"""The port's viz (madrona_tpu_torch/viz) against the JAX package's, on
the CPU.

  * ``png_bytes``: byte-equal to the JAX encoder's for float and uint8
    images; ``render_topdown`` equal (tensor inputs on the port's side);
  * ``Recorder``: round trips, and a file saved by either package loads
    with the other's ``Recorder.load``, keys, dtypes and values equal;
  * ``WebViewer`` over HTTP on a port physics scene built like
    tests/test_web_viewer.py's fixture (a plane and two falling boxes in
    2 worlds): the page, ``/state``, both PNGs, the keys driving the
    camera and the sim, ``tick`` advancing the physics, the BLAS
    flycam; ``PlaybackViewer`` over HTTP on tests/test_playback.py's
    trajectory;
  * a flycam frame of the port's viewer against the JAX viewer's frame of
    the same state and camera (its jitted ``_frame``, the dense tracer):
    rgb differing by more than 0.02 at under 0.2 % of pixels, and the
    depth of the same rays within 1e-4 of the JAX tracer's
    (tests/test_torch_raycast_glue.py (b)'s bounds).
"""

import dataclasses
import http.client
import json
import os
import threading
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu import viz as j_viz
from madrona_tpu.render import MeshRegistry as JMeshRegistry
from madrona_tpu.render import RenderConfig as JRenderConfig
from madrona_tpu.render import raycast as j_raycast
from madrona_tpu_torch import viz as t_viz
from madrona_tpu_torch.viz import viewer as t_viewer
from madrona_tpu.viz import viewer as j_viewer

torch.set_num_threads(1)

W = 2


def _get(port, path):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    c.request("GET", path)
    r = c.getresponse()
    body = r.read()
    c.close()
    return r.status, r.getheader("Content-Type"), body


def test_png_bytes_and_topdown_match_jax(tmp_path):
    rs = np.random.RandomState(0)
    img_f = rs.rand(12, 9, 3).astype(np.float32)
    img_f[0, 0] = [-1.0, 2.0, 0.5]                 # clipped on both sides
    img_u8 = rs.randint(0, 256, (7, 5, 3)).astype(np.uint8)
    for img in (img_f, img_u8):
        assert t_viewer.png_bytes(torch.from_numpy(img)) == \
            j_viewer.png_bytes(img)
    pos = rs.uniform(-3, 3, (2, 5, 3)).astype(np.float32)
    sc = rs.uniform(0.2, 0.8, (2, 5, 3)).astype(np.float32)
    colors = rs.rand(5, 3).astype(np.float32)
    for kw in ({}, {"colors": colors, "world": 1, "extent": 4.0}):
        t_img = t_viz.render_topdown(torch.from_numpy(pos),
                                     torch.from_numpy(sc), res=64, **kw)
        np.testing.assert_array_equal(
            t_img, j_viz.render_topdown(pos, sc, res=64, **kw))
    rgb = rs.rand(1, 2, 8, 8, 3).astype(np.float32)
    t_viz.save_frame_grid(os.path.join(tmp_path, "t.png"),
                          torch.from_numpy(rgb))
    j_viz.save_frame_grid(os.path.join(tmp_path, "j.png"), rgb)
    with open(os.path.join(tmp_path, "t.png"), "rb") as f, \
            open(os.path.join(tmp_path, "j.png"), "rb") as g:
        assert f.read() == g.read()


def test_recorder_files_cross_both_ways(tmp_path):
    from madrona_tpu_torch import make_sim
    from madrona_tpu_torch.models.cartpole import Cartpole

    sim = make_sim(Cartpole(), num_worlds=4, seed=0, device="cpu")
    rec = t_viz.Recorder()
    step = sim.step_fn()
    s = sim.state
    zero = torch.zeros((4,), dtype=torch.int32)
    for _ in range(5):
        s, o = step(s, {"action": zero, "reset": zero})
        rec.record(s, o)
    traj = rec.stacked()
    assert len(rec) == 5 and traj["obs"].shape == (5, 4, 1, 4)
    p = os.path.join(tmp_path, "port.npz")
    rec.save(p)
    for loaded in (t_viz.Recorder.load(p), j_viz.Recorder.load(p)):
        assert set(loaded) == set(traj)
        for k in traj:
            assert loaded[k].dtype == traj[k].dtype
            np.testing.assert_array_equal(loaded[k], traj[k])
    # the JAX recorder's file, with a capture function, into the port
    j_rec = j_viz.Recorder(capture={"pos": lambda st, out: out["p"]})
    for t in range(3):
        j_rec.record(None, {"p": jnp.full((4, 2), t, jnp.float32)})
    q = os.path.join(tmp_path, "jax.npz")
    j_rec.save(q)
    back = t_viz.Recorder.load(q)
    assert back["pos"].shape == (3, 4, 2)
    np.testing.assert_array_equal(back["pos"], j_rec.stacked()["pos"])


def _physics_scene():
    """tests/test_web_viewer.py's scene on the port: a plane and two boxes
    at z = 2 and 4 in each of 2 worlds (4 body rows, 3 live), stepped by
    the physics node alone."""
    from madrona_tpu_torch.core.registry import ECSRegistry
    from madrona_tpu_torch.core.state import StateManager
    from madrona_tpu_torch.graph.builder import TaskGraphBuilder
    from madrona_tpu_torch.graph.executor import Executor
    from madrona_tpu_torch.physics import api as phys
    from madrona_tpu_torch.physics.bodies import ObjectRegistry
    from madrona_tpu_torch.physics.geo import box_hull
    from madrona_tpu_torch.physics.xpbd import PhysicsConfig

    sm = StateManager()
    phys.register_types(ECSRegistry(sm), max_bodies=4)
    om = ObjectRegistry()
    obj = om.add_hull(box_hull((0.5, 0.5, 0.5)), mass=1.0)
    plane = om.add_plane()
    om = om.build()
    b = TaskGraphBuilder(sm, "step")
    phys.setup_physics_step_tasks(b, om, PhysicsConfig())
    ex = Executor(sm, {"step": b.build()}, num_worlds=W, seed=0,
                  device="cpu")
    t = ex.state.tables["RigidBody"]
    cols = dict(t.columns)
    pos = torch.zeros((W, 4, 3))
    pos[:, 1] = torch.tensor([0, 0, 2.0])
    pos[:, 2] = torch.tensor([0.2, 0, 4.0])
    rot = torch.zeros((W, 4, 4))
    rot[..., 0] = 1
    oid = torch.zeros((W, 4), dtype=torch.int32)
    oid[:, 0] = plane
    oid[:, 1:3] = obj
    resp = torch.zeros((W, 4), dtype=torch.int32)
    resp[:, 0] = 2                                    # static
    cols.update(Position=pos, Rotation=rot, Scale=torch.ones((W, 4, 3)),
                ObjectID=oid, ResponseType=resp)
    tables = dict(ex.state.tables)
    tables["RigidBody"] = dataclasses.replace(
        t, columns=cols, num_rows=torch.full((W,), 3, dtype=torch.int32))
    ex.state = dataclasses.replace(ex.state, tables=tables)
    return ex


class _SimShim:
    def __init__(self, ex):
        self._ex = ex

    @property
    def state(self):
        return self._ex.state

    @state.setter
    def state(self, s):
        self._ex.state = s

    def step_fn(self):
        return self._ex.step_fn(("step",))


def _meshes(reg_cls):
    reg = reg_cls()
    box = reg.add_box(0.5)
    quad = reg.add_quad(20.0)
    return reg.build(), [quad, box, box, box]


@pytest.fixture(scope="module")
def viewer():
    from madrona_tpu_torch.render import MeshRegistry

    sim = _SimShim(_physics_scene())
    mesh, robj = _meshes(MeshRegistry)
    v = t_viz.WebViewer(sim, mesh, robj, width=64, height=48,
                        inputs_fn=lambda: {})
    v.paused = True
    srv = v.make_server(port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    yield v, srv.server_address[1]
    srv.shutdown()
    srv.server_close()


def test_web_viewer_endpoints_and_keys(viewer):
    v, port = viewer
    st, ct, body = _get(port, "/")
    assert st == 200 and ct == "text/html" and b"viewer" in body
    s = json.loads(_get(port, "/state")[2])
    assert s["world"] == 0 and s["num_worlds"] == W and s["num_views"] == 0
    for path in ("/frame.png", "/topdown.png", "/agent.png"):
        st, ct, body = _get(port, path)
        assert st == 200 and ct == "image/png"
        assert body.startswith(b"\x89PNG")
    assert _get(port, "/nothing")[0] == 404
    cam0 = list(v.cam_pos)
    _get(port, "/key?k=w")
    assert v.cam_pos[1] > cam0[1]
    _get(port, "/key?k=ArrowLeft")
    assert v.yaw != 0.0
    # pause toggling and a single step advance the sim
    paused = v.paused
    _get(port, "/key?k=%20")
    assert v.paused != paused
    s0 = json.loads(_get(port, "/state")[2])["step"]
    _get(port, "/key?k=n")
    s1 = json.loads(_get(port, "/state")[2])["step"]
    assert s1 == s0 + 1
    # the world switch clamps
    _get(port, "/key?k=%5D")
    _get(port, "/key?k=%5D")
    assert v.world == 1
    _get(port, "/key?k=%5B")
    assert v.world == 0


def test_tick_advances_physics(viewer):
    v, _ = viewer
    v.paused = False
    pos = lambda: v.sim.state.tables["RigidBody"].columns["Position"]  # noqa
    z0 = float(pos()[0, 1, 2])
    for _ in range(5):
        v.tick()
    assert float(pos()[0, 1, 2]) < z0         # the box is falling
    v.paused = True


def test_flycam_frame_matches_jax(viewer):
    v, _ = viewer
    j_mesh, robj = _meshes(JMeshRegistry)
    jv = j_viz.WebViewer(types.SimpleNamespace(step_fn=lambda: None),
                         j_mesh, robj, width=64, height=48,
                         inputs_fn=lambda: {})
    v.cam_pos = np.array([1.0, -6.0, 3.0])
    v.yaw, v.pitch = 0.1, -0.35
    cols = v.sim.state.tables["RigidBody"].columns
    pos, rot, scale = (cols[k][0].numpy() for k in ("Position", "Rotation",
                                                     "Scale"))
    rgb, depth = v.frame()
    cam = jnp.asarray(v.cam_pos, jnp.float32)
    quat = jnp.asarray(v.cam_quat(), jnp.float32)
    j_rgb = np.asarray(jv._frame(jnp.asarray(pos), jnp.asarray(rot),
                                 jnp.asarray(scale), cam, quat))
    cfg = JRenderConfig(width=64, height=48, fov_deg=90.0)
    o, d = j_raycast.camera_rays(cfg, cam, quat)
    _, j_depth = j_raycast._trace_rays(
        cfg, j_mesh, jnp.asarray(pos), jnp.asarray(rot), jnp.asarray(scale),
        jnp.asarray(np.asarray(robj, np.int32)), jnp.ones((4,), bool),
        o.reshape(-1, 3), d.reshape(-1, 3))
    j_depth = np.asarray(j_depth).reshape(48, 64)
    assert (j_depth < cfg.t_max).mean() > 0.3     # the scene is in view
    assert np.abs(depth.numpy() - j_depth).max() <= 1e-4
    assert (np.abs(rgb.numpy() - j_rgb) > 0.02).mean() < 0.002


def test_blas_flycam_frame(viewer):
    """WebViewer(blas=...) renders the flycam through the mesh-BVH walker
    (tests/test_web_viewer.py's case)."""
    from madrona_tpu_torch.assets.bvh import build_mesh_bvh
    from madrona_tpu_torch.render.blas import bake_blas

    v_mesh, _ = viewer

    def box_mesh(h):
        c = np.asarray([
            [-h, -h, -h], [h, -h, -h], [h, h, -h], [-h, h, -h],
            [-h, -h, h], [h, -h, h], [h, h, h], [-h, h, h],
        ], np.float32)
        f = np.asarray([
            [0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
            [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
            [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7],
        ], np.int32)
        return c, f

    vq, fq = box_mesh(20.0)
    vb, fb = box_mesh(0.5)
    blas = bake_blas([build_mesh_bvh(vq, fq), build_mesh_bvh(vb, fb)],
                     colors=[(0.2, 0.7, 0.2), (0.8, 0.2, 0.2)],
                     device="cpu")
    v = t_viz.WebViewer(v_mesh.sim, None, [0, 1, 1, 1], width=48, height=32,
                        inputs_fn=lambda: {}, blas=blas)
    png = v.frame_png()
    assert png[:8] == b"\x89PNG\r\n\x1a\n" and len(png) > 100
    img = v.frame()[0].numpy()
    assert np.isfinite(img).all()
    assert img.reshape(-1, 3).std(axis=0).max() > 1e-3


def _traj(T=4, Wt=2, N=3, V=2, H=6, Wd=8):
    """tests/test_playback.py's trajectory."""
    rs = np.random.RandomState(3)
    pos = rs.rand(T, Wt, N, 3).astype(np.float32) * 4 - 2
    pos[..., 2] = np.abs(pos[..., 2])
    rot = np.zeros((T, Wt, N, 4), np.float32)
    rot[..., 0] = 1.0
    scale = np.ones((T, Wt, N, 3), np.float32) * 0.5
    rgb = rs.rand(T, Wt, V, H, Wd, 3).astype(np.float32)
    depth = rs.rand(T, Wt, V, H, Wd).astype(np.float32) * 10
    return {"Position": pos, "Rotation": rot, "Scale": scale,
            "rgb": rgb, "depth": depth}


def test_playback_viewer_endpoints():
    from madrona_tpu_torch.render import MeshRegistry

    reg = MeshRegistry()
    box = reg.add_box(0.5)
    v = t_viz.PlaybackViewer(_traj(), mesh=reg.build(),
                             render_obj=[box] * 3, width=32, height=24,
                             device="cpu")
    srv = v.make_server(port=0)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        meta = json.loads(_get(port, "/meta")[2])
        assert meta["steps"] == 4 and meta["num_worlds"] == 2
        assert meta["num_views"] == 2 and meta["has_cam"]
        assert meta["has_topdown"]
        for path in ("/frame.png?t=2&w=1", "/topdown.png?t=3&w=0",
                     "/agent.png?t=1&w=1&v=1", "/frame.png?t=99&w=-4"):
            st, ct, body = _get(port, path)
            assert st == 200 and ct == "image/png", path
            assert body.startswith(b"\x89PNG")
        # the agent panel is RGB | depth side by side
        from madrona_tpu_torch.assets.png import decode_png

        panel = decode_png(_get(port, "/agent.png?t=0&w=0&v=0")[2])
        assert panel.shape[:2] == (6, 16)
        yaw0 = v.yaw
        assert _get(port, "/key?k=ArrowRight")[2] == b"ok"
        assert v.yaw > yaw0
        st, ct, body = _get(port, "/")
        assert st == 200 and b"playback" in body
        # a trajectory without body state serves no frame or top-down
        bare = t_viz.PlaybackViewer({"rgb": _traj()["rgb"]}, device="cpu")
        assert not json.loads(bare.meta_json())["has_cam"]
    finally:
        srv.shutdown()
        srv.server_close()
