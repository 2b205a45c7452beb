"""The port's last public names of the JAX package, on the CPU:
``Executor.build_launch_graph`` and ``get_exported``
(graph/executor.py), ``render/raycast.py::resolve_tracer``,
``physics/xpbd.py::PACK_F``, and ``scripts/torch_weak_scaling.py``.

  * tests/test_taskgraph.py::test_launch_graph_composition on the port,
    held against the JAX executor on the same toy sim (one module-scoped
    JAX executor with the graphs "move" and "count"): the key, and the
    state after each run of the composed launch, of a graph name and of
    a tuple, equal bit for bit; the composed step is built once;
  * ``get_exported`` equal to JAX's and to ``run``'s export, an unknown
    slot a KeyError on both;
  * ``resolve_tracer``: ``MADRONA_TPU_TRACER`` over ``cfg.tracer``, an
    unknown name a ValueError; a scene past the raycast kernel's
    triangle budget rendered by ``render_views`` and
    ``render/tlas.py::render_views_tlas`` under each value of the
    variable (``cfg.tracer`` naming the other tracer), held against the
    JAX package's under the same variable: depth within 1e-4, rgb
    differing by more than 0.02 at under 0.2 % of pixels
    (tests/test_raycast_kernel.py:92-93); the two tracers' images part
    (each value took effect);
  * ``PACK_F`` is 39, the JAX package's; an ast walk of both trees
    finds no public name of the JAX package missing from the port but
    those ROADMAP.md lists under "Not ported, and why";
  * ``torch_weak_scaling.main(["--cpu", ...])`` as one gloo rank: the
    JAX script's keys, a positive rate, no efficiency with one rank.
"""

import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu import Executor as JExecutor
from madrona_tpu import TaskGraphBuilder as JBuilder
from madrona_tpu.physics import xpbd as j_xpbd
from madrona_tpu.render import MeshRegistry as JMeshRegistry
from madrona_tpu.render import raycast as j_ray
from madrona_tpu.render import tlas as j_tlas
from madrona_tpu_torch import ECSRegistry, Executor, StateManager
from madrona_tpu_torch import TaskGraphBuilder
from madrona_tpu_torch.physics import xpbd as t_xpbd
from madrona_tpu_torch.render import MeshRegistry
from madrona_tpu_torch.render import kernel as t_kernel
from madrona_tpu_torch.render import raycast as t_ray
from madrona_tpu_torch.render import tlas as t_tlas

from test_taskgraph import build_sim, count, init_fn, movement

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, K = 4, 6
DEPTH_TOL = 1e-4
PIX_TOL, PIX_FRAC = 0.02, 0.002


@pytest.fixture(scope="module")
def jax_ex():
    """tests/test_taskgraph.py's toy sim with the graphs "move" and
    "count" (the JAX executor), and its initial state."""
    sm, _ = build_sim()
    b1 = JBuilder(sm, "move")
    b1.parallel_for(movement, "Mover", ["Pos", "Vel"], ["Pos"])
    b2 = JBuilder(sm, "count")
    b2.for_worlds(count, ["StepCount"], ["StepCount"])
    ex = JExecutor(sm, {"move": b1.build(), "count": b2.build()},
                   num_worlds=W, init_fn=init_fn, donate=False)
    return ex, ex.state


def torch_ex():
    """The same toy sim on the port, on the CPU."""
    sm = StateManager()
    reg = ECSRegistry(sm)
    reg.register_component("Pos", (), torch.float32)
    reg.register_component("Vel", (), torch.float32)
    reg.register_component("Key", (), torch.int32)
    reg.register_archetype("Mover", ["Pos", "Vel", "Key"], 8)
    reg.register_singleton("StepCount", (), torch.int32)
    reg.export_column("Mover", "Pos", "pos")

    def t_init(sm_, state):
        values = {
            "Pos": torch.arange(K, dtype=torch.float32)[None].repeat(W, 1),
            "Vel": torch.ones((W, K)),
            "Key": torch.arange(K, 0, -1, dtype=torch.int32)[None].repeat(
                W, 1),
        }
        state, _ = sm_.make_entities(state, "Mover", values,
                                     torch.ones((W, K), dtype=torch.bool))
        return state

    b1 = TaskGraphBuilder(sm, "move")
    b1.parallel_for(lambda ctx, pos, vel: pos + vel, "Mover", ["Pos", "Vel"],
                    ["Pos"])
    b2 = TaskGraphBuilder(sm, "count")
    b2.for_worlds(lambda ctx, c: c + 1, ["StepCount"], ["StepCount"])
    return Executor(sm, {"move": b1.build(), "count": b2.build()},
                    num_worlds=W, init_fn=t_init, device="cpu")


def _same_state(t_ex, j_ex):
    t_pos = t_ex.state.tables["Mover"].columns["Pos"].numpy()
    np.testing.assert_array_equal(
        t_pos, np.asarray(j_ex.state.tables["Mover"].columns["Pos"]))
    np.testing.assert_array_equal(
        t_ex.state.singletons["StepCount"].numpy(),
        np.asarray(j_ex.state.singletons["StepCount"]))
    assert int(t_ex.state.step) == int(j_ex.state.step)


def test_launch_graph_composition_matches_jax(jax_ex):
    j_ex, j_start = jax_ex
    j_ex.state = j_start
    t_ex = torch_ex()
    launch = t_ex.build_launch_graph(["move", "count"])
    assert launch == j_ex.build_launch_graph(["move", "count"]) \
        == ("move", "count")
    fn = t_ex.step_fn(launch)
    assert t_ex.step_fn(("move", "count")) is fn
    assert t_ex.build_launch_graph(("move", "count")) == launch
    t_ex.run(launch)
    j_ex.run(launch)
    # tests/test_taskgraph.py's own assertions
    assert (t_ex.state.singletons["StepCount"] == 1).all()
    np.testing.assert_allclose(
        t_ex.state.tables["Mover"].columns["Pos"][0, :6].numpy(),
        np.arange(6) + 1.0)
    _same_state(t_ex, j_ex)
    for step in (launch, "move", ("count",), ["move", "count"]):
        t_ex.run(step)
        j_ex.run(step)
        _same_state(t_ex, j_ex)
    assert t_ex.step_fn(launch) is fn
    with pytest.raises(KeyError):
        t_ex.build_launch_graph(["move", "render"])


def test_get_exported_matches_jax(jax_ex):
    j_ex, j_start = jax_ex
    j_ex.state = j_start
    t_ex = torch_ex()
    np.testing.assert_array_equal(t_ex.get_exported("pos").numpy(),
                                  np.asarray(j_ex.get_exported("pos")))
    for _ in range(2):
        t_out = t_ex.run(("move", "count"))
        j_ex.run(("move", "count"))
    got = t_ex.get_exported("pos")
    assert torch.equal(got, t_out["pos"])
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(j_ex.get_exported("pos")))
    for ex in (t_ex, j_ex):
        with pytest.raises(KeyError):
            ex.get_exported("vel")


def test_resolve_tracer_precedence_and_refusal(monkeypatch):
    monkeypatch.delenv("MADRONA_TPU_TRACER", raising=False)
    cfg = t_ray.RenderConfig(tracer="matmul")
    assert t_ray.resolve_tracer(cfg) == "matmul"
    assert t_ray.resolve_tracer(t_ray.RenderConfig()) == "mt"
    monkeypatch.setenv("MADRONA_TPU_TRACER", "mt")
    assert t_ray.resolve_tracer(cfg) == "mt"
    assert j_ray.resolve_tracer(j_ray.RenderConfig(tracer="matmul")) == "mt"
    monkeypatch.setenv("MADRONA_TPU_TRACER", "bvh")
    with pytest.raises(ValueError, match="unknown tracer 'bvh'"):
        t_ray.resolve_tracer(cfg)
    monkeypatch.delenv("MADRONA_TPU_TRACER")
    with pytest.raises(ValueError, match="unknown tracer"):
        t_ray.resolve_tracer(t_ray.RenderConfig(tracer="bvh"))


def _big_scene(registry):
    """A floor and 64 instances of a 32-triangle height field (65 x 32
    padded triangles a world, past the raycast kernel's 2048), 2 worlds
    and 2 views: the mesh tables of ``registry`` and numpy arrays."""
    reg = registry()
    floor = reg.add_quad(30.0, color=(0.4, 0.4, 0.4))
    nx, ny = 4, 4
    xs, ys = np.meshgrid(np.linspace(-1, 1, nx + 1),
                         np.linspace(-1, 1, ny + 1), indexing="ij")
    zs = 0.3 + 0.25 * np.sin(3 * xs) * np.cos(2 * ys)
    verts = np.stack([xs, ys, zs], -1).reshape(-1, 3).astype(np.float32)
    tris = []
    for i in range(nx):
        for j in range(ny):
            a, b = i * (ny + 1) + j, (i + 1) * (ny + 1) + j
            tris += [(a, b, b + 1), (a, b + 1, a + 1)]
    field = reg.add_mesh(verts.tolist(), tris, color=(0.2, 0.6, 0.3))
    mesh = reg.build()
    rs = np.random.RandomState(5)
    w, n = 2, 65
    pos = np.zeros((w, n, 3), np.float32)
    rot = np.zeros((w, n, 4), np.float32)
    rot[..., 0] = 1.0
    scale = np.ones((w, n, 3), np.float32)
    obj = np.full((w, n), field, np.int32)
    obj[:, 0] = floor
    pos[:, 1:, :2] = rs.uniform(-9, 9, (w, n - 1, 2))
    ang = rs.uniform(0, np.pi, (w, n - 1))
    rot[:, 1:, 0], rot[:, 1:, 3] = np.cos(ang / 2), np.sin(ang / 2)
    mask = np.ones((w, n), bool)
    cam_pos = np.zeros((w, 2, 3), np.float32)
    cam_pos[:, :, 1], cam_pos[:, :, 2] = -10.0, 4.0
    cam_pos[:, 1, 0] = 2.0
    cam_rot = np.zeros((w, 2, 4), np.float32)
    tilt = -0.3
    cam_rot[..., 0], cam_rot[..., 1] = np.cos(tilt / 2), np.sin(tilt / 2)
    return mesh, [pos, rot, scale, obj, mask, cam_pos, cam_rot]


@pytest.mark.parametrize("tracer", t_ray.TRACERS)
def test_render_past_the_kernel_budget_under_each_tracer(tracer,
                                                         monkeypatch):
    j_mesh, args = _big_scene(JMeshRegistry)
    t_mesh, _ = _big_scene(MeshRegistry)
    assert not t_kernel.kernel_eligible(
        t_ray.RenderConfig(), t_mesh, None, 0, args[0].shape[1])
    other = [t for t in t_ray.TRACERS if t != tracer][0]
    kw = dict(width=24, height=16, t_max=60.0, tracer=other)
    monkeypatch.setenv("MADRONA_TPU_TRACER", tracer)
    t_args = [torch.from_numpy(a) for a in args]
    j_args = [jnp.asarray(a) for a in args]
    j_cfg = j_ray.RenderConfig(**kw)
    ref = jax.jit(lambda *a: j_ray.render_views(j_cfg, j_mesh, *a))(*j_args)
    got = t_ray.render_views(t_ray.RenderConfig(**kw), t_mesh, *t_args)
    ref_c = jax.jit(lambda *a: j_tlas.render_views_tlas(
        j_cfg, j_mesh, *a, max_instances_per_view=8))(*j_args)
    got_c = t_tlas.render_views_tlas(t_ray.RenderConfig(**kw), t_mesh,
                                     *t_args, max_instances_per_view=8)
    for (rgb, dep), (r_rgb, r_dep) in ((got, ref), (got_c[:2], ref_c[:2])):
        r_rgb, r_dep = np.asarray(r_rgb), np.asarray(r_dep)
        assert rgb.shape == r_rgb.shape == (2, 2, 16, 24, 3)
        assert np.abs(dep.numpy() - r_dep).max() <= DEPTH_TOL
        assert (np.abs(rgb.numpy() - r_rgb) > PIX_TOL).mean() < PIX_FRAC
    assert 0.3 < (np.asarray(ref[1]) < 60.0).mean() < 1.0
    np.testing.assert_array_equal(got_c[2].numpy(), np.asarray(ref_c[2]))
    assert int(got_c[2].min()) > 8
    # the variable took effect: the other tracer's image parts in a bit
    monkeypatch.setenv("MADRONA_TPU_TRACER", other)
    alt = t_ray.render_views(t_ray.RenderConfig(**kw), t_mesh, *t_args)
    assert not torch.equal(alt[1], got[1])
    assert float((alt[1] - got[1]).abs().max()) <= 2 * DEPTH_TOL


def test_pack_f_is_the_jax_constant():
    assert t_xpbd.PACK_F == j_xpbd.PACK_F == 39
    assert t_xpbd.PACK_F == sum(d for _, d in t_xpbd._PACK_SLOTS)


# ROADMAP.md's "Not ported, and why", by JAX module: every public name
# the port lacks must be here
NOT_PORTED = {
    "interop.py": {"to_torch", "from_torch"},
    "native/__init__.py": None,
    "ops/broadphase_pallas.py": None, "ops/lidar_pallas.py": None,
    "ops/narrowphase_pallas.py": None, "ops/physics_megakernel.py": None,
    "ops/raycast_pallas.py": None, "ops/solver_pallas.py": None,
    "physics/api.py": {"megakernel_substeps", "narrowphase_hh_pallas"},
    "physics/broadphase.py": {"find_candidates_pallas"},
    "physics/joints.py": {"FWD", "RIGHT", "UP"},
    "render/kernel.py": {"make_trace_cached"},
    "utils/config.py": {"enable_compile_cache"},
    "utils/navmesh.py": {"SENTINEL"},
    "utils/roofline.py": {"HBM_BYTES_PER_S", "MXU_BF16_FLOPS",
                          "RENDER_OPS_PRIMARY", "RENDER_OPS_SHADOW",
                          "VPU_VREG_OPS_PER_S", "render_vpu_floor_s"},
    "utils/tracing.py": {"ENABLED", "xprof_trace"},
}


def _public_names(path):
    """The module's public functions, classes, their public methods
    (``Class.method``) and module constants."""
    import ast

    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            if node.name.startswith("_"):
                continue
            out.add(node.name)
            for sub in getattr(node, "body", []) if isinstance(
                    node, ast.ClassDef) else []:
                if isinstance(sub, ast.FunctionDef) \
                        and not sub.name.startswith("_"):
                    out.add(f"{node.name}.{sub.name}")
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            for t in (node.targets if isinstance(node, ast.Assign)
                      else [node.target]):
                if isinstance(t, ast.Name) and not t.id.startswith("_"):
                    out.add(t.id)
    return out


def test_public_names_cover_jax():
    """An ast walk of both trees: every public name of a JAX module is in
    its port, but those NOT_PORTED lists (a whole module: None)."""
    import pathlib

    jax_root = pathlib.Path(REPO) / "madrona_tpu"
    port_root = pathlib.Path(REPO) / "madrona_tpu_torch"
    lacking = {}
    for path in sorted(jax_root.rglob("*.py")):
        rel = str(path.relative_to(jax_root))
        port = port_root / rel
        gone = (None if not port.exists()
                else _public_names(path) - _public_names(port))
        if gone != set():
            lacking[rel] = gone
    assert lacking == NOT_PORTED
    for name in ("Executor.build_launch_graph", "Executor.get_exported"):
        assert name in _public_names(port_root / "graph" / "executor.py")


def test_weak_scaling_script_one_cpu_rank():
    spec = importlib.util.spec_from_file_location(
        "torch_weak_scaling",
        os.path.join(REPO, "scripts", "torch_weak_scaling.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = mod.main(["--cpu", "--worlds-per-device", "4", "--steps", "2",
                    "--env", "escape_room"])
    assert {"devices", "steps_per_sec", "efficiency"} <= set(out)
    assert out["devices"] == [1] and out["backend"] == "gloo"
    rate = out["steps_per_sec"]["1"]
    assert math.isfinite(rate) and rate > 0
    assert out["efficiency"] == {}
    assert not torch.distributed.is_initialized()
