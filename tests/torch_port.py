"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy and handed to both packages; JAX state is
carried into the port through madrona_tpu_torch.interop.
"""

import dataclasses

import numpy as np
import torch

from madrona_tpu_torch.interop import state_from_numpy
from madrona_tpu_torch.models import escape_room as t_er
from madrona_tpu_torch.models import hide_seek as t_hs
from madrona_tpu_torch.physics import api as t_api
from madrona_tpu_torch.physics import xpbd as t_xpbd

# (name, first row, last row, tolerance) of the substep solver's 33 output
# fields: the JAX package's golden bounds (tests/golden_inputs.py:484-492)
SOLVER_FIELDS = (
    ("pos", 0, 3, 1e-3), ("rot", 3, 7, 1e-3),
    ("vel", 7, 10, 5e-2), ("omega", 10, 13, 2e-1),
    ("prev_x", 13, 16, 1e-3), ("prev_q", 16, 20, 1e-3),
    ("presolve_x", 20, 23, 1e-3), ("presolve_q", 23, 27, 1e-3),
    ("presolve_v", 27, 30, 5e-2), ("presolve_w", 30, 33, 2e-1),
)


def jax_tree(x):
    """A JAX pytree of dataclasses/dicts -> the same tree of numpy."""
    if dataclasses.is_dataclass(x):
        return {f.name: jax_tree(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: jax_tree(v) for k, v in x.items()}
    return np.asarray(x)


def carry_state(jax_state):
    """A JAX SimState as the port's SimState on the CPU."""
    return state_from_numpy(jax_tree(jax_state), "cpu")


def body_arrays(rs, w, n, n_obj_hi, crowded=False):
    """A random body scene as numpy arrays (the JAX package's broadphase
    test scene): row 0 a floor plane, row 1 a static box, the last two
    rows sometimes dead."""
    def q_rand(shape):
        q = rs.randn(*shape, 4).astype(np.float32)
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    spread = 0.8 if crowded else 2.5
    pos = rs.uniform(-spread, spread, (w, n, 3)).astype(np.float32)
    pos[..., 2] = rs.uniform(0.0, 1.2 if crowded else 3.0, (w, n))
    pos[:, 0] = 0.0
    obj = rs.randint(1, n_obj_hi, (w, n)).astype(np.int32)
    obj[:, 0] = 0
    resp = np.full((w, n), t_xpbd.RESPONSE_DYNAMIC, np.int32)
    resp[:, :2] = t_xpbd.RESPONSE_STATIC
    active = np.ones((w, n), bool)
    active[:, -2:] = rs.rand(w, 2) < 0.5
    rot = q_rand((w, n))
    rot[:, 0] = [1, 0, 0, 0]
    z3 = np.zeros((w, n, 3), np.float32)
    z4 = np.zeros((w, n, 4), np.float32)
    return dict(
        pos=pos, rot=rot,
        scale=rs.uniform(0.5, 1.8, (w, n, 3)).astype(np.float32),
        vel=(1.5 * rs.randn(w, n, 3)).astype(np.float32),
        omega=z3, obj_id=obj, response=resp, ext_force=z3, ext_torque=z3,
        prev_x=z3, prev_q=z4, presolve_x=z3, presolve_q=z4,
        presolve_v=z3, presolve_w=z3, active=active,
    )


def torch_body(arrays):
    """numpy field dict -> the port's BodyState (CPU)."""
    return t_xpbd.BodyState(**{
        k: torch.from_numpy(np.array(v, copy=True)) for k, v in arrays.items()
    })


def jax_body(arrays):
    """numpy field dict -> the JAX package's BodyState."""
    import jax.numpy as jnp
    from madrona_tpu.physics import xpbd as j_xpbd

    return j_xpbd.BodyState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def jax_cands(cands):
    """The port's Candidates -> the JAX package's."""
    import jax.numpy as jnp
    from madrona_tpu.physics import broadphase as j_bp

    return j_bp.Candidates(**{
        f: jnp.asarray(getattr(cands, f).numpy())
        for f in ("hh", "hh_num", "hp", "hp_num", "sp", "sp_num", "sp_kind",
                  "overflow")
    })


def jax_state(state):
    """The port's SimState -> the JAX package's (through numpy)."""
    import jax.numpy as jnp
    from madrona_tpu.core import archetype as j_arch
    from madrona_tpu.core import entity_store as j_es
    from madrona_tpu.core import state as j_state
    from madrona_tpu_torch.interop import state_to_numpy

    def j(x):
        if isinstance(x, dict):
            return {k: j(v) for k, v in x.items()}
        return jnp.asarray(x)

    tree = state_to_numpy(state)
    return j_state.SimState(
        tables={k: j_arch.Table(**j(t)) for k, t in tree["tables"].items()},
        singletons=j(tree["singletons"]),
        entities=j_es.EntityStore(**j(tree["entities"])),
        rng=jnp.asarray(tree["rng"]), step=jnp.asarray(tree["step"]),
    )


def box_sphere_oms(with_sphere=True):
    """(JAX ObjectManager, port ObjectManager) of the kernel goldens'
    objects: a plane, two boxes and (with_sphere) a sphere."""
    from madrona_tpu.physics import bodies as j_bodies
    from madrona_tpu.physics import geo as j_geo
    from madrona_tpu_torch.physics import bodies as t_bodies
    from madrona_tpu_torch.physics import geo as t_geo

    oms = []
    for mod, geo in ((j_bodies, j_geo), (t_bodies, t_geo)):
        reg = mod.ObjectRegistry()
        reg.add_plane()
        reg.add_hull(geo.box_hull((0.5, 0.5, 0.5)), mass=1.0)
        reg.add_hull(geo.box_hull((0.4, 0.8, 0.3)), mass=2.5)
        if with_sphere:
            reg.add_sphere(0.45, mass=0.8)
        oms.append(reg.build())
    return tuple(oms)


def assert_lanes_match(got, ref, tol_nrm=1e-4, tol_pts=1e-3):
    """W-major (ref, alt, points, num, normal) of the port == the JAX
    package's: rows and counts exactly, normals on live lanes within
    tol_nrm, live manifold points within tol_pts without regard to order
    (tests/golden_inputs.py compares the same way)."""
    names = ("ref", "alt", "points", "num", "normal")
    g = dict(zip(names, (np.asarray(x) for x in got)))
    r = dict(zip(names, (np.asarray(x) for x in ref)))
    for k in ("ref", "alt", "num"):
        np.testing.assert_array_equal(g[k], r[k].astype(g[k].dtype),
                                      err_msg=k)
    live = r["num"] > 0
    d = np.abs(g["normal"].astype(np.float64) - r["normal"])
    assert np.where(live[..., None], d, 0.0).max() <= tol_nrm
    dp = np.abs(sorted_live_points(g["points"], r["num"])
                - sorted_live_points(r["points"], r["num"]))
    assert dp.max() <= tol_pts
    return live


def assert_cands_equal(got, ref):
    """Port Candidates == JAX Candidates, every field exactly."""
    for f in ("hh", "hh_num", "hp", "hp_num", "sp", "sp_num", "sp_kind",
              "overflow"):
        a = getattr(got, f).numpy()
        b = np.asarray(getattr(ref, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f)


def sorted_live_points(points, num):
    """Live manifold points [..., 4, 4] -> lexicographically sorted, dead
    slots zeroed (the 4-point reduction may emit one set in another
    order at argmax ties; tests/golden_inputs.py compares the same way)."""
    pts = np.asarray(points, np.float64).reshape(-1, 4, 4)
    live = np.arange(4)[None] < np.asarray(num).reshape(-1, 1)
    pts = np.where(live[..., None], pts, 0.0)
    order = np.lexsort(
        (pts[..., 3], pts[..., 2], pts[..., 1], pts[..., 0]), axis=-1
    )
    return np.take_along_axis(pts, order[..., None], axis=1)


def with_grab_joints(state):
    """An Escape Room SimState (CPU) with grab joints on: a fixed joint
    (agent 0 holds cube 0) in the even worlds, a hinge (agent 1, cube 1)
    in world 1."""
    jb = {k: v.clone()
          for k, v in state.singletons[t_api.JOINT_BUFFER].items()}
    f32 = lambda *v: torch.tensor(v, dtype=torch.float32)   # noqa: E731
    even = slice(0, jb["e1"].shape[0], 2)
    jb["e1"][even, 0] = t_er.ROW_AGENT0
    jb["e2"][even, 0] = t_er.ROW_CUBE0
    jb["jtype"][even, 0] = 0
    jb["r1"][even, 0] = f32(0.0, 0.6, 0.0)
    jb["r2"][even, 0] = f32(0.0, -0.6, 0.0)
    jb["attach_q1"][even, 0] = f32(1.0, 0.0, 0.0, 0.0)
    jb["attach_q2"][even, 0] = f32(1.0, 0.0, 0.0, 0.0)
    jb["active"][even, 0] = True
    jb["e1"][1, 1] = t_er.ROW_AGENT0 + 1
    jb["e2"][1, 1] = t_er.ROW_CUBE0 + 1
    jb["jtype"][1, 1] = 1
    jb["r1"][1, 1] = f32(0.0, 0.5, 0.1)
    jb["r2"][1, 1] = f32(0.0, -0.5, 0.0)
    jb["a1_local"][1, 1] = f32(0.0, 0.0, 1.0)
    jb["a2_local"][1, 1] = f32(0.0, 0.1, 1.0)
    jb["active"][1, 1] = True
    singles = dict(state.singletons)
    singles[t_api.JOINT_BUFFER] = jb
    return dataclasses.replace(state, singletons=singles)


def raycast_planes(seed, tex, wv=4, t_pad=40):
    """Random inputs of the raycast kernel as numpy arrays: setup
    [wv, t_pad, 24] (t_pad - 4 live rows), attrs [wv, 16, t_pad], dl
    [8, 256], atlas [3 * tex, 2 * tex], made as chip_smoke.py makes its
    synthetic ones (exact ties, disabled shadow rows, dead rows)."""
    import chip_smoke

    return [x.numpy() for x in chip_smoke.synthetic_ray_planes(
        np.random.RandomState(seed), wv, t_pad, 256, tex, "cpu")]


def raycast_scene(registry, seed=0, w=2, n_box=4):
    """Floor quad, a pyramid and boxes at random transforms: the mesh
    tables of ``registry`` and numpy arrays."""
    reg = registry()
    floor = reg.add_quad(20.0, color=(0.4, 0.4, 0.4))
    box = reg.add_box([0.6, 0.5, 0.7], color=(0.7, 0.3, 0.2))
    verts = [(-1, -1, 0), (1, -1, 0), (1, 1, 0), (-1, 1, 0), (0, 0, 1.2)]
    tris = [(0, 1, 4), (1, 2, 4), (2, 3, 4), (3, 0, 4), (0, 2, 1),
            (0, 3, 2)]
    pyr = reg.add_mesh(verts, tris, color=(0.2, 0.6, 0.3))
    mesh = reg.build()

    rs = np.random.RandomState(seed)
    i_n = 2 + n_box
    pos = np.zeros((w, i_n, 3), np.float32)
    rot = np.zeros((w, i_n, 4), np.float32)
    rot[..., 0] = 1.0
    scale = np.ones((w, i_n, 3), np.float32)
    obj = np.zeros((w, i_n), np.int32)
    obj[:, 0] = floor
    obj[:, 1] = pyr
    pos[:, 1, :2] = rs.uniform(-3, 3, (w, 2))
    for b in range(n_box):
        obj[:, 2 + b] = box
        pos[:, 2 + b, :2] = rs.uniform(-4, 4, (w, 2))
        pos[:, 2 + b, 2] = rs.uniform(0.5, 1.5, w)
        ang = rs.uniform(0, np.pi, w)
        rot[:, 2 + b, 0] = np.cos(ang / 2)
        rot[:, 2 + b, 3] = np.sin(ang / 2)
        scale[:, 2 + b] = rs.uniform(0.7, 1.4, (w, 1))
    mask = np.ones((w, 2, i_n), bool)
    mask[:, :, -1] = False                     # one dead instance
    mask[:, 1, 2] = False                      # one hidden from view 1
    cam_pos = np.zeros((w, 2, 3), np.float32)
    cam_pos[:, :, 1] = -8.0
    cam_pos[:, :, 2] = 2.5
    cam_pos[:, 1, 0] = 3.0
    cam_rot = np.zeros((w, 2, 4), np.float32)
    cam_rot[..., 0] = 1.0                      # +y forward
    ang = rs.uniform(-0.3, 0.3, w)
    cam_rot[:, 1, 0] = np.cos(ang / 2)
    cam_rot[:, 1, 3] = np.sin(ang / 2)
    return mesh, (pos, rot, scale, obj, mask, cam_pos, cam_rot)


def hide_seek_scene(w, seed):
    """(env, sim, state): a Hide & Seek SimState of the port (CPU, state
    only) as chip_smoke.py arranges it for the physics kernels: a box on
    a ramp's low end, an agent on a ramp's slope, an agent against a
    ramp's triangular side, a box against a wall; box 0 locked (a static
    row inside the solver's dynamic range) in the even worlds; seeker 0
    holding box 2 by a fixed joint in slot 2 of every fourth world, every
    other slot inactive with e1 = e2 = -1; random kicks."""
    import chip_smoke
    from madrona_tpu_torch import make_sim

    env = t_hs.HideSeek(pixels=False)
    sim = make_sim(env, num_worlds=w, seed=seed, device="cpu")
    sim.step({})
    return env, sim, chip_smoke.arrange_hide_seek(sim)


def hide_seek_kernel_inputs(env, sim, state):
    """(body, candidates, contacts-kernel args, solver-kernel args) of the
    physics node at ``state``, from the plain versions."""
    from madrona_tpu_torch.ops import contacts_cuda, solver_cuda
    from madrona_tpu_torch.physics import broadphase as t_bp

    cfg = env.cfg
    body = t_api.body_state(sim.executor.sm, state)
    cands = t_bp.find_candidates(body, env.om, env.caps, cfg.dt)
    pred = t_xpbd.integrate(body, env.om, cfg.dt / cfg.substeps, cfg.gravity)
    poses, obj = contacts_cuda.pack_poses(pred, body.obj_id)
    cin = (cands.hh.contiguous(), cands.hp.contiguous(), poses, obj)
    cargs = contacts_cuda.contacts_plain(*cin, env.om)
    state_t, param_t = solver_cuda.pack_state(body, env.om)
    jargs = solver_cuda.pack_joints(t_api.joints_view(state), t_hs.N_BODIES)
    return body, cands, cin, (state_t, param_t, *cargs, *jargs)


def assert_trees_equal(a, b, path="state", dtypes=True):
    """Two numpy trees (dicts of arrays) equal leaf for leaf, bit for
    bit, dtypes included unless ``dtypes`` is False."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}/{k}", dtypes)
        return
    a, b = np.asarray(a), np.asarray(b)
    if dtypes:
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=path)


def stack_scene(port, cfg, w, seed=0):
    """chip_smoke.stack_scene's box stack with a sphere and joints in one
    package: (executor, ObjectManager, CandidateCaps). ``port``: the
    PyTorch port on the CPU (chip_smoke's own builder), else the JAX
    package, from the same numpy rows (chip_smoke.stack_arrays)."""
    import chip_smoke

    if port:
        return chip_smoke.stack_scene(cfg, w, "cpu", seed)
    import jax.numpy as jnp
    from madrona_tpu.core.registry import ECSRegistry
    from madrona_tpu.core.state import StateManager
    from madrona_tpu.graph.builder import TaskGraphBuilder
    from madrona_tpu.graph.executor import Executor
    from madrona_tpu.physics import api, bodies, broadphase, geo
    from madrona_tpu.physics import joints as jt

    sm = StateManager()
    reg = ECSRegistry(sm)
    api.register_types(reg, max_bodies=4)
    api.register_joint_types(reg, max_joints=2)
    om_r = bodies.ObjectRegistry()
    om_r.add_hull(geo.box_hull((0.5, 0.5, 0.5)), mass=1.0)
    om_r.add_plane()
    om_r.add_sphere(0.5, mass=1.0)
    om = om_r.build()
    caps = broadphase.CandidateCaps(*chip_smoke.STACK_CAPS)
    b = TaskGraphBuilder(sm, "step")
    api.setup_physics_step_tasks(b, om, cfg, caps)
    ex = Executor(sm, {"step": b.build()}, num_worlds=w, seed=0,
                  donate=False)
    pos, rot, vel, joints = chip_smoke.stack_arrays(w, seed)
    obj = np.tile([1, 0, 0, 2], (w, 1)).astype(np.int32)
    resp = np.tile([bodies.RESPONSE_STATIC] + [bodies.RESPONSE_DYNAMIC] * 3,
                   (w, 1)).astype(np.int32)
    state, _ = sm.make_entities(
        ex.state, api.RIGID_BODY,
        chip_smoke.body_values(jnp.asarray, pos, rot, vel, obj, resp),
        jnp.ones((w, 4), bool))
    buf = api.joints_view(state)
    for kind, kw in joints:
        make = jt.make_fixed_joint if kind == "fixed" else jt.make_hinge_joint
        buf = make(buf, **kw)
    ex.state = api.write_joints(state, buf)
    return ex, om, caps


def events_scene_jax(w, max_events, seed=0):
    """chip_smoke.events_scene's boxes pressed in pairs onto a plane in
    the JAX package, from the same numpy rows (chip_smoke.events_arrays),
    through its entity store: (executor with the scene's state, entity
    handles [w, 9, 2]). Contacts once a step on the XLA tier, one Jacobi
    iteration, as the port's scene."""
    import chip_smoke
    import jax.numpy as jnp
    from madrona_tpu.core.registry import ECSRegistry
    from madrona_tpu.core.state import StateManager
    from madrona_tpu.graph.builder import TaskGraphBuilder
    from madrona_tpu.graph.executor import Executor
    from madrona_tpu.physics import api, bodies, broadphase, geo
    from madrona_tpu.physics.xpbd import PhysicsConfig

    sm = StateManager()
    reg = ECSRegistry(sm)
    api.register_types(reg, max_bodies=9)
    api.register_collision_events(reg, max_events=max_events)
    reg.export_singleton(api.COLLISION_EVENTS, "events")
    om_r = bodies.ObjectRegistry()
    chip_smoke.events_objects(om_r, geo)
    om = om_r.build()
    b = TaskGraphBuilder(sm, "step")
    api.setup_physics_step_tasks(
        b, om, PhysicsConfig(narrowphase_once=True, jacobi_iters=1),
        broadphase.CandidateCaps(*chip_smoke.EV_CAPS))
    ex = Executor(sm, {"step": b.build()}, num_worlds=w, seed=0,
                  donate=False)
    pos, rot, vel, force, obj, resp = chip_smoke.events_arrays(w, seed)
    values = chip_smoke.body_values(jnp.asarray, pos, rot, vel, obj, resp)
    values["ExternalForce"] = jnp.asarray(force)
    ex.state, ents = sm.make_entities(ex.state, api.RIGID_BODY, values,
                                      jnp.ones((w, 9), bool))
    return ex, np.asarray(ents)
