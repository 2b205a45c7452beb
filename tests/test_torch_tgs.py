"""The TGS-Soft solver of the PyTorch port against the JAX package
(tests/test_physics.py:488-690, solver="tgs").

The scene (torch_port.stack_scene, 4 worlds) runs 30 steps in the JAX
package at solver="tgs" (jitted); its states are carried into the port:
  * tgs.substep from the carried state every 6 steps of the first 18,
    joints on, the contacts from each package's own narrowphase, and
  * the physics node at solver="tgs", one step from the carried JAX
    state at each of the 30 steps, on narrowphase="xla" and on
    "kernel_sublane" (the hull-hull record kernel's plain version on the
    CPU),
    both within the golden bounds (tests/golden_inputs.py:484-493:
    pos/rot 1e-3, vel 5e-2, omega 2e-1). Over the first 18 steps the
    node is held against the jitted step. From step 18 on, when the
    sphere lands on the stack, TGS's narrowphase at every substep turns
    resting contacts on and off with the last rounding, and the JAX
    package's jitted step differs from its own op-by-op run
    (jax.disable_jit) by several times the velocity bound; there the
    node is held against the op-by-op step from the same carried state.
    A step may leave a bound only in a world where the op-by-op step
    itself leaves one when every position is scaled by 1 +- 1e-7 (a
    witness: that world's step turns on the last rounding), and at most
    2 of those 12 steps may need a witness;
  * tests/test_physics.py's three TGS behaviours on the port: a box
    settles on the plane (:488), the Escape Room steps at solver="tgs"
    through make_sim at 2 worlds with the agents on the floor and moving
    forward (:528), a fixed joint holds a hanging box (:613);
  * the CollisionEvents export refused under TGS, as the JAX package
    refuses it (a ValueError naming CollisionEvents)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from madrona_tpu.physics import api as japi
from madrona_tpu.physics import broadphase as jbp
from madrona_tpu.physics import tgs as jtgs
from madrona_tpu.physics.xpbd import PhysicsConfig as JConfig
from madrona_tpu_torch import make_sim
from madrona_tpu_torch.core.registry import ECSRegistry
from madrona_tpu_torch.core.state import StateManager
from madrona_tpu_torch.graph.builder import TaskGraphBuilder
from madrona_tpu_torch.graph.executor import Executor
from madrona_tpu_torch.models.escape_room import EscapeRoom
from madrona_tpu_torch.physics import api as tapi
from madrona_tpu_torch.physics import bodies as tbodies
from madrona_tpu_torch.physics import broadphase as tbp
from madrona_tpu_torch.physics import joints as tjoints
from madrona_tpu_torch.physics import tgs as ttgs
from madrona_tpu_torch.physics.geo import box_hull
from madrona_tpu_torch.physics.xpbd import PhysicsConfig

from torch_port import carry_state, jax_tree, stack_scene

torch.set_num_threads(1)

W = 4
STEPS = 30
JIT_STEPS = 18        # steps held against the jitted step; then op-by-op
NUDGES = (1 + 1e-7, 1 - 1e-7)
MAX_WITNESSED = 2
DT = 1.0 / 60.0
H = DT / 4
GRAVITY = (0.0, 0.0, -9.8)
GOLDEN = {"pos": 1e-3, "rot": 1e-3, "vel": 5e-2, "omega": 2e-1}


@pytest.fixture(scope="module")
def jax_run():
    """(executor, ObjectManager, caps, the jitted run's states 0..STEPS,
    {t: the op-by-op step from states[t]} for t >= JIT_STEPS, and
    witness(t): the worlds [W] where the op-by-op step from states[t]
    with nudged positions leaves a golden bound of the unnudged one)."""
    ex, om, caps = stack_scene(False, JConfig(solver="tgs", dt=DT), W)
    fn = ex.step_fn()
    step = jax.jit(fn)
    states = []
    s = ex.state
    for _ in range(STEPS):
        states.append(s)
        s, _ = step(s, {})
    states.append(s)

    def op_by_op(state):
        with jax.disable_jit():
            return _columns(fn(state, {})[0])

    ref = {t: op_by_op(states[t]) for t in range(JIT_STEPS, STEPS)}
    seen = {}

    def witness(t):
        if t not in seen:
            seen[t] = np.zeros(W, bool)
            for f in NUDGES:
                seen[t] |= _outside(op_by_op(_nudged(states[t], f)),
                                    ref[t]).any(1)
        return seen[t]

    return ex, om, caps, states, ref, witness


def _nudged(state, f):
    """A JAX state with every body position scaled by ``f``."""
    t = state.tables[japi.RIGID_BODY]
    cols = dict(t.columns)
    cols["Position"] = cols["Position"] * f
    return dataclasses.replace(state, tables={
        **state.tables,
        japi.RIGID_BODY: dataclasses.replace(t, columns=cols)})


def _outside(got, ref):
    """[W, N] bool: the (world, body) pairs where a field leaves its
    golden bound."""
    return np.any([np.abs(np.asarray(got[k], np.float64)
                          - np.asarray(ref[k], np.float64)).max(-1) > tol
                   for k, tol in GOLDEN.items()], axis=0)


def _assert_golden(t, got, ref):
    for k, tol in GOLDEN.items():
        d = float(np.abs(np.asarray(got[k], np.float64)
                         - np.asarray(ref[k], np.float64)).max())
        assert d <= tol, (t, k, d)


def _fields(body):
    return {k: np.asarray(getattr(body, k)) for k in GOLDEN}


def _columns(state):
    c = jax_tree(state.tables[japi.RIGID_BODY].columns)
    return {"pos": c["Position"], "rot": c["Rotation"],
            "vel": c["Velocity"]["linear"], "omega": c["Velocity"]["angular"]}


def test_substep_matches_jax(jax_run):
    ex, j_om, j_caps, states = jax_run[:4]
    t_ex, t_om, t_caps = stack_scene(True, PhysicsConfig(solver="tgs", dt=DT),
                                     W)
    tcfg = ttgs.TGSConfig()

    @jax.jit
    def j_substep(state):
        b = japi.body_state(ex.sm, state)
        cands = jbp.find_candidates(b, j_om, j_caps, DT)
        return jtgs.substep(
            b, lambda bb: japi._narrowphase_all(bb, j_om, cands,
                                                sat_dirs=True),
            j_om, H, GRAVITY, jtgs.TGSConfig(), jbuf=japi.joints_view(state))

    for t in range(0, JIT_STEPS, 6):
        state = carry_state(states[t])
        b = tapi.body_state(t_ex.sm, state)
        cands = tbp.find_candidates(b, t_om, t_caps, DT)
        got = ttgs.substep(
            b, lambda bb: tapi._narrowphase_all(bb, t_om, cands), t_om, H,
            GRAVITY, tcfg, jbuf=tapi.joints_view(state))
        _assert_golden(t, _fields(got), _fields(j_substep(states[t])))


@pytest.mark.parametrize("narrowphase", ["xla", "kernel_sublane"])
def test_node_matches_jax_each_step(jax_run, narrowphase):
    _, _, _, states, ref, witness = jax_run
    t_ex, _, _ = stack_scene(True, PhysicsConfig(
        solver="tgs", dt=DT, narrowphase=narrowphase), W)
    step = t_ex.step_fn()
    witnessed = []
    for t in range(STEPS):
        got = _columns(step(carry_state(states[t]), {})[0])
        if t < JIT_STEPS:
            _assert_golden(t, got, _columns(states[t + 1]))
            continue
        off = _outside(got, ref[t]).any(1)              # [W] worlds
        if off.any():
            assert not (off & ~witness(t)).any(), (
                t, np.nonzero(off)[0], np.nonzero(witness(t))[0])
            witnessed.append(t)
    assert len(witnessed) <= MAX_WITNESSED, witnessed


def test_tgs_box_settles_on_plane():
    """tests/test_physics.py:488 on the port: 90 steps of a box dropped
    from z = 1 at dt 1/60, 4 substeps, TGS with the plain narrowphase."""
    reg = tbodies.ObjectRegistry()
    box = reg.add_box([0.5, 0.5, 0.5], mass=1.0)
    plane = reg.add_plane()
    om = reg.build()
    z3 = torch.zeros((2, 2, 3))
    pos = z3.clone()
    pos[:, 1, 2] = 1.0
    rot = torch.zeros((2, 2, 4))
    rot[..., 0] = 1.0
    body = tapi.xpbd.BodyState(
        pos=pos, rot=rot, scale=torch.ones((2, 2, 3)), vel=z3, omega=z3,
        obj_id=torch.tensor([[plane, box]] * 2, dtype=torch.int32),
        response=torch.tensor([[tbodies.RESPONSE_STATIC,
                                tbodies.RESPONSE_DYNAMIC]] * 2,
                              dtype=torch.int32),
        ext_force=z3, ext_torque=z3, prev_x=pos, prev_q=rot, presolve_x=pos,
        presolve_q=rot, presolve_v=z3, presolve_w=z3,
        active=torch.ones((2, 2), dtype=torch.bool))
    caps = tbp.CandidateCaps(hull_hull=8, hull_plane=8, sphere_any=8)
    tcfg = ttgs.TGSConfig()
    for _ in range(90):
        cands = tbp.find_candidates(body, om, caps, DT)
        for _ in range(4):
            body = ttgs.substep(
                body, lambda b: tapi._narrowphase_all(b, om, cands), om, H,
                GRAVITY, tcfg)
    assert abs(float(body.pos[0, 1, 2]) - 0.5) < 0.03
    assert float(torch.linalg.vector_norm(body.vel[0, 1])) < 0.2
    assert bool(torch.isfinite(body.pos).all())


def test_tgs_via_physics_config():
    """tests/test_physics.py:528 on the port: the Escape Room through
    make_sim at solver="tgs" (its kernel tiers do not apply to TGS, as in
    the JAX package), 10 steps of forward moves at 2 worlds."""
    env = EscapeRoom()
    env.cfg = dataclasses.replace(env.cfg, solver="tgs")
    sim = make_sim(env, num_worlds=2, seed=0, device="cpu")
    a = torch.zeros((2, 2, 4), dtype=torch.int32)
    a[..., 0] = 3
    a[..., 2] = 2
    for _ in range(10):
        sim.step({"action": a, "reset": torch.zeros((2,), dtype=torch.int32)})
    pos = sim.state.tables["RigidBody"].columns["Position"].numpy()
    assert np.isfinite(pos).all()
    assert (pos[:, 19:, 2] > 0.4).all() and (pos[:, 19:, 2] < 1.2).all()
    assert (pos[:, 19:, 1] > 1.6).all()


def test_tgs_solves_joints():
    """tests/test_physics.py:613 on the port: a fixed joint between a
    static anchor and a box 1 below it keeps the box from falling."""
    w = 2
    sm = StateManager()
    reg = ECSRegistry(sm)
    tapi.register_types(reg, max_bodies=2)
    tapi.register_joint_types(reg, max_joints=1)
    om_r = tbodies.ObjectRegistry()
    box = om_r.add_hull(box_hull((0.3, 0.3, 0.3)), mass=1.0)
    om = om_r.build()
    b = TaskGraphBuilder(sm, "step")
    tapi.setup_physics_step_tasks(b, om, PhysicsConfig(solver="tgs"))
    ex = Executor(sm, {"step": b.build()}, num_worlds=w, seed=0,
                  device="cpu")
    state = ex.state
    t = state.tables["RigidBody"]
    cols = dict(t.columns)
    pos = torch.zeros((w, 2, 3))
    pos[:, 0] = torch.tensor([0, 0, 5.0])
    pos[:, 1] = torch.tensor([0, 0, 4.0])
    rot = torch.zeros((w, 2, 4))
    rot[..., 0] = 1
    cols.update(Position=pos, Rotation=rot, Scale=torch.ones((w, 2, 3)),
                ObjectID=torch.full((w, 2), box, dtype=torch.int32),
                ResponseType=torch.tensor(
                    [[tbodies.RESPONSE_STATIC, tbodies.RESPONSE_DYNAMIC]] * w,
                    dtype=torch.int32))
    state = dataclasses.replace(state, tables={
        **state.tables, "RigidBody": dataclasses.replace(
            t, columns=cols, num_rows=torch.full((w,), 2, dtype=torch.int32))})
    jb = tjoints.make_fixed_joint(
        tapi.joints_view(state), 0, e1=0, e2=1, attach_q1=[1.0, 0, 0, 0],
        attach_q2=[1.0, 0, 0, 0], r1=[0.0, 0, -0.5], r2=[0.0, 0, 0.5])
    ex.state = tapi.write_joints(state, jb)
    for _ in range(30):
        ex.run(inputs={})
    p = ex.state.tables["RigidBody"].columns["Position"].numpy()
    assert np.isfinite(p).all()
    assert (p[:, 1, 2] > 3.0).all(), p[:, 1]


def test_tgs_refuses_collision_events():
    """TGS runs its narrowphase at every substep, so no contacts are
    frozen for the step to export: the node refuses, as the JAX
    package's does (madrona_tpu/physics/api.py:697-707)."""
    import chip_smoke

    def objects(reg, geo):
        reg.add_hull(geo.box_hull((0.5, 0.5, 0.5)), mass=1.0)
        reg.add_plane()

    cfg = PhysicsConfig(narrowphase_once=True, solver="tgs")
    with pytest.raises(ValueError, match="CollisionEvents"):
        chip_smoke.physics_executor(cfg, tbp.CandidateCaps(sphere_any=0), W,
                                    "cpu", 2, objects, max_events=4)
