"""The Gauss-Seidel oracle of the PyTorch port against the JAX package
(tests/test_physics.py:379-486, solver="gauss_seidel").

The scene (torch_port.stack_scene, 4 worlds): a plane, two stacked boxes
held together by a fixed joint (odd worlds) or a hinge (even worlds),
and a sphere dropped onto them off center. The JAX sim runs 30 steps at
solver="gauss_seidel"; its states are carried into the port.
  * solve_positions, solve_velocities (after set_velocities) and
    solve_joints from the carried state after 18 steps (hull-hull,
    hull-plane and sphere lanes live), on the same contacts: pos/rot
    within 1e-5, lambda_n within 1e-5, vel within 1e-4, omega within
    1e-3;
  * the physics node, one step from the carried JAX state at each of the
    30 steps: within the golden bounds (tests/golden_inputs.py:484-493:
    pos/rot 1e-3, vel 5e-2, omega 2e-1);
  * tests/test_physics.py's fixed-joint and hinge scenes on the port,
    with the JAX test's bounds;
  * the ValueError of each tier that refuses a non-Jacobi solver, as the
    JAX package raises it;
  * the step with every short float sum taken in the order an H100's
    reduction took it: equal bit for bit to the step as it runs, at
    every third carried state and at the state an H100 reached after 16
    steps (tests/goldens/torch_gs_card_state16.npz), where one step is
    also held to the JAX oracle's within the golden bounds."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from madrona_tpu.physics import api as japi
from madrona_tpu.physics import broadphase as jbp
from madrona_tpu.physics import joints as jjoints
from madrona_tpu.physics import xpbd as jxpbd
from madrona_tpu.physics.xpbd import PhysicsConfig as JConfig
from madrona_tpu_torch.physics import api as tapi
from madrona_tpu_torch.physics import bodies as tbodies
from madrona_tpu_torch.physics import broadphase as tbp
from madrona_tpu_torch.physics import joints as tjoints
from madrona_tpu_torch.physics import xpbd as txpbd
from madrona_tpu_torch.physics.xpbd import PhysicsConfig
from madrona_tpu_torch.utils import math3d as m3

from torch_port import carry_state, jax_tree, stack_scene

torch.set_num_threads(1)

W = 4
STEPS = 30
AT = 18
DT = 1.0 / 60.0
H = DT / 4
GRAVITY = (0.0, 0.0, -9.8)
GOLDEN = {"Position": 1e-3, "Rotation": 1e-3, "linear": 5e-2,
          "angular": 2e-1}


@pytest.fixture(scope="module")
def jax_run():
    """(JAX executor, ObjectManager, caps, states before each step)."""
    ex, om, caps = stack_scene(False, JConfig(solver="gauss_seidel", dt=DT),
                               W)
    step = jax.jit(ex.step_fn())
    states = []
    s = ex.state
    for _ in range(STEPS):
        states.append(s)
        s, _ = step(s, {})
    states.append(s)
    return ex, om, caps, states


def _torch_tree(x, cls):
    return cls(**{k: torch.from_numpy(np.array(v))
                  for k, v in jax_tree(x).items()})


def _diff(got, ref):
    return float(np.abs(got.numpy().astype(np.float64) - np.asarray(ref))
                 .max())


@pytest.mark.parametrize("part", ["positions", "velocities", "joints"])
def test_solves_match_jax(jax_run, part):
    ex, j_om, j_caps, states = jax_run
    _, t_om, _ = stack_scene(True, PhysicsConfig(solver="gauss_seidel",
                                                 dt=DT), W)
    j_state = states[AT]
    pred, c = jax.jit(lambda b: (
        lambda p: (p, japi._narrowphase_all(
            p, j_om, jbp.find_candidates(b, j_om, j_caps, DT),
            sat_dirs=True)))(jxpbd.integrate(b, j_om, H, GRAVITY)))(
        japi.body_state(ex.sm, j_state))
    num = np.asarray(c.num)
    assert (num[:, :1] > 0).all() and (num[:, 2:6] > 0).any() \
        and (num[:, 6:] > 0).any()
    t_pred = _torch_tree(pred, txpbd.BodyState)
    t_c = _torch_tree(c, txpbd.Contacts)
    if part == "positions":
        jb, jc = jax.jit(lambda b, c: jxpbd.solve_positions(b, c, j_om))(
            pred, c)
        tb, tc = txpbd.solve_positions(t_pred, t_c, t_om)
        assert _diff(tc.lambda_n, jc.lambda_n) <= 1e-5
        assert float(np.abs(np.asarray(jc.lambda_n)).max()) > 1e-3
        tols = {"pos": 1e-5, "rot": 1e-5}
    elif part == "velocities":
        jp, jc = jax.jit(lambda b, c: jxpbd.solve_positions(b, c, j_om))(
            pred, c)
        jp = jxpbd.set_velocities(jp, H)
        jb = jax.jit(lambda b, c: jxpbd.solve_velocities(
            b, c, j_om, H, 0.3, 0.2))(jp, jc)
        tb = txpbd.solve_velocities(_torch_tree(jp, txpbd.BodyState),
                                    _torch_tree(jc, txpbd.Contacts), t_om,
                                    H, 0.3, 0.2)
        tols = {"vel": 1e-4, "omega": 1e-3}
    else:
        jj = japi.joints_view(j_state)
        jb = jax.jit(lambda b: jjoints.solve_joints(b, jj, j_om))(pred)
        tb = tjoints.solve_joints(t_pred, tapi.joints_view(
            carry_state(j_state)), t_om)
        tols = {"pos": 1e-5, "rot": 1e-5}
        # the joints moved the boxes
        assert float(np.abs(np.asarray(jb.pos) - np.asarray(pred.pos))
                     .max()) > 1e-4
    for f, tol in tols.items():
        assert _diff(getattr(tb, f), getattr(jb, f)) <= tol, f


def test_node_matches_jax_each_step(jax_run):
    """One step of the port's node from the carried JAX state at each of
    30 steps, within the golden bounds."""
    ex, _, _, states = jax_run
    t_ex, _, _ = stack_scene(True, PhysicsConfig(solver="gauss_seidel",
                                                 dt=DT), W)
    step = t_ex.step_fn()
    worst = {k: 0.0 for k in GOLDEN}
    for t in range(STEPS):
        got, _ = step(carry_state(states[t]), {})
        gc = got.tables[tapi.RIGID_BODY].columns
        rc = jax_tree(states[t + 1].tables[japi.RIGID_BODY].columns)
        for k, g, r in (
            ("Position", gc["Position"], rc["Position"]),
            ("Rotation", gc["Rotation"], rc["Rotation"]),
            ("linear", gc["Velocity"]["linear"], rc["Velocity"]["linear"]),
            ("angular", gc["Velocity"]["angular"],
             rc["Velocity"]["angular"]),
        ):
            worst[k] = max(worst[k], _diff(g, r))
    for k, tol in GOLDEN.items():
        assert worst[k] <= tol, (k, worst)


class _PairedSums(TorchDispatchMode):
    """Float sums over one axis of 3 to 8 terms taken as the card's
    reduction took four terms on an H100: the even terms and the odd
    terms summed apart, then added ((t0 + t2) + (t1 + t3))."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.ops.aten.sum.dim_IntList:
            x, dims = args[0], args[1]
            keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
            if (x.dtype == torch.float32 and dims is not None
                    and len(dims) == 1 and 2 < x.shape[dims[0]] <= 8
                    and kwargs.get("dtype") is None):
                parts = x.unbind(dims[0])
                even, odd = parts[0], parts[1]
                for p in parts[2::2]:
                    even = even + p
                for p in parts[3::2]:
                    odd = odd + p
                out = even + odd
                return out.unsqueeze(dims[0]) if keep else out
        return func(*args, **kwargs)


def test_step_does_not_depend_on_the_sum_order(jax_run):
    """The squares of a quaternion that an H100 summed to 1.0000004768
    where the CPU gets 1.0000003576 (the card pairs the terms): in
    chip_smoke.py's phase 29 that one ulp of a norm in the position solve
    put a body's velocity 0.084 off the CPU's after step 16
    (scripts/torch_gauss_seidel_ops.py finds such an op). The step sums
    its short axes in a fixed order, so with every such float sum taken
    in the card's pairing it is the same bit for bit, at every third of
    the 30 carried states."""
    sq = torch.tensor([0.49992892146110535, 3.717255125934571e-08,
                       2.874797644381033e-08, 0.5000714063644409])
    with _PairedSums():
        paired = float(sq.sum(dim=-1))
    assert (paired, float(sq.sum(dim=-1))) == (1.0000004768371582,
                                               1.0000003576278687)
    _, _, _, states = jax_run
    t_ex, _, _ = stack_scene(True, PhysicsConfig(solver="gauss_seidel",
                                                 dt=DT), W)
    step = t_ex.step_fn()
    for t in range(0, STEPS, 3):
        want = step(carry_state(states[t]), {})[0]
        with _PairedSums():
            got = step(carry_state(states[t]), {})[0]
        gc = got.tables[tapi.RIGID_BODY].columns
        wc = want.tables[tapi.RIGID_BODY].columns
        for k in ("Position", "Rotation"):
            assert torch.equal(gc[k], wc[k]), (t, k)
        for k in ("linear", "angular"):
            assert torch.equal(gc["Velocity"][k], wc["Velocity"][k]), (t, k)


CARD_STATE = os.path.join(os.path.dirname(__file__), "goldens",
                          "torch_gs_card_state16.npz")


def test_card_state_after_16_steps():
    """The state of worlds 0-7 of chip_smoke.py phase 29's stack after 16
    steps on an H100 (before the ordered sums; saved by
    scripts/torch_gauss_seidel_ops.py --save), where the card's step put
    world 4's body 1 0.084 off the CPU's: one step of the port on the
    CPU within the golden bounds of the JAX oracle's from the same state
    (world 4 body 1 within 0.02 in velocity; the state is near a contact
    switch for the JAX package too), and bit for bit the same with every
    short float sum in the card's pairing."""
    from madrona_tpu.utils import checkpoint as j_ckpt
    from madrona_tpu_torch.utils import checkpoint as t_ckpt

    j_ex, _, _ = stack_scene(False, JConfig(solver="gauss_seidel", dt=DT),
                             8)
    j_next = jax.jit(j_ex.step_fn())(j_ckpt.load_npz(CARD_STATE,
                                                      j_ex.state), {})[0]
    t_ex, _, _ = stack_scene(True, PhysicsConfig(solver="gauss_seidel",
                                                 dt=DT), 8)
    step = t_ex.step_fn()
    want = step(t_ckpt.load_npz(CARD_STATE, t_ex.state), {})[0]
    with _PairedSums():
        got = step(t_ckpt.load_npz(CARD_STATE, t_ex.state), {})[0]
    wc = want.tables[tapi.RIGID_BODY].columns
    gc = got.tables[tapi.RIGID_BODY].columns
    rc = jax_tree(j_next.tables[japi.RIGID_BODY].columns)
    for k, g, t, r in (
        ("Position", gc["Position"], wc["Position"], rc["Position"]),
        ("Rotation", gc["Rotation"], wc["Rotation"], rc["Rotation"]),
        ("linear", gc["Velocity"]["linear"], wc["Velocity"]["linear"],
         rc["Velocity"]["linear"]),
        ("angular", gc["Velocity"]["angular"], wc["Velocity"]["angular"],
         rc["Velocity"]["angular"]),
    ):
        assert torch.equal(g, t), k
        assert _diff(t, r) <= GOLDEN[k], k
    assert _diff(wc["Velocity"]["linear"][4, 1],
                 rc["Velocity"]["linear"][4, 1]) <= 0.02


def _om():
    reg = tbodies.ObjectRegistry()
    reg.add_box([0.5, 0.5, 0.5], mass=1.0)          # 0
    reg.add_plane()                                  # 1
    return reg.build()


def _world(rows):
    """tests/test_physics.py::make_world on the port: W=2 identical
    worlds from a list of body dicts."""
    n = len(rows)

    def arr(key, default):
        vals = np.stack([np.asarray(r.get(key, default), np.float32)
                         for r in rows])
        return torch.from_numpy(np.tile(vals[None], (2, 1, 1)))

    z3, ident = [0.0, 0.0, 0.0], [1.0, 0, 0, 0]
    ints = lambda key, default: torch.from_numpy(np.tile(   # noqa: E731
        np.array([r.get(key, default) for r in rows], np.int32)[None],
        (2, 1)))
    return txpbd.BodyState(
        pos=arr("pos", z3), rot=arr("rot", ident),
        scale=arr("scale", [1, 1, 1]), vel=arr("vel", z3),
        omega=arr("omega", z3), obj_id=ints("obj", 0),
        response=ints("response", tbodies.RESPONSE_DYNAMIC),
        ext_force=arr("f", z3), ext_torque=arr("tau", z3),
        prev_x=arr("pos", z3), prev_q=arr("rot", ident),
        presolve_x=arr("pos", z3), presolve_q=arr("rot", ident),
        presolve_v=arr("vel", z3), presolve_w=arr("omega", z3),
        active=torch.ones((2, n), dtype=torch.bool),
    )


def _run_with_joints(body, joints, om, steps):
    """tests/test_physics.py::run_steps_with_joints on the port (its
    scenes hold one body pair and no contact, so small candidate caps)."""
    caps = tbp.CandidateCaps(hull_hull=2, hull_plane=2, sphere_any=2)
    cfg = PhysicsConfig(dt=DT, substeps=4, gravity=GRAVITY)
    for _ in range(steps):
        cands = tbp.find_candidates(body, om, caps, cfg.dt)
        for _ in range(cfg.substeps):
            body = txpbd.integrate(body, om, H, cfg.gravity)
            contacts = tapi._narrowphase_all(body, om, cands)
            body, contacts = txpbd.solve_positions(body, contacts, om)
            body = tjoints.solve_joints(body, joints, om)
            body = txpbd.set_velocities(body, H)
            body = txpbd.solve_velocities(body, contacts, om, H,
                                          cfg.restitution,
                                          cfg.restitution_threshold)
    return body


@pytest.mark.parametrize("kind", ["fixed", "hinge"])
def test_joint_scenes(kind):
    """tests/test_physics.py:410 (two boxes fixed-jointed, falling: the
    attachment points stay together, the orientations equal) and :444
    (a box on a hinge under a static anchor swings in the xz-plane at
    the hinge's distance), on the port, with the JAX test's bounds."""
    om = _om()
    if kind == "fixed":
        body = _world([dict(obj=0, pos=[0.0, 0.0, 5.0]),
                       dict(obj=0, pos=[1.2, 0.0, 5.0])])
        joints = tjoints.make_fixed_joint(
            tjoints.empty_joints(2, 2, device="cpu"), 0, e1=0, e2=1,
            attach_q1=[1.0, 0, 0, 0], attach_q2=[1.0, 0, 0, 0],
            r1=[0.6, 0, 0.0], r2=[-0.6, 0, 0.0], separation=0.0)
        out = _run_with_joints(body, joints, om, 30)
        p1, p2 = out.pos[0, 0].numpy(), out.pos[0, 1].numpy()
        np.testing.assert_allclose(p2 - p1, [1.2, 0, 0], atol=5e-3)
        assert abs(float((out.rot[0, 0] * out.rot[0, 1]).sum())) > 1 - 1e-4
        assert p1[2] < 4.5
        return
    body = _world([dict(obj=0, pos=[0.0, 0.0, 0.0],
                        response=tbodies.RESPONSE_STATIC),
                   dict(obj=0, pos=[1.2, 0.0, 0.0])])
    joints = tjoints.make_hinge_joint(
        tjoints.empty_joints(2, 1, device="cpu"), 0, e1=0, e2=1,
        a1_local=[0.0, 1.0, 0.0], a2_local=[0.0, 1.0, 0.0],
        r1=[0.0, 0, 0.0], r2=[-1.2, 0, 0.0])
    out = _run_with_joints(body, joints, om, 40)
    p, q = out.pos[0, 1], out.rot[0, 1]
    r2_world = (m3.quat_rotate(q, torch.tensor([-1.2, 0, 0.0])) + p).numpy()
    np.testing.assert_allclose(r2_world, [0, 0, 0], atol=2e-2)
    p = p.numpy()
    assert p[2] < -0.3
    np.testing.assert_allclose(np.linalg.norm(p), 1.2, atol=2e-2)
    assert abs(p[1]) < 1e-3
    np.testing.assert_allclose(out.pos[1, 1].numpy(), p, atol=1e-6)


@pytest.mark.parametrize("change, match", [
    (dict(megakernel_fused=True, narrowphase_once=True), "megakernel_fused"),
    (dict(narrowphase="pallas_mega", narrowphase_once=True,
          megakernel=True), "pallas_mega"),
    (dict(megakernel=True, narrowphase_once=True), "megakernel requires"),
])
def test_non_jacobi_tiers_raise(change, match):
    """The tiers that refuse a non-Jacobi solver in the JAX package
    (api.py:733-738, :756-761, :821-825) refuse "gauss_seidel" here with
    ValueError, when the node is built."""
    cfg = dataclasses.replace(PhysicsConfig(solver="gauss_seidel"), **change)
    with pytest.raises(ValueError, match=match):
        stack_scene(True, cfg, 2)
