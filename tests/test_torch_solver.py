"""Substep solver of the PyTorch port vs the JAX package.

On the CPU ``ops.solver_cuda.substep_solver`` runs its plain version
(the oracle of the CUDA kernel ``csrc/solver.cu``). It is held against:

  * the TPU hardware goldens ``mk_*`` (tests/goldens/kernels_v1.npz) and
    ``dr_*`` (kernels_v2.npz, ``dyn_range=(4, 16)``) on
    ``golden_inputs.golden_case()`` (W = 8, N = 16, 24 contacts, 2 Jacobi
    iterations), through ``compare_goldens``' own tolerances;
  * one interpret-mode call of the Pallas kernel
    (``make_substep_solver``) at the Escape Room shape (N = 21, C = 16,
    J = 2, 4 substeps, 1 iteration, ``dyn_range=(13, 21)``,
    ``ref_dyn_lanes=8``) with a grab joint switched on, on a state the
    port's own CPU sim made from a seed: all 33 output fields;
  * one more such call at Hide & Seek's shape (N = 14, C = 7 + 9,
    J = 4 joint slots of which one is live in world 0 and the others carry
    e1 = e2 = -1, ``dyn_range=(5, 14)``, ``ref_dyn_lanes=7``, a locked box
    as a static row inside the dynamic range, agents with infinite x/y
    inertia), one substep of the env's substep length (the interpret-mode
    call costs about 7 s a substep; the Escape Room case above runs all
    four): all 33 output fields.

Tolerances are the JAX package's golden bounds
(tests/golden_inputs.py:484-492): positions and rotations 1e-3, linear
velocities 5e-2, angular velocities 2e-1; static rows exactly equal
their inputs."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_inputs
from madrona_tpu.ops import solver_pallas as spk
from madrona_tpu_torch import make_sim
from madrona_tpu_torch.models import escape_room as er
from madrona_tpu_torch.models.escape_room import EscapeRoom
from madrona_tpu_torch.ops import (
    broadphase_cuda, contacts_cuda, lidar_cuda, solver_cuda,
)
from madrona_tpu_torch.physics import api as tapi
from madrona_tpu_torch.physics import bodies as tbodies
from madrona_tpu_torch.physics import broadphase as tbp
from madrona_tpu_torch.physics import geo as tgeo
from madrona_tpu_torch.physics import xpbd as txpbd

from torch_port import (
    SOLVER_FIELDS as FIELDS, hide_seek_kernel_inputs, hide_seek_scene,
    jax_tree, torch_body, with_grab_joints,
)

torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
W = 4
def _golden_om():
    reg = tbodies.ObjectRegistry()
    reg.add_plane()
    reg.add_hull(tgeo.box_hull((0.5, 0.5, 0.5)), mass=1.0)
    reg.add_hull(tgeo.box_hull((0.4, 0.8, 0.3)), mass=2.5)
    return reg.build()


@pytest.mark.parametrize("prefix, npz, static_rows, dyn_range", [
    ("mk", "kernels_v1.npz", 1, None),
    ("dr", "kernels_v2.npz", 4, (4, golden_inputs.N)),
])
def test_plain_solver_matches_tpu_goldens(prefix, npz, static_rows,
                                          dyn_range):
    _, j_body, _, j_contacts, cfg = golden_inputs.golden_case()
    arrays = jax_tree(j_body)
    arrays["response"] = arrays["response"].copy()
    arrays["response"][:, :static_rows] = tbodies.RESPONSE_STATIC
    body = torch_body(arrays)
    contacts = txpbd.Contacts(**{
        k: torch.from_numpy(np.array(v))
        for k, v in jax_tree(j_contacts).items()
    })
    om = _golden_om()
    spec = txpbd.PhysicsConfig(
        dt=cfg.dt, substeps=cfg.substeps, gravity=tuple(cfg.gravity),
        restitution=cfg.restitution,
        restitution_threshold=cfg.restitution_threshold,
        jacobi_iters=cfg.jacobi_iters, narrowphase_once=True,
        megakernel=True, solver_dynamic_range=dyn_range,
    )
    state, param = solver_cuda.pack_state(body, om)
    out = solver_cuda.substep_solver(
        spec, state, param, *solver_cuda.pack_contacts(contacts)
    )
    got = solver_cuda.unpack_out(body, out)
    golden = np.load(os.path.join(GOLDENS, npz))
    keys = [f"{prefix}_{f}" for f in ("pos", "rot", "vel", "omega")]
    fails = golden_inputs.compare_goldens(
        {k: getattr(got, k.split("_")[1]).numpy() for k in keys},
        {k: golden[k] for k in keys},
    )
    assert not fails, fails


@pytest.fixture(scope="module")
def escape_room_case():
    """The solver's packed inputs at an Escape Room state 12 steps in
    (port CPU sim, seeded actions, bodies kicked so that contacts are
    live), the port's output and the Pallas kernel's (one jitted
    interpret-mode call)."""
    env = EscapeRoom()
    sim = make_sim(env, num_worlds=W, seed=2, device="cpu")
    acts = EscapeRoom.random_actions(np.random.RandomState(0), 12, W)
    kernels = (broadphase_cuda.KERNEL, contacts_cuda.KERNEL,
               solver_cuda.KERNEL, lidar_cuda.KERNEL)
    before = [k.launches for k in kernels]
    for i in range(12):
        sim.step({"action": acts[i],
                  "reset": torch.zeros(W, dtype=torch.int32)})
    launched = [k.launches - b for k, b in zip(kernels, before)]
    state = with_grab_joints(sim.state)
    cfg = env.cfg
    rs = np.random.RandomState(1)
    kick = lambda s: torch.from_numpy(                      # noqa: E731
        (s * rs.randn(W, er.N_BODIES, 3)).astype(np.float32))
    body = tapi.body_state(sim.executor.sm, state)
    body = dataclasses.replace(
        body, vel=body.vel + kick(0.5), ext_force=body.ext_force + kick(1.0),
        ext_torque=kick(0.2),
    )
    h = cfg.dt / cfg.substeps
    cands = tbp.find_candidates(body, env.om, env.caps, cfg.dt)
    pred = txpbd.integrate(body, env.om, h, cfg.gravity)
    poses, obj = contacts_cuda.pack_poses(pred, body.obj_id)
    cargs = contacts_cuda.contacts(cands.hh, cands.hp, poses, obj, env.om)
    state_t, param_t = solver_cuda.pack_state(body, env.om)
    jargs = solver_cuda.pack_joints(tapi.joints_view(state), er.N_BODIES)
    got = solver_cuda.substep_solver(cfg, state_t, param_t, *cargs, *jargs)

    fn = spk.make_substep_solver(
        er.N_BODIES, cargs[0].shape[0], cfg.substeps, cfg.jacobi_iters, h,
        cfg.gravity, cfg.restitution, cfg.restitution_threshold,
        n_joints=jargs[0].shape[0], tile_w=W, interpret=True,
        dyn_range=cfg.solver_dynamic_range,
        ref_dyn_lanes=cfg.solver_ref_dyn_lanes,
    )
    args = (state_t, param_t, *cargs, *jargs)
    ref = np.asarray(fn(*(jnp.asarray(a.numpy()) for a in args)))
    return dict(cfg=cfg, state=state_t.numpy(), con=cargs[2].numpy(),
                jnt=jargs[2].numpy(), got=got.numpy(), ref=ref,
                launched=launched)


def test_escape_room_case_is_live(escape_room_case):
    c = escape_room_case
    assert c["cfg"].solver_dynamic_range == (er.ROW_CUBE0, er.N_BODIES)
    assert c["cfg"].solver_ref_dyn_lanes == 8
    assert (c["con"][7] > 0.5).sum() >= 4 * W       # contacts ok
    assert (c["jnt"][21] > 0.5).sum() == W // 2 + 1  # joints ok
    assert c["got"].shape == (solver_cuda.OUT_F, er.N_BODIES, W)
    assert np.isfinite(c["got"]).all()
    # the step moved the dynamic rows
    d0 = c["cfg"].solver_dynamic_range[0]
    assert np.abs(c["got"][:3, d0:] - c["state"][:3, d0:]).max() > 1e-3


@pytest.mark.parametrize("name, lo, hi, tol", FIELDS,
                         ids=[f[0] for f in FIELDS])
def test_plain_solver_matches_pallas_kernel(escape_room_case, name, lo, hi,
                                            tol):
    c = escape_room_case
    d = np.abs(c["got"][lo:hi].astype(np.float64) - c["ref"][lo:hi]).max()
    assert d <= tol, (name, d)


def test_static_rows_equal_their_inputs(escape_room_case):
    c = escape_room_case
    d0 = c["cfg"].solver_dynamic_range[0]
    for out in (c["got"], c["ref"]):
        np.testing.assert_array_equal(out[:13, :d0], c["state"][:, :d0])
        np.testing.assert_array_equal(out[13:20, :d0], c["state"][:7, :d0])
        np.testing.assert_array_equal(out[20:27, :d0], c["state"][:7, :d0])
        assert (out[27:33, :d0] == 0.0).all()


@pytest.fixture(scope="module")
def hide_seek_case():
    from madrona_tpu_torch.models import hide_seek as hs

    env, sim, state = hide_seek_scene(W, 3)
    _, _, _, args = hide_seek_kernel_inputs(env, sim, state)
    # one substep of the env's length h
    cfg = dataclasses.replace(env.cfg, dt=env.cfg.dt / env.cfg.substeps,
                              substeps=1)
    got = solver_cuda.substep_solver(cfg, *args)
    fn = spk.make_substep_solver(
        hs.N_BODIES, args[2].shape[0], cfg.substeps, cfg.jacobi_iters,
        cfg.dt / cfg.substeps, cfg.gravity, cfg.restitution,
        cfg.restitution_threshold, n_joints=args[7].shape[0], tile_w=W,
        interpret=True, dyn_range=cfg.solver_dynamic_range,
        ref_dyn_lanes=cfg.solver_ref_dyn_lanes,
    )
    ref = np.asarray(fn(*(jnp.asarray(a.numpy()) for a in args)))
    return dict(cfg=cfg, state=args[0].numpy(), param=args[1].numpy(),
                con=args[4].numpy(), jnt=args[9].numpy(), je=args[7].numpy(),
                got=got.numpy(), ref=ref, locked_row=hs.ROW_BOX0)


@pytest.mark.parametrize("name, lo, hi, tol", FIELDS,
                         ids=[f[0] for f in FIELDS])
def test_hide_seek_shape_matches_pallas_kernel(hide_seek_case, name, lo, hi,
                                               tol):
    c = hide_seek_case
    d = np.abs(c["got"][lo:hi].astype(np.float64) - c["ref"][lo:hi]).max()
    assert d <= tol, (name, d)


def test_hide_seek_shape_static_rows_and_joints(hide_seek_case):
    c = hide_seek_case
    assert c["cfg"].solver_dynamic_range == (5, 14)
    assert c["cfg"].solver_ref_dyn_lanes == 7
    assert c["got"].shape == (solver_cuda.OUT_F, 14, W)
    assert np.isfinite(c["got"]).all()
    assert (c["con"][7] > 0.5).sum() >= 8 * W          # contacts ok
    assert (c["jnt"][21] > 0.5).sum() == 1              # world 0, slot 2
    assert (c["je"] == -1).sum() == 4 * W - 1           # the other slots
    # the locked box (even worlds) is a static row inside the dynamic
    # range: it stays where it was, in both packages
    row = c["locked_row"]
    for out in (c["got"], c["ref"]):
        np.testing.assert_array_equal(out[:13, row, 0::2],
                                      c["state"][:, row, 0::2])
    # the same box moves in the odd worlds, and so does the held box
    assert np.abs(c["got"][:3, row, 1::2] - c["state"][:3, row, 1::2]
                  ).max() > 1e-4
    assert np.abs(c["got"][:3, row + 2, 0] - c["state"][:3, row + 2, 0]
                  ).max() > 1e-4


def test_cpu_step_launches_no_kernel(escape_room_case):
    """On CPU tensors every wrapper took its plain version."""
    assert escape_room_case["launched"] == [0, 0, 0, 0]


def test_env_config_names_the_kernel_tiers():
    env = EscapeRoom()
    assert env.cfg.narrowphase == "kernel_mega"
    assert env.cfg.megakernel and env.cfg.narrowphase_once
    assert env.cfg.broadphase == "kernel"
    sim = make_sim(env, num_worlds=2, seed=0, device="cpu")
    # the node builds for these tiers (it used to raise NotImplementedError)
    tapi.make_physics_node(sim.executor.sm, env.om, env.cfg, env.caps)


@pytest.mark.parametrize("change, caps, error", [
    (dict(narrowphase_once=False), None, ValueError),
    (dict(megakernel=False), None, ValueError),
    (dict(), tbp.CandidateCaps(hull_hull=8, hull_plane=8, sphere_any=2),
     ValueError),
    (dict(narrowphase="xla", narrowphase_once=False), None, ValueError),
    # the JAX package's name of kernel_sublane, with contacts per substep
    (dict(narrowphase="pallas_sublane", narrowphase_once=False), None,
     ValueError),
    (dict(megakernel_fused=True, narrowphase_once=False), None, ValueError),
    (dict(sat_tier="edge_triples"), None, ValueError),
    (dict(narrowphase="kernel_sublane", narrowphase_once=False), None,
     ValueError),
])
def test_unsupported_configs_raise(change, caps, error):
    env = EscapeRoom()
    sim = make_sim(env, num_worlds=2, seed=0, device="cpu")
    cfg = dataclasses.replace(env.cfg, **change)
    with pytest.raises(error):
        tapi.make_physics_node(sim.executor.sm, env.om, cfg,
                               caps or env.caps)


@pytest.mark.parametrize("change", [
    dict(narrowphase="kernel_sublane"),
    dict(narrowphase="kernel", sat_tier="edge_pairs"),
    dict(narrowphase="kernel_sublane", megakernel=False,
         narrowphase_once=False),
    dict(megakernel_fused=True, megakernel=False, narrowphase="xla"),
    dict(megakernel_fused=True, sat_tier="edge_pairs"),
    dict(sat_tier="edge_pairs"),
], ids=["kernel_sublane", "kernel", "kernel_sublane_per_substep", "fused",
        "fused_over_kernel_mega", "kernel_mega_edge_pairs"])
def test_new_tiers_build(change):
    """The hull-hull record tiers, the fused step and the edge_pairs SAT
    tier build a physics node for the Escape Room."""
    env = EscapeRoom()
    sim = make_sim(env, num_worlds=2, seed=0, device="cpu")
    cfg = dataclasses.replace(env.cfg, **change)
    assert callable(tapi.make_physics_node(sim.executor.sm, env.om, cfg,
                                           env.caps))


def test_library_path_covers_included_headers(monkeypatch, tmp_path):
    """A kernel library is keyed by its source and every csrc header it
    includes: editing a header that a source includes, directly or
    through another header, gives the source a new library; an edit
    elsewhere does not."""
    import shutil

    from madrona_tpu_torch.ops import cuda_build

    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    monkeypatch.setattr(cuda_build, "CSRC", csrc)
    assert cuda_build.includes("fused_step.cu") == [
        "fused_step.cu", "lanes.cuh", "solver.cuh", "sat_warp.cuh",
        "vec.cuh", "sat.cuh"]
    before = {s: cuda_build.library_path(s) for s in cuda_build.SOURCES}
    with open(csrc / "vec.cuh", "a") as f:
        f.write("// edited\n")
    after = {s: cuda_build.library_path(s) for s in cuda_build.SOURCES}
    changed = {s for s in before if before[s] != after[s]}
    assert changed == {"contacts.cu", "solver.cu", "hh_narrowphase.cu",
                       "fused_step.cu"}
    with open(csrc / "solver.cuh", "a") as f:
        f.write("// edited\n")
    again = {s: cuda_build.library_path(s) for s in cuda_build.SOURCES}
    assert {s for s in after if after[s] != again[s]} == {
        "solver.cu", "fused_step.cu"}
    with open(csrc / "lanes.cuh", "a") as f:
        f.write("// edited\n")
    last = {s: cuda_build.library_path(s) for s in cuda_build.SOURCES}
    assert {s for s in again if again[s] != last[s]} == {
        "contacts.cu", "hh_narrowphase.cu", "fused_step.cu"}


def test_launch_path_refuses_cpu_tensors():
    """The kernel's launch path takes CUDA tensors only."""
    spec = txpbd.PhysicsConfig()
    ints = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        solver_cuda._launch(
            spec, torch.zeros((13, 3, 2)), torch.zeros((20, 3, 2)), ints,
            ints, torch.zeros((8, 1, 2)), torch.zeros((16, 1, 2)), ints,
            None, None, None)


def test_build_without_compiler_raises(monkeypatch, tmp_path):
    """No compiler and no built library: the build raises, so a launch
    on the card can never fall back to the plain version."""
    from madrona_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build(["solver.cu", "contacts.cu"])
    assert set(cuda_build.SOURCE_FLAGS) >= {"solver.cu", "contacts.cu"}
    assert all("--fmad=false" in f for f in cuda_build.SOURCE_FLAGS.values())
