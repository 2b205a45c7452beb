"""The fused physics step (B8) of the PyTorch port vs the JAX package.

On the CPU ``ops.fused_cuda.fused_step`` runs its plain version (the
oracle of the CUDA kernel ``csrc/fused_step.cu``: integrate, the tensor
narrowphase with every lane kind, the manifold reduction, the plain
substep solver over all rows). Held against:

  * the TPU hardware goldens ``fk_*`` (tests/goldens/kernels_v1.npz) on
    ``golden_inputs.fused_case()`` (a plane, two box sizes and spheres,
    hull-hull, hull-plane and sphere candidates, ``edge_pairs`` SAT),
    through ``compare_goldens``;
  * the JAX package's fused Pallas kernel in interpret mode, un-jitted
    (``megakernel_fused_step``), at W = 4, N = 10, caps 12/10/10, with and
    without two random joint slots, at the JAX package's own tolerance
    for it (rtol 5e-3, atol 5e-4: tests/test_physics_megakernel.py:148).
    Two substeps of one Jacobi pass: such a call takes about 20 s, one
    of four substeps and two passes about 45 s;
  * the port's physics node with ``megakernel_fused=True`` on carried
    Escape Room (grab joints on) and arranged Hide & Seek states (a
    locked box, a held box, ramp wedges in contact), against the JAX
    package's physics node with ``narrowphase="xla"``,
    ``megakernel_fused=False``, jitted (10 s to compile; 32 s un-jitted,
    op by op): bodies after the step within the JAX
    package's fused-pipeline tolerances (Escape Room rtol 2e-3, atol
    2e-4; Hide & Seek rtol 1e-3, atol 2e-4:
    tests/test_physics_megakernel.py:206-210, :243-246)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import golden_inputs
from madrona_tpu.core.registry import ECSRegistry as JRegistry
from madrona_tpu.core.state import StateManager as JStateManager
from madrona_tpu.physics import api as japi
from madrona_tpu.physics import joints as jjoints
from madrona_tpu.physics.xpbd import PhysicsConfig as JPhysicsConfig
from madrona_tpu_torch import make_sim
from madrona_tpu_torch.models.escape_room import EscapeRoom
from madrona_tpu_torch.ops import fused_cuda, solver_cuda
from madrona_tpu_torch.physics import api as tapi
from madrona_tpu_torch.physics import broadphase as tbp
from madrona_tpu_torch.physics import joints as tjoints
from madrona_tpu_torch.physics import xpbd as txpbd

from torch_port import (
    body_arrays, box_sphere_oms, hide_seek_scene, jax_body, jax_cands,
    jax_state, jax_tree, torch_body, with_grab_joints,
)

torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
FIELDS = ("pos", "rot", "vel", "omega", "prev_x", "prev_q", "presolve_x",
          "presolve_q", "presolve_v", "presolve_w")
W, N = 4, 10


def _port_cfg(cfg):
    """The port's PhysicsConfig of a JAX one (the fields that change
    results)."""
    return txpbd.PhysicsConfig(
        dt=cfg.dt, substeps=cfg.substeps, gravity=tuple(cfg.gravity),
        restitution=cfg.restitution,
        restitution_threshold=cfg.restitution_threshold,
        jacobi_iters=cfg.jacobi_iters, narrowphase_once=True,
        megakernel_fused=True, sat_tier=cfg.sat_tier,
    )


def _fused(cfg, body, om, cands, jbuf=None):
    """The port's fused step (its plain version on the CPU)."""
    jargs = (solver_cuda.pack_joints(jbuf, body.pos.shape[1])
             if jbuf is not None else ())
    out = fused_cuda.fused_step(
        cfg, *fused_cuda.pack_fused(body, om), cands.hh, cands.hp, cands.sp,
        cands.sp_kind, om, *jargs)
    return solver_cuda.unpack_out(body, out)


def test_plain_fused_matches_tpu_goldens():
    j_om, j_body, j_cands, cfg = golden_inputs.fused_case()
    assert cfg.sat_tier == "edge_pairs"
    _, t_om = box_sphere_oms()
    body = torch_body(jax_tree(j_body))
    cands = tbp.Candidates(**{k: torch.from_numpy(np.array(v))
                              for k, v in jax_tree(j_cands).items()})
    got = _fused(_port_cfg(cfg), body, t_om, cands)
    keys = [f"fk_{f}" for f in ("pos", "rot", "vel", "omega")]
    golden = np.load(os.path.join(GOLDENS, "kernels_v1.npz"))
    fails = golden_inputs.compare_goldens(
        {k: getattr(got, k[3:]).numpy() for k in keys},
        {k: golden[k] for k in keys})
    assert not fails, fails
    assert float((got.pos - body.pos).abs().max()) > 1e-3


def _joint_arrays(rs):
    """Two random joint slots per world (test_physics_megakernel's)."""
    j = 2

    def q_rand(shape):
        q = rs.randn(*shape, 4).astype(np.float32)
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    e1 = rs.randint(1, N - 1, (W, j)).astype(np.int32)
    e2 = rs.randint(1, N - 1, (W, j)).astype(np.int32)
    e2 = np.where(e2 == e1, (e2 % (N - 2)) + 1, e2).astype(np.int32)
    a1 = rs.randn(W, j, 3).astype(np.float32)
    a1 /= np.linalg.norm(a1, axis=-1, keepdims=True)
    a2 = rs.randn(W, j, 3).astype(np.float32)
    a2 /= np.linalg.norm(a2, axis=-1, keepdims=True)
    return dict(
        e1=e1, e2=e2, jtype=rs.randint(0, 2, (W, j)).astype(np.int32),
        r1=(0.3 * rs.randn(W, j, 3)).astype(np.float32),
        r2=(0.3 * rs.randn(W, j, 3)).astype(np.float32),
        attach_q1=q_rand((W, j)), attach_q2=q_rand((W, j)),
        separation=(0.2 * rs.rand(W, j)).astype(np.float32),
        a1_local=a1, a2_local=a2, active=rs.rand(W, j) < 0.8,
    )


@pytest.mark.parametrize("with_joints", [False, True],
                         ids=["no_joints", "joints"])
def test_plain_fused_matches_pallas_kernel(with_joints):
    import jax.numpy as jnp

    rs = np.random.RandomState(7)
    j_om, t_om = box_sphere_oms()
    arrays = body_arrays(rs, W, N, 4, crowded=True)
    arrays["scale"][:] = 1.0
    arrays["omega"] = (0.3 * rs.randn(W, N, 3)).astype(np.float32)
    arrays["ext_force"] = (0.1 * rs.randn(W, N, 3)).astype(np.float32)
    body = torch_body(arrays)
    cands = tbp.find_candidates(body, t_om, tbp.CandidateCaps(12, 10, 10),
                                1.0 / 30.0)
    live = [int(getattr(cands, k).sum()) for k in ("hh_num", "hp_num",
                                                   "sp_num")]
    assert min(live) > 0, live
    cfg = JPhysicsConfig(substeps=2, jacobi_iters=1, narrowphase_once=True,
                         megakernel_fused=True)
    j_jbuf = t_jbuf = None
    if with_joints:
        ja = _joint_arrays(rs)
        j_jbuf = jjoints.Joints(**{k: jnp.asarray(v) for k, v in ja.items()})
        t_jbuf = tjoints.Joints(**{k: torch.from_numpy(v)
                                   for k, v in ja.items()})
    ref = japi.megakernel_fused_step(jax_body(arrays), jax_cands(cands),
                                     j_om, cfg, jbuf=j_jbuf, interpret=True)
    got = _fused(_port_cfg(cfg), body, t_om, cands, t_jbuf)
    for f in FIELDS:
        np.testing.assert_allclose(
            getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
            rtol=5e-3, atol=5e-4, err_msg=f)


def _jax_node(j_env, state):
    """The JAX package's physics node (XLA narrowphase, not fused) on
    the port's state; the bodies' table after it."""
    import jax

    j_sm = JStateManager()
    j_env.register_types(JRegistry(j_sm))
    cfg = dataclasses.replace(j_env.cfg, megakernel=False,
                              megakernel_fused=False, narrowphase="xla")
    node = japi.make_physics_node(j_sm, j_env.om, cfg, j_env.caps)
    out = jax.jit(lambda s: node(j_sm, s, None))(jax_state(state))
    return jax_tree(out.tables[japi.RIGID_BODY].columns)


def _escape_room_case():
    from madrona_tpu.models.escape_room import EscapeRoom as JEscapeRoom

    env = EscapeRoom()
    sim = make_sim(env, num_worlds=W, seed=2, device="cpu")
    acts = EscapeRoom.random_actions(np.random.RandomState(0), 6, W)
    for i in range(6):
        sim.step({"action": acts[i],
                  "reset": torch.zeros(W, dtype=torch.int32)})
    return env, sim, with_grab_joints(sim.state), JEscapeRoom(), 2e-3


def _hide_seek_case():
    from madrona_tpu.models.hide_seek import HideSeek as JHideSeek

    env, sim, state = hide_seek_scene(W, 3)
    return env, sim, state, JHideSeek(pixels=False), 1e-3


@pytest.mark.parametrize("case", ["escape_room", "hide_seek"])
def test_fused_node_matches_jax_node(case):
    env, sim, state, j_env, rtol = {
        "escape_room": _escape_room_case, "hide_seek": _hide_seek_case,
    }[case]()
    sm = sim.executor.sm
    cfg = dataclasses.replace(env.cfg, megakernel=False,
                              megakernel_fused=True, narrowphase="xla")
    launched = fused_cuda.KERNEL.launches
    node = tapi.make_physics_node(sm, env.om, cfg, env.caps)
    got = node(sm, state, None).tables[tapi.RIGID_BODY].columns
    assert fused_cuda.KERNEL.launches == launched
    ref = _jax_node(j_env, state)
    before = state.tables[tapi.RIGID_BODY].columns["Position"]
    assert float((got["Position"] - before).abs().max()) > 1e-3
    for a, b in (
        (got["Position"], ref["Position"]), (got["Rotation"], ref["Rotation"]),
        (got["Velocity"]["linear"], ref["Velocity"]["linear"]),
        (got["Velocity"]["angular"], ref["Velocity"]["angular"]),
    ):
        np.testing.assert_allclose(a.numpy(), b, rtol=rtol, atol=2e-4)
    # the fused step took contacts: some body rests on or touches another
    body = tapi.body_state(sm, state)
    cands = tbp.find_candidates(body, env.om, env.caps, env.cfg.dt)
    assert int(cands.hh_num.sum()) + int(cands.hp_num.sum()) >= 2 * W
