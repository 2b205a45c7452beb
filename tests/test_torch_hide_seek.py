"""Hide & Seek of the PyTorch port vs the JAX package, step by step.

One module-scoped JAX sim (``HideSeek(pixels=False)``, 4 worlds, seeded
random actions) supplies states at steps 0, 6 and 100 (past the prep
phase); each is carried into the port (madrona_tpu_torch.interop) and
both packages take the same next step. Tolerances:
  integer exports (done): exact;
  body state after the step: pos/rot 1e-3, vel 5e-2, omega 2e-1 (the JAX
    package's kernel-golden bounds, tests/golden_inputs.py:484-492);
  self_obs and flat_obs: 1e-3 on the position and heading columns (both
    divide positions by ARENA = 20), 5e-2 / MAX_SPEED on the velocity
    columns; the reward follows ``visible``;
  ``visible`` (and the flat_obs and reward entries that copy it) after
    the step may differ only where the JAX side's margin to one of its two
    thresholds (cone cosine, line-of-sight depth) is under 1e-3;
  threshold decisions on one and the same state, exact: the port's
    ``_action_system`` (Locked, Grabbed, ResponseType, the joint slots'
    e1/e2/active) and ``_post_system`` (visible, reward, done) applied to
    a carried JAX state against the JAX systems called un-jitted; their
    float outputs within 1e-5;
  the reset draws (positions and yaws from the Threefry stream): equal to
    one float32 rounding, 1e-5 relative to the arena's half width;
  pixels: the port's render node on a carried JAX state against the JAX
    ``RenderingSystem`` node called un-jitted at render_size 16 (the
    Pallas raycast kernel in interpret mode): depth within 1e-3, rgb
    differing by more than 0.02 at under 0.2 % of pixels
    (tests/test_raycast_kernel.py:92-93).
The file holds few tests on purpose: it is long-running (one JAX compile
and several un-jitted JAX calls), and a file with few tests is scheduled
late by the parallel test run, beside the suite's longest files instead
of ahead of them. The port alone (determinism, launches, behaviours) is
in tests/test_torch_hide_seek_env.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu.models.base import make_sim as j_make_sim
from madrona_tpu.models.hide_seek import HideSeek as JHideSeek
from madrona_tpu.utils import rng as j_rng
from madrona_tpu_torch import make_sim
from madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from madrona_tpu_torch.models import hide_seek as hs
from madrona_tpu_torch.models.hide_seek import HideSeek
from madrona_tpu_torch.physics import api as tapi
from madrona_tpu_torch.utils import rng as t_rng

from torch_port import carry_state, jax_tree

torch.set_num_threads(1)

W = 4
SEED = 7
AT = (0, 6, 100)
TOL_POS = TOL_ROT = 1e-3
TOL_VEL = 5e-2
TOL_OMEGA = 2e-1
TOL_SAME = 1e-5
MARGIN = 1e-3
N_VIS = hs.N_SEEKERS * hs.N_HIDERS


@pytest.fixture(scope="module")
def rollout():
    j_sim = j_make_sim(JHideSeek(pixels=False), num_worlds=W, seed=SEED,
                       donate=False)
    step = j_sim.step_fn()
    acts = HideSeek.random_actions(np.random.RandomState(1), max(AT) + 1, W)
    states = {0: j_sim.state}
    s = j_sim.state
    for t in range(max(AT)):
        s, _ = step(s, _j_inputs(acts[t]))
        if t + 1 in AT:
            states[t + 1] = s
    return j_sim, step, acts, states


def _j_inputs(act):
    return {"action": jnp.asarray(act.numpy()),
            "reset": jnp.zeros((W,), jnp.int32)}


def _t_inputs(act, w=W):
    return {"action": act, "reset": torch.zeros((w,), dtype=torch.int32)}


def _cols(state):
    return state.tables[hs.RIGID_BODY].columns


def _obs_tol():
    """Per-column bounds of flat_obs [46]: self_obs (pos 3, sin, cos, vel
    3, grabbed, prep), relative positions, locked, visible."""
    tol = np.full(46, TOL_POS)
    tol[5:8] = TOL_VEL / hs.MAX_SPEED
    return tol


def _check_rollout_passes_prep_and_uses_the_mechanics(rollout):
    _, _, _, states = rollout
    s = states[100].singletons
    assert (np.asarray(s["EpisodeStep"]) == 100).all()
    assert 100 > hs.PREP_STEPS
    seen = [np.asarray(states[t].singletons[k]) for t in (6, 100)
            for k in ("Locked",)]
    grabbed = [np.asarray(states[t].singletons["Grabbed"]) for t in (6, 100)]
    assert any((x > 0).any() for x in seen) or any(
        (g >= 0).any() for g in grabbed)


@pytest.mark.parametrize("at", AT)
def test_step_from_carried_state(rollout, at):
    _, j_step, acts, states = rollout
    j_next, j_out = j_step(states[at], _j_inputs(acts[at]))
    env = HideSeek(pixels=False)
    t_sim = make_sim(env, num_worlds=W, seed=SEED, device="cpu")
    t_next, t_out = t_sim.step_fn()(carry_state(states[at]),
                                    _t_inputs(acts[at]))
    assert set(t_out) == set(j_out)
    for k, ref in j_out.items():
        assert t_out[k].numpy().dtype == np.asarray(ref).dtype, k
        assert t_out[k].shape == np.asarray(ref).shape, k
    np.testing.assert_array_equal(t_out["done"].numpy(),
                                  np.asarray(j_out["done"]))

    jc, tc = jax_tree(_cols(j_next)), _cols(t_next)
    for got, ref, tol in (
        (tc["Position"], jc["Position"], TOL_POS),
        (tc["Rotation"], jc["Rotation"], TOL_ROT),
        (tc["Velocity"]["linear"], jc["Velocity"]["linear"], TOL_VEL),
        (tc["Velocity"]["angular"], jc["Velocity"]["angular"], TOL_OMEGA),
    ):
        assert np.abs(got.numpy().astype(np.float64) - ref).max() <= tol
    # decisions taken on the carried state itself
    for k in ("Locked", "Grabbed"):
        np.testing.assert_array_equal(t_next.singletons[k].numpy(),
                                      np.asarray(j_next.singletons[k]), k)
    np.testing.assert_array_equal(tc["ResponseType"].numpy(),
                                  jc["ResponseType"])

    # visible may flip only within MARGIN of a threshold on the JAX side
    _, cone, los = env.visibility(carry_state(j_next))
    near = ((cone.abs() < MARGIN) | (los.abs() < MARGIN)).numpy()
    j_vis = np.asarray(j_out["visible"])
    flipped = t_out["visible"].numpy() != j_vis
    assert not (flipped & ~near).any()
    settled = ~flipped.reshape(W, -1).any(axis=1)          # [W]
    d = np.abs(t_out["flat_obs"].numpy().astype(np.float64)
               - np.asarray(j_out["flat_obs"]))
    assert (d[settled][..., :-N_VIS] <= _obs_tol()[:-N_VIS]).all()
    assert (d[~settled][..., :-N_VIS] <= _obs_tol()[:-N_VIS]).all()
    assert (d[settled][..., -N_VIS:] == 0).all()
    assert (np.abs(t_out["self_obs"].numpy() - np.asarray(j_out["self_obs"]))
            <= _obs_tol()[:10]).all()
    np.testing.assert_array_equal(t_out["reward"].numpy()[settled],
                                  np.asarray(j_out["reward"])[settled])
    assert int(t_next.step) == int(j_next.step) == at + 1
    if at == max(AT):
        _check_rollout_passes_prep_and_uses_the_mechanics(rollout)


def _check_action_system(rollout, at):
    """The threshold decisions of hs_actions on one and the same state."""
    j_sim, _, acts, states = rollout
    sm = j_sim.executor.sm
    j_in = sm.apply_imports(states[at], _j_inputs(acts[at]))
    j_got = j_sim.env._action_system(sm, j_in, None)
    t_got = HideSeek(pixels=False)._action_system(None, carry_state(j_in),
                                                  None)
    for k in ("Locked", "Grabbed"):
        np.testing.assert_array_equal(t_got.singletons[k].numpy(),
                                      np.asarray(j_got.singletons[k]), k)
    jc, tc = jax_tree(_cols(j_got)), _cols(t_got)
    np.testing.assert_array_equal(tc["ResponseType"].numpy(),
                                  jc["ResponseType"])
    jj = jax_tree(j_got.singletons[tapi.JOINT_BUFFER])
    tj = t_got.singletons[tapi.JOINT_BUFFER]
    for k in ("e1", "e2", "jtype", "active"):
        np.testing.assert_array_equal(tj[k].numpy(), jj[k], k)
    for k in ("r1", "r2", "attach_q1", "attach_q2"):
        np.testing.assert_allclose(tj[k].numpy(), jj[k], rtol=0,
                                   atol=TOL_SAME, err_msg=k)
    np.testing.assert_allclose(tc["ExternalForce"].numpy(),
                               jc["ExternalForce"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(tc["Velocity"]["angular"].numpy(),
                               jc["Velocity"]["angular"], rtol=0,
                               atol=TOL_SAME)


def _check_post_system(rollout, at):
    """The threshold decisions of hs_post (visibility) on one and the
    same state, and its observations."""
    j_sim, _, _, states = rollout
    j_got = j_sim.env._post_system(j_sim.executor.sm, states[at], None)
    t_got = HideSeek(pixels=False)._post_system(None, carry_state(states[at]),
                                                None)
    for k in ("Visible", "Done", "EpisodeStep", "Reward"):
        np.testing.assert_array_equal(t_got.singletons[k].numpy(),
                                      np.asarray(j_got.singletons[k]), k)
    for k in ("SelfObs", "FlatObs"):
        np.testing.assert_allclose(t_got.singletons[k].numpy(),
                                   np.asarray(j_got.singletons[k]), rtol=0,
                                   atol=TOL_SAME, err_msg=k)
    np.testing.assert_allclose(
        _cols(t_got)["Velocity"]["linear"].numpy(),
        np.asarray(_cols(j_got)["Velocity"]["linear"]), rtol=0,
        atol=TOL_SAME)


def _check_pixels(rollout, at):
    _, _, _, states = rollout
    j_env = JHideSeek(render_size=16)
    j_got = j_env.rsys._render_node(None, states[at], None)
    t_env = HideSeek(render_size=16)
    t_got = t_env.rsys._render_node(None, carry_state(states[at]), None)
    j_rgb = np.asarray(j_got.singletons["RGBOut"])
    j_dep = np.asarray(j_got.singletons["DepthOut"])
    t_rgb = t_got.singletons["RGBOut"].numpy()
    t_dep = t_got.singletons["DepthOut"].numpy()
    assert t_rgb.shape == j_rgb.shape == (W, hs.N_AGENTS, 16, 16, 3)
    assert np.abs(t_dep - j_dep).max() < 1e-3
    assert (np.abs(t_rgb - j_rgb) > 0.02).mean() < 0.002
    assert 0.3 < (j_dep < t_env.rcfg.t_max).mean() < 1.0


@pytest.mark.parametrize("at", AT[1:])
def test_systems_on_same_state(rollout, at):
    """hs_actions, hs_post and (past the prep phase) the render node on
    one and the same carried state."""
    _check_action_system(rollout, at)
    _check_post_system(rollout, at)
    if at > hs.PREP_STEPS:
        _check_pixels(rollout, at)


def _check_state_round_trip(rollout):
    """A Hide & Seek SimState (Grabbed, Locked, Visible, a joint buffer of
    4 slots) crosses over and back unchanged."""
    _, _, _, states = rollout
    tree = jax_tree(states[100])
    back = state_to_numpy(state_from_numpy(tree, "cpu"))
    assert tree["singletons"][tapi.JOINT_BUFFER]["e1"].shape == (W, 4)
    assert set(tree["singletons"]) >= {"Grabbed", "Locked", "Visible"}

    def same(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                same(a[k], b[k], f"{path}/{k}")
        else:
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(a, b, err_msg=path)

    same(tree, back, "state")


def test_reset_draws_and_state_round_trip(rollout):
    """hs_reset on the initial state (every world needs a reset) with the
    same node key: the same placements to one float32 rounding."""
    j_sim, _, _, states = rollout
    j_state = states[0]
    w_u32 = lambda v: jnp.full((W,), v, jnp.uint32)            # noqa: E731
    j_key = j_rng.split_i(j_rng.split_i(j_state.rng, w_u32(0)), w_u32(0))
    j_got = j_sim.env._reset_system(j_sim.executor.sm, j_state, j_key)
    t_state = carry_state(j_state)
    t_key = t_rng.split_i(t_rng.split_i(t_state.rng, 0), 0)
    np.testing.assert_array_equal(
        t_key.numpy().astype(np.uint32), np.asarray(j_key))
    t_got = HideSeek(pixels=False)._reset_system(None, t_state, t_key)
    jc, tc = jax_tree(_cols(j_got)), _cols(t_got)
    np.testing.assert_allclose(tc["Position"].numpy(), jc["Position"],
                               rtol=0, atol=1e-5 * hs.ARENA)
    np.testing.assert_allclose(tc["Rotation"].numpy(), jc["Rotation"],
                               rtol=0, atol=1e-5)
    for k in ("Scale", "ObjectID", "ResponseType"):
        np.testing.assert_array_equal(tc[k].numpy(), jc[k], k)
    pos = tc["Position"].numpy()
    assert np.abs(pos[:, hs.ROW_BOX0:hs.ROW_AGENT0 + hs.N_HIDERS, :2]
                  ).max() <= hs.ARENA - 3.0
    assert len(np.unique(pos[:, hs.ROW_BOX0, 0])) == W
    _check_state_round_trip(rollout)
