"""Escape Room of the PyTorch port vs the JAX package, step by step.

A seeded JAX rollout (4 worlds, random actions) supplies states at steps
0, 5 and 30; each is carried into the port (madrona_tpu_torch.interop)
and both packages take the same next step. Carrying the state at every
checked step keeps drift from compounding. Tolerances:
  integer exports (done, steps_taken, door_open): exact;
  body state after the step: pos/rot 1e-3, vel 5e-2, omega 2e-1 (the
    JAX package's kernel-golden bounds, tests/golden_inputs.py:484-492);
  observations built from positions: 1e-3; those that carry the agent
    velocity (self_obs, flat_obs): 5e-2 / MAX_SPEED; reward:
    PROGRESS_REWARD * 1e-3;
  lidar on one and the same state: 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu.models.base import make_sim as j_make_sim
from madrona_tpu.models.escape_room import EscapeRoom as JEscapeRoom
from madrona_tpu_torch import make_sim
from madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from madrona_tpu_torch.models import escape_room as er
from madrona_tpu_torch.models.escape_room import EscapeRoom

from torch_port import carry_state, jax_tree

torch.set_num_threads(1)

W = 4
SEED = 7
AT = (0, 5, 30)
TOL_POS = TOL_ROT = 1e-3
TOL_VEL = 5e-2
TOL_OMEGA = 2e-1
TOL_OBS = 1e-3
TOL_LIDAR = 1e-5
EXPORT_TOL = {
    "self_obs": TOL_VEL / er.MAX_SPEED, "flat_obs": TOL_VEL / er.MAX_SPEED,
    "partner_obs": TOL_OBS, "entity_obs": TOL_OBS, "door_obs": TOL_OBS,
    "lidar": TOL_OBS, "reward": er.PROGRESS_REWARD * TOL_POS,
}


@pytest.fixture(scope="module")
def rollout():
    j_sim = j_make_sim(JEscapeRoom(), num_worlds=W, seed=SEED, donate=False)
    step = j_sim.step_fn()
    acts = EscapeRoom.random_actions(np.random.RandomState(1),
                                     max(AT) + 1, W)
    states = {0: j_sim.state}
    s = j_sim.state
    for t in range(max(AT)):
        s, _ = step(s, _j_inputs(acts[t]))
        if t + 1 in AT:
            states[t + 1] = s
    return step, acts, states


def _j_inputs(act):
    return {"action": jnp.asarray(act.numpy()),
            "reset": jnp.zeros((W,), jnp.int32)}


def _t_inputs(act):
    return {"action": act, "reset": torch.zeros((W,), dtype=torch.int32)}


@pytest.mark.parametrize("at", AT)
def test_step_from_carried_state(rollout, at):
    j_step, acts, states = rollout
    j_next, j_out = j_step(states[at], _j_inputs(acts[at]))
    t_sim = make_sim(EscapeRoom(), num_worlds=W, seed=SEED, device="cpu")
    t_next, t_out = t_sim.step_fn()(carry_state(states[at]),
                                    _t_inputs(acts[at]))

    assert set(t_out) == set(j_out)
    for k, ref in j_out.items():
        ref = np.asarray(ref)
        got = t_out[k].numpy()
        assert got.dtype == ref.dtype and got.shape == ref.shape, k
        if ref.dtype.kind in "iub":
            np.testing.assert_array_equal(got, ref, err_msg=k)
        else:
            d = np.abs(got.astype(np.float64) - ref).max()
            assert d <= EXPORT_TOL[k], (k, d)

    jc = jax_tree(j_next.tables[er.RIGID_BODY].columns)
    tc = t_next.tables[er.RIGID_BODY].columns
    for got, ref, tol in (
        (tc["Position"], jc["Position"], TOL_POS),
        (tc["Rotation"], jc["Rotation"], TOL_ROT),
        (tc["Velocity"]["linear"], jc["Velocity"]["linear"], TOL_VEL),
        (tc["Velocity"]["angular"], jc["Velocity"]["angular"], TOL_OMEGA),
    ):
        assert np.abs(got.numpy().astype(np.float64) - ref).max() <= tol
    # a reset draws the level from the same Threefry stream: equal up to
    # one float32 rounding (XLA contracts u * a + b into an FMA; eager
    # torch rounds the product first)
    for k in ("ButtonPos", "DoorX"):
        np.testing.assert_allclose(
            t_next.singletons[k].numpy(), np.asarray(j_next.singletons[k]),
            rtol=0, atol=1e-5, err_msg=k,
        )
    assert int(t_next.step) == int(j_next.step)


@pytest.mark.parametrize("at", AT)
def test_lidar_on_same_state(rollout, at):
    """The port's lidar on a carried JAX post-step state equals that
    step's Lidar export."""
    j_step, acts, states = rollout
    j_next, j_out = j_step(states[at], _j_inputs(acts[at]))
    env = EscapeRoom()
    got = torch.clamp(env.lidar(carry_state(j_next)) / er.HALL_LEN, max=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_out["lidar"]),
                               rtol=TOL_LIDAR, atol=TOL_LIDAR)


def test_determinism_across_fresh_sims():
    acts = EscapeRoom.random_actions(np.random.RandomState(0), 5, W)
    sims = [make_sim(EscapeRoom(), num_worlds=W, seed=SEED, device="cpu")
            for _ in range(2)]
    for t in range(5):
        o1, o2 = (s.step(_t_inputs(acts[t])) for s in sims)
        for k in o1:
            assert torch.equal(o1[k], o2[k]), (t, k)


def test_make_sim_defaults_to_cuda():
    """No device means the card; without CUDA that raises."""
    if torch.cuda.is_available():
        assert make_sim(EscapeRoom(), num_worlds=W).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            make_sim(EscapeRoom(), num_worlds=W)


def test_state_round_trip(rollout):
    _, _, states = rollout
    tree = jax_tree(states[5])
    back = state_to_numpy(state_from_numpy(tree, "cpu"))
    assert back["rng"].dtype == np.uint32

    def same(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                same(a[k], b[k], f"{path}/{k}")
        else:
            assert a.dtype == b.dtype, path
            np.testing.assert_array_equal(a, b, err_msg=path)

    same(tree, back, "state")
