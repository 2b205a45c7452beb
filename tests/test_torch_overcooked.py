"""Overcooked of the PyTorch port vs the JAX package and the NumPy oracle.

Tolerance: none anywhere; every comparison is equality, dtypes included:

- the JAX sim Overcooked(shaped_rewards=True) at 4 worlds for 900 steps
  of random_actions(RandomState(3)), through the automatic resets at
  steps 400 and 800: every export and every singleton of the port equal
  at every step;
- the port against tests/test_overcooked.py's Oracle on both layouts
  (cramped_room, asymmetric_advantages), 150 steps of RandomState(3):
  reward, positions, held items, pot counts and timers;
- tests/test_overcooked.py's scripted cook-and-serve episode and the
  collision rule, on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu.models.base import make_sim as j_make_sim
from madrona_tpu.models.overcooked import Overcooked as JOvercooked
from madrona_tpu_torch import make_sim
from madrona_tpu_torch.models import overcooked as OC
from madrona_tpu_torch.models.overcooked import Overcooked

from test_overcooked import Oracle

torch.set_num_threads(1)

W, T = 4, 900


def _zeros(w):
    return torch.zeros((w,), dtype=torch.int32)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX sim's exports and singletons at every step (numpy)."""
    acts = np.asarray(JOvercooked.random_actions(np.random.RandomState(3),
                                                 T, W))
    sim = j_make_sim(JOvercooked(shaped_rewards=True), num_worlds=W, seed=0,
                     donate=False)
    step = sim.step_fn()
    s = sim.state
    zero = jnp.zeros((W,), jnp.int32)
    outs, singles = [], []
    for t in range(T):
        s, o = step(s, {"action": jnp.asarray(acts[t]), "reset": zero})
        outs.append({k: np.asarray(v) for k, v in o.items()})
        singles.append({k: np.asarray(v) for k, v in s.singletons.items()})
    return acts, outs, singles


def test_matches_jax_every_step(jax_run):
    acts, outs, singles = jax_run
    np.testing.assert_array_equal(
        Overcooked.random_actions(np.random.RandomState(3), T, W).numpy(),
        acts)
    sim = make_sim(Overcooked(shaped_rewards=True), num_worlds=W, seed=0,
                   device="cpu")
    shaped = 0.0
    for t in range(T):
        o = sim.step({"action": torch.from_numpy(acts[t].copy()),
                      "reset": _zeros(W)})
        assert set(o) == set(outs[t])
        for k, v in o.items():
            assert v.numpy().dtype == outs[t][k].dtype, k
            np.testing.assert_array_equal(v.numpy(), outs[t][k],
                                          err_msg=f"step {t} export {k}")
        for k, v in sim.state.singletons.items():
            assert v.numpy().dtype == singles[t][k].dtype, k
            np.testing.assert_array_equal(v.numpy(), singles[t][k],
                                          err_msg=f"step {t} singleton {k}")
        shaped += float(o["reward"].sum())
        want_done = (t + 1) % OC.EPISODE_LEN == 0
        assert (o["done"].numpy() == int(want_done)).all(), t
    assert shaped > 0


@pytest.mark.parametrize("layout", ["cramped_room", "asymmetric_advantages"])
def test_matches_numpy_oracle(layout):
    """tests/test_overcooked.py's oracle, sparse rewards."""
    env = Overcooked(layout)
    sim = make_sim(env, num_worlds=W, seed=0, device="cpu")
    acts = Overcooked.random_actions(np.random.RandomState(3), 150, W)
    oracles = [Oracle(env) for _ in range(W)]
    for t in range(150):
        o = sim.step({"action": acts[t], "reset": _zeros(W)})
        s = sim.state.singletons
        pos, held = s["AgentPos"].numpy(), s["Held"].numpy()
        cnt, tmr = s["PotCount"].numpy(), s["PotTimer"].numpy()
        rew = o["reward"].numpy()
        for wi in range(W):
            orc = oracles[wi]
            r = orc.step(acts[t, wi].numpy())
            assert rew[wi] == r, (t, wi)
            assert (pos[wi] == np.asarray(orc.pos)).all(), (t, wi)
            assert (held[wi] == orc.held).all(), (t, wi)
            assert (cnt[wi] == orc.pot_cnt).all(), (t, wi)
            assert (tmr[wi] == orc.pot_tmr).all(), (t, wi)


def _scripted_cook_and_serve():
    """Agent 0 cooks and serves one soup in cramped_room (the script of
    tests/test_overcooked.py)."""
    sim = make_sim(Overcooked(), num_worlds=1, seed=0, device="cpu")
    step = sim.step_fn()
    s = sim.state

    def do(s, a0, a1=OC.A_STAY):
        acts = torch.tensor([[a0, a1]], dtype=torch.int32)
        return step(s, {"action": acts, "reset": _zeros(1)})

    script = []
    for _ in range(3):          # onion from the west dispenser into the pot
        script += [OC.A_WEST, OC.A_INTERACT]
        script += [OC.A_EAST, OC.A_NORTH, OC.A_INTERACT]
        script += [OC.A_WEST]
    script += [OC.A_STAY] * OC.COOK_TIME
    script += [OC.A_SOUTH, OC.A_SOUTH, OC.A_INTERACT]             # dish
    script += [OC.A_NORTH, OC.A_EAST, OC.A_NORTH, OC.A_INTERACT]  # soup
    rewards = []
    for a in script:
        s, o = do(s, a)
        rewards.append(float(o["reward"][0]))
    assert int(s.singletons["Held"][0, 0]) == OC.H_SOUP
    for a in [OC.A_SOUTH, OC.A_EAST, OC.A_SOUTH, OC.A_INTERACT]:  # serve
        s, o = do(s, a)
        rewards.append(float(o["reward"][0]))
    assert max(rewards) == OC.DELIVERY_REWARD, rewards
    assert int(o["deliveries"][0]) == 1


def _collision():
    """Both agents step toward (1, 2): neither moves."""
    env = Overcooked()
    sim = make_sim(env, num_worlds=1, seed=0, device="cpu")
    sim.step({"action": torch.tensor([[OC.A_EAST, OC.A_WEST]],
                                     dtype=torch.int32), "reset": _zeros(1)})
    np.testing.assert_array_equal(sim.state.singletons["AgentPos"][0].numpy(),
                                  env.start_pos)


@pytest.mark.parametrize("case", ["cook_and_serve", "collision"])
def test_scripted_rules(case):
    {"cook_and_serve": _scripted_cook_and_serve, "collision": _collision}[
        case]()
