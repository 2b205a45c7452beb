"""Cartpole and Projectiles of the PyTorch port vs the JAX package.

Cartpole (tests/test_cartpole.py's case: 8 worlds, 50 steps, seed 17,
actions from RandomState(0)): done and reward equal the NumPy oracle
(test_cartpole.py::numpy_oracle) and the JAX sim exactly; obs within
2e-6 of both (the JAX test's atol: XLA contracts a*b+c into an FMA on
the CPU and eager PyTorch does not, and cos/sin may round differently).
The auto-reset, the forced reset and the device default are checked on
the port alone, as the JAX tests check them.

Projectiles (tests/test_projectiles.py's case: 6 worlds, seed 4, 120
steps): the live counts, the spawn and destroy totals, every table row's
entity id and generation, the entity store (generations, rows, the free
stack) and the live rows' order equal the JAX sim's exactly at every
step; positions within 1e-5 (one float32 rounding of pos + vel * dt a
step, as above, over a flight of up to 40 steps). A JAX state with live
entities crosses into the port through numpy, and a port state into the
JAX package, and both take the same next step. The port's capacity
argument, grown by Executor.maybe_grow, keeps the churn going.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu.models.base import make_sim as j_make_sim
from madrona_tpu.models.cartpole import Cartpole as JCartpole
from madrona_tpu.models.projectiles import Projectiles as JProjectiles
from madrona_tpu_torch import make_sim, rollout
from madrona_tpu_torch.interop import state_to_numpy
from madrona_tpu_torch.models import projectiles as pr
from madrona_tpu_torch.models.cartpole import Cartpole
from madrona_tpu_torch.models.projectiles import Projectiles

from test_cartpole import numpy_oracle
from torch_port import assert_trees_equal, carry_state, jax_state, jax_tree

torch.set_num_threads(1)

PW, PSEED, PT = 6, 4, 120
POS_TOL = 1e-5


def _zeros(w):
    return torch.zeros((w,), dtype=torch.int32)


def test_cartpole_matches_oracle_and_jax():
    w, t_len, seed = 8, 50, 17
    actions = np.random.RandomState(0).randint(0, 2, (t_len, w)).astype(
        np.int32)
    sim = make_sim(Cartpole(), num_worlds=w, seed=seed, device="cpu")
    j_sim = j_make_sim(JCartpole(), num_worlds=w, seed=seed, donate=False)
    got = {"obs": [], "reward": [], "done": []}
    ref = {"obs": [], "reward": [], "done": []}
    for t in range(t_len):
        o = sim.step({"action": torch.from_numpy(actions[t]),
                      "reset": _zeros(w)})
        jo = j_sim.step({"action": jnp.asarray(actions[t]),
                         "reset": jnp.zeros((w,), jnp.int32)})
        for k in got:
            assert o[k].numpy().dtype == np.asarray(jo[k]).dtype, k
            got[k].append(o[k].numpy().copy())
            ref[k].append(np.asarray(jo[k]))
    got = {k: np.stack(v) for k, v in got.items()}
    ref = {k: np.stack(v) for k, v in ref.items()}
    o_obs, o_rew, o_done = numpy_oracle(w, actions, seed)
    for k, oracle in (("done", o_done), ("reward", o_rew)):
        np.testing.assert_array_equal(got[k], oracle, err_msg=k)
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert got["done"].sum() > 0
    np.testing.assert_allclose(got["obs"][:, :, 0], o_obs, rtol=0, atol=2e-6)
    np.testing.assert_allclose(got["obs"], ref["obs"], rtol=0, atol=2e-6)
    # the state after the run crosses back into the JAX package's layout
    assert_trees_equal(jax_tree(jax_state(sim.state).tables["Cart"]),
                       state_to_numpy(sim.state)["tables"]["Cart"])


def test_cartpole_resets_and_device_default():
    """A constant action ends episodes, and the next obs lies in the
    reset range; a forced reset redraws world 0 only (rollout and
    sim.step); without a device the sim goes to the card."""
    w, t_len = 16, 300
    sim = make_sim(Cartpole(), num_worlds=w, seed=3, device="cpu")
    outs = rollout(sim, {"action": torch.ones((t_len, w), dtype=torch.int32),
                         "reset": torch.zeros((t_len, w),
                                              dtype=torch.int32)})
    done = outs["done"].numpy()
    obs = outs["obs"].numpy()[:, :, 0, :]
    t_idx, w_idx = np.nonzero(done[:-1])
    assert len(t_idx) > 0
    assert (np.abs(obs[t_idx + 1, w_idx]) <= 0.05 + 1e-6).all()

    sim = make_sim(Cartpole(), num_worlds=4, seed=3, device="cpu")
    for _ in range(30):
        o1 = sim.step({"action": torch.ones((4,), dtype=torch.int32),
                       "reset": _zeros(4)})
    o2 = sim.step({"action": _zeros(4),
                   "reset": torch.tensor([1, 0, 0, 0], dtype=torch.int32)})
    assert float(o2["obs"][0].abs().max()) <= 0.05 + 1e-6
    assert float(o1["obs"][1:].abs().max()) > 0.05
    if torch.cuda.is_available():
        assert make_sim(Cartpole(), num_worlds=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            make_sim(Cartpole(), num_worlds=2)


@pytest.fixture(scope="module")
def jax_projectiles():
    """The JAX Projectiles sim's states (PT + 1) and exports (PT)."""
    j_sim = j_make_sim(JProjectiles(), num_worlds=PW, seed=PSEED,
                       donate=False)
    step = j_sim.step_fn()
    inp = {"action": jnp.zeros((PW,), jnp.int32),
           "reset": jnp.zeros((PW,), jnp.int32)}
    states, outs = [j_sim.state], []
    for _ in range(PT):
        s, o = step(states[-1], inp)
        states.append(s)
        outs.append({k: np.asarray(v) for k, v in o.items()})
    return step, inp, states, outs


def _same_churn(got, ref, t):
    """Integer state equal, live positions within POS_TOL."""
    gt, rt = got["tables"]["Projectile"], ref["tables"]["Projectile"]
    for k in ("entity_id", "entity_gen", "num_rows", "overflow"):
        np.testing.assert_array_equal(gt[k], rt[k], err_msg=f"{t} {k}")
    assert_trees_equal(got["entities"], ref["entities"], f"{t} entities")
    for k in ("LiveCount", "TotalSpawned", "TotalDestroyed", "Done"):
        np.testing.assert_array_equal(got["singletons"][k],
                                      ref["singletons"][k], err_msg=k)
    mask = np.arange(pr.CAPACITY)[None] < rt["num_rows"][:, None]
    for c in ("PPos", "PVel"):
        d = np.abs(gt["columns"][c] - rt["columns"][c]).max(-1)
        assert np.where(mask, d, 0.0).max() <= POS_TOL, (t, c)


def test_projectiles_matches_jax(jax_projectiles):
    """Every step of the port's own run against the JAX run."""
    _, _, states, outs = jax_projectiles
    sim = make_sim(Projectiles(), num_worlds=PW, seed=PSEED, device="cpu")
    inp = {"action": _zeros(PW), "reset": _zeros(PW)}
    assert_trees_equal(state_to_numpy(sim.state), jax_tree(states[0]))
    saw_destroy = False
    for t in range(PT):
        o = sim.step(inp)
        np.testing.assert_array_equal(o["live"].numpy(), outs[t]["live"])
        _same_churn(state_to_numpy(sim.state), jax_tree(states[t + 1]), t)
        live = o["live"].numpy()
        z = sim.state.tables["Projectile"].columns["PPos"].numpy()[..., 2]
        for w in range(PW):
            assert (np.diff(z[w, :live[w]]) <= 1e-5).all(), (t, w)
        saw_destroy |= bool(
            (sim.state.singletons["TotalDestroyed"] > 0).any())
    assert saw_destroy
    assert (sim.state.singletons["TotalSpawned"] > 50).all()


def test_projectiles_state_crosses_both_ways(jax_projectiles):
    """A JAX state with live entities (step 60) steps in the port as in
    JAX; the port's next state, carried into JAX, steps there as the
    JAX package's own does, ids and generations exact."""
    step, inp, states, outs = jax_projectiles
    sim = make_sim(Projectiles(), num_worlds=PW, seed=PSEED, device="cpu")
    fn = sim.step_fn()
    t = 60
    assert (np.asarray(states[t].tables["Projectile"].num_rows) > 0).all()
    t_next, t_out = fn(carry_state(states[t]),
                       {"action": _zeros(PW), "reset": _zeros(PW)})
    _same_churn(state_to_numpy(t_next), jax_tree(states[t + 1]), t)
    j_next, j_out = step(jax_state(t_next), inp)
    _same_churn(jax_tree(j_next), jax_tree(states[t + 2]), t + 1)
    np.testing.assert_array_equal(np.asarray(j_out["live"]),
                                  outs[t + 1]["live"])


def test_projectiles_grow_keeps_churning():
    """At a capacity of 4 the spawns overflow; maybe_grow doubles the
    archetype until it holds them, and the run goes on: live ids unique,
    rows sorted by height, each spawn kept or counted as dropped. (The
    entity store does not grow: it is sized by max_entities.)"""
    w = 4
    sim = make_sim(Projectiles(capacity=4), num_worlds=w, seed=PSEED,
                   device="cpu", max_entities=64)
    ex = sim.executor
    inp = {"action": _zeros(w), "reset": _zeros(w)}
    grown, dropped = [], np.zeros(w, np.int64)
    for t in range(60):
        sim.step(inp)
        dropped += sim.state.tables["Projectile"].overflow.numpy()
        g = ex.maybe_grow()
        if g:
            grown.append((t, g["Projectile"]))
        tab = sim.state.tables["Projectile"]
        n = tab.num_rows.numpy()
        s = sim.state.singletons
        np.testing.assert_array_equal(
            n, (s["TotalSpawned"] - s["TotalDestroyed"]).numpy() - dropped)
        for wi in range(w):
            ids = tab.entity_id[wi, :n[wi]].tolist()
            assert len(set(ids)) == n[wi] and min(ids, default=0) >= 0
            z = tab.columns["PPos"][wi, :n[wi], 2].numpy()
            assert (np.diff(z) <= 1e-5).all()
    assert grown and grown[0][1] == 8
    assert ex.sm.archetypes["Projectile"].capacity == grown[-1][1]
