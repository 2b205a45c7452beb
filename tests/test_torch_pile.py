"""Pile (the many-body tier) of the PyTorch port vs the JAX package.

A JAX Pile of 64 bodies (69 rows: floor, 4 walls, boxes of two sizes and
spheres) at 4 worlds, seed 0, steps T times under Pile.random_actions
(RandomState(0)); the bodies fall from the lattice onto the floor and
into each other from about step 15 on. Tolerances:

* the reset system on the same state and node key: the lattice with its
  jitter (Position), Scale, ObjectID, ResponseType and the zeroed
  velocities exact; Rotation within 2.4e-7 (one float32 rounding of the
  cos/sin of the same yaw draw);
* one step from the carried JAX state at each of the T steps: done and
  summary[:, 4:6] (episode step, the broadphase-overflow flag) exact;
  the body state within the golden bounds (pos/rot 1e-3, vel 5e-2,
  omega 2e-1, tests/golden_inputs.py:484-492); summary's mean and max
  height 1e-3; its mean speed (|v| + |omega| of a body) 2.5e-1; the rest
  fraction and the reward exact. The pile is chaotic, as the Escape Room
  of tests/test_torch_rollout.py: a step outside a bound passes only
  with a witness (the JAX package, stepped from the same state with every
  position scaled by (1 + 1e-7), outside the same bound at every (world,
  body), or world of a summary column, where the port is), on at most
  MAX_WITNESSED steps;
* fresh port sims: bit-identical.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu.models.base import make_sim as j_make_sim
from madrona_tpu.models.pile import Pile as JPile
from madrona_tpu.utils import rng as j_rng
from madrona_tpu_torch import make_sim
from madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from madrona_tpu_torch.models import pile as pl
from madrona_tpu_torch.models.pile import Pile
from madrona_tpu_torch.physics import api as tapi
from madrona_tpu_torch.utils import rng as t_rng

from torch_port import carry_state, jax_tree

torch.set_num_threads(1)

W = 4
NB = 64
T = 30
MAX_WITNESSED = 3
NUDGE = np.float32(1 + 1e-7)
BODY_TOL = (("Position", 1e-3), ("Rotation", 1e-3), ("linear", 5e-2),
            ("angular", 2e-1))
# summary columns: mean height, max height, mean speed, rest fraction
SUMMARY_TOL = (1e-3, 1e-3, 2.5e-1, 0.0)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX sim, its jitted step, the actions, and the states (T + 1)
    and exports (T) of a step loop from its initial state."""
    j_sim = j_make_sim(JPile(num_bodies=NB), num_worlds=W, seed=0,
                       donate=False)
    step = j_sim.step_fn()
    acts = Pile.random_actions(np.random.RandomState(0), T, W)
    states, outs = [j_sim.state], []
    for t in range(T):
        s, o = step(states[-1], _j_inputs(acts[t]))
        states.append(s)
        outs.append(o)
    return j_sim, step, acts, states, outs


def _j_inputs(act):
    return {"action": jnp.asarray(act.numpy()),
            "reset": jnp.zeros((W,), jnp.int32)}


def _t_inputs(act):
    return {"action": act, "reset": torch.zeros((W,), dtype=torch.int32)}


def _floats(state, outs):
    """{name: (array [W, ...], tolerance)} of everything held to a bound."""
    cols = state["tables"][tapi.RIGID_BODY]["columns"]
    got = {"Position": cols["Position"], "Rotation": cols["Rotation"],
           "linear": cols["Velocity"]["linear"],
           "angular": cols["Velocity"]["angular"]}
    out = {k: (np.asarray(got[k]), tol) for k, tol in BODY_TOL}
    summ = np.asarray(outs["summary"])
    for i, tol in enumerate(SUMMARY_TOL):
        out[f"summary{i}"] = (summ[:, i], tol)
    out["reward"] = (np.asarray(outs["reward"]), 0.0)
    return out


def _outside(got, ref):
    """{name: (mask of the (world, body) or world outside the bound,
    largest difference)}."""
    off = {}
    for k, (a, tol) in got.items():
        d = np.abs(a.astype(np.float64) - ref[k][0].astype(np.float64))
        if d.max() > tol:
            loc = d.reshape(d.shape[:2] + (-1,)).max(-1) if d.ndim > 2 else d
            off[k] = (loc > tol, float(d.max()))
    return off


def _nudged(j_state):
    t = j_state.tables[tapi.RIGID_BODY]
    cols = dict(t.columns)
    cols["Position"] = cols["Position"] * NUDGE
    tables = dict(j_state.tables)
    tables[tapi.RIGID_BODY] = dataclasses.replace(t, columns=cols)
    return dataclasses.replace(j_state, tables=tables)


def test_reset_draws_and_lattice_equal(jax_run):
    """The reset system of both packages on the initial state (every
    world done) with the step-0 node key of the JAX split tree."""
    j_sim = jax_run[0]
    j_state = j_sim.state
    zeros = jnp.zeros((W,), jnp.uint32)
    j_key = j_rng.split_i(j_rng.split_i(j_state.rng, zeros), zeros)
    ref = jax_tree(j_sim.env._reset_system(j_sim.executor.sm, j_state,
                                           j_key))
    sim = make_sim(Pile(num_bodies=NB), num_worlds=W, seed=0, device="cpu")
    t_state = carry_state(j_state)
    t_key = t_rng.split_i(t_rng.split_i(t_state.rng, 0), 0)
    np.testing.assert_array_equal(t_key.numpy(), np.asarray(j_key))
    got = state_to_numpy(sim.env._reset_system(sim.executor.sm, t_state,
                                               t_key))
    rc = ref["tables"][tapi.RIGID_BODY]["columns"]
    gc = got["tables"][tapi.RIGID_BODY]["columns"]
    for k in ("Position", "Scale", "ObjectID", "ResponseType",
              "ExternalForce", "ExternalTorque"):
        np.testing.assert_array_equal(gc[k], rc[k], err_msg=k)
    for k in ("linear", "angular"):
        np.testing.assert_array_equal(gc["Velocity"][k], rc["Velocity"][k])
    np.testing.assert_allclose(gc["Rotation"], rc["Rotation"], rtol=0,
                               atol=2.4e-7)
    for k in ("EpisodeStep", tapi.BROADPHASE_OVERFLOW):
        np.testing.assert_array_equal(got["singletons"][k],
                                      ref["singletons"][k])
    # the jitter really is per world and per body
    dyn = gc["Position"][:, pl.N_STATIC:, :2]
    assert (dyn[0] != dyn[1]).all()


def test_one_step_from_every_carried_state(jax_run):
    """Integers exact at every step; a float outside its bound only where
    the JAX package, nudged, is outside it too."""
    _, j_step, acts, states, outs = jax_run
    t_step = make_sim(Pile(num_bodies=NB), num_worlds=W, seed=0,
                      device="cpu").step_fn()
    witnessed = {}
    for t in range(T):
        t_next, t_out = t_step(carry_state(states[t]), _t_inputs(acts[t]))
        assert set(t_out) == set(outs[t])
        ref_summ = np.asarray(outs[t]["summary"])
        np.testing.assert_array_equal(t_out["done"].numpy(),
                                      np.asarray(outs[t]["done"]))
        np.testing.assert_array_equal(t_out["summary"].numpy()[:, 4:],
                                      ref_summ[:, 4:], err_msg=str(t))
        assert int(t_next.step) == int(states[t + 1].step)
        ref = _floats(jax_tree(states[t + 1]), outs[t])
        off = _outside(_floats(state_to_numpy(t_next), t_out), ref)
        if not off:
            continue
        w_next, w_out = j_step(_nudged(states[t]), _j_inputs(acts[t]))
        witness = _outside(_floats(jax_tree(w_next), w_out), ref)
        for k, (mask, d) in off.items():
            assert k in witness and not (mask & ~witness[k][0]).any(), (
                f"step {t}: {k} off by {d} at {np.argwhere(mask).tolist()} "
                f"with no witness there (JAX nudged: "
                f"{witness.get(k, (None, 0.0))[1]})")
        witnessed[t] = {k: d for k, (_, d) in off.items()}
    print(f"steps with a witness: {witnessed}")
    assert len(witnessed) <= MAX_WITNESSED, witnessed
    # the bodies reached the floor and each other inside the horizon
    assert float(np.asarray(outs[-1]["summary"])[:, 0].min()) < 1.5


def test_fresh_port_sims_bit_identical_and_overflow_flag():
    """Two fresh port sims give the same bits; with a window of one body
    the lattice overflows it, and summary[:, 5] holds 1 (the node's
    running maximum) until the next reset."""
    acts = Pile.random_actions(np.random.RandomState(3), 6, 2)

    def run(window):
        sim = make_sim(Pile(num_bodies=NB, episode_len=4,
                            broadphase_window=window),
                       num_worlds=2, seed=4, device="cpu")
        outs = [sim.step({"action": acts[t],
                          "reset": torch.zeros((2,), dtype=torch.int32)})
                for t in range(6)]
        return outs, state_to_numpy(sim.state)

    a, sa = run(80)
    b, sb = run(80)
    for oa, ob in zip(a, b):
        for k in oa:
            assert torch.equal(oa[k], ob[k]), k
    for k in ("Position", "Rotation"):
        np.testing.assert_array_equal(
            sa["tables"][tapi.RIGID_BODY]["columns"][k],
            sb["tables"][tapi.RIGID_BODY]["columns"][k])
    assert all(float(o["summary"][:, 5].max()) == 0.0 for o in a)
    narrow, _ = run(1)
    flags = np.stack([o["summary"][:, 5].numpy() for o in narrow])
    np.testing.assert_array_equal(flags, 1.0)
    assert [int(o["done"][0]) for o in narrow] == [0, 0, 0, 1, 0, 0]


def test_state_crosses_both_ways(jax_run):
    """A JAX Pile state (Summary, BroadphaseOverflow, the RigidBody table
    as a fixed-rows archetype) through numpy into the port and back: the
    same tree, dtypes included."""
    states = jax_run[3]
    tree = jax_tree(states[-1])
    back = state_to_numpy(state_from_numpy(tree, "cpu"))

    def same(x, y, path):
        if isinstance(x, dict):
            assert set(x) == set(y), path
            for k in x:
                same(x[k], y[k], f"{path}/{k}")
        else:
            assert x.dtype == y.dtype, path
            np.testing.assert_array_equal(x, y, err_msg=path)

    same(tree, back, "state")
    assert (tree["tables"][tapi.RIGID_BODY]["num_rows"] == NB + 5).all()


@pytest.mark.parametrize("change, match", [
    (dict(solver="gauss_seidel"), "solver"),
    (dict(solver="tgs"), "solver"),
    (dict(broadphase="all_pairs"), "broadphase"),
    (dict(broadphase="pallas"), "broadphase"),
])
def test_unported_configs_raise(change, match):
    """The JAX package's solvers and broadphase names run on the port
    (they raised before the Gauss-Seidel oracle, TGS and the tier names
    were ported): the pile builds and steps with each, its exports
    finite; a name neither package knows raises ValueError naming the
    field. No fallback: without a device the pile goes to the card, and
    raises without CUDA."""
    env = Pile(num_bodies=8)
    env.cfg = dataclasses.replace(env.cfg, **change)
    sim = make_sim(env, num_worlds=2, device="cpu")
    out = sim.step({"action": torch.zeros((2,), dtype=torch.int32),
                    "reset": torch.zeros((2,), dtype=torch.int32)})
    assert torch.isfinite(out["summary"]).all()
    bad = Pile(num_bodies=8)
    bad.cfg = dataclasses.replace(
        bad.cfg, **{k: v + "_x" for k, v in change.items()})
    with pytest.raises(ValueError, match=match):
        make_sim(bad, num_worlds=2, device="cpu")
    if torch.cuda.is_available():
        assert make_sim(Pile(num_bodies=8), num_worlds=2).device.type == \
            "cuda"
    else:
        with pytest.raises(RuntimeError):
            make_sim(Pile(num_bodies=8), num_worlds=2)
