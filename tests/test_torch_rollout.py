"""rollout / rollout_flat of the PyTorch port, held against the JAX
package's over 210 steps of Escape Room (4 worlds, seed 7, actions from
RandomState(1)), through the auto-reset at step 200.

The scene amplifies tiny differences, so two correct implementations
drift apart when they run freely: from the same seed the port and the
JAX package differ in position by 3.8e-6 at steps 1-3, 4.26e-2 at step
6 (the golden bound is 1e-3), 1.44 at step 40 and 68.9 at step 199,
while `done` agrees at every step; after the reset at step 200 the
positions agree again to 3.8e-6 at steps 201-203. The port diverges from
itself the same way: every position nudged by 1e-6 at step 2 moves the
velocity by 0.392 (g * dt: one resting contact flips) one step later and
the position by 70 by step 80. Hence the rules here:

(a) One step from the carried JAX state at every one of the 210 steps:
    integer exports exact; float exports, body state (pos/rot 1e-3,
    vel 5e-2, omega 2e-1), ButtonPos and DoorX within
    tests/test_torch_escape_room.py's tolerances (the golden bounds,
    tests/golden_inputs.py:484-492). A step outside a bound passes only
    with a witness: the JAX package, stepped from the same state with
    every position scaled by (1 + 1e-7), is itself outside the same bound
    at every (world, body) -- or (world, agent), (world, slot) of an
    export -- where the port is. At most 2 of the 210 steps may need a
    witness (one does: step 37, where JAX against itself differs by 26.3
    rad/s and 0.317 m); a step outside a bound without one fails.
(b) The port's rollout against the JAX rollout, running freely over the
    same 210 steps: `done` and `steps_taken` (the exports the episode
    clock sets) exact at every step; after the reset, at step 201, the
    body state within the golden bounds and ButtonPos, DoorX within 1e-5.
    Positions between reset points are not compared.
(c) rollout equals a loop of sim.step bit for bit; rollout_flat equals
    rollout's kept keys, with the shapes and dtypes of the JAX
    rollout_flat.

Also: actions on another device raise, and Hide & Seek's FlatObs blocks
equal their exports with rollout_flat stacked [T, W, A, D] (the port's
counterpart of tests/test_hide_seek.py::test_flat_obs_and_rollout_flat).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu.models import escape_room as j_er
from madrona_tpu.models.base import make_sim as j_make_sim
from madrona_tpu.models.base import rollout as j_rollout
from madrona_tpu.models.base import rollout_flat as j_rollout_flat
from madrona_tpu.models.escape_room import EscapeRoom as JEscapeRoom
from madrona_tpu_torch import make_sim, rollout, rollout_flat
from madrona_tpu_torch.interop import state_to_numpy
from madrona_tpu_torch.models import escape_room as er
from madrona_tpu_torch.models import hide_seek as hs
from madrona_tpu_torch.models.escape_room import EscapeRoom

from test_torch_escape_room import (
    EXPORT_TOL, TOL_OMEGA, TOL_POS, TOL_ROT, TOL_VEL,
)
from torch_port import carry_state, jax_tree

torch.set_num_threads(1)

W = 4
SEED = 7
T = 210                 # through the auto-reset at step 200
AFTER_RESET = er.EPISODE_LEN + 1
TOL_LEVEL = 1e-5        # ButtonPos, DoorX: one float32 rounding of a draw
MAX_WITNESSED = 2
NUDGE = np.float32(1 + 1e-7)
SHORT = 6
BODY_TOL = (("Position", TOL_POS), ("Rotation", TOL_ROT),
            ("linear", TOL_VEL), ("angular", TOL_OMEGA))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX sim, its jitted step, the actions, and the states (T + 1)
    and exports (T) of a step loop from its initial state."""
    j_sim = j_make_sim(JEscapeRoom(), num_worlds=W, seed=SEED, donate=False)
    step = j_sim.step_fn()
    acts = EscapeRoom.random_actions(np.random.RandomState(1), T, W)
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


def _seq(acts):
    return {"action": acts,
            "reset": torch.zeros((acts.shape[0], W), dtype=torch.int32)}


def _j_seq(acts):
    return {"action": jnp.asarray(acts.numpy()),
            "reset": jnp.zeros((acts.shape[0], W), jnp.int32)}


def _floats(state, outs):
    """{name: (array, tolerance)} of everything held to a bound: float
    exports, body state, ButtonPos and DoorX (numpy, from either
    package)."""
    cols = state["tables"][er.RIGID_BODY]["columns"]
    got = {"Position": cols["Position"], "Rotation": cols["Rotation"],
           "linear": cols["Velocity"]["linear"],
           "angular": cols["Velocity"]["angular"]}
    out = {k: (np.asarray(got[k]), tol) for k, tol in BODY_TOL}
    for k in ("ButtonPos", "DoorX"):
        out[k] = (np.asarray(state["singletons"][k]), TOL_LEVEL)
    for k, v in outs.items():
        if np.asarray(v).dtype.kind == "f":
            out[k] = (np.asarray(v), EXPORT_TOL[k])
    return out


def _outside(got, ref):
    """{name: (mask of the (world, body|agent|slot) outside the bound,
    largest difference)} for each quantity of ``got`` outside its bound
    against ``ref``."""
    off = {}
    for k, (a, tol) in got.items():
        d = np.abs(a.astype(np.float64) - ref[k][0].astype(np.float64))
        if d.max() > tol:
            loc = d.reshape(d.shape[:2] + (-1,)).max(-1) if d.ndim > 2 else d
            off[k] = (loc > tol, float(d.max()))
    return off


def _nudged(j_state):
    """A JAX state with every position scaled by (1 + 1e-7)."""
    t = j_state.tables[j_er.RIGID_BODY]
    cols = dict(t.columns)
    cols["Position"] = cols["Position"] * NUDGE
    tables = dict(j_state.tables)
    tables[j_er.RIGID_BODY] = dataclasses.replace(t, columns=cols)
    return dataclasses.replace(j_state, tables=tables)


def test_one_step_from_every_carried_state(jax_run):
    """(a): integers exact at every step; a float outside its bound only
    where the JAX package, nudged, is outside it too, on at most
    MAX_WITNESSED steps."""
    _, j_step, acts, states, outs = jax_run
    t_step = make_sim(EscapeRoom(), num_worlds=W, seed=SEED,
                      device="cpu").step_fn()
    witnessed = {}
    for t in range(T):
        t_next, t_out = t_step(carry_state(states[t]), _t_inputs(acts[t]))
        assert set(t_out) == set(outs[t])
        for k, ref in outs[t].items():
            ref = np.asarray(ref)
            got = t_out[k].numpy()
            assert got.dtype == ref.dtype and got.shape == ref.shape, (t, k)
            if ref.dtype.kind in "iub":
                np.testing.assert_array_equal(got, ref, err_msg=f"{t} {k}")
        assert int(t_next.step) == int(states[t + 1].step)
        ref = _floats(jax_tree(states[t + 1]), outs[t])
        off = _outside(_floats(state_to_numpy(t_next),
                               {k: v.numpy() for k, v in t_out.items()}),
                       ref)
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


def test_rollout_against_jax_rollout(jax_run):
    """(b): free-running rollouts agree on the episode clock at every
    step and on the regenerated level after the reset."""
    j_sim, _, acts, states, _ = jax_run
    j_sim.state = states[0]
    sim = make_sim(EscapeRoom(), num_worlds=W, seed=SEED, device="cpu")
    parts = []
    for lo, hi in ((0, AFTER_RESET), (AFTER_RESET, T)):
        j_out = j_rollout(j_sim, _j_seq(acts[lo:hi]))
        t_out = rollout(sim, _seq(acts[lo:hi]))
        parts.append((j_out, t_out))
        if hi == AFTER_RESET:
            j_state, t_state = jax_tree(j_sim.state), state_to_numpy(sim.state)
    for k in ("done", "steps_taken"):
        ref = np.concatenate([np.asarray(j[k]) for j, _ in parts])
        got = np.concatenate([t[k].numpy() for _, t in parts])
        assert got.dtype == ref.dtype and got.shape == (T, W), k
        np.testing.assert_array_equal(got, ref, err_msg=k)
    done = np.concatenate([t["done"].numpy() for _, t in parts])
    assert done[er.EPISODE_LEN - 1].all() and done.sum() == W
    assert (np.concatenate([t["steps_taken"].numpy() for _, t in parts])
            [AFTER_RESET - 1] == 1).all()
    got, ref = _floats(t_state, {}), _floats(j_state, {})
    assert not _outside(got, ref), _outside(got, ref)


def test_rollout_equals_step_loop():
    """(c): rollout == a loop of sim.step, every export and the final
    state bit for bit."""
    acts = EscapeRoom.random_actions(np.random.RandomState(3), SHORT, W)
    a = make_sim(EscapeRoom(), num_worlds=W, seed=SEED, device="cpu")
    b = make_sim(EscapeRoom(), num_worlds=W, seed=SEED, device="cpu")
    outs = rollout(a, _seq(acts), unroll=4)
    loop = [b.step(_t_inputs(acts[t])) for t in range(SHORT)]
    assert set(outs) == set(loop[0])
    for k, v in outs.items():
        assert v.shape == (SHORT,) + tuple(loop[0][k].shape), k
        assert torch.equal(v, torch.stack([o[k] for o in loop])), k

    def same(x, y, path):
        if isinstance(x, dict):
            assert set(x) == set(y), path
            for k in x:
                same(x[k], y[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(x, y, err_msg=path)

    same(state_to_numpy(a.state), state_to_numpy(b.state), "state")


def test_rollout_flat_keeps_rollout_keys(jax_run):
    """(c): rollout_flat == rollout's flat_obs, reward and done, with the
    JAX rollout_flat's keys, shapes and dtypes."""
    j_sim, _, acts, states, _ = jax_run
    j_sim.state = states[0]
    ref = j_rollout_flat(j_sim, _j_seq(acts[:SHORT]))
    full = rollout(make_sim(EscapeRoom(), num_worlds=W, seed=SEED,
                            device="cpu"), _seq(acts[:SHORT]))
    flat = rollout_flat(make_sim(EscapeRoom(), num_worlds=W, seed=SEED,
                                 device="cpu"), _seq(acts[:SHORT]))
    assert set(flat) == set(ref) == {"flat_obs", "reward", "done"}
    for k, v in flat.items():
        r = np.asarray(ref[k])
        assert tuple(v.shape) == r.shape and v.numpy().dtype == r.dtype, k
        assert torch.equal(v, full[k]), k
    assert flat["flat_obs"].shape == (SHORT, W, er.N_AGENTS, 101)


def test_rollout_refuses_other_devices():
    """Actions on another device, or not a tensor, raise; nothing is
    stepped."""
    sim = make_sim(EscapeRoom(), num_worlds=W, seed=SEED, device="cpu")
    acts = EscapeRoom.random_actions(np.random.RandomState(0), 2, W)
    before = int(sim.state.step)
    with pytest.raises(ValueError, match="meta"):
        rollout(sim, {"action": acts.to("meta"),
                      "reset": torch.zeros((2, W), dtype=torch.int32)})
    with pytest.raises(TypeError):
        rollout_flat(sim, {"action": acts.numpy()})
    with pytest.raises(ValueError, match="step counts"):
        rollout(sim, {"action": acts,
                      "reset": torch.zeros((3, W), dtype=torch.int32)})
    assert int(sim.state.step) == before


def test_hide_seek_flat_obs_and_rollout_flat():
    """FlatObs mirrors its constituent exports; rollout_flat stacks to
    [T, W, A, D] (Hide & Seek without pixels, 2 worlds, 4 steps)."""
    w = 2
    sim = make_sim(hs.HideSeek(pixels=False), num_worlds=w, seed=0,
                   device="cpu")
    step = sim.step_fn()
    s = sim.state
    acts = hs.HideSeek.random_actions(np.random.RandomState(1), 4, w)
    zeros = torch.zeros((w,), dtype=torch.int32)
    for t in range(3):
        s, o = step(s, {"action": acts[t], "reset": zeros})
    flat = o["flat_obs"].numpy()
    a = hs.N_AGENTS
    d = (10 + a * 3 + hs.N_MOVABLE * 3 + hs.N_MOVABLE
         + hs.N_SEEKERS * hs.N_HIDERS)
    assert flat.shape == (w, a, d)
    np.testing.assert_array_equal(flat[..., :10], o["self_obs"].numpy())
    vis = o["visible"].numpy().reshape(w, 1, -1).astype(np.float32)
    np.testing.assert_array_equal(
        flat[..., -hs.N_SEEKERS * hs.N_HIDERS:],
        np.broadcast_to(vis, (w, a, vis.shape[-1])))
    # the relative-agent block is zero on the self diagonal
    rel = flat[..., 10:10 + a * 3].reshape(w, a, a, 3)
    for i in range(a):
        np.testing.assert_array_equal(rel[:, i, i], 0.0)

    sim.state = s
    outs = rollout_flat(sim, {"action": acts,
                              "reset": torch.zeros((4, w), dtype=torch.int32)})
    assert outs["flat_obs"].shape == (4, w, a, d)
    assert outs["done"].shape == (4, w)
    assert int(sim.state.step) == 7
