"""Escape Room of the PyTorch port on its CPU path, alone: the behaviour
suite of tests/test_escape_room.py at 4 worlds (determinism, movement,
doors and buttons, grab, reset regeneration, world independence, flat
obs) and its long rollout at 16 worlds x 500 steps, whose candidate lists
must never overflow the shipped caps. Parity with the JAX package is in
tests/test_torch_escape_room.py and tests/test_torch_rollout.py."""

import dataclasses

import numpy as np
import pytest
import torch

from madrona_tpu_torch import make_sim
from madrona_tpu_torch.models import escape_room as er
from madrona_tpu_torch.models.escape_room import EscapeRoom
from madrona_tpu_torch.physics import api as papi
from madrona_tpu_torch.physics import broadphase as bp

torch.set_num_threads(1)

W = 4
SEED = 7


@pytest.fixture(scope="module")
def sim():
    return make_sim(EscapeRoom(), num_worlds=W, seed=SEED, device="cpu")


def zero_actions():
    return {"action": torch.zeros((W, er.N_AGENTS, 4), dtype=torch.int32),
            "reset": torch.zeros((W,), dtype=torch.int32)}


def act(move_amount=0, move_angle=0, rotate=2, grab=0):
    a = torch.zeros((W, er.N_AGENTS, 4), dtype=torch.int32)
    a[..., 0] = move_amount
    a[..., 1] = move_angle
    a[..., 2] = rotate
    a[..., 3] = grab
    return {"action": a, "reset": torch.zeros((W,), dtype=torch.int32)}


def body_pos(state):
    return state.tables[er.RIGID_BODY].columns["Position"].numpy()


def with_positions(state, rows):
    """``state`` with body rows moved: {row: [W, 3] positions}."""
    t = state.tables[er.RIGID_BODY]
    pos = t.columns["Position"].clone()
    for row, p in rows.items():
        pos[:, row] = torch.as_tensor(p, dtype=torch.float32)
    tables = dict(state.tables)
    tables[er.RIGID_BODY] = dataclasses.replace(
        t, columns={**t.columns, "Position": pos})
    return dataclasses.replace(state, tables=tables)


def test_determinism_across_fresh_sims(sim):
    sim2 = make_sim(EscapeRoom(), num_worlds=W, seed=SEED, device="cpu")
    step1, step2 = sim.step_fn(), sim2.step_fn()
    s1, s2 = sim.state, sim2.state
    acts = EscapeRoom.random_actions(np.random.RandomState(0), 5, W)
    for t in range(5):
        inp = {"action": acts[t], "reset": torch.zeros((W,), dtype=torch.int32)}
        s1, o1 = step1(s1, inp)
        s2, o2 = step2(s2, inp)
    for k in o1:
        assert torch.equal(o1[k], o2[k]), k


def test_forward_action_moves_agents(sim):
    step = sim.step_fn()
    s, _ = step(sim.state, zero_actions())          # the initial reset
    y0 = body_pos(s)[:, er.ROW_AGENT0:, 1].copy()
    total_r = 0.0
    for _ in range(10):
        s, o = step(s, act(move_amount=3, move_angle=0))
        total_r = total_r + o["reward"].numpy()
    y1 = body_pos(s)[:, er.ROW_AGENT0:, 1]
    assert (y1 > y0 + 0.5).all(), (y0, y1)
    # progress beats the step penalty
    assert total_r.mean() > 0.0
    # agents neither tip nor leave the floor
    np.testing.assert_allclose(body_pos(s)[:, er.ROW_AGENT0:, 2], er.AGENT_Z,
                               atol=0.1)


def test_buttons_open_door(sim):
    step = sim.step_fn()
    s, _ = step(sim.state, zero_actions())
    # each agent onto one button of room 0
    bpos = s.singletons["ButtonPos"].numpy()            # [W, 6, 2]
    s = with_positions(s, {
        er.ROW_AGENT0 + a: np.concatenate(
            [bpos[:, a, :], np.full((W, 1), er.AGENT_Z)], axis=-1)
        for a in range(2)})
    s, o = step(s, zero_actions())
    door_open = o["door_open"].numpy()
    assert (door_open[:, 0] == 1).all()
    assert (door_open[:, 1:] == 0).all()
    # the door body goes below the floor
    assert (body_pos(s)[:, er.ROW_SEP0 + 2, 2] < -1.0).all()
    # stepping off closes it again
    s = with_positions(s, {er.ROW_AGENT0 + a: [0.0 + a, 1.5, er.AGENT_Z]
                           for a in range(2)})
    s, o = step(s, zero_actions())
    assert (o["door_open"].numpy()[:, 0] == 0).all()


def test_grab_attaches_cube(sim):
    step = sim.step_fn()
    s, _ = step(sim.state, zero_actions())
    # cube 0 right in front of agent 0 (facing +y)
    front = body_pos(s)[:, er.ROW_AGENT0] + np.array([0.0, 1.4, 0.0])
    front[:, 2] = er.CUBE_Z
    s = with_positions(s, {er.ROW_CUBE0: front})
    s, _ = step(s, act(grab=1))
    grabbed = s.singletons["Grabbed"].numpy()
    assert (grabbed[:, 0] == er.ROW_CUBE0).all(), grabbed
    # hold and walk backward: the cube follows
    cube_y0 = body_pos(s)[:, er.ROW_CUBE0, 1].copy()
    for _ in range(8):
        s, _ = step(s, act(move_amount=3, move_angle=4, grab=1))
    moved = cube_y0 - body_pos(s)[:, er.ROW_CUBE0, 1]
    assert (moved > 0.3).all(), moved
    # release
    s, _ = step(s, act(grab=0))
    assert (s.singletons["Grabbed"].numpy()[:, 0] == -1).all()


def test_episode_reset_regenerates_level(sim):
    step = sim.step_fn()
    s, _ = step(sim.state, zero_actions())
    door_x0 = s.singletons["DoorX"].numpy().copy()
    # a forced reset
    inp = zero_actions()
    inp["reset"] = torch.ones((W,), dtype=torch.int32)
    s, _ = step(s, inp)
    assert not np.allclose(door_x0, s.singletons["DoorX"].numpy())
    assert (s.singletons["EpisodeStep"].numpy() == 1).all()
    # agents back at the start
    np.testing.assert_allclose(body_pos(s)[:, er.ROW_AGENT0, :2],
                               np.tile([-2.0, 1.5], (W, 1)), atol=0.5)
    # done after EPISODE_LEN steps
    s2, _ = step(sim.state, zero_actions())
    for _ in range(er.EPISODE_LEN - 1):
        s2, o2 = step(s2, zero_actions())
    assert (o2["done"].numpy() == 1).all()


def test_worlds_differ_and_stay_independent(sim):
    step = sim.step_fn()
    s, _ = step(sim.state, zero_actions())
    # the worlds' levels differ (independent RNG streams)
    dx = s.singletons["DoorX"].numpy()
    assert len({tuple(np.round(r, 4)) for r in dx}) > 1
    # an action in one world moves that world only
    a = torch.zeros((W, er.N_AGENTS, 4), dtype=torch.int32)
    a[0, :, 0] = 3
    s1, _ = step(s, {"action": a, "reset": torch.zeros((W,), dtype=torch.int32)})
    s2, _ = step(s, zero_actions())
    p1, p2 = body_pos(s1), body_pos(s2)
    assert not np.allclose(p1[0], p2[0])
    np.testing.assert_array_equal(p1[1:], p2[1:])


def test_flat_obs_concatenates_fields(sim):
    _, o = sim.step_fn()(sim.state, zero_actions())
    parts = np.concatenate(
        [o[k].numpy().reshape(W, er.N_AGENTS, -1)
         for k in ("self_obs", "partner_obs", "entity_obs", "door_obs",
                   "lidar")], axis=-1)
    np.testing.assert_array_equal(o["flat_obs"].numpy(), parts)


def test_candidate_caps_never_overflow_long_rollout():
    """The shipped caps (hull_hull=8) hold over a long seeded
    random-action rollout across episodes (auto-reset at step 200): the
    true occupancy, measured with oversized caps before every step, fits
    them at every step (a list over its cap drops contacts for a step)."""
    worlds, steps = 16, 500
    env = EscapeRoom()
    sim = make_sim(env, num_worlds=worlds, seed=123, device="cpu")
    step = sim.step_fn()
    shipped = env.caps
    big = bp.CandidateCaps(hull_hull=64, hull_plane=64, sphere_any=8)
    acts = env.random_actions(np.random.RandomState(42), steps, worlds)
    reset = torch.zeros((worlds,), dtype=torch.int32)
    state = sim.state
    most = np.zeros(3, np.int64)
    for t in range(steps):
        body = papi.body_state(sim.executor.sm, state)
        c = bp.find_candidates(body, env.om, big, env.cfg.dt)
        occ = np.array([int(c.hh_num.max()), int(c.hp_num.max()),
                        int(c.sp_num.max())])
        assert not bool(c.overflow.any())
        assert (occ <= [shipped.hull_hull, shipped.hull_plane,
                        shipped.sphere_any]).all(), (t, occ)
        most = np.maximum(most, occ)
        state, _ = step(state, {"action": acts[t], "reset": reset})
    print(f"max occupancy over {steps} steps x {worlds} worlds: "
          f"hh={most[0]}/{shipped.hull_hull} hp={most[1]}/"
          f"{shipped.hull_plane} sp={most[2]}/{shipped.sphere_any}")
