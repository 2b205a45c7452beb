"""Hanabi of the PyTorch port vs the JAX package and the NumPy oracles.

Tolerance: none anywhere. Hanabi is an integer game driven by Threefry,
so every comparison is equality (dtypes included):

(a) the JAX sim Hanabi(num_players=3, obs_mode="card_knowledge") at 8
    worlds, 120 steps of random_actions(RandomState(7)), reset = 1 for
    worlds 0-3 at step 60: every export and every singleton of the port
    equal at every step;
(b) the port against tests/test_hanabi.py's OracleHanabi (2 players, 4
    worlds, its seed and actions) and OracleHanabiN (3, 4 and 5 players,
    2 worlds, seed 11 + p, RandomState(p)), 120 steps each: reward,
    score and done;
(c) the knowledge and rule tests of tests/test_hanabi.py (negative hint
    information, the knowledge shift on removal, and the six rules) on
    the port, from the same literal states;
(d) the deal's sort (deck_order) on uniforms with forced ties, equal to
    jnp.argsort.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import np_rng
from madrona_tpu.models.base import make_sim as j_make_sim
from madrona_tpu.models.hanabi import Hanabi as JHanabi
from madrona_tpu_torch import make_sim
from madrona_tpu_torch.models import hanabi as H
from madrona_tpu_torch.models.hanabi import Hanabi

from test_hanabi import SEED, OracleHanabi, OracleHanabiN

torch.set_num_threads(1)

W, T, RESET_AT = 8, 120, 60


def _zeros(w):
    return torch.zeros((w,), dtype=torch.int32)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX sim's exports and singletons at every step (numpy)."""
    env = JHanabi(num_players=3, obs_mode="card_knowledge")
    acts = np.asarray(env.random_actions(np.random.RandomState(7), T, W))
    resets = np.zeros((T, W), np.int32)
    resets[RESET_AT, :4] = 1
    sim = j_make_sim(env, num_worlds=W, seed=SEED, donate=False)
    step = sim.step_fn()
    s = sim.state
    outs, singles = [], []
    for t in range(T):
        s, o = step(s, {"action": jnp.asarray(acts[t]),
                        "reset": jnp.asarray(resets[t])})
        outs.append({k: np.asarray(v) for k, v in o.items()})
        singles.append({k: np.asarray(v) for k, v in s.singletons.items()})
    return acts, resets, outs, singles


def _equal(got, ref, what):
    assert got.dtype == ref.dtype, (what, got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref, err_msg=what)


def test_matches_jax_every_step(jax_run):
    """(a) 3 players, card knowledge, a forced reset of half the worlds."""
    acts, resets, outs, singles = jax_run
    env = Hanabi(num_players=3, obs_mode="card_knowledge")
    np.testing.assert_array_equal(
        env.random_actions(np.random.RandomState(7), T, W).numpy(), acts)
    sim = make_sim(env, num_worlds=W, seed=SEED, device="cpu")
    dones = 0
    for t in range(T):
        o = sim.step({"action": torch.from_numpy(acts[t].copy()),
                      "reset": torch.from_numpy(resets[t].copy())})
        assert set(o) == set(outs[t])
        for k, v in o.items():
            _equal(v.numpy(), outs[t][k], f"step {t} export {k}")
        for k, v in sim.state.singletons.items():
            _equal(v.numpy(), singles[t][k], f"step {t} singleton {k}")
        dones += int(o["done"].sum())
    assert dones > 0
    assert (singles[RESET_AT]["JustReset"][:4] == 1).all()


@pytest.mark.parametrize("p", [2, 3, 4, 5])
def test_matches_numpy_oracle(p):
    """(b) tests/test_hanabi.py's oracles, its seeds and actions."""
    w, seed = (4, SEED) if p == 2 else (2, SEED + p)
    env = Hanabi(num_players=p)
    acts = env.random_actions(np.random.RandomState(7 if p == 2 else p),
                              T, w)
    sim = make_sim(env, num_worlds=w, seed=seed, device="cpu")
    outs = [sim.step({"action": acts[t], "reset": _zeros(w)})
            for t in range(T)]
    base = np_rng.key(np.full((w,), seed, np.uint32))
    keys = np_rng.split_i(base, np.arange(w, dtype=np.uint32))
    ends = 0
    for wi in range(w):
        oracle = (OracleHanabi(keys[wi]) if p == 2
                  else OracleHanabiN(keys[wi], p))
        for t in range(T):
            r = oracle.step(acts[t, wi].numpy())
            assert float(outs[t]["reward"][wi]) == r, (p, wi, t)
            assert int(outs[t]["score"][wi]) == oracle.score, (p, wi, t)
            assert int(outs[t]["done"][wi]) == int(oracle.done), (p, wi, t)
            ends += int(oracle.done)
        lm = outs[-1]["legal_moves"].numpy()
        assert lm.shape == (w, H.num_actions(p)) and (lm.sum(1) >= 1).all()
    assert ends > 0


# ------------------------------------------------ knowledge and rules (c)

def _stacked_state(sim, **overrides):
    """World 0's singletons set to a literal configuration."""
    s = dict(sim.state.singletons)
    overrides.setdefault("FinalTurns", -1)   # deck not out
    overrides.setdefault("DeckPos", 20)
    for k, v in overrides.items():
        arr = s[k].clone()
        arr[0] = torch.as_tensor(v, dtype=arr.dtype)
        s[k] = arr
    return dataclasses.replace(sim.state, singletons=s)


def _step0(step, state, action):
    acts = torch.full((1, 2), action, dtype=torch.int32)
    return step(state, {"action": acts, "reset": _zeros(1)})


def _single(st, name, *idx):
    return int(st.singletons[name][(0,) + idx])


HANDS = [[0, 10, 20, 30, 40], [1, 11, 21, 31, 41]]


def _rule_play_correct_card_scores(step, sim):
    st = _stacked_state(sim, Hands=HANDS, Fireworks=[0] * 5, Info=4,
                        Lives=3, CurPlayer=0, Score=0, Done=0, Reset=0)
    st, o = _step0(step, st, H.HAND + 0)            # play slot 0
    assert _single(st, "Fireworks", 0) == 1
    assert float(o["reward"][0]) == 1.0 and int(o["score"][0]) == 1
    assert _single(st, "Lives") == 3


def _rule_misplay_burns_life_not_score(step, sim):
    st = _stacked_state(sim, Hands=[[9, 10, 20, 30, 40], HANDS[1]],
                        Fireworks=[0] * 5, Info=4, Lives=3, CurPlayer=0,
                        Score=0, Done=0, Reset=0)
    st, o = _step0(step, st, H.HAND + 0)
    assert _single(st, "Lives") == 2
    assert int(o["score"][0]) == 0 and float(o["reward"][0]) == 0.0
    assert _single(st, "DiscardCount", 4) == 1      # colour 0, rank 4


def _rule_hint_costs_token_discard_regains(step, sim):
    st = _stacked_state(sim, Hands=HANDS, Info=4, Lives=3, CurPlayer=0,
                        Done=0, Reset=0)
    st, _ = _step0(step, st, 2 * H.HAND + 0)        # hint colour 0
    assert _single(st, "Info") == 3
    st, _ = _step0(step, st, 0)                     # player 1 discards
    assert _single(st, "Info") == 4


def _rule_completing_firework_grants_bonus_token(step, sim):
    st = _stacked_state(sim, Hands=[[9, 10, 20, 30, 40], HANDS[1]],
                        Fireworks=[4, 0, 0, 0, 0], Info=2, Lives=3,
                        CurPlayer=0, Score=4, Done=0, Reset=0)
    st, o = _step0(step, st, H.HAND + 0)
    assert _single(st, "Fireworks", 0) == 5
    assert _single(st, "Info") == 3 and float(o["reward"][0]) == 1.0


def _rule_discard_illegal_at_max_tokens(step, sim):
    st = _stacked_state(sim, Hands=HANDS, Info=H.MAX_INFO, CurPlayer=0,
                        Done=0, Reset=0)
    lm = H._legal_moves(sim.env, dict(st.singletons)).numpy()
    assert (lm[0, :H.HAND] == 0).all()              # discards illegal
    assert (lm[0, H.HAND:2 * H.HAND] == 1).all()    # plays legal


def _rule_out_of_lives_zeroes_score(step, sim):
    st = _stacked_state(sim, Hands=[[9, 10, 20, 30, 40], HANDS[1]],
                        Fireworks=[0, 3, 0, 0, 0], Info=4, Lives=1,
                        CurPlayer=0, Score=3, Done=0, Reset=0)
    st, o = _step0(step, st, H.HAND + 0)            # misplay, 1 life left
    assert int(o["done"][0]) == 1 and int(o["score"][0]) == 0


RULES = {f.__name__[6:]: f for f in (
    _rule_play_correct_card_scores, _rule_misplay_burns_life_not_score,
    _rule_hint_costs_token_discard_regains,
    _rule_completing_firework_grants_bonus_token,
    _rule_discard_illegal_at_max_tokens, _rule_out_of_lives_zeroes_score)}


@pytest.mark.parametrize("rule", sorted(RULES))
def test_rules(rule):
    """tests/test_hanabi.py:472-563 on the port."""
    sim = make_sim(Hanabi(), num_worlds=1, seed=3, device="cpu")
    RULES[rule](sim.step_fn(), sim)


def _hint_first_card_colour(seed):
    """Deal (one step), then the current player hints the colour of the
    other player's slot-0 card; returns (sim, step, state, hands, other,
    colour, the hint step's exports)."""
    env = Hanabi(obs_mode="card_knowledge")
    sim = make_sim(env, num_worlds=1, seed=seed, device="cpu")
    step = sim.step_fn()
    s, _ = _step0(step, sim.state, 5)
    hands = s.singletons["Hands"][0].numpy()
    cur = int(s.singletons["CurPlayer"][0])
    other = 1 - cur
    colour = int(H.CARD_COLOR[hands[other][0]])
    a = torch.zeros((1, 2), dtype=torch.int32)
    a[0, cur] = 10 + colour           # reveal colour to the other player
    s, o = step(s, {"action": a, "reset": _zeros(1)})
    return sim, step, s, hands, other, colour, o


@pytest.mark.parametrize("case", ["negative_info", "shift_on_removal"])
def test_card_knowledge(case):
    """tests/test_hanabi.py:369-466 on the port."""
    if case == "negative_info":
        sim, _, s, hands, other, colour, o = _hint_first_card_colour(3)
        kc = s.singletons["KnowColor"][0, other].numpy()        # [h, 5]
        hc = s.singletons["HintedColor"][0, other].numpy()
        for i in range(5):
            card = hands[other][i]
            if card < 0:
                continue
            if int(H.CARD_COLOR[card]) == colour:
                assert hc[i] == colour
                assert kc[i].tolist() == [int(c == colour) for c in range(5)]
            else:
                assert kc[i, colour] == 0 and kc[i].sum() == 4
        obs = o["obs"].numpy()
        assert obs.shape == (1, 2, sim.env.obs_dim)
        assert np.isfinite(obs).all()
        know_sec = obs[0, other, H.compact_obs_dim(2):].reshape(2, 5, 35)
        kr = s.singletons["KnowRank"][0, other].numpy()
        np.testing.assert_array_equal(
            know_sec[0, :, :25], (kc[:, :, None] * kr[:, None, :]).reshape(
                5, 25))
    else:
        _, step, s, _, other, _, _ = _hint_first_card_colour(5)
        before = s.singletons["KnowColor"][0, other].numpy()
        a = torch.zeros((1, 2), dtype=torch.int32)
        a[0, other] = 0            # the hinted player discards slot 0
        s, _ = step(s, {"action": a, "reset": _zeros(1)})
        after = s.singletons["KnowColor"][0, other].numpy()
        np.testing.assert_array_equal(after[:4], before[1:])
        assert after[4].tolist() == [1] * 5


def test_deck_order_ties_match_jnp_argsort():
    """(d) Uniforms with many ties (8 values a row, and rows of one
    value): the port's stable sort deals as jnp.argsort does."""
    rs = np.random.RandomState(0)
    u = (rs.randint(0, 8, (64, H.DECK)) * 2.0 ** -24).astype(np.float32)
    u[0] = 0.5
    u[1, ::2] = u[1, 1::2]
    got = H.deck_order(torch.from_numpy(u)).numpy()
    ref = np.asarray(jnp.argsort(jnp.asarray(u), axis=-1)).astype(np.int32)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got[0], np.arange(H.DECK))
