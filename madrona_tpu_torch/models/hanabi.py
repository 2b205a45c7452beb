"""Hanabi: the cooperative card game, 2-5 players, full deck.

Port of ``madrona_tpu/models/hanabi.py``, equal to it bit for bit. The
rules are the Hanabi Learning Environment's defaults: 5 colours x 5
ranks, deck counts (3, 2, 2, 2, 1) a colour, hand size 5 (2-3 players)
or 4 (4-5 players), 8 info tokens, 3 life tokens; running out of lives
ends the game with score 0; after the deck empties every player gets
one final turn.

Action space (the current player only), HLE layout:
``[discard slot x H | play slot x H | reveal color x (P-1)*5 |
reveal rank x (P-1)*5]``, hints ordered by target offset (+1..P-1 seats
ahead), then hint value. An illegal action is replaced by the first
legal one; learners should mask with the exported ``legal_moves``.

Observations: ``obs_mode="compact"`` packs fireworks, tokens, deck,
the other hands, the own positive hints and the discards;
``"card_knowledge"`` appends the HLE V0 knowledge section: per
(relative player, slot) the 25-entry colour x rank plausibility kept
with negative hint information, and the hinted colour and rank
one-hots (35 floats a card).

The game is singleton tensors stepped by three ``custom`` nodes (reset,
turn, observation) of masked updates over the worlds. Hands shift left
on removal as in HLE. A reset deals a 50-card permutation: a stable
argsort of 50 uniforms drawn with one ``split_i`` of shape [W, 50] from
the reset node's key (equal to the JAX package's 50 separate splits;
stable, as ``jnp.argsort`` is, since 24-bit uniforms can tie).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.registry import ECSRegistry
from ..graph.builder import TaskGraphBuilder
from ..utils import rng as _rng
from .base import EnvBase

N_COLORS = 5
N_RANKS = 5
HAND = 5                 # 2-3 player hand size (module default: 2 players)
N_PLAYERS = 2
DECK = 50
MAX_INFO = 8
MAX_LIVES = 3
N_ACTIONS = 4 * HAND     # the 2-player action space

# deck composition per colour: ranks 0,0,0,1,1,2,2,3,3,4
_RANK_COUNTS = (3, 2, 2, 2, 1)
_CARD_RANKS = np.concatenate(
    [np.full(c, r) for r, c in enumerate(_RANK_COUNTS)])      # [10]
CARD_COLOR = np.repeat(np.arange(N_COLORS), 10).astype(np.int32)   # [50]
CARD_RANK = np.tile(_CARD_RANKS, N_COLORS).astype(np.int32)        # [50]

I32 = torch.int32


def hand_size(num_players: int) -> int:
    """HLE default hand sizes."""
    return 5 if num_players <= 3 else 4


def num_actions(num_players: int) -> int:
    h = hand_size(num_players)
    return 2 * h + (num_players - 1) * (N_COLORS + N_RANKS)


def compact_obs_dim(num_players: int) -> int:
    h = hand_size(num_players)
    return (
        N_COLORS * (N_RANKS + 1)
        + (MAX_INFO + 1) + (MAX_LIVES + 1) + (DECK + 1)
        + (num_players - 1) * h * (N_COLORS * N_RANKS + 1)
        + h * (N_COLORS + N_RANKS + 2)
        + DECK // 2
    )


def knowledge_obs_dim(num_players: int) -> int:
    h = hand_size(num_players)
    return num_players * h * (N_COLORS * N_RANKS + N_COLORS + N_RANKS)


OBS_DIM = compact_obs_dim(2)


class Hanabi(EnvBase):
    name = "hanabi"
    action_is_discrete = True

    def __init__(self, num_players: int = 2, obs_mode: str = "compact"):
        if not 2 <= num_players <= 5:
            raise ValueError("HLE supports 2-5 players")
        if obs_mode not in ("compact", "card_knowledge"):
            raise ValueError(f"unknown obs_mode {obs_mode!r}")
        self.num_players = num_players
        self.obs_mode = obs_mode
        self.hand = hand_size(num_players)
        self.n_actions = num_actions(num_players)
        self.num_agents = num_players
        self.action_shape = (num_players,)
        self.action_buckets = (self.n_actions,)
        self.obs_dim = compact_obs_dim(num_players) + (
            knowledge_obs_dim(num_players)
            if obs_mode == "card_knowledge" else 0
        )

    def random_actions(self, rs, steps, num_worlds):
        """[steps, W, players] int32 (CPU) from a numpy RandomState, the
        JAX package's draw."""
        return torch.from_numpy(rs.randint(
            0, self.n_actions, (steps, num_worlds, self.num_players)
        ).astype(np.int32))

    def register_types(self, reg: ECSRegistry):
        p, h = self.num_players, self.hand
        reg.register_singleton("Deck", (DECK,), I32)        # card ids
        reg.register_singleton("DeckPos", (), I32)
        reg.register_singleton("Hands", (p, h), I32)
        reg.register_singleton("HintedColor", (p, h), I32)
        reg.register_singleton("HintedRank", (p, h), I32)
        reg.register_singleton("KnowColor", (p, h, N_COLORS), I32)
        reg.register_singleton("KnowRank", (p, h, N_RANKS), I32)
        reg.register_singleton("Fireworks", (N_COLORS,), I32)
        reg.register_singleton("DiscardCount", (DECK // 2,), I32)
        reg.register_singleton("Info", (), I32)
        reg.register_singleton("Lives", (), I32)
        reg.register_singleton("CurPlayer", (), I32)
        reg.register_singleton("Score", (), I32)
        reg.register_singleton("FinalTurns", (), I32)  # -1 until deck out
        reg.register_singleton("Action", (p,), I32)
        reg.register_singleton("Reward", (), torch.float32)
        reg.register_singleton("Done", (), I32)
        reg.register_singleton("Reset", (), I32)
        reg.register_singleton("JustReset", (), I32)
        reg.register_singleton("EpisodeStep", (), I32)
        reg.register_singleton("Obs", (p, self.obs_dim), torch.float32)
        reg.register_singleton("LegalMoves", (self.n_actions,), I32)

        reg.import_singleton("Action", "action")
        reg.import_singleton("Reset", "reset")
        reg.export_singleton("Obs", "obs")
        reg.export_singleton("LegalMoves", "legal_moves")
        reg.export_singleton("Reward", "reward")
        reg.export_singleton("Done", "done")
        reg.export_singleton("Score", "score")
        reg.export_singleton("CurPlayer", "cur_player")

    def setup_tasks(self, b: TaskGraphBuilder):
        env = self
        n_reset = b.custom(
            lambda sm, st, nk: _reset_system(env, sm, st, nk),
            name="hanabi_reset",
        )
        n_step = b.custom(
            lambda sm, st, nk: _turn_system(env, sm, st, nk),
            deps=[n_reset], name="hanabi_turn",
        )
        b.custom(
            lambda sm, st, nk: _obs_system(env, sm, st, nk),
            deps=[n_step], name="hanabi_obs",
        )

    def init_worlds(self, sm, state):
        singles = dict(state.singletons)
        singles["Done"] = torch.ones_like(singles["Done"])
        return dataclasses.replace(state, singletons=singles)


def one_hot(x, n, dtype=torch.float32):
    """``jax.nn.one_hot``: a row of zeros where ``x`` lies outside
    [0, n)."""
    return (x[..., None] == torch.arange(n, device=x.device)).to(dtype)


def card_color(card):
    return card // 10


def card_rank(card):
    """CARD_RANK[card], -1 for no card. The ranks by position in a colour
    are 0,0,0,1,1,2,2,3,3,4: max((position - 1) // 2, 0), computed on the
    card's device (a table would be copied from the host every call)."""
    pos = torch.clamp(card, 0, DECK - 1) % 10
    return torch.where(card >= 0, torch.clamp((pos - 1) // 2, min=0), -1)


def deck_order(u):
    """Card ids in draw order from uniforms [W, 50]: a stable argsort,
    as ``jnp.argsort`` is (24-bit uniforms can tie)."""
    return torch.argsort(u, dim=-1, stable=True).to(I32)


def _legal_moves(env: Hanabi, s):
    """[W, A] int32 mask for the current player (HLE action layout)."""
    p = env.num_players
    w = s["Info"].shape[0]
    cur = s["CurPlayer"].long()
    widx = torch.arange(w, device=cur.device)
    values = torch.arange(N_COLORS, device=cur.device)    # = ranks 0..4
    hand = s["Hands"][widx, cur]                          # [W, h]
    occupied = hand >= 0
    can_discard = occupied & (s["Info"] < MAX_INFO)[:, None]
    has_info = (s["Info"] > 0)[:, None]

    hint_cols, hint_ranks = [], []
    for off in range(1, p):
        thand = s["Hands"][widx, (cur + off) % p]
        occ = (thand >= 0)[..., None]
        hint_cols.append(has_info & (
            occ & (card_color(thand)[..., None] == values)).any(1))
        hint_ranks.append(has_info & (
            occ & (card_rank(thand)[..., None] == values)).any(1))
    return torch.cat(
        [can_discard, occupied] + hint_cols + hint_ranks, dim=1).to(I32)


def _reset_system(env: Hanabi, sm, state, node_key):
    p, h = env.num_players, env.hand
    s = dict(state.singletons)
    need = (s["Done"] > 0) | (s["Reset"] > 0)
    w = need.shape[0]
    dev = need.device

    # deck permutation: sort 50 uniforms from the per-world stream
    perm = deck_order(_rng.sample_uniform(_rng.split_i(
        node_key[:, None, :], torch.arange(DECK, device=dev))))  # [W, 50]
    hands = perm[:, :p * h].reshape(w, p, h)

    def pick(name, fresh):
        """``fresh`` (a tensor, or a Python number kept as a scalar so
        that nothing is copied from the host) where a world resets."""
        cur = s[name]
        sel = need.reshape((w,) + (1,) * (cur.ndim - 1))
        if torch.is_tensor(fresh):
            fresh = fresh.to(cur.dtype)
        return torch.where(sel, fresh, cur)

    s["Deck"] = pick("Deck", perm)
    s["DeckPos"] = pick("DeckPos", p * h)
    s["Hands"] = pick("Hands", hands)
    s["HintedColor"] = pick("HintedColor", -1)
    s["HintedRank"] = pick("HintedRank", -1)
    s["KnowColor"] = pick("KnowColor", 1)
    s["KnowRank"] = pick("KnowRank", 1)
    s["Fireworks"] = pick("Fireworks", 0)
    s["DiscardCount"] = pick("DiscardCount", 0)
    s["Info"] = pick("Info", MAX_INFO)
    s["Lives"] = pick("Lives", MAX_LIVES)
    s["CurPlayer"] = pick("CurPlayer", 0)
    s["Score"] = pick("Score", 0)
    s["FinalTurns"] = pick("FinalTurns", -1)
    s["EpisodeStep"] = pick("EpisodeStep", 0)
    s["JustReset"] = need.to(I32)
    return dataclasses.replace(state, singletons=s)


# the singletons the turn node writes; a world reset this step keeps them
_TURN_WRITES = (
    "Fireworks", "Lives", "Info", "DiscardCount", "Hands", "HintedColor",
    "HintedRank", "KnowColor", "KnowRank", "DeckPos", "CurPlayer", "Score",
    "FinalTurns", "Done", "Reward", "EpisodeStep",
)


def _turn_system(env: Hanabi, sm, state, node_key):
    p, h = env.num_players, env.hand
    pre = state.singletons
    s = dict(pre)
    w = s["Info"].shape[0]
    cur = s["CurPlayer"]
    cur_l = cur.long()
    widx = torch.arange(w, device=cur.device)

    legal = _legal_moves(env, s)                          # [W, A]
    raw = s["Action"][widx, cur_l]
    n_act = legal.shape[1]
    # an index outside [0, A) reads as JAX's gather reads it: negative
    # values wrap once, the rest clamp
    raw_idx = torch.clamp(torch.where(raw < 0, raw + n_act, raw), 0,
                          n_act - 1).long()
    is_legal = legal[widx, raw_idx] > 0
    first_legal = torch.argmax(legal, dim=1).to(I32)
    act = torch.where(is_legal, raw, first_legal)

    # HLE layout decode
    is_discard = act < h
    is_play = (act >= h) & (act < 2 * h)
    hint_id = act - 2 * h                                 # >= 0 iff a hint
    n_chints = (p - 1) * N_COLORS
    is_chint = (hint_id >= 0) & (hint_id < n_chints)
    is_rhint = hint_id >= n_chints
    rhint_id = hint_id - n_chints
    hint_off = torch.where(
        is_chint, hint_id // N_COLORS, rhint_id // N_RANKS) + 1
    hint_val = torch.where(
        is_chint, hint_id % N_COLORS, rhint_id % N_RANKS)
    hint_tgt = ((cur + torch.clamp(hint_off, 1, p - 1)) % p).long()
    slot = torch.clamp(torch.where(is_discard, act, act - h), 0, h - 1)
    removes = is_discard | is_play

    hand = s["Hands"][widx, cur_l]                        # [W, h]
    card = hand[widx, slot.long()]
    ccol = card_color(torch.clamp(card, min=0)).long()
    crank = card_rank(card)

    # ---- play resolution
    fw = s["Fireworks"]
    success = is_play & (crank == fw[widx, ccol])
    fw = fw.index_put((widx, ccol), success.to(I32), accumulate=True)
    completed = success & (fw[widx, ccol] == N_RANKS)
    lives = s["Lives"] - (is_play & ~success).to(I32)
    info = s["Info"] + (is_discard | completed).to(I32)
    info = info - (is_chint | is_rhint).to(I32)
    info = torch.clamp(info, 0, MAX_INFO)

    # discard pile: count per card *type* (colour * 5 + rank)
    ctype = ccol * N_RANKS + torch.clamp(crank, min=0).long()
    add_discard = (is_discard | (is_play & ~success)) & (card >= 0)
    discards = s["DiscardCount"].index_put(
        (widx, ctype), add_discard.to(I32), accumulate=True)

    # ---- hand update: shift-left removal + draw at the rightmost slot
    deck_pos = s["DeckPos"]
    can_draw = deck_pos < DECK
    drawn = torch.where(
        can_draw, s["Deck"][widx, torch.clamp(deck_pos, 0, DECK - 1).long()],
        -1)

    slots = torch.arange(h, device=cur.device)[None, :]
    shift = removes[:, None] & (slots >= slot[:, None])
    next_slot = torch.clamp(slots + 1, 0, h - 1)
    last = removes[:, None] & (slots == h - 1)

    def shift_left(arr, fresh):
        """arr [W, h, ...]: remove ``slot``, shift left, append fresh."""
        extra = (1,) * (arr.ndim - 2)
        out = torch.where(shift.reshape(shift.shape + extra),
                          arr[widx[:, None], next_slot], arr)
        return torch.where(last.reshape(last.shape + extra), fresh, out)

    rm = removes[:, None]
    hc = s["HintedColor"][widx, cur_l]
    hr = s["HintedRank"][widx, cur_l]
    kc = s["KnowColor"][widx, cur_l]                      # [W, h, C]
    kr = s["KnowRank"][widx, cur_l]
    rows = (widx, cur_l)
    hands = s["Hands"].index_put(
        rows, torch.where(rm, shift_left(hand, drawn[:, None]), hand))
    hinted_c = s["HintedColor"].index_put(
        rows, torch.where(rm, shift_left(hc, -1), hc))
    hinted_r = s["HintedRank"].index_put(
        rows, torch.where(rm, shift_left(hr, -1), hr))
    know_c = s["KnowColor"].index_put(
        rows, torch.where(rm[..., None], shift_left(kc, 1), kc))
    know_r = s["KnowRank"].index_put(
        rows, torch.where(rm[..., None], shift_left(kr, 1), kr))
    deck_pos = deck_pos + (removes & can_draw).to(I32)

    # ---- hints mark the target player's matching cards (+ negative info)
    trows = (widx, hint_tgt)
    thand = hands[trows]
    occ = thand >= 0
    mark_c = is_chint[:, None] & occ & (
        card_color(torch.clamp(thand, min=0)) == hint_val[:, None])
    mark_r = is_rhint[:, None] & occ & (
        card_rank(thand) == hint_val[:, None])
    hinted_c = hinted_c.index_put(
        trows, torch.where(mark_c, hint_val[:, None], hinted_c[trows]))
    hinted_r = hinted_r.index_put(
        trows, torch.where(mark_r, hint_val[:, None], hinted_r[trows]))

    # knowledge (HLE V0): matching cards collapse to the hinted value;
    # non-matching occupied cards exclude it
    def know(table, is_hint, mark, n):
        t = table[trows]                                  # [W, h, n]
        val_oh = one_hot(hint_val, n, t.dtype)[:, None, :]
        miss = (is_hint[:, None] & occ & ~mark)[..., None]
        t = torch.where(mark[..., None], val_oh, t)
        t = torch.where(miss & (val_oh > 0), 0, t)
        return table.index_put(trows, t)

    know_c = know(know_c, is_chint, mark_c, N_COLORS)
    know_r = know(know_r, is_rhint, mark_r, N_RANKS)

    # ---- scoring / termination (HLE: out of lives -> score 0)
    old_score = s["Score"]
    score = fw.sum(dim=1, dtype=I32)
    dead = lives <= 0
    final_turns = s["FinalTurns"]
    # decrement an active countdown first, THEN arm it when the deck just
    # ran out: the player who drew the last card also gets a final turn
    final_turns = torch.where(final_turns > 0, final_turns - 1, final_turns)
    deck_out = (deck_pos >= DECK) & (final_turns < 0)
    final_turns = torch.where(deck_out, p, final_turns)
    perfect = score == N_COLORS * N_RANKS
    done = dead | perfect | (final_turns == 0)
    score = torch.where(dead, 0, score)

    s.update(
        Fireworks=fw, Lives=lives, Info=info, DiscardCount=discards,
        Hands=hands, HintedColor=hinted_c, HintedRank=hinted_r,
        KnowColor=know_c, KnowRank=know_r, DeckPos=deck_pos,
        CurPlayer=(cur + 1) % p, Score=score, FinalTurns=final_turns,
        Done=done.to(I32), Reward=(score - old_score).to(torch.float32),
        EpisodeStep=s["EpisodeStep"] + 1,
    )
    # hold on just-reset worlds (the cartpole convention): the action in
    # flight was chosen from the dead episode's terminal observation, so
    # the fresh deal is observed first; reward 0 and done 0 on that step
    hold = pre["JustReset"] > 0
    for key in _TURN_WRITES:
        sel = hold.reshape((w,) + (1,) * (s[key].ndim - 1))
        s[key] = torch.where(sel, pre[key], s[key])
    s["Reward"] = torch.where(hold, 0.0, s["Reward"])
    s["Done"] = torch.where(hold, 0, s["Done"])
    return dataclasses.replace(state, singletons=s)


def _obs_system(env: Hanabi, sm, state, node_key):
    p, h = env.num_players, env.hand
    s = dict(state.singletons)
    w = s["Info"].shape[0]
    f32 = torch.float32

    def onehot(x, n):
        return one_hot(torch.clamp(x, 0, n - 1), n) * (x >= 0)[..., None]

    fw = one_hot(s["Fireworks"], N_RANKS + 1).reshape(w, -1)
    info = one_hot(s["Info"], MAX_INFO + 1)
    lives = one_hot(s["Lives"], MAX_LIVES + 1)
    deck_left = one_hot(DECK - s["DeckPos"], DECK + 1)
    discards = s["DiscardCount"].to(f32) / 3.0

    def player_view(q):
        # other hands in relative seat order (+1 .. +p-1)
        ocards = []
        for off in range(1, p):
            ohand = s["Hands"][:, (q + off) % p]
            otype = card_color(torch.clamp(ohand, min=0)) * N_RANKS \
                + torch.clamp(card_rank(ohand), min=0)
            ocards.append(torch.cat([
                onehot(torch.where(ohand >= 0, otype, -1),
                       N_COLORS * N_RANKS),
                (ohand < 0)[..., None].to(f32),
            ], dim=-1).reshape(w, -1))
        kc = s["HintedColor"][:, q]
        kr = s["HintedRank"][:, q]
        own = torch.cat([
            onehot(kc, N_COLORS), onehot(kr, N_RANKS),
            (kc >= 0)[..., None].to(f32), (kr >= 0)[..., None].to(f32),
        ], dim=-1).reshape(w, -1)
        parts = [fw, info, lives, deck_left] + ocards + [own, discards]
        if env.obs_mode == "card_knowledge":
            # HLE V0 knowledge section: relative seats starting at self
            for off in range(p):
                q2 = (q + off) % p
                plaus = (s["KnowColor"][:, q2][..., :, None]
                         * s["KnowRank"][:, q2][..., None, :]
                         ).reshape(w, h, -1)              # [W, h, 25]
                parts.append(torch.cat([
                    plaus.to(f32),
                    onehot(s["HintedColor"][:, q2], N_COLORS),
                    onehot(s["HintedRank"][:, q2], N_RANKS),
                ], dim=-1).reshape(w, -1))
        return torch.cat(parts, dim=-1)

    s["Obs"] = torch.stack([player_view(q) for q in range(p)], dim=1)
    s["LegalMoves"] = _legal_moves(env, s)
    return dataclasses.replace(state, singletons=s)
