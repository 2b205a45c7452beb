"""Overcooked: a 2-agent cooperative cooking gridworld.

Port of ``madrona_tpu/models/overcooked.py``, equal to it bit for bit.
The rules follow overcooked_ai's OvercookedGridworld defaults: 6 actions
(N/S/E/W/stay/interact), the facing updated on every move attempt, the
collision rule (the same target, or a swap: neither moves), onion pots
that start cooking at 3 onions (20 ticks), a dish picks up ready soup,
+20 shared reward a delivery, counters hold one item each, 400 steps an
episode, then an automatic reset.

Layouts are static per env instance (X counter, P pot, O onion
dispenser, D dish dispenser, S serving, ' ' floor, 1/2 start
positions). Every step is masked updates over the worlds, in three
``custom`` nodes (reset, step, observation). Agent 0 interacts before
agent 1 within a step, so two agents facing the same pot or counter
resolve in that order. The env draws no random number.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.registry import ECSRegistry
from ..graph.builder import TaskGraphBuilder
from .base import EnvBase

CRAMPED_ROOM = (
    "XXPXX",
    "O1 2O",
    "X   X",
    "XDXSX",
)

ASYMMETRIC_ADVANTAGES = (
    "XXXXXXXXX",
    "O XSXOX S",
    "X   P 1 X",
    "X2  P   X",
    "XXXDXDXXX",
)

LAYOUTS = {
    "cramped_room": CRAMPED_ROOM,
    "asymmetric_advantages": ASYMMETRIC_ADVANTAGES,
}

# actions
A_NORTH, A_SOUTH, A_EAST, A_WEST, A_STAY, A_INTERACT = range(6)
# grid deltas (row, col); north = up = row - 1
DELTAS = np.array([(-1, 0), (1, 0), (0, 1), (0, -1), (0, 0)], np.int32)

# held items
H_NONE, H_ONION, H_DISH, H_SOUP = range(4)

T_FLOOR, T_COUNTER, T_POT, T_ONION, T_DISH, T_SERVE = range(6)
_TCHAR = {" ": T_FLOOR, "1": T_FLOOR, "2": T_FLOOR, "X": T_COUNTER,
          "P": T_POT, "O": T_ONION, "D": T_DISH, "S": T_SERVE}

COOK_TIME = 20
POT_CAPACITY = 3
DELIVERY_REWARD = 20.0
EPISODE_LEN = 400
N_AGENTS = 2

I32 = torch.int32
F32 = torch.float32
_INV_COOK_TIME = float(np.float32(1.0 / COOK_TIME))


class Overcooked(EnvBase):
    name = "overcooked"
    num_agents = N_AGENTS
    action_is_discrete = True
    action_shape = (N_AGENTS,)
    action_buckets = (6,)

    def __init__(self, layout="cramped_room", shaped_rewards: bool = False):
        # overcooked_ai's default shaped rewards (a training aid):
        # +3 onion into a pot, +3 dish pickup, +5 soup pickup
        self.shaped_rewards = shaped_rewards
        rows = LAYOUTS[layout] if isinstance(layout, str) else layout
        self.layout_name = layout if isinstance(layout, str) else "custom"
        self.H = len(rows)
        self.W = len(rows[0])
        self.terrain = np.array(
            [[_TCHAR[ch] for ch in row] for row in rows], np.int32)
        starts = {}
        for r, row in enumerate(rows):
            for c, ch in enumerate(row):
                if ch in "12":
                    starts[int(ch) - 1] = (r, c)
        self.start_pos = np.array([starts[0], starts[1]], np.int32)  # [2, 2]
        self.pot_rc = np.argwhere(self.terrain == T_POT).astype(np.int32)
        self.n_pots = len(self.pot_rc)
        self.obs_channels = 16
        self._tables = {}

    def tables(self, device):
        """(terrain, DELTAS, pot_rc, start_pos) as tensors on ``device``,
        copied from the host once a device."""
        device = torch.device(device)
        if device not in self._tables:
            self._tables[device] = tuple(
                torch.as_tensor(a, device=device) for a in (
                    self.terrain, DELTAS, self.pot_rc, self.start_pos))
        return self._tables[device]

    @staticmethod
    def random_actions(rs, steps, num_worlds):
        """[steps, W, 2] int32 (CPU) from a numpy RandomState, the JAX
        package's draw."""
        return torch.from_numpy(
            rs.randint(0, 6, (steps, num_worlds, N_AGENTS)).astype(np.int32))

    def register_types(self, reg: ECSRegistry):
        H, W_ = self.H, self.W
        reg.register_singleton("AgentPos", (N_AGENTS, 2), I32)
        reg.register_singleton("AgentDir", (N_AGENTS,), I32)
        reg.register_singleton("Held", (N_AGENTS,), I32)
        reg.register_singleton("PotCount", (self.n_pots,), I32)
        reg.register_singleton("PotTimer", (self.n_pots,), I32)
        reg.register_singleton("ItemGrid", (H, W_), I32)
        reg.register_singleton("Action", (N_AGENTS,), I32)
        reg.register_singleton("Reward", (), F32)
        reg.register_singleton("Done", (), I32)
        reg.register_singleton("Reset", (), I32)
        reg.register_singleton("EpisodeStep", (), I32)
        reg.register_singleton(
            "Obs", (N_AGENTS, H, W_, self.obs_channels), F32)

        reg.register_singleton("Deliveries", (), I32)
        reg.export_singleton("Deliveries", "deliveries")

        reg.import_singleton("Action", "action")
        reg.import_singleton("Reset", "reset")
        reg.export_singleton("Obs", "obs")
        reg.export_singleton("Reward", "reward")
        reg.export_singleton("Done", "done")
        reg.export_singleton("EpisodeStep", "steps_taken")

    def setup_tasks(self, b: TaskGraphBuilder):
        n_reset = b.custom(self._reset_system, name="oc_reset")
        n_step = b.custom(self._step_system, deps=[n_reset], name="oc_step")
        b.custom(self._obs_system, deps=[n_step], name="oc_obs")

    def init_worlds(self, sm, state):
        singles = dict(state.singletons)
        singles["Done"] = torch.ones_like(singles["Done"])
        return dataclasses.replace(state, singletons=singles)

    # ------------------------------------------------------------- systems

    def _reset_system(self, sm, state, node_key):
        s = dict(state.singletons)
        need = (s["Done"] > 0) | (s["Reset"] > 0)
        w = need.shape[0]

        def pick(name, fresh):
            cur = s[name]
            sel = need.reshape((w,) + (1,) * (cur.ndim - 1))
            return torch.where(sel, fresh, cur)

        s["AgentPos"] = pick("AgentPos", self.tables(need.device)[3][None])
        s["AgentDir"] = pick("AgentDir", A_SOUTH)
        s["Held"] = pick("Held", H_NONE)
        s["PotCount"] = pick("PotCount", 0)
        s["PotTimer"] = pick("PotTimer", -1)
        s["ItemGrid"] = pick("ItemGrid", 0)
        s["Deliveries"] = pick("Deliveries", 0)
        s["EpisodeStep"] = pick("EpisodeStep", 0)
        return dataclasses.replace(state, singletons=s)

    def _step_system(self, sm, state, node_key):
        s = dict(state.singletons)
        w = s["Done"].shape[0]
        dev = s["Done"].device
        widx = torch.arange(w, device=dev)
        terrain, deltas, pot_rc, _ = self.tables(dev)
        H, W_ = self.H, self.W

        act = s["Action"]                                 # [W, 2]
        pos = s["AgentPos"]                               # [W, 2, 2]
        dirs = s["AgentDir"]
        held = s["Held"]
        items = s["ItemGrid"]
        pot_cnt = s["PotCount"]
        pot_tmr = s["PotTimer"]
        reward = torch.zeros((w,), dtype=F32, device=dev)
        deliveries = s["Deliveries"]

        # ---- movement (face first, then move if free; collision rule)
        is_move = act < 4
        new_dir = torch.where(is_move, act, dirs)
        step_d = deltas[torch.clamp(act, 0, 4).long()]   # [W, 2, 2]
        tgt = pos + torch.where(is_move[..., None], step_d, 0)
        tgt = torch.stack([torch.clamp(tgt[..., 0], 0, H - 1),
                           torch.clamp(tgt[..., 1], 0, W_ - 1)], dim=-1)
        walkable = terrain[tgt[..., 0].long(), tgt[..., 1].long()] == T_FLOOR
        prop = torch.where(walkable[..., None], tgt, pos)
        # conflict: the same target cell, or swapping cells
        same = (prop[:, 0] == prop[:, 1]).all(-1)
        swap = (prop[:, 0] == pos[:, 1]).all(-1) & (
            prop[:, 1] == pos[:, 0]).all(-1)
        new_pos = torch.where((same | swap)[:, None, None], pos, prop)

        # ---- interact
        facing = new_pos + deltas[torch.clamp(new_dir, 0, 3).long()]
        fr = torch.clamp(facing[..., 0], 0, H - 1)
        fc = torch.clamp(facing[..., 1], 0, W_ - 1)
        ftile = terrain[fr.long(), fc.long()]             # [W, 2]
        interact = act == A_INTERACT

        # resolve agents in turn (agent 0, then agent 1) so that two agents
        # using the same tile behave deterministically
        for a in range(N_AGENTS):
            ia = interact[:, a]
            h = held[:, a]
            tr, tc = fr[:, a], fc[:, a]
            tile = ftile[:, a]

            # onion / dish dispensers
            grab_onion = ia & (tile == T_ONION) & (h == H_NONE)
            grab_dish = ia & (tile == T_DISH) & (h == H_NONE)

            # pot interactions: which pot (if any) is faced
            pot_match = (pot_rc[None, :, 0] == tr[:, None]) & (
                pot_rc[None, :, 1] == tc[:, None])        # [W, n_pots]
            faces_pot = ia & (tile == T_POT) & pot_match.any(1)
            # the first matching pot (argmax of a bool taken on ints)
            pot_idx = torch.argmax(pot_match.to(I32), dim=1)
            pots = (widx, pot_idx)
            cnt = pot_cnt[pots]
            tmr = pot_tmr[pots]
            add_onion = (faces_pot & (h == H_ONION) & (cnt < POT_CAPACITY)
                         & (tmr < 0))
            new_cnt = cnt + add_onion.to(I32)
            start_cook = add_onion & (new_cnt == POT_CAPACITY)
            take_soup = faces_pot & (h == H_DISH) & (tmr == 0)
            pot_cnt = pot_cnt.index_put(
                pots, torch.where(take_soup, 0, new_cnt))
            pot_tmr = pot_tmr.index_put(pots, torch.where(
                take_soup, -1, torch.where(start_cook, COOK_TIME, tmr)))

            # serving
            serve = ia & (tile == T_SERVE) & (h == H_SOUP)
            reward = reward + torch.where(serve, DELIVERY_REWARD, 0.0)
            deliveries = deliveries + serve.to(I32)
            if self.shaped_rewards:
                reward = (reward + 3.0 * add_onion + 3.0 * grab_dish
                          + 5.0 * take_soup)

            # counters: put down on an empty one, pick up from a full one
            cell = (widx, tr.long(), tc.long())
            citem = items[cell]
            on_counter = ia & (tile == T_COUNTER)
            put = on_counter & (h != H_NONE) & (citem == H_NONE)
            take = on_counter & (h == H_NONE) & (citem != H_NONE)
            items = items.index_put(cell, torch.where(
                put, h, torch.where(take, H_NONE, citem)))

            new_h = torch.where(grab_onion, H_ONION, h)
            new_h = torch.where(grab_dish, H_DISH, new_h)
            new_h = torch.where(add_onion, H_NONE, new_h)
            new_h = torch.where(take_soup, H_SOUP, new_h)
            new_h = torch.where(serve, H_NONE, new_h)
            new_h = torch.where(put, H_NONE, new_h)
            new_h = torch.where(take, citem, new_h)
            held = torch.stack([new_h if i == a else held[:, i]
                                for i in range(N_AGENTS)], dim=1)

        # ---- pots cook
        pot_tmr = torch.where(pot_tmr > 0, pot_tmr - 1, pot_tmr)

        ep = s["EpisodeStep"] + 1
        s.update(
            AgentPos=new_pos, AgentDir=new_dir, Held=held, ItemGrid=items,
            PotCount=pot_cnt, PotTimer=pot_tmr, Reward=reward,
            Deliveries=deliveries, EpisodeStep=ep,
            Done=(ep >= EPISODE_LEN).to(I32),
        )
        return dataclasses.replace(state, singletons=s)

    def _obs_system(self, sm, state, node_key):
        """Feature planes a agent ([H, W, 16]): 0 own position, 1-4 own
        direction, 5 other position, 6-9 other direction, 10 pot onions
        / 3, 11 cook remaining / 20, 12 soup ready, 13-15 items on the
        grid (onion, dish, soup)."""
        s = dict(state.singletons)
        w = s["Done"].shape[0]
        dev = s["Done"].device
        H, W_ = self.H, self.W
        widx = torch.arange(w, device=dev)
        pos = s["AgentPos"].long()
        dirs = s["AgentDir"].long()
        items = s["ItemGrid"]

        pot_plane = torch.zeros((w, H, W_), dtype=F32, device=dev)
        cook_plane = torch.zeros_like(pot_plane)
        ready_plane = torch.zeros_like(pot_plane)
        for i, (r, c) in enumerate(self.pot_rc.tolist()):
            pot_plane[:, r, c] = s["PotCount"][:, i] / POT_CAPACITY
            # XLA turns the JAX package's division by COOK_TIME into a
            # product with its float32 reciprocal (18 / 20 reads
            # 0.90000004 there); the port takes the same product
            cook_plane[:, r, c] = torch.clamp(
                s["PotTimer"][:, i], min=0).to(F32) * _INV_COOK_TIME
            ready_plane[:, r, c] = (s["PotTimer"][:, i] == 0).to(F32)
        item_planes = torch.stack(
            [(items == k).to(F32) for k in (H_ONION, H_DISH, H_SOUP)], dim=-1)
        shared = torch.cat([pot_plane[..., None], cook_plane[..., None],
                            ready_plane[..., None], item_planes], dim=-1)

        def view(p):
            o = torch.zeros((w, H, W_, 10), dtype=F32, device=dev)
            other = 1 - p
            o[widx, pos[:, p, 0], pos[:, p, 1], 0] = 1.0
            o[widx, pos[:, p, 0], pos[:, p, 1], 1 + dirs[:, p]] = 1.0
            o[widx, pos[:, other, 0], pos[:, other, 1], 5] = 1.0
            o[widx, pos[:, other, 0], pos[:, other, 1],
              6 + dirs[:, other]] = 1.0
            return torch.cat([o, shared], dim=-1)

        s["Obs"] = torch.stack([view(p) for p in range(N_AGENTS)], dim=1)
        return dataclasses.replace(state, singletons=s)
