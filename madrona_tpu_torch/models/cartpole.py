"""Cartpole: the smallest end-to-end environment (ECS only, no physics).

Port of ``madrona_tpu/models/cartpole.py``: the classic CartPole-v1
dynamics (Barto, Sutton & Anderson 1983, as Gym implements them) in ECS
systems: Euler steps of tau = 0.02 s, a force of +-10 N, termination at
|x| > 2.4 or |theta| > 12 degrees, episodes capped at 500 steps; a reset
draws the state uniformly from [-0.05, 0.05)^4 from the Threefry stream
of that (world, step).

One fixed-rows "Cart" row a world holds the state; Action, Reward, Done
and Reset are the train-interface singletons. The step is a ``custom``
reset, a ``parallel_for`` physics system and a ``custom`` termination.
The step on which a world resets counts as episode step 1 with reward
1, and the state drawn there is held for that step.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..core.registry import ECSRegistry
from ..graph.builder import TaskGraphBuilder
from ..utils import rng as _rng
from .base import EnvBase

GRAVITY = 9.8
MASS_CART = 1.0
MASS_POLE = 0.1
TOTAL_MASS = MASS_CART + MASS_POLE
POLE_HALF_LENGTH = 0.5
POLE_MASS_LENGTH = MASS_POLE * POLE_HALF_LENGTH
FORCE_MAG = 10.0
TAU = 0.02
THETA_LIMIT = 12 * 2 * math.pi / 360
X_LIMIT = 2.4
EPISODE_LEN = 500


class Cartpole(EnvBase):
    name = "cartpole"
    num_agents = 1
    action_shape = ()

    @staticmethod
    def random_actions(rs, steps, num_worlds):
        """[steps, W] int32 (CPU) from a numpy RandomState: the draw
        bench.py makes for an env without its own (two buckets)."""
        return torch.from_numpy(
            rs.randint(0, 2, (steps, num_worlds)).astype("int32"))

    def register_types(self, reg: ECSRegistry):
        reg.register_component("CartState", (4,), torch.float32)
        reg.register_archetype("Cart", ["CartState"], 1, fixed_rows=True)

        reg.register_singleton("Action", (), torch.int32)
        reg.register_singleton("Reward", (), torch.float32)
        reg.register_singleton("Done", (), torch.int32)
        reg.register_singleton("Reset", (), torch.int32)
        reg.register_singleton("EpisodeStep", (), torch.int32)

        reg.import_singleton("Action", "action")
        reg.import_singleton("Reset", "reset")
        reg.export_column("Cart", "CartState", "obs")
        reg.export_singleton("Reward", "reward")
        reg.export_singleton("Done", "done")

    def setup_tasks(self, b: TaskGraphBuilder):
        n_reset = b.custom(_reset_system, name="cartpole_reset")
        n_phys = b.parallel_for(
            _physics_system, "Cart",
            read=["CartState"], write=["CartState"],
            read_singletons=["Action", "Done", "Reset"],
            deps=[n_reset], name="cartpole_physics",
        )
        b.custom(_termination_system, deps=[n_phys], name="cartpole_done")

    def init_worlds(self, sm, state):
        # every world starts "done", so the first step's reset draws the
        # initial state from the RNG stream
        singles = dict(state.singletons)
        singles["Done"] = torch.ones_like(singles["Done"])
        return dataclasses.replace(state, singletons=singles)


def _physics_system(ctx, s):
    """One Euler step of one cart; a world that was just reset holds its
    drawn state this step."""
    x, x_dot, theta, theta_dot = s[0], s[1], s[2], s[3]
    force = torch.where(ctx.singleton("Action") > 0, FORCE_MAG, -FORCE_MAG)
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    temp = (force + POLE_MASS_LENGTH * theta_dot**2 * sin_t) / TOTAL_MASS
    theta_acc = (GRAVITY * sin_t - cos_t * temp) / (
        POLE_HALF_LENGTH * (4.0 / 3.0 - MASS_POLE * cos_t**2 / TOTAL_MASS)
    )
    x_acc = temp - POLE_MASS_LENGTH * theta_acc * cos_t / TOTAL_MASS
    new = torch.stack([
        x + TAU * x_dot,
        x_dot + TAU * x_acc,
        theta + TAU * theta_dot,
        theta_dot + TAU * theta_acc,
    ])
    just_reset = (ctx.singleton("Done") > 0) | (ctx.singleton("Reset") > 0)
    return torch.where(just_reset, s, new)


def _reset_system(sm, state, node_key):
    """Redraw the state of the worlds flagged done or reset: four
    uniforms a world, from split_i(node_key, i) for i in 0..3."""
    need = (state.singletons["Done"] > 0) | (state.singletons["Reset"] > 0)
    fresh = torch.stack([
        _rng.sample_uniform(_rng.split_i(node_key, i)) * 0.1 - 0.05
        for i in range(4)
    ], dim=-1)                                            # [W, 4]
    cart = state.tables["Cart"]
    cur = cart.columns["CartState"]                       # [W, 1, 4]
    cols = dict(cart.columns)
    cols["CartState"] = torch.where(need[:, None, None], fresh[:, None, :],
                                    cur)
    tables = dict(state.tables)
    tables["Cart"] = dataclasses.replace(cart, columns=cols)
    singles = dict(state.singletons)
    singles["EpisodeStep"] = torch.where(
        need, 0, state.singletons["EpisodeStep"])
    return dataclasses.replace(state, tables=tables, singletons=singles)


def _termination_system(sm, state, node_key):
    s = state.tables["Cart"].columns["CartState"][:, 0, :]  # [W, 4]
    x, theta = s[:, 0], s[:, 2]
    ep = state.singletons["EpisodeStep"] + 1
    out_of_bounds = (torch.abs(x) > X_LIMIT) | (torch.abs(theta) > THETA_LIMIT)
    done = out_of_bounds | (ep >= EPISODE_LEN)
    singles = dict(state.singletons)
    singles["EpisodeStep"] = ep
    singles["Done"] = done.to(torch.int32)
    # Gym: reward 1 on every step, the terminating one included
    singles["Reward"] = torch.ones_like(state.singletons["Reward"])
    return dataclasses.replace(state, singletons=singles)
