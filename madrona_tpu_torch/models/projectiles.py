"""Projectiles: entity churn in a stepped environment.

Port of ``madrona_tpu/models/projectiles.py``. Each step every world's
emitter may spawn a projectile (a Threefry Bernoulli draw) with a random
velocity; projectiles fly ballistically and are destroyed once they fall
below the ground plane; the live set is sorted by height each step. It
exercises what the fixed-layout envs do not: entities made and destroyed
every step, with handles, at fixed capacity.

The step: spawn (``make_entities``) -> fly (``parallel_for``) -> despawn
(``destroy_entities``) -> sort by height -> count. Exports the live
count and the positions.

``capacity`` (the JAX env's fixed 32 by default) sizes the archetype.
The despawn system masks rows by the table's capacity as it stands, so
an archetype grown by ``Executor.maybe_grow`` steps on.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import archetype as _arch
from ..core.registry import ECSRegistry
from ..graph.builder import TaskGraphBuilder
from ..ops.lifecycle import destroy_entities
from ..utils import rng as _rng
from .base import EnvBase

CAPACITY = 32
SPAWN_PROB = 0.6
GRAVITY = -9.8
DT = 0.05


class Projectiles(EnvBase):
    name = "projectiles"
    num_agents = 1
    action_is_discrete = True
    action_shape = ()

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity

    def register_types(self, reg: ECSRegistry):
        reg.register_component("PPos", (3,))
        reg.register_component("PVel", (3,))
        reg.register_archetype("Projectile", ["PPos", "PVel"],
                               capacity=self.capacity)
        reg.register_singleton("Action", (), torch.int32)
        reg.register_singleton("Reward", (), torch.float32)
        reg.register_singleton("Done", (), torch.int32)
        reg.register_singleton("Reset", (), torch.int32)
        reg.register_singleton("LiveCount", (), torch.int32)
        reg.register_singleton("TotalSpawned", (), torch.int32)
        reg.register_singleton("TotalDestroyed", (), torch.int32)

        reg.import_singleton("Action", "action")
        reg.import_singleton("Reset", "reset")
        reg.export_column("Projectile", "PPos", "positions")
        reg.export_singleton("LiveCount", "live")
        reg.export_singleton("Reward", "reward")
        reg.export_singleton("Done", "done")

    def setup_tasks(self, b: TaskGraphBuilder):
        n_spawn = b.custom(_spawn_system, name="proj_spawn")
        n_fly = b.parallel_for(
            _fly_system, "Projectile",
            read=["PPos", "PVel"], write=["PPos", "PVel"],
            deps=[n_spawn], name="proj_fly",
        )
        n_kill = b.custom(_despawn_system, deps=[n_fly], name="proj_despawn")
        n_sort = b.sort("Projectile", key_fn=lambda cols: -cols["PPos"][..., 2],
                        deps=[n_kill])
        b.custom(_count_system, deps=[n_sort], name="proj_count")


def _spawn_system(sm, state, node_key):
    w = node_key.shape[0]
    u = _rng.sample_uniform(_rng.split_i(node_key, 0))
    vx = _rng.sample_uniform(_rng.split_i(node_key, 1)) * 4 - 2
    vy = _rng.sample_uniform(_rng.split_i(node_key, 2)) * 4 - 2
    vz = _rng.sample_uniform(_rng.split_i(node_key, 3)) * 5 + 5
    spawn = (u < SPAWN_PROB)[:, None]                     # [W, 1]
    vals = {
        "PPos": torch.zeros((w, 1, 3), dtype=torch.float32,
                            device=node_key.device),
        "PVel": torch.stack([vx, vy, vz], dim=-1)[:, None, :],
    }
    state, _ = sm.make_entities(state, "Projectile", vals, spawn)
    singles = dict(state.singletons)
    singles["TotalSpawned"] = (state.singletons["TotalSpawned"]
                               + spawn[:, 0].to(torch.int32))
    return dataclasses.replace(state, singletons=singles)


def _fly_system(ctx, pos, vel):
    g = torch.zeros_like(vel)
    vel = vel + torch.stack([g[0], g[1], g[2] + GRAVITY]) * DT
    pos = pos + vel * DT
    return pos, vel


def _despawn_system(sm, state, node_key):
    t = state.tables["Projectile"]
    below = t.columns["PPos"][..., 2] < 0.0
    kill = below & _arch.row_mask(t, _arch._capacity_of(t))
    ents = torch.stack([t.entity_gen, t.entity_id], dim=-1)
    n_killed = kill.sum(-1, dtype=torch.int32)
    state = destroy_entities(sm, state, "Projectile", ents, kill)
    singles = dict(state.singletons)
    singles["TotalDestroyed"] = singles["TotalDestroyed"] + n_killed
    return dataclasses.replace(state, singletons=singles)


def _count_system(sm, state, node_key):
    singles = dict(state.singletons)
    singles["LiveCount"] = state.tables["Projectile"].num_rows
    singles["Reward"] = singles["LiveCount"].to(torch.float32)
    singles["Done"] = torch.zeros_like(singles["Done"])
    return dataclasses.replace(state, singletons=singles)
