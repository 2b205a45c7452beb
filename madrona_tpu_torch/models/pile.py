"""Pile: the many-body stress environment (256 bodies a world).

Port of ``madrona_tpu/models/pile.py``. A static floor plane and 4 walls
enclose ``num_bodies`` dynamic bodies (boxes of two sizes and spheres)
spawned in a lattice above the floor with per-world random jitter and
yaw; they fall and settle into a pile. The physics runs the many-body
tier: the swept broadphase (``physics/broadphase.py::
find_candidates_swept``) and the narrowphase at every substep, Jacobi
solver. No hand-written kernel runs on this path (the JAX package runs
it in XLA); every tensor op is plain PyTorch on the card.

Action per world: 0 = none, 1-4 = a lateral shake (a velocity change of
every dynamic body along +x, -x, +y, -y). Reward: the fraction of
dynamic bodies at rest (speed below ``REST_SPEED``) minus 0.05 for a
shake. An episode ends after ``episode_len`` steps.

Exports: ``summary`` [W, 6] (mean height, max height, mean speed, rest
fraction, episode step, the broadphase-overflow flag), ``reward``,
``done``; with ``body_obs=True`` also ``body_obs`` [W, num_bodies, 6]
(position and velocity of each dynamic body).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.registry import ECSRegistry
from ..graph.builder import TaskGraphBuilder
from ..physics import api as papi
from ..physics import bodies, broadphase as bp
from ..physics.api import RIGID_BODY
from ..physics.xpbd import PhysicsConfig
from ..utils import rng as _rng
from ..utils.config import apply_tuned, env_override
from .base import EnvBase

DT = 1.0 / 30.0
SUBSTEPS = 4
ARENA = 12.0          # half-extent of the container
WALL_H = 6.0
REST_SPEED = 0.25
SHAKE_IMPULSE = 1.5   # m/s velocity change of a shake action

N_STATIC = 5          # floor + 4 walls

# (centre x, y), (half extent x, y) of the four walls
WALLS = (
    ((-ARENA - 1, 0.0), (1.0, ARENA + 2)),
    ((ARENA + 1, 0.0), (1.0, ARENA + 2)),
    ((0.0, -ARENA - 1), (ARENA + 2, 1.0)),
    ((0.0, ARENA + 1), (ARENA + 2, 1.0)),
)
SHAKE_DIRS = ((0.0, 0.0), (1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0))


def _make_objects():
    reg = bodies.ObjectRegistry()
    ids = {}
    ids["plane"] = reg.add_plane(mu_s=0.9, mu_d=0.7)
    ids["wall"] = reg.add_box(
        [1.0, 1.0, 1.0], mass=0.0, response=bodies.RESPONSE_STATIC
    )
    ids["box_s"] = reg.add_box([0.35] * 3, mass=0.8, mu_s=0.7, mu_d=0.5)
    ids["box_l"] = reg.add_box([0.55] * 3, mass=1.6, mu_s=0.7, mu_d=0.5)
    ids["sphere"] = reg.add_sphere(0.4, mass=1.0, mu_s=0.5, mu_d=0.4)
    return reg.build(), ids


class Pile(EnvBase):
    name = "pile"
    num_agents = 1
    action_is_discrete = True
    action_shape = ()
    action_buckets = (5,)

    def __init__(self, num_bodies: int = 256, episode_len: int = 100,
                 body_obs: bool = False, broadphase_window: int = 80,
                 caps: bp.CandidateCaps | None = None):
        self.num_bodies = num_bodies
        self.n_total = N_STATIC + num_bodies
        self.episode_len = episode_len
        self.body_obs = body_obs
        self.om, self.obj = _make_objects()
        # Through the tuned table and the MADRONA_TPU_* environment
        # overrides (utils/config.py), as the JAX env's config. The
        # narrowphase runs every substep: contacts frozen for a step let
        # a dense pile fall through.
        self.cfg = env_override(apply_tuned(PhysicsConfig(
            dt=DT, substeps=SUBSTEPS,
            solver="jacobi", narrowphase_once=False,
            broadphase="swept", broadphase_window=broadphase_window,
            sat_tier="edge_dirs",
        ), self.name))
        # candidate budget of the JAX env: hull-hull 2n, hull-plane n+8,
        # sphere 3n; summary[5] reports a saturated list or window
        self.caps = caps or bp.CandidateCaps(
            hull_hull=2 * num_bodies,
            hull_plane=num_bodies + 8,
            sphere_any=3 * num_bodies,
        )
        side = int(np.ceil(num_bodies ** (1.0 / 3.0)))
        self._lattice_side = side
        self._obj_row = np.asarray(
            [self.obj["plane"]] + [self.obj["wall"]] * 4
            + [(self.obj["box_s"], self.obj["box_l"],
                self.obj["sphere"])[i % 3] for i in range(num_bodies)],
            np.int32,
        )
        self._resp_row = np.asarray(
            [bodies.RESPONSE_STATIC] * N_STATIC
            + [bodies.RESPONSE_DYNAMIC] * num_bodies,
            np.int32,
        )
        self._consts = {}

    @staticmethod
    def random_actions(rs, steps, num_worlds):
        """[steps, W] int32 (CPU) drawn from a numpy RandomState."""
        return torch.from_numpy(
            rs.randint(0, 5, (steps, num_worlds)).astype(np.int32))

    def _const(self, device):
        """Per-device constants: the lattice, the static rows' poses, the
        object and response rows and the shake directions."""
        if device not in self._consts:
            nb, side = self.num_bodies, self._lattice_side
            slot = np.arange(nb)
            gx, gy = slot % side, (slot // side) % side
            gz = slot // (side * side)
            # slot centres: density below packing, so no deep overlap
            pitch = min(1.6, (2 * ARENA - 3.0) / side)
            base = -0.5 * (side - 1) * pitch
            pos = np.zeros((self.n_total, 3), np.float32)
            scale = np.ones((self.n_total, 3), np.float32)
            for i, ((cx, cy), (sx, sy)) in enumerate(WALLS):
                pos[1 + i] = (cx, cy, WALL_H / 2)
                scale[1 + i] = (sx, sy, WALL_H / 2)
            f32 = dict(dtype=torch.float32, device=device)
            i32 = dict(dtype=torch.int32, device=device)
            lattice = [(base + g * pitch).astype(np.float32) for g in (gx, gy)]
            self._consts[device] = dict(
                pitch=pitch,
                lx=torch.tensor(lattice[0], **f32),
                ly=torch.tensor(lattice[1], **f32),
                lz=torch.tensor((2.0 + gz * pitch).astype(np.float32), **f32),
                pos=torch.tensor(pos, **f32),
                scale=torch.tensor(scale, **f32),
                obj=torch.tensor(self._obj_row, **i32),
                resp=torch.tensor(self._resp_row, **i32),
                bidx=torch.arange(nb, dtype=torch.int64, device=device),
                shake=torch.tensor(SHAKE_DIRS, **f32) * SHAKE_IMPULSE,
            )
        return self._consts[device]

    # ------------------------------------------------------------ registry

    def register_types(self, reg: ECSRegistry):
        papi.register_types(reg, max_bodies=self.n_total)
        sm = reg._sm
        sm.archetypes[RIGID_BODY] = dataclasses.replace(
            sm.archetypes[RIGID_BODY], fixed_rows=True
        )
        reg.register_singleton("Action", (), torch.int32)
        reg.register_singleton("Reward", (), torch.float32)
        reg.register_singleton("Done", (), torch.int32)
        reg.register_singleton("Reset", (), torch.int32)
        reg.register_singleton("EpisodeStep", (), torch.int32)
        reg.register_singleton("Summary", (6,), torch.float32)
        reg.register_singleton(papi.BROADPHASE_OVERFLOW, (), torch.int32)
        if self.body_obs:
            reg.register_singleton("BodyObs", (self.num_bodies, 6),
                                   torch.float32)
            reg.export_singleton("BodyObs", "body_obs")
        reg.import_singleton("Action", "action")
        reg.import_singleton("Reset", "reset")
        reg.export_singleton("Summary", "summary")
        reg.export_singleton("Reward", "reward")
        reg.export_singleton("Done", "done")

    def setup_tasks(self, b: TaskGraphBuilder):
        n_reset = b.custom(self._reset_system, name="pile_reset")
        n_act = b.custom(self._action_system, deps=[n_reset],
                         name="pile_actions")
        n_phys = papi.setup_physics_step_tasks(
            b, self.om, self.cfg, self.caps, deps=[n_act]
        )
        b.custom(self._post_system, deps=[n_phys], name="pile_post")

    def init_worlds(self, sm, state):
        singles = dict(state.singletons)
        singles["Done"] = torch.ones_like(singles["Done"])
        return dataclasses.replace(state, singletons=singles)

    # ------------------------------------------------------------- systems

    def _reset_system(self, sm, state, node_key):
        s = state.singletons
        need = (s["Done"] > 0) | (s["Reset"] > 0)
        w = need.shape[0]
        c = self._const(need.device)
        pitch = c["pitch"]

        def body_draws(i):
            # per (world, body): split_i(split_i(node_key, i), body)
            kw = _rng.split_i(node_key, i)
            return _rng.sample_uniform(
                _rng.split_i(kw[:, None, :], c["bidx"][None, :]))

        jx = (body_draws(1) - 0.5) * 0.6 * pitch
        jy = (body_draws(2) - 0.5) * 0.6 * pitch
        yaw = body_draws(3) * (2 * np.pi)

        nb = self.num_bodies
        dyn_pos = torch.stack(
            [c["lx"][None] + jx, c["ly"][None] + jy,
             c["lz"][None].expand(w, nb)], dim=-1)
        pos = torch.cat([c["pos"][None, :N_STATIC].expand(w, -1, -1),
                         dyn_pos], dim=1)
        zero = torch.zeros_like(yaw)
        half = torch.stack([torch.cos(yaw / 2), zero, zero,
                            torch.sin(yaw / 2)], dim=-1)
        ident = torch.zeros((w, N_STATIC, 4), dtype=torch.float32,
                            device=need.device)
        ident[..., 0] = 1.0
        rot = torch.cat([ident, half], dim=1)

        t = state.tables[RIGID_BODY]
        cols = dict(t.columns)

        def pick(new, old):
            sel = need.reshape((w,) + (1,) * (old.dim() - 1))
            return torch.where(sel, new.to(old.dtype), old)

        zeros3 = torch.zeros_like(cols["Position"])
        cols["Position"] = pick(pos, cols["Position"])
        cols["Rotation"] = pick(rot, cols["Rotation"])
        cols["Scale"] = pick(c["scale"][None], cols["Scale"])
        cols["ObjectID"] = pick(c["obj"][None], cols["ObjectID"])
        cols["ResponseType"] = pick(c["resp"][None], cols["ResponseType"])
        cols["Velocity"] = {
            "linear": pick(zeros3, cols["Velocity"]["linear"]),
            "angular": pick(zeros3, cols["Velocity"]["angular"]),
        }
        cols["ExternalForce"] = pick(zeros3, cols["ExternalForce"])
        cols["ExternalTorque"] = pick(zeros3, cols["ExternalTorque"])
        tables = dict(state.tables)
        tables[RIGID_BODY] = dataclasses.replace(t, columns=cols)

        singles = dict(s)
        singles["EpisodeStep"] = torch.where(
            need, 0, s["EpisodeStep"]).to(torch.int32)
        singles[papi.BROADPHASE_OVERFLOW] = torch.where(
            need, 0, s[papi.BROADPHASE_OVERFLOW]).to(torch.int32)
        return dataclasses.replace(state, tables=tables, singletons=singles)

    def _action_system(self, sm, state, node_key):
        act = state.singletons["Action"]                      # [W]
        c = self._const(act.device)
        dv2 = c["shake"][torch.clamp(act, 0, 4).long()]       # [W, 2]
        dv = torch.cat([dv2, torch.zeros_like(dv2[:, :1])], dim=-1)[:, None]
        t = state.tables[RIGID_BODY]
        cols = dict(t.columns)
        vel = cols["Velocity"]["linear"]
        dyn = (cols["ResponseType"] == bodies.RESPONSE_DYNAMIC)[..., None]
        cols["Velocity"] = {
            "linear": torch.where(dyn, vel + dv, vel),
            "angular": cols["Velocity"]["angular"],
        }
        tables = dict(state.tables)
        tables[RIGID_BODY] = dataclasses.replace(t, columns=cols)
        return dataclasses.replace(state, tables=tables)

    def _post_system(self, sm, state, node_key):
        s = dict(state.singletons)
        t = state.tables[RIGID_BODY]
        pos = t.columns["Position"]
        vel = t.columns["Velocity"]["linear"]
        omega = t.columns["Velocity"]["angular"]
        dyn = t.columns["ResponseType"] == bodies.RESPONSE_DYNAMIC

        def norm(v):
            return torch.sqrt((v * v).sum(-1))

        speed = norm(vel) + norm(omega)
        at_rest = dyn & (speed < REST_SPEED)
        n_dyn = torch.clamp(dyn.sum(1, dtype=torch.int32), min=1)
        rest_frac = at_rest.sum(1, dtype=torch.int32) / n_dyn
        mean_h = torch.where(dyn, pos[..., 2], 0.0).sum(1) / n_dyn
        max_h = torch.where(dyn, pos[..., 2], -math.inf).amax(1)
        mean_sp = torch.where(dyn, speed, 0.0).sum(1) / n_dyn

        ep = s["EpisodeStep"] + 1
        shake_pen = (s["Action"] > 0).to(torch.float32) * 0.05
        # the sticky window-saturation flag written by the physics node
        overflow = s[papi.BROADPHASE_OVERFLOW].to(torch.float32)
        s["Summary"] = torch.stack(
            [mean_h, max_h, mean_sp, rest_frac, ep.to(torch.float32),
             overflow], dim=-1)
        if self.body_obs:
            s["BodyObs"] = torch.cat([pos[:, N_STATIC:], vel[:, N_STATIC:]],
                                     dim=-1)
        s["Reward"] = rest_frac - shake_pen
        s["Done"] = (ep >= self.episode_len).to(torch.int32)
        s["EpisodeStep"] = ep
        return dataclasses.replace(state, singletons=s)
