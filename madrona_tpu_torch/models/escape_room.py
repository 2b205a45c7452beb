"""Escape Room: the flagship physics environment.

Port of ``madrona_tpu/models/escape_room.py``: a 3-room hallway per
world; two agents press floor buttons (standing on them or dragging
cubes onto them) to open each room's door. Full XPBD physics, grab by
fixed joints, egocentric observations, a 30-ray lidar per agent,
200-step episodes with the level regenerated from the per-(world, step)
Threefry stream on reset.

The step is the same taskgraph: er_reset -> er_actions -> er_doors ->
physics_step -> er_post. Its physics configuration is fixed here, the
one the JAX env runs on an accelerator, under the port's tier names:

  JAX package                     port
  broadphase="pallas"             broadphase="kernel"
  narrowphase="pallas_mega"       narrowphase="kernel_mega"
  megakernel=True                 megakernel=True
  (lidar_pallas.lidar_obb)        ops.lidar_cuda.lidar_obb

The config names the kernel tiers on every device and the tensor's
device picks the route inside each wrapper: on CUDA the broadphase, the
contacts, the substep solver and the lidar launch their hand-written
kernels or raise; on a CPU tensor the wrappers run the plain versions.
The config passes through the port's tuned table and the MADRONA_TPU_*
environment overrides (utils/config.py), as the JAX env's does.

Axis convention: z up, +y is hallway depth ("forward"), x is width.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.registry import ECSRegistry
from ..graph.builder import TaskGraphBuilder
from ..ops.lidar_cuda import lidar_obb
from ..physics import api as papi
from ..physics import bodies, geo
from ..physics import broadphase as bp
from ..physics import joints as jt
from ..physics.xpbd import PhysicsConfig
from ..utils import math3d as m3
from ..utils import rng as _rng
from ..utils.config import apply_tuned, env_override
from .base import EnvBase

# ----------------------------------------------------------------- layout

N_ROOMS = 3
CUBES_PER_ROOM = 2
BUTTONS_PER_ROOM = 2
N_AGENTS = 2
N_CUBES = N_ROOMS * CUBES_PER_ROOM
N_BUTTONS = N_ROOMS * BUTTONS_PER_ROOM

ROOM_LEN = 20.0
WORLD_WIDTH = 18.0
HALL_LEN = N_ROOMS * ROOM_LEN          # 60
DOOR_GAP = 3.0                          # door opening width
WALL_HEIGHT = 2.0
BUTTON_RADIUS = 1.6

# body-table row map (fixed layout)
ROW_FLOOR = 0
ROW_LWALL = 1
ROW_RWALL = 2
ROW_BWALL = 3
ROW_SEP0 = 4                            # per room i: A, B, door
ROW_CUBE0 = ROW_SEP0 + 3 * N_ROOMS      # 13
ROW_AGENT0 = ROW_CUBE0 + N_CUBES        # 19
N_BODIES = ROW_AGENT0 + N_AGENTS        # 21

EPISODE_LEN = 200
DT = 0.04
SUBSTEPS = 4

MOVE_FORCE = 70.0                       # N at move_amount == 3
TURN_SPEED = 2.5                        # rad/s at |rotate - 2| == 2
GRAB_RANGE = 2.5                        # max distance hand -> cube center
MAX_SPEED = 9.0                         # agent linear speed clamp

AGENT_HALF = (0.4, 0.4, 0.8)
CUBE_HALF = 0.55
AGENT_Z = AGENT_HALF[2]
CUBE_Z = CUBE_HALF

PROGRESS_REWARD = 0.05                  # per unit of new max-y progress
STEP_PENALTY = 0.005
LIDAR_RAYS = 30                         # 30-sample lidar ring per agent
LIDAR_T_MAX = HALL_LEN * 2.0

RIGID_BODY = papi.RIGID_BODY
N_DRAWS = 3 + 2 * N_BUTTONS + 2 * N_CUBES   # uniforms per reset


def _make_objects():
    reg = bodies.ObjectRegistry()
    ids = {}
    ids["plane"] = reg.add_plane(mu_s=1.0, mu_d=0.8)
    ids["wall"] = reg.add_box(
        [1.0, 1.0, 1.0], mass=0.0, response=bodies.RESPONSE_STATIC,
        mu_s=0.6, mu_d=0.6,
    )
    ids["cube"] = reg.add_box([CUBE_HALF] * 3, mass=1.0, mu_s=0.8, mu_d=0.6)
    # agent: yaw-only inertia so contacts can never tip it
    he = np.asarray(AGENT_HALF, np.float32)
    ex, ey, ez = (2 * he).tolist()
    izz = 1.0 * (ex * ex + ey * ey) / 12.0
    ids["agent"] = reg.add_hull(
        geo.box_hull(he), mass=1.0, mu_s=0.4, mu_d=0.3,
        inertia_diag=np.array([np.inf, np.inf, izz], np.float32),
    )
    return reg.build(), ids


class EscapeRoom(EnvBase):
    name = "escape_room"
    num_agents = N_AGENTS
    action_is_discrete = True
    # per-agent action: (move_amount 0-3, move_angle 0-7, rotate 0-4, grab 0-1)
    action_shape = (N_AGENTS, 4)
    action_buckets = (4, 8, 5, 2)

    def __init__(self):
        self.om, self.obj = _make_objects()
        # precedence: the values below < the port's tuned table <
        # MADRONA_TPU_* environment variables (utils/config.py)
        self.cfg = env_override(apply_tuned(PhysicsConfig(
            dt=DT, substeps=SUBSTEPS, gravity=(0.0, 0.0, -9.8),
            jacobi_iters=1,             # one position pass per substep
            narrowphase_once=True,      # contacts once per step
            narrowphase="kernel_mega",  # contacts on the CUDA kernel
            megakernel=True,            # all substeps in the solver kernel
            broadphase="kernel",        # all-pairs on the CUDA kernel
            # rows 0..12 (floor, walls, separators, doors) are always
            # static; contact lanes >= 8 are the hull-plane segment, whose
            # ref row is the static floor
            solver_dynamic_range=(ROW_CUBE0, N_BODIES),
            solver_ref_dyn_lanes=8,
        ), self.name))
        # measured occupancy: at most 3 hull-hull and 8 hull-plane
        # candidates; no sphere prims, so no sphere lane
        self.caps = bp.CandidateCaps(hull_hull=8, hull_plane=8, sphere_any=0)
        self._consts = {}

    @staticmethod
    def random_actions(rs, steps, num_worlds):
        """[steps, W, A, 4] int32 (CPU) drawn from a numpy RandomState."""
        cols = [
            rs.randint(0, hi, (steps, num_worlds, N_AGENTS))
            for hi in EscapeRoom.action_buckets
        ]
        return torch.from_numpy(np.stack(cols, axis=-1).astype(np.int32))

    def _const(self, device):
        """Per-device constant tensors of the fixed level layout."""
        if device not in self._consts:
            o = self.obj
            obj_id = ([o["plane"]] + [o["wall"]] * (3 + 3 * N_ROOMS)
                      + [o["cube"]] * N_CUBES + [o["agent"]] * N_AGENTS)
            response = ([bodies.RESPONSE_STATIC] * (4 + 3 * N_ROOMS)
                        + [bodies.RESPONSE_DYNAMIC] * (N_CUBES + N_AGENTS))
            half = ([1.0] * (ROW_CUBE0 - 1) + [CUBE_HALF] * N_CUBES
                    + [1.0] * N_AGENTS)
            self_mask = ~(
                np.arange(1, N_BODIES)[None, :]
                == (ROW_AGENT0 + np.arange(N_AGENTS))[:, None]
            )                                             # [A, N-1]
            i32 = dict(dtype=torch.int32, device=device)
            f32 = dict(dtype=torch.float32, device=device)
            self._consts[device] = dict(
                obj_id=torch.tensor(obj_id, **i32),
                response=torch.tensor(response, **i32),
                lidar_half=torch.tensor(half, **f32),
                agent_half=torch.tensor(AGENT_HALF, **f32),
                self_mask=torch.from_numpy(self_mask).to(device),
                ray_ang=torch.arange(LIDAR_RAYS, **f32)
                * (2 * math.pi / LIDAR_RAYS),
                door_y=(torch.arange(N_ROOMS, **f32) + 1.0) * ROOM_LEN,
            )
        return self._consts[device]

    # ------------------------------------------------------------ registry

    def register_types(self, reg: ECSRegistry):
        papi.register_types(reg, max_bodies=N_BODIES)
        papi.register_joint_types(reg, max_joints=N_AGENTS)
        # every row of the RigidBody table is always live
        sm = reg._sm
        spec = sm.archetypes[RIGID_BODY]
        sm.archetypes[RIGID_BODY] = dataclasses.replace(spec, fixed_rows=True)

        i32, f32 = torch.int32, torch.float32
        reg.register_singleton("Action", (N_AGENTS, 4), i32)
        reg.register_singleton("Reward", (N_AGENTS,), f32)
        reg.register_singleton("Done", (), i32)
        reg.register_singleton("Reset", (), i32)
        reg.register_singleton("EpisodeStep", (), i32)
        reg.register_singleton("Progress", (N_AGENTS,), f32)
        reg.register_singleton("Grabbed", (N_AGENTS,), i32)  # cube row or -1
        reg.register_singleton("ButtonPos", (N_BUTTONS, 2), f32)
        reg.register_singleton("ButtonPressed", (N_BUTTONS,), i32)
        reg.register_singleton("DoorOpen", (N_ROOMS,), i32)
        reg.register_singleton("DoorX", (N_ROOMS,), f32)

        reg.register_singleton("SelfObs", (N_AGENTS, 8), f32)
        reg.register_singleton("PartnerObs", (N_AGENTS, 3), f32)
        reg.register_singleton("EntityObs", (N_AGENTS, N_CUBES + N_BUTTONS, 4),
                               f32)
        reg.register_singleton("DoorObs", (N_AGENTS, N_ROOMS, 4), f32)
        reg.register_singleton("Lidar", (N_AGENTS, LIDAR_RAYS), f32)
        flat_dim = 8 + 3 + (N_CUBES + N_BUTTONS) * 4 + N_ROOMS * 4 + LIDAR_RAYS
        reg.register_singleton("FlatObs", (N_AGENTS, flat_dim), f32)

        reg.import_singleton("Action", "action")
        reg.import_singleton("Reset", "reset")
        reg.export_singleton("FlatObs", "flat_obs")
        reg.export_singleton("SelfObs", "self_obs")
        reg.export_singleton("PartnerObs", "partner_obs")
        reg.export_singleton("EntityObs", "entity_obs")
        reg.export_singleton("DoorObs", "door_obs")
        reg.export_singleton("Lidar", "lidar")
        reg.export_singleton("Reward", "reward")
        reg.export_singleton("Done", "done")
        reg.export_singleton("EpisodeStep", "steps_taken")
        reg.export_singleton("DoorOpen", "door_open")

    # --------------------------------------------------------------- tasks

    def setup_tasks(self, b: TaskGraphBuilder):
        n_reset = b.custom(self._reset_system, name="er_reset")
        n_act = b.custom(self._action_system, deps=[n_reset], name="er_actions")
        n_door = b.custom(self._door_system, deps=[n_act], name="er_doors")
        n_phys = papi.setup_physics_step_tasks(
            b, self.om, self.cfg, self.caps, deps=[n_door]
        )
        b.custom(self._post_system, deps=[n_phys], name="er_post")

    def init_worlds(self, sm, state):
        singles = dict(state.singletons)
        singles["Done"] = torch.ones_like(singles["Done"])  # force a reset
        return dataclasses.replace(state, singletons=singles)

    # ------------------------------------------------------------- systems

    def _reset_system(self, sm, state, node_key):
        """Regenerate done/reset worlds from the RNG stream: door x
        positions, button and cube placements, agents at the start."""
        need = (state.singletons["Done"] > 0) | (state.singletons["Reset"] > 0)
        w = need.shape[0]
        dev = need.device
        cst = self._const(dev)

        # all N_DRAWS uniforms of a world from one Threefry call
        idx = torch.arange(N_DRAWS, dtype=torch.int64, device=dev)
        draws = _rng.sample_uniform(_rng.split_i(node_key[:, None, :], idx))
        di = iter(draws.unbind(dim=1))

        x_lim = WORLD_WIDTH / 2.0
        door_x = torch.stack(
            [next(di) * (WORLD_WIDTH - 2 * DOOR_GAP) - (x_lim - DOOR_GAP)
             for _ in range(N_ROOMS)], dim=-1
        )                                                    # [W, 3]

        def room_xy(room):
            x = next(di) * (WORLD_WIDTH - 5.0) - (x_lim - 2.5)
            y = room * ROOM_LEN + 2.5 + next(di) * (ROOM_LEN - 6.0)
            return torch.stack([x, y], dim=-1)

        button_pos = torch.stack(
            [room_xy(i // BUTTONS_PER_ROOM) for i in range(N_BUTTONS)], dim=1
        )                                                    # [W, 6, 2]
        cube_xy = torch.stack(
            [room_xy(i // CUBES_PER_ROOM) for i in range(N_CUBES)], dim=1
        )                                                    # [W, 6, 2]

        # ---- the fresh body layout [W, 21, ...]; written in place into
        # tensors created here
        f32 = dict(dtype=torch.float32, device=dev)
        pos = torch.zeros((w, N_BODIES, 3), **f32)
        scale = torch.ones((w, N_BODIES, 3), **f32)
        hy = WALL_HEIGHT / 2
        pos[:, ROW_LWALL] = torch.tensor([-(x_lim + 1.0), HALL_LEN / 2, hy],
                                         **f32)
        pos[:, ROW_RWALL] = torch.tensor([x_lim + 1.0, HALL_LEN / 2, hy], **f32)
        wall_side = torch.tensor([1.0, HALL_LEN / 2 + 1.0, hy], **f32)
        scale[:, ROW_LWALL] = wall_side
        scale[:, ROW_RWALL] = wall_side
        pos[:, ROW_BWALL] = torch.tensor([0.0, -1.0, hy], **f32)
        scale[:, ROW_BWALL] = torch.tensor([x_lim, 1.0, hy], **f32)
        for i in range(N_ROOMS):
            y = (i + 1) * ROOM_LEN
            dx = door_x[:, i]
            a_lo, a_hi = -x_lim, dx - DOOR_GAP / 2
            b_lo, b_hi = dx + DOOR_GAP / 2, x_lim
            ra, rb, rd = (ROW_SEP0 + 3 * i, ROW_SEP0 + 3 * i + 1,
                          ROW_SEP0 + 3 * i + 2)
            pos[:, ra, 0] = (a_lo + a_hi) / 2
            scale[:, ra, 0] = (a_hi - a_lo) / 2
            pos[:, rb, 0] = (b_lo + b_hi) / 2
            scale[:, rb, 0] = (b_hi - b_lo) / 2
            pos[:, rd, 0] = dx
            for r in (ra, rb, rd):
                pos[:, r, 1] = y
                pos[:, r, 2] = hy
            scale[:, ra, 1:] = torch.tensor([0.4, hy], **f32)
            scale[:, rb, 1:] = torch.tensor([0.4, hy], **f32)
            scale[:, rd] = torch.tensor([DOOR_GAP / 2 - 0.05, 0.35, hy], **f32)
        pos[:, ROW_CUBE0:ROW_CUBE0 + N_CUBES, :2] = cube_xy
        pos[:, ROW_CUBE0:ROW_CUBE0 + N_CUBES, 2] = CUBE_Z
        for a in range(N_AGENTS):
            pos[:, ROW_AGENT0 + a] = torch.tensor(
                [-2.0 + 4.0 * a, 1.5, AGENT_Z], **f32
            )
        rot = torch.zeros((w, N_BODIES, 4), **f32)
        rot[..., 0] = 1.0                  # agents face +y: identity

        t = state.tables[RIGID_BODY]
        c = dict(t.columns)
        sel3 = need[:, None, None]
        sel2 = need[:, None]

        def pick(new, old):
            return torch.where(sel3 if old.dim() == 3 else sel2, new, old)

        zeros3 = torch.zeros((w, N_BODIES, 3), **f32)
        c["Position"] = pick(pos, c["Position"])
        c["Rotation"] = pick(rot, c["Rotation"])
        c["Scale"] = pick(scale, c["Scale"])
        c["ObjectID"] = pick(cst["obj_id"], c["ObjectID"])
        c["ResponseType"] = pick(cst["response"], c["ResponseType"])
        c["Velocity"] = {
            "linear": pick(zeros3, c["Velocity"]["linear"]),
            "angular": pick(zeros3, c["Velocity"]["angular"]),
        }
        c["ExternalForce"] = pick(zeros3, c["ExternalForce"])
        c["ExternalTorque"] = pick(zeros3, c["ExternalTorque"])
        tables = dict(state.tables)
        tables[RIGID_BODY] = dataclasses.replace(t, columns=c)

        s = state.singletons
        singles = dict(s)
        singles["EpisodeStep"] = torch.where(need, 0, s["EpisodeStep"])
        singles["Progress"] = torch.where(sel2, 1.5, s["Progress"])
        singles["Grabbed"] = torch.where(sel2, -1, s["Grabbed"])
        singles["ButtonPos"] = torch.where(sel3, button_pos, s["ButtonPos"])
        singles["DoorX"] = torch.where(sel2, door_x, s["DoorX"])
        # deactivate the grab joints of reset worlds
        jb = dict(s[papi.JOINT_BUFFER])
        jb["active"] = jb["active"] & ~sel2
        singles[papi.JOINT_BUFFER] = jb
        return dataclasses.replace(state, tables=tables, singletons=singles)

    def _action_system(self, sm, state, node_key):
        """Discrete actions -> external force and yaw rate on the agent
        rows; grab joints activate on grab=1 and release on grab=0."""
        act = state.singletons["Action"]              # [W, A, 4]
        t = state.tables[RIGID_BODY]
        pos = t.columns["Position"]                   # [W, 21, 3]
        rotq = t.columns["Rotation"]
        w = act.shape[0]
        dev = act.device
        a_sl = slice(ROW_AGENT0, ROW_AGENT0 + N_AGENTS)

        a_pos = pos[:, a_sl]                          # [W, A, 3]
        a_rot = rotq[:, a_sl]                         # [W, A, 4]
        yaw = m3.yaw_of_quat(a_rot)                   # [W, A]

        move_amount = act[..., 0].to(torch.float32) / 3.0
        move_angle = act[..., 1].to(torch.float32) * (math.pi / 4.0)
        turn = (act[..., 2].to(torch.float32) - 2.0) / 2.0
        grab = act[..., 3] > 0

        # move_angle is relative to facing; angle 0 = forward (+y local)
        ang = yaw + move_angle
        f = MOVE_FORCE * move_amount
        zero = torch.zeros_like(f)
        ext_f = t.columns["ExternalForce"].clone()
        ext_f[:, a_sl] = torch.stack(
            [-f * torch.sin(ang), f * torch.cos(ang), zero], dim=-1
        )
        # rotation is velocity-controlled: the action sets omega_z
        omega = t.columns["Velocity"]["angular"].clone()
        omega[:, a_sl] = torch.stack([zero, zero, TURN_SPEED * turn], dim=-1)

        # ---- grab handling
        grabbed = state.singletons["Grabbed"]        # [W, A] cube row or -1
        cube_pos = pos[:, ROW_CUBE0:ROW_CUBE0 + N_CUBES]      # [W, 6, 3]
        fwd = torch.stack([-torch.sin(yaw), torch.cos(yaw),
                           torch.zeros_like(yaw)], dim=-1)
        hand = a_pos + fwd * 0.8
        d2 = ((cube_pos[:, None, :, :] - hand[:, :, None, :]) ** 2).sum(-1)
        # a cube already held by anyone is not grabbable
        cube_rows = ROW_CUBE0 + torch.arange(N_CUBES, device=dev)
        held_any = torch.any(
            grabbed[:, :, None] == cube_rows[None, None, :], dim=1
        )                                             # [W, C]
        d2 = torch.where(held_any[:, None, :], math.inf, d2)
        nearest = torch.argmin(d2, dim=-1)            # [W, A]
        near_ok = (torch.gather(d2, -1, nearest[..., None])[..., 0]
                   <= GRAB_RANGE ** 2)

        want_new = grab & (grabbed < 0) & near_ok
        # agent 0 wins ties on the same cube (sequential claim)
        same = (nearest[:, 1] == nearest[:, 0]) & want_new[:, 0]
        want_new = torch.stack([want_new[:, 0], want_new[:, 1] & ~same], 1)
        new_grabbed = torch.where(
            want_new, ROW_CUBE0 + nearest,
            torch.where(grab, grabbed, -1),
        ).to(torch.int32)

        # write the per-agent fixed-joint slots (into fresh copies)
        jb = {k: v.clone() for k, v in state.singletons[papi.JOINT_BUFFER]
              .items()}
        widx = torch.arange(w, device=dev)
        ident = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
        for a in range(N_AGENTS):
            row = new_grabbed[:, a]
            on = row >= 0
            srow = torch.clamp(row, 0, N_BODIES - 1).long()
            q1 = a_rot[:, a]
            q2 = rotq[widx, srow]
            x1 = a_pos[:, a]
            x2 = pos[widx, srow]
            # lock the current relative pose: q1 * aq1 == q2
            aq1 = m3.quat_normalize(m3.quat_mul(m3.quat_inv(q1), q2))
            mid = 0.5 * (x1 + x2)
            r1 = m3.quat_rotate(m3.quat_inv(q1), mid - x1)
            r2 = m3.quat_rotate(m3.quat_inv(q2), mid - x2)
            # keep the previous joint params where the grab persists
            fresh = want_new[:, a, None]
            jb["e1"][:, a] = torch.where(on, ROW_AGENT0 + a, -1)
            jb["e2"][:, a] = torch.where(on, srow, -1)
            jb["jtype"][:, a] = jt.JOINT_FIXED
            jb["r1"][:, a] = torch.where(fresh, r1, jb["r1"][:, a])
            jb["r2"][:, a] = torch.where(fresh, r2, jb["r2"][:, a])
            jb["attach_q1"][:, a] = torch.where(fresh, aq1,
                                                jb["attach_q1"][:, a])
            jb["attach_q2"][:, a] = torch.where(fresh, ident,
                                                jb["attach_q2"][:, a])
            jb["separation"][:, a] = 0.0
            jb["active"][:, a] = on

        singles = dict(state.singletons)
        singles[papi.JOINT_BUFFER] = jb
        singles["Grabbed"] = new_grabbed
        cols = dict(t.columns)
        cols["ExternalForce"] = ext_f
        cols["Velocity"] = {"linear": t.columns["Velocity"]["linear"],
                            "angular": omega}
        tables = dict(state.tables)
        tables[RIGID_BODY] = dataclasses.replace(t, columns=cols)
        return dataclasses.replace(state, tables=tables, singletons=singles)

    def _door_system(self, sm, state, node_key):
        """A button is pressed while an agent or cube stands on it; a
        room's door is open iff all its buttons are pressed. Open doors
        are teleported below the floor."""
        t = state.tables[RIGID_BODY]
        pos = t.columns["Position"]
        bpos = state.singletons["ButtonPos"]          # [W, 6, 2]
        w = pos.shape[0]

        press_rows = pos[:, ROW_CUBE0:ROW_AGENT0 + N_AGENTS]  # cubes, agents
        d2 = ((press_rows[:, None, :, :2] - bpos[:, :, None, :]) ** 2).sum(-1)
        low = press_rows[:, None, :, 2] < 1.8
        pressed = torch.any((d2 <= BUTTON_RADIUS ** 2) & low, dim=-1)
        open_ = torch.all(pressed.reshape(w, N_ROOMS, BUTTONS_PER_ROOM), -1)

        door_rows = [ROW_SEP0 + 3 * i + 2 for i in range(N_ROOMS)]
        new_pos = pos.clone()
        new_pos[:, door_rows, 2] = torch.where(open_, -5.0, WALL_HEIGHT / 2)

        cols = dict(t.columns)
        cols["Position"] = new_pos
        tables = dict(state.tables)
        tables[RIGID_BODY] = dataclasses.replace(t, columns=cols)
        singles = dict(state.singletons)
        singles["ButtonPressed"] = pressed.to(torch.int32)
        singles["DoorOpen"] = open_.to(torch.int32)
        return dataclasses.replace(state, tables=tables, singletons=singles)

    def lidar(self, state):
        """Depth [W, A, R] of each agent's 30-ray horizontal ring against
        the walls, doors, cubes and the other agent as oriented boxes
        (open doors sit below the ring)."""
        return lidar_obb(*self.lidar_inputs(state))

    def lidar_inputs(self, state):
        """The lidar's arguments at ``state``: boxes [W, I, 3|4|3],
        self-mask [A, I], origins [W, A, 3], dirs [W, A, R, 3], t_max."""
        t = state.tables[RIGID_BODY]
        pos = t.columns["Position"]
        rotq = t.columns["Rotation"]
        cst = self._const(pos.device)
        a_sl = slice(ROW_AGENT0, ROW_AGENT0 + N_AGENTS)
        yaw = m3.yaw_of_quat(rotq[:, a_sl])
        # lidar targets: rows 1..N-1 (the floor plane is not one); cubes
        # and agents are unit boxes, scaled to their true half extents
        inst_half = t.columns["Scale"][:, 1:] * cst["lidar_half"][None, :, None]
        inst_half = torch.cat(
            [inst_half[:, :-N_AGENTS],
             cst["agent_half"].expand(pos.shape[0], N_AGENTS, 3)], dim=1
        )
        ang = yaw[..., None] + cst["ray_ang"]                 # [W, A, R]
        dirs = torch.stack(
            [-torch.sin(ang), torch.cos(ang), torch.zeros_like(ang)], dim=-1
        )
        return (
            pos[:, 1:].contiguous(), rotq[:, 1:].contiguous(), inst_half,
            cst["self_mask"], pos[:, a_sl].contiguous(), dirs, LIDAR_T_MAX,
        )

    def _post_system(self, sm, state, node_key):
        """Post-physics: clamp agent speed; observations, reward, done."""
        t = state.tables[RIGID_BODY]
        pos = t.columns["Position"]
        rotq = t.columns["Rotation"]
        w = pos.shape[0]
        cst = self._const(pos.device)
        a_sl = slice(ROW_AGENT0, ROW_AGENT0 + N_AGENTS)

        # agent speed clamp (keeps the solver in a friendly regime)
        vel = t.columns["Velocity"]["linear"].clone()
        a_vel = vel[:, a_sl]
        speed = torch.sqrt(a_vel[..., 0] * a_vel[..., 0]
                           + a_vel[..., 1] * a_vel[..., 1])[..., None]
        scale_v = torch.clamp(MAX_SPEED / torch.clamp(speed, min=1e-6),
                              max=1.0)
        a_vel = torch.cat([a_vel[..., :2] * scale_v, a_vel[..., 2:]], dim=-1)
        vel[:, a_sl] = a_vel

        a_pos = pos[:, a_sl]                                  # [W, A, 3]
        yaw = m3.yaw_of_quat(rotq[:, a_sl])

        def egocentric(target_xy):
            """(dist, sin, cos) of targets [W, A, (K,) 2] relative to
            each agent's position and facing."""
            extra = target_xy.dim() - 3
            a_xy = a_pos[..., :2].reshape((w, N_AGENTS) + (1,) * extra + (2,))
            yw = yaw.reshape((w, N_AGENTS) + (1,) * extra)
            rel = target_xy - a_xy
            dist = torch.sqrt(rel[..., 0] * rel[..., 0]
                              + rel[..., 1] * rel[..., 1])
            loc = torch.atan2(-rel[..., 0], rel[..., 1]) - yw
            return dist, torch.sin(loc), torch.cos(loc)

        s = state.singletons
        self_obs = torch.stack([
            a_pos[..., 0] / (WORLD_WIDTH / 2),
            a_pos[..., 1] / HALL_LEN,
            a_pos[..., 2],
            torch.sin(yaw),
            torch.cos(yaw),
            a_vel[..., 0] / MAX_SPEED,
            a_vel[..., 1] / MAX_SPEED,
            (s["Grabbed"] >= 0).to(torch.float32),
        ], dim=-1)

        d, sn, cs = egocentric(torch.flip(a_pos[..., :2], dims=[1]))
        partner_obs = torch.stack([d / HALL_LEN, sn, cs], dim=-1)

        # entity obs: cubes then buttons
        ent_xy = torch.cat(
            [pos[:, ROW_CUBE0:ROW_CUBE0 + N_CUBES, :2], s["ButtonPos"]], dim=1
        )                                                     # [W, 12, 2]
        d, sn, cs = egocentric(
            ent_xy[:, None].expand(w, N_AGENTS, N_CUBES + N_BUTTONS, 2)
        )
        ent_flag = torch.cat([
            torch.zeros((w, N_CUBES), dtype=torch.float32, device=pos.device),
            s["ButtonPressed"].to(torch.float32),
        ], dim=-1)
        entity_obs = torch.stack(
            [d / HALL_LEN, sn, cs, ent_flag[:, None, :].expand(d.shape)], -1
        )

        door_xy = torch.stack(
            [s["DoorX"], cst["door_y"].expand(w, N_ROOMS)], dim=-1
        )
        d, sn, cs = egocentric(door_xy[:, None].expand(w, N_AGENTS, N_ROOMS, 2))
        door_obs = torch.stack([
            d / HALL_LEN, sn, cs,
            s["DoorOpen"].to(torch.float32)[:, None, :].expand(d.shape),
        ], dim=-1)

        lidar = torch.clamp(self.lidar(state) / HALL_LEN, max=1.0)

        # reward: new max-y progress per agent, minus a step penalty
        prev = s["Progress"]
        new_prog = torch.maximum(prev, a_pos[..., 1])
        reward = PROGRESS_REWARD * (new_prog - prev) - STEP_PENALTY
        ep = s["EpisodeStep"] + 1

        cols = dict(t.columns)
        cols["Velocity"] = {"linear": vel,
                            "angular": t.columns["Velocity"]["angular"]}
        tables = dict(state.tables)
        tables[RIGID_BODY] = dataclasses.replace(t, columns=cols)
        singles = dict(s)
        singles["SelfObs"] = self_obs
        singles["PartnerObs"] = partner_obs
        singles["EntityObs"] = entity_obs
        singles["DoorObs"] = door_obs
        singles["Lidar"] = lidar
        # learner-friendly flat view: one [A, D] vector per agent
        singles["FlatObs"] = torch.cat([
            self_obs, partner_obs,
            entity_obs.reshape(w, N_AGENTS, -1),
            door_obs.reshape(w, N_AGENTS, -1),
            lidar,
        ], dim=-1)
        singles["Progress"] = new_prog
        singles["Reward"] = reward
        singles["EpisodeStep"] = ep
        singles["Done"] = (ep >= EPISODE_LEN).to(torch.int32)
        return dataclasses.replace(state, tables=tables, singletons=singles)
