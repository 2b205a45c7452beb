"""Hide & Seek: team-based physics env with pixel observations.

Port of ``madrona_tpu/models/hide_seek.py``: hiders and seekers in a
walled arena with movable boxes and climbable ramps, both grabbable and
team-lockable (a lock is owned by the locking team; only that team can
unlock); a prep phase where only hiders act; per-step team rewards
driven by occlusion-aware visibility (a line-of-sight ray plus a ±60°
facing cone); per-agent RGBD camera observations rendered by the batch
raycaster.

Two taskgraphs, as in the JAX package: "step" (hs_reset -> hs_actions
-> physics_step -> hs_post) and, with ``pixels=True``, "render"
(render_views). The default launch is ("step", "render"); a learner
that needs only state observations launches ("step",).

The physics configuration is the one the JAX env runs on an
accelerator, under the port's tier names (see ``models/escape_room``):
contacts and substep-solver kernels, the broadphase kernel, contacts
once per step, one Jacobi pass, candidate caps 7 hull-hull / 9
hull-plane / 0 sphere. Both render tiers go through the raycast kernel
(``ops/raycast_cuda``) at every size the env offers: the dense one with
flat colours, and ``render_tier="blas"`` (the same meshes baked into
mesh BVHs) with per-object materials, a checker-textured floor and one
shadow-casting sun. ``tlas_max_instances`` > 0 adds the per-view cull's
overlap export (``tlas_overlap``). The env's tables are built on the
host and follow the sim's device (``make_sim``'s default: the card).

Actions per agent: (move_amount 0-3, move_angle 0-7, rotate 0-4,
grab 0-1, lock 0-1). Agents 0..NH-1 are hiders, the rest seekers.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.registry import ECSRegistry
from ..graph.builder import TaskGraphBuilder
from ..physics import api as papi
from ..physics import bodies, geo
from ..physics import broadphase as bp
from ..physics import joints as jt
from ..physics.xpbd import PhysicsConfig
from ..render import MeshRegistry, RenderConfig, RenderingSystem
from ..render.raycast import _trace_rays
from ..utils import math3d as m3
from ..utils import rng as _rng
from ..utils.config import apply_tuned, env_override
from .base import EnvBase

N_HIDERS = 2
N_SEEKERS = 2
N_AGENTS = N_HIDERS + N_SEEKERS
N_BOXES = 3
N_RAMPS = 2
N_MOVABLE = N_BOXES + N_RAMPS     # grab/lock targets (boxes then ramps)

ARENA = 20.0            # arena half-width
WALL_H = 3.0
BOX_HALF = 0.9
AGENT_HALF = (0.4, 0.4, 0.8)
AGENT_Z = AGENT_HALF[2]

# body rows
ROW_FLOOR = 0
ROW_WALL0 = 1           # 4 walls
ROW_BOX0 = 5
ROW_RAMP0 = ROW_BOX0 + N_BOXES           # 8
ROW_AGENT0 = ROW_RAMP0 + N_RAMPS         # 10
N_BODIES = ROW_AGENT0 + N_AGENTS         # 14

# ramp wedge: 22 deg slope rising toward -x
RAMP_L, RAMP_W, RAMP_H = 1.2, 1.1, 1.0

EPISODE_LEN = 240
PREP_STEPS = 96
DT = 0.04
SUBSTEPS = 4
MOVE_FORCE = 70.0
TURN_SPEED = 2.5
GRAB_RANGE = 2.5
MAX_SPEED = 9.0
VIS_COS = 0.5           # ±60° seeker facing cone

RIGID_BODY = papi.RIGID_BODY
N_DRAWS = 2 * N_MOVABLE + 2 * N_HIDERS + N_AGENTS   # uniforms per reset
N_OCCLUDERS = 4 + N_MOVABLE                         # walls, boxes, ramps


def _wedge_geo():
    l, w, h = RAMP_L, RAMP_W, RAMP_H
    verts = np.array(
        [
            [-l, -w, 0], [l, -w, 0], [l, w, 0], [-l, w, 0],  # base
            [-l, -w, h], [-l, w, h],                          # top edge
        ],
        np.float32,
    )
    faces = [
        (0, 3, 2, 1),      # bottom (outward -z)
        (0, 1, 4),         # -y side triangle
        (2, 3, 5),         # +y side triangle
        (1, 2, 5, 4),      # slope
        (0, 4, 5, 3),      # back (-x)
    ]
    return verts, faces


def _make_objects():
    reg = bodies.ObjectRegistry()
    ids = {}
    ids["plane"] = reg.add_plane(mu_s=1.0, mu_d=0.8)
    ids["wall"] = reg.add_box(
        [1.0, 1.0, 1.0], mass=0.0, response=bodies.RESPONSE_STATIC
    )
    ids["box"] = reg.add_box([BOX_HALF] * 3, mass=1.2, mu_s=0.8, mu_d=0.6)
    rverts, rfaces = _wedge_geo()
    ids["ramp"] = reg.add_hull(
        geo.build_hull(rverts, rfaces), mass=1.5, mu_s=0.7, mu_d=0.5,
    )
    # agent: yaw-only inertia so contacts can never tip it
    he = np.asarray(AGENT_HALF, np.float32)
    izz = ((2 * he[0]) ** 2 + (2 * he[1]) ** 2) / 12.0
    ids["agent"] = reg.add_hull(
        geo.box_hull(he), mass=1.0, mu_s=0.4, mu_d=0.3,
        inertia_diag=np.array([np.inf, np.inf, izz], np.float32),
    )
    return reg.build(), ids


def _make_meshes():
    """Hide & Seek's render objects; the material slots 1..6 line up with
    ``_make_materials`` (the floor takes the checker texture). Both
    render tiers bake from this registry."""
    reg = MeshRegistry()
    ids = {}
    ids["plane"] = reg.add_quad(
        ARENA * 2, color=(0.45, 0.45, 0.45), uv_tiles=8.0, material=1
    )
    ids["wall"] = reg.add_box([1.0, 1.0, 1.0], color=(0.6, 0.6, 0.2),
                              material=2)
    ids["box"] = reg.add_box([BOX_HALF] * 3, color=(0.55, 0.3, 0.1),
                             material=3)
    rverts, rfaces = _wedge_geo()
    tris = []
    for fc in rfaces:
        for k in range(1, len(fc) - 1):
            tris.append((fc[0], fc[k], fc[k + 1]))
    ids["ramp"] = reg.add_mesh(rverts, tris, color=(0.7, 0.55, 0.2),
                               material=4)
    ids["hider"] = reg.add_box(AGENT_HALF, color=(0.1, 0.4, 0.9),
                               material=5)
    ids["seeker"] = reg.add_box(AGENT_HALF, color=(0.9, 0.15, 0.1),
                                material=6)
    return reg, ids


def _make_materials(tex_size: int = 32, device=None):
    """Per-object materials and a checkerboard floor texture for the BLAS
    render tier (the reference's per-leaf material path), on ``device``
    (default: the card)."""
    from ..assets.importer import ImportedMaterial, ImportedTexture
    from ..render.materials import bake_materials

    n = tex_size
    yy, xx = np.mgrid[0:n, 0:n]
    check = (((yy // (n // 4)) + (xx // (n // 4))) % 2).astype(np.uint8)
    img = np.empty((n, n, 4), np.uint8)
    img[..., :3] = np.where(check[..., None] > 0, 200, 90)
    img[..., 3] = 255
    mats = [
        ImportedMaterial("floor", (1.0, 1.0, 1.0, 1.0),
                         roughness=0.9, texture=0),
        ImportedMaterial("wall", (0.6, 0.6, 0.2, 1.0), roughness=0.8),
        ImportedMaterial("box", (0.55, 0.3, 0.1, 1.0), roughness=0.7),
        ImportedMaterial("ramp", (0.7, 0.55, 0.2, 1.0), roughness=0.7),
        ImportedMaterial("hider", (0.1, 0.4, 0.9, 1.0), roughness=0.4),
        ImportedMaterial("seeker", (0.9, 0.15, 0.1, 1.0), roughness=0.4),
    ]
    return bake_materials(
        mats, [ImportedTexture("checker", img)], tex_size=tex_size,
        device=device,
    )


class HideSeek(EnvBase):
    name = "hide_seek"
    num_agents = N_AGENTS
    action_is_discrete = True
    action_shape = (N_AGENTS, 5)
    action_buckets = (4, 8, 5, 2, 2)

    def __init__(self, render_size: int = 32, pixels: bool = True,
                 tlas_max_instances: int = 0,
                 render_tier: str = "dense"):
        if render_tier not in ("dense", "blas"):
            raise ValueError(f"unknown render_tier {render_tier!r}")
        self.render_tier = render_tier
        self.om, self.obj = _make_objects()
        mesh_reg, self.mobj = _make_meshes()
        self.mesh = mesh_reg.build()
        self.pixels = pixels
        # precedence: the values below < the port's tuned table (keyed by
        # the base env name for every render variant) < MADRONA_TPU_*
        # environment variables (utils/config.py)
        self.cfg = env_override(apply_tuned(PhysicsConfig(
            dt=DT, substeps=SUBSTEPS, narrowphase_once=True,
            jacobi_iters=1,             # one position pass per substep
            narrowphase="kernel_mega",  # contacts on the CUDA kernel
            megakernel=True,            # all substeps in the solver kernel
            broadphase="kernel",        # all-pairs on the CUDA kernel
            # rows 0-4 (floor + walls) are always static; only boxes,
            # ramps and agents move (a locked box turns static at run
            # time, inside the range)
            solver_dynamic_range=(ROW_BOX0, N_BODIES),
            # contact lanes >= 7 are the hull-plane segment, whose ref
            # row is the static floor
            solver_ref_dyn_lanes=7,
        ), self.name))
        # hull-plane cap 9 = the dynamic-body count (3 boxes + 2 ramps +
        # 4 agents): every dynamic near the floor is a candidate. No
        # sphere prims, so no sphere lane.
        self.caps = bp.CandidateCaps(hull_hull=7, hull_plane=9, sphere_any=0)
        self.rcfg = RenderConfig(
            width=render_size, height=render_size, fov_deg=90.0,
            t_max=4 * ARENA, dtype="bfloat16",
            shadows=(render_tier == "blas"),
        )
        render_obj = (
            [self.mobj["plane"]] + [self.mobj["wall"]] * 4
            + [self.mobj["box"]] * N_BOXES + [self.mobj["ramp"]] * N_RAMPS
            + [self.mobj["hider"]] * N_HIDERS
            + [self.mobj["seeker"]] * N_SEEKERS
        )
        blas = materials = None
        if render_tier == "blas" and pixels:
            # per-object materials, the checker floor and a shadow-casting
            # sun through the mesh-BVH tier; host tables, moved to the
            # sim's device by the render node
            blas = mesh_reg.build_blas(device="cpu")
            materials = _make_materials(device="cpu")
            self._light_specs = [
                {"direction": (0.3, -0.4, -1.0), "cast_shadow": True},
            ]
        self.rsys = RenderingSystem(
            self.mesh, self.rcfg, RIGID_BODY, render_obj,
            camera_rows=list(range(ROW_AGENT0, ROW_AGENT0 + N_AGENTS)),
            camera_offset=(0.0, 0.3, 0.6),
            # > 0: the per-view top-K cull and its overlap export
            tlas_max_instances=tlas_max_instances,
            blas=blas, materials=materials,
            lights_fn=self._lights_for if blas is not None else None,
        )
        self._lights_cache = {}
        # the line-of-sight query is float32 whatever the render type
        self.los_cfg = dataclasses.replace(self.rcfg, dtype="float32")
        self._consts = {}

    def _lights_for(self, state):
        """The [W, L] light table at the state's world count and device
        (built once for each: the table is static)."""
        from ..render.lights import make_lights

        key = (state.rng.shape[0], state.rng.device)
        if key not in self._lights_cache:
            self._lights_cache[key] = make_lights(key[0], self._light_specs,
                                                  device=key[1])
        return self._lights_cache[key]

    @staticmethod
    def random_actions(rs, steps, num_worlds):
        """[steps, W, A, 5] int32 (CPU) drawn from a numpy RandomState."""
        cols = [
            rs.randint(0, hi, (steps, num_worlds, N_AGENTS))
            for hi in HideSeek.action_buckets
        ]
        return torch.from_numpy(np.stack(cols, axis=-1).astype(np.int32))

    def _const(self, device):
        """Per-device constant tensors of the fixed layout."""
        if device not in self._consts:
            o, mo = self.obj, self.mobj
            obj_id = ([o["plane"]] + [o["wall"]] * 4 + [o["box"]] * N_BOXES
                      + [o["ramp"]] * N_RAMPS + [o["agent"]] * N_AGENTS)
            response = ([bodies.RESPONSE_STATIC] * 5
                        + [bodies.RESPONSE_DYNAMIC] * (N_MOVABLE + N_AGENTS))
            # the fresh layout: walls at x/y = +-ARENA, boxes and agents
            # resting on the floor, seekers in the corner
            pos = np.zeros((N_BODIES, 3), np.float32)
            scale = np.ones((N_BODIES, 3), np.float32)
            wall_cfg = [
                ((-ARENA - 1, 0), (1.0, ARENA + 2)),
                ((ARENA + 1, 0), (1.0, ARENA + 2)),
                ((0, -ARENA - 1), (ARENA + 2, 1.0)),
                ((0, ARENA + 1), (ARENA + 2, 1.0)),
            ]
            for i, ((cx, cy), (sx, sy)) in enumerate(wall_cfg):
                pos[ROW_WALL0 + i] = [cx, cy, WALL_H / 2]
                scale[ROW_WALL0 + i] = [sx, sy, WALL_H / 2]
            pos[ROW_BOX0:ROW_BOX0 + N_BOXES, 2] = BOX_HALF
            pos[ROW_AGENT0:, 2] = AGENT_Z
            for a in range(N_SEEKERS):
                pos[ROW_AGENT0 + N_HIDERS + a, :2] = [
                    -ARENA + 2.0 + 2 * a, -ARENA + 2.0]
            rot = np.zeros((N_BODIES, 4), np.float32)
            rot[:, 0] = 1.0
            i32 = dict(dtype=torch.int32, device=device)
            self._consts[device] = dict(
                obj_id=torch.tensor(obj_id, **i32),
                response=torch.tensor(response, **i32),
                pos=torch.from_numpy(pos).to(device),
                scale=torch.from_numpy(scale).to(device),
                rot=torch.from_numpy(rot).to(device),
                movable_rows=ROW_BOX0 + torch.arange(N_MOVABLE, device=device),
                # occluders of the line-of-sight rays: walls, boxes, ramps
                occ_obj=torch.tensor(
                    [mo["wall"]] * 4 + [mo["box"]] * N_BOXES
                    + [mo["ramp"]] * N_RAMPS, **i32),
                occ_mask=torch.ones(N_OCCLUDERS, dtype=torch.bool,
                                    device=device),
                ident=torch.tensor([1.0, 0.0, 0.0, 0.0], device=device),
                mesh=self.mesh.to(device),
            )
        return self._consts[device]

    # ------------------------------------------------------------ registry

    def register_types(self, reg: ECSRegistry):
        papi.register_types(reg, max_bodies=N_BODIES)
        papi.register_joint_types(reg, max_joints=N_AGENTS)
        sm = reg._sm
        sm.archetypes[RIGID_BODY] = dataclasses.replace(
            sm.archetypes[RIGID_BODY], fixed_rows=True
        )
        i32, f32 = torch.int32, torch.float32
        reg.register_singleton("Action", (N_AGENTS, 5), i32)
        reg.register_singleton("Reward", (N_AGENTS,), f32)
        reg.register_singleton("Done", (), i32)
        reg.register_singleton("Reset", (), i32)
        reg.register_singleton("EpisodeStep", (), i32)
        reg.register_singleton("Grabbed", (N_AGENTS,), i32)
        reg.register_singleton("Locked", (N_MOVABLE,), i32)
        reg.register_singleton("SelfObs", (N_AGENTS, 10), f32)
        reg.register_singleton("Visible", (N_SEEKERS, N_HIDERS), i32)
        # flat per-agent vector: self(10) + rel agents (A*3) + rel
        # movables (M*3) + locked (M) + visibility (S*H)
        flat_dim = (
            10 + N_AGENTS * 3 + N_MOVABLE * 3 + N_MOVABLE
            + N_SEEKERS * N_HIDERS
        )
        reg.register_singleton("FlatObs", (N_AGENTS, flat_dim), f32)

        reg.import_singleton("Action", "action")
        reg.import_singleton("Reset", "reset")
        reg.export_singleton("SelfObs", "self_obs")
        reg.export_singleton("FlatObs", "flat_obs")
        reg.export_singleton("Reward", "reward")
        reg.export_singleton("Done", "done")
        reg.export_singleton("Visible", "visible")
        if self.pixels:
            self.rsys.register_types(reg)

    def setup_tasks(self, b: TaskGraphBuilder):
        n_reset = b.custom(self._reset_system, name="hs_reset")
        n_act = b.custom(self._action_system, deps=[n_reset],
                         name="hs_actions")
        n_phys = papi.setup_physics_step_tasks(
            b, self.om, self.cfg, self.caps, deps=[n_act]
        )
        b.custom(self._post_system, deps=[n_phys], name="hs_post")

    def setup_graphs(self, mgr):
        """Separate "step" (sim) and "render" (raycast) graphs."""
        self.setup_tasks(mgr.init("step"))
        if self.pixels:
            self.rsys.setup_tasks(mgr.init("render"))
            self.default_launch = ("step", "render")

    def init_worlds(self, sm, state):
        singles = dict(state.singletons)
        singles["Done"] = torch.ones_like(singles["Done"])  # force a reset
        return dataclasses.replace(state, singletons=singles)

    # ------------------------------------------------------------- systems

    def _reset_system(self, sm, state, node_key):
        """Regenerate done/reset worlds from the RNG stream: boxes, ramps
        and hiders placed at random, seekers in the corner, random yaws."""
        s = state.singletons
        need = (s["Done"] > 0) | (s["Reset"] > 0)
        w = need.shape[0]
        dev = need.device
        cst = self._const(dev)

        # all N_DRAWS uniforms of a world from one Threefry call: box xy,
        # ramp xy, hider xy, then the agents' yaws
        idx = torch.arange(N_DRAWS, dtype=torch.int64, device=dev)
        draws = _rng.sample_uniform(_rng.split_i(node_key[:, None, :], idx))
        span = ARENA - 3.0
        n_xy = 2 * (N_MOVABLE + N_HIDERS)
        xy = draws[:, :n_xy] * 2 * span - span
        yaw = draws[:, n_xy:] * 2 * math.pi                   # [W, A]

        pos = cst["pos"].expand(w, N_BODIES, 3).clone()
        pos[:, ROW_BOX0:ROW_BOX0 + N_MOVABLE, :2] = (
            xy[:, :2 * N_MOVABLE].reshape(w, N_MOVABLE, 2))
        pos[:, ROW_AGENT0:ROW_AGENT0 + N_HIDERS, :2] = (
            xy[:, 2 * N_MOVABLE:].reshape(w, N_HIDERS, 2))
        rot = cst["rot"].expand(w, N_BODIES, 4).clone()
        rot[:, ROW_AGENT0:] = m3.quat_yaw_only(yaw)

        t = state.tables[RIGID_BODY]
        c = dict(t.columns)
        sel3 = need[:, None, None]
        sel2 = need[:, None]

        def pick(new, old):
            return torch.where(sel3 if old.dim() == 3 else sel2, new, old)

        zeros3 = torch.zeros((w, N_BODIES, 3), dtype=torch.float32,
                             device=dev)
        c["Position"] = pick(pos, c["Position"])
        c["Rotation"] = pick(rot, c["Rotation"])
        c["Scale"] = pick(cst["scale"], c["Scale"])
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

        singles = dict(s)
        singles["EpisodeStep"] = torch.where(need, 0, s["EpisodeStep"])
        singles["Grabbed"] = torch.where(sel2, -1, s["Grabbed"])
        singles["Locked"] = torch.where(sel2, 0, s["Locked"])
        jb = dict(s[papi.JOINT_BUFFER])
        jb["active"] = jb["active"] & ~sel2
        singles[papi.JOINT_BUFFER] = jb
        return dataclasses.replace(state, tables=tables, singletons=singles)

    def _action_system(self, sm, state, node_key):
        """Discrete actions -> external force and yaw rate on the agent
        rows; team-owned lock toggles; grab joints."""
        s = state.singletons
        act = s["Action"]                            # [W, A, 5]
        t = state.tables[RIGID_BODY]
        pos = t.columns["Position"]
        rotq = t.columns["Rotation"]
        w = act.shape[0]
        dev = act.device
        cst = self._const(dev)
        widx = torch.arange(w, device=dev)
        a_sl = slice(ROW_AGENT0, ROW_AGENT0 + N_AGENTS)

        # prep phase: seekers frozen
        in_prep = s["EpisodeStep"] < PREP_STEPS
        agent_on = torch.cat(
            [torch.ones((w, N_HIDERS), dtype=torch.bool, device=dev),
             (~in_prep)[:, None].expand(w, N_SEEKERS)], dim=1,
        )

        a_pos = pos[:, a_sl]
        a_rot = rotq[:, a_sl]
        yaw = m3.yaw_of_quat(a_rot)
        move_amount = act[..., 0].to(torch.float32) / 3.0 * agent_on
        move_angle = act[..., 1].to(torch.float32) * (math.pi / 4.0)
        turn = (act[..., 2].to(torch.float32) - 2.0) / 2.0 * agent_on
        grab = (act[..., 3] > 0) & agent_on
        lock = (act[..., 4] > 0) & agent_on

        ang = yaw + move_angle
        f = MOVE_FORCE * move_amount
        zero = torch.zeros_like(f)
        ext_f = t.columns["ExternalForce"].clone()
        ext_f[:, a_sl] = torch.stack(
            [-f * torch.sin(ang), f * torch.cos(ang), zero], dim=-1
        )
        omega = t.columns["Velocity"]["angular"].clone()
        omega[:, a_sl] = torch.stack([zero, zero, TURN_SPEED * turn], dim=-1)

        # nearest movable (box or ramp) in front: the grab/lock target
        box_pos = pos[:, ROW_BOX0:ROW_BOX0 + N_MOVABLE]
        fwd = torch.stack(
            [-torch.sin(yaw), torch.cos(yaw), torch.zeros_like(yaw)], dim=-1
        )
        hand = a_pos + fwd * 0.8
        d2 = ((box_pos[:, None, :, :] - hand[:, :, None, :]) ** 2).sum(-1)
        nearest = torch.argmin(d2, dim=-1)            # [W, A]
        near_ok = (torch.gather(d2, -1, nearest[..., None])[..., 0]
                   <= GRAB_RANGE ** 2)

        # ---- team-owned lock toggle (one agent per box per step; the
        # lowest agent wins). Locked stores the owning team + 1 (0 =
        # unlocked, 1 = hider-locked, 2 = seeker-locked); only the owning
        # team can unlock.
        locked = s["Locked"]
        want_lock = lock & near_ok
        later = torch.arange(N_AGENTS, device=dev)
        for a in range(N_AGENTS):
            team_code = 1 if a < N_HIDERS else 2
            tgt = nearest[:, a:a + 1]                 # [W, 1]
            do = want_lock[:, a:a + 1]
            cur = torch.gather(locked, 1, tgt)
            new = torch.where(
                cur == 0, team_code,                  # lock for my team
                torch.where(cur == team_code, 0, cur),  # unlock own
            )
            locked = locked.scatter(1, tgt, torch.where(do, new, cur))
            # only the first locker acts on a box this step
            same = want_lock & (nearest == tgt)
            want_lock = want_lock & ~(same & (later > a)[None, :] & do)
        resp = t.columns["ResponseType"].clone()
        resp[:, ROW_BOX0:ROW_BOX0 + N_MOVABLE] = torch.where(
            locked > 0, bodies.RESPONSE_STATIC, bodies.RESPONSE_DYNAMIC
        )

        # ---- grab joints (held or locked boxes are not grabbable)
        grabbed = s["Grabbed"]
        held_any = torch.any(
            grabbed[:, :, None] == cst["movable_rows"][None, None, :], dim=1
        )
        d2m = torch.where(held_any[:, None, :], math.inf, d2)
        nearest_g = torch.argmin(d2m, dim=-1)
        locked_g = torch.gather(locked, 1, nearest_g)
        ok_g = (
            torch.gather(d2m, -1, nearest_g[..., None])[..., 0]
            <= GRAB_RANGE ** 2
        ) & ~(locked_g > 0)
        want_new = grab & (grabbed < 0) & ok_g
        # sequential claim: earlier agents win contested boxes
        for a in range(N_AGENTS):
            same = want_new & (nearest_g == nearest_g[:, a:a + 1])
            want_new = want_new & ~(same & (later > a)[None, :]
                                    & want_new[:, a:a + 1])
        new_grabbed = torch.where(
            want_new, ROW_BOX0 + nearest_g, torch.where(grab, grabbed, -1)
        ).to(torch.int32)

        # write the per-agent fixed-joint slots (into fresh copies)
        jb = {k: v.clone() for k, v in s[papi.JOINT_BUFFER].items()}
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
            jb["attach_q2"][:, a] = torch.where(fresh, cst["ident"],
                                                jb["attach_q2"][:, a])
            jb["active"][:, a] = on
        state = papi.write_joints(state, jt.Joints(**jb))

        cols = dict(t.columns)
        cols["ExternalForce"] = ext_f
        cols["ResponseType"] = resp
        cols["Velocity"] = {"linear": t.columns["Velocity"]["linear"],
                            "angular": omega}
        tables = dict(state.tables)
        tables[RIGID_BODY] = dataclasses.replace(t, columns=cols)
        singles = dict(state.singletons)
        singles["Grabbed"] = new_grabbed
        singles["Locked"] = locked
        return dataclasses.replace(state, tables=tables, singletons=singles)

    def visibility(self, state):
        """(visible [W, S, H] bool, cone margin, line-of-sight margin):
        seeker -> hider facing cone and occlusion ray. A pair is visible
        where both margins are positive (cone: cos - VIS_COS; line of
        sight: nearest occluder depth - (distance - 0.5))."""
        t = state.tables[RIGID_BODY]
        pos = t.columns["Position"]
        rotq = t.columns["Rotation"]
        w = pos.shape[0]
        cst = self._const(pos.device)
        a_sl = slice(ROW_AGENT0, ROW_AGENT0 + N_AGENTS)
        a_pos = pos[:, a_sl]
        yaw = m3.yaw_of_quat(rotq[:, a_sl])

        seeker_pos = a_pos[:, N_HIDERS:]
        seeker_yaw = yaw[:, N_HIDERS:]
        hider_pos = a_pos[:, :N_HIDERS]
        to_h = hider_pos[:, None, :, :] - seeker_pos[:, :, None, :]
        dist = torch.sqrt(m3.dot(to_h, to_h))                  # [W, S, H]
        dir_ = to_h / torch.clamp(dist, min=1e-6)[..., None]
        fwd = torch.stack(
            [-torch.sin(seeker_yaw), torch.cos(seeker_yaw),
             torch.zeros_like(seeker_yaw)], dim=-1,
        )
        cone = m3.dot(dir_, fwd[:, :, None, :]) - VIS_COS

        # occlusion rays against walls, boxes and ramps (not the floor or
        # the agents), through the dense tracer in float32
        occ = slice(ROW_WALL0, ROW_RAMP0 + N_RAMPS)
        _, depth = _trace_rays(
            self.los_cfg, cst["mesh"], pos[:, occ], rotq[:, occ],
            t.columns["Scale"][:, occ], cst["occ_obj"], cst["occ_mask"],
            seeker_pos[:, :, None, :].expand(to_h.shape).reshape(w, -1, 3),
            dir_.reshape(w, -1, 3),
        )
        # clear: nothing closer than the hider
        los = depth.reshape(w, N_SEEKERS, N_HIDERS) - (dist - 0.5)
        return (cone > 0) & (los > 0), cone, los

    def _post_system(self, sm, state, node_key):
        """Post-physics: clamp agent speed; visibility, rewards,
        observations, done."""
        s = state.singletons
        t = state.tables[RIGID_BODY]
        pos = t.columns["Position"]
        rotq = t.columns["Rotation"]
        w = pos.shape[0]
        a_sl = slice(ROW_AGENT0, ROW_AGENT0 + N_AGENTS)

        vel = t.columns["Velocity"]["linear"].clone()
        a_vel = vel[:, a_sl]
        speed = torch.sqrt(a_vel[..., 0] * a_vel[..., 0]
                           + a_vel[..., 1] * a_vel[..., 1])[..., None]
        scale_v = torch.clamp(MAX_SPEED / torch.clamp(speed, min=1e-6),
                              max=1.0)
        a_vel = torch.cat([a_vel[..., :2] * scale_v, a_vel[..., 2:]], dim=-1)
        vel[:, a_sl] = a_vel

        a_pos = pos[:, a_sl]
        yaw = m3.yaw_of_quat(rotq[:, a_sl])
        visible, _, _ = self.visibility(state)                # [W, S, H]

        in_prep = s["EpisodeStep"] < PREP_STEPS
        any_seen = torch.any(visible.reshape(w, -1), dim=1)
        hider_r = torch.where(any_seen, -1.0, 1.0)
        reward = torch.cat(
            [hider_r[:, None].expand(w, N_HIDERS),
             (-hider_r)[:, None].expand(w, N_SEEKERS)], dim=1,
        )
        reward = torch.where(in_prep[:, None], 0.0, reward)

        self_obs = torch.cat(
            [
                a_pos / ARENA,
                torch.sin(yaw)[..., None], torch.cos(yaw)[..., None],
                a_vel / MAX_SPEED,
                (s["Grabbed"] >= 0).to(torch.float32)[..., None],
                in_prep.to(torch.float32)[:, None, None].expand(
                    w, N_AGENTS, 1),
            ],
            dim=-1,
        )

        ep = s["EpisodeStep"] + 1
        cols = dict(t.columns)
        cols["Velocity"] = {"linear": vel,
                            "angular": t.columns["Velocity"]["angular"]}
        tables = dict(state.tables)
        tables[RIGID_BODY] = dataclasses.replace(t, columns=cols)
        singles = dict(s)
        singles["SelfObs"] = self_obs
        singles["Visible"] = visible.to(torch.int32)
        # flat per-agent learner vector
        mov_pos = pos[:, ROW_BOX0:ROW_BOX0 + N_MOVABLE]       # [W, M, 3]
        rel_agents = (
            a_pos[:, None, :, :] - a_pos[:, :, None, :]
        ).reshape(w, N_AGENTS, -1) / ARENA
        rel_mov = (
            mov_pos[:, None, :, :] - a_pos[:, :, None, :]
        ).reshape(w, N_AGENTS, -1) / ARENA
        locked_b = s["Locked"].to(torch.float32)[:, None, :].expand(
            w, N_AGENTS, N_MOVABLE)
        vis_b = visible.to(torch.float32).reshape(w, 1, -1).expand(
            w, N_AGENTS, N_SEEKERS * N_HIDERS)
        singles["FlatObs"] = torch.cat(
            [self_obs, rel_agents, rel_mov, locked_b, vis_b], dim=-1
        )
        singles["Reward"] = reward
        singles["EpisodeStep"] = ep
        singles["Done"] = (ep >= EPISODE_LEN).to(torch.int32)
        return dataclasses.replace(state, tables=tables, singletons=singles)
