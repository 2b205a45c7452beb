"""PhysicsSystem: registration and the physics taskgraph node.

Port of ``madrona_tpu/physics/api.py`` on the branch the Escape Room
takes: broadphase once per step (plain or on its CUDA kernel), contacts
once per step at the first substep's predicted poses
(``narrowphase_once``) from the plain tensor narrowphase, then every
substep as integrate -> Jacobi position solve -> joints ->
set_velocities -> Jacobi velocity solve.

The contacts and substep-solver kernels (``narrowphase="pallas_mega"``,
``megakernel=True``), the fused step, TGS, the Gauss-Seidel oracle and
the collision-event export come with later slices; selecting them
raises ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import archetype as _arch
from ..core.registry import ECSRegistry
from ..core.state import SimState, StateManager
from ..graph.builder import TaskGraphBuilder, TaskGraphID
from . import broadphase as bp
from . import geo
from . import joints as _joints
from . import narrowphase as np_
from . import xpbd
from ..ops.broadphase_cuda import find_candidates_kernel
from .bodies import ObjectManager
from .xpbd import BodyState, Contacts, PhysicsConfig, gather_rows

RIGID_BODY = "RigidBody"
JOINT_BUFFER = "JointBuffer"

_F32 = ((3,), torch.float32)


def register_types(reg: ECSRegistry, max_bodies: int):
    """Register the RigidBody archetype and its solver components."""
    reg.register_component("Position", (3,))
    reg.register_component("Rotation", (4,))
    reg.register_component("Scale", (3,))
    reg.register_component("Velocity", fields={"linear": _F32,
                                               "angular": _F32})
    reg.register_component("ObjectID", (), torch.int32)
    reg.register_component("ResponseType", (), torch.int32)
    reg.register_component("ExternalForce", (3,))
    reg.register_component("ExternalTorque", (3,))
    reg.register_component("SubstepPrev", fields={
        "x": _F32, "q": ((4,), torch.float32),
    })
    reg.register_component("PreSolvePositional", fields={
        "x": _F32, "q": ((4,), torch.float32),
    })
    reg.register_component("PreSolveVelocity", fields={
        "v": _F32, "omega": _F32,
    })
    reg.register_archetype(
        RIGID_BODY,
        [
            "Position", "Rotation", "Scale", "ObjectID", "ResponseType",
            "Velocity", "ExternalForce", "ExternalTorque",
            "SubstepPrev", "PreSolvePositional", "PreSolveVelocity",
        ],
        capacity=max_bodies,
    )


def register_joint_types(reg: ECSRegistry, max_joints: int):
    """Register the per-world joint buffer (``max_joints`` slots)."""
    j = max_joints
    reg.register_singleton(JOINT_BUFFER, fields={
        "e1": ((j,), torch.int32), "e2": ((j,), torch.int32),
        "jtype": ((j,), torch.int32),
        "r1": ((j, 3), torch.float32), "r2": ((j, 3), torch.float32),
        "attach_q1": ((j, 4), torch.float32),
        "attach_q2": ((j, 4), torch.float32),
        "separation": ((j,), torch.float32),
        "a1_local": ((j, 3), torch.float32),
        "a2_local": ((j, 3), torch.float32),
        "active": ((j,), torch.bool),
    })


def joints_view(state: SimState) -> _joints.Joints:
    return _joints.Joints(**state.singletons[JOINT_BUFFER])


def body_state(sm: StateManager, state: SimState) -> BodyState:
    """View the RigidBody table as a solver BodyState (no copy)."""
    t = state.tables[RIGID_BODY]
    c = t.columns
    return BodyState(
        pos=c["Position"], rot=c["Rotation"], scale=c["Scale"],
        vel=c["Velocity"]["linear"], omega=c["Velocity"]["angular"],
        obj_id=c["ObjectID"], response=c["ResponseType"],
        ext_force=c["ExternalForce"], ext_torque=c["ExternalTorque"],
        prev_x=c["SubstepPrev"]["x"], prev_q=c["SubstepPrev"]["q"],
        presolve_x=c["PreSolvePositional"]["x"],
        presolve_q=c["PreSolvePositional"]["q"],
        presolve_v=c["PreSolveVelocity"]["v"],
        presolve_w=c["PreSolveVelocity"]["omega"],
        active=_arch.row_mask(t, sm.archetypes[RIGID_BODY].capacity),
    )


def write_back(sm: StateManager, state: SimState, body: BodyState
               ) -> SimState:
    """Store the solver's pose, velocity and scratch columns. The
    external force and torque columns are left as the env wrote them."""
    t = state.tables[RIGID_BODY]
    cols = dict(t.columns)
    cols["Position"] = body.pos
    cols["Rotation"] = body.rot
    cols["Velocity"] = {"linear": body.vel, "angular": body.omega}
    cols["SubstepPrev"] = {"x": body.prev_x, "q": body.prev_q}
    cols["PreSolvePositional"] = {"x": body.presolve_x, "q": body.presolve_q}
    cols["PreSolveVelocity"] = {"v": body.presolve_v,
                                "omega": body.presolve_w}
    tables = dict(state.tables)
    tables[RIGID_BODY] = dataclasses.replace(t, columns=cols)
    return dataclasses.replace(state, tables=tables)


def _narrowphase_all(body: BodyState, om: ObjectManager,
                     cands: bp.Candidates) -> Contacts:
    """Contacts of the candidate buffers in the fixed layout
    [hull-hull | hull-plane] (one lane per candidate slot, all worlds
    flattened into the batch axis). Sentinel rows read row N-1 and are
    masked out by ``pair[0] < n``."""
    if cands.sp.shape[1]:
        raise NotImplementedError(
            "sphere narrowphase lanes come with a later slice; set "
            "CandidateCaps.sphere_any=0"
        )
    w, n = body.pos.shape[:2]
    dims = om.hull_dims
    nb = torch.cat([body.pos, body.rot, body.scale], dim=-1)   # [W, N, 10]

    def lanes(pairs, side):
        """Per-lane (pos, rot, scale, object id) of one pair side."""
        rows = pairs[..., side]
        blk = gather_rows(nb, rows).reshape(-1, 10)
        oid = gather_rows(body.obj_id, rows).reshape(-1).long()
        return blk[:, 0:3], blk[:, 3:7], blk[:, 7:10], oid

    def hull(lane, need_edges=True, dirs=False):
        p, q, s, oid = lane
        return np_.hull_row_to_world(
            om.hull_pack[oid], dims, p, q, s, need_edges=need_edges,
            dirs_row=om.hull_dirs_pack[oid] if dirs else None,
            n_dirs=om.n_edge_dirs if dirs else 0,
        )

    def emit(c, first, second, pairs):
        """(ref, alt, points, num, normal) in [W, P, ...] layout."""
        p = pairs.shape[1]
        ok = c["valid"] & (pairs[..., 0].reshape(-1) < n)
        sent = torch.full_like(first, n)
        pts = torch.cat([c["points"], c["depths"][..., None]], dim=-1)
        return (
            torch.where(ok, first, sent).reshape(w, p).to(torch.int32),
            torch.where(ok, second, sent).reshape(w, p).to(torch.int32),
            pts.reshape(w, p, 4, 4),
            torch.where(ok, c["num"], 0).reshape(w, p).to(torch.int32),
            c["normal"].reshape(w, p, 3),
        )

    hh_pairs = cands.hh
    a = hull(lanes(hh_pairs, 0), dirs=True)
    b = hull(lanes(hh_pairs, 1), dirs=True)
    c = np_.hull_hull_contact(a, b)
    pa = hh_pairs[..., 0].reshape(-1).long()
    pb = hh_pairs[..., 1].reshape(-1).long()
    hh = emit(c, torch.where(c["ref_is_a"], pa, pb),
              torch.where(c["ref_is_a"], pb, pa), hh_pairs)

    hp_pairs = cands.hp
    h = hull(lanes(hp_pairs, 0), need_edges=False)
    pp, qp, _, _ = lanes(hp_pairs, 1)
    c = np_.hull_plane_contact(h, pp, qp)
    # the plane (second row) is the reference
    hp = emit(c, hp_pairs[..., 1].reshape(-1).long(),
              hp_pairs[..., 0].reshape(-1).long(), hp_pairs)

    ref, alt, points, num, normal = (
        torch.cat([x, y], dim=1) for x, y in zip(hh, hp)
    )
    return Contacts(
        ref=ref, alt=alt, points=points, num=num, normal=normal,
        lambda_n=torch.zeros(num.shape, dtype=torch.float32,
                             device=num.device),
    )


def _check_supported(cfg: PhysicsConfig, om: ObjectManager,
                     caps: bp.CandidateCaps):
    later = []
    if cfg.narrowphase != "xla":
        later.append(f"narrowphase={cfg.narrowphase!r}")
    if cfg.megakernel:
        later.append("megakernel=True")
    if cfg.broadphase != "kernel":
        later.append(f"broadphase={cfg.broadphase!r}")
    if later:
        raise NotImplementedError(
            "not ported yet: " + ", ".join(later)
        )
    if cfg.solver_ref_dyn_lanes:
        # an env-layout contract (every contact lane >= K has a static
        # ref row): validate the parts visible at setup
        if cfg.solver_ref_dyn_lanes != caps.hull_hull:
            raise ValueError(
                f"solver_ref_dyn_lanes={cfg.solver_ref_dyn_lanes} must "
                f"equal CandidateCaps.hull_hull={caps.hull_hull}"
            )
        if caps.sphere_any != 0:
            raise ValueError("solver_ref_dyn_lanes requires sphere_any=0")
        movable = ((om.prim_type.numpy() == geo.TYPE_PLANE)
                   & (om.inv_mass.numpy() != 0.0))
        if movable.any():
            raise ValueError(
                "solver_ref_dyn_lanes requires every plane object to be "
                f"immovable; movable: {np.nonzero(movable)[0].tolist()}"
            )


def make_physics_node(sm: StateManager, om: ObjectManager,
                      cfg: PhysicsConfig,
                      caps: Optional[bp.CandidateCaps] = None):
    """The physics step for ``builder.custom``: broadphase, contacts,
    and every XPBD substep. ``om`` is built on the CPU; a copy is kept
    per device the node runs on."""
    caps = caps or bp.CandidateCaps()
    _check_supported(cfg, om, caps)
    h = cfg.dt / cfg.substeps
    om_on = {}

    def physics_step(sm_, state: SimState, node_key) -> SimState:
        body = body_state(sm_, state)
        dev = body.pos.device
        if dev not in om_on:
            om_on[dev] = om.to(dev)
        om_d = om_on[dev]
        cands = find_candidates_kernel(body, om_d, caps, cfg.dt)
        jbuf = joints_view(state) if JOINT_BUFFER in sm_.singletons else None

        frozen = None
        if cfg.narrowphase_once:
            frozen = _narrowphase_all(
                xpbd.integrate(body, om_d, h, cfg.gravity), om_d, cands
            )
        for _ in range(cfg.substeps):
            body = xpbd.integrate(body, om_d, h, cfg.gravity)
            contacts = frozen if frozen is not None else _narrowphase_all(
                body, om_d, cands
            )
            body, contacts = xpbd.solve_positions_jacobi(
                body, contacts, om_d, cfg.jacobi_iters
            )
            if jbuf is not None:
                body = _joints.solve_joints_jacobi(body, jbuf, om_d)
            body = xpbd.set_velocities(body, h)
            body = xpbd.solve_velocities_jacobi(
                body, contacts, om_d, h,
                cfg.restitution, cfg.restitution_threshold,
            )
        return write_back(sm_, state, body)

    return physics_step


def setup_physics_step_tasks(builder: TaskGraphBuilder, om: ObjectManager,
                             cfg: PhysicsConfig,
                             caps: Optional[bp.CandidateCaps] = None,
                             deps=()) -> TaskGraphID:
    return builder.custom(
        make_physics_node(builder.sm, om, cfg, caps), deps=deps,
        name="physics_step",
    )
