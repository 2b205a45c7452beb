"""PhysicsSystem: registration and the physics taskgraph node.

Port of ``madrona_tpu/physics/api.py`` on the branches the Escape Room
takes. Broadphase once per step on its kernel wrapper. Then one of:

  * ``narrowphase="kernel_mega"`` (the JAX package's ``"pallas_mega"``):
    predicted poses from ``xpbd.integrate``, the contacts kernel
    (``ops/contacts_cuda``), and every substep in the substep-solver
    kernel (``ops/solver_cuda``) fed by the contacts kernel's buffers;
  * ``narrowphase="xla"`` with ``megakernel=True``: contacts once per
    step from the plain tensor narrowphase, packed for the
    substep-solver kernel;
  * ``narrowphase="xla"`` alone: the plain tensor narrowphase (once per
    step under ``narrowphase_once``, else per substep) and every substep
    as integrate -> Jacobi position solve -> joints -> set_velocities ->
    Jacobi velocity solve in tensor ops.

Each kernel wrapper runs its plain version on a CPU tensor. The fused
step, TGS, the Gauss-Seidel oracle, the hull-hull-only narrowphase
kernels and the collision-event export come with later slices; selecting
them raises ``NotImplementedError``.
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
from ..ops import contacts_cuda, solver_cuda
from ..ops.broadphase_cuda import find_candidates_kernel
from .bodies import ObjectManager
from .xpbd import BodyState, Contacts, PhysicsConfig

RIGID_BODY = "RigidBody"
JOINT_BUFFER = "JointBuffer"
COLLISION_EVENTS = "CollisionEvents"   # the export itself is not ported

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


def write_joints(state: SimState, joints: _joints.Joints) -> SimState:
    singles = dict(state.singletons)
    singles[JOINT_BUFFER] = {
        f.name: getattr(joints, f.name) for f in dataclasses.fields(joints)
    }
    return dataclasses.replace(state, singletons=singles)


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
    [hull-hull | hull-plane] from the plain tensor narrowphase."""
    if cands.sp.shape[1]:
        raise NotImplementedError(
            "sphere narrowphase lanes come with a later slice; set "
            "CandidateCaps.sphere_any=0"
        )
    ref, alt, points, num, normal = np_.narrowphase_lanes(
        body.pos, body.rot, body.scale, body.obj_id, om, cands.hh, cands.hp
    )
    return Contacts(
        ref=ref, alt=alt, points=points, num=num, normal=normal,
        lambda_n=torch.zeros(num.shape, dtype=torch.float32,
                             device=num.device),
    )


def _check_supported(sm: StateManager, cfg: PhysicsConfig,
                     om: ObjectManager, caps: bp.CandidateCaps):
    later = []
    if cfg.narrowphase not in ("xla", "kernel_mega"):
        later.append(f"narrowphase={cfg.narrowphase!r}")
    if cfg.broadphase != "kernel":
        later.append(f"broadphase={cfg.broadphase!r}")
    if later:
        raise NotImplementedError(
            "not ported yet: " + ", ".join(later)
        )
    if cfg.megakernel and not cfg.narrowphase_once:
        raise ValueError(
            "PhysicsConfig.megakernel requires narrowphase_once=True"
        )
    if cfg.narrowphase == "kernel_mega":
        if not (cfg.narrowphase_once and cfg.megakernel):
            raise ValueError(
                "narrowphase='kernel_mega' requires narrowphase_once=True "
                "and megakernel=True"
            )
        if caps.sphere_any != 0:
            raise ValueError(
                "narrowphase='kernel_mega' covers hull-hull and hull-plane "
                "lanes only; set CandidateCaps.sphere_any=0"
            )
        if COLLISION_EVENTS in sm.singletons:
            raise NotImplementedError(
                "the CollisionEvents export needs W-major Contacts, which "
                "narrowphase='kernel_mega' never builds; it is not ported"
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
    _check_supported(sm, cfg, om, caps)
    h = cfg.dt / cfg.substeps
    om_on = {}

    def megakernel_substeps(body, om_d, cargs, jbuf):
        """Every substep in one call of the substep-solver kernel, on
        contact buffers already in its layout."""
        state, param = solver_cuda.pack_state(body, om_d)
        jargs = (solver_cuda.pack_joints(jbuf, body.pos.shape[1])
                 if jbuf is not None else ())
        out = solver_cuda.substep_solver(cfg, state, param, *cargs, *jargs)
        return solver_cuda.unpack_out(body, out)

    def physics_step(sm_, state: SimState, node_key) -> SimState:
        body = body_state(sm_, state)
        dev = body.pos.device
        if dev not in om_on:
            om_on[dev] = om.to(dev)
        om_d = om_on[dev]
        cands = find_candidates_kernel(body, om_d, caps, cfg.dt)
        jbuf = joints_view(state) if JOINT_BUFFER in sm_.singletons else None

        if cfg.narrowphase == "kernel_mega":
            # contacts kernel at the predicted poses, feeding the
            # substep-solver kernel its buffers as they stand
            pred = xpbd.integrate(body, om_d, h, cfg.gravity)
            poses, obj = contacts_cuda.pack_poses(pred, body.obj_id)
            cargs = contacts_cuda.contacts(cands.hh, cands.hp, poses, obj,
                                           om_d)
            return write_back(
                sm_, state, megakernel_substeps(body, om_d, cargs, jbuf)
            )

        frozen = None
        if cfg.narrowphase_once:
            frozen = _narrowphase_all(
                xpbd.integrate(body, om_d, h, cfg.gravity), om_d, cands
            )
        if cfg.megakernel:
            cargs = solver_cuda.pack_contacts(frozen)
            return write_back(
                sm_, state, megakernel_substeps(body, om_d, cargs, jbuf)
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
