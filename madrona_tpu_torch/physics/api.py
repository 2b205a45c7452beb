"""PhysicsSystem: registration and the physics taskgraph node.

Port of ``madrona_tpu/physics/api.py``, in its branch order.
Broadphase once per step (below), then one of:

  * ``solver="tgs"``: every substep is ``physics/tgs.py``'s TGS-Soft
    substep with the narrowphase run at each substep (on the hull-hull
    record kernel under ``"kernel_sublane"``/``"kernel"``, else plain;
    ``kernel_mega`` and ``megakernel`` do not apply, as in the JAX
    package);
  * ``megakernel_fused=True``: the whole step (predicted-pose
    integrate, every narrowphase lane, every substep) in the fused-step
    kernel (``ops/fused_cuda``);
  * ``narrowphase="kernel_mega"`` (the JAX package's ``"pallas_mega"``):
    predicted poses from ``xpbd.integrate``, the contacts kernel
    (``ops/contacts_cuda``), and every substep in the substep-solver
    kernel (``ops/solver_cuda``) fed by the contacts kernel's buffers;
  * ``narrowphase="xla"``, ``"kernel_sublane"`` or ``"kernel"``: contacts
    from the plain tensor narrowphase, or with the hull-hull lane on the
    hull-hull record kernel (``ops/hh_narrowphase_cuda``; the JAX
    package's ``"pallas_sublane"`` and ``"pallas"``), once per step under
    ``narrowphase_once``, else per substep; then with ``megakernel=True``
    every substep in the substep-solver kernel, else every substep as
    integrate -> position solve -> joints -> set_velocities -> velocity
    solve in tensor ops, Jacobi (``solver="jacobi"``) or the
    Gauss-Seidel oracle (``"gauss_seidel"``, slot by slot).

The broadphase is the all-pairs kernel (``broadphase="kernel"``, and the
JAX package's ``"pallas"`` and ``"all_pairs"``: its candidates equal
the plain all-pairs tier's bit for bit) or the swept tier (``"swept"``,
plain PyTorch, the many-body tier); where the env registers a
``BroadphaseOverflow`` singleton the node keeps the running maximum of
the candidates' overflow flag in it. Where the env registers the
``CollisionEvents`` singleton (:func:`register_collision_events`), the
node fills it each step from the contacts computed once per step.

Each kernel wrapper runs its plain version on a CPU tensor. What the
JAX package refuses with ``ValueError``, this node refuses with the
same words when it is built.
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
from . import tgs as _tgs
from . import xpbd
from ..ops import contacts_cuda, fused_cuda, hh_narrowphase_cuda, solver_cuda
from ..ops.broadphase_cuda import find_candidates_kernel
from .bodies import ObjectManager
from .xpbd import BodyState, Contacts, PhysicsConfig

RIGID_BODY = "RigidBody"
JOINT_BUFFER = "JointBuffer"
COLLISION_EVENTS = "CollisionEvents"   # see register_collision_events

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


def register_collision_events(reg: ECSRegistry, max_events: int = 16):
    """Register the per-world collision-event buffer, filled every step
    from the narrowphase contacts: the active pairs, compacted in
    contact-buffer order. ``a``/``b`` are Entity handles ([K, 2] gen|id;
    -1 for rows not allocated through the entity store), ``row_a``/
    ``row_b`` the body table rows, ``num`` the event count (clamped to
    ``max_events``; ``overflow`` flags the clamp).

    Needs ``PhysicsConfig.narrowphase_once=True`` (contacts once per
    step), a tier that builds the contacts outside a kernel (not
    ``megakernel_fused``, not ``narrowphase="kernel_mega"``) and a
    solver other than ``"tgs"``."""
    k = max_events
    reg.register_singleton(COLLISION_EVENTS, fields={
        "a": ((k, 2), torch.int32), "b": ((k, 2), torch.int32),
        "row_a": ((k,), torch.int32), "row_b": ((k,), torch.int32),
        "num": ((), torch.int32), "overflow": ((), torch.int32),
    })


def _write_collision_events(state: SimState, contacts: Contacts
                            ) -> SimState:
    """Compact the active contact pairs into the CollisionEvents
    singleton, in contact-buffer order: the JAX package's
    ``masked_set_2d`` writes as one scatter each, with no host sync."""
    buf = state.singletons[COLLISION_EVENTS]
    k = buf["row_a"].shape[1]
    w, c = contacts.num.shape
    t = state.tables[RIGID_BODY]
    n_rows = t.columns["Position"].shape[1]
    dev = contacts.num.device

    valid = contacts.num > 0
    vi = valid.to(torch.int32)
    rank = torch.cumsum(vi, dim=1, dtype=torch.int32) - vi     # [W, C]
    total = vi.sum(dim=1, dtype=torch.int32)                    # [W]
    # a kept pair's slot is its rank; the rest go to a spare slot k,
    # dropped after the scatter (a masked index would sync the host)
    slot = torch.where(valid & (rank < k), rank, k).long()
    ref = contacts.ref.clamp(0, n_rows - 1)
    alt = contacts.alt.clamp(0, n_rows - 1)

    def compact(vals):
        """vals [W, C, ...] at their slots in [W, k, ...], -1 in the
        slots no pair fills."""
        out = torch.full((w, k + 1) + vals.shape[2:], -1,
                         dtype=torch.int32, device=dev)
        idx = slot.view((w, c) + (1,) * (vals.dim() - 2)).expand(vals.shape)
        return out.scatter_(1, idx, vals.to(torch.int32))[:, :k].contiguous()

    def handles(rows):
        if t.entity_id.shape[1] == 0:         # a no-entities archetype
            return torch.full((w, c, 2), -1, dtype=torch.int32, device=dev)
        rows_c = rows.long().clamp(0, t.entity_id.shape[1] - 1)
        gen = torch.gather(t.entity_gen, 1, rows_c)
        eid = torch.gather(t.entity_id, 1, rows_c)
        return torch.stack([gen, eid], dim=-1)                  # [W, C, 2]

    singles = dict(state.singletons)
    singles[COLLISION_EVENTS] = {
        "a": compact(handles(ref)), "b": compact(handles(alt)),
        "row_a": compact(ref), "row_b": compact(alt),
        "num": torch.clamp(total, max=k),
        "overflow": (total > k).to(torch.int32),
    }
    return dataclasses.replace(state, singletons=singles)


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
                     cands: bp.Candidates, skip_hh: bool = False,
                     sat_dirs: bool = True) -> Contacts:
    """Contacts of the candidate buffers in the fixed layout
    [hull-hull | hull-plane | sphere] from the plain tensor narrowphase.
    ``skip_hh`` leaves the hull-hull segment without contacts (a kernel
    fills it)."""
    ref, alt, points, num, normal = np_.narrowphase_lanes(
        body.pos, body.rot, body.scale, body.obj_id, om, cands.hh, cands.hp,
        cands.sp, cands.sp_kind, sat_dirs=sat_dirs, skip_hh=skip_hh,
    )
    return Contacts(
        ref=ref, alt=alt, points=points, num=num, normal=normal,
        lambda_n=torch.zeros(num.shape, dtype=torch.float32,
                             device=num.device),
    )


def narrowphase_hh_kernel(body: BodyState, om: ObjectManager,
                          cands: bp.Candidates, sat_dirs: bool = True):
    """The hull-hull lanes on the hull-hull record kernel: the same
    (ref, alt, points, num, normal) as the hull-hull segment of
    :func:`_narrowphase_all` (JAX: ``narrowphase_hh_pallas``)."""
    poses, obj = contacts_cuda.pack_poses(body, body.obj_id)
    rec = hh_narrowphase_cuda.hh_record(cands.hh.contiguous(), poses, obj,
                                        om, sat_dirs)
    return hh_narrowphase_cuda.lanes(rec)


def _narrowphase_mixed_kernel(body: BodyState, om: ObjectManager,
                              cands: bp.Candidates,
                              sat_dirs: bool = True) -> Contacts:
    """Contacts with the hull-hull lane on its kernel and the hull-plane
    and sphere lanes in plain tensor ops."""
    full = _narrowphase_all(body, om, cands, skip_hh=True, sat_dirs=sat_dirs)
    p = cands.hh.shape[1]
    hh = narrowphase_hh_kernel(body, om, cands, sat_dirs)
    seg = lambda x, y: torch.cat([y, x[:, p:]], dim=1)   # noqa: E731
    return dataclasses.replace(
        full, ref=seg(full.ref, hh[0]), alt=seg(full.alt, hh[1]),
        points=seg(full.points, hh[2]), num=seg(full.num, hh[3]),
        normal=seg(full.normal, hh[4]),
    )


def megakernel_fused_step(body: BodyState, cands: bp.Candidates,
                          om: ObjectManager, cfg: PhysicsConfig,
                          jbuf: Optional[_joints.Joints] = None
                          ) -> BodyState:
    """The whole physics step in one call of the fused-step kernel: the
    same as integrate -> narrowphase at the predicted poses -> every
    substep of the substep solver over all rows."""
    args = fused_cuda.pack_fused(body, om)
    jargs = (solver_cuda.pack_joints(jbuf, body.pos.shape[1])
             if jbuf is not None else ())
    out = fused_cuda.fused_step(
        cfg, *args, cands.hh.contiguous(), cands.hp.contiguous(),
        cands.sp.contiguous(), cands.sp_kind.contiguous(), om, *jargs,
    )
    return solver_cuda.unpack_out(body, out)


NARROWPHASES = ("xla", "kernel_mega", "kernel_sublane", "kernel")
BROADPHASES = ("kernel", "swept")
SOLVERS = ("jacobi", "gauss_seidel", "tgs")
SAT_TIERS = ("edge_dirs", "edge_pairs")
BROADPHASE_OVERFLOW = "BroadphaseOverflow"


def _check_supported(sm: StateManager, cfg: PhysicsConfig,
                     om: ObjectManager, caps: bp.CandidateCaps):
    """Refuse at build time what the JAX package's node refuses when it
    traces, with its words, in its branch order. ``PhysicsConfig`` has
    already resolved the JAX package's tier names to the port's."""
    for field, names in (("narrowphase", NARROWPHASES),
                         ("broadphase", BROADPHASES), ("solver", SOLVERS),
                         ("sat_tier", SAT_TIERS)):
        if getattr(cfg, field) not in names:
            raise ValueError(f"{field} must be one of {names} (or the JAX "
                             f"package's name of one), got "
                             f"{getattr(cfg, field)!r}")
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
    events = COLLISION_EVENTS in sm.singletons
    if events and (cfg.megakernel_fused or not cfg.narrowphase_once
                   or cfg.solver == "tgs"):
        raise ValueError(
            "CollisionEvents export requires narrowphase_once=True with a "
            "non-fused tier (solver='jacobi'/'gauss_seidel', "
            "megakernel_fused=False): contacts must be computed once per "
            "step outside the fused kernel"
        )
    if cfg.solver == "tgs":
        return                      # the TGS branch comes first
    jacobi = cfg.solver == "jacobi"
    if cfg.megakernel_fused:
        if not (jacobi and cfg.narrowphase_once):
            raise ValueError(
                "PhysicsConfig.megakernel_fused requires solver='jacobi' "
                "and narrowphase_once=True"
            )
        return
    if cfg.narrowphase == "kernel_mega":
        if not (jacobi and cfg.narrowphase_once and cfg.megakernel):
            raise ValueError(
                "narrowphase='kernel_mega' (the JAX package's "
                "'pallas_mega') requires solver='jacobi', "
                "narrowphase_once=True and megakernel=True"
            )
        if caps.sphere_any != 0:
            raise ValueError(
                "narrowphase='kernel_mega' covers hull-hull and "
                "hull-plane lanes only; set CandidateCaps.sphere_any=0"
            )
        if events:
            raise ValueError(
                "CollisionEvents export needs W-major Contacts; use "
                "narrowphase='kernel_sublane' instead of 'kernel_mega'"
            )
    if cfg.megakernel and not (jacobi and cfg.narrowphase_once):
        raise ValueError(
            "PhysicsConfig.megakernel requires solver='jacobi' and "
            "narrowphase_once=True"
        )


def make_physics_node(sm: StateManager, om: ObjectManager,
                      cfg: PhysicsConfig,
                      caps: Optional[bp.CandidateCaps] = None):
    """The physics step for ``builder.custom``: broadphase, contacts,
    and every substep. ``om`` is built on the CPU; a copy is kept per
    device the node runs on."""
    caps = caps or bp.CandidateCaps()
    _check_supported(sm, cfg, om, caps)
    h = cfg.dt / cfg.substeps
    sat_dirs = cfg.sat_tier == "edge_dirs"
    om_on = {}

    def narrow(body, om_d, cands):
        if cfg.narrowphase == "kernel_sublane":
            return _narrowphase_mixed_kernel(body, om_d, cands, sat_dirs)
        if cfg.narrowphase == "kernel":
            # the lane-major TPU kernel has edge pairs only
            return _narrowphase_mixed_kernel(body, om_d, cands, False)
        return _narrowphase_all(body, om_d, cands, sat_dirs=sat_dirs)

    def megakernel_substeps(body, om_d, cargs, jbuf):
        """Every substep in one call of the substep-solver kernel, on
        contact buffers already in its layout."""
        state, param = solver_cuda.pack_state(body, om_d)
        jargs = (solver_cuda.pack_joints(jbuf, body.pos.shape[1])
                 if jbuf is not None else ())
        out = solver_cuda.substep_solver(cfg, state, param, *cargs, *jargs)
        return solver_cuda.unpack_out(body, out)

    def tgs_step(body, om_d, cands, jbuf):
        tcfg = _tgs.TGSConfig()
        for _ in range(cfg.substeps):
            body = _tgs.substep(body, lambda b: narrow(b, om_d, cands),
                                om_d, h, cfg.gravity, tcfg, jbuf=jbuf)
        # consumed, as in the JAX package (write_back does not store them)
        return dataclasses.replace(
            body, ext_force=torch.zeros_like(body.ext_force),
            ext_torque=torch.zeros_like(body.ext_torque))

    def physics_step(sm_, state: SimState, node_key) -> SimState:
        body = body_state(sm_, state)
        dev = body.pos.device
        if dev not in om_on:
            om_on[dev] = om.to(dev)
        om_d = om_on[dev]
        if cfg.broadphase == "swept":
            cands = bp.find_candidates_swept(body, om_d, caps, cfg.dt,
                                             window=cfg.broadphase_window)
        else:
            cands = find_candidates_kernel(body, om_d, caps, cfg.dt)
        if BROADPHASE_OVERFLOW in sm_.singletons:
            singles = dict(state.singletons)
            singles[BROADPHASE_OVERFLOW] = torch.maximum(
                singles[BROADPHASE_OVERFLOW], cands.overflow.to(torch.int32))
            state = dataclasses.replace(state, singletons=singles)
        jbuf = joints_view(state) if JOINT_BUFFER in sm_.singletons else None

        if cfg.solver == "tgs":
            return write_back(sm_, state, tgs_step(body, om_d, cands, jbuf))

        if cfg.megakernel_fused:
            return write_back(
                sm_, state, megakernel_fused_step(body, cands, om_d, cfg, jbuf)
            )

        if cfg.narrowphase == "kernel_mega":
            # contacts kernel at the predicted poses, feeding the
            # substep-solver kernel its buffers as they stand
            pred = xpbd.integrate(body, om_d, h, cfg.gravity)
            poses, obj = contacts_cuda.pack_poses(pred, body.obj_id)
            cargs = contacts_cuda.contacts(cands.hh, cands.hp, poses, obj,
                                           om_d, sat_dirs)
            return write_back(
                sm_, state, megakernel_substeps(body, om_d, cargs, jbuf)
            )

        frozen = None
        if cfg.narrowphase_once:
            frozen = narrow(xpbd.integrate(body, om_d, h, cfg.gravity), om_d,
                            cands)
            if COLLISION_EVENTS in sm_.singletons:
                state = _write_collision_events(state, frozen)
        if cfg.megakernel:
            cargs = solver_cuda.pack_contacts(frozen)
            return write_back(
                sm_, state, megakernel_substeps(body, om_d, cargs, jbuf)
            )
        jacobi = cfg.solver == "jacobi"
        for _ in range(cfg.substeps):
            body = xpbd.integrate(body, om_d, h, cfg.gravity)
            contacts = frozen if frozen is not None else narrow(
                body, om_d, cands
            )
            if jacobi:
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
            else:
                body, contacts = xpbd.solve_positions(body, contacts, om_d)
                if jbuf is not None:
                    body = _joints.solve_joints(body, jbuf, om_d)
                body = xpbd.set_velocities(body, h)
                body = xpbd.solve_velocities(
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
