"""Joint constraints (fixed and hinge), solved in the XPBD position pass.

Port of ``madrona_tpu/physics/joints.py`` (reference
``src/physics/xpbd.cpp:552-718``, factories ``src/physics/physics.cpp:
255-307``). Joints live in a fixed-capacity per-world buffer
``[W, J, ...]``, filled with :func:`empty_joints`,
:func:`make_fixed_joint` and :func:`make_hinge_joint`. Two solves share
one per-joint update (:func:`_joint_update`):
:func:`solve_joints_jacobi` solves every slot against a body snapshot
and averages the corrections per body; :func:`solve_joints` (the
Gauss-Seidel oracle) walks the slots in order, each a [W]-wide step.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core.device import resolve_device
from ..utils import math3d as m3
from .xpbd import (
    RESPONSE_STATIC,
    BodyState,
    _apply_positional_update,
    _gather_pair,
    _gather_packed,
    _pure,
    _scatter_avg_packed,
    _scatter_pose,
    const_f32,
    pack_bodies,
)

JOINT_FIXED = 0
JOINT_HINGE = 1

# world axes (up=+z, fwd=+y, right=+x)
_FWD = (0.0, 1.0, 0.0)
_RIGHT = (1.0, 0.0, 0.0)


@dataclasses.dataclass
class Joints:
    """Fixed-capacity per-world joint buffer: [W, J, ...] tensors."""

    e1: torch.Tensor          # [W, J] int32 body row (<0 or >=N: inactive)
    e2: torch.Tensor          # [W, J] int32
    jtype: torch.Tensor       # [W, J] int32 (JOINT_FIXED / JOINT_HINGE)
    r1: torch.Tensor          # [W, J, 3] attach point, body-1 local frame
    r2: torch.Tensor          # [W, J, 3]
    attach_q1: torch.Tensor   # [W, J, 4] fixed-joint data
    attach_q2: torch.Tensor   # [W, J, 4]
    separation: torch.Tensor  # [W, J]
    a1_local: torch.Tensor    # [W, J, 3] hinge axis, body-1 local
    a2_local: torch.Tensor    # [W, J, 3]
    active: torch.Tensor      # [W, J] bool

    @property
    def capacity(self) -> int:
        return self.e1.shape[1]


def empty_joints(num_worlds: int, cap: int, device=None) -> Joints:
    """An all-inactive joint buffer (the app writes joints into its
    slots at init). ``device=None`` means the card."""
    w, j = num_worlds, cap
    device = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    ident = torch.zeros((w, j, 4), **f32)
    ident[..., 0] = 1.0
    return Joints(
        e1=torch.full((w, j), -1, dtype=torch.int32, device=device),
        e2=torch.full((w, j), -1, dtype=torch.int32, device=device),
        jtype=torch.zeros((w, j), dtype=torch.int32, device=device),
        r1=torch.zeros((w, j, 3), **f32), r2=torch.zeros((w, j, 3), **f32),
        attach_q1=ident, attach_q2=ident.clone(),
        separation=torch.zeros((w, j), **f32),
        a1_local=torch.zeros((w, j, 3), **f32),
        a2_local=torch.zeros((w, j, 3), **f32),
        active=torch.zeros((w, j), dtype=torch.bool, device=device),
    )


def make_fixed_joint(joints: Joints, slot: int, e1, e2, attach_q1,
                     attach_q2, r1, r2, separation=0.0,
                     worlds=None) -> Joints:
    """A fixed joint in ``slot`` (makeFixedJoint, physics.cpp:255-279).
    Scalar or per-world arguments broadcast over the worlds; ``worlds``
    ([W] bool) picks the worlds that get it."""
    return _set_slot(
        joints, slot, e1, e2, JOINT_FIXED, worlds=worlds,
        r1=r1, r2=r2, attach_q1=attach_q1, attach_q2=attach_q2,
        separation=separation,
    )


def make_hinge_joint(joints: Joints, slot: int, e1, e2, a1_local,
                     a2_local, r1, r2, worlds=None) -> Joints:
    """A hinge joint in ``slot`` (makeHingeJoint, physics.cpp:281-307;
    the b1/b2 axes are unused by the solver and not stored)."""
    return _set_slot(
        joints, slot, e1, e2, JOINT_HINGE, worlds=worlds,
        r1=r1, r2=r2, a1_local=a1_local, a2_local=a2_local,
    )


def _set_slot(joints, slot, e1, e2, jtype, worlds=None, **fields):
    """A copy of ``joints`` with ``slot`` set in the chosen worlds."""
    w = joints.e1.shape[0]
    dev = joints.e1.device

    def bc(val, like):
        val = torch.as_tensor(val, dtype=like.dtype).to(dev)
        return torch.broadcast_to(val, (w,) + tuple(like.shape[2:]))

    on = (torch.ones((w,), dtype=torch.bool, device=dev) if worlds is None
          else torch.as_tensor(worlds, dtype=torch.bool).to(dev))
    upd = dict(e1=bc(e1, joints.e1), e2=bc(e2, joints.e2),
               jtype=bc(jtype, joints.jtype), active=on)
    for k, v in fields.items():
        upd[k] = bc(v, getattr(joints, k))
    out = {}
    for f in dataclasses.fields(joints):
        cur = getattr(joints, f.name)
        if f.name in upd:
            sel = on.reshape((w,) + (1,) * (cur.dim() - 2))
            cur = cur.clone()
            cur[:, slot] = torch.where(sel, upd[f.name], cur[:, slot])
        out[f.name] = cur
    return Joints(**out)


def _compute_angular_update(q1, q2, inv_i1, inv_i2, n1, n2, theta):
    """computeAngularUpdate (xpbd.cpp:289-312): pure-quat updates."""
    lra1 = inv_i1 * n1
    lra2 = inv_i2 * n2
    w1 = m3.dot(n1, lra1)
    w2 = m3.dot(n2, lra2)
    denom = w1 + w2
    zero = denom == 0.0
    dl = torch.where(zero, 0.0, -theta / torch.where(zero, 1.0, denom))
    half = 0.5 * dl
    upd1 = _pure(m3.quat_rotate(q1, half[..., None] * lra1))
    upd2 = _pure(m3.quat_rotate(q2, half[..., None] * lra2))
    return upd1, upd2


def _apply_angular_update(q1, q2, upd1, upd2):
    q1 = m3.quat_normalize(q1 + m3.quat_mul(upd1, q1))
    q2 = m3.quat_normalize(q2 - m3.quat_mul(upd2, q2))
    return q1, q2


def _rotate_toward(q1, q2, delta_q, inv_i1, inv_i2):
    """Shared tail of the orientation and axis constraints."""
    mag = torch.linalg.vector_norm(delta_q, dim=-1)
    ok = mag > 0.0
    n = delta_q / torch.where(ok, mag, 1.0)[..., None]
    n1 = m3.quat_rotate(m3.quat_inv(q1), n)
    n2 = m3.quat_rotate(m3.quat_inv(q2), n)
    u1, u2 = _compute_angular_update(q1, q2, inv_i1, inv_i2, n1, n2, mag)
    nq1, nq2 = _apply_angular_update(q1, q2, u1, u2)
    okv = ok[..., None]
    return torch.where(okv, nq1, q1), torch.where(okv, nq2, q2)


def _joint_orientation_constraint(q1, q2, aq1, aq2, inv_i1, inv_i2):
    """applyJointOrientationConstraint (xpbd.cpp:551-578)."""
    o1 = m3.quat_normalize(m3.quat_mul(q1, aq1))
    o2 = m3.quat_normalize(m3.quat_mul(q2, aq2))
    diff = m3.quat_mul(o1, m3.quat_inv(o2))
    return _rotate_toward(q1, q2, 2.0 * diff[..., 1:4], inv_i1, inv_i2)


def _joint_axis_constraint(q1, q2, a1_local, a2_local, inv_i1, inv_i2):
    """applyJointAxisConstraint (xpbd.cpp:580-605)."""
    axis1 = m3.quat_rotate(q1, a1_local)
    axis2 = m3.quat_rotate(q2, a2_local)
    return _rotate_toward(q1, q2, m3.cross(axis1, axis2), inv_i1, inv_i2)


def _joint_update(b1, b2, jtype, r1, r2, attach_q1, attach_q2,
                  separation, a1_local, a2_local):
    """handleJointConstraint (xpbd.cpp:607-718) of joints [...] between
    bodies b1 and b2 (solver views): their updated (x1, x2, q1, q2)."""
    x1, x2, q1, q2 = b1["x"], b2["x"], b1["q"], b2["q"]
    inv_m1, inv_m2 = b1["inv_m"], b2["inv_m"]
    inv_i1, inv_i2 = b1["inv_i"], b2["inv_i"]

    fq1, fq2 = _joint_orientation_constraint(
        q1, q2, attach_q1, attach_q2, inv_i1, inv_i2
    )
    delta_r = (m3.quat_rotate(fq2, r2) + x2) - (m3.quat_rotate(fq1, r1) + x1)
    axes_rot = m3.quat_normalize(m3.quat_mul(fq1, attach_q1))
    fwd = const_f32(_FWD, x1.device)
    right = const_f32(_RIGHT, x1.device)
    a1 = m3.quat_rotate(axes_rot, torch.broadcast_to(fwd, axes_rot[..., 1:].shape))
    b1_axis = m3.quat_rotate(
        axes_rot, torch.broadcast_to(right, axes_rot[..., 1:].shape)
    )
    c1 = m3.cross(a1, b1_axis)
    fixed_corr = (
        -(m3.dot(delta_r, a1) - separation)[..., None] * a1
        - m3.dot(delta_r, b1_axis)[..., None] * b1_axis
        - m3.dot(delta_r, c1)[..., None] * c1
    )

    hq1, hq2 = _joint_axis_constraint(q1, q2, a1_local, a2_local,
                                      inv_i1, inv_i2)
    # converging sign (r1w - r2w), as the fixed branch
    hinge_corr = (m3.quat_rotate(hq1, r1) + x1) - (m3.quat_rotate(hq2, r2) + x2)

    is_fixed = (jtype == JOINT_FIXED)[..., None]
    nq1 = torch.where(is_fixed, fq1, hq1)
    nq2 = torch.where(is_fixed, fq2, hq2)
    corr = torch.where(is_fixed, fixed_corr, hinge_corr)

    mag = torch.linalg.vector_norm(corr, dim=-1)
    has_c = mag > 0.0
    n_dir = corr / torch.where(has_c, mag, 1.0)[..., None]
    ux1, ux2, uq1, uq2, _ = _apply_positional_update(
        x1, x2, nq1, nq2, r1, r2, inv_m1, inv_m2, inv_i1, inv_i2,
        n_dir, mag, 0.0,
    )
    sel = has_c[..., None]
    return (torch.where(sel, ux1, x1), torch.where(sel, ux2, x2),
            torch.where(sel, uq1, nq1), torch.where(sel, uq2, nq2))


def _slot_ok(n: int, e1, e2, active):
    return active & (e1 >= 0) & (e1 < n) & (e2 >= 0) & (e2 < n)


def solve_joints(body: BodyState, joints: Joints, om) -> BodyState:
    """Gauss-Seidel joint solve: slot by slot, each a [W]-wide step that
    reads the poses the slots before it wrote (the joint half of
    solvePositions, xpbd.cpp:727-736)."""
    n = body.pos.shape[1]
    for j in range(joints.capacity):
        e1, e2 = joints.e1[:, j], joints.e2[:, j]
        ok = _slot_ok(n, e1, e2, joints.active[:, j])
        x1, x2, q1, q2 = _joint_update(
            *_gather_pair(body, om, e1, e2),
            joints.jtype[:, j], joints.r1[:, j], joints.r2[:, j],
            joints.attach_q1[:, j], joints.attach_q2[:, j],
            joints.separation[:, j], joints.a1_local[:, j],
            joints.a2_local[:, j],
        )
        body = _scatter_pose(body, e1, x1, q1, ok)
        body = _scatter_pose(body, e2, x2, q2, ok)
    return body


def solve_joints_jacobi(body: BodyState, joints: Joints, om,
                        params=None) -> BodyState:
    """Every joint slot at once against a body snapshot, averaged."""
    n = body.pos.shape[1]
    e1, e2 = joints.e1, joints.e2                       # [W, J]
    ok = _slot_ok(n, e1, e2, joints.active)

    packed = pack_bodies(body, om, params)
    b1 = _gather_packed(packed, e1)
    b2 = _gather_packed(packed, e2)
    ux1, ux2, uq1, uq2 = _joint_update(
        b1, b2, joints.jtype, joints.r1, joints.r2, joints.attach_q1,
        joints.attach_q2, joints.separation, joints.a1_local,
        joints.a2_local,
    )

    rows2 = torch.cat([e1, e2], dim=1)
    ok2 = torch.cat([ok, ok], dim=1)
    d1 = torch.cat([ux1 - b1["x"], uq1 - b1["q"]], dim=-1)
    d2 = torch.cat([ux2 - b2["x"], uq2 - b2["q"]], dim=-1)
    mean = _scatter_avg_packed(rows2, torch.cat([d1, d2], dim=1), ok2, n)
    static = (body.response == RESPONSE_STATIC)[..., None]
    pos = torch.where(static, body.pos, body.pos + mean[..., :3])
    rot = torch.where(
        static, body.rot, m3.quat_normalize(body.rot + mean[..., 3:7])
    )
    return dataclasses.replace(body, pos=pos, rot=rot)
