"""Batched 3D math on tensors: vectors, quaternions (w, x, y, z), AABBs.

Port of the parts of ``madrona_tpu/utils/math3d.py`` the Escape Room
step reaches. Every function works on the last axis and broadcasts over
the leading ones. Three-term sums are written out left to right, so the
CUDA kernels (compiled without FMA contraction) can repeat them bit for
bit.
"""

from __future__ import annotations

import torch


def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def normalize(v):
    """Unit vector; zero for a zero vector."""
    l2 = dot(v, v)
    inv = torch.where(
        l2 > 0.0, 1.0 / torch.sqrt(torch.clamp(l2, min=1e-30)), 0.0
    )
    return v * inv[..., None]


def quat_mul(a, b):
    """Hamilton product a*b."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_inv(q):
    """Inverse of a unit quaternion (its conjugate)."""
    return torch.cat([q[..., :1], -q[..., 1:4]], dim=-1)


def quat_rotate(q, v):
    """Rotate v by q: v + 2*(w*(u x v) + u x (u x v))."""
    u = q[..., 1:4]
    w = q[..., 0:1]
    uv = cross(u, v)
    uuv = cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


def quat_normalize(q):
    l2 = (q * q).sum(dim=-1, keepdim=True)
    return q / torch.sqrt(torch.clamp(l2, min=1e-30))


def quat_normalize_rcp(q):
    """quat_normalize in the CUDA kernels' rounding: the squares summed
    left to right, then one reciprocal square root multiplied in."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    l2 = w * w + x * x + y * y + z * z
    return q * (1.0 / torch.sqrt(torch.clamp(l2, min=1e-30)))[..., None]


def quat_to_mat3(q):
    """3x3 rotation matrix [..., 3, 3] (row-major)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def aabb_transform(box, pos, rot, scale=None):
    """Transform an AABB (lo, hi) by scale, rotation and translation
    with the center/extent absolute-rotation trick. The 3x3 products are
    written out (no matmul): the broadphase kernel repeats them in the
    same order."""
    pmin, pmax = box
    center = (pmin + pmax) * 0.5
    extent = (pmax - pmin) * 0.5
    if scale is not None:
        center = center * scale
        extent = extent * torch.abs(scale)
    m = quat_to_mat3(rot)
    am = torch.abs(m)
    new_center = (
        m[..., 0] * center[..., 0:1] + m[..., 1] * center[..., 1:2]
        + m[..., 2] * center[..., 2:3] + pos
    )
    new_extent = (
        am[..., 0] * extent[..., 0:1] + am[..., 1] * extent[..., 1:2]
        + am[..., 2] * extent[..., 2:3]
    )
    return new_center - new_extent, new_center + new_extent


def quat_yaw_only(yaw):
    """Quaternion of a pure rotation about +z."""
    half = 0.5 * yaw
    z = torch.zeros_like(yaw)
    return torch.stack([torch.cos(half), z, z, torch.sin(half)], dim=-1)


def yaw_of_quat(q):
    """Heading of a yaw-only quaternion: 2*atan2(z, w)."""
    return 2.0 * torch.atan2(q[..., 3], q[..., 0])
