"""Batched 3D math on tensors: vectors, quaternions (w, x, y, z), AABBs.

Port of ``madrona_tpu/utils/math3d.py``. Every function works on the
last axis and broadcasts over the leading ones. Three-term sums are
written out left to right, so the CUDA kernels (compiled without FMA
contraction) can repeat them bit for bit. An AABB is a pair
``(pmin, pmax)`` of ``[..., 3]`` tensors.
"""

from __future__ import annotations

import functools

import torch


def dot(a, b):
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


@functools.lru_cache(maxsize=None)
def _cycle(device, shift: int) -> torch.Tensor:
    """The index of the components (y, z, x) (shift 1) or (z, x, y)
    (shift 2) on ``device``, built once."""
    return torch.tensor([(i + shift) % 3 for i in range(3)], device=device)


def cross(a, b):
    """a x b: component i is a[i+1] * b[i+2] - a[i+2] * b[i+1] (indices
    mod 3), each product and the difference rounded once, as written
    out component by component."""
    yzx, zxy = _cycle(a.device, 1), _cycle(a.device, 2)
    return (a.index_select(-1, yzx) * b.index_select(-1, zxy)
            - a.index_select(-1, zxy) * b.index_select(-1, yzx))


def length2(v):
    return dot(v, v)


def length(v):
    return torch.sqrt(length2(v))


def normalize(v):
    """Unit vector; zero for a zero vector."""
    l2 = dot(v, v)
    inv = torch.where(
        l2 > 0.0, 1.0 / torch.sqrt(torch.clamp(l2, min=1e-30)), 0.0
    )
    return v * inv[..., None]


def safe_normalize(v, fallback=None):
    """Unit vector where |v|^2 > 1e-12, else ``fallback`` (zeros)."""
    l2 = length2(v)
    good = l2 > 1e-12
    out = v * (1.0 / torch.sqrt(torch.where(good, l2, 1.0)))[..., None]
    if fallback is None:
        fallback = torch.zeros_like(v)
    return torch.where(good[..., None], out, fallback)


def vec(x, y, z, dtype=torch.float32, device=None):
    return torch.tensor([x, y, z], dtype=dtype, device=device)


def quat_identity(shape=(), dtype=torch.float32, device=None):
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat(w, x, y, z, dtype=torch.float32, device=None):
    return torch.tensor([w, x, y, z], dtype=dtype, device=device)


# quat_mul's terms: for each component of a, the components of b it
# multiplies, in [b | -b] (index 4 + i is -b[i]), one per component of
# the product
_QMUL = ((0, 1, 2, 3), (5, 0, 7, 2), (6, 3, 0, 5), (7, 6, 1, 0))


@functools.lru_cache(maxsize=None)
def _qmul_index(device):
    return tuple(torch.tensor(i, device=device) for i in _QMUL)


@functools.lru_cache(maxsize=None)
def _conj_sign(device, dtype):
    return torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=dtype, device=device)


def quat_mul(a, b):
    """Hamilton product a*b, each component's four products added left
    to right as written out:
        w = aw*bw - ax*bx - ay*by - az*bz
        x = aw*bx + ax*bw + ay*bz - az*by
        y = aw*by - ax*bz + ay*bw + az*bx
        z = aw*bz + ax*by - ay*bx + az*bw
    (a term subtracted is its negation added: the same rounding)."""
    signed = torch.cat([b, -b], dim=-1)
    idx = _qmul_index(b.device)
    out = a[..., 0:1] * signed.index_select(-1, idx[0])
    for i in (1, 2, 3):
        out = out + a[..., i:i + 1] * signed.index_select(-1, idx[i])
    return out


def quat_inv(q):
    """Inverse of a unit quaternion (its conjugate)."""
    return q * _conj_sign(q.device, q.dtype)


def quat_rotate(q, v):
    """Rotate v by q: v + 2*(w*(u x v) + u x (u x v))."""
    u = q[..., 1:4]
    w = q[..., 0:1]
    uv = cross(u, v)
    uuv = cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


def quat_rotate_inv(q, v):
    return quat_rotate(quat_inv(q), v)


def sum_in_order(x, dim=-1):
    """``x`` summed over ``dim`` left to right, the order of the CPU's
    reduction. The card's reduction adds the terms in another order,
    which can round one ulp apart and tip a contact one way on the card
    and the other on the CPU."""
    parts = x.unbind(dim)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def norm(v):
    """``|v|`` over the last axis, in the CPU's rounding of
    ``torch.linalg.vector_norm``: each square added to the sum so far
    by a fused multiply-add, left to right, and the square root rounded
    once. Formed in float64, where a product of two float32 values is
    exact and each sum is rounded back to float32, so the card gives the
    same bits; the card's own ``vector_norm`` adds the squares in
    another order."""
    parts = v.double().unbind(-1)
    s = (parts[0] * parts[0]).float()
    for p in parts[1:]:
        s = (s.double() + p * p).float()
    return torch.sqrt(s.double()).float()


def quat_normalize(q):
    l2 = sum_in_order(q * q)[..., None]
    return q / torch.sqrt(torch.clamp(l2, min=1e-30))


def quat_normalize_rcp(q):
    """quat_normalize in the CUDA kernels' rounding: the squares summed
    left to right, then one reciprocal square root multiplied in."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    l2 = w * w + x * x + y * y + z * z
    return q * (1.0 / torch.sqrt(torch.clamp(l2, min=1e-30)))[..., None]


def quat_from_angular(omega, dt):
    """The pure quaternion (0, omega) * 0.5 * dt: the first-order rotation
    delta of the integrator, q' = normalize(q + quat_mul(delta, q))."""
    zero = torch.zeros_like(omega[..., :1])
    return torch.cat([zero, omega], dim=-1) * (0.5 * dt)


def quat_axis_angle(axis, angle):
    """Rotation by ``angle`` about ``axis`` (normalized here)."""
    axis = normalize(torch.as_tensor(axis, dtype=torch.float32))
    half = torch.as_tensor(angle, dtype=torch.float32,
                           device=axis.device) / 2.0
    c = torch.cos(half)
    s = torch.sin(half)
    return torch.cat(
        [torch.broadcast_to(c, axis[..., :1].shape), axis * s[..., None]],
        dim=-1,
    )


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


def aabb_invalid(shape=(), dtype=torch.float32, device=None):
    """(pmin = +max, pmax = -max): the identity of :func:`aabb_merge`."""
    big = torch.finfo(dtype).max
    pmin = torch.full(tuple(shape) + (3,), big, dtype=dtype, device=device)
    pmax = torch.full(tuple(shape) + (3,), -big, dtype=dtype, device=device)
    return pmin, pmax


def aabb_merge(a, b):
    return torch.minimum(a[0], b[0]), torch.maximum(a[1], b[1])


def aabb_expand(box, amount):
    return box[0] - amount, box[1] + amount


def aabb_contains(outer, inner):
    return torch.all((outer[0] <= inner[0]) & (inner[1] <= outer[1]),
                     dim=-1)


def aabb_overlaps(a, b):
    return torch.all((a[0] <= b[1]) & (b[0] <= a[1]), dim=-1)


def aabb_from_points(pts, mask=None):
    """AABB of the points along axis -2; masked-out points are ignored."""
    if mask is not None:
        big = torch.finfo(pts.dtype).max
        lo = torch.where(mask[..., None], pts, big)
        hi = torch.where(mask[..., None], pts, -big)
    else:
        lo = hi = pts
    return lo.amin(dim=-2), hi.amax(dim=-2)


def aabb_ray_hit(box, origin, inv_dir, t_max):
    """Slab test: (hit, t_near), over the leading axes."""
    t0 = (box[0] - origin) * inv_dir
    t1 = (box[1] - origin) * inv_dir
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    hit = (tmin <= tmax) & (tmax >= 0.0) & (tmin <= t_max)
    return hit, torch.clamp(tmin, min=0.0)


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
