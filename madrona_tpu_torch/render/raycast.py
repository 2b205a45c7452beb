"""Ray tracing against oriented boxes (the lidar path).

Port of ``trace_rays_obb`` from ``madrona_tpu/render/raycast.py``: the
plain version of the lidar kernel (``ops/lidar_cuda.py``, which
replaces the Pallas kernel ``ops/lidar_pallas.py``). The rest of the
renderer comes with the hide & seek pixels slice.
"""

from __future__ import annotations

import torch

from ..utils import math3d as m3


def trace_rays_obb(inst_pos, inst_rot, inst_half, inst_mask,
                   origins, dirs, t_max):
    """Nearest-hit distance of each ray against oriented boxes, by the
    exact slab test. Rays that start inside a box hit its exit face;
    hits need t > 1e-3. All float32.

    inst_pos/inst_rot/inst_half: [..., I, 3|4|3] box centers,
    world-from-local quats and half extents; inst_mask [..., I] bool;
    origins/dirs [..., R, 3] (dirs need not be unit: t is in units of
    |dir|). Leading axes broadcast. Returns depth [..., R] (t_max on a
    miss)."""
    inv_q = m3.quat_inv(inst_rot)[..., :, None, :]            # [..., I, 1, 4]
    half = torch.clamp(inst_half, min=1e-12)[..., :, None, :]
    o_l = m3.quat_rotate(
        inv_q, origins[..., None, :, :] - inst_pos[..., :, None, :]
    ) / half                                                  # [..., I, R, 3]
    d_l = m3.quat_rotate(inv_q, dirs[..., None, :, :]) / half
    inv_d = torch.where(torch.abs(d_l) > 1e-12, 1.0 / d_l, 1e30)
    t0 = (-1.0 - o_l) * inv_d
    t1 = (1.0 - o_l) * inv_d
    lo = torch.minimum(t0, t1).amax(dim=-1)                   # [..., I, R]
    hi = torch.maximum(t0, t1).amin(dim=-1)
    t = torch.where(lo > 1e-3, lo, hi)       # inside the box -> exit face
    hit = (
        (hi >= torch.clamp(lo, min=0.0)) & (t > 1e-3) & (t < t_max)
        & inst_mask[..., :, None]
    )
    return torch.where(hit, t, t_max).amin(dim=-2)
