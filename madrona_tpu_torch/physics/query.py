"""Physics-side queries against rigid bodies: AABB overlap and rays.

Port of ``madrona_tpu/physics/query.py`` (the reference's broadphase
tree queries, ``src/physics/broadphase.cpp:658-726`` ``BVH::traceRay``
and ``:930-1027`` ``findIntersectingEntry``). Every (query, body) lane
runs the exact test directly, a masked dense sweep: body counts are tens
per world. Each body's object row is gathered by ObjectID, where the
JAX package multiplies by one-hot matrices; the results are the same.

Exact ray tests per primitive type:
  * hull: the ray moved into the body's scaled local frame (t kept),
    then clipped against the unscaled local half-planes
    (``om.hull_planes``);
  * sphere: the analytic quadratic in the world frame (uniform scale,
    as the narrowphase's sphere lanes assume);
  * plane: one half-plane clip against the body's rotated +z plane.

All float32; the nearest hit wins (the first row on ties, as
``argmin`` takes it), row -1 on a miss.
"""

from __future__ import annotations

import torch

from ..utils import math3d as m3
from . import broadphase as bp
from . import geo
from .xpbd import const_f32

BIG = 3.0e38


def aabb_overlap_bodies(body, om, q_lo, q_hi, active=None):
    """[W, Q, N] bool: the bodies whose world AABB meets each query AABB
    (q_lo, q_hi [W, Q, 3]); dead rows are False."""
    act = body.active if active is None else active
    lo, hi = bp.world_aabbs(body, om, expansion_dt=0.0)    # [W, N, 3]
    sep = torch.any(
        (q_hi[:, :, None, :] < lo[:, None, :, :])
        | (q_lo[:, :, None, :] > hi[:, None, :, :]),
        dim=-1,
    )
    return ~sep & act[:, None, :]


def raycast_bodies(body, om, origins, dirs, t_max, exclude_row=None,
                   active=None):
    """The nearest body hit of each ray.

    origins/dirs: [W, R, 3] (dirs need not be unit: t is in units of
    |dir|); exclude_row: optional [W, R] int32 row each ray ignores (-1:
    none); active: optional [W, N] bool in place of ``body.active``.
    Returns (t [W, R] float32, t_max on a miss; row [W, R] int32, -1 on
    a miss)."""
    n = body.obj_id.shape[1]
    act = body.active if active is None else active
    obj = body.obj_id.long()
    params = om.obj_params(body.obj_id)
    ptype = params["prim_type"]                            # [W, N]
    planes = om.hull_planes[obj]                           # [W, N, F, 4]
    fmask = om.hull_faces_mask[obj]                        # [W, N, F]

    # rays in each body's scaled local frame: [W, N, R, 3]
    inv_q = m3.quat_inv(body.rot)[:, :, None, :]
    s = torch.clamp(body.scale, min=1e-12)[:, :, None, :]
    o_l = m3.quat_rotate(
        inv_q, origins[:, None, :, :] - body.pos[:, :, None, :]) / s
    d_l = m3.quat_rotate(inv_q, dirs[:, None, :, :]) / s

    # hull: clip [W, N, R] rays against [W, N, F] local half-planes
    nrm = planes[..., None, :3]                            # [W, N, F, 1, 3]
    denom = m3.dot(nrm, d_l[:, :, None])                   # [W, N, F, R]
    numer = planes[..., 3, None] - m3.dot(nrm, o_l[:, :, None])
    tf = numer / torch.where(torch.abs(denom) > 1e-12, denom, 1e-12)
    live_f = fmask[..., None]
    # denom > 0: leaving (upper bound); < 0: entering (lower bound);
    # ~0: parallel, a miss if outside that half-plane
    lower = torch.where(live_f & (denom < -1e-12), tf, -BIG)
    upper = torch.where(live_f & (denom > 1e-12), tf, BIG)
    outside_par = live_f & (torch.abs(denom) <= 1e-12) & (numer < 0.0)
    t_in = lower.amax(dim=2)                               # [W, N, R]
    t_out = upper.amin(dim=2)
    hull_ok = (t_in <= t_out) & ~outside_par.any(dim=2) & (t_out > 1e-3)
    # a ray from inside the hull hits its exit face
    t_hull = torch.where(t_in > 1e-3, t_in, t_out)
    t_hull = torch.where(hull_ok & (t_hull > 1e-3), t_hull, BIG)

    # sphere: analytic in the world frame (uniform scale: scale.x)
    rad_w = params["sphere_radius"] * body.scale[..., 0]   # [W, N]
    oc = origins[:, None, :, :] - body.pos[:, :, None, :]  # [W, N, R, 3]
    dw = dirs[:, None, :, :]
    a = m3.dot(dw, dw)
    b2 = m3.dot(oc, dw)
    c = m3.dot(oc, oc) - (rad_w ** 2)[..., None]
    disc = b2 * b2 - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = (-b2 - sq) / torch.clamp(a, min=1e-12)
    t1 = (-b2 + sq) / torch.clamp(a, min=1e-12)
    t_sph = torch.where(t0 > 1e-3, t0, t1)
    t_sph = torch.where((disc >= 0.0) & (t_sph > 1e-3), t_sph, BIG)

    # plane: the body's +z half-space boundary
    up = const_f32((0.0, 0.0, 1.0), body.pos.device)
    pn = m3.quat_rotate(body.rot, torch.broadcast_to(up, body.pos.shape))
    dn = m3.dot(dw, pn[:, :, None, :])
    on = m3.dot(oc, pn[:, :, None, :])
    t_pln = -on / torch.where(torch.abs(dn) > 1e-12, dn, 1e-12)
    t_pln = torch.where((torch.abs(dn) > 1e-12) & (t_pln > 1e-3), t_pln, BIG)

    pt = ptype[..., None]
    t_all = torch.where(
        pt == geo.TYPE_HULL, t_hull,
        torch.where(pt == geo.TYPE_SPHERE, t_sph,
                    torch.where(pt == geo.TYPE_PLANE, t_pln, BIG)),
    )                                                      # [W, N, R]
    t_all = torch.where(act[..., None], t_all, BIG)
    if exclude_row is not None:
        rows = torch.arange(n, device=t_all.device)[None, :, None]
        t_all = torch.where(rows == exclude_row[:, None, :], BIG, t_all)
    t_all = torch.where(t_all < t_max, t_all, BIG)

    row = torch.argmin(t_all, dim=1)                       # [W, R]
    t_best = t_all.amin(dim=1)
    miss = t_best >= BIG
    return (torch.where(miss, float(t_max), t_best),
            torch.where(miss, -1, row.to(torch.int32)))
