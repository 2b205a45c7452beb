"""TLAS tier: an LBVH over instances, and per-view culling for large scenes.

Port of ``madrona_tpu/render/tlas.py``, plain PyTorch:

- :func:`build_tlas` is the reference's GPU TLAS build (30-bit Morton
  sort, Karras 2012 internal-node ranges, bottom-up AABB refit) as
  fixed-depth vectorised passes over ``[I]`` tensors, with skip links
  for a stackless walk.
- :func:`tlas_candidates` walks the threaded tree for each ray, in
  lockstep over the rays (a loop whose condition syncs with the host),
  and returns up to K candidate instances and the true overlap count.
- :func:`cull_view_topk` culls per *view*: frustum plus distance top-K
  over instance world AABBs; :func:`render_views_tlas` then traces the
  K instances with the dense tracer. Where the raycast kernel can take
  the scene, it traces the full set instead and only the overlap count
  is computed (``render/kernel.py::view_overlap_counts``).

The top-K keeps the JAX package's order: ``jax.lax.top_k`` breaks ties
by the lower index, and every instance outside the frustum ties at
``-BIG``, so the port sorts stably on (-score, index).
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import math3d as m3
from ..utils.morton import morton3d
from .mesh import MeshTables

BIG = 3.0e38
_U32 = 0xFFFFFFFF


# ----------------------------------------------------------------- AABBs


def object_aabbs(mesh: MeshTables):
    """Local-space AABB of every render object: ([O, 3] lo, hi)."""
    pts = torch.stack(
        [mesh.tri_v0, mesh.tri_v0 + mesh.tri_e1, mesh.tri_v0 + mesh.tri_e2],
        dim=2,
    )                                                 # [O, T, 3, 3]
    m = mesh.tri_mask[:, :, None, None]
    lo = torch.where(m, pts, BIG).amin(dim=(1, 2))
    hi = torch.where(m, pts, -BIG).amax(dim=(1, 2))
    return lo, hi


def _mat_vec(r, v):
    """r [..., 3, 3] times v [..., 3], each row's terms summed left to
    right."""
    return (r[..., 0] * v[..., None, 0] + r[..., 1] * v[..., None, 1]
            + r[..., 2] * v[..., None, 2])


def instance_world_aabbs(obj_lo, obj_hi, inst_pos, inst_rot, inst_scale,
                         inst_obj):
    """Conservative world AABBs of instances ([..., I, 3] lo, hi)."""
    obj = inst_obj.long()
    lo, hi = obj_lo[obj], obj_hi[obj]
    c_l = (lo + hi) * 0.5 * inst_scale
    e_l = (hi - lo) * 0.5 * inst_scale
    rm = m3.quat_to_mat3(inst_rot)                    # [..., I, 3, 3]
    c_w = _mat_vec(rm, c_l) + inst_pos
    e_w = _mat_vec(torch.abs(rm), e_l)
    return c_w - e_w, c_w + e_w


# ------------------------------------------------------------ LBVH build


@dataclasses.dataclass
class TLAS:
    """Flat threaded LBVH of one world. Pointer space: [0, I-2] internal
    nodes, [I-1, 2I-2] leaves (leaf p holds instance ``inst[p - (I-1)]``).
    The sentinel 2I-1 ends a walk."""

    node_lo: torch.Tensor    # [2I-1, 3] AABB per pointer
    node_hi: torch.Tensor    # [2I-1, 3]
    left: torch.Tensor       # [2I-1] i32: first-child ptr (leaves: self)
    skip: torch.Tensor       # [2I-1] i32: next ptr on a miss / leaf done
    inst: torch.Tensor       # [I] i32: instance id per leaf slot (-1 dead)
    num_leaves: int = 0


def _clz32(x):
    """Leading zeros of 32-bit values held in int64 (32 for 0)."""
    n = torch.zeros_like(x)
    for bits, top in ((16, 0xFFFF), (8, 0xFFFFFF), (4, 0xFFFFFFF),
                      (2, 0x3FFFFFFF), (1, 0x7FFFFFFF)):
        m = x <= top
        n = n + m.long() * bits
        x = torch.where(m, (x << bits) & _U32, x)
    return n + (x == 0).long()


def _delta(codes, i, j, n):
    """Common-prefix length of sorted keys i and j (the index breaks a
    tie, as if its bits followed the code's); -1 outside the range."""
    j_ok = (j >= 0) & (j < n)
    jc = torch.clamp(j, 0, n - 1)
    x = codes[i] ^ codes[jc]
    d = torch.where(x == 0, 32 + _clz32(i ^ jc), _clz32(x))
    return torch.where(j_ok, d, -1)


def build_tlas(inst_lo, inst_hi, inst_mask, scene_lo, scene_hi) -> TLAS:
    """Build the threaded LBVH over one world's instance AABBs [I, 3].

    Dead instances sort to the end with inverted AABBs (never hit). Every
    loop runs a static number of passes (log2 I searches, at most 64
    refit and skip passes)."""
    i_n = inst_lo.shape[0]
    dev = inst_lo.device
    i32 = dict(dtype=torch.int32, device=dev)
    if i_n < 2:
        # one root == leaf node always exists (zero instances get an
        # inverted never-hit box), so every field has length 1
        one = (inst_mask[:1] if i_n == 1
               else torch.zeros((1,), dtype=torch.bool, device=dev))
        big = torch.full((1, 3), BIG, dtype=torch.float32, device=dev)
        lo = torch.where(one[:, None], inst_lo[:1] if i_n == 1 else big, BIG)
        hi = torch.where(one[:, None], inst_hi[:1] if i_n == 1 else -big,
                         -BIG)
        return TLAS(node_lo=lo, node_hi=hi,
                    left=torch.zeros((1,), **i32),
                    skip=torch.ones((1,), **i32),
                    inst=torch.where(one, 0, -1).to(torch.int32),
                    num_leaves=1)

    center = (inst_lo + inst_hi) * 0.5
    codes = morton3d(center, scene_lo, scene_hi)
    codes = torch.where(inst_mask, codes, _U32)
    order = torch.argsort(codes, stable=True)
    codes = codes[order]
    live = inst_mask[order][:, None]
    lo_s = torch.where(live, inst_lo[order], BIG)
    hi_s = torch.where(live, inst_hi[order], -BIG)

    n = i_n
    ii = torch.arange(n - 1, device=dev)              # internal node ids

    def delta(i, j):
        return _delta(codes, i, j, n)

    d = torch.sign(delta(ii, ii + 1) - delta(ii, ii - 1))
    d = torch.where(d == 0, 1, d)
    delta_min = delta(ii, ii - d)

    # the range's other end: the largest l with delta(i, i + l*d) >
    # delta_min (non-increasing in l) by a binary search on n's bits
    nbits = max(1, (n - 1).bit_length())
    ln = torch.zeros_like(ii)
    for b in range(nbits, -1, -1):
        cand = ln + (1 << b)
        ok = (cand <= n) & (delta(ii, ii + cand * d) > delta_min)
        ln = torch.where(ok, cand, ln)
    j = ii + ln * d

    delta_node = delta(ii, j)
    # the split: the largest s with delta(i, i + s*d) > delta_node
    s = torch.zeros_like(ii)
    for b in range(nbits, -1, -1):
        cand = s + (1 << b)
        ok = (cand < ln) & (delta(ii, ii + cand * d) > delta_node)
        s = torch.where(ok, cand, s)
    gamma = ii + s * d + torch.clamp(d, max=0)

    lo_rng = torch.minimum(ii, j)
    hi_rng = torch.maximum(ii, j)
    left_child = torch.where(lo_rng == gamma, gamma + (n - 1), gamma)
    right_child = torch.where(hi_rng == gamma + 1, gamma + 1 + (n - 1),
                              gamma + 1)

    num_ptr = 2 * n - 1
    parent = torch.zeros((num_ptr,), dtype=torch.int64, device=dev)
    parent[left_child] = ii
    parent[right_child] = ii
    is_right = torch.zeros((num_ptr,), dtype=torch.bool, device=dev)
    is_right[right_child] = True

    # bottom-up AABB refit: a fixed number of passes
    fill = torch.full((n - 1, 3), BIG, dtype=torch.float32, device=dev)
    node_lo = torch.cat([fill, lo_s])
    node_hi = torch.cat([-fill, hi_s])
    depth = min(n - 1, 64)
    for _ in range(depth):
        int_lo = torch.minimum(node_lo[left_child], node_lo[right_child])
        int_hi = torch.maximum(node_hi[left_child], node_hi[right_child])
        node_lo = torch.cat([int_lo, lo_s])
        node_hi = torch.cat([int_hi, hi_s])

    # skip links: skip[left] = its right sibling, skip[right] =
    # skip[parent] (resolved along right spines); the root skips to END
    sentinel = num_ptr
    right_sib = torch.zeros((num_ptr,), dtype=torch.int64, device=dev)
    right_sib[left_child] = right_child
    ptr = torch.arange(num_ptr, device=dev)
    skip = torch.where(ptr == 0, sentinel,
                       torch.where(is_right, sentinel, right_sib))
    for _ in range(depth):
        skip = torch.where(is_right, skip[parent], skip)
    skip[0] = sentinel

    left_full = torch.cat([left_child, torch.arange(n - 1, num_ptr,
                                                    device=dev)])
    # dead leaves: inverted AABBs are identities of the refit but pass a
    # slab test (min/max un-invert them), so they carry inst = -1
    return TLAS(node_lo=node_lo, node_hi=node_hi,
                left=left_full.to(torch.int32), skip=skip.to(torch.int32),
                inst=torch.where(inst_mask[order], order, -1).to(torch.int32),
                num_leaves=n)


# -------------------------------------------------------------- traverse


def _ray_aabb(lo, hi, o, inv_d, t_max):
    t0 = (lo - o) * inv_d
    t1 = (hi - o) * inv_d
    t_near = torch.minimum(t0, t1).amax(dim=-1)
    t_far = torch.maximum(t0, t1).amin(dim=-1)
    return (t_near <= t_far) & (t_far > 0.0) & (t_near < t_max)


def tlas_candidates(tlas: TLAS, origins, dirs, k: int, t_max: float):
    """Walk the threaded LBVH for each ray [R, 3]; return up to K
    candidate instance ids [R, K] (padded with -1) and the true overlap
    count [R] (an overflow signal, like the broadphase caps). The rays
    walk in lockstep; a ray that has reached the sentinel stays there."""
    n_ptr = tlas.left.shape[0]
    leaf0 = max(tlas.num_leaves - 1, 0)
    r = origins.shape[0]
    dev = origins.device
    inv_d = 1.0 / torch.where(torch.abs(dirs) > 1e-12, dirs, 1e-12)
    left, skip, inst = tlas.left.long(), tlas.skip.long(), tlas.inst.long()
    ptr = torch.zeros((r,), dtype=torch.int64, device=dev)
    cands = torch.full((r, k), -1, dtype=torch.int32, device=dev)
    cnt = torch.zeros((r,), dtype=torch.int32, device=dev)
    rows = torch.arange(r, device=dev)
    while bool((ptr < n_ptr).any()):
        walking = ptr < n_ptr
        p = torch.clamp(ptr, max=n_ptr - 1)
        hit = _ray_aabb(tlas.node_lo[p], tlas.node_hi[p], origins, inv_d,
                        t_max)
        is_leaf = p >= leaf0
        who = inst[torch.clamp(p - leaf0, min=0)]
        take = walking & hit & is_leaf & (who >= 0)
        slot = torch.clamp(cnt, max=k - 1).long()
        cands[rows, slot] = torch.where(take & (cnt < k), who.to(torch.int32),
                                        cands[rows, slot])
        cnt = cnt + take.to(torch.int32)
        nxt = torch.where(hit & ~is_leaf, left[p], skip[p])
        ptr = torch.where(walking, nxt, ptr)
    return cands, cnt


# ------------------------------------------------------- per-view culling


def _unit(v):
    t = torch.tensor(v, dtype=torch.float32)
    return t / torch.sqrt(m3.dot(t, t))


def cull_view_topk(inst_lo, inst_hi, inst_mask, cam_pos, cam_rot, k: int,
                   fov_deg: float, aspect: float, t_max: float):
    """Frustum and distance cull of cameras [..., 3|4] over instance
    world AABBs [..., I, 3] (mask [..., I]): the K nearest instances
    whose bounding sphere meets the view frustum. Returns ([..., K]
    indices into the instances, [..., K] valid mask, [...] overlap
    count); the indices are in descending score, ties by the lower
    index, as ``jax.lax.top_k`` gives them."""
    n_inst = inst_lo.shape[-2]
    if not 0 < k <= n_inst:
        raise ValueError(f"k={k} must lie in [1, {n_inst}]")
    dev = inst_lo.device
    c = (inst_lo + inst_hi) * 0.5
    e = (inst_hi - inst_lo) * 0.5
    r = torch.sqrt(m3.dot(e, e))                       # bounding-sphere cull

    # frustum planes in camera space (+y forward, x right, z up)
    half = torch.tan(torch.deg2rad(torch.tensor(fov_deg, dtype=torch.float32))
                     * 0.5)
    half_x = float(half * aspect)
    half_z = float(half)
    c_cam = m3.quat_rotate(m3.quat_inv(cam_rot)[..., None, :],
                           c - cam_pos[..., None, :])
    planes = torch.stack([
        _unit([0.0, 1.0, 0.0]),                        # near (y > 0)
        _unit([-1.0, half_x, 0.0]),                    # +x side
        _unit([1.0, half_x, 0.0]),                     # -x side
        _unit([0.0, half_z, -1.0]),                    # +z side
        _unit([0.0, half_z, 1.0]),                     # -z side
    ]).to(dev)                                         # [5, 3]
    sd = m3.dot(c_cam[..., None, :], planes)           # [..., I, 5]
    inside = (sd > -r[..., None]).all(dim=-1)
    dist = torch.sqrt(m3.dot(c - cam_pos[..., None, :],
                             c - cam_pos[..., None, :]))
    inside &= (dist - r) < t_max
    inside &= inst_mask & (inst_hi[..., 0] >= inst_lo[..., 0])

    score = torch.where(inside, -dist, -BIG)
    # descending score, ties by the lower index: a stable ascending sort
    # of -score
    idx = torch.argsort(-score, dim=-1, stable=True)[..., :k]
    top = torch.take_along_dim(score, idx, dim=-1)
    return idx, top > -BIG, inside.sum(dim=-1, dtype=torch.int32)


def render_views_tlas(cfg, mesh: MeshTables, inst_pos, inst_rot, inst_scale,
                      inst_obj, inst_mask, cam_pos, cam_rot,
                      max_instances_per_view: int = 16):
    """``render_views`` at scene scale: a per-view frustum and top-K cull
    over instance world AABBs, then the dense tracer on the K compacted
    instances. Exact whenever at most K instances overlap a view frustum
    (callers size K like the broadphase caps).

    Returns (rgb [W, V, H, Wpx, 3], depth [W, V, H, Wpx], overlap
    [W, V]: the true per-view overlap count, for overflow detection)."""
    from .blas import _take
    from .raycast import per_view, resolve_tracer, trace_view

    tracer = resolve_tracer(cfg)
    k = max_instances_per_view
    obj_lo, obj_hi = object_aabbs(mesh)
    n_views = cam_pos.shape[1]
    if inst_mask.dim() == 2:
        inst_mask = per_view(inst_mask, n_views)

    from .kernel import (kernel_eligible, render_views_kernel,
                         view_overlap_counts)

    if kernel_eligible(cfg, mesh, None, k, inst_pos.shape[1]):
        # the kernel traces the full set (exact whatever the overlap);
        # the overlap count keeps the adaptive-K contract
        # (RenderingSystem.maybe_grow_tlas)
        rgb, depth = render_views_kernel(
            cfg, mesh, inst_pos, inst_rot, inst_scale, inst_obj, inst_mask,
            cam_pos, cam_rot)
        overlap = view_overlap_counts(
            obj_lo, obj_hi, inst_pos, inst_rot, inst_scale, inst_obj,
            inst_mask, cam_pos, cam_rot, cfg)
        return rgb, depth, overlap

    lo, hi = instance_world_aabbs(obj_lo, obj_hi, inst_pos, inst_rot,
                                  inst_scale, inst_obj)       # [W, I, 3]
    rgbs, deps, overlaps = [], [], []
    for v in range(n_views):
        cp, cr = cam_pos[:, v], cam_rot[:, v]
        idx, ok, n_overlap = cull_view_topk(
            lo, hi, inst_mask[:, v], cp, cr, k, cfg.fov_deg,
            cfg.width / cfg.height, cfg.t_max)
        rgb, dep = trace_view(cfg, tracer, mesh, *(_take(a, idx) for a in (
            inst_pos, inst_rot, inst_scale, inst_obj)), ok, cp, cr)
        rgbs.append(rgb)
        deps.append(dep)
        overlaps.append(n_overlap)
    return (torch.stack(rgbs, dim=1), torch.stack(deps, dim=1),
            torch.stack(overlaps, dim=1))
