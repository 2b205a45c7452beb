"""Broadphase: velocity-expanded AABB overlap -> typed candidate buffers.

Port of ``madrona_tpu/physics/broadphase.py``'s all-pairs and swept
tiers. :func:`find_candidates` is the plain version of the broadphase kernel
(``ops/broadphase_cuda.py``, which replaces the Pallas kernel
``ops/broadphase_pallas.py``): the CPU path, the parity tests' subject
and the kernel's oracle on the card. Kernel and plain version produce
equal Candidates, field by field.

  * AABBs are expanded by velocity (the reference's BVH::expandLeaf).
  * Pairs are ordered lower primitive-type code first (the reference's
    swap), so each narrowphase buffer holds one pair type.
  * Static|static pairs are skipped.
  * Compaction rank is row-major over the upper triangle, the order of
    ``torch.triu_indices``.

:func:`find_candidates_swept` is the many-body tier (sweep and prune
along x, the widest bodies tested densely). No TPU kernel runs it: the
JAX package runs it in XLA, and here it is plain PyTorch on the card.
Its Candidates equal the JAX package's field by field, compaction order
included.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..utils import math3d as m3
from . import geo
from .bodies import RESPONSE_STATIC
from .xpbd import BodyState


@dataclasses.dataclass(frozen=True)
class CandidateCaps:
    """Fixed capacities of each narrowphase candidate buffer."""

    hull_hull: int = 32
    hull_plane: int = 16
    sphere_any: int = 16


@dataclasses.dataclass
class Candidates:
    """Per-world typed candidate row pairs; N = invalid sentinel."""

    hh: torch.Tensor       # [W, CAP_HH, 2] int32
    hh_num: torch.Tensor   # [W] int32
    hp: torch.Tensor       # [W, CAP_HP, 2] int32 (hull, plane)
    hp_num: torch.Tensor
    sp: torch.Tensor       # [W, CAP_S, 2] int32 (sphere first)
    sp_num: torch.Tensor
    sp_kind: torch.Tensor  # [W, CAP_S] int32 — geo type of the second prim
    # [W] bool: a buffer saturated and pairs were dropped this step
    overflow: Optional[torch.Tensor] = None


def world_aabbs(body: BodyState, om, expansion_dt: float, params=None):
    """Per-body world AABB, expanded along velocity: (lo, hi) [W, N, 3]."""
    params = params or om.obj_params(body.obj_id)
    lo, hi = m3.aabb_transform(
        (params["aabb_min"], params["aabb_max"]),
        body.pos, body.rot, body.scale,
    )
    delta = body.vel * expansion_dt
    return lo + torch.clamp(delta, max=0.0), hi + torch.clamp(delta, min=0.0)


def _typed_compact(first, second, hit, ptype, n: int,
                   caps: CandidateCaps) -> Candidates:
    """Type each hit pair, order it (lower type code first) and compact
    the hits in rank order into the three fixed-capacity buffers.

    first/second: [P] row indices; hit: [W, P] bool; ptype: [W, N]."""
    w = hit.shape[0]
    ta = ptype[:, first]
    tb = ptype[:, second]
    swap = ta > tb
    first_b = torch.broadcast_to(first, hit.shape)
    second_b = torch.broadcast_to(second, hit.shape)
    pair = torch.stack([
        torch.where(swap, second_b, first_b),
        torch.where(swap, first_b, second_b),
    ], dim=-1).to(torch.int32)                               # [W, P, 2]
    t_first = torch.minimum(ta, tb)
    t_second = torch.maximum(ta, tb)

    code = t_first | t_second          # the reference's NarrowphaseTest code
    is_hh = hit & (code == (geo.TYPE_HULL | geo.TYPE_HULL))
    is_hp = hit & (code == (geo.TYPE_HULL | geo.TYPE_PLANE))
    is_sphere = hit & (t_first == geo.TYPE_SPHERE) & (t_second != geo.TYPE_NONE)

    def compact(mask, cap):
        """(buf [W, cap, 2] with sentinel n, count, saturated [W])."""
        mi = mask.to(torch.int32)
        pos = torch.cumsum(mi, dim=1) - mi
        total = mi.sum(dim=1, dtype=torch.int32)
        # hits past the cap go to a spare slot that is cut off
        dest = torch.where(mask & (pos < cap), pos, cap).long()
        buf = torch.full((w, cap + 1, 2), n, dtype=torch.int32,
                         device=hit.device)
        buf.scatter_(1, dest[..., None].expand(-1, -1, 2), pair)
        return buf[:, :cap], torch.clamp(total, max=cap), total > cap

    hh, hh_num, hh_sat = compact(is_hh, caps.hull_hull)
    hp, hp_num, hp_sat = compact(is_hp, caps.hull_plane)
    sp, sp_num, sp_sat = compact(is_sphere, caps.sphere_any)

    sp_b = sp[..., 1].long().clamp(0, n - 1)
    sp_kind = torch.where(
        sp[..., 1] < n, torch.gather(ptype, 1, sp_b), geo.TYPE_NONE
    ).to(torch.int32)
    return Candidates(
        hh=hh, hh_num=hh_num, hp=hp, hp_num=hp_num,
        sp=sp, sp_num=sp_num, sp_kind=sp_kind,
        overflow=hh_sat | hp_sat | sp_sat,
    )


def find_candidates(body: BodyState, om, caps: CandidateCaps,
                    expansion_dt: float) -> Candidates:
    """All-pairs overlap -> compacted typed candidate buffers."""
    n = body.pos.shape[1]
    params = om.obj_params(body.obj_id)
    lo, hi = world_aabbs(body, om, expansion_dt, params=params)
    ptype = params["prim_type"]                              # [W, N]
    static = body.response == RESPONSE_STATIC

    iu, ju = torch.triu_indices(n, n, offset=1, device=body.pos.device)
    overlap = torch.all(
        (lo[:, iu] <= hi[:, ju]) & (lo[:, ju] <= hi[:, iu]), dim=-1
    )                                                        # [W, P]
    both_live = body.active[:, iu] & body.active[:, ju]
    both_static = static[:, iu] & static[:, ju]
    hit = overlap & both_live & (~both_static)
    return _typed_compact(iu, ju, hit, ptype, n, caps)


def first_index_geq(pos_inc, targets):
    """Per row, the first index i with ``pos_inc[:, i] >= target`` for
    each target, clipped to P-1: an unrolled binary search over the
    nondecreasing rows of ``pos_inc`` [W, P]; ``targets`` is [cap].
    Callers check the hit with a gather-compare. It takes
    ceil(log2(P+1)) steps: the interval [0, P] holds P+1 answers
    (ceil(log2(P)) is one short when P is a power of two)."""
    w, p_len = pos_inc.shape
    cap = targets.shape[0]
    lo = torch.zeros((w, cap), dtype=torch.int64, device=pos_inc.device)
    hi = torch.full((w, cap), p_len, dtype=torch.int64,
                    device=pos_inc.device)
    tgt = targets.to(pos_inc.dtype)[None]
    for _ in range(max(1, math.ceil(math.log2(p_len + 1)))):
        mid = (lo + hi) >> 1
        vm = torch.gather(pos_inc, 1, torch.clamp(mid, max=p_len - 1))
        go_right = vm < tgt
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    return torch.clamp(lo, max=p_len - 1)


def _typed_masks(hit, ta, tb):
    """(hull-hull, hull-plane, sphere) masks of the hit pairs by type."""
    t_lo = torch.minimum(ta, tb)
    t_hi = torch.maximum(ta, tb)
    code = t_lo | t_hi
    return (
        hit & (code == (geo.TYPE_HULL | geo.TYPE_HULL)),
        hit & (code == (geo.TYPE_HULL | geo.TYPE_PLANE)),
        hit & (t_lo == geo.TYPE_SPHERE) & (t_hi != geo.TYPE_NONE),
    )


def find_candidates_swept(body: BodyState, om, caps: CandidateCaps,
                          expansion_dt: float, window: int = 32,
                          large_slots: int = 8) -> Candidates:
    """Sweep-and-prune tier for many-body worlds (hundreds of bodies).

    * The ``large_slots`` widest live bodies along x per world (walls,
      floors) are tested densely against every body: [W, L, N].
    * The other live bodies are sorted by AABB min-x per world, and each
      is tested against the next ``min(window, N-1)`` in that order.
      If more than ``window`` later bodies start before one ends along
      x, pairs may be missed, and ``overflow`` is set for that world.

    Dead rows sort to +inf (out of the sweep and of the large slots).
    Hits are compacted per type in the block order [large (L*N) | k=1
    (N) | ... | k=K (N)], the JAX package's, and pairs are rebuilt only
    at the selected indices, lower type code first."""
    w, n = body.pos.shape[:2]
    dev = body.pos.device
    params = om.obj_params(body.obj_id)
    lo, hi = world_aabbs(body, om, expansion_dt, params=params)
    ptype = params["prim_type"]                              # [W, N]
    static = body.response == RESPONSE_STATIC
    live = body.active
    ar_n = torch.arange(n, device=dev)

    # ---- the large slots: top-L x-extent among live bodies. lax.top_k
    # keeps the lower index among ties (every dead row ties at -inf): a
    # stable descending sort does the same
    l_slots = min(large_slots, n)
    extent = torch.where(live, hi[..., 0] - lo[..., 0],
                         torch.tensor(-math.inf, device=dev))
    large_idx = torch.sort(extent, dim=1, descending=True,
                           stable=True).indices[:, :l_slots]  # [W, L]
    li_live = torch.gather(live, 1, large_idx)
    is_large = torch.zeros((w, n), dtype=torch.bool, device=dev).scatter(
        1, large_idx, li_live)

    # ---- dense large-vs-all pairs
    g3 = large_idx[..., None].expand(-1, -1, 3)
    la_lo = torch.gather(lo, 1, g3)                          # [W, L, 3]
    la_hi = torch.gather(hi, 1, g3)
    ov_large = torch.all(
        (la_lo[:, :, None, :] <= hi[:, None, :, :])
        & (lo[:, None, :, :] <= la_hi[:, :, None, :]), dim=-1,
    )                                                        # [W, L, N]
    pair_live = li_live[:, :, None] & live[:, None, :]
    both_static = (torch.gather(static, 1, large_idx)[:, :, None]
                   & static[:, None, :])
    not_self = large_idx[:, :, None] != ar_n[None, None, :]
    # a large-large pair counts once, from the lower slot
    rank = torch.full((w, n), l_slots, dtype=torch.int64, device=dev).scatter(
        1, large_idx,
        torch.arange(l_slots, device=dev)[None].expand(w, -1).contiguous())
    ll_keep = (~is_large[:, None, :]) | (
        rank[:, None, :] > torch.arange(l_slots, device=dev)[None, :, None])
    hit_large = ov_large & pair_live & ~both_static & not_self & ll_keep

    # ---- the sweep over the rest (argsort is stable, as jnp.argsort)
    small_live = live & ~is_large
    inf = torch.tensor(math.inf, device=dev)
    sort_key = torch.where(small_live, lo[..., 0], inf)
    order = torch.argsort(sort_key, dim=1, stable=True)      # [W, N]
    o3 = order[..., None].expand(-1, -1, 3)
    s_lo = torch.gather(lo, 1, o3)
    s_hi = torch.gather(hi, 1, o3)
    s_live = torch.gather(small_live, 1, order)
    s_static = torch.gather(static, 1, order)

    # the window is exact while, for every small body, the later smalls
    # whose x-interval starts no later than it ends fit in it. The pair
    # test is inclusive (b_lo <= a_hi), so the count is searchsorted's
    # right side
    s_key = torch.where(s_live, s_lo[..., 0], inf).contiguous()
    reach = torch.searchsorted(
        s_key, torch.where(s_live, s_hi[..., 0], -inf).contiguous(),
        right=True)
    span = reach - ar_n[None, :] - 1
    overflow = torch.any(s_live & (span > window), dim=1)

    # ---- every shifted block at once: [W, K, N], which reshaped to
    # [W, K*N] is the k=1..K block order
    s_type = torch.gather(ptype, 1, order)
    li_type = torch.gather(ptype, 1, large_idx)
    k_max = min(window, n - 1)
    ks = torch.arange(1, k_max + 1, device=dev)
    j = ar_n[None, :] + ks[:, None]                          # [K, N]
    valid = j < n
    jc = torch.clamp(j, max=n - 1).reshape(-1)               # [K*N]
    b_lo = s_lo[:, jc].reshape(w, k_max, n, 3)
    b_hi = s_hi[:, jc].reshape(w, k_max, n, 3)
    a_lo, a_hi = s_lo[:, None], s_hi[:, None]
    x_live = b_lo[..., 0] <= a_hi[..., 0]
    overlap = torch.all((a_lo <= b_hi) & (b_lo <= a_hi), dim=-1)
    del b_lo, b_hi
    pair_live = s_live[:, None, :] & s_live[:, jc].reshape(w, k_max, n)
    both_static = s_static[:, None, :] & s_static[:, jc].reshape(
        w, k_max, n)
    hit_k = overlap & x_live & pair_live & ~both_static & valid[None]
    masks = zip(
        _typed_masks(hit_large, li_type[:, :, None], ptype[:, None, :]),
        _typed_masks(hit_k, s_type[:, None, :],
                     s_type[:, jc].reshape(w, k_max, n)),
    )
    ln = l_slots * n

    def pair_at(idx_c):
        """(first, second, second's type) at flat pair indices [W, cap]:
        the inverse of the block order, lower type code first."""
        in_large = idx_c < ln
        li = torch.clamp(idx_c, 0, max(ln - 1, 0))
        f_l = torch.gather(large_idx, 1, li // n)
        s_l = li % n
        ps = torch.clamp(idx_c - ln, 0, k_max * n - 1)
        i_s = ps % n
        j_s = torch.clamp(i_s + ps // n + 1, max=n - 1)
        f = torch.where(in_large, f_l, torch.gather(order, 1, i_s))
        s = torch.where(in_large, s_l, torch.gather(order, 1, j_s))
        tf = torch.gather(ptype, 1, f)
        ts = torch.gather(ptype, 1, s)
        sw = tf > ts
        return (torch.where(sw, s, f), torch.where(sw, f, s),
                torch.maximum(tf, ts))

    def compact_lazy(m_large, m_small, cap):
        mask = torch.cat([m_large.reshape(w, -1), m_small.reshape(w, -1)],
                         dim=1)                              # [W, P]
        pos_inc = torch.cumsum(mask, dim=1, dtype=torch.int32)
        total = pos_inc[:, -1]
        targets = torch.arange(1, cap + 1, dtype=torch.int32, device=dev)
        idx_c = first_index_geq(pos_inc, targets)
        got = torch.gather(pos_inc, 1, idx_c) == targets[None]
        f, s, t2 = pair_at(idx_c)
        buf = torch.stack([torch.where(got, f, n), torch.where(got, s, n)],
                          dim=-1).to(torch.int32)
        kind = torch.where(got, t2, geo.TYPE_NONE).to(torch.int32)
        return buf, torch.clamp(total, max=cap), total > cap, kind

    (hh, hh_num, hh_sat, _), (hp, hp_num, hp_sat, _), (
        sp, sp_num, sp_sat, sp_kind) = (
        compact_lazy(ml, ms, cap) for (ml, ms), cap in zip(
            masks, (caps.hull_hull, caps.hull_plane, caps.sphere_any)))
    return Candidates(
        hh=hh, hh_num=hh_num, hp=hp, hp_num=hp_num,
        sp=sp, sp_num=sp_num, sp_kind=sp_kind,
        overflow=overflow | hh_sat | hp_sat | sp_sat,
    )
