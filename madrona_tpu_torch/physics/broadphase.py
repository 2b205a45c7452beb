"""Broadphase: velocity-expanded AABB overlap -> typed candidate buffers.

Port of the all-pairs tier of ``madrona_tpu/physics/broadphase.py``.
:func:`find_candidates` is the plain version of the broadphase kernel
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

``find_candidates_swept`` (the many-body tier) comes with the pile env.
"""

from __future__ import annotations

import dataclasses
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
