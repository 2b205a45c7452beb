"""Per-world light tables and the reference's multi-light shading loop.

Port of ``madrona_tpu/render/lights.py`` (the reference's LightDesc
archetype and its raycaster's per-light loop):

* per light: directional (light_dir = -direction) or spotlight
  (light_dir = normalize(position - hit), skipped outside the cutoff
  cone);
* castShadow lights contribute only when the surface faces the light
  AND an occlusion trace toward it misses; for a spotlight the trace is
  the segment that ends at the light;
* contribution = clamp(normal . light_dir, 0, 1) x intensity, summed
  over lights;
* the caller shades max(ambient floor, sum) x albedo, clamped to 1.

Lights ride a fixed-capacity ``[W, L]`` table; inactive slots are
masked. The raycast kernel (``render/kernel.py``) reads the same table
for directional lights.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import resolve_device
from ..utils import math3d as m3


@dataclasses.dataclass
class Lights:
    """[W, L] light table (or [L] for a single world)."""

    direction: torch.Tensor    # [..., L, 3] f32 (normalised at build)
    position: torch.Tensor     # [..., L, 3] f32 (spotlights)
    is_spot: torch.Tensor      # [..., L] bool
    cutoff: torch.Tensor       # [..., L] f32 half-angle, radians
    cast_shadow: torch.Tensor  # [..., L] bool
    active: torch.Tensor       # [..., L] bool
    intensity: torch.Tensor    # [..., L] f32

    @property
    def capacity(self) -> int:
        return self.direction.shape[-2]

    def to(self, device) -> "Lights":
        return self.map(lambda a: a.to(device))

    def map(self, fn) -> "Lights":
        """The table with ``fn`` applied to every field."""
        return dataclasses.replace(self, **{
            f.name: fn(getattr(self, f.name))
            for f in dataclasses.fields(self)})


def make_lights(num_worlds: int, specs, device=None) -> Lights:
    """A [W, L] table replicated across worlds, on ``device`` (default:
    the card), from a list of dicts: {"direction" | "position",
    "cutoff"?, "cast_shadow"?, "intensity"?}. A spec with "position"
    (and optionally "direction" as the cone axis) is a spotlight;
    otherwise it is directional."""
    dev = resolve_device(device)
    n = max(len(specs), 1)
    dirs = np.zeros((n, 3), np.float32)
    dirs[:, 2] = -1.0
    pos = np.zeros((n, 3), np.float32)
    spot = np.zeros((n,), bool)
    cut = np.full((n,), np.pi, np.float32)
    shad = np.zeros((n,), bool)
    act = np.zeros((n,), bool)
    inten = np.ones((n,), np.float32)
    for i, s in enumerate(specs):
        act[i] = True
        if "position" in s:
            spot[i] = True
            pos[i] = s["position"]
            cut[i] = s.get("cutoff", np.pi / 4)
        if "direction" in s:
            d = np.asarray(s["direction"], np.float32)
            dirs[i] = d / max(np.linalg.norm(d), 1e-12)
        shad[i] = s.get("cast_shadow", False)
        inten[i] = s.get("intensity", 1.0)

    def rep(a):
        t = torch.from_numpy(a).to(dev)
        return t[None].expand((num_worlds,) + t.shape).contiguous()

    return Lights(
        direction=rep(dirs), position=rep(pos), is_spot=rep(spot),
        cutoff=rep(cut), cast_shadow=rep(shad), active=rep(act),
        intensity=rep(inten),
    )


def light_contrib(lights: Lights, hit_p, n_w, hit_any, shadow_trace,
                  use_shadows: bool):
    """The reference's per-light loop over rays.

    lights: [..., L] rows; hit_p / n_w [..., R, 3]; hit_any [..., R];
    shadow_trace: fn(origins [..., R, 3], dirs [..., R, 3], t_limit
    [..., R]) -> occluded [..., R] bool, occluded iff a hit lands
    strictly before t_limit (the distance to a spotlight; inf for a
    directional light). Returns contrib [..., R]."""
    contrib = torch.zeros_like(hit_p[..., 0])
    for i in range(lights.capacity):
        axis = lights.direction[..., i, None, :]            # [..., 1, 3]
        is_spot = lights.is_spot[..., i, None]               # [..., 1]
        to_light = lights.position[..., i, None, :] - hit_p  # [..., R, 3]
        tl_len = torch.clamp(torch.sqrt(m3.dot(to_light, to_light)),
                             min=1e-12)                      # [..., R]
        ldir = torch.where(is_spot[..., None], to_light / tl_len[..., None],
                           -axis)
        # the spotlight's cone test
        d = m3.dot(-ldir, axis)
        angle = torch.arccos(torch.clamp(d, -1.0, 1.0))
        in_cone = (~is_spot) | (
            torch.abs(angle) <= torch.abs(lights.cutoff[..., i, None]))
        ndl = m3.dot(n_w, ldir)
        lam = torch.clamp(ndl, 0.0, 1.0) * lights.intensity[..., i, None]
        lit = torch.ones_like(hit_any)
        if use_shadows:
            # traced whatever cast_shadow says, then masked by it; the
            # segment ends at a spotlight: geometry beyond it casts no
            # shadow
            s_org = hit_p + n_w * torch.where(ndl >= 0, 1e-2, -1e-2)[..., None]
            t_limit = torch.where(is_spot, tl_len - 2e-2, float("inf"))
            occluded = shadow_trace(s_org, ldir.expand(s_org.shape), t_limit)
            lit = (~lights.cast_shadow[..., i, None]) | (
                (ndl > 0.0) & (~occluded))
        ok = lights.active[..., i, None] & in_cone & lit & hit_any
        contrib = contrib + torch.where(ok, lam, 0.0)
    return contrib
