"""Material and texture tables of the raycaster.

Port of ``madrona_tpu/render/materials.py``: materials are a packed
``[M, ...]`` table and every texture lives in one fixed-shape atlas
``[A, S, S, 3]``, so a texture fetch is one gather (the reference's
``AssetProcessor::initMaterialData`` and its raycast kernel's material
and texture sampling). The raycast kernel (``ops/raycast_cuda``) reads
the atlas packed by ``render/kernel.py``; :func:`sample_materials` is
the mesh-BVH tier's plain sampler.

A texture must already be ``tex_size`` x ``tex_size``: the JAX package
resizes others with PIL, which the port does not use, so the bake raises
``ValueError`` for them.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..core.device import resolve_device


@dataclasses.dataclass
class MaterialTables:
    base_color: torch.Tensor    # [M, 4] f32 RGBA factor
    rough_metal: torch.Tensor   # [M, 2] f32 (roughness, metallic)
    tex_id: torch.Tensor        # [M] i32 (-1 = untextured)
    atlas: torch.Tensor         # [A, S, S, 3] f32 (A >= 1)

    @property
    def tex_size(self) -> int:
        return self.atlas.shape[1]

    @property
    def num_materials(self) -> int:
        return self.base_color.shape[0]

    def to(self, device) -> "MaterialTables":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


def bake_materials(materials: Sequence, textures: Sequence = (),
                   tex_size: int = 64, device=None) -> MaterialTables:
    """Pack ImportedMaterial / ImportedTexture lists into tables on
    ``device`` (default: the card).

    Material slot 0 is always the default white material so ``mat_id``
    -1 can clamp to it; callers offset imported ids by +1."""
    dev = resolve_device(device)
    m = len(materials) + 1
    base = np.ones((m, 4), np.float32)
    rm = np.ones((m, 2), np.float32)
    tid = np.full((m,), -1, np.int32)
    for i, mat in enumerate(materials):
        base[i + 1] = np.asarray(mat.base_color, np.float32)
        rm[i + 1] = (mat.roughness, mat.metallic)
        tid[i + 1] = mat.texture

    a = max(len(textures), 1)
    atlas = np.ones((a, tex_size, tex_size, 3), np.float32)
    for i, tex in enumerate(textures):
        img = np.asarray(tex.data)
        if img.shape[0] != tex_size or img.shape[1] != tex_size:
            raise ValueError(
                f"texture {tex.name!r} is {img.shape[1]}x{img.shape[0]}, "
                f"the atlas takes {tex_size}x{tex_size}; the port does not "
                "resize textures"
            )
        atlas[i] = img[..., :3].astype(np.float32) / 255.0
    t = lambda x: torch.from_numpy(x).to(dev)  # noqa: E731
    return MaterialTables(base_color=t(base), rough_metal=t(rm),
                          tex_id=t(tid), atlas=t(atlas))


def default_materials(device=None) -> MaterialTables:
    return bake_materials([], device=device)


def sample_materials(tables: MaterialTables, mat_id, uv):
    """Albedo of hits: base_color.rgb x (texture sample | 1).

    mat_id [...] int (imported id + 1; <= 0 -> default white); uv
    [..., 2] f32, wrapped (GL_REPEAT, the reference's default sampler).
    Bilinear filtering over the atlas. Returns [..., 3] f32."""
    m = torch.clamp(mat_id.long(), 0, tables.num_materials - 1)
    base = tables.base_color[m, :3]                     # [..., 3]
    t = tables.tex_id[m]                                # [...]
    s = tables.tex_size
    frac = uv - torch.floor(uv)                         # wrap
    # texel space; v flipped (image row 0 = v 1.0, the stb/GL convention)
    x = frac[..., 0] * s - 0.5
    y = (1.0 - frac[..., 1]) * s - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    ti = torch.clamp(t, min=0).long()

    def texel(yy, xx):
        # GL_REPEAT: neighbour texels wrap across tile edges
        return tables.atlas[ti, yy.long() % s, xx.long() % s]

    c00 = texel(y0, x0)
    c01 = texel(y0, x0 + 1)
    c10 = texel(y0 + 1, x0)
    c11 = texel(y0 + 1, x0 + 1)
    tex = (
        c00 * (1 - fx) * (1 - fy) + c01 * fx * (1 - fy)
        + c10 * (1 - fx) * fy + c11 * fx * fy
    )
    return base * torch.where((t >= 0)[..., None], tex, 1.0)
