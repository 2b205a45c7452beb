"""Material and texture tables of the raycaster.

Port of ``madrona_tpu/render/materials.py``: materials are a packed
``[M, ...]`` table and every texture lives in one fixed-shape atlas
``[A, S, S, 3]``, so a texture fetch is one gather (the reference's
``AssetProcessor::initMaterialData`` and its raycast kernel's material
and texture sampling). The raycast kernel (``ops/raycast_cuda``) reads
the atlas packed by ``render/kernel.py``; :func:`sample_materials` is
the mesh-BVH tier's plain sampler.

A texture of another size is resampled to ``tex_size`` x ``tex_size``
by :func:`resize_bilinear`, which gives the bytes of the JAX package's
PIL resize (``Image.resize(..., Image.BILINEAR)``) in numpy: the
machines with the card have no PIL.
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


# PIL's fixed-point resampling: 8-bit samples times coefficients of
# 22 fractional bits (Pillow's Resample.c, PRECISION_BITS)
PRECISION_BITS = 22


def _bilinear_coeffs(in_size: int, out_size: int):
    """(first source index [O], integer weights [O, K]) of PIL's
    BILINEAR filter from ``in_size`` samples to ``out_size``: a triangle
    whose support widens with the scale on a downsample, its weights
    normalised in double and rounded to PRECISION_BITS bits."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    support = fscale                      # the triangle's support is 1
    ksize = int(np.ceil(support)) * 2 + 1
    ss = 1.0 / fscale
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        n = min(int(center + support + 0.5), in_size) - lo
        w = [max(0.0, 1.0 - abs((x + lo - center + 0.5) * ss))
             for x in range(n)]
        total = 0.0
        for v in w:
            total += v
        if total != 0.0:
            w = [v / total for v in w]
        first[xx] = lo
        weights[xx, :n] = [int(0.5 + v * (1 << PRECISION_BITS)) for v in w]
    return first, weights


def _resample(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One separable pass of PIL's 8-bit resampling along ``axis`` of an
    int64 image, rounded and clipped to [0, 255] as PIL does."""
    x = np.moveaxis(img, axis, 0)
    first, weights = _bilinear_coeffs(x.shape[0], out_size)
    idx = np.minimum(first[:, None] + np.arange(weights.shape[1]),
                     x.shape[0] - 1)
    acc = np.full((out_size,) + x.shape[1:], 1 << (PRECISION_BITS - 1),
                  np.int64)
    for k in range(weights.shape[1]):
        wk = weights[:, k].reshape((-1,) + (1,) * (x.ndim - 1))
        acc += x[idx[:, k]] * wk
    out = np.clip(acc >> PRECISION_BITS, 0, 255)
    return np.moveaxis(out, 0, axis)


def resize_bilinear(img, size) -> np.ndarray:
    """``img`` [H, W, 3 or 4] uint8 resampled to ``size`` = (width,
    height): the bytes of ``PIL.Image.fromarray(img).resize(size,
    Image.BILINEAR)``. RGBA is premultiplied by alpha before the two
    passes (horizontal, then vertical) and divided back after, as PIL
    does (RGBA -> RGBa -> RGBA), so the colour of a texel with alpha
    below 255 moves."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"resize_bilinear takes [H, W, 3|4] uint8, got "
                         f"{img.shape} {img.dtype}")
    w, h = size
    x = img.astype(np.int64)
    rgba = img.shape[2] == 4
    if rgba:
        a = x[..., 3:]
        t = x[..., :3] * a + 128           # PIL's MULDIV255
        x = np.concatenate([((t >> 8) + t) >> 8, a], axis=-1)
    if w != img.shape[1]:
        x = _resample(x, w, 1)
    if h != img.shape[0]:
        x = _resample(x, h, 0)
    if rgba:
        a = x[..., 3:]
        back = np.minimum(255 * x[..., :3] // np.maximum(a, 1), 255)
        x = np.concatenate(
            [np.where((a == 0) | (a == 255), x[..., :3], back), a], axis=-1)
    return x.astype(np.uint8)


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
            img = resize_bilinear(img, (tex_size, tex_size))
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
