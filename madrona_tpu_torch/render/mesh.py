"""Render meshes: padded triangle tables per render object.

Port of ``madrona_tpu/render/mesh.py``. The batch-sim envs render
low-poly game geometry (boxes, ramps, planes: tens of triangles), so a
render object is a padded ``[T, 3]`` triangle table and a scene is the
flat list of its instances' triangles. The registry accumulates numpy
rows on the host; :meth:`MeshRegistry.build` stacks them into CPU
tensors and :meth:`MeshTables.to` moves them to a device, as
``ObjectManager.to`` does for the collision tables. The mesh-BVH bake
(``build_blas``) comes with the BLAS render tier.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

MAX_TRIS = 32


@dataclasses.dataclass
class MeshTables:
    """All registered render objects as stacked tensors on one device."""

    tri_v0: torch.Tensor      # [O, T, 3]
    tri_e1: torch.Tensor      # [O, T, 3] (v1 - v0)
    tri_e2: torch.Tensor      # [O, T, 3] (v2 - v0)
    tri_mask: torch.Tensor    # [O, T] bool
    tri_color: torch.Tensor   # [O, T, 3]
    num_objects: int = 0

    def to(self, device) -> "MeshTables":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if torch.is_tensor(getattr(self, f.name))
        })


class MeshRegistry:
    """Build-time accumulator of render meshes."""

    def __init__(self):
        self._rows: List[dict] = []

    def add_mesh(self, verts, tris, color=(0.8, 0.8, 0.8),
                 tri_colors=None, uv=None, material=0) -> int:
        """``uv`` (optional [V, 2] vertex UVs) and ``material`` (slot,
        0 = default) are kept for the BLAS tier's bake; the dense tier
        ignores them."""
        verts = np.asarray(verts, np.float32)
        tris = np.asarray(tris, np.int32)
        if len(tris) > MAX_TRIS:
            raise ValueError(
                f"mesh has {len(tris)} tris > MAX_TRIS={MAX_TRIS}"
            )
        v0 = verts[tris[:, 0]]
        e1 = verts[tris[:, 1]] - v0
        e2 = verts[tris[:, 2]] - v0
        if tri_colors is None:
            tri_colors = np.tile(np.asarray(color, np.float32), (len(tris), 1))
        self._rows.append(dict(
            v0=v0, e1=e1, e2=e2, colors=tri_colors,
            verts=verts, tris=tris,
            uv=None if uv is None else np.asarray(uv, np.float32),
            material=int(material),
        ))
        return len(self._rows) - 1

    def build_blas(self, leaf_size: int = 4):
        raise NotImplementedError(
            "the mesh-BVH (BLAS) render tier is not ported yet"
        )

    def add_box(self, half_extents, color=(0.8, 0.8, 0.8),
                uv=None, material=0) -> int:
        hx, hy, hz = np.broadcast_to(
            np.asarray(half_extents, np.float32), (3,)
        )
        v = np.array(
            [
                [sx * hx, sy * hy, sz * hz]
                for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)
            ],
            np.float32,
        )
        # 12 triangles, outward winding
        quads = [
            (0, 1, 3, 2), (4, 6, 7, 5),   # -x, +x
            (0, 4, 5, 1), (2, 3, 7, 6),   # -y, +y
            (0, 2, 6, 4), (1, 5, 7, 3),   # -z, +z
        ]
        tris = []
        for a, b, c, d in quads:
            tris += [(a, b, c), (a, c, d)]
        return self.add_mesh(v, tris, color, uv=uv, material=material)

    def add_quad(self, size=100.0, color=(0.5, 0.5, 0.5),
                 uv_tiles: float = 0.0, material=0) -> int:
        """A ground quad in the local z=0 plane (the render stand-in for
        the infinite collision plane). ``uv_tiles`` > 0 assigns wrapped
        UVs spanning that many texture repeats across the quad."""
        s = float(size)
        v = np.array(
            [[-s, -s, 0], [s, -s, 0], [s, s, 0], [-s, s, 0]], np.float32
        )
        uv = None
        if uv_tiles > 0:
            t = float(uv_tiles)
            uv = np.array([[0, 0], [t, 0], [t, t], [0, t]], np.float32)
        return self.add_mesh(v, [(0, 1, 2), (0, 2, 3)], color,
                             uv=uv, material=material)

    def build(self) -> MeshTables:
        """Stack the rows, padded to the largest triangle count (CPU)."""
        if not self._rows:
            raise ValueError("no meshes registered")
        t = max(len(r["v0"]) for r in self._rows)

        def stack(get):
            rows = []
            for r in self._rows:
                x = get(r)
                out = np.zeros((t,) + x.shape[1:], x.dtype)
                out[: len(x)] = x
                rows.append(out)
            return torch.from_numpy(np.stack(rows))

        return MeshTables(
            tri_v0=stack(lambda r: r["v0"]),
            tri_e1=stack(lambda r: r["e1"]),
            tri_e2=stack(lambda r: r["e2"]),
            tri_mask=stack(lambda r: np.ones(len(r["v0"]), bool)),
            tri_color=stack(lambda r: np.asarray(r["colors"], np.float32)),
            num_objects=len(self._rows),
        )
