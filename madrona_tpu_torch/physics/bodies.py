"""Rigid-body object registry: the ObjectManager.

Port of ``madrona_tpu/physics/bodies.py``: every registered object
type's collision primitive and mass data, packed into small tensors
indexed by ObjectID and shared by all worlds. The packs are built with
numpy in the same slot order as the JAX package's, so they are equal
byte for byte. Per-body lookups are index gathers; the JAX package's
one-hot einsums exist only for the TPU.

The contacts kernel (``csrc/contacts.cu``) reads ``hull_pack`` and
``hull_dirs_pack`` as they are, copied to shared memory; the JAX
package's ``hull_pack_planar``, a component-planar copy for the TPU's
tiling, has no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from . import geo

RESPONSE_DYNAMIC = 0
RESPONSE_KINEMATIC = 1
RESPONSE_STATIC = 2


@dataclasses.dataclass
class ObjectManager:
    """Per-app (not per-world) object tables, as tensors on one device."""

    prim_type: torch.Tensor       # [O] int32 (geo.TYPE_*)
    inv_mass: torch.Tensor        # [O] f32
    # every hull constant flattened into one [O, K] row, in the slot
    # order narrowphase.hull_row_to_world unpacks
    hull_pack: torch.Tensor       # [O, K] f32
    hull_dims: tuple              # static (V, F, FV, E)
    # unique edge directions: dirs.flat (3D) | mask (D) | edge dir id (E)
    hull_dirs_pack: torch.Tensor  # [O, 4D + E] f32
    n_edge_dirs: int              # D (static)
    # inv_mass(1) inv_inertia(3) mu_s(1) mu_d(1) aabb_min(3) aabb_max(3)
    # sphere_radius(1) prim_type(1, as float)
    body_pack: torch.Tensor       # [O, 14] f32
    # local face planes (n, d) and their mask, for the ray query
    hull_planes: torch.Tensor     # [O, F, 4] f32
    hull_faces_mask: torch.Tensor  # [O, F] bool

    @property
    def num_objects(self) -> int:
        return self.prim_type.shape[0]

    def to(self, device) -> "ObjectManager":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if torch.is_tensor(getattr(self, f.name))
        })

    def obj_params(self, obj_id):
        """Per-body object params: one gather of the packed rows."""
        blk = self.body_pack[obj_id.long()]
        return dict(
            inv_m=blk[..., 0], inv_i=blk[..., 1:4],
            mu_s=blk[..., 4], mu_d=blk[..., 5],
            aabb_min=blk[..., 6:9], aabb_max=blk[..., 9:12],
            sphere_radius=blk[..., 12],
            prim_type=blk[..., 13].to(torch.int32),
        )


def _edge_pts(h: geo.HullData, end: int) -> np.ndarray:
    return h.verts[h.edges[:, end]].astype(np.float32)


def _edge_normals(h: geo.HullData, side: int) -> np.ndarray:
    return h.planes[h.edge_faces[:, side], :3].astype(np.float32)


def _face_polys(h: geo.HullData) -> np.ndarray:
    idx = np.clip(h.face_verts, 0, None)
    return h.verts[idx].astype(np.float32)  # [F, FV, 3]


def _pack_hull(h: geo.HullData) -> np.ndarray:
    """Flatten one hull's tables into its [K] float row."""
    parts = [
        h.verts.reshape(-1), h.verts_mask.astype(np.float32),
        h.planes[:, :3].reshape(-1), h.faces_mask.astype(np.float32),
        _edge_pts(h, 0).reshape(-1), _edge_pts(h, 1).reshape(-1),
        _edge_normals(h, 0).reshape(-1), _edge_normals(h, 1).reshape(-1),
        h.edges_mask.astype(np.float32),
        _face_polys(h).reshape(-1),
        (h.face_verts >= 0).astype(np.float32).reshape(-1),
    ]
    return np.concatenate(parts).astype(np.float32)


class ObjectRegistry:
    """Build-time accumulator; ``build()`` packs the tensors (on CPU)."""

    def __init__(self):
        self._rows: List[dict] = []

    def _add(self, **row) -> int:
        self._rows.append(row)
        return len(self._rows) - 1

    def add_sphere(self, radius: float, mass: float = 1.0,
                   mu_s: float = 0.5, mu_d: float = 0.5,
                   response: int = RESPONSE_DYNAMIC) -> int:
        r = float(radius)
        inv_m = 0.0 if response == RESPONSE_STATIC or mass == 0 else 1.0 / mass
        i = 0.4 * mass * r * r          # solid sphere: 2/5 m r^2
        inv_i = 0.0 if inv_m == 0.0 else 1.0 / i
        return self._add(
            prim_type=geo.TYPE_SPHERE, radius=r, hull=None,
            inv_mass=inv_m, inv_inertia=np.full(3, inv_i, np.float32),
            mu_s=mu_s, mu_d=mu_d,
            aabb=(np.full(3, -r, np.float32), np.full(3, r, np.float32)),
        )

    def add_plane(self, mu_s: float = 0.5, mu_d: float = 0.5) -> int:
        """The infinite z=0 plane (normal +z locally). Always static."""
        big = 1e9
        return self._add(
            prim_type=geo.TYPE_PLANE, radius=0.0, hull=None,
            inv_mass=0.0, inv_inertia=np.zeros(3, np.float32),
            mu_s=mu_s, mu_d=mu_d,
            aabb=(np.array([-big, -big, -big], np.float32),
                  np.array([big, big, 0.0], np.float32)),
        )

    def add_hull(self, hull: geo.HullData, mass: float = 1.0,
                 mu_s: float = 0.5, mu_d: float = 0.5,
                 response: int = RESPONSE_DYNAMIC,
                 inertia_diag: Optional[np.ndarray] = None) -> int:
        if response == RESPONSE_STATIC or mass == 0:
            inv_m = 0.0
            inv_i = np.zeros(3, np.float32)
        else:
            inv_m = 1.0 / mass
            if inertia_diag is None:
                m_unit, _com, evals, _ = geo.hull_mass_properties(hull, 1.0)
                inertia_diag = evals * (mass / m_unit)
            inv_i = (1.0 / np.maximum(np.asarray(inertia_diag), 1e-12)
                     ).astype(np.float32)
        v = hull.verts[hull.verts_mask]
        return self._add(
            prim_type=geo.TYPE_HULL, radius=0.0, hull=hull,
            inv_mass=inv_m, inv_inertia=inv_i, mu_s=mu_s, mu_d=mu_d,
            aabb=(v.min(axis=0), v.max(axis=0)),
        )

    def add_box(self, half_extents, mass: float = 1.0,
                mu_s: float = 0.5, mu_d: float = 0.5,
                response: int = RESPONSE_DYNAMIC) -> int:
        he = np.broadcast_to(np.asarray(half_extents, np.float32), (3,))
        inertia = None
        if not (response == RESPONSE_STATIC or mass == 0):
            ex, ey, ez = (2 * he).tolist()           # analytic box inertia
            inertia = np.array(
                [ey * ey + ez * ez, ex * ex + ez * ez, ex * ex + ey * ey],
                np.float32,
            ) * mass / 12.0
        return self.add_hull(
            geo.box_hull(he), mass=mass, mu_s=mu_s, mu_d=mu_d,
            response=response, inertia_diag=inertia,
        )

    def build(self) -> ObjectManager:
        if not self._rows:
            raise ValueError("no objects registered")
        # non-hull objects carry a tiny placeholder hull (never used)
        z_hull = geo.build_hull(
            np.array([[0, 0, 0], [1e-4, 0, 0], [0, 1e-4, 0], [0, 0, 1e-4]],
                     np.float32),
            [[0, 2, 1], [0, 1, 3], [1, 2, 3], [2, 0, 3]],
        )
        hulls = [r["hull"] if r["hull"] is not None else z_hull
                 for r in self._rows]
        # trim the tables to the tightest live counts over all objects
        nv = max(int(h.verts_mask.sum()) for h in hulls)
        nf = max(int(h.faces_mask.sum()) for h in hulls)
        ne = max(int(h.edges_mask.sum()) for h in hulls)
        nfv = max(int((h.face_verts >= 0).sum(axis=1).max()) for h in hulls)
        trimmed = [
            dataclasses.replace(
                h,
                verts=h.verts[:nv], verts_mask=h.verts_mask[:nv],
                planes=h.planes[:nf], faces_mask=h.faces_mask[:nf],
                face_verts=h.face_verts[:nf, :nfv],
                edges=h.edges[:ne], edge_faces=h.edge_faces[:ne],
                edges_mask=h.edges_mask[:ne],
            )
            for h in hulls
        ]
        # unique edge directions of HULL-typed rows only (the placeholder
        # hull's diagonal edges would inflate the app-wide count D)
        dirs = [
            geo.unique_edge_dirs(h) if r["prim_type"] == geo.TYPE_HULL
            else (np.zeros((0, 3), np.float32), np.zeros(ne, np.int32))
            for r, h in zip(self._rows, trimmed)
        ]
        nd = max([1] + [len(d) for d, _ in dirs])

        def dirs_row(d, ids):
            pad = np.zeros((nd, 3), np.float32)
            pad[: len(d)] = d
            m = np.zeros(nd, np.float32)
            m[: len(d)] = 1.0
            return np.concatenate(
                [pad.reshape(-1), m, ids.astype(np.float32)]
            ).astype(np.float32)

        def stack(get):
            return torch.from_numpy(np.stack([get(r) for r in self._rows]))

        def stack_hulls(get):
            return torch.from_numpy(np.stack([get(h) for h in trimmed]))

        body_pack = stack(lambda r: np.concatenate([
            [np.float32(r["inv_mass"])],
            np.asarray(r["inv_inertia"], np.float32),
            [np.float32(r["mu_s"]), np.float32(r["mu_d"])],
            np.asarray(r["aabb"][0], np.float32),
            np.asarray(r["aabb"][1], np.float32),
            [np.float32(r["radius"]), np.float32(r["prim_type"])],
        ]).astype(np.float32))
        return ObjectManager(
            prim_type=stack(lambda r: np.int32(r["prim_type"])),
            inv_mass=stack(lambda r: np.float32(r["inv_mass"])),
            hull_pack=torch.from_numpy(
                np.stack([_pack_hull(h) for h in trimmed])
            ),
            hull_dims=(nv, nf, nfv, ne),
            hull_dirs_pack=torch.from_numpy(
                np.stack([dirs_row(d, ids) for d, ids in dirs])
            ),
            n_edge_dirs=nd,
            body_pack=body_pack,
            hull_planes=stack_hulls(lambda h: h.planes),
            hull_faces_mask=stack_hulls(lambda h: h.faces_mask),
        )
