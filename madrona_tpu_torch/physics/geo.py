"""Collision geometry: convex hulls as padded numpy tables.

Numpy-only copy of ``madrona_tpu/physics/geo.py`` (the port imports
nothing of the JAX package): ``build_hull``, ``box_hull``,
``convex_hull_from_points``, ``hull_mass_properties`` and
``unique_edge_dirs``. A hull is a fixed-capacity padded table of verts,
face planes, face polygons and edges; primitive type codes match the
reference's dispatch encoding (Sphere=1, Hull=2, Plane=4). The hull
builder runs the same float64 numpy steps in the same order as the JAX
package's, so it gives the same ``HullData`` bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

# Capacity budget: sized for box/ramp/frustum-class game geometry (the
# reference's envs use low-poly convex hulls). Raise if an app needs more.
MAX_VERTS = 16
MAX_FACES = 12
MAX_FACE_VERTS = 8
MAX_EDGES = 24

TYPE_NONE = 0
TYPE_SPHERE = 1
TYPE_HULL = 2
TYPE_PLANE = 4


@dataclasses.dataclass
class HullData:
    """One hull in local frame (numpy, build-time)."""

    verts: np.ndarray        # [MAX_VERTS, 3] f32
    verts_mask: np.ndarray   # [MAX_VERTS] bool
    planes: np.ndarray       # [MAX_FACES, 4] f32 (nx, ny, nz, d); x.n = d
    faces_mask: np.ndarray   # [MAX_FACES] bool
    face_verts: np.ndarray   # [MAX_FACES, MAX_FACE_VERTS] i32, -1 pad
    edges: np.ndarray        # [MAX_EDGES, 2] i32 vert indices, 0 pad
    edge_faces: np.ndarray   # [MAX_EDGES, 2] i32 face indices, 0 pad
    edges_mask: np.ndarray   # [MAX_EDGES] bool


def build_hull(verts: np.ndarray, faces: Sequence[Sequence[int]]) -> HullData:
    """Pack an explicit convex polyhedron (verts + CCW face index lists)
    into the padded table format. Faces must wind counter-clockwise viewed
    from outside (same convention the reference's asset pipeline produces
    via ``buildHalfEdgeMesh``, src/physics/physics_assets.cpp)."""
    verts = np.asarray(verts, np.float32)
    nv = len(verts)
    nf = len(faces)
    if nv > MAX_VERTS:
        raise ValueError(f"hull has {nv} verts > MAX_VERTS={MAX_VERTS}")
    if nf > MAX_FACES:
        raise ValueError(f"hull has {nf} faces > MAX_FACES={MAX_FACES}")

    out_verts = np.zeros((MAX_VERTS, 3), np.float32)
    out_verts[:nv] = verts
    verts_mask = np.zeros(MAX_VERTS, bool)
    verts_mask[:nv] = True

    planes = np.zeros((MAX_FACES, 4), np.float32)
    faces_mask = np.zeros(MAX_FACES, bool)
    face_verts = np.full((MAX_FACES, MAX_FACE_VERTS), -1, np.int32)
    for i, f in enumerate(faces):
        f = list(f)
        if len(f) > MAX_FACE_VERTS:
            raise ValueError(
                f"face has {len(f)} verts > MAX_FACE_VERTS={MAX_FACE_VERTS}"
            )
        a, b, c = verts[f[0]], verts[f[1]], verts[f[2]]
        n = np.cross(b - a, c - a)
        norm = np.linalg.norm(n)
        if norm < 1e-12:
            raise ValueError(f"degenerate face {i}")
        n = n / norm
        planes[i, :3] = n
        planes[i, 3] = np.dot(n, a)
        faces_mask[i] = True
        face_verts[i, : len(f)] = f

    # Unique edges + their two adjacent faces (Gauss-map arcs).
    edge_map = {}
    for fi, f in enumerate(faces):
        for k in range(len(f)):
            a, b = f[k], f[(k + 1) % len(f)]
            key = (min(a, b), max(a, b))
            edge_map.setdefault(key, []).append(fi)
    edges = np.zeros((MAX_EDGES, 2), np.int32)
    edge_faces = np.zeros((MAX_EDGES, 2), np.int32)
    edges_mask = np.zeros(MAX_EDGES, bool)
    if len(edge_map) > MAX_EDGES:
        raise ValueError(f"hull has {len(edge_map)} edges > {MAX_EDGES}")
    for i, (key, fs) in enumerate(sorted(edge_map.items())):
        if len(fs) != 2:
            raise ValueError(f"edge {key} borders {len(fs)} faces (not 2)")
        edges[i] = key
        edge_faces[i] = fs
        edges_mask[i] = True

    return HullData(
        verts=out_verts,
        verts_mask=verts_mask,
        planes=planes,
        faces_mask=faces_mask,
        face_verts=face_verts,
        edges=edges,
        edge_faces=edge_faces,
        edges_mask=edges_mask,
    )


def box_hull(half_extents) -> HullData:
    """Axis-aligned box hull; the workhorse shape of the example envs."""
    hx, hy, hz = [float(v) for v in np.broadcast_to(half_extents, (3,))]
    verts = np.array(
        [
            [-hx, -hy, -hz], [hx, -hy, -hz], [hx, hy, -hz], [-hx, hy, -hz],
            [-hx, -hy, hz], [hx, -hy, hz], [hx, hy, hz], [-hx, hy, hz],
        ],
        np.float32,
    )
    faces = [
        [0, 3, 2, 1],  # -z
        [4, 5, 6, 7],  # +z
        [0, 1, 5, 4],  # -y
        [2, 3, 7, 6],  # +y
        [1, 2, 6, 5],  # +x
        [0, 4, 7, 3],  # -x
    ]
    return build_hull(verts, faces)



def convex_hull_from_points(points: np.ndarray) -> HullData:
    """Convex hull of a point cloud (gift-wrapping via incremental method).

    Small-n replacement for the reference asset pipeline's hull builder
    (``RigidBodyAssets::processRigidBodyAssets``,
    src/physics/physics_assets.cpp:556-1030): builds triangle hull then
    merges coplanar faces so SAT sees true n-gon faces.
    """
    points = np.asarray(points, np.float64)
    tri_faces = _incremental_hull(points)
    # merge coplanar neighbors into n-gon faces
    faces = _merge_coplanar(points, tri_faces)
    used = sorted({v for f in faces for v in f})
    remap = {v: i for i, v in enumerate(used)}
    new_faces = [[remap[v] for v in f] for f in faces]
    return build_hull(points[used].astype(np.float32), new_faces)


def _incremental_hull(pts: np.ndarray) -> List[List[int]]:
    n = len(pts)
    if n < 4:
        raise ValueError("need >= 4 points")
    # find 4 non-coplanar starting points
    i0 = 0
    i1 = max(range(n), key=lambda i: np.linalg.norm(pts[i] - pts[i0]))
    i2 = max(
        range(n),
        key=lambda i: np.linalg.norm(
            np.cross(pts[i1] - pts[i0], pts[i] - pts[i0])
        ),
    )
    nrm = np.cross(pts[i1] - pts[i0], pts[i2] - pts[i0])
    i3 = max(range(n), key=lambda i: abs(np.dot(nrm, pts[i] - pts[i0])))
    if abs(np.dot(nrm, pts[i3] - pts[i0])) < 1e-12:
        raise ValueError("degenerate (coplanar) point set")

    if np.dot(nrm, pts[i3] - pts[i0]) > 0:
        faces = [[i0, i2, i1], [i0, i1, i3], [i1, i2, i3], [i2, i0, i3]]
    else:
        faces = [[i0, i1, i2], [i1, i0, i3], [i2, i1, i3], [i0, i2, i3]]

    def face_normal(f):
        a, b, c = pts[f[0]], pts[f[1]], pts[f[2]]
        return np.cross(b - a, c - a)

    for p in range(n):
        if p in (i0, i1, i2, i3):
            continue
        visible = [
            f
            for f in faces
            if np.dot(face_normal(f), pts[p] - pts[f[0]]) > 1e-10
        ]
        if not visible:
            continue
        # horizon edges: edges of visible faces not shared with another
        # visible face
        edge_count = {}
        for f in visible:
            for k in range(3):
                e = (f[k], f[(k + 1) % 3])
                edge_count[e] = edge_count.get(e, 0) + 1
        horizon = [
            e
            for e in edge_count
            if (e[1], e[0]) not in edge_count
        ]
        faces = [f for f in faces if f not in visible]
        for a, b in horizon:
            faces.append([a, b, p])
    return faces


def _merge_coplanar(pts, tri_faces, tol=1e-6):
    def plane_of(f):
        a, b, c = pts[f[0]], pts[f[1]], pts[f[2]]
        nrm = np.cross(b - a, c - a)
        nrm = nrm / np.linalg.norm(nrm)
        return nrm, np.dot(nrm, a)

    groups: List[List[int]] = []
    planes = []
    assigned = [-1] * len(tri_faces)
    for i, f in enumerate(tri_faces):
        nrm, d = plane_of(f)
        for gi, (gn, gd) in enumerate(planes):
            if np.dot(nrm, gn) > 1 - tol and abs(d - gd) < 1e-6 * max(1, abs(gd)) + tol:
                assigned[i] = gi
                break
        if assigned[i] < 0:
            assigned[i] = len(planes)
            planes.append((nrm, d))
            groups.append([])
        groups[assigned[i]].append(i)

    out_faces = []
    for gi, g in enumerate(groups):
        vids = sorted({v for ti in g for v in tri_faces[ti]})
        nrm, _ = planes[gi]
        center = pts[vids].mean(axis=0)
        # order CCW around normal
        ref = pts[vids[0]] - center
        ref = ref - np.dot(ref, nrm) * nrm
        ref /= np.linalg.norm(ref)
        ref2 = np.cross(nrm, ref)
        ang = [
            np.arctan2(np.dot(pts[v] - center, ref2), np.dot(pts[v] - center, ref))
            for v in vids
        ]
        out_faces.append([v for _, v in sorted(zip(ang, vids))])
    return out_faces


def hull_mass_properties(hull: HullData, density: float = 1.0):
    """(mass, center_of_mass, diag inertia in COM frame, rot=identity-ish).

    Tetrahedron decomposition about the origin — same method the
    reference's asset pipeline uses (physics_assets.cpp mass-property
    pass). Returns the inertia of the *principal-axis-aligned* diagonal if
    products of inertia are negligible; otherwise the full 3x3 is
    diagonalized and the rotation returned.
    """
    verts = hull.verts[hull.verts_mask].astype(np.float64)
    total_vol = 0.0
    com = np.zeros(3)
    covariance = np.zeros((3, 3))
    canonical = np.array(
        [[1 / 60, 1 / 120, 1 / 120],
         [1 / 120, 1 / 60, 1 / 120],
         [1 / 120, 1 / 120, 1 / 60]]
    )
    for fi in range(MAX_FACES):
        if not hull.faces_mask[fi]:
            continue
        fv = [v for v in hull.face_verts[fi] if v >= 0]
        for k in range(1, len(fv) - 1):
            a, b, c = (
                hull.verts[fv[0]].astype(np.float64),
                hull.verts[fv[k]].astype(np.float64),
                hull.verts[fv[k + 1]].astype(np.float64),
            )
            m = np.stack([a, b, c], axis=0)
            det = np.linalg.det(m)
            vol = det / 6.0
            total_vol += vol
            com += vol * (a + b + c) / 4.0
            covariance += det * m.T @ canonical @ m
    com = com / total_vol
    mass = density * total_vol
    covariance = density * covariance
    # shift to COM
    covariance -= mass * np.outer(com, com)
    inertia_tensor = np.eye(3) * np.trace(covariance) - covariance
    evals, evecs = np.linalg.eigh(inertia_tensor)
    return float(mass), com.astype(np.float32), evals.astype(np.float32), evecs.astype(np.float32)


def unique_edge_dirs(h: HullData):
    """Unique edge DIRECTIONS of a hull (canonicalized sign, deduped by
    parallelism) + each edge's direction id.

    The edge-edge SAT axis family is {cross(da, db)} over edge
    DIRECTIONS, not edge instances — a box's 12 edges span only 3
    directions, so testing direction pairs shrinks the axis sweep from
    E_a*E_b to D_a*D_b (144 -> 9 for box-box; the reference iterates
    edge pairs with a per-pair Gauss-map test instead,
    src/physics/narrowphase.cpp doSAT edge loop — on TPU the masked
    full sweep pays for every pair, so dedup wins).

    Returns (dirs [D, 3] unit f32, edge_dir_id [E] i32 — id of each
    live edge's direction, 0 for pad edges)."""
    ne = len(h.edges_mask)
    dirs = []
    edge_dir_id = np.zeros(ne, np.int32)
    for i in range(ne):
        if not h.edges_mask[i]:
            continue
        a, b = h.edges[i]
        d = h.verts[b] - h.verts[a]
        n = np.linalg.norm(d)
        if n < 1e-12:
            raise ValueError(f"degenerate edge {i}")
        d = d / n
        # canonical sign: first component with |x| > eps is positive
        for c in d:
            if abs(c) > 1e-9:
                if c < 0:
                    d = -d
                break
        found = -1
        for k, dk in enumerate(dirs):
            if np.linalg.norm(np.cross(dk, d)) < 1e-6:
                found = k
                break
        if found < 0:
            found = len(dirs)
            dirs.append(d.astype(np.float32))
        edge_dir_id[i] = found
    return np.asarray(dirs, np.float32).reshape(-1, 3), edge_dir_id
