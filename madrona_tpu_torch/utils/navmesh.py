"""Navmesh: triangle nav queries, alias-table sampling, shortest paths.

Port of ``madrona_tpu/utils/navmesh.py`` (the reference's
``include/madrona/navmesh.hpp``, ``src/common/navmesh.cpp``).
Construction is the same host-side numpy: convex polygons are fan
triangulated, edge adjacency comes from shared edges, and a Vose alias
table samples triangles by area. :class:`Navmesh` holds the tables as
tensors on an explicit device.

The queries are batched over leading axes (the JAX module answers one
key, point or triangle and is vmapped by its callers):

  * :meth:`Navmesh.sample_point` draws the JAX module's Threefry words
    (``utils/rng.split_i`` at 0..3 of each key);
  * :meth:`Navmesh.locate` is a masked point-in-triangle sweep, the
    nearest centroid where no triangle holds the point;
  * :meth:`Navmesh.shortest_dists` is Bellman-Ford over the centroid
    graph: at most T - 1 relaxations, stopped once a relaxation changes
    nothing (a fixed point, so the distances are those of all T - 1);
  * :meth:`Navmesh.next_hop` takes the first step of a shortest path,
    and returns the start at the goal or where the goal is unreachable.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.device import resolve_device
from . import rng as _rng

# relaxations between two checks of the fixed point (each check is one
# host read)
_FIXED_POINT_EVERY = 32


def _norm(v):
    """Euclidean length over the last axis of 3, summed left to right,
    its square root correctly rounded: taken in float64 and rounded once
    to float32 (torch's float32 sqrt on the CPU can miss by an ulp, which
    tips the next hop's ties on a regular grid)."""
    s = (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2]
    return torch.sqrt(s.double()).float()


@dataclasses.dataclass
class Navmesh:
    """Baked navmesh tables (tensors on one device; static per app)."""

    verts: torch.Tensor        # [V, 3] float32
    tris: torch.Tensor         # [T, 3] int64 vertex indices
    adjacency: torch.Tensor    # [T, 3] int64 neighbour tri per edge (-1)
    centroids: torch.Tensor    # [T, 3] float32
    alias_tau: torch.Tensor    # [T] float32 alias-table thresholds
    alias_idx: torch.Tensor    # [T] int64 alias targets
    areas: torch.Tensor        # [T] float32

    @property
    def num_tris(self) -> int:
        return self.tris.shape[0]

    @property
    def device(self) -> torch.device:
        return self.verts.device

    # ----------------------------------------------------------- sampling

    def sample_point(self, keys):
        """Uniform-by-area points (samplePointAndPoly, navmesh.inl).
        keys [..., 2] Threefry keys. Returns (points [..., 3] float32,
        triangles [...] int64)."""
        t = self.num_tris
        u = _rng.sample_uniform(_rng.split_i(keys, 0))
        slot = torch.clamp((u * t).to(torch.int64), max=t - 1)
        take_alias = _rng.sample_uniform(_rng.split_i(keys, 1)) \
            > self.alias_tau[slot]
        tri = torch.where(take_alias, self.alias_idx[slot], slot)
        # uniform barycentric coordinates (the sqrt method)
        su = torch.sqrt(_rng.sample_uniform(_rng.split_i(keys, 2)))[..., None]
        u2 = _rng.sample_uniform(_rng.split_i(keys, 3))[..., None]
        a, b, c = (self.verts[self.tris[tri, i]] for i in range(3))
        return (1 - su) * a + su * (1 - u2) * b + su * u2 * c, tri

    # ----------------------------------------------------------- location

    def locate(self, points):
        """The triangle holding each point's (x, y) projection, else the
        one of the nearest centroid. points [..., 3]; returns [...]
        int64."""
        p = points[..., None, :2]                          # [..., 1, 2]
        corners = [self.verts[self.tris[:, i]][:, :2] for i in range(3)]

        def edge(p0, p1):
            d = p1 - p0
            return (d[:, 0] * (p[..., 1] - p0[:, 1])
                    - d[:, 1] * (p[..., 0] - p0[:, 0]))       # [..., T]

        e0 = edge(corners[0], corners[1])
        e1 = edge(corners[1], corners[2])
        e2 = edge(corners[2], corners[0])
        inside = ((e0 >= 0) & (e1 >= 0) & (e2 >= 0)) | (
            (e0 <= 0) & (e1 <= 0) & (e2 <= 0))
        d = self.centroids - points[..., None, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
            + d[..., 2] * d[..., 2]
        score = torch.where(inside, torch.full_like(d2, -1.0), d2)
        return torch.argmin(score, dim=-1)

    # -------------------------------------------------------------- paths

    def _edge_weights(self):
        """[T, 3] centroid distance to each neighbour (inf: none)."""
        nbr = self.adjacency
        w = _norm(self.centroids[nbr.clamp(min=0)]
                  - self.centroids[:, None, :])
        return torch.where(nbr >= 0, w, torch.full_like(w, float("inf")))

    def shortest_dists(self, start_tris):
        """Centroid-graph distances from each start triangle to every
        triangle (dijkstrasFromPoly's answer): start_tris [...] ->
        [..., T] float32, inf where unreachable."""
        t = self.num_tris
        start = torch.as_tensor(start_tris, device=self.device).long()
        nbr = self.adjacency.clamp(min=0)
        has = self.adjacency >= 0
        w_edge = self._edge_weights()
        inf = torch.tensor(float("inf"), device=self.device)
        dist = torch.full(start.shape + (t,), float("inf"),
                          device=self.device)
        dist.scatter_(-1, start[..., None], 0.0)
        for i in range(t - 1):
            via = torch.where(has, dist[..., nbr] + w_edge, inf)
            new = torch.minimum(dist, via.min(dim=-1).values)
            if (i + 1) % _FIXED_POINT_EVERY == 0 and torch.equal(new, dist):
                return new
            dist = new
        return dist

    def next_hop(self, start_tri, goal_tri, dists=None):
        """First adjacency step of the shortest start -> goal path (the
        query bfsFromPoly serves in the reference's envs): the neighbour
        n minimizing edge_weight(start, n) + dist(n, goal). Returns the
        start at the goal or where the goal is unreachable, never the -1
        sentinel. start_tri, goal_tri [...] (broadcast); ``dists``:
        ``shortest_dists(goal_tri)`` where the caller has it already."""
        dev = self.device
        start = torch.as_tensor(start_tri, device=dev).long()
        goal = torch.as_tensor(goal_tri, device=dev).long()
        start, goal = torch.broadcast_tensors(start, goal)
        if dists is None:
            dists = self.shortest_dists(goal)
        nbr = self.adjacency[start]                        # [..., 3]
        nbr_c = nbr.clamp(min=0)
        w_edge = _norm(self.centroids[nbr_c]
                       - self.centroids[start][..., None, :])
        cand = torch.where(nbr >= 0, w_edge + torch.gather(dists, -1, nbr_c),
                           torch.full_like(w_edge, float("inf")))
        best = torch.argmin(cand, dim=-1, keepdim=True)
        done = (start == goal) | ~torch.isfinite(
            torch.gather(cand, -1, best)[..., 0])
        return torch.where(done, start, torch.gather(nbr, -1, best)[..., 0])


def build_navmesh(poly_vertices, poly_idxs, poly_sizes=None,
                  device=None) -> Navmesh:
    """initFromPolygons: fan-triangulate convex polygons, derive edge
    adjacency, build the alias table (navmesh.cpp:123+); the tables on
    ``device`` (default: the card, ``core/device.resolve_device``)."""
    dev = resolve_device(device)
    verts = np.asarray(poly_vertices, np.float32)
    if poly_sizes is None:  # already triangles
        tris = np.asarray(poly_idxs, np.int64).reshape(-1, 3)
    else:
        tris = []
        off = 0
        flat = np.asarray(poly_idxs, np.int64)
        for sz in poly_sizes:
            for k in range(1, sz - 1):
                tris.append((flat[off], flat[off + k], flat[off + k + 1]))
            off += sz
        tris = np.asarray(tris, np.int64)

    t = len(tris)
    # adjacency via shared (undirected) edges
    edge_map = {}
    adjacency = np.full((t, 3), -1, np.int64)
    for ti, (i, j, k) in enumerate(tris):
        for e, (a, b) in enumerate(((i, j), (j, k), (k, i))):
            key = (min(a, b), max(a, b))
            if key in edge_map:
                tj, ej = edge_map[key]
                adjacency[ti, e] = tj
                adjacency[tj, ej] = ti
            else:
                edge_map[key] = (ti, e)

    # areas + alias table (Vose)
    va = verts[tris[:, 0]]
    vb = verts[tris[:, 1]]
    vc = verts[tris[:, 2]]
    areas = 0.5 * np.linalg.norm(
        np.cross(vb - va, vc - va), axis=-1
    ).astype(np.float64)
    p = areas / areas.sum() * t
    tau = np.ones(t, np.float32)
    alias = np.arange(t, dtype=np.int64)
    small = [i for i in range(t) if p[i] < 1.0]
    large = [i for i in range(t) if p[i] >= 1.0]
    p = p.copy()
    while small and large:
        s = small.pop()
        l = large.pop()  # noqa: E741
        tau[s] = p[s]
        alias[s] = l
        p[l] = p[l] - (1.0 - p[s])
        (small if p[l] < 1.0 else large).append(l)

    centroids = (va + vb + vc) / 3.0

    def t_(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).to(dev)

    return Navmesh(
        verts=t_(verts, torch.float32),
        tris=t_(tris, torch.int64),
        adjacency=t_(adjacency, torch.int64),
        centroids=t_(centroids, torch.float32),
        alias_tau=t_(tau, torch.float32),
        alias_idx=t_(alias, torch.int64),
        areas=t_(areas, torch.float32),
    )
