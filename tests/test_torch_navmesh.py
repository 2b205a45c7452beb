"""The port's navmesh (madrona_tpu_torch/utils/navmesh.py) against the JAX
package's (madrona_tpu/utils/navmesh.py), on the CPU.

Two meshes, both built from the same numpy rows on both sides: the 4 x
2 unit grid of tests/test_navmesh.py and a random convex-polygon mesh
(a jittered grid of quads, some split in two triangles; numpy seed 3).

  * build tables equal (every field, bit for bit);
  * 4000 keys: ``sample_point``'s triangles equal, points within 2e-6
    (XLA's CPU contracts the barycentric sum to fused multiply-adds);
  * ``locate`` equal on 1000 points;
  * ``shortest_dists`` within 1e-6, relative, from every triangle;
  * ``next_hop`` equal at every (start, goal) pair;
  * the JAX test's statistics: every triangle of the equal-area grid
    drawn more than 0.6 x its share, next_hop walks reach the goal with
    the distance falling at every hop.

The JAX queries are the JAX module's own, vmapped and jitted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu.utils import navmesh as j_nm
from madrona_tpu.utils import rng as j_rng
from madrona_tpu_torch.utils import navmesh as t_nm
from madrona_tpu_torch.utils import rng as t_rng

torch.set_num_threads(1)

N_KEYS = 4000
N_POINTS = 1000


def grid_rows(nx=4, ny=2):
    """tests/test_navmesh.py's nx x ny unit-square grid of quads."""
    verts = np.array([[x, y, 0.0] for y in range(ny + 1)
                      for x in range(nx + 1)], np.float32)
    idx = lambda x, y: y * (nx + 1) + x  # noqa: E731
    polys, sizes = [], []
    for y in range(ny):
        for x in range(nx):
            polys += [idx(x, y), idx(x + 1, y), idx(x + 1, y + 1),
                      idx(x, y + 1)]
            sizes.append(4)
    return verts, polys, sizes


def random_rows(seed=3, nx=5, ny=4):
    """A jittered grid (interior vertices moved by up to 0.3, so every
    quad stays convex), each cell a quad or two triangles."""
    rs = np.random.RandomState(seed)
    verts = np.array([[x, y, 0.0] for y in range(ny + 1)
                      for x in range(nx + 1)], np.float32)
    inner = ((verts[:, 0] > 0) & (verts[:, 0] < nx) & (verts[:, 1] > 0)
             & (verts[:, 1] < ny))
    verts[inner, :2] += rs.uniform(-0.3, 0.3, (int(inner.sum()), 2))
    verts[:, 2] = rs.uniform(0, 0.1, len(verts))
    idx = lambda x, y: y * (nx + 1) + x  # noqa: E731
    polys, sizes = [], []
    for y in range(ny):
        for x in range(nx):
            q = [idx(x, y), idx(x + 1, y), idx(x + 1, y + 1), idx(x, y + 1)]
            if rs.rand() < 0.4:
                polys += q[:3] + [q[0], q[2], q[3]]
                sizes += [3, 3]
            else:
                polys += q
                sizes.append(4)
    return verts, polys, sizes


MESHES = {"grid": grid_rows, "random": random_rows}


@pytest.fixture(scope="module", params=list(MESHES))
def meshes(request):
    rows = MESHES[request.param]()
    return request.param, j_nm.build_navmesh(*rows), \
        t_nm.build_navmesh(*rows, device="cpu")


def test_tables_and_sample_point_match(meshes):
    name, jm, tm = meshes
    for f in ("verts", "tris", "adjacency", "centroids", "alias_tau",
              "alias_idx", "areas"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)), err_msg=f)
    k0 = j_rng.key(jnp.uint32(0))
    j_keys = jax.vmap(lambda i: j_rng.split_i(k0, i))(
        jnp.arange(N_KEYS, dtype=jnp.uint32))
    j_pts, j_tris = jax.jit(jax.vmap(jm.sample_point))(j_keys)
    t_keys = t_rng.split_i(t_rng.key(0), torch.arange(N_KEYS))
    np.testing.assert_array_equal(t_keys.numpy(),
                                  np.asarray(j_keys).astype(np.int64))
    t_pts, t_tris = tm.sample_point(t_keys)
    np.testing.assert_array_equal(t_tris.numpy(), np.asarray(j_tris))
    np.testing.assert_allclose(t_pts.numpy(), np.asarray(j_pts), rtol=0,
                               atol=2e-6)
    if name == "grid":      # tests/test_navmesh.py's statistics
        pts = t_pts.numpy()
        assert (pts[:, 0] >= 0).all() and (pts[:, 0] <= 4).all()
        assert (pts[:, 1] >= 0).all() and (pts[:, 1] <= 2).all()
        counts = np.bincount(t_tris.numpy(), minlength=tm.num_tris)
        assert counts.min() > N_KEYS / tm.num_tris * 0.6, counts


def test_locate_matches(meshes):
    _, jm, tm = meshes
    rs = np.random.RandomState(5)
    lo = tm.verts.numpy().min(0) - 0.5
    hi = tm.verts.numpy().max(0) + 0.5
    pts = rs.uniform(lo, hi, (N_POINTS, 3)).astype(np.float32)
    j_tri = jax.jit(jax.vmap(jm.locate))(jnp.asarray(pts))
    np.testing.assert_array_equal(tm.locate(torch.from_numpy(pts)).numpy(),
                                  np.asarray(j_tri))


def test_shortest_dists_match(meshes):
    _, jm, tm = meshes
    starts = np.arange(tm.num_tris)
    j_d = np.asarray(jax.jit(jax.vmap(jm.shortest_dists))(
        jnp.asarray(starts, jnp.int32)))
    t_d = tm.shortest_dists(torch.from_numpy(starts)).numpy()
    assert np.isfinite(j_d).all()
    np.testing.assert_allclose(t_d, j_d, rtol=1e-6, atol=0)


def test_next_hop_matches_every_pair(meshes):
    _, jm, tm = meshes
    t = tm.num_tris
    s, g = np.meshgrid(np.arange(t), np.arange(t), indexing="ij")
    s, g = s.ravel(), g.ravel()
    j_hop = jax.jit(jax.vmap(jm.next_hop))(jnp.asarray(s, jnp.int32),
                                           jnp.asarray(g, jnp.int32))
    t_hop = tm.next_hop(torch.from_numpy(s), torch.from_numpy(g))
    np.testing.assert_array_equal(t_hop.numpy(), np.asarray(j_hop))
    # tests/test_navmesh.py's walk: the distance to the goal falls at
    # every hop and the walk ends at the goal
    dists = tm.shortest_dists(torch.from_numpy(g))
    cur = torch.from_numpy(s)
    goal = torch.from_numpy(g)
    for _ in range(t):
        nxt = tm.next_hop(cur, goal, dists=dists)
        moved = nxt != cur
        d = torch.gather(dists, -1, torch.stack([cur, nxt], -1))
        assert bool((d[moved, 1] < d[moved, 0]).all())
        cur = nxt
    assert torch.equal(cur, goal)
