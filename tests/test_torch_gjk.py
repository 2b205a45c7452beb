"""GJK of the PyTorch port against the JAX package (tests/test_gjk.py).

The same inputs, made with numpy from a seed, go through the JAX
functions (vmapped, jitted) and the port's (batched over the leading
axis):
  * solve1..solve4 on 512 random simplices: v and |v|^2 within 1e-5,
    the lambdas within 1e-5 (the same sub-simplex chosen);
  * hull_hull_distance2 on 256 random vertex-cloud pairs (8 points, some
    masked out), separated and overlapping, and
    hull_closest_point_to_origin on 256 clouds: squared distances within
    1e-5 (relative, floored at 1; JAX's own tests allow 1e-4), closest
    points within 1e-3 (JAX's own test's bound: GJK stops once |v|^2
    improves by under 1e-8 of itself, which leaves v that far open);
  * the reference's captured hard cases (tests/gjk.cpp) and
    tests/test_gjk.py's analytic distances, on the port alone;
  * tests/test_gjk.py:90's cross-check of the SAT narrowphase's
    separation against the GJK distance on random box pairs, on the port
    alone, with its bounds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu.physics import gjk as jgjk
from madrona_tpu_torch.physics import bodies as tbodies
from madrona_tpu_torch.physics import gjk as tgjk
from madrona_tpu_torch.physics import narrowphase as tnp

torch.set_num_threads(1)

TOL = 1e-5
N_SIMPLEX = 512
N_PAIRS = 256


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_simplex_solvers_match_jax(k):
    # simplices in general position: where points repeat, the signed
    # volumes are rounding noise and the sub-simplex choice with them
    # (the captured duplicate-point case is held below, on the port)
    rs = np.random.RandomState(10 + k)
    y = rs.randn(N_SIMPLEX, k, 3).astype(np.float32)
    fn = {1: jgjk.solve1, 2: jgjk.solve2, 3: jgjk.solve3, 4: jgjk.solve4}[k]
    jv, jd, jl = jax.jit(jax.vmap(fn))(*[jnp.asarray(y[:, i])
                                          for i in range(k)])
    tfn = {1: tgjk.solve1, 2: tgjk.solve2, 3: tgjk.solve3,
           4: tgjk.solve4}[k]
    tv, td, tl = tfn(*[_t(y[:, i]) for i in range(k)])
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)


def _clouds(rs, n, offset):
    """n pairs of 8-point clouds; cloud b shifted by ``offset`` times a
    random unit direction; 0-2 points of each cloud masked out."""
    a = rs.uniform(-1, 1, (n, 8, 3)).astype(np.float32)
    b = rs.uniform(-1, 1, (n, 8, 3)).astype(np.float32)
    d = rs.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    b += (offset * d[:, None, :]).astype(np.float32)
    am = np.ones((n, 8), bool)
    bm = np.ones((n, 8), bool)
    am[np.arange(n), rs.randint(0, 8, n)] = rs.rand(n) < 0.5
    bm[np.arange(n), rs.randint(0, 8, n)] = rs.rand(n) < 0.5
    bm[:, 0] = True
    return a, am, b, bm


@pytest.mark.parametrize("case, offset", [("separated", 4.0),
                                          ("overlapping", 0.6)])
def test_hull_distances_match_jax(case, offset):
    rs = np.random.RandomState(3 if case == "separated" else 4)
    a, am, b, bm = _clouds(rs, N_PAIRS, offset)
    jd2 = np.asarray(jax.jit(jax.vmap(jgjk.hull_hull_distance2))(
        jnp.asarray(a), jnp.asarray(am), jnp.asarray(b), jnp.asarray(bm)))
    td2 = tgjk.hull_hull_distance2(_t(a), torch.from_numpy(am), _t(b),
                                   torch.from_numpy(bm)).numpy()
    scale = np.maximum(np.abs(jd2), 1.0)
    assert (np.abs(td2 - jd2) / scale).max() <= TOL
    if case == "separated":
        assert (jd2 > 0.1).all()
    else:
        assert (jd2 <= 1e-6).sum() > N_PAIRS // 2

    # the closest point of cloud b (offset from the origin) to the origin
    jc2, jv = jax.jit(jax.vmap(jgjk.hull_closest_point_to_origin))(
        jnp.asarray(b), jnp.asarray(bm))
    tc2, tv = tgjk.hull_closest_point_to_origin(_t(b), torch.from_numpy(bm))
    jc2 = np.asarray(jc2)
    scale = np.maximum(np.abs(jc2), 1.0)
    assert (np.abs(tc2.numpy() - jc2) / scale).max() <= TOL
    live = jc2 > 0.0
    np.testing.assert_allclose(tv.numpy()[live], np.asarray(jv)[live],
                               rtol=0, atol=1e-3)


def test_reference_hard_cases_and_analytic_distances():
    """tests/test_gjk.py's cases on the port: the captured simplices of
    tests/gjk.cpp and the box distances."""
    y = _t([[0.814353108, 0.195752025, -0.698764443],
            [-0.784147143, 0.126484752, 0.701235533],
            [-0.784147143, 0.126484752, -0.698764443],
            [-0.784147143, 0.126484752, 0.701235533]])
    _, d3, _ = tgjk.solve3(y[0], y[1], y[2])
    _, d4, _ = tgjk.solve4(y[0], y[1], y[2], y[3])
    assert float(d4) - float(d3) <= 1e-5
    y = _t([[0.793287277, 2.86326122, -0.700307727],
            [-0.794485092, -0.542466521, 0.699692249],
            [0.80550468, -0.536717057, -0.700307727],
            [-0.794485092, -0.542466521, -0.700307727]])
    v, d, _ = tgjk.solve4(y[0], y[1], y[2], y[3])
    assert np.abs(v.numpy()).max() < 1e-5 and float(d) < 1e-5

    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)], np.float32)
    mask = torch.ones((1, 8), dtype=torch.bool)

    def box(center):
        return _t(corners + np.asarray(center, np.float32))[None]

    d2, v = tgjk.hull_closest_point_to_origin(box([3.0, 0, 0]), mask)
    np.testing.assert_allclose(float(d2), 4.0, rtol=1e-4)
    np.testing.assert_allclose(v.numpy()[0], [2.0, 0, 0], atol=1e-3)
    got = [float(tgjk.hull_hull_distance2(box([0, 0, 0]), mask, box(c),
                                          mask))
           for c in ([5.0, 0, 0], [3.0, 3.0, 0.0], [1.0, 0.5, 0.0])]
    np.testing.assert_allclose(got[:2], [9.0, 2.0], rtol=1e-3)
    assert got[2] <= 1e-6


def test_sat_separation_matches_gjk_distance():
    """tests/test_gjk.py:90 on the port: for separated box pairs the SAT
    separation is a lower bound of the GJK distance, equal where face or
    edge pairs are closest; overlapping pairs have GJK distance 0."""
    reg = tbodies.ObjectRegistry()
    reg.add_box([1.0, 0.8, 0.6], mass=1.0)
    om = reg.build()
    rs = np.random.RandomState(3)
    pos_b, q_b = [], []
    for _ in range(30):
        pos_b.append(rs.randn(3) * 4.0)
        axis = rs.randn(3)
        axis /= np.linalg.norm(axis)
        ang = rs.rand() * np.pi
        q_b.append([np.cos(ang / 2), *(np.sin(ang / 2) * axis)])
    n = len(pos_b)
    ident = torch.tensor([[1.0, 0, 0, 0]]).expand(n, 4)
    one = torch.ones((n, 3))
    ha = tnp.hull_to_world(om, 0, torch.zeros((n, 3)), ident, one)
    hb = tnp.hull_to_world(om, 0, _t(pos_b), _t(q_b), one)
    sep_a, _ = tnp.query_face_directions(ha, hb)
    sep_b, _ = tnp.query_face_directions(hb, ha)
    sep_e = tnp.query_edge_directions(ha, hb)[0]
    sat = torch.maximum(torch.maximum(sep_a, sep_b), sep_e).numpy()
    d2 = tgjk.hull_hull_distance2(ha.verts, ha.verts_mask, hb.verts,
                                  hb.verts_mask).numpy()
    dist = np.sqrt(d2)
    sep = sat > 1e-3
    assert (sat[sep] <= dist[sep] * (1 + 2e-3) + 2e-4).all()
    checked = (np.abs(sat - dist) <= 1e-2 * np.maximum(dist, 1.0)) & sep
    assert checked.sum() >= 8, checked.sum()
    assert (d2[~sep] <= 1e-5).all()
