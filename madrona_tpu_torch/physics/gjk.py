"""GJK distance queries: the signed-volume simplex solver and a
fixed-iteration loop.

Port of ``madrona_tpu/physics/gjk.py`` (the reference's
``src/physics/gjk.hpp``: Montanari's signed-volume sub-algorithm with
the reference's deviations). The JAX functions take one simplex and are
vmapped; these take any number of leading batch dimensions ``[...]``
and run the same steps on all of them at once:

  * every sub-simplex case is computed and the answer chosen by masks
    (branchless), ties going to the first index (``argmax``/``argmin``);
  * the outer loop runs a fixed iteration count under a convergence
    mask (the vmappable form of the reference's early-exit loop);
  * the simplex keeps its contributing points with a stable sort of
    ``~keep``, so ties keep their order as ``argsort`` does in JAX.

Used for hull-hull and point-hull distance queries; the SAT narrowphase
does not need it.
"""

from __future__ import annotations

import torch

from ..utils import math3d as m3

FLT_MAX = 3.0e38


def _len2(v):
    return m3.dot(v, v)


def _compare_signs(a, b):
    return ((a > 0) & (b > 0)) | ((a < 0) & (b < 0))


def _at(values, idx):
    """values [..., K, *rest] at idx [...] -> [..., *rest]."""
    extra = values.dim() - idx.dim() - 1
    i = idx.long().reshape(idx.shape + (1,) * (extra + 1))
    i = i.expand(idx.shape + (1,) + values.shape[idx.dim() + 1:])
    return torch.take_along_dim(values, i, dim=idx.dim()).squeeze(idx.dim())


def _lams(*cols):
    """Stack per-slot lambdas (tensors or 0.0) into [..., 4]."""
    like = next(c for c in cols if torch.is_tensor(c))
    return torch.stack([c if torch.is_tensor(c) else torch.full_like(like, c)
                        for c in cols], dim=-1)


def solve1(y0):
    lam = torch.zeros(y0.shape[:-1] + (4,), dtype=y0.dtype, device=y0.device)
    lam[..., 0] = 1.0
    return y0, _len2(y0), lam


def solve2(y0, y1):
    """S1D (gjkSolve2Simplex, gjk.hpp:187-256): (v, |v|^2, lambdas in Y
    order [l_y0, l_y1, 0, 0])."""
    s1, s2 = y1, y0
    t = s2 - s1
    t_len2 = torch.clamp(_len2(t), min=1e-30)

    mus = s1 - s2                       # per-coordinate mu
    i_star = torch.argmax(torch.abs(mus), dim=-1)
    mu_max = _at(mus, i_star)
    s1_i = _at(s1, i_star)
    s2_i = _at(s2, i_star)

    po_i = (m3.dot(s2, t) / t_len2) * (s1_i - s2_i) + s2_i
    c1 = po_i - s2_i
    c2 = s1_i - po_i

    inside = _compare_signs(mu_max, c1) & _compare_signs(mu_max, c2)
    lambda2 = c2 / torch.where(mu_max == 0, 1.0, mu_max)
    v = torch.where(inside[..., None], s1 + t * lambda2[..., None], s1)
    lams = torch.where(inside[..., None],
                       _lams(lambda2, 1.0 - lambda2, 0.0, 0.0),
                       _lams(torch.zeros_like(lambda2), 1.0, 0.0, 0.0))
    return v, _len2(v), lams


def _tri_c(po, a, b):
    return (po[..., 0] * a[..., 1] + po[..., 1] * b[..., 0]
            + a[..., 0] * b[..., 1] - po[..., 0] * b[..., 1]
            - po[..., 1] * a[..., 0] - b[..., 0] * a[..., 1])


_PLANES = ((1, 2), (0, 2), (0, 1))     # the 2D coordinates left by a drop


def _pick_best(inside, v_in, d_in, lam_in, cases):
    """The inside answer, else the sub-case of least distance (first on
    ties). cases: [(v, d, lam)]."""
    vs = torch.stack([c[0] for c in cases], dim=-2)
    ds = torch.stack([c[1] for c in cases], dim=-1)
    ls = torch.stack([c[2] for c in cases], dim=-2)
    best = torch.argmin(ds, dim=-1)
    iv = inside[..., None]
    return (torch.where(iv, v_in, _at(vs, best)),
            torch.where(inside, d_in, _at(ds, best)),
            torch.where(iv, lam_in, _at(ls, best)))


def solve3(y0, y1, y2):
    """S2D (gjkSolve3Simplex, gjk.hpp:259-394)."""
    s1, s2, s3 = y2, y1, y0
    n = m3.cross(s2 - s1, s3 - s1)
    n_len2 = torch.clamp(_len2(n), min=1e-30)
    po = m3.dot(s1, n)[..., None] * n / n_len2[..., None]

    def m_cof(drop):
        a, b = _PLANES[drop]
        return (s2[..., a] * s3[..., b] - s3[..., a] * s2[..., b]
                - s1[..., a] * s3[..., b] + s3[..., a] * s1[..., b]
                + s1[..., a] * s2[..., b] - s2[..., a] * s1[..., b])

    ms = torch.stack([m_cof(0), m_cof(1), m_cof(2)], dim=-1)
    drop = torch.argmax(torch.abs(ms), dim=-1)
    mu_max = _at(ms, drop)

    def proj2(p):
        planes = torch.stack([p[..., list(ab)] for ab in _PLANES], dim=-2)
        return _at(planes, drop)

    s1_2, s2_2, s3_2, po_2 = proj2(s1), proj2(s2), proj2(s3), proj2(po)
    c1 = _tri_c(po_2, s2_2, s3_2)
    c2 = _tri_c(po_2, s3_2, s1_2)
    c3 = _tri_c(po_2, s1_2, s2_2)

    cs1 = _compare_signs(mu_max, c1)
    cs2 = _compare_signs(mu_max, c2)
    cs3 = _compare_signs(mu_max, c3)
    inside = cs1 & cs2 & cs3

    safe_mu = torch.where(mu_max == 0, 1.0, mu_max)
    l2 = c2 / safe_mu
    l3 = c3 / safe_mu
    l1 = 1.0 - l2 - l3
    v_face = s1 * l1[..., None] + s2 * l2[..., None] + s3 * l3[..., None]
    lam_face = _lams(l3, l2, l1, 0.0)

    # the sub-cases, each tested where its sign check fails
    v_a, d_a, la = solve2(y0, y2)
    v_b, d_b, lb = solve2(y1, y2)
    v_c, d_c, lc = solve2(y0, y1)
    la = _lams(la[..., 0], 0.0, la[..., 1], 0.0)
    lb = _lams(torch.zeros_like(d_b), lb[..., 0], lb[..., 1], 0.0)
    return _pick_best(inside, v_face, _len2(v_face), lam_face, [
        (v_a, torch.where(cs2, FLT_MAX, d_a), la),
        (v_b, torch.where(cs3, FLT_MAX, d_b), lb),
        (v_c, torch.where(cs1, FLT_MAX, d_c), lc),
    ])


def solve4(y0, y1, y2, y3):
    """S3D (gjkSolve4Simplex, gjk.hpp:396-540)."""
    s1, s2, s3, s4 = y3, y2, y1, y0

    def det3(a, b, c):
        return m3.dot(a, m3.cross(b, c))

    c41 = -det3(s2, s3, s4)
    c42 = det3(s1, s3, s4)
    c43 = -det3(s1, s2, s4)
    c44 = det3(s1, s2, s3)
    det_m = c41 + c42 + c43 + c44

    cs = [_compare_signs(det_m, c) for c in (c41, c42, c43, c44)]
    inside = cs[0] & cs[1] & cs[2] & cs[3]

    safe = torch.where(det_m == 0, 1.0, det_m)
    l1 = c41 / safe
    l2 = c42 / safe
    l3 = c43 / safe
    l4 = 1.0 - l1 - l2 - l3
    v_in = (s1 * l1[..., None] + s2 * l2[..., None] + s3 * l3[..., None]
            + s4 * l4[..., None])
    lam_in = _lams(l4, l3, l2, l1)

    v_a, d_a, la = solve3(y0, y1, y3)
    v_b, d_b, lb = solve3(y0, y2, y3)
    v_c, d_c, lc = solve3(y1, y2, y3)
    v_d, d_d, ld = solve3(y0, y1, y2)
    la = _lams(la[..., 0], la[..., 1], 0.0, la[..., 2])
    lb = _lams(lb[..., 0], 0.0, lb[..., 1], lb[..., 2])
    lc = _lams(torch.zeros_like(d_c), lc[..., 0], lc[..., 1], lc[..., 2])
    return _pick_best(inside, v_in, _len2(v_in), lam_in, [
        (v_a, torch.where(cs[1], FLT_MAX, d_a), la),
        (v_b, torch.where(cs[2], FLT_MAX, d_b), lb),
        (v_c, torch.where(cs[3], FLT_MAX, d_c), lc),
        (v_d, torch.where(cs[0], FLT_MAX, d_d), ld),
    ])


def _solve_simplex(ys, n_y):
    """The answer for the live simplex size (all four solved, one
    chosen). ys [..., 4, 3], n_y [...]."""
    y = [ys[..., k, :] for k in range(4)]
    cases = [solve1(y[0]), solve2(y[0], y[1]), solve3(y[0], y[1], y[2]),
             solve4(*y)]
    i = torch.clamp(n_y - 1, 0, 3)
    return (_at(torch.stack([c[0] for c in cases], dim=-2), i),
            _at(torch.stack([c[1] for c in cases], dim=-1), i),
            _at(torch.stack([c[2] for c in cases], dim=-2), i))


def gjk_distance(support_fn, init_v, max_iters: int = 24,
                 err_tolerance2: float = 1e-10):
    """Distance from the origin to the convex sets given by
    ``support_fn``: support_fn(d [..., 3]) -> the set's point maximizing
    dot(p, -d). Returns (dist2 [...], v [..., 3])."""
    batch = init_v.shape[:-1]
    dev = init_v.device
    v = init_v
    ys = torch.zeros(batch + (4, 3), dtype=torch.float32, device=dev)
    n_y = torch.zeros(batch, dtype=torch.int32, device=dev)
    v_len2 = torch.full(batch, FLT_MAX, dtype=torch.float32, device=dev)
    done = torch.zeros(batch, dtype=torch.bool, device=dev)
    slot = torch.arange(4, device=dev)
    for _ in range(max_iters):
        w = support_fn(v)
        # termination: v . w close enough to |v|^2 (no progress)
        len2 = _len2(v)
        converged = (len2 - m3.dot(v, w)) <= torch.clamp(
            1e-8 * len2, min=err_tolerance2)
        # w goes in front (the reference pushes, then compacts)
        ys_new = torch.cat([w[..., None, :], ys[..., :3, :]], dim=-2)
        n_new = torch.clamp(n_y + 1, max=4)
        v_new, d, lams = _solve_simplex(ys_new, n_new)
        # keep the contributing points (lambda > 0), compacted in order
        keep = (lams > 0.0) & (slot < n_new[..., None])
        order = torch.argsort((~keep).to(torch.int8), dim=-1, stable=True)
        ys_c = torch.take_along_dim(ys_new, order[..., None], dim=-2)
        n_keep = keep.sum(dim=-1, dtype=torch.int32)
        # the origin enclosed: the whole simplex survives with v ~ 0
        enclosed = (n_keep == 4) | (d <= err_tolerance2)
        stay = done
        v = torch.where(stay[..., None], v, v_new)
        ys = torch.where(stay[..., None, None], ys, ys_c)
        n_y = torch.where(stay, n_y, n_keep)
        v_len2 = torch.where(stay, v_len2,
                             torch.where(enclosed, 0.0, d))
        done = done | converged | enclosed
    return v_len2, v


def hull_support(verts, mask):
    """Support function of vertex clouds verts [..., V, 3] (mask
    [..., V]): the vertex of largest dot with -v (first on ties)."""
    def fn(v):
        dots = m3.dot(verts, (-v)[..., None, :])
        dots = torch.where(mask, dots, -FLT_MAX)
        return _at(verts, torch.argmax(dots, dim=-1))

    return fn


def _first_live(verts, mask):
    return _at(verts, torch.argmax(mask.to(torch.int8), dim=-1))


def hull_closest_point_to_origin(verts, mask, max_iters: int = 24):
    """hullClosestPointToOriginGJK: (dist2 [...], closest point
    [..., 3])."""
    return gjk_distance(hull_support(verts, mask), _first_live(verts, mask),
                        max_iters)


def hull_hull_distance2(a_verts, a_mask, b_verts, b_mask,
                        max_iters: int = 24):
    """Squared distance between convex vertex clouds (0 where they
    intersect): GJK on the Minkowski difference A - B."""
    sa = hull_support(a_verts, a_mask)
    sb = hull_support(b_verts, b_mask)

    def support(v):
        return sa(v) - sb(-v)

    init = _first_live(a_verts, a_mask) - _first_live(b_verts, b_mask)
    d2, _ = gjk_distance(support, init, max_iters)
    return d2
