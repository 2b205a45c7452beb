"""Narrowphase: batched SAT contact generation for candidate pairs.

Port of ``madrona_tpu/physics/narrowphase.py`` (the reference's
``src/physics/narrowphase.cpp``): the hull-hull lane in both SAT tiers,
the hull-plane lane and the three sphere lanes. Every function takes a
leading batch axis B (one lane per candidate pair, all worlds
flattened) and computes fixed-shape masked reductions over padded hull
tables; argmax winners are read back with index gathers. These are the
plain versions of the narrowphase device functions of the CUDA kernels
(``csrc/sat.cuh``), which repeat their sums in the same order.

Algorithm (unchanged from the JAX package):
  * face query: max over A's faces of (min over B's verts of signed
    distance), both ways;
  * edge query, ``sat_tier="edge_dirs"``: over unique edge DIRECTION
    pairs, with a 1e-5 face preference under near-ties (the direction
    family contains axes equal to face normals);
  * edge query, ``sat_tier="edge_pairs"``: over every edge pair that
    passes the Gauss-map (Minkowski-face) test, with a strict face
    compare;
  * face manifold: the incident polygon clipped by the ref face's side
    planes (its vertex set computed directly), points below the ref
    plane projected onto it, reduced to <= 4 points;
  * edge manifold: closest point on A's winning edge;
  * hull-plane and sphere-plane: the plane is always the reference;
  * sphere-sphere and sphere-hull: the second body is the reference;
    sphere-hull takes the closest of the hull's vertices, edges and face
    interiors, or the face of least penetration when the center is
    inside.

Contact points lie on the REF body's surface; the normal points
ref -> other.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..utils import math3d as m3
from .xpbd import gather_rows

NEG_BIG = -3.0e38
BIG = 3.0e38


@dataclasses.dataclass
class HullW:
    """A batch of hulls in world space: [B, ...] tensors."""

    verts: torch.Tensor           # [B, V, 3]
    verts_mask: torch.Tensor      # [B, V] bool
    planes_n: torch.Tensor        # [B, F, 3]
    planes_d: torch.Tensor        # [B, F]
    faces_mask: torch.Tensor      # [B, F] bool
    edge_p1: torch.Tensor         # [B, E, 3]
    edge_p2: torch.Tensor         # [B, E, 3]
    edges_mask: torch.Tensor      # [B, E] bool
    face_polys: torch.Tensor      # [B, F, FV, 3]
    face_poly_mask: torch.Tensor  # [B, F, FV] bool
    center: torch.Tensor          # [B, 3]
    # world normals of each edge's two faces (edge_pairs tier)
    edge_n1: Optional[torch.Tensor] = None         # [B, E, 3]
    edge_n2: Optional[torch.Tensor] = None         # [B, E, 3]
    # unique edge directions in world frame (scaled + rotated, not unit)
    edge_dirs: Optional[torch.Tensor] = None       # [B, D, 3]
    edge_dirs_mask: Optional[torch.Tensor] = None  # [B, D] bool
    edge_dir_id: Optional[torch.Tensor] = None     # [B, E] f32


def hull_to_world(om, obj_idx, pos, rot, scale) -> HullW:
    """Object ``obj_idx``'s hull (an int, or one per lane [B]) in world
    space at (pos [B, 3], rot [B, 4], scale [B, 3]), with the edges'
    face normals (the edge_pairs query reads them)."""
    idx = torch.as_tensor(obj_idx, device=pos.device).long()
    row = torch.broadcast_to(om.hull_pack[idx], (pos.shape[0],
                                                 om.hull_pack.shape[1]))
    return hull_row_to_world(row, om.hull_dims, pos, rot, scale,
                             edge_normals=True)


def hull_row_to_world(row, dims, pos, rot, scale, need_edges: bool = True,
                      dirs_row=None, n_dirs: int = 0,
                      edge_normals: bool = False) -> HullW:
    """Unpack packed hull rows [B, K] and transform them by
    (pos [B, 3], rot [B, 4], scale [B, 3]). Normals are re-derived to
    stay valid under non-uniform scale: n' ~ R (n / scale).
    need_edges=False skips the edge transforms (hull-plane lanes);
    edge_normals=True adds the edges' face normals (edge_pairs tier)."""
    v, f, fv, e = dims
    b = row.shape[0]
    off = 0

    def cut(k, shape):
        nonlocal off
        out = row[:, off:off + k].reshape((b,) + shape)
        off += k
        return out

    verts_l = cut(v * 3, (v, 3))
    vm = cut(v, (v,)) > 0.5
    planes_nl = cut(f * 3, (f, 3))
    faces_mask = cut(f, (f,)) > 0.5
    edge_p1l = cut(e * 3, (e, 3))
    edge_p2l = cut(e * 3, (e, 3))
    edge_n1l = cut(e * 3, (e, 3))   # adjacent-face normals
    edge_n2l = cut(e * 3, (e, 3))
    edges_mask = cut(e, (e,)) > 0.5
    face_polys_l = cut(f * fv * 3, (f * fv, 3))
    face_poly_mask = cut(f * fv, (f, fv)) > 0.5

    rot_b = rot[:, None, :]
    scale_b = scale[:, None, :]

    def xform_pt(p):
        return m3.quat_rotate(rot_b, p * scale_b) + pos[:, None, :]

    def xform_n(n):
        return m3.normalize(
            m3.quat_rotate(rot_b, n / torch.clamp(scale_b, min=1e-12))
        )

    verts = xform_pt(verts_l)
    n_w = xform_n(planes_nl)
    face_polys = xform_pt(face_polys_l).reshape(b, f, fv, 3)
    # plane d from the face's first polygon vertex (always live)
    d_w = m3.dot(n_w, face_polys[:, :, 0, :])
    denom = torch.clamp(vm.sum(dim=1), min=1)
    # summed vertex by vertex, in index order: the contacts kernel repeats
    # this order (a reduction's order is the library's to choose)
    live_verts = torch.where(vm[..., None], verts, 0.0)
    center = live_verts[:, 0]
    for i in range(1, v):
        center = center + live_verts[:, i]
    center = center / denom[:, None]
    dirs_kw = {}
    if dirs_row is not None and n_dirs:
        d = n_dirs
        dirs_kw = dict(
            # scaled edge direction = R (S d), unnormalized
            edge_dirs=m3.quat_rotate(
                rot_b, dirs_row[:, : 3 * d].reshape(b, d, 3) * scale_b
            ),
            edge_dirs_mask=dirs_row[:, 3 * d: 4 * d] > 0.5,
            edge_dir_id=dirs_row[:, 4 * d: 4 * d + e],
        )
    if need_edges and edge_normals:
        dirs_kw.update(edge_n1=xform_n(edge_n1l), edge_n2=xform_n(edge_n2l))
    return HullW(
        verts=verts, verts_mask=vm, planes_n=n_w, planes_d=d_w,
        faces_mask=faces_mask,
        edge_p1=xform_pt(edge_p1l) if need_edges else edge_p1l,
        edge_p2=xform_pt(edge_p2l) if need_edges else edge_p2l,
        edges_mask=edges_mask, face_polys=face_polys,
        face_poly_mask=face_poly_mask, center=center, **dirs_kw,
    )


def _pick(values, idx):
    """values [B, K, ...] at idx [B] -> [B, ...]."""
    return values[torch.arange(values.shape[0], device=values.device), idx]


def _first_true(mask):
    """Index of the first True per row (0 if none), as argmax does."""
    return torch.argmax(mask.to(torch.float32), dim=1)


def query_face_directions(a: HullW, b: HullW):
    """(max separation, face index) of A's faces against B's verts."""
    d = (
        m3.dot(b.verts[:, :, None, :], a.planes_n[:, None, :, :])
        - a.planes_d[:, None, :]
    )                                                      # [B, V, F]
    d = torch.where(b.verts_mask[:, :, None], d, BIG)
    seps = torch.where(a.faces_mask, d.amin(dim=1), NEG_BIG)
    return seps.amax(dim=1), torch.argmax(seps, dim=1)


def _incident_face_poly(h: HullW, ref_normal):
    """Polygon of h's face most anti-parallel to ref_normal [B, 3]."""
    dots = m3.dot(h.planes_n, ref_normal[:, None, :])
    dots = torch.where(h.faces_mask, dots, BIG)
    idx = torch.argmin(dots, dim=1)
    return _pick(h.face_polys, idx), _pick(h.face_poly_mask, idx)


def _poly_next(poly, mask):
    """next[i] = poly[i+1] for i < count-1, next[count-1] = poly[0]."""
    count = mask.sum(dim=1)
    rolled = torch.roll(poly, -1, dims=1)
    is_last = (torch.arange(poly.shape[1], device=poly.device)
               == (count - 1)[:, None])
    return torch.where(is_last[..., None], poly[:, :1], rolled)


def _reduce_manifold(points, depths, mask, normal):
    """Select <= 4 contact points (buildFaceContactManifold): first live;
    farthest from it; max |triangle area|; the fourth that most extends
    the triangle. points [B, K, 3], depths/mask [B, K], normal [B, 3]."""
    idx = torch.arange(points.shape[1], device=points.device)
    n_pts = mask.sum(dim=1)
    nb = normal[:, None, :]

    i0 = _first_true(mask)
    p0, d0 = _pick(points, i0), _pick(depths, i0)
    avail = mask & (idx != i0[:, None])

    diff = points - p0[:, None]
    dist2 = torch.where(avail, m3.dot(diff, diff), NEG_BIG)
    i1 = torch.argmax(dist2, dim=1)
    p1, d1 = _pick(points, i1), _pick(depths, i1)
    avail = avail & (idx != i1[:, None])

    ba = p1 - p0
    signed = m3.dot(nb, m3.cross(ba[:, None], points - p1[:, None]))
    area = torch.where(avail, torch.abs(signed), NEG_BIG)
    i2 = torch.argmax(area, dim=1)
    p2, d2, s2 = _pick(points, i2), _pick(depths, i2), _pick(signed, i2)
    avail = avail & (idx != i2[:, None])

    # CCW winding for the fourth-point test
    flip = s2 < 0
    fv = flip[:, None]
    q0 = torch.where(fv, p1, p0)
    q1 = torch.where(fv, p0, p1)
    e0 = torch.where(flip, d1, d0)
    e1 = torch.where(flip, d0, d1)
    ba2 = q1 - q0
    cb = p2 - q1
    ac = q0 - p2
    aq = q0[:, None] - points
    qc = points - p2[:, None]
    abq = m3.dot(nb, m3.cross(ba2[:, None], aq))
    bcq = m3.dot(nb, m3.cross(cb[:, None], qc))
    caq = m3.dot(nb, m3.cross(aq, ac[:, None]))
    qarea = torch.minimum(abq, torch.minimum(bcq, caq))
    qarea = torch.where(avail, qarea, BIG)
    i3 = torch.argmin(qarea, dim=1)
    p3, d3 = _pick(points, i3), _pick(depths, i3)

    pts4 = torch.stack([q0, q1, p2, p3], dim=1)
    dep4 = torch.stack([e0, e1, d2, d3], dim=1)
    return pts4, dep4, torch.clamp(n_pts, max=4)


def _clipped_poly_candidates(inc_poly, inc_mask, ref_poly, ref_mask, ref_n):
    """Vertex set of the incident polygon clipped by the ref face's side
    planes: incident verts inside every side plane, plus incident-edge x
    side-plane intersections inside the region. Returns
    (points [B, FVi + FVi*FVr, 3], valid [B, ...])."""
    fv_i = inc_poly.shape[1]
    fv_r = ref_poly.shape[1]

    ref_nxt = _poly_next(ref_poly, ref_mask)
    side_n = m3.cross(ref_nxt - ref_poly, ref_n[:, None, :])  # [B, FVr, 3]
    side_d = m3.dot(side_n, ref_poly)                         # [B, FVr]

    def inside_all(pts):
        sd = (m3.dot(pts[:, :, None, :], side_n[:, None, :, :])
              - side_d[:, None, :])                           # [B, M, FVr]
        return torch.all(
            torch.where(ref_mask[:, None, :], sd <= 1e-6, True), dim=-1
        )

    v_ok = inc_mask & inside_all(inc_poly)

    inc_nxt = _poly_next(inc_poly, inc_mask)
    inc_count = inc_mask.sum(dim=1)
    edge_live = inc_mask & (inc_count >= 2)[:, None]
    # [B, FVi * FVr], incident edge major
    p1 = torch.repeat_interleave(inc_poly, fv_r, dim=1)
    p2 = torch.repeat_interleave(inc_nxt, fv_r, dim=1)
    e_live = torch.repeat_interleave(edge_live, fv_r, dim=1)
    sn = side_n.repeat(1, fv_i, 1)
    sd_ = side_d.repeat(1, fv_i)
    s_live = ref_mask.repeat(1, fv_i)
    g1 = m3.dot(p1, sn) - sd_
    g2 = m3.dot(p2, sn) - sd_
    crosses = (g1 > 0.0) != (g2 > 0.0)
    gd = g1 - g2
    t = g1 / torch.where(torch.abs(gd) > 1e-12, gd, 1.0)
    inter = p1 + t[..., None] * (p2 - p1)
    i_ok = e_live & s_live & crosses & inside_all(inter)
    return (torch.cat([inc_poly, inter], dim=1),
            torch.cat([v_ok, i_ok], dim=1))


def face_contact_manifold(ref_poly, ref_mask, ref_n, ref_d, other: HullW):
    """Clip other's incident face against the ref face; keep points
    below the ref plane, projected onto it. Returns
    (points4 [B, 4, 3], depths4 [B, 4], num [B], normal [B, 3])."""
    inc_poly, inc_mask = _incident_face_poly(other, ref_n)
    pts, ok = _clipped_poly_candidates(
        inc_poly, inc_mask, ref_poly, ref_mask, ref_n
    )
    d = m3.dot(pts, ref_n[:, None, :]) - ref_d[:, None]
    below = ok & (d <= 0.0)
    proj = pts - d[..., None] * ref_n[:, None, :]
    pts4, dep4, npts = _reduce_manifold(proj, -d, below, ref_n)
    return pts4, dep4, npts, ref_n


def query_edge_directions_dirs(a: HullW, b: HullW):
    """Edge query over unique edge DIRECTION pairs: for each axis
    cross(da_i, db_j) (oriented A -> B) the support separation
    min_B - max_A; the winner's witnesses are the A edge of direction i
    farthest along the axis and the B edge of direction j nearest."""
    da, db = a.edge_dirs, b.edge_dirs                     # [B, D, 3]
    bsz, d = da.shape[:2]
    ax = m3.cross(da[:, :, None, :], db[:, None, :, :])   # [B, D, D, 3]
    len2 = m3.dot(ax, ax)
    ok = (a.edge_dirs_mask[:, :, None] & b.edge_dirs_mask[:, None, :]
          & (len2 > 1e-12))
    # 1 / sqrt, both correctly rounded: the contacts kernel repeats it
    # bit for bit, which an approximate rsqrt would not promise
    n = ax * (1.0 / torch.sqrt(torch.clamp(len2, min=1e-30)))[..., None]
    c_ab = b.center - a.center
    flip = torch.where(m3.dot(n, c_ab[:, None, None, :]) < 0.0, -1.0, 1.0)
    n = n * flip[..., None]
    dots_a = m3.dot(n[:, :, :, None, :], a.verts[:, None, None, :, :])
    dots_b = m3.dot(n[:, :, :, None, :], b.verts[:, None, None, :, :])
    max_a = torch.where(a.verts_mask[:, None, None, :], dots_a,
                        NEG_BIG).amax(dim=-1)
    min_b = torch.where(b.verts_mask[:, None, None, :], dots_b,
                        BIG).amin(dim=-1)
    sep = torch.where(ok, min_b - max_a, NEG_BIG).reshape(bsz, d * d)

    best = torch.argmax(sep, dim=1)                       # i-major
    i_star = best // d
    j_star = best % d
    sep_e = _pick(sep, best)
    n_e = _pick(n.reshape(bsz, d * d, 3), best)

    def witness(h, dir_star, pick_max):
        mid = 0.5 * (h.edge_p1 + h.edge_p2)               # [B, E, 3]
        score = m3.dot(mid, n_e[:, None, :])
        if not pick_max:
            score = -score
        usable = ((torch.abs(h.edge_dir_id - dir_star[:, None]) < 0.5)
                  & h.edges_mask)
        e_star = torch.argmax(torch.where(usable, score, NEG_BIG), dim=1)
        return _pick(h.edge_p1, e_star), _pick(h.edge_p2, e_star)

    pa1, pa2 = witness(a, i_star, True)
    pb1, pb2 = witness(b, j_star, False)
    return sep_e, n_e, pa1, pa2, pb1, pb2


def query_edge_directions(a: HullW, b: HullW):
    """Edge query over every edge pair (queryEdgeDirections): a pair
    counts where its Gauss-map arcs cross (isMinkowskiFace); its axis
    cross(ea, eb) is oriented away from A's center and its separation is
    the distance of B's edge from A's along it. A-edge major, first
    best."""
    bsz, e_a = a.edge_p1.shape[:2]
    e_b = b.edge_p1.shape[1]

    def ea(v):
        return v[:, :, None, :]                           # [B, Ea, 1, 3]

    def eb(v):
        return v[:, None, :, :]                           # [B, 1, Eb, 3]

    na1, na2 = ea(a.edge_n1), ea(a.edge_n2)
    nb1, nb2 = eb(-b.edge_n1), eb(-b.edge_n2)
    bxa = m3.cross(na2, na1)
    dxc = m3.cross(nb2, nb1)
    cba = m3.dot(nb1, bxa)
    dba = m3.dot(nb2, bxa)
    adc = m3.dot(na1, dxc)
    bdc = m3.dot(na2, dxc)
    mink = (cba * dba < 0.0) & (adc * bdc < 0.0) & (cba * bdc > 0.0)

    pa1, pa2 = ea(a.edge_p1), ea(a.edge_p2)
    pb1, pb2 = eb(b.edge_p1), eb(b.edge_p2)
    cr = m3.cross(pa2 - pa1, pb2 - pb1)                   # [B, Ea, Eb, 3]
    len2 = m3.dot(cr, cr)
    ok = (mink & (len2 > 1e-12) & a.edges_mask[:, :, None]
          & b.edges_mask[:, None, :])
    n = cr * (1.0 / torch.sqrt(torch.clamp(len2, min=1e-30)))[..., None]
    to_edge = pa1 - a.center[:, None, None, :]
    flip = torch.where(m3.dot(n, to_edge) < 0.0, -1.0, 1.0)
    n = n * flip[..., None]
    sep = torch.where(ok, m3.dot(n, pb1 - pa1), NEG_BIG).reshape(
        bsz, e_a * e_b)

    best = torch.argmax(sep, dim=1)
    i_star = best // e_b
    j_star = best % e_b
    return (_pick(sep, best), _pick(n.reshape(bsz, e_a * e_b, 3), best),
            _pick(a.edge_p1, i_star), _pick(a.edge_p2, i_star),
            _pick(b.edge_p1, j_star), _pick(b.edge_p2, j_star))


def _select_hull(cond, x: HullW, y: HullW) -> HullW:
    """Per-lane choice between two hull batches (cond [B] bool)."""
    def sel(u, v):
        c = cond.reshape((-1,) + (1,) * (u.dim() - 1))
        return torch.where(c, u, v)

    return HullW(**{
        f.name: sel(getattr(x, f.name), getattr(y, f.name))
        for f in dataclasses.fields(HullW)
        if getattr(x, f.name) is not None
    })


def hull_hull_contact(a: HullW, b: HullW):
    """Full SAT + manifold for a batch of hull pairs, in the tier the
    hulls carry: ``edge_dirs`` when they have edge directions, else
    ``edge_pairs`` (their edge normals).

    Returns dict(valid, ref_is_a, points [B, 4, 3], depths [B, 4],
    num [B], normal [B, 3]). Face and edge manifolds are both computed
    and selected by mask."""
    sep_a, face_a = query_face_directions(a, b)
    sep_b, face_b = query_face_directions(b, a)
    if a.edge_dirs is not None:
        sep_e, n_e, pa1, pa2, pb1, pb2 = query_edge_directions_dirs(a, b)
        # face preference under near-ties: the direction family contains
        # axes numerically equal to face normals
        face_bias = 1e-5
        is_face = ((sep_a >= sep_e - face_bias)
                   | (sep_b >= sep_e - face_bias))
    else:
        # the pair family is disjoint from the face normals: strict
        sep_e, n_e, pa1, pa2, pb1, pb2 = query_edge_directions(a, b)
        is_face = (sep_a > sep_e) | (sep_b > sep_e)
    separated = (sep_a > 0.0) | (sep_b > 0.0) | (sep_e > 0.0)
    a_is_ref = sep_a >= sep_b

    ref = _select_hull(a_is_ref, a, b)
    other = _select_hull(a_is_ref, b, a)
    ref_face = torch.where(a_is_ref, face_a, face_b)
    f_pts, f_dep, f_num, f_nrm = face_contact_manifold(
        _pick(ref.face_polys, ref_face), _pick(ref.face_poly_mask, ref_face),
        _pick(ref.planes_n, ref_face), _pick(ref.planes_d, ref_face), other,
    )

    # edge manifold: closest point on A's winning edge
    v1 = pa2 - pa1
    v2 = pb2 - pb1
    v21 = pb1 - pa1
    d22 = m3.dot(v2, v2)
    d11 = m3.dot(v1, v1)
    d21 = m3.dot(v2, v1)
    d211 = m3.dot(v21, v1)
    d212 = m3.dot(v21, v2)
    denom = d21 * d21 - d22 * d11
    s_gen = (d212 * d21 - d22 * d211) / torch.where(
        torch.abs(denom) > 1e-12, denom, 1.0
    )
    s_par = -d211 / torch.where(torch.abs(d21) > 1e-12, d21, 1.0)
    s = torch.clamp(
        torch.where(torch.abs(denom) < 1e-5, s_par, s_gen), 0.0, 1.0
    )
    e_contact = pa1 + s[:, None] * v1

    bsz = sep_a.shape[0]
    e_pts = torch.zeros((bsz, 4, 3), dtype=v1.dtype, device=v1.device)
    e_pts[:, 0] = e_contact
    e_dep = torch.zeros((bsz, 4), dtype=v1.dtype, device=v1.device)
    e_dep[:, 0] = -sep_e
    n_pts = torch.where(is_face, f_num, 1)
    valid = (~separated) & (n_pts > 0)
    return dict(
        valid=valid,
        ref_is_a=torch.where(is_face, a_is_ref, True),
        points=torch.where(is_face[:, None, None], f_pts, e_pts),
        depths=torch.where(is_face[:, None], f_dep, e_dep),
        num=torch.where(valid, n_pts, 0),
        normal=torch.where(is_face[:, None], f_nrm, n_e),
    )


def hull_plane_contact(h: HullW, plane_pos, plane_rot):
    """Hull vs infinite plane; the plane (normal = its local +z) is the
    reference (ref_is_a is False)."""
    up = torch.zeros_like(plane_pos)
    up[:, 2] = 1.0
    n = m3.quat_rotate(plane_rot, up)
    d = m3.dot(n, plane_pos)
    vd = m3.dot(h.verts, n[:, None, :]) - d[:, None]
    separation = torch.where(h.verts_mask, vd, BIG).amin(dim=1)

    poly, poly_mask = _incident_face_poly(h, n)
    pd = m3.dot(poly, n[:, None, :]) - d[:, None]
    below = poly_mask & (pd <= 0.0)
    proj = poly - pd[..., None] * n[:, None, :]
    pts4, dep4, npts = _reduce_manifold(proj, -pd, below, n)
    valid = (separation <= 0.0) & (npts > 0)
    return dict(
        valid=valid, points=pts4, depths=dep4,
        num=torch.where(valid, npts, 0), normal=n,
    )


def _one_point(valid, pt, depth, normal):
    """A 1-point manifold dict: the point in slot 0, the rest zero."""
    bsz = pt.shape[0]
    pts = torch.zeros((bsz, 4, 3), dtype=pt.dtype, device=pt.device)
    pts[:, 0] = pt
    dep = torch.zeros((bsz, 4), dtype=pt.dtype, device=pt.device)
    dep[:, 0] = depth
    return dict(valid=valid, points=pts, depths=dep,
                num=valid.to(torch.int32), normal=normal)


def _plane_normal(plane_rot):
    up = torch.zeros(plane_rot.shape[:-1] + (3,), dtype=plane_rot.dtype,
                     device=plane_rot.device)
    up[..., 2] = 1.0
    return m3.quat_rotate(plane_rot, up)


def sphere_sphere_contact(a_pos, a_r, b_pos, b_r):
    """The point on B's surface toward A; B is the reference, the normal
    points B -> A (the JAX package's convention for every pair type)."""
    to_b = b_pos - a_pos
    dist = torch.sqrt(torch.clamp(m3.dot(to_b, to_b), min=1e-30))
    n_ab = to_b / dist[:, None]
    up = torch.zeros_like(n_ab)
    up[:, 2] = 1.0
    n_ab = torch.where((dist > 1e-12)[:, None], n_ab, up)
    penetration = a_r + b_r - dist
    n = -n_ab
    return _one_point(penetration >= 0.0, b_pos + b_r[:, None] * n,
                      penetration, n)


def sphere_plane_contact(s_pos, s_r, plane_pos, plane_rot):
    """SpherePlane: the plane is the reference."""
    n = _plane_normal(plane_rot)
    d = m3.dot(n, plane_pos)
    t = m3.dot(n, s_pos) - d
    penetration = s_r - t
    return _one_point(penetration >= 0.0, s_pos - t[:, None] * n,
                      penetration, n)


def sphere_hull_contact(s_pos, s_r, h: HullW):
    """Sphere vs hull (the reference) by exact closest-point enumeration
    over the padded tables: vertices, edge segments, face interiors;
    a center inside the hull takes the face of least penetration."""
    fd = m3.dot(h.planes_n, s_pos[:, None, :]) - h.planes_d   # [B, F]
    fd_masked = torch.where(h.faces_mask, fd, NEG_BIG)
    max_fd = fd_masked.amax(dim=1)
    inside = max_fd <= 0.0

    dv = h.verts - s_pos[:, None, :]
    vdist2 = torch.where(h.verts_mask, m3.dot(dv, dv), BIG)
    best_pt = _pick(h.verts, torch.argmin(vdist2, dim=1))
    best_d2 = vdist2.amin(dim=1)

    ev = h.edge_p2 - h.edge_p1
    tt = m3.dot(s_pos[:, None, :] - h.edge_p1, ev) / torch.clamp(
        m3.dot(ev, ev), min=1e-12)
    tt = torch.clamp(tt, 0.0, 1.0)
    ept = h.edge_p1 + tt[..., None] * ev
    de = ept - s_pos[:, None, :]
    ed2 = torch.where(h.edges_mask, m3.dot(de, de), BIG)
    e_best = _pick(ept, torch.argmin(ed2, dim=1))
    e_d2 = ed2.amin(dim=1)
    best_pt = torch.where((e_d2 < best_d2)[:, None], e_best, best_pt)
    best_d2 = torch.minimum(e_d2, best_d2)

    # face interiors: the projection inside every side plane of the face
    proj = s_pos[:, None, :] - fd[..., None] * h.planes_n     # [B, F, 3]
    bsz, f, fv = h.face_poly_mask.shape
    nxt = _poly_next(h.face_polys.reshape(bsz * f, fv, 3),
                     h.face_poly_mask.reshape(bsz * f, fv)
                     ).reshape(bsz, f, fv, 3)
    side_n = m3.cross(nxt - h.face_polys, h.planes_n[:, :, None, :])
    sd = m3.dot(side_n, proj[:, :, None, :] - h.face_polys)   # [B, F, FV]
    f_inside = torch.all(torch.where(h.face_poly_mask, sd <= 1e-7, True),
                         dim=-1)
    f_ok = f_inside & h.faces_mask & (fd > 0.0)
    f_d2 = torch.where(f_ok, fd * fd, BIG)
    f_best = _pick(proj, torch.argmin(f_d2, dim=1))
    f_d2min = f_d2.amin(dim=1)
    best_pt = torch.where((f_d2min < best_d2)[:, None], f_best, best_pt)
    best_d2 = torch.minimum(f_d2min, best_d2)

    dist = torch.sqrt(torch.clamp(best_d2, min=1e-30))
    to_sphere = (s_pos - best_pt) / dist[:, None]
    deep_n = _pick(h.planes_n, torch.argmax(fd_masked, dim=1))
    iv = inside[:, None]
    depth = torch.where(inside, -max_fd + s_r, s_r - dist)
    return _one_point(
        depth >= 0.0,
        torch.where(iv, s_pos - max_fd[:, None] * deep_n, best_pt), depth,
        torch.where(iv, deep_n, to_sphere))


def _sentinel_lanes(w, p, n, device):
    """(ref, alt, points, num, normal) of p lanes without a contact."""
    i32 = torch.int32
    return (torch.full((w, p), n, dtype=i32, device=device),
            torch.full((w, p), n, dtype=i32, device=device),
            torch.zeros((w, p, 4, 4), device=device),
            torch.zeros((w, p), dtype=i32, device=device),
            torch.zeros((w, p, 3), device=device))


class _Lanes:
    """Per-lane body data of candidate buffers over one [W, N] body set."""

    def __init__(self, pos, rot, scale, obj_id, om):
        self.n = pos.shape[1]
        self.w = pos.shape[0]
        self.om = om
        self.nb = torch.cat([pos, rot, scale], dim=-1)          # [W, N, 10]
        self.obj_id = obj_id

    def side(self, pairs, side):
        """Per-lane (pos, rot, scale, object id) of one pair side."""
        rows = pairs[..., side]
        blk = gather_rows(self.nb, rows).reshape(-1, 10)
        oid = gather_rows(self.obj_id, rows).reshape(-1).long()
        return blk[:, 0:3], blk[:, 3:7], blk[:, 7:10], oid

    def hull(self, lane, need_edges=True, dirs=False, edge_normals=False):
        p, q, s, oid = lane
        om = self.om
        return hull_row_to_world(
            om.hull_pack[oid], om.hull_dims, p, q, s, need_edges=need_edges,
            dirs_row=om.hull_dirs_pack[oid] if dirs else None,
            n_dirs=om.n_edge_dirs if dirs else 0, edge_normals=edge_normals,
        )

    def emit(self, c, first, second, pairs):
        """(ref, alt, points, num, normal) in [W, P, ...] layout."""
        w, n, p = self.w, self.n, pairs.shape[1]
        ok = c["valid"] & (pairs[..., 0].reshape(-1) < n)
        sent = torch.full_like(first, n)
        pts = torch.cat([c["points"], c["depths"][..., None]], dim=-1)
        return (
            torch.where(ok, first, sent).reshape(w, p).to(torch.int32),
            torch.where(ok, second, sent).reshape(w, p).to(torch.int32),
            pts.reshape(w, p, 4, 4),
            torch.where(ok, c["num"], 0).reshape(w, p).to(torch.int32),
            c["normal"].reshape(w, p, 3),
        )


def hull_hull_lanes(pos, rot, scale, obj_id, om, hh_pairs,
                    sat_dirs: bool = True):
    """The hull-hull segment of :func:`narrowphase_lanes`: (ref, alt
    [W, P] int32, points [W, P, 4, 4], num [W, P] int32, normal
    [W, P, 3]); ``sat_dirs`` picks the ``edge_dirs`` SAT tier, else
    ``edge_pairs``."""
    lanes = _Lanes(pos, rot, scale, obj_id, om)
    a = lanes.hull(lanes.side(hh_pairs, 0), dirs=sat_dirs,
                   edge_normals=not sat_dirs)
    b = lanes.hull(lanes.side(hh_pairs, 1), dirs=sat_dirs,
                   edge_normals=not sat_dirs)
    c = hull_hull_contact(a, b)
    pa = hh_pairs[..., 0].reshape(-1).long()
    pb = hh_pairs[..., 1].reshape(-1).long()
    return lanes.emit(c, torch.where(c["ref_is_a"], pa, pb),
                      torch.where(c["ref_is_a"], pb, pa), hh_pairs)


def narrowphase_lanes(pos, rot, scale, obj_id, om, hh_pairs, hp_pairs,
                      sp_pairs=None, sp_kind=None, sat_dirs: bool = True,
                      skip_hh: bool = False):
    """Contacts of candidate pair buffers, in the fixed lane layout
    [hull-hull | hull-plane | sphere]: one lane per candidate slot, all
    worlds flattened into the batch axis of the functions above.

    pos/rot/scale [W, N, 3|4|3], obj_id [W, N]; hh_pairs [W, PH, 2],
    hp_pairs [W, PP, 2] (hull row, plane row), sp_pairs [W, PS, 2]
    (sphere row, other row) with sp_kind [W, PS] the other's primitive
    type (None: no sphere lanes). ``sat_dirs`` picks the SAT tier;
    ``skip_hh`` leaves the hull-hull segment without contacts (the
    caller fills it from a kernel). Returns (ref, alt [W, C] int32,
    points [W, C, 4, 4], num [W, C] int32, normal [W, C, 3]) with
    C = PH + PP + PS. Sentinel rows read row N-1 and are masked out by
    ``pair[0] < n``."""
    from . import geo

    lanes = _Lanes(pos, rot, scale, obj_id, om)
    w, n = lanes.w, lanes.n
    if skip_hh:
        hh = _sentinel_lanes(w, hh_pairs.shape[1], n, pos.device)
    else:
        hh = hull_hull_lanes(pos, rot, scale, obj_id, om, hh_pairs, sat_dirs)

    h = lanes.hull(lanes.side(hp_pairs, 0), need_edges=False)
    pp, qp, _, _ = lanes.side(hp_pairs, 1)
    c = hull_plane_contact(h, pp, qp)
    # the plane (second row) is the reference
    hp = lanes.emit(c, hp_pairs[..., 1].reshape(-1).long(),
                    hp_pairs[..., 0].reshape(-1).long(), hp_pairs)
    segs = [hh, hp]

    if sp_pairs is not None and sp_pairs.shape[1]:
        radius = om.body_pack[:, 12]
        ps, _, ss, os_ = lanes.side(sp_pairs, 0)
        po, qo, so, oo = lanes.side(sp_pairs, 1)
        r_s = radius[os_] * ss[:, 0]
        c_ss = sphere_sphere_contact(ps, r_s, po, radius[oo] * so[:, 0])
        c_sp = sphere_plane_contact(ps, r_s, po, qo)
        c_sh = sphere_hull_contact(ps, r_s, lanes.hull((po, qo, so, oo)))
        kind = sp_kind.reshape(-1)
        is_plane, is_hull = kind == geo.TYPE_PLANE, kind == geo.TYPE_HULL

        def pick(f):
            a, b_, c_ = c_sp[f], c_sh[f], c_ss[f]
            shape = (-1,) + (1,) * (a.dim() - 1)
            return torch.where(is_plane.reshape(shape), a, torch.where(
                is_hull.reshape(shape), b_, c_))

        c = {f: pick(f) for f in ("valid", "points", "depths", "num",
                                  "normal")}
        # the second body (plane, hull or other sphere) is the reference
        segs.append(lanes.emit(c, sp_pairs[..., 1].reshape(-1).long(),
                               sp_pairs[..., 0].reshape(-1).long(),
                               sp_pairs))
    return tuple(torch.cat(parts, dim=1) for parts in zip(*segs))
