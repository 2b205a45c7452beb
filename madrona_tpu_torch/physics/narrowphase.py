"""Narrowphase: batched SAT contact generation for candidate pairs.

Port of the hull-hull (``edge_dirs`` SAT tier) and hull-plane lanes of
``madrona_tpu/physics/narrowphase.py`` (the reference's
``src/physics/narrowphase.cpp``). Every function takes a leading batch
axis B (one lane per candidate pair, all worlds flattened) and computes
fixed-shape masked reductions over padded hull tables; argmax winners
are read back with index gathers.

Algorithm (unchanged from the JAX package):
  * face query: max over A's faces of (min over B's verts of signed
    distance), both ways;
  * edge query over unique edge DIRECTION pairs, with a 1e-5 face
    preference under near-ties (the direction family contains axes
    equal to face normals);
  * face manifold: the incident polygon clipped by the ref face's side
    planes (its vertex set computed directly), points below the ref
    plane projected onto it, reduced to <= 4 points;
  * edge manifold: closest point on A's winning edge;
  * hull-plane: the plane is always the reference.

Contact points lie on the REF body's surface; the normal points
ref -> other. The Gauss-map ``edge_pairs`` tier and the sphere lanes
come with the configurations that use them.
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
    # unique edge directions in world frame (scaled + rotated, not unit)
    edge_dirs: Optional[torch.Tensor] = None       # [B, D, 3]
    edge_dirs_mask: Optional[torch.Tensor] = None  # [B, D] bool
    edge_dir_id: Optional[torch.Tensor] = None     # [B, E] f32


def hull_row_to_world(row, dims, pos, rot, scale, need_edges: bool = True,
                      dirs_row=None, n_dirs: int = 0) -> HullW:
    """Unpack packed hull rows [B, K] and transform them by
    (pos [B, 3], rot [B, 4], scale [B, 3]). Normals are re-derived to
    stay valid under non-uniform scale: n' ~ R (n / scale).
    need_edges=False skips the edge transforms (hull-plane lanes)."""
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
    cut(e * 3, (e, 3))              # adjacent-face normals: edge_pairs tier
    cut(e * 3, (e, 3))
    edges_mask = cut(e, (e,)) > 0.5
    face_polys_l = cut(f * fv * 3, (f * fv, 3))
    face_poly_mask = cut(f * fv, (f, fv)) > 0.5

    rot_b = rot[:, None, :]
    scale_b = scale[:, None, :]

    def xform_pt(p):
        return m3.quat_rotate(rot_b, p * scale_b) + pos[:, None, :]

    verts = xform_pt(verts_l)
    n_w = m3.normalize(
        m3.quat_rotate(rot_b, planes_nl / torch.clamp(scale_b, min=1e-12))
    )
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
    """Full SAT + manifold for a batch of hull pairs (``edge_dirs``).

    Returns dict(valid, ref_is_a, points [B, 4, 3], depths [B, 4],
    num [B], normal [B, 3]). Face and edge manifolds are both computed
    and selected by mask."""
    sep_a, face_a = query_face_directions(a, b)
    sep_b, face_b = query_face_directions(b, a)
    sep_e, n_e, pa1, pa2, pb1, pb2 = query_edge_directions_dirs(a, b)
    # face preference under near-ties: the direction family contains
    # axes numerically equal to face normals
    face_bias = 1e-5
    is_face = (sep_a >= sep_e - face_bias) | (sep_b >= sep_e - face_bias)
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


def narrowphase_lanes(pos, rot, scale, obj_id, om, hh_pairs, hp_pairs):
    """Contacts of candidate pair buffers, in the fixed lane layout
    [hull-hull | hull-plane]: one lane per candidate slot, all worlds
    flattened into the batch axis of the functions above.

    pos/rot/scale [W, N, 3|4|3], obj_id [W, N]; hh_pairs [W, PH, 2],
    hp_pairs [W, PP, 2] (hull row, plane row). Returns (ref, alt [W, C]
    int32, points [W, C, 4, 4], num [W, C] int32, normal [W, C, 3]) with
    C = PH + PP. Sentinel rows read row N-1 and are masked out by
    ``pair[0] < n``."""
    w, n = pos.shape[:2]
    dims = om.hull_dims
    nb = torch.cat([pos, rot, scale], dim=-1)                  # [W, N, 10]

    def lanes(pairs, side):
        """Per-lane (pos, rot, scale, object id) of one pair side."""
        rows = pairs[..., side]
        blk = gather_rows(nb, rows).reshape(-1, 10)
        oid = gather_rows(obj_id, rows).reshape(-1).long()
        return blk[:, 0:3], blk[:, 3:7], blk[:, 7:10], oid

    def hull(lane, need_edges=True, dirs=False):
        p, q, s, oid = lane
        return hull_row_to_world(
            om.hull_pack[oid], dims, p, q, s, need_edges=need_edges,
            dirs_row=om.hull_dirs_pack[oid] if dirs else None,
            n_dirs=om.n_edge_dirs if dirs else 0,
        )

    def emit(c, first, second, pairs):
        """(ref, alt, points, num, normal) in [W, P, ...] layout."""
        p = pairs.shape[1]
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

    a = hull(lanes(hh_pairs, 0), dirs=True)
    b = hull(lanes(hh_pairs, 1), dirs=True)
    c = hull_hull_contact(a, b)
    pa = hh_pairs[..., 0].reshape(-1).long()
    pb = hh_pairs[..., 1].reshape(-1).long()
    hh = emit(c, torch.where(c["ref_is_a"], pa, pb),
              torch.where(c["ref_is_a"], pb, pa), hh_pairs)

    h = hull(lanes(hp_pairs, 0), need_edges=False)
    pp, qp, _, _ = lanes(hp_pairs, 1)
    c = hull_plane_contact(h, pp, qp)
    # the plane (second row) is the reference
    hp = emit(c, hp_pairs[..., 1].reshape(-1).long(),
              hp_pairs[..., 0].reshape(-1).long(), hp_pairs)
    return tuple(torch.cat([x, y], dim=1) for x, y in zip(hh, hp))
