// Narrowphase device functions shared by the contacts, hull-hull record
// and fused-step kernels (csrc/contacts.cu, hh_narrowphase.cu,
// fused_step.cu): hulls to world space, the SAT queries, the clipped face
// manifold and its reduction to 4 points, the edge contact, the
// hull-plane lane and the three sphere lanes. One thread computes one
// candidate lane.
//
// Their plain PyTorch versions are in madrona_tpu_torch/physics/
// narrowphase.py: every sum is written in that module's order and the
// sources are compiled with --fmad=false, so the integer results (which
// body is the reference, how many points) equal the plain version's.
// Every arg-best is the first best, as torch.argmax/argmin pick it.
//
// Two SAT tiers for the edge-edge axes (PhysicsConfig.sat_tier):
// "edge_dirs" sweeps the unique edge-direction pairs with a support
// separation and prefers faces within 1e-5; "edge_pairs" sweeps every edge
// pair with the Gauss-map (Minkowski-face) test and a strict face compare.

#pragma once

#include "vec.cuh"

namespace {

constexpr int MAXV = 8, MAXF = 6, MAXFV = 4, MAXE = 12, MAXD = 6;
constexpr int MAXCAND = MAXFV + MAXFV * MAXFV;
constexpr float BIG = 3.0e38f, NEG_BIG = -3.0e38f;

// The packed hull tables (physics/bodies.py::_pack_hull and the edge
// direction pack) of every object.
struct Tables {
    const float* pack;   // [n_obj, k]
    const float* dirs;   // [n_obj, kd]
    int v, f, fv, e, d, k, kd;
    // offsets inside a pack row
    int o_vmask, o_pn, o_fmask, o_e1, o_e2, o_n1, o_n2, o_emask, o_poly,
        o_pmask;
};

__device__ Tables make_tables(const float* pack, const float* dirs, int v,
                              int f, int fv, int e, int d) {
    Tables t;
    t.pack = pack; t.dirs = dirs;
    t.v = v; t.f = f; t.fv = fv; t.e = e; t.d = d;
    t.o_vmask = 3 * v;
    t.o_pn = t.o_vmask + v;
    t.o_fmask = t.o_pn + 3 * f;
    t.o_e1 = t.o_fmask + f;
    t.o_e2 = t.o_e1 + 3 * e;
    t.o_n1 = t.o_e2 + 3 * e;             // the edges' two adjacent faces'
    t.o_n2 = t.o_n1 + 3 * e;             // normals (edge_pairs tier)
    t.o_emask = t.o_n2 + 3 * e;
    t.o_poly = t.o_emask + e;
    t.o_pmask = t.o_poly + 3 * f * fv;
    t.k = t.o_pmask + f * fv;
    t.kd = 4 * d + e;
    return t;
}

// Copy the packed tables to shared memory; the block's threads all call it.
__device__ Tables stage_tables(float* smem, const float* pack,
                               const float* dirs, int n_obj, int v, int f,
                               int fv, int e, int d) {
    Tables t = make_tables(smem, nullptr, v, f, fv, e, d);
    const int np = n_obj * t.k, nd = n_obj * t.kd;
    for (int i = threadIdx.x; i < np; i += blockDim.x) smem[i] = pack[i];
    for (int i = threadIdx.x; i < nd; i += blockDim.x)
        smem[np + i] = dirs[i];
    t.dirs = smem + np;
    __syncthreads();
    return t;
}

// One body's pose and its rows of the tables. The pose is read from p:
// field i (pos xyz | rot wxyz | scale xyz) at p[i * stride].
struct Body {
    V3 p; Q4 q; V3 s;
    const float* row;
    const float* drow;
};

__device__ Body load_body(const Tables& t, const float* p, size_t stride,
                          int obj) {
    const size_t s = stride;
    Body b;
    b.p = {p[0], p[s], p[2 * s]};
    b.q = {p[3 * s], p[4 * s], p[5 * s], p[6 * s]};
    b.s = {p[7 * s], p[8 * s], p[9 * s]};
    b.row = t.pack + (size_t)obj * t.k;
    b.drow = t.dirs + (size_t)obj * t.kd;
    return b;
}

__device__ __forceinline__ V3 xform_pt(const Body& b, V3 local) {
    return qrot(b.q, mul(local, b.s)) + b.p;
}

// A local normal to world space under non-uniform scale: R (n / s),
// normalized (zero stays zero).
__device__ __forceinline__ V3 xform_n(const Body& b, V3 nl) {
    const V3 r = qrot(b.q, V3{nl.x / fmaxf(b.s.x, 1e-12f),
                              nl.y / fmaxf(b.s.y, 1e-12f),
                              nl.z / fmaxf(b.s.z, 1e-12f)});
    const float l2 = dot(r, r);
    const float inv = l2 > 0.0f ? 1.0f / sqrtf(fmaxf(l2, 1e-30f)) : 0.0f;
    return r * inv;
}

// World-space vertices, face planes and center of a hull.
struct Hull {
    V3 verts[MAXV];
    bool vmask[MAXV];
    V3 pn[MAXF];
    float pd[MAXF];
    bool fmask[MAXF];
    V3 center;
};

__device__ void world_hull(const Tables& t, const Body& b, Hull& h) {
    int live = 0;
    V3 acc = {0.0f, 0.0f, 0.0f};
    for (int i = 0; i < t.v; ++i) {
        h.verts[i] = xform_pt(b, ld3(b.row + 3 * i));
        h.vmask[i] = b.row[t.o_vmask + i] > 0.5f;
        const V3 term = h.vmask[i] ? h.verts[i] : V3{0.0f, 0.0f, 0.0f};
        acc = i == 0 ? term : acc + term;
        live += h.vmask[i];
    }
    const float denom = (float)(live > 1 ? live : 1);
    h.center = {acc.x / denom, acc.y / denom, acc.z / denom};
    for (int f = 0; f < t.f; ++f) {
        h.pn[f] = xform_n(b, ld3(b.row + t.o_pn + 3 * f));
        // plane d from the face's first polygon vertex (always live)
        h.pd[f] = dot(h.pn[f],
                      xform_pt(b, ld3(b.row + t.o_poly + 3 * f * t.fv)));
        h.fmask[f] = b.row[t.o_fmask + f] > 0.5f;
    }
}

// The polygon of face f in world space; returns its live vertex count.
__device__ int face_poly(const Tables& t, const Body& b, int f, V3* poly,
                         bool* mask) {
    int count = 0;
    for (int i = 0; i < t.fv; ++i) {
        poly[i] = xform_pt(b, ld3(b.row + t.o_poly + 3 * (f * t.fv + i)));
        mask[i] = b.row[t.o_pmask + f * t.fv + i] > 0.5f;
        count += mask[i];
    }
    return count;
}

// next[i] = poly[i+1] for i < count-1, next[count-1] = poly[0]
__device__ void poly_next(const V3* poly, int count, int fv, V3* next) {
    for (int i = 0; i < fv; ++i)
        next[i] = (i == count - 1) ? poly[0] : poly[(i + 1) % fv];
}

// (largest separation, its face) of A's faces against B's vertices
__device__ float face_query(const Tables& t, const Hull& a, const Hull& b,
                            int& face) {
    float best = 0.0f;
    for (int f = 0; f < t.f; ++f) {
        float mn = BIG;
        for (int v = 0; v < t.v; ++v) {
            const float d = b.vmask[v] ? dot(b.verts[v], a.pn[f]) - a.pd[f]
                                       : BIG;
            mn = fminf(mn, d);
        }
        const float sep = a.fmask[f] ? mn : NEG_BIG;
        if (f == 0 || sep > best) { best = sep; face = f; }
    }
    return best;
}

// Face of h most anti-parallel to n (the first least dot).
__device__ int incident_face(const Tables& t, const Hull& h, V3 n) {
    int idx = 0;
    float best = 0.0f;
    for (int f = 0; f < t.f; ++f) {
        const float d = h.fmask[f] ? dot(h.pn[f], n) : BIG;
        if (f == 0 || d < best) { best = d; idx = f; }
    }
    return idx;
}

// Select <= 4 of k candidate points (buildFaceContactManifold): the first
// live one; the farthest from it; the one of largest |triangle area|; the
// one that most extends the triangle. Every arg-best is the first best.
__device__ int reduce_manifold(int k, const V3* pts, const float* dep,
                               const bool* mask, V3 n, V3* pts4,
                               float* dep4) {
    bool avail[MAXCAND];
    int n_pts = 0, i0 = -1;
    for (int i = 0; i < k; ++i) {
        n_pts += mask[i];
        if (mask[i] && i0 < 0) i0 = i;
    }
    if (i0 < 0) i0 = 0;
    const V3 p0 = pts[i0];
    for (int i = 0; i < k; ++i) avail[i] = mask[i] && i != i0;

    int i1 = 0;
    float best = 0.0f;
    for (int i = 0; i < k; ++i) {
        const V3 diff = pts[i] - p0;
        const float s = avail[i] ? dot(diff, diff) : NEG_BIG;
        if (i == 0 || s > best) { best = s; i1 = i; }
    }
    const V3 p1 = pts[i1];
    avail[i1] = false;

    const V3 ba = p1 - p0;
    int i2 = 0;
    float s2 = 0.0f;
    for (int i = 0; i < k; ++i) {
        const float sg = dot(n, cross(ba, pts[i] - p1));
        const float s = avail[i] ? fabsf(sg) : NEG_BIG;
        if (i == 0 || s > best) { best = s; i2 = i; s2 = sg; }
    }
    const V3 p2 = pts[i2];
    avail[i2] = false;

    // counter-clockwise winding for the fourth-point test
    const bool flip = s2 < 0.0f;
    const V3 q0 = flip ? p1 : p0, q1 = flip ? p0 : p1;
    const V3 ba2 = q1 - q0, cb = p2 - q1, ac = q0 - p2;
    int i3 = 0;
    for (int i = 0; i < k; ++i) {
        const V3 aq = q0 - pts[i];
        const V3 qc = pts[i] - p2;
        const float abq = dot(n, cross(ba2, aq));
        const float bcq = dot(n, cross(cb, qc));
        const float caq = dot(n, cross(aq, ac));
        const float s = avail[i] ? fminf(abq, fminf(bcq, caq)) : BIG;
        if (i == 0 || s < best) { best = s; i3 = i; }
    }
    pts4[0] = q0; pts4[1] = q1; pts4[2] = p2; pts4[3] = pts[i3];
    dep4[0] = flip ? dep[i1] : dep[i0];
    dep4[1] = flip ? dep[i0] : dep[i1];
    dep4[2] = dep[i2];
    dep4[3] = dep[i3];
    return n_pts < 4 ? n_pts : 4;
}

// Witness edge of a direction class along axis n: among the live edges of
// class dir_star, the one whose midpoint is extremal (first best).
__device__ void witness_edge(const Tables& t, const Body& b, int dir_star,
                             V3 n, bool pick_max, V3& p1, V3& p2) {
    float best = 0.0f;
    for (int e = 0; e < t.e; ++e) {
        const V3 a = xform_pt(b, ld3(b.row + t.o_e1 + 3 * e));
        const V3 c = xform_pt(b, ld3(b.row + t.o_e2 + 3 * e));
        const V3 mid = (a + c) * 0.5f;
        float score = dot(mid, n);
        if (!pick_max) score = -score;
        const bool usable =
            fabsf(b.drow[4 * t.d + e] - (float)dir_star) < 0.5f &&
            b.row[t.o_emask + e] > 0.5f;
        if (!usable) score = NEG_BIG;
        if (e == 0 || score > best) { best = score; p1 = a; p2 = c; }
    }
}

// Edge query over unique direction pairs, i-major, first best: the
// support separation min_B - max_A along cross(da_i, db_j), oriented from
// A to B. Returns the separation; i_star, j_star name the winning pair.
__device__ float edge_query_dirs(const Tables& t, const Body& ba,
                                 const Body& bb, const Hull& ha,
                                 const Hull& hb, V3& n_e, int& i_star,
                                 int& j_star) {
    const V3 c_ab = hb.center - ha.center;
    float sep_e = 0.0f;
    n_e = {0.0f, 0.0f, 0.0f};
    i_star = 0; j_star = 0;
    for (int i = 0; i < t.d; ++i) {
        const V3 da = qrot(ba.q, mul(ld3(ba.drow + 3 * i), ba.s));
        const bool ma = ba.drow[3 * t.d + i] > 0.5f;
        for (int j = 0; j < t.d; ++j) {
            const V3 db = qrot(bb.q, mul(ld3(bb.drow + 3 * j), bb.s));
            const bool mb = bb.drow[3 * t.d + j] > 0.5f;
            const V3 ax = cross(da, db);
            const float len2 = dot(ax, ax);
            const bool ok = ma && mb && len2 > 1e-12f;
            V3 nv = ax * (1.0f / sqrtf(fmaxf(len2, 1e-30f)));
            const float flip = dot(nv, c_ab) < 0.0f ? -1.0f : 1.0f;
            nv = nv * flip;
            float max_a = NEG_BIG, min_b = BIG;
            for (int k = 0; k < t.v; ++k) {
                max_a = fmaxf(max_a, ha.vmask[k] ? dot(nv, ha.verts[k])
                                                 : NEG_BIG);
                min_b = fminf(min_b, hb.vmask[k] ? dot(nv, hb.verts[k])
                                                 : BIG);
            }
            const float sep = ok ? min_b - max_a : NEG_BIG;
            if ((i == 0 && j == 0) || sep > sep_e) {
                sep_e = sep; n_e = nv; i_star = i; j_star = j;
            }
        }
    }
    return sep_e;
}

// One edge of a hull in world space: endpoints, the normals of its two
// faces, and whether it is live.
struct EdgeW { V3 p1, p2, n1, n2; bool live; };

__device__ EdgeW world_edge(const Tables& t, const Body& b, int e) {
    EdgeW r;
    r.p1 = xform_pt(b, ld3(b.row + t.o_e1 + 3 * e));
    r.p2 = xform_pt(b, ld3(b.row + t.o_e2 + 3 * e));
    r.n1 = xform_n(b, ld3(b.row + t.o_n1 + 3 * e));
    r.n2 = xform_n(b, ld3(b.row + t.o_n2 + 3 * e));
    r.live = b.row[t.o_emask + e] > 0.5f;
    return r;
}

// Edge query over every edge pair (queryEdgeDirections): a pair counts
// where its Gauss-map arcs cross (isMinkowskiFace); its axis is
// cross(ea, eb) oriented away from A's center, its separation the
// distance of B's edge from A's along it. A-edge major, first best.
__device__ float edge_query_pairs(const Tables& t, const Body& ba,
                                  const Body& bb, const Hull& ha, V3& n_e,
                                  V3& pa1, V3& pa2, V3& pb1, V3& pb2) {
    EdgeW eb[MAXE];
    for (int j = 0; j < t.e; ++j) eb[j] = world_edge(t, bb, j);
    float sep_e = 0.0f;
    for (int i = 0; i < t.e; ++i) {
        const EdgeW ea = world_edge(t, ba, i);
        const V3 bxa = cross(ea.n2, ea.n1);
        const V3 da = ea.p2 - ea.p1;
        const V3 to_edge = ea.p1 - ha.center;
        for (int j = 0; j < t.e; ++j) {
            const V3 nb1 = -eb[j].n1, nb2 = -eb[j].n2;
            const V3 dxc = cross(nb2, nb1);
            const float cba = dot(nb1, bxa), dba = dot(nb2, bxa);
            const float adc = dot(ea.n1, dxc), bdc = dot(ea.n2, dxc);
            const bool mink = cba * dba < 0.0f && adc * bdc < 0.0f &&
                              cba * bdc > 0.0f;
            const V3 cr = cross(da, eb[j].p2 - eb[j].p1);
            const float len2 = dot(cr, cr);
            const bool ok = mink && len2 > 1e-12f && ea.live && eb[j].live;
            V3 nv = cr * (1.0f / sqrtf(fmaxf(len2, 1e-30f)));
            const float flip = dot(nv, to_edge) < 0.0f ? -1.0f : 1.0f;
            nv = nv * flip;
            const float sep = ok ? dot(nv, eb[j].p1 - ea.p1) : NEG_BIG;
            if ((i == 0 && j == 0) || sep > sep_e) {
                sep_e = sep; n_e = nv;
                pa1 = ea.p1; pa2 = ea.p2; pb1 = eb[j].p1; pb2 = eb[j].p2;
            }
        }
    }
    return sep_e;
}

// A lane's manifold: up to 4 points on the reference body's surface with
// their depths, the normal from the reference body to the other, and
// which side of the candidate pair is the reference.
struct Manifold {
    int num;             // 0: no contact
    bool ref_is_a;
    V3 nrm;
    V3 pts[4];
    float dep[4];
};

__device__ void one_point(Manifold& m, bool valid, V3 nrm, V3 pt,
                          float depth) {
    m.num = valid ? 1 : 0;
    m.ref_is_a = false;
    m.nrm = nrm;
    m.pts[0] = pt;
    m.dep[0] = depth;
    for (int k = 1; k < 4; ++k) {
        m.pts[k] = {0.0f, 0.0f, 0.0f};
        m.dep[k] = 0.0f;
    }
}

// Hull-hull lane: face queries both ways, the edge query of the tier;
// separated pairs drop out; a face contact clips the incident face of the
// other hull against the side planes of the reference face, keeps the
// points below the reference plane, projects them onto it and reduces
// them to at most 4; an edge contact is the closest point on A's edge.
__device__ void hull_hull(const Tables& t, const Body& ba, const Body& bb,
                          bool pairs, Manifold& m) {
    m.num = 0;
    Hull ha, hb;
    world_hull(t, ba, ha);
    world_hull(t, bb, hb);

    int face_a = 0, face_b = 0;
    const float sep_a = face_query(t, ha, hb, face_a);
    const float sep_b = face_query(t, hb, ha, face_b);

    V3 n_e, pa1, pa2, pb1, pb2;
    int i_star = 0, j_star = 0;
    const float sep_e =
        pairs ? edge_query_pairs(t, ba, bb, ha, n_e, pa1, pa2, pb1, pb2)
              : edge_query_dirs(t, ba, bb, ha, hb, n_e, i_star, j_star);
    if (sep_a > 0.0f || sep_b > 0.0f || sep_e > 0.0f) return;
    // edge_dirs: face preference under near-ties, as the direction family
    // contains axes numerically equal to face normals
    const bool is_face =
        pairs ? (sep_a > sep_e || sep_b > sep_e)
              : (sep_a >= sep_e - 1e-5f || sep_b >= sep_e - 1e-5f);
    const bool a_is_ref = sep_a >= sep_b;

    if (is_face) {
        const Body& br = a_is_ref ? ba : bb;
        const Body& bo = a_is_ref ? bb : ba;
        const Hull& hr = a_is_ref ? ha : hb;
        const Hull& ho = a_is_ref ? hb : ha;
        const int ref_face = a_is_ref ? face_a : face_b;
        const V3 ref_n = hr.pn[ref_face];
        const float ref_d = hr.pd[ref_face];
        V3 ref_poly[MAXFV], ref_nxt[MAXFV], inc_poly[MAXFV], inc_nxt[MAXFV];
        bool ref_mask[MAXFV], inc_mask[MAXFV];
        const int ref_count = face_poly(t, br, ref_face, ref_poly, ref_mask);
        const int inc_count = face_poly(t, bo, incident_face(t, ho, ref_n),
                                        inc_poly, inc_mask);
        poly_next(ref_poly, ref_count, t.fv, ref_nxt);
        poly_next(inc_poly, inc_count, t.fv, inc_nxt);

        V3 side_n[MAXFV];
        float side_d[MAXFV];
        for (int k = 0; k < t.fv; ++k) {
            side_n[k] = cross(ref_nxt[k] - ref_poly[k], ref_n);
            side_d[k] = dot(side_n[k], ref_poly[k]);
        }
        auto inside_all = [&](V3 p) {
            bool in = true;
            for (int k = 0; k < t.fv; ++k)
                if (ref_mask[k] && !(dot(p, side_n[k]) - side_d[k] <= 1e-6f))
                    in = false;
            return in;
        };

        // the clipped polygon's vertex set: incident vertices inside every
        // side plane, then incident-edge x side-plane crossings inside the
        // region (incident edge major)
        V3 cand[MAXCAND];
        float cdep[MAXCAND];
        bool below[MAXCAND];
        int nc = 0;
        for (int i = 0; i < t.fv; ++i, ++nc) {
            cand[nc] = inc_poly[i];
            below[nc] = inc_mask[i] && inside_all(inc_poly[i]);
        }
        for (int i = 0; i < t.fv; ++i) {
            const bool edge_live = inc_mask[i] && inc_count >= 2;
            const V3 p1 = inc_poly[i], p2 = inc_nxt[i];
            for (int k = 0; k < t.fv; ++k, ++nc) {
                const float g1 = dot(p1, side_n[k]) - side_d[k];
                const float g2 = dot(p2, side_n[k]) - side_d[k];
                const bool crosses = (g1 > 0.0f) != (g2 > 0.0f);
                const float gd = g1 - g2;
                const float tt = g1 / (fabsf(gd) > 1e-12f ? gd : 1.0f);
                cand[nc] = p1 + (p2 - p1) * tt;
                below[nc] = edge_live && ref_mask[k] && crosses &&
                            inside_all(cand[nc]);
            }
        }
        // keep what lies below the reference plane, projected onto it
        for (int i = 0; i < nc; ++i) {
            const float dd = dot(cand[i], ref_n) - ref_d;
            below[i] = below[i] && dd <= 0.0f;
            cand[i] = cand[i] - ref_n * dd;
            cdep[i] = -dd;
        }
        m.num = reduce_manifold(nc, cand, cdep, below, ref_n, m.pts, m.dep);
        m.nrm = ref_n;
    } else {
        if (!pairs) {
            witness_edge(t, ba, i_star, n_e, true, pa1, pa2);
            witness_edge(t, bb, j_star, n_e, false, pb1, pb2);
        }
        // closest point on A's winning edge
        const V3 v1 = pa2 - pa1, v2 = pb2 - pb1, v21 = pb1 - pa1;
        const float d22 = dot(v2, v2), d11 = dot(v1, v1), d21 = dot(v2, v1);
        const float d211 = dot(v21, v1), d212 = dot(v21, v2);
        const float denom = d21 * d21 - d22 * d11;
        const float s_gen = (d212 * d21 - d22 * d211) /
                            (fabsf(denom) > 1e-12f ? denom : 1.0f);
        const float s_par = -d211 / (fabsf(d21) > 1e-12f ? d21 : 1.0f);
        const float s = fminf(
            fmaxf(fabsf(denom) < 1e-5f ? s_par : s_gen, 0.0f), 1.0f);
        one_point(m, true, n_e, pa1 + v1 * s, -sep_e);
    }
    m.ref_is_a = !is_face || a_is_ref;
}

// Hull-plane lane: the plane (normal = its local +z) is the reference; the
// hull's face most against the normal, its vertices below the plane
// projected onto it, the same reduction.
__device__ void hull_plane(const Tables& t, const Body& bh, const Body& bp,
                           Manifold& m) {
    m.num = 0;
    Hull h;
    world_hull(t, bh, h);
    const V3 nrm = qrot(bp.q, V3{0.0f, 0.0f, 1.0f});
    const float pd = dot(nrm, bp.p);
    float separation = BIG;
    for (int k = 0; k < t.v; ++k)
        separation = fminf(separation,
                           h.vmask[k] ? dot(h.verts[k], nrm) - pd : BIG);
    if (!(separation <= 0.0f)) return;
    V3 poly[MAXFV];
    bool mask[MAXFV];
    float dep[MAXFV];
    face_poly(t, bh, incident_face(t, h, nrm), poly, mask);
    for (int i = 0; i < t.fv; ++i) {
        const float dd = dot(poly[i], nrm) - pd;
        mask[i] = mask[i] && dd <= 0.0f;
        poly[i] = poly[i] - nrm * dd;
        dep[i] = -dd;
    }
    m.num = reduce_manifold(t.fv, poly, dep, mask, nrm, m.pts, m.dep);
    m.nrm = nrm;
    m.ref_is_a = false;
}

// Sphere (center ps, radius r) against another sphere: the point on the
// other sphere's surface toward this one; the other sphere is the
// reference.
__device__ void sphere_sphere(V3 ps, float r, V3 po, float ro, Manifold& m) {
    const V3 to_b = po - ps;
    const float dist = sqrtf(fmaxf(dot(to_b, to_b), 1e-30f));
    V3 n_ab = {to_b.x / dist, to_b.y / dist, to_b.z / dist};
    if (!(dist > 1e-12f)) n_ab = {0.0f, 0.0f, 1.0f};
    const float pen = r + ro - dist;
    const V3 n = -n_ab;
    one_point(m, pen >= 0.0f, n, po + n * ro, pen);
}

// Sphere against a plane (the reference).
__device__ void sphere_plane(V3 ps, float r, const Body& bp, Manifold& m) {
    const V3 n = qrot(bp.q, V3{0.0f, 0.0f, 1.0f});
    const float d = dot(n, bp.p);
    const float t = dot(n, ps) - d;
    const float pen = r - t;
    one_point(m, pen >= 0.0f, n, ps - n * t, pen);
}

// Sphere against a hull (the reference): the closest point of the hull's
// surface among its vertices, edges and face interiors; a center inside
// the hull takes the face of least penetration (the deep case).
__device__ void sphere_hull(const Tables& t, V3 ps, float r, const Body& bh,
                            Manifold& m) {
    Hull h;
    world_hull(t, bh, h);
    float fd[MAXF];
    float max_fd = 0.0f;
    int deep = 0;
    for (int f = 0; f < t.f; ++f) {
        fd[f] = dot(h.pn[f], ps) - h.pd[f];
        const float s = h.fmask[f] ? fd[f] : NEG_BIG;
        if (f == 0 || s > max_fd) { max_fd = s; deep = f; }
    }
    const bool inside = max_fd <= 0.0f;

    V3 best_pt = {0.0f, 0.0f, 0.0f};
    float best_d2 = 0.0f;
    for (int v = 0; v < t.v; ++v) {
        const V3 dv = h.verts[v] - ps;
        const float d2 = h.vmask[v] ? dot(dv, dv) : BIG;
        if (v == 0 || d2 < best_d2) { best_d2 = d2; best_pt = h.verts[v]; }
    }
    V3 e_best = {0.0f, 0.0f, 0.0f};
    float e_d2 = 0.0f;
    for (int e = 0; e < t.e; ++e) {
        const V3 p1 = xform_pt(bh, ld3(bh.row + t.o_e1 + 3 * e));
        const V3 p2 = xform_pt(bh, ld3(bh.row + t.o_e2 + 3 * e));
        const V3 ev = p2 - p1;
        float tt = dot(ps - p1, ev) / fmaxf(dot(ev, ev), 1e-12f);
        tt = fminf(fmaxf(tt, 0.0f), 1.0f);
        const V3 ept = p1 + ev * tt;
        const V3 de = ept - ps;
        const float d2 = bh.row[t.o_emask + e] > 0.5f ? dot(de, de) : BIG;
        if (e == 0 || d2 < e_d2) { e_d2 = d2; e_best = ept; }
    }
    if (e_d2 < best_d2) best_pt = e_best;
    best_d2 = fminf(e_d2, best_d2);

    V3 f_best = {0.0f, 0.0f, 0.0f};
    float f_d2min = 0.0f;
    for (int f = 0; f < t.f; ++f) {
        const V3 proj = ps - h.pn[f] * fd[f];
        V3 poly[MAXFV], nxt[MAXFV];
        bool mask[MAXFV];
        poly_next(poly, face_poly(t, bh, f, poly, mask), t.fv, nxt);
        bool in = true;
        for (int k = 0; k < t.fv; ++k) {
            const V3 side_n = cross(nxt[k] - poly[k], h.pn[f]);
            if (mask[k] && !(dot(side_n, proj - poly[k]) <= 1e-7f))
                in = false;
        }
        const bool ok = in && h.fmask[f] && fd[f] > 0.0f;
        const float d2 = ok ? fd[f] * fd[f] : BIG;
        if (f == 0 || d2 < f_d2min) { f_d2min = d2; f_best = proj; }
    }
    if (f_d2min < best_d2) best_pt = f_best;
    best_d2 = fminf(f_d2min, best_d2);

    const float dist = sqrtf(fmaxf(best_d2, 1e-30f));
    const V3 to_s = ps - best_pt;
    const V3 to_sphere = {to_s.x / dist, to_s.y / dist, to_s.z / dist};
    const V3 deep_n = h.pn[deep];
    const float depth = inside ? -max_fd + r : r - dist;
    one_point(m, depth >= 0.0f, inside ? deep_n : to_sphere,
              inside ? ps - deep_n * max_fd : best_pt, depth);
}

// Where a lane's outputs go: five worlds-minor buffers, field k of a lane
// at con[k * stride + at] (and pts alike).
struct Out {
    int* ref; int* alt; float* con; float* pts; int* num;
    size_t stride;
};

// One lane's outputs: the manifold, then its reduction (getAvgContact):
// the depth-weighted average point, the largest penetration, the ok flag.
__device__ void write_lane(const Out& o, size_t at, int ref, int alt,
                           const Manifold& m) {
    const int num = m.num;
    float wgt[4];
    for (int k = 0; k < 4; ++k) wgt[k] = k < num ? m.dep[k] : 0.0f;
    const float total = ((wgt[0] + wgt[1]) + wgt[2]) + wgt[3];
    const bool zero = total == 0.0f;
    const float den = zero ? 1.0f : total;
    V3 avg = {0.0f, 0.0f, 0.0f};
    float max_pen = NEG_BIG;
    for (int k = 0; k < 4; ++k) {
        const V3 term = m.pts[k] * (wgt[k] / den);
        avg = k == 0 ? term : avg + term;
        max_pen = fmaxf(max_pen, k < num ? m.dep[k] : NEG_BIG);
    }
    o.ref[at] = ref;
    o.alt[at] = alt;
    o.num[at] = num;
    const V3 nrm = m.nrm;
    const float con[kConF] = {nrm.x, nrm.y, nrm.z, avg.x, avg.y, avg.z,
                              max_pen,
                              (num > 0 && !zero) ? 1.0f : 0.0f};
    for (int k = 0; k < kConF; ++k) o.con[k * o.stride + at] = con[k];
    for (int k = 0; k < 4; ++k) {
        o.pts[(4 * k) * o.stride + at] = m.pts[k].x;
        o.pts[(4 * k + 1) * o.stride + at] = m.pts[k].y;
        o.pts[(4 * k + 2) * o.stride + at] = m.pts[k].z;
        o.pts[(4 * k + 3) * o.stride + at] = m.dep[k];
    }
}

// A lane without a contact: the sentinel row n, nothing live.
__device__ void write_empty(const Out& o, size_t at, int n) {
    o.ref[at] = n;
    o.alt[at] = n;
    o.num[at] = 0;
    for (int k = 0; k < kConF; ++k) o.con[k * o.stride + at] = 0.0f;
    for (int k = 0; k < kPtsF; ++k) o.pts[k * o.stride + at] = 0.0f;
}

// Whether the hull dimensions fit the per-thread tables above.
__host__ __device__ inline bool dims_fit(int v, int f, int fv, int e,
                                         int d) {
    return v <= MAXV && f <= MAXF && fv <= MAXFV && e <= MAXE && d <= MAXD &&
           v >= 1 && f >= 1 && fv >= 1 && d >= 1;
}
__host__ __device__ inline int pack_width(int v, int f, int fv, int e) {
    return 3 * v + v + 3 * f + f + 12 * e + e + 4 * f * fv;
}

}  // namespace
