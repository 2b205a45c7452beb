// The hull-hull lane of csrc/sat.cuh computed by a whole warp: the
// contacts kernel (csrc/contacts.cu) gives each live hull-hull candidate
// of a tile with few of them a warp of its own.
//
// The SAT's independent pieces are spread over the warp's lanes, an item
// a lane (a lane taking every 32nd where there are more): the two hulls'
// vertices and face planes; the face queries, a face an item; the edge
// query, a direction pair (edge_dirs, up to 36) or an edge pair
// (edge_pairs, up to 144) an item; the clip's up to MAXCAND candidate
// points; the witness edges. Each
// value (a vertex, a separation, a dot product, an area) is still
// computed whole by one lane with sat.cuh's expressions in sat.cuh's
// order, so it rounds as the per-thread function's does. Only maxima,
// minima and arg-bests cross lanes. A small scan (a hull's faces or
// edges) is done in full by every lane from shared memory, as sat.cuh
// does it. A large one (the edge query, the reduction's candidates) is
// first a lane's own scan of its items in ascending order, then a
// butterfly of (value, index) pairs that keeps the greater value (the
// lesser for a minimum) and the lower index on a tie: the serial scan's
// first best on every input, ties included (no NaN reaches a scan). So
// the manifold equals sat.cuh's hull_hull bit for bit, and sat.cuh's
// per-thread functions stay as they are for the record and fused-step
// kernels.
//
// Every lane of the warp calls these functions together (full-warp
// masks); they leave the result in every lane.

#pragma once

#include "sat.cuh"

namespace {

constexpr int kNoIndex = 0x7fffffff;

// One hull in world space, in shared memory.
struct WarpHull {
    V3 verts[MAXV];
    V3 pn[MAXF];
    float pd[MAXF];
    V3 center;
    bool vmask[MAXV];
    bool fmask[MAXF];
};

// A warp's shared scratch for one hull-hull lane.
struct WarpScratch {
    WarpHull h[2];
    float fsep[2][MAXF];          // face query: least distance per face
    EdgeW edge[2][MAXE];          // edge_pairs: the world edges; edge_dirs:
    float wscore[2][MAXE];        // the witness edges' endpoints, scores
    V3 ref_poly[MAXFV], inc_poly[MAXFV], side_n[MAXFV];
    float side_d[MAXFV];
    bool ref_mask[MAXFV], inc_mask[MAXFV];
};

constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ V3 shfl3(V3 v, int src) {
    return {__shfl_sync(kFullWarp, v.x, src), __shfl_sync(kFullWarp, v.y, src),
            __shfl_sync(kFullWarp, v.z, src)};
}

// (value, index) of the first greatest (greater) or first least value
// over the warp; a lane without a value holds index kNoIndex
__device__ __forceinline__ void warp_argbest(float& v, int& idx,
                                             bool greater) {
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFullWarp, v, off);
        const int oi = __shfl_xor_sync(kFullWarp, idx, off);
        const bool better = greater ? ov > v : ov < v;
        if (oi != kNoIndex &&
            (idx == kNoIndex || better || (ov == v && oi < idx))) {
            v = ov;
            idx = oi;
        }
    }
}

// world_hull of both bodies: items [0, 16) the vertices (A's, then B's),
// [16, 28) the face planes (A's, then B's).
__device__ void warp_world_hulls(const Tables& t, const Body& ba,
                                  const Body& bb, WarpScratch& s,
                                  int lane) {
    for (int it = lane; it < 2 * MAXV + 2 * MAXF; it += 32) {
        if (it < 2 * MAXV) {
            const int side = it / MAXV, i = it % MAXV;
            const Body& b = side ? bb : ba;
            if (i < t.v) {
                s.h[side].verts[i] = xform_pt(b, ld3(b.row + 3 * i));
                s.h[side].vmask[i] = b.row[t.o_vmask + i] > 0.5f;
            }
        } else {
            const int side = (it - 2 * MAXV) / MAXF;
            const int f = (it - 2 * MAXV) % MAXF;
            const Body& b = side ? bb : ba;
            if (f < t.f) {
                const V3 pn = xform_n(b, ld3(b.row + t.o_pn + 3 * f));
                s.h[side].pn[f] = pn;
                s.h[side].pd[f] = dot(
                    pn, xform_pt(b, ld3(b.row + t.o_poly + 3 * f * t.fv)));
                s.h[side].fmask[f] = b.row[t.o_fmask + f] > 0.5f;
            }
        }
    }
    __syncwarp();
}

// The face queries (items [0, 12): A's faces against B's vertices, then
// B's against A's) and the two centers (items 12, 13), as world_hull and
// face_query compute them.
__device__ void warp_face_seps(const Tables& t, WarpScratch& s,
                                int lane) {
    for (int it = lane; it < 2 * MAXF + 2; it += 32) {
        if (it < 2 * MAXF) {
            const int side = it / MAXF, f = it % MAXF;
            if (f < t.f) {
                const WarpHull& a = s.h[side];
                const WarpHull& b = s.h[1 - side];
                float mn = BIG;
                for (int v = 0; v < t.v; ++v) {
                    const float d = b.vmask[v]
                                        ? dot(b.verts[v], a.pn[f]) - a.pd[f]
                                        : BIG;
                    mn = fminf(mn, d);
                }
                s.fsep[side][f] = a.fmask[f] ? mn : NEG_BIG;
            }
        } else {
            WarpHull& h = s.h[it - 2 * MAXF];
            int live = 0;
            V3 acc = {0.0f, 0.0f, 0.0f};
            for (int i = 0; i < t.v; ++i) {
                const V3 term =
                    h.vmask[i] ? h.verts[i] : V3{0.0f, 0.0f, 0.0f};
                acc = i == 0 ? term : acc + term;
                live += h.vmask[i];
            }
            const float denom = (float)(live > 1 ? live : 1);
            h.center = {acc.x / denom, acc.y / denom, acc.z / denom};
        }
    }
    __syncwarp();
}

// face_query's arg-best, by every lane
__device__ inline float warp_face_best(const Tables& t,
                                        const WarpScratch& s, int side,
                                        int& face) {
    float best = 0.0f;
    for (int f = 0; f < t.f; ++f) {
        const float sep = s.fsep[side][f];
        if (f == 0 || sep > best) { best = sep; face = f; }
    }
    return best;
}

// edge_query_dirs: an item per direction pair p = i * d + j
__device__ float warp_edge_dirs(const Tables& t, const Body& ba,
                                 const Body& bb, const WarpScratch& s,
                                 int lane, V3& n_e, int& i_star,
                                 int& j_star) {
    const WarpHull& ha = s.h[0];
    const WarpHull& hb = s.h[1];
    const V3 c_ab = hb.center - ha.center;
    float best = 0.0f;
    int idx = kNoIndex;
    V3 best_n = {0.0f, 0.0f, 0.0f};
    for (int p = lane; p < t.d * t.d; p += 32) {
        const int i = p / t.d, j = p % t.d;
        const V3 da = qrot(ba.q, mul(ld3(ba.drow + 3 * i), ba.s));
        const bool ma = ba.drow[3 * t.d + i] > 0.5f;
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
            min_b = fminf(min_b, hb.vmask[k] ? dot(nv, hb.verts[k]) : BIG);
        }
        const float sep = ok ? min_b - max_a : NEG_BIG;
        if (idx == kNoIndex || sep > best) { best = sep; idx = p; best_n = nv; }
    }
    warp_argbest(best, idx, true);
    n_e = shfl3(best_n, idx % 32);
    i_star = idx / t.d;
    j_star = idx % t.d;
    return best;
}

// edge_query_pairs: items [0, 24) the world edges (A's, then B's); then
// an item per edge pair p = i * e + j
__device__ float warp_edge_pairs(const Tables& t, const Body& ba,
                                  const Body& bb, WarpScratch& s,
                                  int lane, V3& n_e, V3& pa1,
                                  V3& pa2, V3& pb1, V3& pb2) {
    for (int it = lane; it < 2 * MAXE; it += 32) {
        const int side = it / MAXE, i = it % MAXE;
        if (i < t.e) s.edge[side][i] = world_edge(t, side ? bb : ba, i);
    }
    __syncwarp();
    const V3 center_a = s.h[0].center;
    float best = 0.0f;
    int idx = kNoIndex;
    V3 best_n = {0.0f, 0.0f, 0.0f};
    for (int p = lane; p < t.e * t.e; p += 32) {
        const int i = p / t.e, j = p % t.e;
        const EdgeW& ea = s.edge[0][i];
        const EdgeW& eb = s.edge[1][j];
        const V3 bxa = cross(ea.n2, ea.n1);
        const V3 da = ea.p2 - ea.p1;
        const V3 to_edge = ea.p1 - center_a;
        const V3 nb1 = -eb.n1, nb2 = -eb.n2;
        const V3 dxc = cross(nb2, nb1);
        const float cba = dot(nb1, bxa), dba = dot(nb2, bxa);
        const float adc = dot(ea.n1, dxc), bdc = dot(ea.n2, dxc);
        const bool mink = cba * dba < 0.0f && adc * bdc < 0.0f &&
                          cba * bdc > 0.0f;
        const V3 cr = cross(da, eb.p2 - eb.p1);
        const float len2 = dot(cr, cr);
        const bool ok = mink && len2 > 1e-12f && ea.live && eb.live;
        V3 nv = cr * (1.0f / sqrtf(fmaxf(len2, 1e-30f)));
        const float flip = dot(nv, to_edge) < 0.0f ? -1.0f : 1.0f;
        nv = nv * flip;
        const float sep = ok ? dot(nv, eb.p1 - ea.p1) : NEG_BIG;
        if (idx == kNoIndex || sep > best) { best = sep; idx = p; best_n = nv; }
    }
    warp_argbest(best, idx, true);
    if (idx == kNoIndex) {          // no edges: sat.cuh's sep_e of 0
        n_e = {0.0f, 0.0f, 0.0f};
        pa1 = pa2 = pb1 = pb2 = n_e;
        return 0.0f;
    }
    n_e = shfl3(best_n, idx % 32);
    const int i = idx / t.e, j = idx % t.e;
    pa1 = s.edge[0][i].p1; pa2 = s.edge[0][i].p2;
    pb1 = s.edge[1][j].p1; pb2 = s.edge[1][j].p2;
    return best;
}

// witness_edge of A (items [0, 12), pick_max) and of B (items [12, 24),
// pick_min): the scores by an item each, the arg-best by every lane.
__device__ void warp_witness_edges(const Tables& t, const Body& ba,
                                    const Body& bb, int i_star, int j_star,
                                    V3 n, WarpScratch& s, int lane,
                                    V3& pa1, V3& pa2, V3& pb1, V3& pb2) {
    for (int it = lane; it < 2 * MAXE; it += 32) {
        const int side = it / MAXE, e = it % MAXE;
        const Body& b = side ? bb : ba;
        if (e < t.e) {
            const V3 a = xform_pt(b, ld3(b.row + t.o_e1 + 3 * e));
            const V3 c = xform_pt(b, ld3(b.row + t.o_e2 + 3 * e));
            const V3 mid = (a + c) * 0.5f;
            float score = dot(mid, n);
            if (side) score = -score;
            const bool usable =
                fabsf(b.drow[4 * t.d + e] - (float)(side ? j_star : i_star))
                    < 0.5f &&
                b.row[t.o_emask + e] > 0.5f;
            s.wscore[side][e] = usable ? score : NEG_BIG;
            s.edge[side][e].p1 = a;
            s.edge[side][e].p2 = c;
        }
    }
    __syncwarp();
    for (int side = 0; side < 2; ++side) {
        float best = 0.0f;
        V3& p1 = side ? pb1 : pa1;
        V3& p2 = side ? pb2 : pa2;
        for (int e = 0; e < t.e; ++e) {
            const float score = s.wscore[side][e];
            if (e == 0 || score > best) {
                best = score;
                p1 = s.edge[side][e].p1;
                p2 = s.edge[side][e].p2;
            }
        }
    }
}

// reduce_manifold with candidate i in lane i (i < k <= 32): the first
// live one; the farthest from it; the largest |triangle area|; the one
// that most extends the triangle; each arg-best the first best.
__device__ int warp_reduce_manifold(int k, V3 pt, float dep, bool mask, V3 n,
                                    int lane, V3* pts4, float* dep4) {
    const bool mine = lane < k;
    const unsigned live = __ballot_sync(kFullWarp, mine && mask);
    const int n_pts = __popc(live);
    const int i0 = live ? __ffs(live) - 1 : 0;
    const V3 p0 = shfl3(pt, i0);
    bool avail = mine && mask && lane != i0;

    const V3 diff = pt - p0;
    float v1 = avail ? dot(diff, diff) : NEG_BIG;
    int i1 = mine ? lane : kNoIndex;
    warp_argbest(v1, i1, true);
    const V3 p1 = shfl3(pt, i1);
    avail = avail && lane != i1;

    const V3 ba = p1 - p0;
    const float sg = dot(n, cross(ba, pt - p1));
    float v2 = avail ? fabsf(sg) : NEG_BIG;
    int i2 = mine ? lane : kNoIndex;
    warp_argbest(v2, i2, true);
    const float s2 = __shfl_sync(kFullWarp, sg, i2);
    const V3 p2 = shfl3(pt, i2);
    avail = avail && lane != i2;

    // counter-clockwise winding for the fourth-point test
    const bool flip = s2 < 0.0f;
    const V3 q0 = flip ? p1 : p0, q1 = flip ? p0 : p1;
    const V3 ba2 = q1 - q0, cb = p2 - q1, ac = q0 - p2;
    const V3 aq = q0 - pt;
    const V3 qc = pt - p2;
    const float abq = dot(n, cross(ba2, aq));
    const float bcq = dot(n, cross(cb, qc));
    const float caq = dot(n, cross(aq, ac));
    float v3 = avail ? fminf(abq, fminf(bcq, caq)) : BIG;
    int i3 = mine ? lane : kNoIndex;
    warp_argbest(v3, i3, false);

    const float d0 = __shfl_sync(kFullWarp, dep, i0);
    const float d1 = __shfl_sync(kFullWarp, dep, i1);
    pts4[0] = q0; pts4[1] = q1; pts4[2] = p2; pts4[3] = shfl3(pt, i3);
    dep4[0] = flip ? d1 : d0;
    dep4[1] = flip ? d0 : d1;
    dep4[2] = __shfl_sync(kFullWarp, dep, i2);
    dep4[3] = __shfl_sync(kFullWarp, dep, i3);
    return n_pts < 4 ? n_pts : 4;
}

// sat.cuh's hull_hull, by the whole warp; m is the same in every lane.
__device__ void warp_hull_hull(const Tables& t, const Body& ba,
                               const Body& bb, bool pairs, WarpScratch& s,
                               int lane, Manifold& m) {
    m.num = 0;
    __syncwarp();                     // the last lane's readers are done
    warp_world_hulls(t, ba, bb, s, lane);
    warp_face_seps(t, s, lane);
    int face_a = 0, face_b = 0;
    const float sep_a = warp_face_best(t, s, 0, face_a);
    const float sep_b = warp_face_best(t, s, 1, face_b);

    V3 n_e, pa1, pa2, pb1, pb2;
    int i_star = 0, j_star = 0;
    const float sep_e =
        pairs ? warp_edge_pairs(t, ba, bb, s, lane, n_e, pa1, pa2, pb1, pb2)
              : warp_edge_dirs(t, ba, bb, s, lane, n_e, i_star, j_star);
    if (sep_a > 0.0f || sep_b > 0.0f || sep_e > 0.0f) return;
    const bool is_face =
        pairs ? (sep_a > sep_e || sep_b > sep_e)
              : (sep_a >= sep_e - 1e-5f || sep_b >= sep_e - 1e-5f);
    const bool a_is_ref = sep_a >= sep_b;

    if (is_face) {
        const Body& br = a_is_ref ? ba : bb;
        const Body& bo = a_is_ref ? bb : ba;
        const WarpHull& hr = s.h[a_is_ref ? 0 : 1];
        const WarpHull& ho = s.h[a_is_ref ? 1 : 0];
        const int ref_face = a_is_ref ? face_a : face_b;
        const V3 ref_n = hr.pn[ref_face];
        const float ref_d = hr.pd[ref_face];
        // incident_face: the first least dot, by every lane
        int inc_face = 0;
        float least = 0.0f;
        for (int f = 0; f < t.f; ++f) {
            const float d = ho.fmask[f] ? dot(ho.pn[f], ref_n) : BIG;
            if (f == 0 || d < least) { least = d; inc_face = f; }
        }
        // face_poly of both faces: items [0, 4) the reference face's
        // vertices, [4, 8) the incident face's
        for (int it = lane; it < 2 * MAXFV; it += 32) {
            const int side = it / MAXFV, i = it % MAXFV;
            if (i < t.fv) {
                const Body& b = side ? bo : br;
                const int face = side ? inc_face : ref_face;
                const V3 p = xform_pt(
                    b, ld3(b.row + t.o_poly + 3 * (face * t.fv + i)));
                const bool live = b.row[t.o_pmask + face * t.fv + i] > 0.5f;
                if (side) { s.inc_poly[i] = p; s.inc_mask[i] = live; }
                else { s.ref_poly[i] = p; s.ref_mask[i] = live; }
            }
        }
        __syncwarp();
        int ref_count = 0, inc_count = 0;
        for (int i = 0; i < t.fv; ++i) {
            ref_count += s.ref_mask[i];
            inc_count += s.inc_mask[i];
        }
        // poly_next
        auto next = [&](const V3* poly, int count, int i) {
            return (i == count - 1) ? poly[0] : poly[(i + 1) % t.fv];
        };
        for (int k = lane; k < t.fv; k += 32) {
            const V3 nxt = next(s.ref_poly, ref_count, k);
            const V3 sn = cross(nxt - s.ref_poly[k], ref_n);
            s.side_n[k] = sn;
            s.side_d[k] = dot(sn, s.ref_poly[k]);
        }
        __syncwarp();
        auto inside_all = [&](V3 p) {
            bool in = true;
            for (int k = 0; k < t.fv; ++k)
                if (s.ref_mask[k] &&
                    !(dot(p, s.side_n[k]) - s.side_d[k] <= 1e-6f))
                    in = false;
            return in;
        };
        // the clip's candidates, a lane each: incident vertices, then
        // incident-edge x side-plane crossings (incident edge major)
        const int nc = t.fv + t.fv * t.fv;
        V3 cand = {0.0f, 0.0f, 0.0f};
        bool below = false;
        if (lane < t.fv) {
            cand = s.inc_poly[lane];
            below = s.inc_mask[lane] && inside_all(cand);
        } else if (lane < nc) {
            const int i = (lane - t.fv) / t.fv, k = (lane - t.fv) % t.fv;
            const bool edge_live = s.inc_mask[i] && inc_count >= 2;
            const V3 p1 = s.inc_poly[i], p2 = next(s.inc_poly, inc_count, i);
            const float g1 = dot(p1, s.side_n[k]) - s.side_d[k];
            const float g2 = dot(p2, s.side_n[k]) - s.side_d[k];
            const bool crosses = (g1 > 0.0f) != (g2 > 0.0f);
            const float gd = g1 - g2;
            const float tt = g1 / (fabsf(gd) > 1e-12f ? gd : 1.0f);
            cand = p1 + (p2 - p1) * tt;
            below = edge_live && s.ref_mask[k] && crosses && inside_all(cand);
        }
        // keep what lies below the reference plane, projected onto it
        const float dd = dot(cand, ref_n) - ref_d;
        below = below && dd <= 0.0f;
        cand = cand - ref_n * dd;
        m.num = warp_reduce_manifold(nc, cand, -dd, below, ref_n, lane,
                                     m.pts, m.dep);
        m.nrm = ref_n;
    } else {
        if (!pairs)
            warp_witness_edges(t, ba, bb, i_star, j_star, n_e, s, lane, pa1,
                                pa2, pb1, pb2);
        // closest point on A's winning edge
        const V3 v1 = pa2 - pa1, v2 = pb2 - pb1, v21 = pb1 - pa1;
        const float d22 = dot(v2, v2), d11 = dot(v1, v1), d21 = dot(v2, v1);
        const float d211 = dot(v21, v1), d212 = dot(v21, v2);
        const float denom = d21 * d21 - d22 * d11;
        const float s_gen = (d212 * d21 - d22 * d211) /
                            (fabsf(denom) > 1e-12f ? denom : 1.0f);
        const float s_par = -d211 / (fabsf(d21) > 1e-12f ? d21 : 1.0f);
        const float sc = fminf(
            fmaxf(fabsf(denom) < 1e-5f ? s_par : s_gen, 0.0f), 1.0f);
        one_point(m, true, n_e, pa1 + v1 * sc, -sep_e);
    }
    m.ref_is_a = !is_face || a_is_ref;
}

}  // namespace
