// Narrowphase contacts of the candidate pairs, one thread per (lane, world).
//
// Replaces the Pallas TPU kernel madrona_tpu/ops/physics_megakernel.py
// (_contacts_kernel, built by make_contacts_kernel; hull-plane lane
// _hp_contacts) and the SAT body it calls, madrona_tpu/ops/
// narrowphase_pallas.py::hh_sat_planes. Its plain PyTorch version is
// madrona_tpu_torch/ops/contacts_cuda.py::contacts_plain; ref, alt and
// num are equal between the two, the floats agree to rounding.
//
// What it computes. Hull-hull lanes: both hulls to world space; the face
// query both ways (largest over A's faces of the least signed distance of
// B's vertices); the edge query over unique edge-direction pairs (support
// separation along cross(da, db), oriented from A to B); separated pairs
// drop out; a face contact (preferred within 1e-5) clips the incident
// face of the other hull against the side planes of the reference face,
// keeps the points below the reference plane, projects them onto it and
// reduces them to at most 4; an edge contact is the closest point on A's
// witness edge. Hull-plane lanes: the plane is the reference; the hull's
// face most against the plane normal, its vertices below the plane
// projected onto it, the same reduction. Every lane then gets its
// depth-weighted average point, largest penetration and ok flag.
//
// What bounds it on the H100: it depends on the data. A world moves about
// 2.8 KB (candidate rows, 21 poses, five output buffers); a live
// hull-hull lane costs 6,000-7,000 float operations and a live hull-plane
// lane about 1,500. On Escape Room data (hull-hull candidates are rare)
// the byte time is the larger one; on a crowded scene the operations are.
// Both are far below the launch latency of its two launches.
//
// What the design does about it: the two lane kinds are two __global__
// functions behind one C entry point, so a warp never mixes their work.
// Threads of a warp are 32 neighbouring worlds of one lane: their loads of
// the worlds-minor poses and their stores of the worlds-minor outputs
// coalesce, and in an env whose candidate order is the same in most worlds
// they take the same branches. A lane with no candidate, or a separated
// pair, stops at once. The hull tables of all objects (a few KB) are
// copied to shared memory per block; a thread keeps its world-space
// vertices and planes in local arrays and transforms face polygons and
// edges only when it needs them.
//
// Compiled with --fmad=false, and every sum written in the plain
// version's order: the separations feed comparisons that decide ref, alt
// and num, which must equal the plain version's.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int MAXV = 8, MAXF = 6, MAXFV = 4, MAXE = 12, MAXD = 6;
constexpr int MAXCAND = MAXFV + MAXFV * MAXFV;
constexpr float BIG = 3.0e38f, NEG_BIG = -3.0e38f;
constexpr int kConF = 8, kPtsF = 16;

struct V3 { float x, y, z; };
struct Q4 { float w, x, y, z; };

__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
    return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
    return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator*(V3 a, float s) {
    return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
    return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 qrot(Q4 q, V3 v) {
    const V3 u = {q.x, q.y, q.z};
    const V3 uv = cross(u, v);
    const V3 uuv = cross(u, uv);
    return {v.x + 2.0f * (q.w * uv.x + uuv.x),
            v.y + 2.0f * (q.w * uv.y + uuv.y),
            v.z + 2.0f * (q.w * uv.z + uuv.z)};
}

// The packed hull tables (physics/bodies.py::_pack_hull and the edge
// direction pack) of every object, in shared memory.
struct Tables {
    const float* pack;   // [n_obj, k]
    const float* dirs;   // [n_obj, kd]
    int v, f, fv, e, d, k, kd;
    // offsets inside a pack row
    int o_vmask, o_pn, o_fmask, o_e1, o_e2, o_emask, o_poly, o_pmask;
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
    t.o_emask = t.o_e2 + 9 * e;          // skips the two edge-normal blocks
    t.o_poly = t.o_emask + e;
    t.o_pmask = t.o_poly + 3 * f * fv;
    t.k = t.o_pmask + f * fv;
    t.kd = 4 * d + e;
    return t;
}

__device__ __forceinline__ V3 ld3(const float* p) { return {p[0], p[1], p[2]}; }

// One body's pose and its rows of the tables.
struct Body {
    V3 p; Q4 q; V3 s;
    const float* row;
    const float* drow;
};

__device__ Body load_body(const Tables& t, const float* poses, const int* obj,
                          int row, int w, int num_worlds) {
    const float* p = poses + (size_t)row * 10 * num_worlds + w;
    const size_t s = num_worlds;
    Body b;
    b.p = {p[0], p[s], p[2 * s]};
    b.q = {p[3 * s], p[4 * s], p[5 * s], p[6 * s]};
    b.s = {p[7 * s], p[8 * s], p[9 * s]};
    const int o = obj[(size_t)row * num_worlds + w];
    b.row = t.pack + (size_t)o * t.k;
    b.drow = t.dirs + (size_t)o * t.kd;
    return b;
}

__device__ __forceinline__ V3 xform_pt(const Body& b, V3 local) {
    return qrot(b.q, mul(local, b.s)) + b.p;
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
        const V3 nl = ld3(b.row + t.o_pn + 3 * f);
        const V3 r = qrot(b.q, V3{nl.x / fmaxf(b.s.x, 1e-12f),
                                  nl.y / fmaxf(b.s.y, 1e-12f),
                                  nl.z / fmaxf(b.s.z, 1e-12f)});
        const float l2 = dot(r, r);
        const float inv = l2 > 0.0f ? 1.0f / sqrtf(fmaxf(l2, 1e-30f)) : 0.0f;
        h.pn[f] = r * inv;
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

struct Out {
    int* ref; int* alt; float* con; float* pts; int* num;
    int c, num_worlds;
};

// One lane's outputs: the manifold, then its reduction (getAvgContact).
__device__ void write_lane(const Out& o, int lane, int w, int ref, int alt,
                           int num, V3 nrm, const V3* pts4,
                           const float* dep4) {
    const size_t cw = (size_t)o.c * o.num_worlds;
    const size_t at = (size_t)lane * o.num_worlds + w;
    float wgt[4];
    for (int k = 0; k < 4; ++k) wgt[k] = k < num ? dep4[k] : 0.0f;
    const float total = ((wgt[0] + wgt[1]) + wgt[2]) + wgt[3];
    const bool zero = total == 0.0f;
    const float den = zero ? 1.0f : total;
    V3 avg = {0.0f, 0.0f, 0.0f};
    float max_pen = NEG_BIG;
    for (int k = 0; k < 4; ++k) {
        const V3 term = pts4[k] * (wgt[k] / den);
        avg = k == 0 ? term : avg + term;
        max_pen = fmaxf(max_pen, k < num ? dep4[k] : NEG_BIG);
    }
    o.ref[at] = ref;
    o.alt[at] = alt;
    o.num[at] = num;
    const float con[kConF] = {nrm.x, nrm.y, nrm.z, avg.x, avg.y, avg.z,
                              max_pen,
                              (num > 0 && !zero) ? 1.0f : 0.0f};
    for (int k = 0; k < kConF; ++k) o.con[k * cw + at] = con[k];
    for (int k = 0; k < 4; ++k) {
        o.pts[(4 * k) * cw + at] = pts4[k].x;
        o.pts[(4 * k + 1) * cw + at] = pts4[k].y;
        o.pts[(4 * k + 2) * cw + at] = pts4[k].z;
        o.pts[(4 * k + 3) * cw + at] = dep4[k];
    }
}

// A lane without a contact: the sentinel row n, nothing live.
__device__ void write_empty(const Out& o, int lane, int w, int n) {
    const size_t cw = (size_t)o.c * o.num_worlds;
    const size_t at = (size_t)lane * o.num_worlds + w;
    o.ref[at] = n;
    o.alt[at] = n;
    o.num[at] = 0;
    for (int k = 0; k < kConF; ++k) o.con[k * cw + at] = 0.0f;
    for (int k = 0; k < kPtsF; ++k) o.pts[k * cw + at] = 0.0f;
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

__global__ void __launch_bounds__(kThreads) hull_hull_kernel(
    const int* __restrict__ hh, const float* __restrict__ poses,
    const int* __restrict__ obj, const float* __restrict__ pack,
    const float* __restrict__ dirs, Out o, int n, int ph, int n_obj,
    int v, int f, int fv, int e, int d) {
    extern __shared__ float smem[];
    const Tables t = stage_tables(smem, pack, dirs, n_obj, v, f, fv, e, d);
    const int w = blockIdx.x * blockDim.x + threadIdx.x;
    const int lane = blockIdx.y;
    if (w >= o.num_worlds) return;

    const int row_a = hh[((size_t)w * ph + lane) * 2];
    const int row_b = hh[((size_t)w * ph + lane) * 2 + 1];
    if (!(row_a >= 0 && row_a < n && row_b >= 0 && row_b < n)) {
        write_empty(o, lane, w, n);
        return;
    }
    const Body ba = load_body(t, poses, obj, row_a, w, o.num_worlds);
    const Body bb = load_body(t, poses, obj, row_b, w, o.num_worlds);
    Hull ha, hb;
    world_hull(t, ba, ha);
    world_hull(t, bb, hb);

    int face_a = 0, face_b = 0;
    const float sep_a = face_query(t, ha, hb, face_a);
    const float sep_b = face_query(t, hb, ha, face_b);

    // edge query over unique direction pairs, i-major, first best
    const V3 c_ab = hb.center - ha.center;
    float sep_e = 0.0f;
    V3 n_e = {0.0f, 0.0f, 0.0f};
    int i_star = 0, j_star = 0;
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

    if (sep_a > 0.0f || sep_b > 0.0f || sep_e > 0.0f) {
        write_empty(o, lane, w, n);
        return;
    }
    // face preference under near-ties: the direction family contains axes
    // numerically equal to face normals
    const bool is_face = sep_a >= sep_e - 1e-5f || sep_b >= sep_e - 1e-5f;
    const bool a_is_ref = sep_a >= sep_b;

    V3 pts4[4];
    float dep4[4];
    V3 nrm;
    int num;
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
        num = reduce_manifold(nc, cand, cdep, below, ref_n, pts4, dep4);
        nrm = ref_n;
    } else {
        V3 pa1, pa2, pb1, pb2;
        witness_edge(t, ba, i_star, n_e, true, pa1, pa2);
        witness_edge(t, bb, j_star, n_e, false, pb1, pb2);
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
        pts4[0] = pa1 + v1 * s;
        dep4[0] = -sep_e;
        for (int k = 1; k < 4; ++k) {
            pts4[k] = {0.0f, 0.0f, 0.0f};
            dep4[k] = 0.0f;
        }
        num = 1;
        nrm = n_e;
    }
    if (num <= 0) {
        write_empty(o, lane, w, n);
        return;
    }
    const bool ref_is_a = !is_face || a_is_ref;
    write_lane(o, lane, w, ref_is_a ? row_a : row_b, ref_is_a ? row_b : row_a,
               num, nrm, pts4, dep4);
}

__global__ void __launch_bounds__(kThreads) hull_plane_kernel(
    const int* __restrict__ hp, const float* __restrict__ poses,
    const int* __restrict__ obj, const float* __restrict__ pack,
    const float* __restrict__ dirs, Out o, int n, int ph, int pp, int n_obj,
    int v, int f, int fv, int e, int d) {
    extern __shared__ float smem[];
    const Tables t = stage_tables(smem, pack, dirs, n_obj, v, f, fv, e, d);
    const int w = blockIdx.x * blockDim.x + threadIdx.x;
    const int slot = blockIdx.y;
    const int lane = ph + slot;
    if (w >= o.num_worlds) return;

    const int row_h = hp[((size_t)w * pp + slot) * 2];
    const int row_p = hp[((size_t)w * pp + slot) * 2 + 1];
    if (!(row_h >= 0 && row_h < n && row_p >= 0 && row_p < n)) {
        write_empty(o, lane, w, n);
        return;
    }
    const Body bh = load_body(t, poses, obj, row_h, w, o.num_worlds);
    const Body bp = load_body(t, poses, obj, row_p, w, o.num_worlds);
    Hull h;
    world_hull(t, bh, h);

    // the plane's normal is its local +z
    const V3 nrm = qrot(bp.q, V3{0.0f, 0.0f, 1.0f});
    const float pd = dot(nrm, bp.p);
    float separation = BIG;
    for (int k = 0; k < t.v; ++k)
        separation = fminf(separation,
                           h.vmask[k] ? dot(h.verts[k], nrm) - pd : BIG);
    if (!(separation <= 0.0f)) {
        write_empty(o, lane, w, n);
        return;
    }
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
    V3 pts4[4];
    float dep4[4];
    const int num = reduce_manifold(t.fv, poly, dep, mask, nrm, pts4, dep4);
    if (num <= 0) {
        write_empty(o, lane, w, n);
        return;
    }
    // the plane is the reference, the hull the other body
    write_lane(o, lane, w, row_p, row_h, num, nrm, pts4, dep4);
}

}  // namespace

extern "C" int contacts_launch(
    const void* hh, const void* hp, const void* poses, const void* obj,
    const void* pack, const void* dirs, void* ref, void* alt, void* con,
    void* pts, void* num,
    int n, int num_worlds, int ph, int pp, int n_obj, int v, int f, int fv,
    int e, int d, void* stream) {
    if (v > MAXV || f > MAXF || fv > MAXFV || e > MAXE || d > MAXD || d < 1 ||
        n < 1 || num_worlds < 1 || ph < 0 || pp < 0)
        return (int)cudaErrorInvalidValue;
    const int k = 3 * v + v + 3 * f + f + 12 * e + e + 4 * f * fv;
    const size_t bytes = (size_t)n_obj * (k + 4 * d + e) * sizeof(float);
    if (bytes > 48 * 1024) return (int)cudaErrorInvalidValue;
    Out o{(int*)ref, (int*)alt, (float*)con, (float*)pts, (int*)num,
          ph + pp, num_worlds};
    const int blocks = (num_worlds + kThreads - 1) / kThreads;
    cudaStream_t s = (cudaStream_t)stream;
    if (ph > 0) {
        hull_hull_kernel<<<dim3(blocks, ph), kThreads, bytes, s>>>(
            (const int*)hh, (const float*)poses, (const int*)obj,
            (const float*)pack, (const float*)dirs, o, n, ph, n_obj,
            v, f, fv, e, d);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    if (pp > 0) {
        hull_plane_kernel<<<dim3(blocks, pp), kThreads, bytes, s>>>(
            (const int*)hp, (const float*)poses, (const int*)obj,
            (const float*)pack, (const float*)dirs, o, n, ph, pp, n_obj,
            v, f, fv, e, d);
    }
    return (int)cudaGetLastError();
}
