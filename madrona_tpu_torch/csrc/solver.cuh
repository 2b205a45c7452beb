// XPBD substep device functions shared by the substep-solver and
// fused-step kernels (csrc/solver.cu, fused_step.cu): kLanes lanes of a
// warp per world (16 in the substep solver, 32 in the fused step), the
// world's bodies, parameters, contacts and joints in shared memory.
//
// Per world and per substep, on contacts frozen for the step: integrate
// (gravity, external force and torque, gyroscopic term, quaternion
// update); `iters` Jacobi passes of the contact position solve (normal
// correction, then static friction), each contact solved against the same
// snapshot and the 7-float pose deltas averaged per body; the fixed and
// hinge joints, averaged the same way; velocities from the pose change;
// the velocity solve (restitution on the average contact, dynamic friction
// per manifold point), averaged per body.
//
// A world's lanes own bodies in the per-body phases and contacts (or
// joints) in the per-constraint phases. A constraint lane writes its two
// bodies' deltas to shared memory; then each body lane sums the deltas of
// the constraints that name it, ref side first, then alt side, each in
// lane order. Contacts and joints are frozen for the step, so each body
// lane lists those constraints once a step (build_list) and every sum
// walks its list instead of scanning every lane. No atomics: the sum
// order is fixed, so a step is reproducible bit for bit. Rows outside the
// dynamic range are static by contract: they are loaded, read by the
// contacts that touch them and never written. A contact that is not ok,
// or that names the sentinel row, does nothing and never becomes an
// address. Its plain PyTorch version is
// madrona_tpu_torch/ops/solver_cuda.py::substep_solver_plain.

#pragma once

#include "vec.cuh"

namespace {

constexpr int kWorldsPerBlock = 8;
constexpr int kStateF = 13;
constexpr int kOutF = 33;
constexpr int kParamF = 20;
constexpr int kJntF = 23;
constexpr int kDeltaF = 14;      // two bodies x (3 position + 4 rotation)
constexpr size_t kMaxShared = 227 * 1024;

// rows of the shared body block, in the order of the out buffer
enum Field {
    F_X = 0, F_Q = 3, F_V = 7, F_W = 10, F_PREV_X = 13, F_PREV_Q = 16,
    F_PSX = 20, F_PSQ = 23, F_PSV = 27, F_PSW = 30
};
// rows of the params block
enum Param {
    P_INV_M = 0, P_INV_I = 1, P_MU_S = 4, P_MU_D = 5, P_DYNAMIC = 6,
    P_MOVING = 7, P_STATIC = 8, P_EXT_F = 9, P_EXT_T = 12, P_ACTIVE = 15,
    P_INV_M_RAW = 16, P_INV_I_RAW = 17
};

// One world's slice of shared memory. Every table is [field][row].
struct World {
    float* st;     // [kOutF][n]
    float* pr;     // [kParamF][n]
    float* con;    // [kConF][c]
    float* pts;    // [kPtsF][c]
    float* jnt;    // [kJntF][j]
    float* delta;  // [kDeltaF][max(c, j)]
    float* lam;    // [c]
    int* ref;      // [c]
    int* alt;      // [c]
    int* num;      // [c]
    int* live;     // [c] ok and both rows inside [0, n)
    int* je1;      // [j]
    int* je2;      // [j]
    int* jlive;    // [j]
    int* cofs;     // [n + 1] each body's contact entries: cent[cofs[b]..]
    int* cent;     // [2c] contact lists (build_list)
    int* jofs;     // [n + 1] the same for the joints
    int* jent;     // [2j]
    int n, c, j;
    int stride;    // row length of delta: max(c, j)

    __device__ V3 s3(int f, int b) const {
        return {st[f * n + b], st[(f + 1) * n + b], st[(f + 2) * n + b]};
    }
    __device__ Q4 s4(int f, int b) const {
        return {st[f * n + b], st[(f + 1) * n + b], st[(f + 2) * n + b],
                st[(f + 3) * n + b]};
    }
    __device__ void put3(int f, int b, V3 v) {
        st[f * n + b] = v.x; st[(f + 1) * n + b] = v.y;
        st[(f + 2) * n + b] = v.z;
    }
    __device__ void put4(int f, int b, Q4 q) {
        st[f * n + b] = q.w; st[(f + 1) * n + b] = q.x;
        st[(f + 2) * n + b] = q.y; st[(f + 3) * n + b] = q.z;
    }
    __device__ float p1(int f, int b) const { return pr[f * n + b]; }
    __device__ V3 p3(int f, int b) const {
        return {pr[f * n + b], pr[(f + 1) * n + b], pr[(f + 2) * n + b]};
    }
    __device__ V3 c3(int f, int k) const {
        return {con[f * c + k], con[(f + 1) * c + k], con[(f + 2) * c + k]};
    }
    __device__ V3 j3(int f, int k) const {
        return {jnt[f * j + k], jnt[(f + 1) * j + k], jnt[(f + 2) * j + k]};
    }
    __device__ Q4 j4(int f, int k) const {
        return {jnt[f * j + k], jnt[(f + 1) * j + k], jnt[(f + 2) * j + k],
                jnt[(f + 3) * j + k]};
    }
    // deltas of constraint k: side 0 at rows 0..6, side 1 at rows 7..13
    __device__ void put_delta(int k, int side, V3 dx, Q4 dq) {
        float* d = delta + (side * 7) * stride + k;
        d[0] = dx.x; d[stride] = dx.y; d[2 * stride] = dx.z;
        d[3 * stride] = dq.w; d[4 * stride] = dq.x; d[5 * stride] = dq.y;
        d[6 * stride] = dq.z;
    }
};

struct Args {
    const float* state; const float* param;
    const int* ref; const int* alt; const float* con; const float* pts;
    const int* num; const int* je1; const int* je2; const float* jnt;
    float* out;
    int n, c, j, w, substeps, iters, d0, d1, ref_live;
    float h, hgx, hgy, hgz, half_h, two_over_h, restitution, rest_thr;
};

struct PosUpdate { V3 x1, x2; Q4 q1, q2; float lam; };

// applyPositionalUpdate with compliance 0
__device__ PosUpdate apply_positional(V3 x1, V3 x2, Q4 q1, Q4 q2, V3 r1,
                                      V3 r2, float im1, float im2, V3 ii1,
                                      V3 ii2, V3 nrm, float c) {
    const V3 n_l1 = qrot(qinv(q1), nrm);
    const V3 n_l2 = qrot(qinv(q2), nrm);
    const V3 t1 = cross(r1, n_l1);
    const V3 t2 = cross(r2, n_l2);
    const V3 ra1 = mul(ii1, t1);
    const V3 ra2 = mul(ii2, t2);
    const float w1 = im1 + dot(t1, ra1);
    const float w2 = im2 + dot(t2, ra2);
    const float den = w1 + w2;
    // two immovable bodies would divide 0 by 0
    const float lam = den > 0.0f ? -c / den : 0.0f;
    PosUpdate u;
    u.x1 = x1 + nrm * (lam * im1);
    u.x2 = x2 - nrm * (lam * im2);
    const float half = 0.5f * lam;
    const V3 dq1 = qrot(q1, ra1 * half);
    const V3 dq2 = qrot(q2, ra2 * half);
    u.q1 = qnormalize(q1 + pure_mul(dq1, q1));
    u.q2 = qnormalize(q2 - pure_mul(dq2, q2));
    u.lam = lam;
    return u;
}

// getLocalSpaceContacts: the contact point in each body's presolve frame
__device__ void local_contacts(Q4 psq1, V3 psx1, Q4 psq2, V3 psx2, V3 pt,
                               float pen, V3 nrm, V3& r1, V3& r2) {
    const V3 contact2 = pt - nrm * pen;
    r1 = qrot(qinv(psq1), pt - psx1);
    r2 = qrot(qinv(psq2), contact2 - psx2);
}

// substepRigidBodies for body b: the pose and velocities after gravity,
// the external force and torque, the gyroscopic term and the quaternion
// update (rows that do not move keep their pose, velocities 0).
struct Integrated { V3 x, v, w; Q4 q; };

__device__ Integrated integrate_values(const World& s, const Args& a, int b) {
    const bool dyn = s.p1(P_DYNAMIC, b) > 0.5f;
    const bool mov = s.p1(P_MOVING, b) > 0.5f;
    const float inv_m = s.p1(P_INV_M_RAW, b);
    const V3 inv_i = s.p3(P_INV_I_RAW, b);
    const V3 x0 = s.s3(F_X, b), w0 = s.s3(F_W, b);
    const Q4 q0 = s.s4(F_Q, b);
    const V3 zero = {0.0f, 0.0f, 0.0f};

    V3 v = s.s3(F_V, b) + (dyn ? V3{a.hgx, a.hgy, a.hgz} : zero);
    v = v + s.p3(P_EXT_F, b) * (a.h * inv_m);
    const V3 x = x0 + v * a.h;

    const V3 inertia = {
        inv_i.x == 0.0f ? 0.0f : 1.0f / inv_i.x,
        inv_i.y == 0.0f ? 0.0f : 1.0f / inv_i.y,
        inv_i.z == 0.0f ? 0.0f : 1.0f / inv_i.z};
    const Q4 q_inv = qinv(q0);
    const V3 tau_l = qrot(q_inv, s.p3(P_EXT_T, b));
    V3 w_l = qrot(q_inv, w0);
    const V3 coriolis = cross(w_l, mul(inertia, w_l));
    w_l = w_l + mul(inv_i * a.h, tau_l - coriolis);
    const V3 omega = qrot(q0, w_l);
    const Q4 q = qnormalize(q0 + pure_mul(omega * a.half_h, q0));

    Integrated r;
    r.x = sel(mov, x, x0);
    r.q = sel(mov, q, q0);
    r.v = sel(mov, v, zero);
    r.w = sel(mov, omega, zero);
    return r;
}

__device__ void integrate_body(World& s, const Args& a, int b) {
    const bool stat = s.p1(P_STATIC, b) > 0.5f;
    const V3 x0 = s.s3(F_X, b), v0 = s.s3(F_V, b), w0 = s.s3(F_W, b);
    const Q4 q0 = s.s4(F_Q, b);
    const Integrated r = integrate_values(s, a, b);
    s.put3(F_PREV_X, b, x0);
    s.put4(F_PREV_Q, b, q0);
    s.put3(F_X, b, r.x);
    s.put4(F_Q, b, r.q);
    s.put3(F_V, b, sel(stat, v0, r.v));
    s.put3(F_W, b, sel(stat, w0, r.w));
    s.put3(F_PSX, b, r.x);
    s.put4(F_PSQ, b, r.q);
    s.put3(F_PSV, b, r.v);
    s.put3(F_PSW, b, r.w);
}

// handleContactConstraint for contact k: the normal correction, then
// static friction; leaves the two bodies' pose deltas in s.delta
__device__ void position_contact(World& s, int k) {
    const int r = s.ref[k], al = s.alt[k];
    const V3 nrm = s.c3(0, k), avg = s.c3(3, k);
    const float pen = s.con[6 * s.c + k];
    const V3 bx1 = s.s3(F_X, r), bx2 = s.s3(F_X, al);
    const Q4 bq1 = s.s4(F_Q, r), bq2 = s.s4(F_Q, al);
    const float im1 = s.p1(P_INV_M, r), im2 = s.p1(P_INV_M, al);
    const V3 ii1 = s.p3(P_INV_I, r), ii2 = s.p3(P_INV_I, al);
    const float mu_s = 0.5f * (s.p1(P_MU_S, r) + s.p1(P_MU_S, al));
    V3 r1, r2;
    local_contacts(s.s4(F_PSQ, r), s.s3(F_PSX, r), s.s4(F_PSQ, al),
                   s.s3(F_PSX, al), avg, pen, nrm, r1, r2);

    V3 x1 = bx1, x2 = bx2;
    Q4 q1 = bq1, q2 = bq2;
    V3 p1 = qrot(q1, r1) + x1;
    V3 p2 = qrot(q2, r2) + x2;
    const float d = dot(p1 - p2, nrm);
    const bool penetrating = d > 0.0f;
    float lam_n = 0.0f;
    if (penetrating) {
        const PosUpdate u = apply_positional(x1, x2, q1, q2, r1, r2, im1,
                                             im2, ii1, ii2, nrm, d);
        x1 = u.x1; x2 = u.x2; q1 = u.q1; q2 = u.q2; lam_n = u.lam;
    }

    const V3 p1_hat = qrot(s.s4(F_PREV_Q, r), r1) + s.s3(F_PREV_X, r);
    const V3 p2_hat = qrot(s.s4(F_PREV_Q, al), r2) + s.s3(F_PREV_X, al);
    p1 = qrot(q1, r1) + x1;
    p2 = qrot(q2, r2) + x2;
    const V3 dp = (p1 - p1_hat) - (p2 - p2_hat);
    const V3 dpt = dp - nrm * dot(dp, nrm);
    const float t_mag = sqrtf(fmaxf(dot(dpt, dpt), 1e-30f));
    const V3 t_world = {dpt.x / t_mag, dpt.y / t_mag, dpt.z / t_mag};
    const V3 ft1 = cross(r1, qrot(qinv(q1), t_world));
    const V3 ft2 = cross(r2, qrot(qinv(q2), t_world));
    const V3 fr1 = mul(ii1, ft1);
    const V3 fr2 = mul(ii2, ft2);
    const float den_t = (im1 + dot(ft1, fr1)) + (im2 + dot(ft2, fr2));
    const float lam_t = den_t > 0.0f ? -t_mag / den_t : 0.0f;
    // applies when lambda_t > lambda_n * mu_s (both negative)
    if (penetrating && t_mag > 0.0f && lam_t > lam_n * mu_s) {
        const float half = 0.5f * lam_t;
        const V3 dq1 = qrot(q1, fr1 * half);
        const V3 dq2 = qrot(q2, fr2 * half);
        x1 = x1 + t_world * (lam_t * im1);
        x2 = x2 - t_world * (lam_t * im2);
        q1 = qnormalize(q1 + pure_mul(dq1, q1));
        q2 = qnormalize(q2 - pure_mul(dq2, q2));
    }
    s.lam[k] += lam_n;
    s.put_delta(k, 0, x1 - bx1, q1 - bq1);
    s.put_delta(k, 1, x2 - bx2, q2 - bq2);
}

// Shared tail of the orientation and axis constraints.
__device__ void rotate_toward(Q4 q1, Q4 q2, V3 delta_q, V3 ii1, V3 ii2,
                              Q4& o1, Q4& o2) {
    const float mag = norm3(delta_q);
    o1 = q1; o2 = q2;
    if (!(mag > 0.0f)) return;
    const V3 n = {delta_q.x / mag, delta_q.y / mag, delta_q.z / mag};
    const V3 n1 = qrot(qinv(q1), n);
    const V3 n2 = qrot(qinv(q2), n);
    const V3 lra1 = mul(ii1, n1);
    const V3 lra2 = mul(ii2, n2);
    const float denom = dot(n1, lra1) + dot(n2, lra2);
    const float dl = denom == 0.0f ? 0.0f : -mag / denom;
    const float half = 0.5f * dl;
    const V3 u1 = qrot(q1, lra1 * half);
    const V3 u2 = qrot(q2, lra2 * half);
    o1 = qnormalize(q1 + pure_mul(u1, q1));
    o2 = qnormalize(q2 - pure_mul(u2, q2));
}

// One joint slot (fixed or hinge) against the snapshot.
__device__ void joint_slot(World& s, int k) {
    const int e1 = s.je1[k], e2 = s.je2[k];
    const V3 x1 = s.s3(F_X, e1), x2 = s.s3(F_X, e2);
    const Q4 q1 = s.s4(F_Q, e1), q2 = s.s4(F_Q, e2);
    const float im1 = s.p1(P_INV_M, e1), im2 = s.p1(P_INV_M, e2);
    const V3 ii1 = s.p3(P_INV_I, e1), ii2 = s.p3(P_INV_I, e2);
    const V3 r1 = s.j3(0, k), r2 = s.j3(3, k);
    const bool is_fixed = s.jnt[22 * s.j + k] > 0.5f;

    Q4 nq1, nq2;
    V3 corr;
    if (is_fixed) {
        const Q4 aq1 = s.j4(6, k), aq2 = s.j4(10, k);
        const Q4 o1 = qnormalize(qmul(q1, aq1));
        const Q4 o2 = qnormalize(qmul(q2, aq2));
        const Q4 diff = qmul(o1, qinv(o2));
        rotate_toward(q1, q2,
                      V3{2.0f * diff.x, 2.0f * diff.y, 2.0f * diff.z},
                      ii1, ii2, nq1, nq2);
        const V3 delta_r = (qrot(nq2, r2) + x2) - (qrot(nq1, r1) + x1);
        const Q4 axes_rot = qnormalize(qmul(nq1, aq1));
        const V3 a1 = qrot(axes_rot, V3{0.0f, 1.0f, 0.0f});
        const V3 b1 = qrot(axes_rot, V3{1.0f, 0.0f, 0.0f});
        const V3 c1 = cross(a1, b1);
        const float a_sep = dot(delta_r, a1) - s.jnt[14 * s.j + k];
        const float b_sep = dot(delta_r, b1);
        const float c_sep = dot(delta_r, c1);
        corr = {-a_sep * a1.x - b_sep * b1.x - c_sep * c1.x,
                -a_sep * a1.y - b_sep * b1.y - c_sep * c1.y,
                -a_sep * a1.z - b_sep * b1.z - c_sep * c1.z};
    } else {
        rotate_toward(q1, q2,
                      cross(qrot(q1, s.j3(15, k)), qrot(q2, s.j3(18, k))),
                      ii1, ii2, nq1, nq2);
        // converging sign (r1w - r2w), as the fixed branch
        corr = (qrot(nq1, r1) + x1) - (qrot(nq2, r2) + x2);
    }

    const float mag = norm3(corr);
    V3 ux1 = x1, ux2 = x2;
    Q4 uq1 = nq1, uq2 = nq2;
    if (mag > 0.0f) {
        const V3 n_dir = {corr.x / mag, corr.y / mag, corr.z / mag};
        const PosUpdate u = apply_positional(x1, x2, nq1, nq2, r1, r2, im1,
                                             im2, ii1, ii2, n_dir, mag);
        ux1 = u.x1; ux2 = u.x2; uq1 = u.q1; uq2 = u.q2;
    }
    s.put_delta(k, 0, ux1 - x1, uq1 - q1);
    s.put_delta(k, 1, ux2 - x2, uq2 - q2);
}

// The list of the constraints that name body b (in [d0, d1)): entries
// ent[ofs[b] .. ofs[b + 1]), side 0 (lanes below lanes0, entry k: delta
// rows 0..6) first, then side 1 (entry 7 * stride + k: rows 7..13), each
// in lane order. Lists of lower bodies come first; body b's lane writes
// ofs[b], and the last body's lane ofs[d1] too.
__device__ void build_list(const World& s, int b, int d0, int d1,
                           const int* rows0, const int* rows1,
                           const int* live, int lanes0, int lanes, int* ofs,
                           int* ent) {
    int start = 0, own = 0;
    for (int k = 0; k < lanes0; ++k) {
        if (!live[k]) continue;
        const int r = rows0[k];
        start += r >= d0 && r < b;
        own += r == b;
    }
    for (int k = 0; k < lanes; ++k) {
        if (!live[k]) continue;
        const int r = rows1[k];
        start += r >= d0 && r < b;
        own += r == b;
    }
    ofs[b] = start;
    if (b == d1 - 1) ofs[d1] = start + own;
    int e = start;
    for (int k = 0; k < lanes0; ++k)
        if (live[k] && rows0[k] == b) ent[e++] = k;
    for (int k = 0; k < lanes; ++k)
        if (live[k] && rows1[k] == b) ent[e++] = 7 * s.stride + k;
}

// Mean over the constraints of body b's list of their `width` delta rows:
// the side-0 sum and the side-1 sum, each in lane order, then their sum
// over the count, as a scan over every lane would add them.
__device__ void mean_delta(const World& s, int b, const int* ofs,
                           const int* ent, int width, float* mean) {
    const int stride = s.stride, side1 = 7 * stride;
    float sum0[7], sum1[7];
    for (int i = 0; i < width; ++i) sum0[i] = sum1[i] = 0.0f;
    const int lo = ofs[b], hi = ofs[b + 1];
    int e = lo;
    for (; e < hi && ent[e] < side1; ++e)
        for (int i = 0; i < width; ++i)
            sum0[i] += s.delta[i * stride + ent[e]];
    for (; e < hi; ++e)
        for (int i = 0; i < width; ++i)
            sum1[i] += s.delta[i * stride + ent[e]];
    const float count = fmaxf((float)(hi - lo), 1.0f);
    for (int i = 0; i < width; ++i) mean[i] = (sum0[i] + sum1[i]) / count;
}

// Add the mean pose delta to body b. Static rows are exactly invariant:
// no delta and no renormalisation.
__device__ void apply_pose_mean(World& s, int b, const float* mean) {
    if (s.p1(P_STATIC, b) > 0.5f) return;
    const V3 x = s.s3(F_X, b);
    const Q4 q = s.s4(F_Q, b);
    s.put3(F_X, b, x + V3{mean[0], mean[1], mean[2]});
    s.put4(F_Q, b, qnormalize(q + Q4{mean[3], mean[4], mean[5], mean[6]}));
}

__device__ void set_velocity(World& s, const Args& a, int b) {
    if (s.p1(P_STATIC, b) > 0.5f || !(s.p1(P_ACTIVE, b) > 0.5f)) return;
    const V3 x = s.s3(F_X, b), px = s.s3(F_PREV_X, b);
    const Q4 q = s.s4(F_Q, b), pq = s.s4(F_PREV_Q, b);
    const V3 v = {(x.x - px.x) / a.h, (x.y - px.y) / a.h,
                  (x.z - px.z) / a.h};
    const Q4 dq = qmul(q, qinv(pq));
    const bool same = q.w == pq.w && q.x == pq.x && q.y == pq.y &&
                      q.z == pq.z;
    V3 w = {a.two_over_h * dq.x, a.two_over_h * dq.y, a.two_over_h * dq.z};
    if (!(dq.w > 0.0f)) w = -w;
    if (same) w = {0.0f, 0.0f, 0.0f};
    s.put3(F_V, b, v);
    s.put3(F_W, b, w);
}

// Restitution on the average contact and dynamic friction per manifold
// point for contact k; leaves the two bodies' velocity deltas in s.delta.
__device__ void velocity_contact(World& s, const Args& a, int k) {
    const int r = s.ref[k], al = s.alt[k];
    const V3 nrm = s.c3(0, k), avg = s.c3(3, k);
    const float pen = s.con[6 * s.c + k];
    const Q4 q1 = s.s4(F_Q, r), q2 = s.s4(F_Q, al);
    const V3 v1 = s.s3(F_V, r), v2 = s.s3(F_V, al);
    const V3 w1 = s.s3(F_W, r), w2 = s.s3(F_W, al);
    const Q4 psq1 = s.s4(F_PSQ, r), psq2 = s.s4(F_PSQ, al);
    const V3 psx1 = s.s3(F_PSX, r), psx2 = s.s3(F_PSX, al);
    const float im1 = s.p1(P_INV_M, r), im2 = s.p1(P_INV_M, al);
    const V3 ii1 = s.p3(P_INV_I, r), ii2 = s.p3(P_INV_I, al);
    const float mu_d = 0.5f * (s.p1(P_MU_D, r) + s.p1(P_MU_D, al));

    V3 r1, r2;
    local_contacts(psq1, psx1, psq2, psx2, avg, pen, nrm, r1, r2);
    const V3 r1_pre = qrot(psq1, r1);
    const V3 r2_pre = qrot(psq2, r2);
    const V3 v_bar = (s.s3(F_PSV, r) + cross(s.s3(F_PSW, r), r1_pre)) -
                     (s.s3(F_PSV, al) + cross(s.s3(F_PSW, al), r2_pre));
    const float vn_bar = dot(nrm, v_bar);

    const V3 r1_world = qrot(q1, r1);
    const V3 r2_world = qrot(q2, r2);
    const V3 rt1 = cross(r1, qrot(qinv(q1), nrm));
    const V3 rt2 = cross(r2, qrot(qinv(q2), nrm));
    const V3 v_now = (v1 + cross(w1, r1_world)) - (v2 + cross(w2, r2_world));
    const float vn = dot(nrm, v_now);
    const float e = fabsf(vn_bar) <= a.rest_thr ? 0.0f : a.restitution;
    const float rest_mag = fminf(-e * vn_bar, 0.0f) - vn;
    const V3 rr1 = mul(ii1, rt1);
    const V3 rr2 = mul(ii2, rt2);
    const float den_r = (im1 + dot(rt1, rr1)) + (im2 + dot(rt2, rr2));
    const float imp = den_r > 0.0f ? rest_mag / den_r : 0.0f;
    const V3 dv1 = nrm * (imp * im1);
    const V3 dv2 = -(nrm * (imp * im2));
    const V3 dw1 = qrot(q1, rr1 * imp);
    const V3 dw2 = -qrot(q2, rr2 * imp);

    const int num = s.num[k];
    float pen_sum = 0.0f;
    for (int i = 0; i < 4; ++i)
        pen_sum += i < num ? s.pts[(4 * i + 3) * s.c + k] : 0.0f;
    const bool has_pen = pen_sum > 0.0f;
    const float lam_n = s.lam[k];

    V3 fdv1 = {0.0f, 0.0f, 0.0f}, fdv2 = fdv1, fdw1 = fdv1, fdw2 = fdv1;
    for (int i = 0; i < 4; ++i) {
        if (!(i < num && has_pen)) continue;
        const V3 cp = {s.pts[(4 * i) * s.c + k], s.pts[(4 * i + 1) * s.c + k],
                       s.pts[(4 * i + 2) * s.c + k]};
        const float pen_i = s.pts[(4 * i + 3) * s.c + k];
        V3 rr1_i, rr2_i;
        local_contacts(psq1, psx1, psq2, psx2, cp, pen_i, nrm, rr1_i, rr2_i);
        const V3 rw1 = qrot(q1, rr1_i);
        const V3 rw2 = qrot(q2, rr2_i);
        const float lam_pt = lam_n * (pen_i / pen_sum);
        V3 v_rel = (v1 + cross(w1 + dw1, rw1)) - (v2 + cross(w2 + dw2, rw2));
        // the restitution delta on the linear velocity too
        v_rel = v_rel + (dv1 - dv2);
        const float vn_f = dot(nrm, v_rel);
        const V3 vt = v_rel - nrm * vn_f;
        const float vt_len = sqrtf(fmaxf(dot(vt, vt), 1e-30f));
        if (!(vt_len > 1e-15f)) continue;
        const V3 t_dir = {vt.x / vt_len, vt.y / vt_len, vt.z / vt_len};
        const V3 fta1 = cross(rr1_i, qrot(qinv(q1), t_dir));
        const V3 fta2 = cross(rr2_i, qrot(qinv(q2), t_dir));
        const V3 fra1 = mul(ii1, fta1);
        const V3 fra2 = mul(ii2, fta2);
        const float den_f = (im1 + dot(fta1, fra1)) + (im2 + dot(fta2, fra2));
        const float inv_scale = den_f > 0.0f ? 1.0f / den_f : 0.0f;
        // inv_scale appears twice on purpose: the reference deviates from
        // the XPBD paper here (xpbd.cpp:834-842)
        const float dyn_mag = mu_d * fabsf(lam_pt) * inv_scale / a.h;
        const float f_imp = -fminf(dyn_mag, vt_len) * inv_scale;
        fdv1 = fdv1 + t_dir * (f_imp * im1);
        fdv2 = fdv2 - t_dir * (f_imp * im2);
        fdw1 = fdw1 + qrot(q1, fra1 * f_imp);
        fdw2 = fdw2 - qrot(q2, fra2 * f_imp);
    }
    const V3 a1 = dv1 + fdv1, b1 = dw1 + fdw1;
    const V3 a2 = dv2 + fdv2, b2 = dw2 + fdw2;
    s.put_delta(k, 0, a1, Q4{b1.x, b1.y, b1.z, 0.0f});
    s.put_delta(k, 1, a2, Q4{b2.x, b2.y, b2.z, 0.0f});
}

// Copy one worlds-minor table [rows, W] of this block's worlds to or from
// shared memory: 8 neighbouring threads touch 8 neighbouring worlds.
template <typename T>
__device__ void load_table(T* shared, size_t world_stride, const T* global,
                           int rows, int w0, int w) {
    for (int i = threadIdx.x; i < rows * kWorldsPerBlock; i += blockDim.x) {
        const int lw = i % kWorldsPerBlock, row = i / kWorldsPerBlock;
        if (w0 + lw < w)
            shared[lw * world_stride + row] =
                global[(size_t)row * w + w0 + lw];
    }
}

__host__ __device__ inline size_t floats_per_world(int n, int c, int j) {
    const int cj = c > j ? c : j;
    return (size_t)(kOutF + kParamF) * n + (size_t)(kConF + kPtsF + 1) * c +
           (size_t)kJntF * j + (size_t)kDeltaF * cj;
}
__host__ __device__ inline size_t ints_per_world(int n, int c, int j) {
    return (size_t)6 * c + (size_t)5 * j + 2 * ((size_t)n + 1);
}

// Offsets of the tables inside one world's float and int slices of shared
// memory (floats_per_world and ints_per_world long).
struct Layout {
    size_t fpw, ipw;
    size_t o_st, o_pr, o_con, o_pts, o_jnt, o_delta, o_lam;
    size_t o_ref, o_alt, o_num, o_live, o_je1, o_je2, o_jlive;
    size_t o_cofs, o_cent, o_jofs, o_jent;
};

__host__ __device__ inline Layout world_layout(int n, int c, int j) {
    const int cj = c > j ? c : j;
    Layout L;
    L.fpw = floats_per_world(n, c, j);
    L.ipw = ints_per_world(n, c, j);
    L.o_st = 0;
    L.o_pr = L.o_st + (size_t)kOutF * n;
    L.o_con = L.o_pr + (size_t)kParamF * n;
    L.o_pts = L.o_con + (size_t)kConF * c;
    L.o_jnt = L.o_pts + (size_t)kPtsF * c;
    L.o_delta = L.o_jnt + (size_t)kJntF * j;
    L.o_lam = L.o_delta + (size_t)kDeltaF * cj;
    L.o_ref = 0;
    L.o_alt = c;
    L.o_num = 2 * (size_t)c;
    L.o_live = 3 * (size_t)c;
    L.o_je1 = 4 * (size_t)c;
    L.o_je2 = L.o_je1 + j;
    L.o_jlive = L.o_je2 + j;
    L.o_cofs = L.o_jlive + j;
    L.o_cent = L.o_cofs + (size_t)n + 1;
    L.o_jofs = L.o_cent + 2 * (size_t)c;
    L.o_jent = L.o_jofs + (size_t)n + 1;
    return L;
}

// The World whose float slice starts at f and int slice at ip.
__device__ World world_at(const Layout& L, float* f, int* ip, int n, int c,
                          int j) {
    World s;
    s.st = f + L.o_st; s.pr = f + L.o_pr; s.con = f + L.o_con;
    s.pts = f + L.o_pts; s.jnt = f + L.o_jnt; s.delta = f + L.o_delta;
    s.lam = f + L.o_lam;
    s.ref = ip + L.o_ref; s.alt = ip + L.o_alt; s.num = ip + L.o_num;
    s.live = ip + L.o_live; s.je1 = ip + L.o_je1; s.je2 = ip + L.o_je2;
    s.jlive = ip + L.o_jlive;
    s.cofs = ip + L.o_cofs; s.cent = ip + L.o_cent;
    s.jofs = ip + L.o_jofs; s.jent = ip + L.o_jent;
    s.n = n; s.c = c; s.j = j; s.stride = c > j ? c : j;
    return s;
}

// The lanes of the caller's warp that serve its world: kLanes of the 32.
template <int kLanes>
__device__ __forceinline__ unsigned world_mask() {
    static_assert(kLanes == 16 || kLanes == 32, "16 or 32 lanes a world");
    if constexpr (kLanes == 32) return 0xffffffffu;
    else
        return ((1u << kLanes) - 1u) << ((threadIdx.x % 32) / kLanes * kLanes);
}

// Every substep of world s on its frozen contacts, by its kLanes lanes
// (lane in [0, kLanes)). Rows outside [a.d0, a.d1) are static by contract.
template <int kLanes>
__device__ void run_substeps(World& s, const Args& a, int lane) {
    const unsigned mask = world_mask<kLanes>();
    const int n = s.n, c = s.c, j = s.j;
    // the solver scratch of every row as integrate leaves a row that
    // does not move: previous and presolve pose = pose, presolve
    // velocities 0 (rows outside the dynamic range keep these)
    for (int b = lane; b < n; b += kLanes) {
        const V3 x = s.s3(F_X, b);
        const Q4 q = s.s4(F_Q, b);
        s.put3(F_PREV_X, b, x); s.put4(F_PREV_Q, b, q);
        s.put3(F_PSX, b, x); s.put4(F_PSQ, b, q);
        s.put3(F_PSV, b, V3{0.0f, 0.0f, 0.0f});
        s.put3(F_PSW, b, V3{0.0f, 0.0f, 0.0f});
    }
    for (int k = lane; k < c; k += kLanes) {
        const int r = s.ref[k], al = s.alt[k];
        s.live[k] = s.con[7 * c + k] > 0.5f && r >= 0 && r < n &&
                    al >= 0 && al < n;
    }
    for (int k = lane; k < j; k += kLanes) {
        const int e1 = s.je1[k], e2 = s.je2[k];
        s.jlive[k] = s.jnt[21 * j + k] > 0.5f && e1 >= 0 && e1 < n &&
                     e2 >= 0 && e2 < n;
    }
    __syncwarp(mask);
    // each body's contacts and joints, once a step
    for (int b = a.d0 + lane; b < a.d1; b += kLanes) {
        build_list(s, b, a.d0, a.d1, s.ref, s.alt, s.live, a.ref_live, c,
                   s.cofs, s.cent);
        if (j > 0)
            build_list(s, b, a.d0, a.d1, s.je1, s.je2, s.jlive, j, j, s.jofs,
                       s.jent);
    }
    __syncwarp(mask);

    float mean[7];
    for (int step = 0; step < a.substeps; ++step) {
        for (int b = a.d0 + lane; b < a.d1; b += kLanes)
            integrate_body(s, a, b);
        for (int k = lane; k < c; k += kLanes) s.lam[k] = 0.0f;
        __syncwarp(mask);

        for (int it = 0; it < a.iters; ++it) {
            for (int k = lane; k < c; k += kLanes)
                if (s.live[k]) position_contact(s, k);
            __syncwarp(mask);
            for (int b = a.d0 + lane; b < a.d1; b += kLanes) {
                mean_delta(s, b, s.cofs, s.cent, 7, mean);
                apply_pose_mean(s, b, mean);
            }
            __syncwarp(mask);
        }

        if (j > 0) {
            for (int k = lane; k < j; k += kLanes)
                if (s.jlive[k]) joint_slot(s, k);
            __syncwarp(mask);
            for (int b = a.d0 + lane; b < a.d1; b += kLanes) {
                mean_delta(s, b, s.jofs, s.jent, 7, mean);
                apply_pose_mean(s, b, mean);
            }
            __syncwarp(mask);
        }

        for (int b = a.d0 + lane; b < a.d1; b += kLanes)
            set_velocity(s, a, b);
        __syncwarp(mask);

        for (int k = lane; k < c; k += kLanes)
            if (s.live[k]) velocity_contact(s, a, k);
        __syncwarp(mask);
        for (int b = a.d0 + lane; b < a.d1; b += kLanes) {
            mean_delta(s, b, s.cofs, s.cent, 6, mean);
            s.put3(F_V, b, s.s3(F_V, b) + V3{mean[0], mean[1], mean[2]});
            s.put3(F_W, b, s.s3(F_W, b) + V3{mean[3], mean[4], mean[5]});
        }
        __syncwarp(mask);
    }
}

}  // namespace
