// The whole physics step in one launch, one warp per world: integrate at
// the predicted pose, every narrowphase lane (hull-hull, hull-plane,
// sphere) into shared memory, then every XPBD substep on those contacts.
//
// Replaces the Pallas TPU kernel madrona_tpu/ops/physics_megakernel.py
// (_fused_kernel, built by make_fused_step; its sphere lanes _sp_contacts
// and _sphere_hull_planes). Its plain PyTorch version is
// madrona_tpu_torch/ops/fused_cuda.py::fused_step_plain: xpbd.integrate,
// the tensor narrowphase, the manifold reduction and the plain substep
// solver with no dynamic range.
//
// What it computes, per world: the predicted pose of every body (one
// substep of integrate, csrc/solver.cuh::integrate_values); the contact
// lanes [hull-hull | hull-plane | sphere] at those poses (csrc/sat.cuh,
// either SAT tier); each lane's depth-weighted average point, largest
// penetration and ok flag; then every substep of csrc/solver.cuh over all
// rows (no dynamic range, every contact lane with its ref-side update: the
// fused step takes none of the env's layout contracts).
//
// What bounds it on the H100: the operations of the live lanes (a
// hull-hull candidate 3,800 up to its separation test, a manifold
// 2,000-3,300, a hull-plane lane about 1,500, a sphere-hull lane about
// 3,100) and of the substeps (about 2,000 per live contact and substep);
// the bytes are the state in (53 floats per body) and out (33) once. In
// practice it is latency: long dependent chains and one warp per world.
//
// What the design does about it: the contacts never leave shared memory,
// and the state of a world goes to global memory once, at the end. A block
// holds 8 worlds, one warp each, as the substep-solver kernel does; the
// block's threads load and store the worlds-minor buffers so that 8
// neighbouring threads touch 8 neighbouring worlds. The hull tables and the
// objects' sphere radii (a few KB) are staged in shared memory per block.
// In the narrowphase, lane k of a warp computes contact lanes k, k + 32,
// ... of its world; in the substeps, lanes own bodies and constraints as in
// csrc/solver.cu. No atomics: a step is reproducible bit for bit. Compiled
// with --fmad=false, every sum in the plain versions' order.

#include "sat.cuh"
#include "solver.cuh"

namespace {

constexpr int kPoseF = 10;       // predicted pos xyz | rot wxyz | scale xyz

struct Narrow {
    const int* hh; const int* hp; const int* sp; const int* sp_kind;
    int ph, pp, ps, pairs, type_plane, type_hull;
};

// Contact lane k of world w (lane order [hull-hull | hull-plane | sphere])
// at the predicted poses, into the world's contact tables.
__device__ void narrow_lane(const Tables& t, const float* radius,
                            const Narrow& nw, const Out& o, const float* pose,
                            const int* obj, int n, int w, int k) {
    int row0, row1, seg, kind = 0;
    if (k < nw.ph) {
        const int* c = nw.hh + ((size_t)w * nw.ph + k) * 2;
        row0 = c[0]; row1 = c[1]; seg = 0;
    } else if (k < nw.ph + nw.pp) {
        const int* c = nw.hp + ((size_t)w * nw.pp + (k - nw.ph)) * 2;
        row0 = c[0]; row1 = c[1]; seg = 1;
    } else {
        const int slot = k - nw.ph - nw.pp;
        const int* c = nw.sp + ((size_t)w * nw.ps + slot) * 2;
        row0 = c[0]; row1 = c[1]; seg = 2;
        kind = nw.sp_kind[(size_t)w * nw.ps + slot];
    }
    if (!(row0 >= 0 && row0 < n && row1 >= 0 && row1 < n)) {
        write_empty(o, k, n);
        return;
    }
    const Body b0 = load_body(t, pose + row0, n, obj[row0]);
    const Body b1 = load_body(t, pose + row1, n, obj[row1]);
    Manifold m;
    int ref = row1, alt = row0;     // the second body is the reference
    if (seg == 0) {
        hull_hull(t, b0, b1, nw.pairs != 0, m);
        if (m.ref_is_a) { ref = row0; alt = row1; }
    } else if (seg == 1) {
        hull_plane(t, b0, b1, m);
    } else {
        const float r = radius[obj[row0]] * b0.s.x;
        if (kind == nw.type_plane)
            sphere_plane(b0.p, r, b1, m);
        else if (kind == nw.type_hull)
            sphere_hull(t, b0.p, r, b1, m);
        else
            sphere_sphere(b0.p, r, b1.p, radius[obj[row1]] * b1.s.x, m);
    }
    if (m.num <= 0) {
        write_empty(o, k, n);
        return;
    }
    write_lane(o, k, ref, alt, m);
}

struct FusedArgs {
    Args a;
    Narrow nw;
    const float* scale; const int* obj;
    const float* pack; const float* dirs; const float* radius;
    // where not null: the contact tables as the narrowphase left them,
    // in the substep-solver kernel's input layout (for checking only)
    int* lane_ref; int* lane_alt; float* lane_con; float* lane_pts;
    int* lane_num;
    int n_obj, v, f, fv, e, d;
};

// The world's contact tables [rows][c] in shared memory -> [rows, c, W].
template <typename T>
__device__ void store_lanes(T* dst, const T* src, int rows, int c, int w,
                            int nw, int lane) {
    for (int i = lane; i < rows * c; i += 32)
        dst[(size_t)i * nw + w] = src[i];
}

__host__ __device__ inline size_t table_floats(int n_obj, int v, int f,
                                               int fv, int e, int d) {
    return (size_t)n_obj * (pack_width(v, f, fv, e) + 4 * d + e + 1);
}

__global__ void __launch_bounds__(kThreads) fused_kernel(FusedArgs fa) {
    extern __shared__ float smem[];
    const Args& a = fa.a;
    const int n = a.n, c = a.c, j = a.j;
    const Tables t = stage_tables(smem, fa.pack, fa.dirs, fa.n_obj, fa.v,
                                  fa.f, fa.fv, fa.e, fa.d);
    float* radius = smem + (size_t)fa.n_obj * (t.k + t.kd);
    for (int i = threadIdx.x; i < fa.n_obj; i += kThreads)
        radius[i] = fa.radius[i];

    const Layout L = world_layout(n, c, j);
    // per world: the solver's floats, then the predicted poses [10][n];
    // the solver's ints, then the object ids [n]
    const size_t fstride = L.fpw + (size_t)kPoseF * n;
    const size_t istride = L.ipw + (size_t)n;
    float* fbase = smem + table_floats(fa.n_obj, fa.v, fa.f, fa.fv, fa.e,
                                       fa.d);
    int* ibase = reinterpret_cast<int*>(fbase + fstride * kWorldsPerBlock);
    const int w0 = blockIdx.x * kWorldsPerBlock;

    load_table(fbase + L.o_st, fstride, a.state, kStateF * n, w0, a.w);
    load_table(fbase + L.o_pr, fstride, a.param, kParamF * n, w0, a.w);
    load_table(fbase + L.fpw + 7 * (size_t)n, fstride, fa.scale, 3 * n, w0,
               a.w);
    load_table(ibase + L.ipw, istride, fa.obj, n, w0, a.w);
    if (j > 0) {
        load_table(fbase + L.o_jnt, fstride, a.jnt, kJntF * j, w0, a.w);
        load_table(ibase + L.o_je1, istride, a.je1, j, w0, a.w);
        load_table(ibase + L.o_je2, istride, a.je2, j, w0, a.w);
    }
    __syncthreads();

    const int lw = threadIdx.x / 32, lane = threadIdx.x % 32;
    float* fw = fbase + lw * fstride;
    int* iw = ibase + lw * istride;
    World s = world_at(L, fw, iw, n, c, j);
    if (w0 + lw < a.w) {
        float* pose = fw + L.fpw;
        const int* obj = iw + L.ipw;
        for (int b = lane; b < n; b += 32) {
            const Integrated r = integrate_values(s, a, b);
            pose[0 * n + b] = r.x.x;
            pose[1 * n + b] = r.x.y;
            pose[2 * n + b] = r.x.z;
            pose[3 * n + b] = r.q.w;
            pose[4 * n + b] = r.q.x;
            pose[5 * n + b] = r.q.y;
            pose[6 * n + b] = r.q.z;
        }
        __syncwarp();
        const Out o{s.ref, s.alt, s.con, s.pts, s.num, (size_t)c};
        for (int k = lane; k < c; k += 32)
            narrow_lane(t, radius, fa.nw, o, pose, obj, n, w0 + lw, k);
        __syncwarp();
        if (fa.lane_num != nullptr) {
            const int w = w0 + lw;
            store_lanes(fa.lane_ref, s.ref, 1, c, w, a.w, lane);
            store_lanes(fa.lane_alt, s.alt, 1, c, w, a.w, lane);
            store_lanes(fa.lane_num, s.num, 1, c, w, a.w, lane);
            store_lanes(fa.lane_con, s.con, kConF, c, w, a.w, lane);
            store_lanes(fa.lane_pts, s.pts, kPtsF, c, w, a.w, lane);
        }
        run_substeps(s, a, lane);
    }
    __syncthreads();

    for (int i = threadIdx.x; i < kOutF * n * kWorldsPerBlock; i += kThreads) {
        const int ow = i % kWorldsPerBlock, row = i / kWorldsPerBlock;
        if (w0 + ow < a.w)
            a.out[(size_t)row * a.w + w0 + ow] =
                fbase[ow * fstride + L.o_st + row];
    }
}

}  // namespace

// state [13, N, W], param [20, N, W], scale [3, N, W], obj [N, W] int32,
// hh [W, PH, 2], hp [W, PP, 2], sp [W, PS, 2], sp_kind [W, PS] int32,
// the hull tables, radius [n_obj], je1/je2 [J, W] int32, jnt [23, J, W]
// -> out [33, N, W]. pairs != 0: the edge_pairs SAT tier; else edge_dirs.
// lane_ref/alt/num [C, W] int32, lane_con [8, C, W], lane_pts [16, C, W]:
// all null, or where the narrowphase's contact tables are written.
extern "C" int fused_launch(
    const void* state, const void* param, const void* scale, const void* obj,
    const void* hh, const void* hp, const void* sp, const void* sp_kind,
    const void* pack, const void* dirs, const void* radius, const void* je1,
    const void* je2, const void* jnt, void* out, void* lane_ref,
    void* lane_alt, void* lane_con, void* lane_pts, void* lane_num,
    int n, int ph, int pp, int ps, int j, int w, int substeps, int iters,
    int n_obj, int v, int f, int fv, int e, int d, int pairs, int type_plane,
    int type_hull,
    float h, float hgx, float hgy, float hgz, float half_h, float two_over_h,
    float restitution, float rest_thr, void* stream) {
    const int c = ph + pp + ps;
    if (!dims_fit(v, f, fv, e, d) || n < 1 || w < 1 || ph < 0 || pp < 0 ||
        ps < 0 || j < 0 || n_obj < 1)
        return (int)cudaErrorInvalidValue;
    const Layout L = world_layout(n, c, j);
    const size_t bytes =
        table_floats(n_obj, v, f, fv, e, d) * sizeof(float) +
        ((L.fpw + (size_t)kPoseF * n) * sizeof(float) +
         (L.ipw + (size_t)n) * sizeof(int)) * kWorldsPerBlock;
    if (bytes > kMaxShared) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    FusedArgs fa;
    Args& a = fa.a;
    a.state = (const float*)state; a.param = (const float*)param;
    a.ref = nullptr; a.alt = nullptr; a.con = nullptr; a.pts = nullptr;
    a.num = nullptr; a.je1 = (const int*)je1;
    a.je2 = (const int*)je2; a.jnt = (const float*)jnt;
    a.out = (float*)out;
    a.n = n; a.c = c; a.j = j; a.w = w; a.substeps = substeps;
    a.iters = iters; a.d0 = 0; a.d1 = n; a.ref_live = c;
    a.h = h; a.hgx = hgx; a.hgy = hgy; a.hgz = hgz; a.half_h = half_h;
    a.two_over_h = two_over_h; a.restitution = restitution;
    a.rest_thr = rest_thr;
    fa.nw = Narrow{(const int*)hh, (const int*)hp, (const int*)sp,
                   (const int*)sp_kind, ph, pp, ps, pairs, type_plane,
                   type_hull};
    fa.scale = (const float*)scale; fa.obj = (const int*)obj;
    fa.pack = (const float*)pack; fa.dirs = (const float*)dirs;
    fa.radius = (const float*)radius;
    fa.lane_ref = (int*)lane_ref; fa.lane_alt = (int*)lane_alt;
    fa.lane_con = (float*)lane_con; fa.lane_pts = (float*)lane_pts;
    fa.lane_num = (int*)lane_num;
    fa.n_obj = n_obj; fa.v = v; fa.f = f; fa.fv = fv; fa.e = e; fa.d = d;
    const int blocks = (w + kWorldsPerBlock - 1) / kWorldsPerBlock;
    fused_kernel<<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(fa);
    return (int)cudaGetLastError();
}
