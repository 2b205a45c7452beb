// The whole physics step in one launch: integrate at the predicted pose,
// every narrowphase lane (hull-hull, hull-plane, sphere) into shared
// memory, then every XPBD substep on those contacts; a tile of worlds a
// block, its live lanes compacted, 16 lanes a world in the substeps.
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
// practice it is latency: the loads, the SAT's long dependent chains, the
// substeps' chains through shared memory.
//
// What the design does about it. The contacts never leave shared memory,
// and the state of a world goes to global memory once, at the end. A block
// takes a tile of worlds (16 for a block of 256 threads: one pass of the
// substeps). Then, each phase over the whole block:
//   1. The loads: the hull tables and the objects' sphere radii (a few
//      KB, once for the tile), the worlds' state, parameters, scales,
//      object ids and joints, as asynchronous copies (cp.async) to shared
//      memory, every copy of a thread in flight at once, consecutive
//      threads on consecutive worlds of the worlds-minor buffers.
//   2. The integrate to the predicted pose: a thread a (body, world).
//   3. The narrowphase: the tile's (slot, world) lanes, slot-major and
//      worlds minor, compacted by csrc/lanes.cuh (a block-wide prefix of
//      warp ballots, no atomics) into the list [hull-hull | hull-plane and
//      sphere]; a dead lane gets its empty tables at once. Hull-hull lanes
//      go a warp each where the tile has few (csrc/sat_warp.cuh: a lane's
//      chain of dependent operations spread over the warp), a thread each
//      where it has many; hull-plane and sphere lanes a thread each, the
//      highest threads first. A lane writes its world's tables in shared
//      memory.
//   4. The substeps: 16 lanes a world, two worlds a warp, as the
//      substep-solver kernel (csrc/solver.cu) runs them: at these shapes
//      every per-body and per-constraint phase is one pass of the 16.
// The predicted poses share their shared memory with the substeps'
// delta and lam tables, which are written only after the narrowphase.
// Threads a block and blocks an SM (the register budget: the SAT wants
// about 180, the substeps' occupancy fewer) and the tile are launch
// parameters of fused_launch_tiled; scripts/torch_contacts_tiles.py
// --kernel fused sweeps them. The outputs depend on none of them. No
// atomics: a step is reproducible bit for bit. Compiled with --fmad=false,
// every sum in the plain versions' order.

#include "lanes.cuh"
#include "solver.cuh"

namespace {

constexpr int kPoseF = 10;       // predicted pos xyz | rot wxyz | scale xyz
// fused_launch's launch bounds (from the sweep); a kernel's widest
// default tile is one pass of its substeps, threads / kWorldLanes worlds
constexpr int kThreadsDefault = 256;
constexpr int kMinBlocksDefault = 1;

struct FusedArgs {
    Args a;
    const int* hh; const int* hp; const int* sp; const int* sp_kind;
    int ph, pp, ps, pairs, type_plane, type_hull;
    const float* scale; const int* obj;
    const float* pack; const float* dirs; const float* radius;
    // where not null: the contact tables as the narrowphase left them,
    // in the substep-solver kernel's input layout (for checking only)
    int* lane_ref; int* lane_alt; float* lane_con; float* lane_pts;
    int* lane_num;
    int n_obj, v, f, fv, e, d;
    int tile, warp_lanes_max;
};

__host__ __device__ inline size_t table_floats(int n_obj, int v, int f,
                                               int fv, int e, int d) {
    return (size_t)n_obj * (pack_width(v, f, fv, e) + 4 * d + e + 1);
}

// A world's slice of shared memory: the solver's floats, where the
// predicted poses [10][n] share the delta and lam tables' room (and run
// past it where they are longer); the solver's ints, then the object ids
// [n].
struct Slices {
    Layout L;
    size_t fstride, istride, o_pose;
};

__host__ __device__ inline Slices world_slices(int n, int c, int j) {
    Slices s;
    s.L = world_layout(n, c, j);
    s.o_pose = s.L.o_delta;
    const size_t pose_end = s.o_pose + (size_t)kPoseF * n;
    s.fstride = pose_end > s.L.fpw ? pose_end : s.L.fpw;
    s.istride = s.L.ipw + (size_t)n;
    return s;
}

// Copy one 32-bit word from global to shared memory without waiting for
// it (cp.async): a thread issues all its copies back to back, then
// copies_done waits for them. (A plain copy where this compiles for the
// host.)
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
    const unsigned to =
        static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(to),
                 "l"(src));
#else
    *static_cast<unsigned*>(dst) = *static_cast<const unsigned*>(src);
#endif
}

__device__ __forceinline__ void copies_done() {
#if defined(__CUDA_ARCH__)
    asm volatile("cp.async.wait_all;\n" ::);
#endif
}

// Copy count words to shared memory.
template <int kThreads, typename T>
__device__ void copy_in(T* dst, const T* src, int count) {
    for (int i = threadIdx.x; i < count; i += kThreads)
        copy_async(dst + i, src + i);
}

// Copy one worlds-minor table [rows, W] of the tile's nw worlds to shared
// memory, consecutive threads on consecutive worlds: row r of world lw
// to shared[lw * world_stride + r].
template <int kThreads, typename T>
__device__ void load_tile(T* shared, size_t world_stride, const T* global,
                          int rows, int w0, int nw, int num_worlds) {
    for (int i = threadIdx.x; i < rows * nw; i += kThreads)
        copy_async(shared + (i % nw) * world_stride + i / nw,
                   global + (size_t)(i / nw) * num_worlds + w0 + i % nw);
}

// What the block's phases need: the staged tables, the candidates, the
// worlds' slices of shared memory, the tile.
struct Ctx {
    Tables t;
    Cands<3> cd;          // [hull-hull | hull-plane | sphere]
    const int* sp_kind;
    const float* radius;
    float* fbase;
    int* ibase;
    Slices sl;
    int n, c, j, ps, tile, w0, type_plane, type_hull;
    bool pairs;

    __device__ World world(int lw) const {
        return world_at(sl.L, fbase + lw * sl.fstride, ibase + lw * sl.istride,
                        n, c, j);
    }
    __device__ float* pose(int lw) const {
        return fbase + lw * sl.fstride + sl.o_pose;
    }
    __device__ const int* obj(int lw) const {
        return ibase + lw * sl.istride + sl.L.ipw;
    }
    // the world's contact tables, lane k at [field * c + k]
    __device__ Out out(int lw) const {
        const World s = world(lw);
        return Out{s.ref, s.alt, s.con, s.pts, s.num, (size_t)c};
    }
    __device__ Body body(int lw, int row) const {
        return load_body(t, pose(lw) + row, n, obj(lw)[row]);
    }
};

// A lane's outputs: its manifold with (ref, alt), or empty.
__device__ inline void write_manifold(const Ctx& x, const Lane& l, int ref,
                                      int alt, const Manifold& m) {
    const Out o = x.out(l.world - x.w0);
    if (m.num <= 0)
        write_empty(o, l.slot, x.n);
    else
        write_lane(o, l.slot, ref, alt, m);
}

// A hull-hull lane (tile entry e) by one thread.
__device__ inline void hull_hull_thread(const Ctx& x, int e) {
    const Lane l = tile_lane(x.cd, e, x.tile, x.w0, x.n);
    const int lw = l.world - x.w0;
    Manifold m;
    hull_hull(x.t, x.body(lw, l.row_a), x.body(lw, l.row_b), x.pairs, m);
    write_manifold(x, l, m.ref_is_a ? l.row_a : l.row_b,
                   m.ref_is_a ? l.row_b : l.row_a, m);
}

// A hull-hull lane by the whole warp; lane 0 writes it.
__device__ inline void hull_hull_by_warp(const Ctx& x, int e,
                                         WarpScratch& s, int lane) {
    const Lane l = tile_lane(x.cd, e, x.tile, x.w0, x.n);
    const int lw = l.world - x.w0;
    Manifold m;
    warp_hull_hull(x.t, x.body(lw, l.row_a), x.body(lw, l.row_b), x.pairs,
                   s, lane, m);
    if (lane == 0)
        write_manifold(x, l, m.ref_is_a ? l.row_a : l.row_b,
                       m.ref_is_a ? l.row_b : l.row_a, m);
}

// A hull-plane or sphere lane by one thread; the second body is the
// reference.
__device__ inline void other_lane_thread(const Ctx& x, int e) {
    const Lane l = tile_lane(x.cd, e, x.tile, x.w0, x.n);
    const int lw = l.world - x.w0;
    const Body b0 = x.body(lw, l.row_a), b1 = x.body(lw, l.row_b);
    Manifold m;
    if (l.kind == 1) {
        hull_plane(x.t, b0, b1, m);
    } else {
        const int kind = x.sp_kind[(size_t)l.world * x.ps + l.slot -
                                   x.cd.cap[0] - x.cd.cap[1]];
        const float r = x.radius[x.obj(lw)[l.row_a]] * b0.s.x;
        if (kind == x.type_plane)
            sphere_plane(b0.p, r, b1, m);
        else if (kind == x.type_hull)
            sphere_hull(x.t, b0.p, r, b1, m);
        else
            sphere_sphere(b0.p, r, b1.p,
                          x.radius[x.obj(lw)[l.row_b]] * b1.s.x, m);
    }
    write_manifold(x, l, l.row_b, l.row_a, m);
}

// The world's contact tables [rows][c] in shared memory -> [rows, c, W],
// consecutive threads on consecutive worlds.
template <int kThreads, typename T, typename Table>
__device__ void store_lanes(T* dst, Table table, int rows, int c, int w0,
                            int nw, int num_worlds) {
    for (int i = threadIdx.x; i < rows * c * nw; i += kThreads)
        dst[(size_t)(i / nw) * num_worlds + w0 + i % nw] =
            table(i % nw)[i / nw];
}

template <int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    fused_kernel(FusedArgs fa) {
    constexpr int kWarps = kThreads / 32;
    extern __shared__ float smem[];
    const Args& a = fa.a;
    const int n = a.n, c = a.c, j = a.j;
    // the hull tables (csrc/sat.cuh::stage_tables' layout) and the radii
    float* dirs = smem + (size_t)fa.n_obj * (pack_width(fa.v, fa.f, fa.fv,
                                                         fa.e));
    const Tables t = make_tables(smem, dirs, fa.v, fa.f, fa.fv, fa.e, fa.d);
    float* radius = dirs + (size_t)fa.n_obj * t.kd;
    copy_in<kThreads>(smem, fa.pack, fa.n_obj * t.k);
    copy_in<kThreads>(dirs, fa.dirs, fa.n_obj * t.kd);
    copy_in<kThreads>(radius, fa.radius, fa.n_obj);

    const int w0 = blockIdx.x * fa.tile;
    const int nw = min(fa.tile, a.w - w0);
    const Slices sl = world_slices(n, c, j);
    float* fbase = smem + table_floats(fa.n_obj, fa.v, fa.f, fa.fv, fa.e,
                                       fa.d);
    int* ibase = reinterpret_cast<int*>(fbase + sl.fstride * fa.tile);
    WarpScratch* scratch =
        reinterpret_cast<WarpScratch*>(ibase + sl.istride * fa.tile);
    int* warp_sums = reinterpret_cast<int*>(scratch + kWarps);
    int* list = warp_sums + kWarps;
    const Ctx x{t, Cands<3>{{fa.hh, fa.hp, fa.sp}, {fa.ph, fa.pp, fa.ps}},
                fa.sp_kind, radius, fbase, ibase, sl, n, c, j, fa.ps, nw, w0,
                fa.type_plane, fa.type_hull, fa.pairs != 0};
    const Layout& L = sl.L;

    // 1. the loads, every copy of a thread in flight at once
    load_tile<kThreads>(fbase + L.o_st, sl.fstride, a.state, kStateF * n, w0,
                        nw, a.w);
    load_tile<kThreads>(fbase + L.o_pr, sl.fstride, a.param, kParamF * n, w0,
                        nw, a.w);
    load_tile<kThreads>(fbase + sl.o_pose + 7 * (size_t)n, sl.fstride,
                        fa.scale, 3 * n, w0, nw, a.w);
    load_tile<kThreads>(ibase + L.ipw, sl.istride, fa.obj, n, w0, nw, a.w);
    if (j > 0) {
        load_tile<kThreads>(fbase + L.o_jnt, sl.fstride, a.jnt, kJntF * j,
                            w0, nw, a.w);
        load_tile<kThreads>(ibase + L.o_je1, sl.istride, a.je1, j, w0, nw,
                            a.w);
        load_tile<kThreads>(ibase + L.o_je2, sl.istride, a.je2, j, w0, nw,
                            a.w);
    }
    copies_done();
    __syncthreads();

    // 2. the predicted poses, a thread a (body, world)
    for (int i = threadIdx.x; i < n * nw; i += kThreads) {
        const int lw = i / n, b = i % n;
        const Integrated r = integrate_values(x.world(lw), a, b);
        float* pose = x.pose(lw);
        pose[0 * n + b] = r.x.x;
        pose[1 * n + b] = r.x.y;
        pose[2 * n + b] = r.x.z;
        pose[3 * n + b] = r.q.w;
        pose[4 * n + b] = r.q.x;
        pose[5 * n + b] = r.q.y;
        pose[6 * n + b] = r.q.z;
    }
    __syncthreads();

    // 3. the narrowphase: hull-hull lanes, then the hull-plane and sphere
    // lanes, each list compacted; the dead lanes' tables at once
    auto dead = [&](const Lane& l) {
        write_empty(x.out(l.world - w0), l.slot, n);
    };
    const int n_hh = compact_lanes<kThreads>(x.cd, 0, fa.ph * nw, nw, w0, n,
                                             list, warp_sums, dead);
    const int n_other = compact_lanes<kThreads>(
        x.cd, fa.ph * nw, c * nw, nw, w0, n, list + n_hh, warp_sums, dead);
    if (n_hh <= fa.warp_lanes_max) {
        const int warp = threadIdx.x / 32;
        for (int k = warp; k < n_hh; k += kWarps)
            hull_hull_by_warp(x, list[k], scratch[warp], threadIdx.x % 32);
    } else {
        for (int k = threadIdx.x; k < n_hh; k += kThreads)
            hull_hull_thread(x, list[k]);
    }
    for (int k = kThreads - 1 - threadIdx.x; k < n_other; k += kThreads)
        other_lane_thread(x, list[n_hh + k]);
    __syncthreads();

    if (fa.lane_num != nullptr) {
        auto world_of = [&](int lw) { return x.world(lw); };
        store_lanes<kThreads>(fa.lane_ref, [&](int lw) {
            return world_of(lw).ref; }, 1, c, w0, nw, a.w);
        store_lanes<kThreads>(fa.lane_alt, [&](int lw) {
            return world_of(lw).alt; }, 1, c, w0, nw, a.w);
        store_lanes<kThreads>(fa.lane_num, [&](int lw) {
            return world_of(lw).num; }, 1, c, w0, nw, a.w);
        store_lanes<kThreads>(fa.lane_con, [&](int lw) {
            return world_of(lw).con; }, kConF, c, w0, nw, a.w);
        store_lanes<kThreads>(fa.lane_pts, [&](int lw) {
            return world_of(lw).pts; }, kPtsF, c, w0, nw, a.w);
    }

    // 4. the substeps, 16 lanes a world
    for (int lw = threadIdx.x / kWorldLanes; lw < nw;
         lw += kThreads / kWorldLanes) {
        World s = x.world(lw);
        run_substeps(s, a, threadIdx.x % kWorldLanes);
    }
    __syncthreads();

    for (int i = threadIdx.x; i < kOutF * n * nw; i += kThreads) {
        const int ow = i % nw, row = i / nw;
        a.out[(size_t)row * a.w + w0 + ow] = fbase[ow * sl.fstride + row];
    }
}

// Shared memory of a block of kThreads over `tile` worlds.
template <int kThreads>
size_t shared_bytes(const FusedArgs& fa, int tile) {
    const Slices sl = world_slices(fa.a.n, fa.a.c, fa.a.j);
    return table_floats(fa.n_obj, fa.v, fa.f, fa.fv, fa.e, fa.d) *
               sizeof(float) +
           (sl.fstride * sizeof(float) + sl.istride * sizeof(int)) * tile +
           lane_bytes<kThreads>(tile, fa.a.c);
}

// The tile of the kernel of kThreads and kMinBlocks: tile_worlds, or
// where 0 one_wave_tile within max_tile and the shared memory a block
// may have; 0 where not even one world fits.
template <int kThreads, int kMinBlocks>
int pick_tile(const FusedArgs& fa, int tile_worlds, int max_tile) {
    auto bytes = [&](int t) { return shared_bytes<kThreads>(fa, t); };
    if (tile_worlds != 0)
        return bytes(tile_worlds) <= kMaxShared ? tile_worlds : 0;
    while (max_tile > 0 && bytes(max_tile) > kMaxShared) --max_tile;
    if (max_tile == 0) return 0;
    return one_wave_tile(fused_kernel<kThreads, kMinBlocks>, kThreads,
                         fa.a.w, kThreads / kWorldLanes, max_tile, bytes);
}

// Launch the kernel of kThreads and kMinBlocks over tiles of tile_worlds
// (0: pick_tile's).
template <int kThreads, int kMinBlocks>
int launch(FusedArgs fa, int tile_worlds, int max_tile, void* stream) {
    auto kernel = fused_kernel<kThreads, kMinBlocks>;
    fa.tile = pick_tile<kThreads, kMinBlocks>(fa, tile_worlds, max_tile);
    if (fa.tile == 0) return (int)cudaErrorInvalidValue;
    const size_t b = shared_bytes<kThreads>(fa, fa.tile);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)b);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (fa.a.w + fa.tile - 1) / fa.tile;
    kernel<<<blocks, kThreads, b, (cudaStream_t)stream>>>(fa);
    return (int)cudaGetLastError();
}

}  // namespace

// state [13, N, W], param [20, N, W], scale [3, N, W], obj [N, W] int32,
// hh [W, PH, 2], hp [W, PP, 2], sp [W, PS, 2], sp_kind [W, PS] int32,
// the hull tables, radius [n_obj], je1/je2 [J, W] int32, jnt [23, J, W]
// -> out [33, N, W]. pairs != 0: the edge_pairs SAT tier; else edge_dirs.
// lane_ref/alt/num [C, W] int32, lane_con [8, C, W], lane_pts [16, C, W]:
// all null, or where the narrowphase's contact tables are written.
// tile_worlds: worlds a block, 0 for one_wave_tile within one substep
// pass of the block; warp_lanes_max: a tile's hull-hull lanes go a warp
// each up to this many, else a thread each (-1: twice the block's
// warps); threads and min_blocks: the kernel's __launch_bounds__, one of
// (256, 1), (256, 2), (128, 2), (128, 3), or 0 and 0 for fused_launch's.
// The outputs depend on none of these.
extern "C" int fused_launch_tiled(
    const void* state, const void* param, const void* scale, const void* obj,
    const void* hh, const void* hp, const void* sp, const void* sp_kind,
    const void* pack, const void* dirs, const void* radius, const void* je1,
    const void* je2, const void* jnt, void* out, void* lane_ref,
    void* lane_alt, void* lane_con, void* lane_pts, void* lane_num,
    int n, int ph, int pp, int ps, int j, int w, int substeps, int iters,
    int n_obj, int v, int f, int fv, int e, int d, int pairs, int type_plane,
    int type_hull,
    float h, float hgx, float hgy, float hgz, float half_h, float two_over_h,
    float restitution, float rest_thr, int tile_worlds, int warp_lanes_max,
    int threads, int min_blocks, void* stream) {
    const int c = ph + pp + ps;
    if (!dims_fit(v, f, fv, e, d) || n < 1 || w < 1 || ph < 0 || pp < 0 ||
        ps < 0 || j < 0 || n_obj < 1 || tile_worlds < 0)
        return (int)cudaErrorInvalidValue;
    if (threads == 0) {
        threads = kThreadsDefault;
        min_blocks = kMinBlocksDefault;
    }
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
    fa.hh = (const int*)hh; fa.hp = (const int*)hp; fa.sp = (const int*)sp;
    fa.sp_kind = (const int*)sp_kind;
    fa.ph = ph; fa.pp = pp; fa.ps = ps; fa.pairs = pairs;
    fa.type_plane = type_plane; fa.type_hull = type_hull;
    fa.scale = (const float*)scale; fa.obj = (const int*)obj;
    fa.pack = (const float*)pack; fa.dirs = (const float*)dirs;
    fa.radius = (const float*)radius;
    fa.lane_ref = (int*)lane_ref; fa.lane_alt = (int*)lane_alt;
    fa.lane_con = (float*)lane_con; fa.lane_pts = (float*)lane_pts;
    fa.lane_num = (int*)lane_num;
    fa.n_obj = n_obj; fa.v = v; fa.f = f; fa.fv = fv; fa.e = e; fa.d = d;
    fa.warp_lanes_max =
        warp_lanes_max >= 0 ? warp_lanes_max : 2 * (threads / 32);
    const int max_tile = threads / kWorldLanes;
    if (threads == 256 && min_blocks == 1)
        return launch<256, 1>(fa, tile_worlds, max_tile, stream);
    if (threads == 256 && min_blocks == 2)
        return launch<256, 2>(fa, tile_worlds, max_tile, stream);
    if (threads == 128 && min_blocks == 2)
        return launch<128, 2>(fa, tile_worlds, max_tile, stream);
    if (threads == 128 && min_blocks == 3)
        return launch<128, 3>(fa, tile_worlds, max_tile, stream);
    return (int)cudaErrorInvalidValue;
}

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
    return fused_launch_tiled(
        state, param, scale, obj, hh, hp, sp, sp_kind, pack, dirs, radius,
        je1, je2, jnt, out, lane_ref, lane_alt, lane_con, lane_pts, lane_num,
        n, ph, pp, ps, j, w, substeps, iters, n_obj, v, f, fv, e, d, pairs,
        type_plane, type_hull, h, hgx, hgy, hgz, half_h, two_over_h,
        restitution, rest_thr, 0, -1, 0, 0, stream);
}

// The tile, warp-lane limit and launch bounds fused_launch takes at these
// shapes (a tile's hull-hull lanes go a warp each up to the limit): where
// a run's tiles went is then a count over the candidates (chip_smoke.py).
extern "C" int fused_tiling(int n, int c, int j, int w, int n_obj, int v,
                            int f, int fv, int e, int d, int* tile,
                            int* warp_lanes_max, int* threads,
                            int* min_blocks) {
    if (!dims_fit(v, f, fv, e, d) || n < 1 || w < 1 || c < 0 || j < 0 ||
        n_obj < 1)
        return (int)cudaErrorInvalidValue;
    FusedArgs fa;
    fa.a.n = n; fa.a.c = c; fa.a.j = j; fa.a.w = w;
    fa.n_obj = n_obj; fa.v = v; fa.f = f; fa.fv = fv; fa.e = e; fa.d = d;
    static_assert(kThreadsDefault == 256 && kMinBlocksDefault == 1,
                  "fused_tiling asks the default kernel");
    *tile = pick_tile<256, 1>(fa, 0, kThreadsDefault / kWorldLanes);
    *warp_lanes_max = 2 * (kThreadsDefault / 32);
    *threads = kThreadsDefault;
    *min_blocks = kMinBlocksDefault;
    return *tile > 0 ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
}
