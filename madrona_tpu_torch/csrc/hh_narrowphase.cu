// The hull-hull lane of the narrowphase as a 22-float record per
// (candidate, world): one launch, the live lanes compacted per tile of
// worlds, a warp per live lane where a tile has few.
//
// Replaces the two Pallas TPU kernels of madrona_tpu/ops/
// narrowphase_pallas.py that compute this record: _hh_kernel_sublane
// (make_hh_narrowphase_sublane, PhysicsConfig.narrowphase=
// "pallas_sublane") and _hh_kernel (make_hh_narrowphase, "pallas"). Their
// outputs are the same function of the same inputs (the TPU layouts differ
// only in how pairs sit on sublanes), so one kernel serves both names: the
// port's "kernel_sublane" follows PhysicsConfig.sat_tier, "kernel" always
// sweeps edge pairs, as the lane-major TPU kernel does. Its plain PyTorch
// version is madrona_tpu_torch/ops/hh_narrowphase_cuda.py::
// hh_record_plain; ref, alt and num are equal between the two, the floats
// agree to rounding.
//
// What it computes: the hull-hull lane of csrc/sat.cuh (face queries both
// ways, the edge query of the tier, the clipped face manifold reduced to
// 4 points or the edge contact) and the record
//   0 ref | 1 alt | 2 num | 3:6 normal | 6:10 x | 10:14 y | 14:18 z
//   | 18:22 depth  (of the 4 points)
// with ref = alt = N (the sentinel), num = 0 and zero floats where there
// is no contact.
//
// What bounds it on the H100: the operations where candidates are live
// (about 3,800 per candidate up to its separation test in the edge_dirs
// tier, about 20,000 in the edge_pairs tier with its 144 box edge pairs,
// then 2,000-3,300 for a manifold); the bytes (22 floats written per lane)
// where most lanes carry the sentinel. Both bounds are microseconds at the
// main paths' shapes; what the kernel loses is latency: on Escape Room
// data few candidates are live, and one thread's serial SAT on one of
// them was the whole kernel's time.
//
// What the design does about it, as the contacts kernel (csrc/
// contacts.cu) does without its hull-plane lanes. A block of 8 warps
// takes a tile of worlds, as wide as makes the grid a single wave of the
// blocks the card holds at once (csrc/lanes.cuh::one_wave_tile):
//   1. It stages the hull tables of all objects (a few KB) in shared
//      memory once for all its lanes.
//   2. Its threads walk the tile's (slot, world) lanes, slot-major and
//      worlds minor. A lane is live where both candidate rows name
//      bodies; a dead lane gets its sentinel record at once (consecutive
//      threads on consecutive worlds, so these stores coalesce). The live
//      lanes go into a dense list in order (lanes.cuh::compact_lanes: a
//      block-wide prefix of warp ballots, no atomics).
//   3. Where the tile has few live lanes (at most 16: Escape Room data), a
//      warp a lane (csrc/sat_warp.cuh::warp_hull_hull): the SAT's
//      faces, vertices, direction or edge pairs and clip candidates
//      spread over the warp's lanes, so a lane's chain of dependent
//      operations becomes a few hundred a warp lane. Where it has many (a
//      crowded scene), a thread a lane down the dense list (sat.cuh's
//      hull_hull), every warp full of live lanes.
// __launch_bounds__(256, 1) gives the SAT the registers it needs without
// spilling (a block an SM); scripts/torch_contacts_tiles.py --kernel
// hh_record times the alternatives. The records depend on neither the
// tile nor the path. No pair padding: the TPU kernel pads pairs to its
// sublane tile only. Compiled with --fmad=false, every sum in the plain
// version's order; the warp's SAT gives sat.cuh's bits.

#include "lanes.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// the narrowest tile, and hh_record_launch's most live lanes a tile gives
// a warp each (more go a thread each)
constexpr int kTileWorlds = 16;
constexpr int kWarpLanesMax = 2 * kWarps;
constexpr int kRecF = 22;

// Floats of the staged hull tables of n_obj objects.
__host__ __device__ inline size_t table_floats(int n_obj, int v, int f,
                                               int fv, int e, int d) {
    return (size_t)n_obj * (pack_width(v, f, fv, e) + 4 * d + e);
}

// What a lane of the block needs: the staged tables, the inputs, the
// records, the shapes, the tile.
struct Ctx {
    Tables t;
    Cands<1> cd;
    const float* poses;
    const int* obj;
    float* rec;
    int n, num_worlds, tile, w0;
    bool pairs;
};

__device__ inline Body ctx_body(const Ctx& c, int row, int w) {
    const size_t stride = c.num_worlds;
    return load_body(c.t, c.poses + (size_t)row * 10 * stride + w, stride,
                     c.obj[(size_t)row * stride + w]);
}

// Lane l's record: its manifold, the reference body first, or the
// sentinel where there is no contact.
__device__ void write_record(const Ctx& c, const Lane& l, const Manifold& m) {
    const size_t stride = c.num_worlds;
    float* out = c.rec + (size_t)l.slot * kRecF * stride + l.world;
    if (m.num <= 0) {
        out[0] = (float)c.n;
        out[stride] = (float)c.n;
        for (int k = 2; k < kRecF; ++k) out[k * stride] = 0.0f;
        return;
    }
    out[0] = (float)(m.ref_is_a ? l.row_a : l.row_b);
    out[stride] = (float)(m.ref_is_a ? l.row_b : l.row_a);
    out[2 * stride] = (float)m.num;
    out[3 * stride] = m.nrm.x;
    out[4 * stride] = m.nrm.y;
    out[5 * stride] = m.nrm.z;
    for (int k = 0; k < 4; ++k) {
        out[(6 + k) * stride] = m.pts[k].x;
        out[(10 + k) * stride] = m.pts[k].y;
        out[(14 + k) * stride] = m.pts[k].z;
        out[(18 + k) * stride] = m.dep[k];
    }
}

// A live lane (tile entry e) by one thread.
__device__ inline void record_thread(const Ctx& c, int e) {
    const Lane l = tile_lane(c.cd, e, c.tile, c.w0, c.n);
    Manifold m;
    hull_hull(c.t, ctx_body(c, l.row_a, l.world),
              ctx_body(c, l.row_b, l.world), c.pairs, m);
    write_record(c, l, m);
}

// A live lane by the whole warp; lane 0 writes it.
__device__ inline void record_by_warp(const Ctx& c, int e, WarpScratch& s,
                                      int lane) {
    const Lane l = tile_lane(c.cd, e, c.tile, c.w0, c.n);
    Manifold m;
    warp_hull_hull(c.t, ctx_body(c, l.row_a, l.world),
                   ctx_body(c, l.row_b, l.world), c.pairs, s, lane, m);
    if (lane == 0) write_record(c, l, m);
}

__global__ void __launch_bounds__(kThreads, 1) hh_record_kernel(
    const int* __restrict__ hh, const float* __restrict__ poses,
    const int* __restrict__ obj, const float* __restrict__ pack,
    const float* __restrict__ dirs, float* __restrict__ rec, int n, int p,
    int num_worlds, int n_obj, int v, int f, int fv, int e, int d,
    int pairs, int tile_worlds, int warp_lanes_max) {
    extern __shared__ float smem[];
    const Tables t = stage_tables(smem, pack, dirs, n_obj, v, f, fv, e, d);
    WarpScratch* scratch = reinterpret_cast<WarpScratch*>(
        smem + table_floats(n_obj, v, f, fv, e, d));
    int* warp_sums = reinterpret_cast<int*>(scratch + kWarps);
    int* list = warp_sums + kWarps;

    const int w0 = blockIdx.x * tile_worlds;
    const int tile = min(tile_worlds, num_worlds - w0);
    const Ctx c{t, Cands<1>{{hh}, {p}}, poses, obj, rec, n, num_worlds,
                tile, w0, pairs != 0};
    Manifold none;
    none.num = 0;
    const int n_live = compact_lanes<kThreads>(
        c.cd, 0, p * tile, tile, w0, n, list, warp_sums,
        [&](const Lane& l) { write_record(c, l, none); });

    // a warp each where the tile has few live lanes (then a lane's chain
    // of dependent operations is the block's time), else a thread each
    if (n_live <= warp_lanes_max) {
        const int warp = threadIdx.x / 32;
        for (int k = warp; k < n_live; k += kWarps)
            record_by_warp(c, list[k], scratch[warp], threadIdx.x % 32);
    } else {
        for (int k = threadIdx.x; k < n_live; k += kThreads)
            record_thread(c, list[k]);
    }
}

// Shared memory of a block: the tables and the lane machinery.
inline size_t shared_bytes(size_t tables, int tile, int p) {
    return tables + lane_bytes<kThreads>(tile, p);
}

// hh_record_launch's tile: one wave.
int default_tile(int num_worlds, size_t tables, int p) {
    return one_wave_tile(hh_record_kernel, kThreads, num_worlds, kTileWorlds,
                         1 << 30, [&](int t) {
                             return shared_bytes(tables, t, p);
                         });
}

}  // namespace

// hh [W, P, 2] int32 candidate rows, poses [N, 10, W], obj [N, W] int32
// -> rec [P, 22, W]. pairs != 0: the edge_pairs SAT tier; else edge_dirs.
// tile_worlds: worlds a block, 0 for one_wave_tile; warp_lanes_max: a
// tile's live lanes go a warp each up to this many, else a thread each.
// The records depend on neither.
extern "C" int hh_record_launch_tiled(
    const void* hh, const void* poses, const void* obj, const void* pack,
    const void* dirs, void* rec, int n, int num_worlds, int p, int n_obj,
    int v, int f, int fv, int e, int d, int pairs, int tile_worlds,
    int warp_lanes_max, void* stream) {
    if (!dims_fit(v, f, fv, e, d) || n < 1 || num_worlds < 1 || p < 1 ||
        tile_worlds < 0)
        return (int)cudaErrorInvalidValue;
    const size_t tables = table_floats(n_obj, v, f, fv, e, d) * sizeof(float);
    if (tables > 48 * 1024) return (int)cudaErrorInvalidValue;
    const int tile =
        tile_worlds ? tile_worlds : default_tile(num_worlds, tables, p);
    const size_t bytes = shared_bytes(tables, tile, p);
    cudaError_t err = cudaFuncSetAttribute(
        hh_record_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (num_worlds + tile - 1) / tile;
    hh_record_kernel<<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(
        (const int*)hh, (const float*)poses, (const int*)obj,
        (const float*)pack, (const float*)dirs, (float*)rec, n, p,
        num_worlds, n_obj, v, f, fv, e, d, pairs, tile, warp_lanes_max);
    return (int)cudaGetLastError();
}

extern "C" int hh_record_launch(
    const void* hh, const void* poses, const void* obj, const void* pack,
    const void* dirs, void* rec, int n, int num_worlds, int p, int n_obj,
    int v, int f, int fv, int e, int d, int pairs, void* stream) {
    return hh_record_launch_tiled(hh, poses, obj, pack, dirs, rec, n,
                                  num_worlds, p, n_obj, v, f, fv, e, d,
                                  pairs, 0, kWarpLanesMax, stream);
}

// The tile and warp-lane limit hh_record_launch takes at these shapes (a
// tile's live lanes go a warp each up to the limit): where a run's tiles
// went is then a count over the candidates (chip_smoke.py).
extern "C" int hh_record_tiling(int num_worlds, int p, int n_obj, int v,
                                int f, int fv, int e, int d, int* tile,
                                int* warp_lanes_max) {
    if (!dims_fit(v, f, fv, e, d) || num_worlds < 1 || p < 1)
        return (int)cudaErrorInvalidValue;
    *tile = default_tile(
        num_worlds, table_floats(n_obj, v, f, fv, e, d) * sizeof(float), p);
    *warp_lanes_max = kWarpLanesMax;
    return (int)cudaSuccess;
}
