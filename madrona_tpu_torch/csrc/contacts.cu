// Narrowphase contacts of the candidate pairs: one launch, the live lanes
// compacted per tile of worlds, a warp per hull-hull lane.
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
// B's vertices); the edge query of the SAT tier (unique edge-direction
// pairs with a support separation, or every edge pair with the Gauss-map
// test; csrc/sat.cuh); separated pairs drop out; a face contact clips the
// incident face of the other hull against the side planes of the
// reference face, keeps the points below the reference plane, projects
// them onto it and reduces them to at most 4; an edge contact is the
// closest point on A's witness edge. Hull-plane lanes: the plane is the
// reference; the hull's face most against the plane normal, its vertices
// below the plane projected onto it, the same reduction. Every lane then gets its
// depth-weighted average point, largest penetration and ok flag.
//
// What bounds it on the H100: it depends on the data. A world moves about
// 2.8 KB (candidate rows, 21 poses, five output buffers); a live
// hull-hull lane costs 6,000-7,000 float operations and a live hull-plane
// lane about 1,500. On Escape Room data (hull-hull candidates are rare)
// the byte time is the larger one; on a crowded scene the operations are.
// Both bounds are microseconds at the main paths' shapes; what the kernel
// loses is latency: one thread's chain of a SAT where lanes are few, the
// threads' SATs at 8 warps an SM (180 registers each) where they are many.
//
// What the design does about it. One launch serves both lane kinds, so
// a call pays one launch's latency. A block of 8 warps takes a tile of
// worlds, as wide as makes the grid a single wave of the blocks the card
// holds at once (one_wave_tile: 32 worlds at Escape Room's 4096, 128 at
// Hide & Seek's 16,384, at one block an SM):
//   1. It stages the hull tables of all objects (a few KB) in shared
//      memory once for all its lanes.
//   2. Its threads walk the tile's (slot, world) lanes, slot-major and
//      worlds minor (consecutive threads on consecutive worlds, so the
//      empty lanes' stores coalesce). A lane is live where both candidate
//      rows name bodies; a dead lane gets its empty outputs at once. The
//      live hull-hull and hull-plane lanes go into two dense lists in
//      that order, by a block-wide prefix of warp ballots: deterministic,
//      no atomics. Nothing assumes that the live slots come first.
//   3. The hull-hull lanes. Where the tile has few (at most 16; on
//      Escape Room data they are rare), a warp a lane (csrc/
//      sat_warp.cuh): the SAT's faces, vertices, direction or edge pairs
//      and clip candidates spread over the lanes, the hulls in shared
//      memory, only maxima, minima and arg-bests crossing lanes, so a
//      lane's chain of 6,000-7,000 dependent operations, the whole
//      kernel's time where one world has a contact, becomes a few
//      hundred a warp lane. Where the tile has many (Hide & Seek, crowded
//      scenes), a thread a lane down the dense list (sat.cuh's
//      hull_hull), every warp full of live lanes: there a warp a lane
//      issues several times the instructions of 32 lanes sharing each.
//   4. The hull-plane lanes (about 1,500 operations each) go a thread a
//      lane, the highest threads first, beside the hull-hull ones.
// __launch_bounds__(256, 1) gives the SAT the registers it needs without
// spilling (a block an SM); scripts/torch_contacts_tiles.py times the
// alternatives (tile widths, a warp or a thread a hull-hull lane).
//
// Compiled with --fmad=false, and every sum written in the plain
// version's order: the separations feed comparisons that decide ref, alt
// and num, which must equal the plain version's. The per-thread device
// functions live in csrc/sat.cuh, shared with the hull-hull record and
// fused-step kernels; the warp's versions of the hull-hull ones in
// csrc/sat_warp.cuh give the same bits.

#include "sat_warp.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
// the narrowest tile, and contacts_launch's most hull-hull lanes a tile
// gives a warp each (more go a thread each)
constexpr int kTileWorlds = 16;
constexpr int kWarpLanesMax = 2 * kWarps;

// Floats of the staged hull tables of n_obj objects.
__host__ __device__ inline size_t table_floats(int n_obj, int v, int f,
                                               int fv, int e, int d) {
    return (size_t)n_obj * (pack_width(v, f, fv, e) + 4 * d + e);
}

// One lane of the tile: entry e is slot e / tile of world w0 + e % tile
// (slot < ph: hull-hull candidate, else hull-plane); its two rows, and
// whether both name bodies.
struct Lane {
    int slot, world, row_a, row_b;
    bool live;
};

__device__ inline Lane tile_lane(const int* hh, const int* hp, int e,
                                 int tile, int w0, int n, int ph, int pp) {
    Lane l;
    l.slot = e / tile;
    l.world = w0 + e % tile;
    const int* r = l.slot < ph ? hh + ((size_t)l.world * ph + l.slot) * 2
                               : hp + ((size_t)l.world * pp + l.slot - ph) * 2;
    l.row_a = r[0];
    l.row_b = r[1];
    l.live = l.row_a >= 0 && l.row_a < n && l.row_b >= 0 && l.row_b < n;
    return l;
}

// Append the live entries of [lo, hi) to list, in order, by a block-wide
// prefix of warp ballots; write the dead ones' empty outputs. Every thread
// of the block calls it; returns the count, the same in every thread.
__device__ int compact_lanes(const int* hh, const int* hp, const Out& o,
                             int lo, int hi, int tile, int w0, int n,
                             int ph, int pp, int num_worlds, int* list,
                             int* warp_sums) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    int total = 0;
    for (int base = lo; base < hi; base += kThreads) {
        const int e = base + threadIdx.x;
        bool keep = false;
        if (e < hi) {
            const Lane l = tile_lane(hh, hp, e, tile, w0, n, ph, pp);
            keep = l.live;
            if (!keep)
                write_empty(o, (size_t)l.slot * num_worlds + l.world, n);
        }
        const unsigned m = __ballot_sync(kFullWarp, keep);
        if (lane == 0) warp_sums[warp] = __popc(m);
        __syncthreads();
        int offset = total, chunk = 0;
        for (int k = 0; k < kWarps; ++k) {
            offset += k < warp ? warp_sums[k] : 0;
            chunk += warp_sums[k];
        }
        if (keep) list[offset + __popc(m & ((1u << lane) - 1u))] = e;
        total += chunk;
        __syncthreads();
    }
    return total;
}

__device__ inline Body lane_body(const Tables& t, const float* poses,
                                 const int* obj, int row, int w,
                                 int num_worlds) {
    const size_t stride = num_worlds;
    return load_body(t, poses + (size_t)row * 10 * stride + w, stride,
                     obj[(size_t)row * stride + w]);
}

// What a lane of the block needs: the staged tables, the inputs and
// outputs, the shapes, the tile.
struct Ctx {
    Tables t;
    const int* hh;
    const int* hp;
    const float* poses;
    const int* obj;
    Out o;
    int n, ph, pp, num_worlds, tile, w0;
    bool pairs;
};

__device__ inline Lane ctx_lane(const Ctx& c, int e) {
    return tile_lane(c.hh, c.hp, e, c.tile, c.w0, c.n, c.ph, c.pp);
}

__device__ inline Body ctx_body(const Ctx& c, int row, int w) {
    return lane_body(c.t, c.poses, c.obj, row, w, c.num_worlds);
}

// A hull-hull lane's outputs: its manifold, the reference body first.
__device__ inline void write_hull_hull(const Ctx& c, const Lane& l,
                                       const Manifold& m) {
    const size_t at = (size_t)l.slot * c.num_worlds + l.world;
    if (m.num <= 0)
        write_empty(c.o, at, c.n);
    else
        write_lane(c.o, at, m.ref_is_a ? l.row_a : l.row_b,
                   m.ref_is_a ? l.row_b : l.row_a, m);
}

// A hull-hull lane (tile entry e) by one thread.
__device__ inline void hull_hull_thread(const Ctx& c, int e) {
    const Lane l = ctx_lane(c, e);
    Manifold m;
    hull_hull(c.t, ctx_body(c, l.row_a, l.world),
              ctx_body(c, l.row_b, l.world), c.pairs, m);
    write_hull_hull(c, l, m);
}

// A hull-hull lane by the whole warp; lane 0 writes it.
__device__ inline void hull_hull_by_warp(const Ctx& c, int e,
                                         WarpScratch& s, int lane) {
    const Lane l = ctx_lane(c, e);
    Manifold m;
    warp_hull_hull(c.t, ctx_body(c, l.row_a, l.world),
                   ctx_body(c, l.row_b, l.world), c.pairs, s, lane, m);
    if (lane == 0) write_hull_hull(c, l, m);
}

// A hull-plane lane by one thread: the plane is the reference, the hull
// the other body.
__device__ inline void hull_plane_thread(const Ctx& c, int e) {
    const Lane l = ctx_lane(c, e);
    const size_t at = (size_t)l.slot * c.num_worlds + l.world;
    Manifold m;
    hull_plane(c.t, ctx_body(c, l.row_a, l.world),
               ctx_body(c, l.row_b, l.world), m);
    if (m.num <= 0)
        write_empty(c.o, at, c.n);
    else
        write_lane(c.o, at, l.row_b, l.row_a, m);
}

__global__ void __launch_bounds__(kThreads, 1) contacts_kernel(
    const int* __restrict__ hh, const int* __restrict__ hp,
    const float* __restrict__ poses, const int* __restrict__ obj,
    const float* __restrict__ pack, const float* __restrict__ dirs, Out o,
    int n, int ph, int pp, int num_worlds, int n_obj, int v, int f, int fv,
    int e, int d, int pairs, int tile_worlds, int warp_lanes_max) {
    extern __shared__ float smem[];
    const Tables t = stage_tables(smem, pack, dirs, n_obj, v, f, fv, e, d);
    WarpScratch* scratch = reinterpret_cast<WarpScratch*>(
        smem + table_floats(n_obj, v, f, fv, e, d));
    int* warp_sums = reinterpret_cast<int*>(scratch + kWarps);
    int* list = warp_sums + kWarps;

    const int w0 = blockIdx.x * tile_worlds;
    const int tile = min(tile_worlds, num_worlds - w0);
    const int n_hh = compact_lanes(hh, hp, o, 0, ph * tile, tile, w0, n, ph,
                                   pp, num_worlds, list, warp_sums);
    const int n_hp = compact_lanes(hh, hp, o, ph * tile, (ph + pp) * tile,
                                   tile, w0, n, ph, pp, num_worlds,
                                   list + n_hh, warp_sums);
    const Ctx c{t, hh, hp, poses, obj, o, n, ph, pp, num_worlds, tile, w0,
                pairs != 0};

    // hull-hull lanes: a warp each where the tile has few of them (then
    // a lane's chain of dependent operations is the block's time), a
    // thread each where it has many; the lowest threads take them
    if (n_hh <= warp_lanes_max) {
        const int warp = threadIdx.x / 32;
        for (int k = warp; k < n_hh; k += kWarps)
            hull_hull_by_warp(c, list[k], scratch[warp], threadIdx.x % 32);
    } else {
        for (int k = threadIdx.x; k < n_hh; k += kThreads)
            hull_hull_thread(c, list[k]);
    }
    // hull-plane lanes, a thread each, the highest threads first
    for (int k = kThreads - 1 - threadIdx.x; k < n_hp; k += kThreads)
        hull_plane_thread(c, list[n_hh + k]);
}

// Shared memory of a block: the tables, a scratch a warp, the warps'
// sums and the tile's lane list.
inline size_t shared_bytes(size_t tables, int tile, int lanes) {
    return tables + kWarps * sizeof(WarpScratch)
           + (kWarps + (size_t)tile * lanes) * sizeof(int);
}

// The tile of one wave: the worlds spread over as many blocks as the card
// holds at once at this kernel's registers and shared memory, rounded up
// to a multiple of kTileWorlds.
int one_wave_tile(int num_worlds, size_t tables, int lanes) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms < 1)
        return kTileWorlds;
    const int widest = (num_worlds + sms - 1) / sms;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, contacts_kernel, kThreads,
            shared_bytes(tables, widest, lanes)) != cudaSuccess ||
        per_sm < 1)
        per_sm = 1;
    const int tile = (num_worlds + sms * per_sm - 1) / (sms * per_sm);
    return (tile + kTileWorlds - 1) / kTileWorlds * kTileWorlds;
}

}  // namespace

// pairs != 0: the edge_pairs SAT tier; else edge_dirs. tile_worlds:
// worlds a block, 0 for one_wave_tile; warp_lanes_max: a tile's
// hull-hull lanes go a warp each up to this many, else a thread each.
// The outputs depend on neither.
extern "C" int contacts_launch_tiled(
    const void* hh, const void* hp, const void* poses, const void* obj,
    const void* pack, const void* dirs, void* ref, void* alt, void* con,
    void* pts, void* num,
    int n, int num_worlds, int ph, int pp, int n_obj, int v, int f, int fv,
    int e, int d, int pairs, int tile_worlds, int warp_lanes_max,
    void* stream) {
    if (!dims_fit(v, f, fv, e, d) || n < 1 || num_worlds < 1 || ph < 0 ||
        pp < 0 || tile_worlds < 0)
        return (int)cudaErrorInvalidValue;
    const size_t tables = table_floats(n_obj, v, f, fv, e, d) * sizeof(float);
    if (tables > 48 * 1024) return (int)cudaErrorInvalidValue;
    if (ph + pp == 0) return (int)cudaSuccess;
    Out o{(int*)ref, (int*)alt, (float*)con, (float*)pts, (int*)num,
          (size_t)(ph + pp) * num_worlds};
    const int tile = tile_worlds ? tile_worlds
                                 : one_wave_tile(num_worlds, tables, ph + pp);
    const size_t bytes = shared_bytes(tables, tile, ph + pp);
    cudaError_t err = cudaFuncSetAttribute(
        contacts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (num_worlds + tile - 1) / tile;
    contacts_kernel<<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(
        (const int*)hh, (const int*)hp, (const float*)poses, (const int*)obj,
        (const float*)pack, (const float*)dirs, o, n, ph, pp, num_worlds,
        n_obj, v, f, fv, e, d, pairs, tile, warp_lanes_max);
    return (int)cudaGetLastError();
}

extern "C" int contacts_launch(
    const void* hh, const void* hp, const void* poses, const void* obj,
    const void* pack, const void* dirs, void* ref, void* alt, void* con,
    void* pts, void* num,
    int n, int num_worlds, int ph, int pp, int n_obj, int v, int f, int fv,
    int e, int d, int pairs, void* stream) {
    return contacts_launch_tiled(hh, hp, poses, obj, pack, dirs, ref, alt,
                                 con, pts, num, n, num_worlds, ph, pp, n_obj,
                                 v, f, fv, e, d, pairs, 0, kWarpLanesMax,
                                 stream);
}
