// A tile's lane lists: the narrowphase kernels (csrc/contacts.cu,
// hh_narrowphase.cu, fused_step.cu) give a block a tile of worlds and
// compact the tile's live candidate lanes before they run them.
//
// A lane is a (slot, world) entry of the tile. Its candidate kinds lie
// one after another in slot order: the contacts kernel has two
// [hull-hull | hull-plane], the record kernel one [hull-hull], the fused
// step three [hull-hull | hull-plane | sphere]. The entries of a range of
// slots are numbered slot-major, worlds minor, so that consecutive
// threads take consecutive worlds and a dead lane's stores coalesce in
// the worlds-minor outputs. compact_lanes appends the live ones to a
// dense list in that order, by a block-wide prefix of warp ballots
// (deterministic, no atomics), and lets the caller write each dead
// lane's outputs at once. one_wave_tile picks the tile so that the grid
// is one wave of the blocks the card holds at once.

#pragma once

#include "sat_warp.cuh"

namespace {

// The candidate kinds of a tile, in slot order: kind k has cap[k] slots
// a world, its rows in rows[k] [W, cap[k], 2] int32.
template <int K>
struct Cands {
    const int* rows[K];
    int cap[K];
};

// One lane of the tile: entry e is slot e / tile of world w0 + e % tile;
// its kind, its two rows, and whether both name bodies.
struct Lane {
    int slot, world, kind, row_a, row_b;
    bool live;
};

template <int K>
__device__ inline Lane tile_lane(const Cands<K>& cd, int e, int tile,
                                 int w0, int n) {
    Lane l;
    l.slot = e / tile;
    l.world = w0 + e % tile;
    const int* r = nullptr;
    int base = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        if (r == nullptr && (k == K - 1 || l.slot < base + cd.cap[k])) {
            l.kind = k;
            r = cd.rows[k] + ((size_t)l.world * cd.cap[k] + l.slot - base) * 2;
        }
        base += cd.cap[k];
    }
    l.row_a = r[0];
    l.row_b = r[1];
    l.live = l.row_a >= 0 && l.row_a < n && l.row_b >= 0 && l.row_b < n;
    return l;
}

// Append the live entries of [lo, hi) to list, in order, by a block-wide
// prefix of warp ballots; dead(lane) writes each dead lane's outputs.
// Every thread of the block (kThreads of them) calls it; returns the
// count, the same in every thread.
template <int kThreads, int K, typename Dead>
__device__ int compact_lanes(const Cands<K>& cd, int lo, int hi, int tile,
                             int w0, int n, int* list, int* warp_sums,
                             Dead dead) {
    constexpr int kWarps = kThreads / 32;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    int total = 0;
    for (int base = lo; base < hi; base += kThreads) {
        const int e = base + threadIdx.x;
        bool keep = false;
        if (e < hi) {
            const Lane l = tile_lane(cd, e, tile, w0, n);
            keep = l.live;
            if (!keep) dead(l);
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

// Shared memory of the lane machinery of a block of kThreads: a scratch
// and a sum a warp, and a tile's lane list.
template <int kThreads>
__host__ __device__ inline size_t lane_bytes(int tile, int lanes) {
    constexpr int kWarps = kThreads / 32;
    return kWarps * sizeof(WarpScratch) +
           (kWarps + (size_t)tile * lanes) * sizeof(int);
}

// The tile of one wave: the worlds spread over as many blocks as the card
// holds at once of `kernel` (blocks of `threads`, bytes(tile) of shared
// memory), rounded up to a multiple of `step` and at most max_tile. The
// occupancy is asked at the widest tile a block could take, one block an
// SM, within max_tile.
template <typename Kernel, typename Bytes>
int one_wave_tile(Kernel kernel, int threads, int num_worlds, int step,
                  int max_tile, Bytes bytes) {
    int dev = 0, sms = 0, per_sm = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        sms < 1)
        return step < max_tile ? step : max_tile;
    const int even = (num_worlds + sms - 1) / sms;
    const int widest = even < max_tile ? even : max_tile;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, threads, bytes(widest)) != cudaSuccess ||
        per_sm < 1)
        per_sm = 1;
    const int tile = (num_worlds + sms * per_sm - 1) / (sms * per_sm);
    const int rounded = (tile + step - 1) / step * step;
    return rounded < max_tile ? rounded : max_tile;
}

}  // namespace
