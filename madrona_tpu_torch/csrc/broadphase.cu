// All-pairs broadphase + typed candidate compaction, a warp per world.
//
// Replaces the Pallas TPU kernel madrona_tpu/ops/broadphase_pallas.py
// (_bp_kernel, built by make_broadphase). Its plain PyTorch version is
// madrona_tpu_torch/physics/broadphase.py::find_candidates; the two give
// equal Candidates, field by field.
//
// What it computes, per world: each body's world AABB (center/extent
// transform by the absolute rotation matrix, expanded along velocity*dt);
// for every pair i < j, overlap & both live & not both static; the pair
// ordered lower primitive-type code first; hull-hull, hull-plane and
// sphere hits appended, in row-major (i, j) order, to their own
// fixed-capacity buffers; unused slots hold the sentinel n; counts clamp
// to the cap; overflow = some type had more hits than its cap.
//
// What bounds it on the H100: memory. Per world it reads the packed
// [22, N] body block once (22*N floats) and writes 2*(cap_hh + cap_hp +
// cap_sp) + cap_sp + 3 ints and one byte; the arithmetic (~110 flops per
// body, ~12 per pair) is far below the card's rate. At the main paths'
// shapes the bound is a few microseconds, about a launch's latency: what
// the kernel can lose is latency, not bandwidth.
//
// What the design does about it. A block takes a tile of 8 worlds, a warp
// each (256 threads: 4096 worlds are 512 blocks and 4096 warps, enough
// to keep every SM busy).
//   1. The block's threads walk (body, world of the tile), consecutive
//      threads on consecutive worlds, so the loads of the W-minor
//      [22, N, W] pack stay coalesced; each computes one body's AABB
//      with the plain version's expressions, in its order, and leaves it
//      in shared memory with the body's type, live and static flags.
//   2. A warp walks its world's pairs in row-major order, 32 at a time, a
//      lane a pair. For each type, m = __ballot_sync of the lanes' hits;
//      a hitting lane's slot is the running count plus the hits of the
//      lanes below it (__popc(m & lanemask_lt)), written while below the
//      cap; the count grows by __popc(m). That is the serial append's
//      row-major rank order exactly, with no atomics.
//   3. The lanes fill the slots [min(count, cap), cap) with the sentinel;
//      lane 0 writes the counts and the overflow flag.
// The Pallas kernel's log-shift cumsums and one-hot compaction existed
// only because Mosaic has neither cumsum nor gather.
//
// Compiled with --fmad=false: the AABB arithmetic feeds <= comparisons
// that decide integer outputs, so it must round exactly as the plain
// version's separate multiplies and adds do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBodies = 64;   // checked by the Python wrapper
constexpr int kWorldsPerBlock = 8;
constexpr int kThreads = 32 * kWorldsPerBlock;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTypeNone = 0;
constexpr int kTypeSphere = 1;
constexpr int kTypeHull = 2;
constexpr int kTypePlane = 4;
// a body's flags beside its type in shared memory
constexpr int kLive = 1 << 8;
constexpr int kStatic = 1 << 9;

// pack rows: 0:3 pos | 3:7 rot (w,x,y,z) | 7:10 scale | 10:13 vel
//   | 13:16 local aabb lo | 16:19 local aabb hi | 19 prim type
//   | 20 live | 21 static
constexpr int kPackFields = 22;

// One typed candidate list of one world, filled by its warp.
struct List {
    int* pairs;   // [W, cap, 2]
    int* num;     // [W]
    int* kind;    // [W, cap] or null
    int cap;
    int count;    // hits so far, the same in every lane
};

// Append the lanes' hits of this round of 32 pairs, in lane order.
__device__ inline void append(List& l, int world, bool hit, int first,
                              int second, int kind_value, unsigned below) {
    const unsigned m = __ballot_sync(kFull, hit);
    if (hit) {
        const int slot = l.count + __popc(m & below);
        if (slot < l.cap) {
            int* at = l.pairs + ((size_t)world * l.cap + slot) * 2;
            at[0] = first;
            at[1] = second;
            if (l.kind) l.kind[(size_t)world * l.cap + slot] = kind_value;
        }
    }
    l.count += __popc(m);
}

// The sentinel n in every slot past the count; lane 0 writes the count.
__device__ inline void finish(const List& l, int world, int n, int lane) {
    const int used = l.count < l.cap ? l.count : l.cap;
    for (int c = used + lane; c < l.cap; c += 32) {
        int* at = l.pairs + ((size_t)world * l.cap + c) * 2;
        at[0] = n;
        at[1] = n;
        if (l.kind) l.kind[(size_t)world * l.cap + c] = kTypeNone;
    }
    if (lane == 0) l.num[world] = used;
}

__global__ void __launch_bounds__(kThreads) broadphase_kernel(
    const float* __restrict__ pack, int n, int num_worlds, float dt,
    int* hh, int* hh_num, int cap_hh,
    int* hp, int* hp_num, int cap_hp,
    int* sp, int* sp_num, int* sp_kind, int cap_sp,
    uint8_t* overflow) {
    // per world of the tile: lo [3][n], hi [3][n], type | flags [n]
    extern __shared__ float smem[];
    const int per_world = 7 * n;

    const int w0 = blockIdx.x * kWorldsPerBlock;
    const int tile = min(kWorldsPerBlock, num_worlds - w0);

    // 1. every body's world AABB of the tile's worlds
    const size_t plane = (size_t)n * num_worlds;
    for (int t = threadIdx.x; t < n * kWorldsPerBlock; t += kThreads) {
        const int i = t / kWorldsPerBlock, wi = t % kWorldsPerBlock;
        if (wi >= tile) continue;
        const float* p = pack + (size_t)i * num_worlds + w0 + wi;
        float f[kPackFields];
        for (int k = 0; k < kPackFields; ++k) f[k] = p[k * plane];

        const float qw = f[3], qx = f[4], qy = f[5], qz = f[6];
        const float xx = qx * qx, yy = qy * qy, zz = qz * qz;
        const float xy = qx * qy, xz = qx * qz, yz = qy * qz;
        const float wx = qw * qx, wy = qw * qy, wz = qw * qz;
        const float m[3][3] = {
            {1.0f - 2.0f * (yy + zz), 2.0f * (xy - wz), 2.0f * (xz + wy)},
            {2.0f * (xy + wz), 1.0f - 2.0f * (xx + zz), 2.0f * (yz - wx)},
            {2.0f * (xz - wy), 2.0f * (yz + wx), 1.0f - 2.0f * (xx + yy)},
        };
        float c[3], e[3];
        for (int k = 0; k < 3; ++k) {
            const float l = f[13 + k], h = f[16 + k], s = f[7 + k];
            c[k] = ((l + h) * 0.5f) * s;
            e[k] = ((h - l) * 0.5f) * fabsf(s);
        }
        for (int r = 0; r < 3; ++r) {
            const float nc = m[r][0] * c[0] + m[r][1] * c[1]
                             + m[r][2] * c[2] + f[r];
            const float ne = fabsf(m[r][0]) * e[0] + fabsf(m[r][1]) * e[1]
                             + fabsf(m[r][2]) * e[2];
            const float delta = f[10 + r] * dt;
            float* at = smem + wi * per_world;
            at[r * n + i] = (nc - ne) + fminf(delta, 0.0f);
            at[(3 + r) * n + i] = (nc + ne) + fmaxf(delta, 0.0f);
        }
        reinterpret_cast<int*>(smem + wi * per_world + 6 * n)[i] =
            (int)f[19] | (f[20] > 0.5f ? kLive : 0)
            | (f[21] > 0.5f ? kStatic : 0);
    }
    __syncthreads();

    // 2. a warp per world: its pairs in row-major order, a lane a pair
    const int wi = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (wi >= tile) return;
    const int w = w0 + wi;
    const float* lo = smem + wi * per_world;
    const float* hi = lo + 3 * n;
    const int* info = reinterpret_cast<const int*>(lo + 6 * n);
    const unsigned below = (1u << lane) - 1u;
    List lhh{hh, hh_num, nullptr, cap_hh, 0};
    List lhp{hp, hp_num, nullptr, cap_hp, 0};
    List lsp{sp, sp_num, sp_kind, cap_sp, 0};

    // this lane's pair: the lane-th after (0, 1) in row-major order, and
    // 32 further each round (row i holds j = i+1 .. n-1)
    int i = 0, j = 1 + lane;
    const int pairs = n * (n - 1) / 2;
    for (int round = 0; round < pairs; round += 32) {
        while (i < n - 1 && j >= n) {
            j = j - n + i + 2;
            ++i;
        }
        bool hit = false;
        int first = 0, second = 0, t_lo = 0, t_hi = 0;
        if (round + lane < pairs) {
            const bool overlap =
                lo[i] <= hi[j] && lo[j] <= hi[i] &&
                lo[n + i] <= hi[n + j] && lo[n + j] <= hi[n + i] &&
                lo[2 * n + i] <= hi[2 * n + j] &&
                lo[2 * n + j] <= hi[2 * n + i];
            const int fi = info[i], fj = info[j];
            hit = overlap && (fi & kLive) && (fj & kLive) &&
                  !((fi & kStatic) && (fj & kStatic));
            const int ta = fi & 0xff, tb = fj & 0xff;
            const bool swap = ta > tb;
            first = swap ? j : i;
            second = swap ? i : j;
            t_lo = min(ta, tb);
            t_hi = max(ta, tb);
        }
        const int code = t_lo | t_hi;
        append(lhh, w, hit && code == (kTypeHull | kTypeHull), first,
               second, 0, below);
        append(lhp, w, hit && code == (kTypeHull | kTypePlane), first,
               second, 0, below);
        append(lsp, w, hit && t_lo == kTypeSphere && t_hi != kTypeNone,
               first, second, t_hi, below);
        j += 32;
    }

    // 3. sentinels, counts, overflow
    finish(lhh, w, n, lane);
    finish(lhp, w, n, lane);
    finish(lsp, w, n, lane);
    if (lane == 0)
        overflow[w] = (lhh.count > cap_hh) || (lhp.count > cap_hp) ||
                      (lsp.count > cap_sp);
}

}  // namespace

extern "C" int broadphase_launch(
    const void* pack, int n, int num_worlds, float dt,
    void* hh, void* hh_num, int cap_hh,
    void* hp, void* hp_num, int cap_hp,
    void* sp, void* sp_num, void* sp_kind, int cap_sp,
    void* overflow, void* stream) {
    if (n > kMaxBodies) return (int)cudaErrorInvalidValue;
    const int blocks = (num_worlds + kWorldsPerBlock - 1) / kWorldsPerBlock;
    const size_t bytes = (size_t)kWorldsPerBlock * 7 * n * sizeof(float);
    broadphase_kernel<<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(
        (const float*)pack, n, num_worlds, dt,
        (int*)hh, (int*)hh_num, cap_hh,
        (int*)hp, (int*)hp_num, cap_hp,
        (int*)sp, (int*)sp_num, (int*)sp_kind, cap_sp,
        (uint8_t*)overflow);
    return (int)cudaGetLastError();
}
