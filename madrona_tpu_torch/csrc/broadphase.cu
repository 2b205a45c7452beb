// All-pairs broadphase + typed candidate compaction, one thread per world.
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
// cap_sp) + cap_sp + 3 ints and one byte; the arithmetic (~60 flops per
// body, ~10 compares per pair) is far below the card's rate.
//
// What the design does about it: the input is the W-minor planar pack
// [22, N, W], so the 32 threads of a warp (32 neighbouring worlds) read
// 32 neighbouring floats per load, fully coalesced. The Pallas kernel's
// log-shift cumsums and one-hot compaction existed only because Mosaic
// has neither cumsum nor gather; here the thread walks i < j in
// row-major order with one running counter per type, which is exactly
// that rank order, and writes the Candidates' int32 W-major layout
// directly. The per-body AABBs live in per-thread local arrays (L1).
//
// Compiled with --fmad=false: the AABB arithmetic feeds <= comparisons
// that decide integer outputs, so it must round exactly as the plain
// version's separate multiplies and adds do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxBodies = 64;   // checked by the Python wrapper
constexpr int kTypeNone = 0;
constexpr int kTypeSphere = 1;
constexpr int kTypeHull = 2;
constexpr int kTypePlane = 4;

// pack rows: 0:3 pos | 3:7 rot (w,x,y,z) | 7:10 scale | 10:13 vel
//   | 13:16 local aabb lo | 16:19 local aabb hi | 19 prim type
//   | 20 live | 21 static
constexpr int kPackFields = 22;

struct Buffer {
    int* pairs;   // [W, cap, 2]
    int cap;
    int count;
};

__device__ inline void append(Buffer& b, int world, int first, int second,
                              int* kind, int kind_value) {
    if (b.count < b.cap) {
        int* slot = b.pairs + ((size_t)world * b.cap + b.count) * 2;
        slot[0] = first;
        slot[1] = second;
        if (kind) kind[(size_t)world * b.cap + b.count] = kind_value;
    }
    b.count++;
}

__device__ inline void finish(Buffer& b, int world, int n, int* num,
                              int* kind) {
    for (int c = b.count; c < b.cap; ++c) {
        int* slot = b.pairs + ((size_t)world * b.cap + c) * 2;
        slot[0] = n;
        slot[1] = n;
        if (kind) kind[(size_t)world * b.cap + c] = kTypeNone;
    }
    num[world] = b.count < b.cap ? b.count : b.cap;
}

__global__ void broadphase_kernel(
    const float* __restrict__ pack, int n, int num_worlds, float dt,
    int* hh, int* hh_num, int cap_hh,
    int* hp, int* hp_num, int cap_hp,
    int* sp, int* sp_num, int* sp_kind, int cap_sp,
    uint8_t* overflow) {
    const int w = blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= num_worlds) return;

    float lo[kMaxBodies][3], hi[kMaxBodies][3];
    int ptype[kMaxBodies];
    bool live[kMaxBodies], is_static[kMaxBodies];

    const size_t plane = (size_t)n * num_worlds;
    for (int i = 0; i < n; ++i) {
        const float* p = pack + (size_t)i * num_worlds + w;
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
            lo[i][r] = (nc - ne) + fminf(delta, 0.0f);
            hi[i][r] = (nc + ne) + fmaxf(delta, 0.0f);
        }
        ptype[i] = (int)f[19];
        live[i] = f[20] > 0.5f;
        is_static[i] = f[21] > 0.5f;
    }

    Buffer bhh{hh, cap_hh, 0}, bhp{hp, cap_hp, 0}, bsp{sp, cap_sp, 0};
    for (int i = 0; i < n; ++i) {
        for (int j = i + 1; j < n; ++j) {
            const bool overlap =
                lo[i][0] <= hi[j][0] && lo[j][0] <= hi[i][0] &&
                lo[i][1] <= hi[j][1] && lo[j][1] <= hi[i][1] &&
                lo[i][2] <= hi[j][2] && lo[j][2] <= hi[i][2];
            if (!(overlap && live[i] && live[j] &&
                  !(is_static[i] && is_static[j])))
                continue;
            const int ta = ptype[i], tb = ptype[j];
            const bool swap = ta > tb;
            const int first = swap ? j : i, second = swap ? i : j;
            const int t_lo = min(ta, tb), t_hi = max(ta, tb);
            const int code = t_lo | t_hi;
            if (code == (kTypeHull | kTypeHull))
                append(bhh, w, first, second, nullptr, 0);
            if (code == (kTypeHull | kTypePlane))
                append(bhp, w, first, second, nullptr, 0);
            if (t_lo == kTypeSphere && t_hi != kTypeNone)
                append(bsp, w, first, second, sp_kind, t_hi);
        }
    }
    finish(bhh, w, n, hh_num, nullptr);
    finish(bhp, w, n, hp_num, nullptr);
    finish(bsp, w, n, sp_num, sp_kind);
    overflow[w] = (bhh.count > cap_hh) || (bhp.count > cap_hp) ||
                  (bsp.count > cap_sp);
}

}  // namespace

extern "C" int broadphase_launch(
    const void* pack, int n, int num_worlds, float dt,
    void* hh, void* hh_num, int cap_hh,
    void* hp, void* hp_num, int cap_hp,
    void* sp, void* sp_num, void* sp_kind, int cap_sp,
    void* overflow, void* stream) {
    if (n > kMaxBodies) return (int)cudaErrorInvalidValue;
    const int threads = 128;
    const int blocks = (num_worlds + threads - 1) / threads;
    broadphase_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)pack, n, num_worlds, dt,
        (int*)hh, (int*)hh_num, cap_hh,
        (int*)hp, (int*)hp_num, cap_hp,
        (int*)sp, (int*)sp_num, (int*)sp_kind, cap_sp,
        (uint8_t*)overflow);
    return (int)cudaGetLastError();
}
