// The hull-hull lane of the narrowphase as a 22-float record per
// (candidate, world), one thread per (candidate, world).
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
// where most lanes carry the sentinel.
//
// What the design does about it: threads of a warp are 32 neighbouring
// worlds of one candidate slot, so their loads of the worlds-minor poses
// and their record stores coalesce, and in an env whose candidate order is
// the same in most worlds they take the same branches. A lane without a
// candidate or a separated pair stops at once. The hull tables of all
// objects (a few KB) are copied to shared memory per block. No pair
// padding: the TPU kernel pads pairs to its sublane tile only. Compiled
// with --fmad=false, every sum in the plain version's order.

#include "sat.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRecF = 22;

__global__ void __launch_bounds__(kThreads) hh_record_kernel(
    const int* __restrict__ hh, const float* __restrict__ poses,
    const int* __restrict__ obj, const float* __restrict__ pack,
    const float* __restrict__ dirs, float* __restrict__ rec, int n, int p,
    int num_worlds, int n_obj, int v, int f, int fv, int e, int d,
    int pairs) {
    extern __shared__ float smem[];
    const Tables t = stage_tables(smem, pack, dirs, n_obj, v, f, fv, e, d);
    const int w = blockIdx.x * blockDim.x + threadIdx.x;
    const int lane = blockIdx.y;
    if (w >= num_worlds) return;
    const size_t stride = num_worlds;
    float* out = rec + (size_t)lane * kRecF * stride + w;

    const int row_a = hh[((size_t)w * p + lane) * 2];
    const int row_b = hh[((size_t)w * p + lane) * 2 + 1];
    Manifold m;
    m.num = 0;
    if (row_a >= 0 && row_a < n && row_b >= 0 && row_b < n) {
        const Body ba = load_body(t, poses + (size_t)row_a * 10 * stride + w,
                                  stride, obj[(size_t)row_a * stride + w]);
        const Body bb = load_body(t, poses + (size_t)row_b * 10 * stride + w,
                                  stride, obj[(size_t)row_b * stride + w]);
        hull_hull(t, ba, bb, pairs != 0, m);
    }
    if (m.num <= 0) {
        out[0] = (float)n;
        out[stride] = (float)n;
        for (int k = 2; k < kRecF; ++k) out[k * stride] = 0.0f;
        return;
    }
    out[0] = (float)(m.ref_is_a ? row_a : row_b);
    out[stride] = (float)(m.ref_is_a ? row_b : row_a);
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

}  // namespace

// hh [W, P, 2] int32 candidate rows, poses [N, 10, W], obj [N, W] int32
// -> rec [P, 22, W]. pairs != 0: the edge_pairs SAT tier; else edge_dirs.
extern "C" int hh_record_launch(
    const void* hh, const void* poses, const void* obj, const void* pack,
    const void* dirs, void* rec, int n, int num_worlds, int p, int n_obj,
    int v, int f, int fv, int e, int d, int pairs, void* stream) {
    if (!dims_fit(v, f, fv, e, d) || n < 1 || num_worlds < 1 || p < 1)
        return (int)cudaErrorInvalidValue;
    const size_t bytes =
        (size_t)n_obj * (pack_width(v, f, fv, e) + 4 * d + e) * sizeof(float);
    if (bytes > 48 * 1024) return (int)cudaErrorInvalidValue;
    const int blocks = (num_worlds + kThreads - 1) / kThreads;
    hh_record_kernel<<<dim3(blocks, p), kThreads, bytes,
                       (cudaStream_t)stream>>>(
        (const int*)hh, (const float*)poses, (const int*)obj,
        (const float*)pack, (const float*)dirs, (float*)rec, n, p,
        num_worlds, n_obj, v, f, fv, e, d, pairs);
    return (int)cudaGetLastError();
}
