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
// and num, which must equal the plain version's. The device functions live
// in csrc/sat.cuh, shared with the hull-hull record and fused-step kernels.

#include "sat.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) hull_hull_kernel(
    const int* __restrict__ hh, const float* __restrict__ poses,
    const int* __restrict__ obj, const float* __restrict__ pack,
    const float* __restrict__ dirs, Out o, int n, int ph, int num_worlds,
    int n_obj, int v, int f, int fv, int e, int d, int pairs) {
    extern __shared__ float smem[];
    const Tables t = stage_tables(smem, pack, dirs, n_obj, v, f, fv, e, d);
    const int w = blockIdx.x * blockDim.x + threadIdx.x;
    const int lane = blockIdx.y;
    if (w >= num_worlds) return;
    const size_t at = (size_t)lane * num_worlds + w;

    const int row_a = hh[((size_t)w * ph + lane) * 2];
    const int row_b = hh[((size_t)w * ph + lane) * 2 + 1];
    if (!(row_a >= 0 && row_a < n && row_b >= 0 && row_b < n)) {
        write_empty(o, at, n);
        return;
    }
    const size_t stride = num_worlds;
    const Body ba = load_body(t, poses + (size_t)row_a * 10 * stride + w,
                              stride, obj[(size_t)row_a * stride + w]);
    const Body bb = load_body(t, poses + (size_t)row_b * 10 * stride + w,
                              stride, obj[(size_t)row_b * stride + w]);
    Manifold m;
    hull_hull(t, ba, bb, pairs != 0, m);
    if (m.num <= 0) {
        write_empty(o, at, n);
        return;
    }
    write_lane(o, at, m.ref_is_a ? row_a : row_b, m.ref_is_a ? row_b : row_a,
               m);
}

__global__ void __launch_bounds__(kThreads) hull_plane_kernel(
    const int* __restrict__ hp, const float* __restrict__ poses,
    const int* __restrict__ obj, const float* __restrict__ pack,
    const float* __restrict__ dirs, Out o, int n, int ph, int pp,
    int num_worlds, int n_obj, int v, int f, int fv, int e, int d) {
    extern __shared__ float smem[];
    const Tables t = stage_tables(smem, pack, dirs, n_obj, v, f, fv, e, d);
    const int w = blockIdx.x * blockDim.x + threadIdx.x;
    const int slot = blockIdx.y;
    if (w >= num_worlds) return;
    const size_t at = (size_t)(ph + slot) * num_worlds + w;

    const int row_h = hp[((size_t)w * pp + slot) * 2];
    const int row_p = hp[((size_t)w * pp + slot) * 2 + 1];
    if (!(row_h >= 0 && row_h < n && row_p >= 0 && row_p < n)) {
        write_empty(o, at, n);
        return;
    }
    const size_t stride = num_worlds;
    const Body bh = load_body(t, poses + (size_t)row_h * 10 * stride + w,
                              stride, obj[(size_t)row_h * stride + w]);
    const Body bp = load_body(t, poses + (size_t)row_p * 10 * stride + w,
                              stride, obj[(size_t)row_p * stride + w]);
    Manifold m;
    hull_plane(t, bh, bp, m);
    if (m.num <= 0) {
        write_empty(o, at, n);
        return;
    }
    // the plane is the reference, the hull the other body
    write_lane(o, at, row_p, row_h, m);
}

}  // namespace

// pairs != 0: the edge_pairs SAT tier; else edge_dirs.
extern "C" int contacts_launch(
    const void* hh, const void* hp, const void* poses, const void* obj,
    const void* pack, const void* dirs, void* ref, void* alt, void* con,
    void* pts, void* num,
    int n, int num_worlds, int ph, int pp, int n_obj, int v, int f, int fv,
    int e, int d, int pairs, void* stream) {
    if (!dims_fit(v, f, fv, e, d) || n < 1 || num_worlds < 1 || ph < 0 ||
        pp < 0)
        return (int)cudaErrorInvalidValue;
    const size_t bytes =
        (size_t)n_obj * (pack_width(v, f, fv, e) + 4 * d + e) * sizeof(float);
    if (bytes > 48 * 1024) return (int)cudaErrorInvalidValue;
    Out o{(int*)ref, (int*)alt, (float*)con, (float*)pts, (int*)num,
          (size_t)(ph + pp) * num_worlds};
    const int blocks = (num_worlds + kThreads - 1) / kThreads;
    cudaStream_t s = (cudaStream_t)stream;
    if (ph > 0) {
        hull_hull_kernel<<<dim3(blocks, ph), kThreads, bytes, s>>>(
            (const int*)hh, (const float*)poses, (const int*)obj,
            (const float*)pack, (const float*)dirs, o, n, ph, num_worlds,
            n_obj, v, f, fv, e, d, pairs);
        cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    if (pp > 0) {
        hull_plane_kernel<<<dim3(blocks, pp), kThreads, bytes, s>>>(
            (const int*)hp, (const float*)poses, (const int*)obj,
            (const float*)pack, (const float*)dirs, o, n, ph, pp, num_worlds,
            n_obj, v, f, fv, e, d);
    }
    return (int)cudaGetLastError();
}
