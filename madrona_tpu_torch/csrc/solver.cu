// Every XPBD substep of one physics step in one launch, half a warp per
// world.
//
// Replaces the Pallas TPU kernel madrona_tpu/ops/solver_pallas.py
// (_substep_kernel, built by make_substep_solver). Its plain PyTorch
// version is madrona_tpu_torch/ops/solver_cuda.py::substep_solver_plain.
//
// What it computes, per world and per substep, on contacts frozen for the
// step: integrate (gravity, external force and torque, gyroscopic term,
// quaternion update); `iters` Jacobi passes of the contact position solve
// (normal correction, then static friction), each contact solved against
// the same snapshot and the 7-float pose deltas averaged per body; the
// fixed and hinge joints, averaged the same way; velocities from the pose
// change; the velocity solve (restitution on the average contact, dynamic
// friction per manifold point), averaged per body. The device functions
// live in csrc/solver.cuh, shared with the fused-step kernel.
//
// What bounds it on the H100: by the count, bytes (it reads each input
// once and writes 33 floats per body once, about 7.5 KB per world at the
// Escape Room shape), with the arithmetic close behind (about 2,000 float
// operations per live contact and substep). In practice it is the issue
// of instructions and their latency: long dependent chains with divisions
// and square roots, a world's state in shared memory, few worlds resident
// on an SM (their shared memory sets the count).
//
// What the design does about it: the body state of a world (33 fields per
// body), its parameters, contacts and joints are loaded once into shared
// memory and never go back to global memory between substeps. A block
// holds 8 worlds on 128 threads, 16 lanes (half a warp) each, so one warp
// instruction serves two worlds: at the default shapes (8 or 9 dynamic
// rows, 16 contact lanes, 2 or 4 joint slots) every per-body and
// per-constraint phase is one pass of the 16 lanes; a warp per world would
// leave half of its lanes or more idle. 8 worlds a block (61 KB of shared
// memory at the Escape Room shape, 51 KB at Hide & Seek's) let 3 or 4
// blocks share an SM; 16 worlds a block would fit 1 or 2. The loads and
// the final store are done by the whole block so that 8 neighbouring
// threads touch 8 neighbouring worlds (one full 32-byte sector) of the
// worlds-minor buffers. A world's lanes own bodies in the per-body phases
// and contacts (or joints) in the per-constraint phases. A constraint
// lane writes its two bodies' deltas to shared memory; then each body
// lane sums the deltas of the constraints that name it, ref side first,
// then alt side, each in lane order, walking the list of them that it
// built once for the step (csrc/solver.cuh::build_list). No atomics: the
// sum order is fixed, so a step is reproducible bit for bit, and equal to
// a scan over every lane. Rows outside the dynamic range are static by
// contract: they are loaded, read by the contacts that touch them and
// never written. A contact that is not ok, or that names the sentinel
// row, does nothing and never becomes an address.

#include "solver.cuh"

namespace {

constexpr int kLanes = 16;                        // lanes per world
constexpr int kThreads = kWorldsPerBlock * kLanes;
// blocks an SM can hold by their shared memory at Hide & Seek's shape;
// the register count must not lower it (at most 128 a thread)
constexpr int kMinBlocks = 4;

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    solver_kernel(Args a) {
    extern __shared__ float smem[];
    const int n = a.n, c = a.c, j = a.j;
    const Layout L = world_layout(n, c, j);
    float* fbase = smem;
    int* ibase = reinterpret_cast<int*>(smem + L.fpw * kWorldsPerBlock);
    const int w0 = blockIdx.x * kWorldsPerBlock;

    load_table(fbase + L.o_st, L.fpw, a.state, kStateF * n, w0, a.w);
    load_table(fbase + L.o_pr, L.fpw, a.param, kParamF * n, w0, a.w);
    load_table(fbase + L.o_con, L.fpw, a.con, kConF * c, w0, a.w);
    load_table(fbase + L.o_pts, L.fpw, a.pts, kPtsF * c, w0, a.w);
    load_table(ibase + L.o_ref, L.ipw, a.ref, c, w0, a.w);
    load_table(ibase + L.o_alt, L.ipw, a.alt, c, w0, a.w);
    load_table(ibase + L.o_num, L.ipw, a.num, c, w0, a.w);
    if (j > 0) {
        load_table(fbase + L.o_jnt, L.fpw, a.jnt, kJntF * j, w0, a.w);
        load_table(ibase + L.o_je1, L.ipw, a.je1, j, w0, a.w);
        load_table(ibase + L.o_je2, L.ipw, a.je2, j, w0, a.w);
    }
    __syncthreads();

    const int lw = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
    World s = world_at(L, fbase + lw * L.fpw, ibase + lw * L.ipw, n, c, j);
    if (w0 + lw < a.w) run_substeps<kLanes>(s, a, lane);
    __syncthreads();

    for (int i = threadIdx.x; i < kOutF * n * kWorldsPerBlock; i += kThreads) {
        const int ow = i % kWorldsPerBlock, row = i / kWorldsPerBlock;
        if (w0 + ow < a.w)
            a.out[(size_t)row * a.w + w0 + ow] =
                fbase[ow * L.fpw + L.o_st + row];
    }
}

}  // namespace

extern "C" int solver_launch(
    const void* state, const void* param, const void* ref, const void* alt,
    const void* con, const void* pts, const void* num, const void* je1,
    const void* je2, const void* jnt, void* out,
    int n, int c, int j, int w, int substeps, int iters, int d0, int d1,
    int ref_live,
    float h, float hgx, float hgy, float hgz, float half_h, float two_over_h,
    float restitution, float rest_thr, void* stream) {
    if (n < 1 || c < 0 || j < 0 || w < 1 || d0 < 0 || d1 > n || d0 >= d1 ||
        ref_live < 0 || ref_live > c)
        return (int)cudaErrorInvalidValue;
    const size_t bytes =
        (floats_per_world(n, c, j) * sizeof(float) +
         ints_per_world(n, c, j) * sizeof(int)) * kWorldsPerBlock;
    if (bytes > kMaxShared) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        solver_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    Args a;
    a.state = (const float*)state; a.param = (const float*)param;
    a.ref = (const int*)ref; a.alt = (const int*)alt;
    a.con = (const float*)con; a.pts = (const float*)pts;
    a.num = (const int*)num; a.je1 = (const int*)je1;
    a.je2 = (const int*)je2; a.jnt = (const float*)jnt;
    a.out = (float*)out;
    a.n = n; a.c = c; a.j = j; a.w = w; a.substeps = substeps;
    a.iters = iters; a.d0 = d0; a.d1 = d1; a.ref_live = ref_live;
    a.h = h; a.hgx = hgx; a.hgy = hgy; a.hgz = hgz; a.half_h = half_h;
    a.two_over_h = two_over_h; a.restitution = restitution;
    a.rest_thr = rest_thr;
    const int blocks = (w + kWorldsPerBlock - 1) / kWorldsPerBlock;
    solver_kernel<<<blocks, kThreads, bytes, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}
