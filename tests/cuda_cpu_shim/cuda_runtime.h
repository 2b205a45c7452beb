// A CPU stand-in for the few CUDA runtime names the kernels under
// madrona_tpu_torch/csrc use, so that their sources compile with g++ and
// run without a GPU (tests/torch_kernel_shim.py rewrites the <<<...>>>
// launches and the dynamic shared memory declaration first).
//
// Every CUDA thread of a block is one std::thread; blocks run one after
// another. __syncthreads() is a barrier over the block, __syncwarp() one
// over each group of 32 threads. A kernel may therefore only return
// early after its last barrier, which holds for the kernels here.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <memory>
#include <thread>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(x)

struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct shim_idx { unsigned x = 0, y = 0, z = 0; };
inline thread_local shim_idx threadIdx, blockIdx;
inline thread_local dim3 blockDim, gridDim;

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <typename F>
inline cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

using std::max;
using std::min;

// one block's dynamic shared memory (blocks never overlap in time)
inline float shim_smem[256 * 1024 / sizeof(float)];
inline std::barrier<>* shim_block_barrier = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> shim_warp_barriers;
inline void __syncthreads() { shim_block_barrier->arrive_and_wait(); }
inline void __syncwarp() {
    shim_warp_barriers[threadIdx.x / 32]->arrive_and_wait();
}

template <typename K, typename... A>
inline void shim_launch(K kernel, dim3 grid, dim3 block, A... args) {
    for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
            std::barrier<> whole(block.x);
            shim_block_barrier = &whole;
            shim_warp_barriers.clear();
            for (unsigned w = 0; w * 32 < block.x; ++w)
                shim_warp_barriers.emplace_back(
                    new std::barrier<>(std::min(32u, block.x - w * 32)));
            std::vector<std::thread> threads;
            for (unsigned t = 0; t < block.x; ++t)
                threads.emplace_back([=]() {
                    threadIdx.x = t;
                    blockIdx.x = bx;
                    blockIdx.y = by;
                    blockDim = block;
                    gridDim = grid;
                    kernel(args...);
                });
            for (auto& th : threads) th.join();
        }
}
