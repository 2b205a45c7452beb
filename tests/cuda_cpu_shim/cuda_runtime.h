// A CPU stand-in for the few CUDA runtime names the kernels under
// madrona_tpu_torch/csrc use, so that their sources compile with g++ and
// run without a GPU (tests/torch_kernel_shim.py rewrites the <<<...>>>
// launches and the dynamic shared memory declaration first).
//
// Every CUDA thread of a block is one std::thread; blocks run one after
// another. __syncthreads() is a barrier over the block; __syncwarp(mask)
// one over exactly the lanes of the caller's warp that the mask names
// (all 32 by default): a mask that leaves out its caller is reported by
// the next cudaGetLastError(), and a named lane that never syncs hangs the
// block, as it may on the card. A kernel may therefore only return early
// after its last barrier, which holds for the kernels here.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <utility>
#include <vector>

#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)

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
// set by a __syncwarp whose mask leaves out its caller or names a lane
// outside the warp; the next cudaGetLastError() reports it
inline std::atomic<bool> shim_fault{false};
inline cudaError_t cudaGetLastError() {
    return shim_fault.exchange(false) ? cudaErrorInvalidValue : cudaSuccess;
}

using std::max;
using std::min;

struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
    return {x, y, z, w};
}

// one block's dynamic shared memory (blocks never overlap in time)
alignas(16) inline float shim_smem[256 * 1024 / sizeof(float)];
inline std::barrier<>* shim_block_barrier = nullptr;
inline std::vector<std::unique_ptr<std::barrier<>>> shim_warp_barriers;
// the barriers of partial masks, by (warp, mask), made at first use
inline std::mutex shim_mask_mutex;
inline std::map<std::pair<unsigned, unsigned>, std::unique_ptr<std::barrier<>>>
    shim_mask_barriers;
inline void __syncthreads() { shim_block_barrier->arrive_and_wait(); }
inline void __syncwarp(unsigned mask = 0xffffffffu) {
    const unsigned warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const unsigned width = std::min(32u, blockDim.x - warp * 32);
    const unsigned all = width == 32 ? 0xffffffffu : (1u << width) - 1u;
    if (!(mask >> lane & 1u) || (mask & ~all)) {
        shim_fault = true;
        return;
    }
    if (mask == all) {
        shim_warp_barriers[warp]->arrive_and_wait();
        return;
    }
    std::barrier<>* b;
    {
        std::lock_guard<std::mutex> hold(shim_mask_mutex);
        auto& slot = shim_mask_barriers[{warp, mask}];
        if (!slot)
            slot.reset(new std::barrier<>(__builtin_popcount(mask)));
        b = slot.get();
    }
    b->arrive_and_wait();
}

template <typename K, typename... A>
inline void shim_launch(K kernel, dim3 grid, dim3 block, A... args) {
    for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
            std::barrier<> whole(block.x);
            shim_block_barrier = &whole;
            shim_warp_barriers.clear();
            shim_mask_barriers.clear();
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
