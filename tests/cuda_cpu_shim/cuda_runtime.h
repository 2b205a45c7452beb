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
// after its last barrier, which holds for the kernels here. The warp
// intrinsics the kernels use (__ballot_sync, __shfl_sync,
// __shfl_xor_sync) exchange their values on the same barriers and follow
// the same mask rules; __popc and __ffs are the compiler's builtins.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
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
// the device the kernels are written for: an H100's 132 SMs, a block of
// any kernel at a time
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* device) {
    *device = 0;
    return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* value, cudaDeviceAttr, int) {
    *value = 132;
    return cudaSuccess;
}
template <typename F>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* blocks, F, int, std::size_t) {
    *blocks = 1;
    return cudaSuccess;
}
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
// A barrier over the lanes of the caller's warp that mask names; false
// (and a fault for the next cudaGetLastError) where the mask leaves out
// its caller or names a lane outside the warp.
inline bool shim_warp_sync(unsigned mask) {
    const unsigned warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const unsigned width = std::min(32u, blockDim.x - warp * 32);
    const unsigned all = width == 32 ? 0xffffffffu : (1u << width) - 1u;
    if (!(mask >> lane & 1u) || (mask & ~all)) {
        shim_fault = true;
        return false;
    }
    if (mask == all) {
        shim_warp_barriers[warp]->arrive_and_wait();
        return true;
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
    return true;
}
inline void __syncwarp(unsigned mask = 0xffffffffu) { shim_warp_sync(mask); }

// The warp-level exchanges, on the same barriers: each named lane writes
// its value to its slot, a barrier, each reads the slot it asks for, a
// barrier (so that no slot is overwritten before every lane has read it).
// Reading a lane that the mask leaves out is a fault, as its value would
// be undefined on the card.
inline std::uint64_t shim_warp_slots[32][32];
template <typename T>
inline T shim_exchange(unsigned mask, T var, int src_lane) {
    static_assert(sizeof(T) <= sizeof(std::uint64_t), "slot size");
    const unsigned warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    std::uint64_t bits = 0;
    std::memcpy(&bits, &var, sizeof(T));
    shim_warp_slots[warp][lane] = bits;
    if (!shim_warp_sync(mask)) return var;
    T out = var;
    if (src_lane < 0 || src_lane >= 32 || !(mask >> src_lane & 1u))
        shim_fault = true;
    else
        std::memcpy(&out, &shim_warp_slots[warp][src_lane], sizeof(T));
    shim_warp_sync(mask);
    return out;
}
inline unsigned __ballot_sync(unsigned mask, int pred) {
    const unsigned warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    shim_warp_slots[warp][lane] = pred != 0;
    if (!shim_warp_sync(mask)) return 0;
    unsigned out = 0;
    for (unsigned l = 0; l < 32; ++l)
        if (mask >> l & 1u) out |= (unsigned)shim_warp_slots[warp][l] << l;
    shim_warp_sync(mask);
    return out;
}
// width: the lanes split into segments of width (a power of two <= 32)
template <typename T>
inline T __shfl_sync(unsigned mask, T var, int src_lane, int width = 32) {
    const int lane = threadIdx.x % 32;
    return shim_exchange(mask, var,
                         (lane & ~(width - 1)) + (src_lane & (width - 1)));
}
template <typename T>
inline T __shfl_xor_sync(unsigned mask, T var, int lane_mask,
                         int width = 32) {
    // a lane of a later segment gives the caller its own value
    const int lane = threadIdx.x % 32;
    const int src = lane ^ lane_mask;
    return shim_exchange(mask, var,
                         src < (lane & ~(width - 1)) + width ? src : lane);
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }

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
