// Small vector and quaternion helpers shared by the physics kernels.
//
// Every sum is written out left to right and the sources are compiled with
// --fmad=false, so each expression rounds as the plain PyTorch versions'
// (utils/math3d.py) does.

#pragma once

#include <cuda_runtime.h>

namespace {

// fields of a contact lane in the solver's buffers: 0:3 normal | 3:6
// average point | 6 largest penetration | 7 ok; 4 x (xyz, depth)
constexpr int kConF = 8;
constexpr int kPtsF = 16;

struct V3 { float x, y, z; };
struct Q4 { float w, x, y, z; };

__device__ __forceinline__ V3 operator+(V3 a, V3 b) {
    return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 operator-(V3 a, V3 b) {
    return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) {
    return {a.x * s, a.y * s, a.z * s};
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
    return {a.x * b.x, a.y * b.y, a.z * b.z};
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }
__device__ __forceinline__ Q4 sel(bool c, Q4 a, Q4 b) { return c ? a : b; }
__device__ __forceinline__ Q4 operator+(Q4 a, Q4 b) {
    return {a.w + b.w, a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ Q4 operator-(Q4 a, Q4 b) {
    return {a.w - b.w, a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ Q4 qmul(Q4 a, Q4 b) {
    return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
            a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
            a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
            a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}
__device__ __forceinline__ Q4 qinv(Q4 q) { return {q.w, -q.x, -q.y, -q.z}; }
__device__ __forceinline__ V3 qrot(Q4 q, V3 v) {
    const V3 u = {q.x, q.y, q.z};
    const V3 uv = cross(u, v);
    const V3 uuv = cross(u, uv);
    return {v.x + 2.0f * (q.w * uv.x + uuv.x),
            v.y + 2.0f * (q.w * uv.y + uuv.y),
            v.z + 2.0f * (q.w * uv.z + uuv.z)};
}
__device__ __forceinline__ Q4 qnormalize(Q4 q) {
    const float l2 = q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z;
    const float inv = 1.0f / sqrtf(fmaxf(l2, 1e-30f));
    return {q.w * inv, q.x * inv, q.y * inv, q.z * inv};
}
// quat_mul((0, v), q)
__device__ __forceinline__ Q4 pure_mul(V3 v, Q4 q) {
    return qmul(Q4{0.0f, v.x, v.y, v.z}, q);
}
__device__ __forceinline__ float norm3(V3 v) { return sqrtf(dot(v, v)); }
__device__ __forceinline__ V3 ld3(const float* p) { return {p[0], p[1], p[2]}; }

}  // namespace
