// Raycast: the whole per-view render of a flat triangle list, one thread
// per ray.
//
// Replaces the Pallas TPU kernel madrona_tpu/ops/raycast_pallas.py
// (_raycast_kernel, built by make_raytrace). Its plain PyTorch version is
// madrona_tpu_torch/ops/raycast_cuda.py::raytrace_plain; the layouts of
// the four inputs and the eight output planes are described there.
//
// What it computes, per ray of a (world, view): the pinhole-factorised
// Möller–Trumbore test against every triangle row (det = d.A, u*det = d.B,
// v*det = d.C, t = s / det, with d the constant view-local pixel
// direction), the nearest hit with the lowest triangle index winning
// ties, optionally one directional shadow test that is affine in the hit
// distance, the winner's attribute rows, optionally a bilinear GL_REPEAT
// atlas sample at the winner's interpolated uv, and the lambert / sky
// compose (with a light table: max(ambient, sum) clamped to [0, 1]; with
// the one fixed light: ambient + (1 - ambient) * lambert * shadow scale).
//
// What bounds it on the H100: arithmetic. A view's inputs are T * 40
// floats and its outputs 8 floats a ray, while every (ray, triangle) pair
// costs about 30 float operations (about 60 with shadows): at Hide &
// Seek's shape (168 triangles, 4096 rays a view) the operations outweigh
// the bytes by two orders of magnitude.
//
// What the design does about it: nothing of the TPU kernel's [T, R]
// planes, one-hot attribute matmul or separable one-hot texture fetch is
// kept. A block is 128 neighbouring rays of one (world, view). The view's
// setup rows pass through shared memory in chunks of 128 triangles (12 KB,
// so any T_pad works), every thread reads the same row at the same time
// (a broadcast), and keeps a running (t_best, winner, u, v) in registers.
// The ascending loop with a strict < gives the lowest index among equal
// hits. The shadow test needs the final t_best, so it is a second sweep
// over the chunks. Attributes and the four texel taps are then read by
// index, and each output plane is written once, coalesced.
//
// Compiled with --fmad=false and without --use_fast_math: every sum is
// written in the plain version's order, so depth and the winner equal the
// plain version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PS = 24;       // setup columns per triangle
constexpr int FA = 16;       // attribute rows
constexpr int PO = 8;        // output planes
constexpr int TILE = 128;    // rays (threads) per block
constexpr int CHUNK = 128;   // triangles per shared-memory chunk

struct Options {
    int shadows, use_lights, use_materials, tex_size;
    float t_max, t_min, eps_det;
    float ambient, one_minus_ambient, one_minus_shadow_ambient;
    float sky[3];
};

__device__ inline float wrap_repeat(float v, float s) {
    return v - s * floorf(v / s);
}

// atlas[c*S + x, a*S + y]; 0 outside the table (a tex id past the atlas)
__device__ inline float texel(const float* __restrict__ atlas, int a_cols,
                              int s, int c, float xcol, float yrow) {
    if (!(yrow >= 0.0f && yrow < (float)a_cols && xcol >= 0.0f &&
          xcol < (float)s))
        return 0.0f;
    return atlas[(size_t)(c * s + (int)xcol) * a_cols + (int)yrow];
}

__device__ inline void sample_atlas(const float* __restrict__ atlas,
                                    int a_cols, int tex_size, float tex_id,
                                    float uvx, float uvy, float out[3]) {
    if (tex_id < 0.0f) {
        out[0] = out[1] = out[2] = 1.0f;
        return;
    }
    const float s = (float)tex_size;
    const float x = (uvx - floorf(uvx)) * s - 0.5f;
    const float y = (1.0f - (uvy - floorf(uvy))) * s - 0.5f;
    const float x0 = floorf(x), y0 = floorf(y);
    const float fx = x - x0, fy = y - y0;
    const float base = fmaxf(tex_id, 0.0f) * s;
    const float rows[2] = {wrap_repeat(y0, s) + base,
                           wrap_repeat(y0 + 1.0f, s) + base};
    const float cols[2] = {wrap_repeat(x0, s), wrap_repeat(x0 + 1.0f, s)};
    // order: (y0, x0), (y0, x1), (y1, x0), (y1, x1)
    const float wts[4] = {(1.0f - fx) * (1.0f - fy), fx * (1.0f - fy),
                          (1.0f - fx) * fy, fx * fy};
    for (int c = 0; c < 3; ++c) {
        float acc = 0.0f;
        for (int yi = 0; yi < 2; ++yi)
            for (int xi = 0; xi < 2; ++xi) {
                const float v = texel(atlas, a_cols, tex_size, c, cols[xi],
                                      rows[yi]) * wts[yi * 2 + xi];
                acc = (yi == 0 && xi == 0) ? v : acc + v;
            }
        out[c] = acc;
    }
}

__global__ void raycast_kernel(
    const float* __restrict__ setup, const float* __restrict__ attrs,
    const float* __restrict__ dl, const float* __restrict__ atlas,
    float* __restrict__ out, int t_pad, int r_pad, int n_tiles, int a_cols,
    Options o) {
    extern __shared__ float smem[];
    const int wv = blockIdx.x / n_tiles;
    const int r = (blockIdx.x % n_tiles) * TILE + threadIdx.x;
    const bool live = r < r_pad;
    const int rc = live ? r : r_pad - 1;     // pad threads trace a real ray
    const float dx = dl[rc], dy = dl[r_pad + rc], dz = dl[2 * r_pad + rc];
    const float* su = setup + (size_t)wv * t_pad * PS;

    // ---- primary sweep: running nearest hit
    float t_best = o.t_max, u_win = 0.0f, v_win = 0.0f;
    int win = -1;
    for (int c0 = 0; c0 < t_pad; c0 += CHUNK) {
        const int n = min(CHUNK, t_pad - c0);
        __syncthreads();
        for (int i = threadIdx.x; i < n * PS; i += TILE)
            smem[i] = su[(size_t)c0 * PS + i];
        __syncthreads();
        for (int k = 0; k < n; ++k) {
            const float* s = smem + k * PS;
            const float det = s[0] * dx + s[1] * dy + s[2] * dz;
            const float ad = fabsf(det);
            if (!(ad > o.eps_det)) continue;      // dead or edge-on row
            const float uu = s[3] * dx + s[4] * dy + s[5] * dz;
            const float vv = s[6] * dx + s[7] * dy + s[8] * dz;
            const float sd = det > 0.0f ? 1.0f : -1.0f;
            const float pu = uu * sd, pv = vv * sd;
            const float inv = 1.0f / det;
            const float t = s[9] * inv;
            const bool hit = pu >= 0.0f && pv >= 0.0f && pu + pv <= ad &&
                             t > o.t_min && t < o.t_max;
            if (hit && t < t_best) {   // strict: the lowest index wins a tie
                t_best = t;
                win = c0 + k;
                u_win = uu * inv;
                v_win = vv * inv;
            }
        }
    }

    // ---- shadow sweep: affine in t_best, for rays without a hit too
    float occ = 0.0f;
    if (o.shadows) {
        for (int c0 = 0; c0 < t_pad; c0 += CHUNK) {
            const int n = min(CHUNK, t_pad - c0);
            __syncthreads();
            for (int i = threadIdx.x; i < n * PS; i += TILE)
                smem[i] = su[(size_t)c0 * PS + i];
            __syncthreads();
            for (int k = 0; k < n; ++k) {
                const float* s = smem + k * PS;
                const float ads = s[22];
                if (!(ads > o.eps_det)) continue;
                const float m1 = s[11] * dx + s[12] * dy + s[13] * dz;
                const float m2 = s[15] * dx + s[16] * dy + s[17] * dz;
                const float m3 = s[19] * dx + s[20] * dy + s[21] * dz;
                const float pu_s = s[10] + t_best * m1;
                const float pv_s = s[14] + t_best * m2;
                const float ts_s = s[18] + t_best * m3;
                if (pu_s >= 0.0f && pv_s >= 0.0f && pu_s + pv_s <= ads &&
                    ts_s > s[23])
                    occ = 1.0f;
            }
        }
    }
    if (!live) return;                 // after the last barrier

    // ---- the winner's attributes (zero without a hit), by index
    const bool hit_any = t_best < o.t_max;
    float a[FA];
    const float* at = attrs + (size_t)wv * FA * t_pad;
    for (int k = 0; k < FA; ++k)
        a[k] = win >= 0 ? at[(size_t)k * t_pad + win] : 0.0f;
    if (!o.use_materials) u_win = v_win = 0.0f;

    float alb[3];
    if (o.use_materials) {
        const float uvx = (a[6] + u_win * a[8]) + v_win * a[10];
        const float uvy = (a[7] + u_win * a[9]) + v_win * a[11];
        float tex[3];
        sample_atlas(atlas, a_cols, o.tex_size, a[5], uvx, uvy, tex);
        alb[0] = a[2] * tex[0];
        alb[1] = a[3] * tex[1];
        alb[2] = a[4] * tex[2];
    } else {
        alb[0] = a[12];
        alb[1] = a[13];
        alb[2] = a[14];
    }

    const float lam_b = a[0], lam_s = a[1];
    const float occf = occ * (hit_any ? 1.0f : 0.0f);
    float rgb[3];
    if (o.use_lights) {
        const float shade = fmaxf(o.ambient, lam_b + lam_s * (1.0f - occf));
        for (int c = 0; c < 3; ++c)
            rgb[c] = fminf(fmaxf(alb[c] * shade, 0.0f), 1.0f);
    } else {
        const float scale = 1.0f - occf * o.one_minus_shadow_ambient;
        const float shade = o.ambient + o.one_minus_ambient * lam_b * scale;
        for (int c = 0; c < 3; ++c) rgb[c] = alb[c] * shade;
    }
    float* po = out + (size_t)wv * PO * r_pad + r;
    for (int c = 0; c < 3; ++c)
        po[(size_t)c * r_pad] = hit_any ? rgb[c] : o.sky[c];
    po[(size_t)3 * r_pad] = t_best;
    po[(size_t)4 * r_pad] = occf;
    po[(size_t)5 * r_pad] = u_win;
    po[(size_t)6 * r_pad] = v_win;
    po[(size_t)7 * r_pad] = 0.0f;
}

}  // namespace

extern "C" int raycast_launch(
    const void* setup, const void* attrs, const void* dl, const void* atlas,
    void* out, int wv, int t_pad, int r_pad, int a_rows, int a_cols,
    int tex_size, int shadows, int use_lights, int use_materials,
    float t_max, float t_min, float eps_det, double ambient,
    double shadow_ambient, float sky_r, float sky_g, float sky_b,
    void* stream) {
    (void)a_rows;
    Options o;
    o.shadows = shadows;
    o.use_lights = use_lights;
    o.use_materials = use_materials;
    o.tex_size = tex_size;
    o.t_max = t_max;
    o.t_min = t_min;
    o.eps_det = eps_det;
    // the plain version forms 1 - x in double before it meets a float32
    o.ambient = (float)ambient;
    o.one_minus_ambient = (float)(1.0 - ambient);
    o.one_minus_shadow_ambient = (float)(1.0 - shadow_ambient);
    o.sky[0] = sky_r;
    o.sky[1] = sky_g;
    o.sky[2] = sky_b;
    const int n_tiles = (r_pad + TILE - 1) / TILE;
    const long long blocks = (long long)wv * n_tiles;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int smem_bytes = CHUNK * PS * (int)sizeof(float);
    if (blocks > 0)
        raycast_kernel<<<(unsigned)blocks, TILE, smem_bytes,
                         (cudaStream_t)stream>>>(
            (const float*)setup, (const float*)attrs, (const float*)dl,
            (const float*)atlas, (float*)out, t_pad, r_pad, n_tiles, a_cols,
            o);
    return (int)cudaGetLastError();
}
