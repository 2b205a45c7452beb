// Raycast: the whole per-view render of a flat triangle list, four rays
// per thread.
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
// floats and its outputs 8 floats a ray, while every (ray, live
// triangle) pair costs about 30 float operations (about 60 with shadows;
// a dead row, A = 0, needs none): at Hide & Seek's shape (168 triangle
// rows, 4096 rays a view) the operations outweigh the bytes by two
// orders of magnitude. Built with --fmad=false, a multiply-add takes two
// issue slots, so half of the bound (which counts a multiply-add as two
// operations of one FMA slot) is this kernel's ceiling.
//
// What the design does about it: nothing of the TPU kernel's [T, R]
// planes, one-hot attribute matmul or separable one-hot texture fetch is
// kept. A block is 512 rays of one (world, view), 128 threads of four rays
// each: thread i owns pixels i, i + 128, i + 256, i + 384 of the tile, so
// every plane is still written coalesced, and the ragged last tile masks
// its rays one by one. The view's setup rows pass through shared memory in
// chunks of 256 triangles (any T_pad works): the primary sweep stages only
// columns 0..9 and a dead-row flag, padded to three float4, so a thread
// reads a triangle with three 16-byte broadcast loads and tests it against
// its four rays (three loads for four (ray, triangle) pairs). A dead row
// (A = 0, a masked instance or padding) costs one load and a warp-uniform
// branch. Only a row that passes |det| > eps and the sign-folded
// barycentric test forms 1 / det and t, as the plain version forms them,
// so t and the winner (strict < over ascending rows) are the plain
// version's; each ray keeps only (t_best, winner) in
// registers, and with materials the winner's u, v are formed again from
// its row at the end, by the same expressions, to the same bits. The loop
// is unrolled by two. Four rays a thread beat eight on the card (eight
// take 96 registers, fewer warps an SM, and spill predicates). The
// shadow test needs the final t_best, so it is a second sweep that stages
// columns 10..23 as four float4 when shadows are on. Attributes and the four texel taps are then read by
// index, and each output plane is written once.
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
constexpr int TILE = 128;    // threads per block
constexpr int RPT = 4;       // rays per thread
constexpr int RAYS = TILE * RPT;   // rays per block
constexpr int CHUNK = 256;   // triangles per shared-memory chunk
constexpr int PRIM = 12;     // staged primary columns: 0..9, dead, a zero
constexpr int SHAD = 16;     // staged shadow columns: 10..23 and two zeros

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

// One ray's running nearest hit.
struct Best {
    float t;
    int win;
};

// (det, u * det, v * det) of setup row s against direction d, as the
// primary sweep forms them
struct Tri { float det, uu, vv; };
__device__ __forceinline__ Tri primary(float s0, float s1, float s2,
                                       float s3, float s4, float s5,
                                       float s6, float s7, float s8,
                                       float dx, float dy, float dz) {
    return {s0 * dx + s1 * dy + s2 * dz, s3 * dx + s4 * dy + s5 * dz,
            s6 * dx + s7 * dy + s8 * dz};
}

__global__ void __launch_bounds__(TILE) raycast_kernel(
    const float* __restrict__ setup, const float* __restrict__ attrs,
    const float* __restrict__ dl, const float* __restrict__ atlas,
    float* __restrict__ out, int t_pad, int r_pad, int n_tiles, int a_cols,
    Options o) {
    extern __shared__ float smem[];
    float4* rows = reinterpret_cast<float4*>(smem);
    const int wv = blockIdx.x / n_tiles;
    const int r0 = (blockIdx.x % n_tiles) * RAYS + threadIdx.x;
    // ray j of this thread: pixel r0 + j * TILE (pad rays trace a real ray)
    float dx[RPT], dy[RPT], dz[RPT];
    Best b[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
        const int r = r0 + j * TILE;
        const int rc = r < r_pad ? r : r_pad - 1;
        dx[j] = dl[rc];
        dy[j] = dl[r_pad + rc];
        dz[j] = dl[2 * r_pad + rc];
        b[j] = Best{o.t_max, -1};
    }
    const float* su = setup + (size_t)wv * t_pad * PS;

    // ---- primary sweep: columns 0..9 staged as three float4 a triangle,
    // with a flag for a dead row (A = 0: det is 0 for every ray, and a row
    // whose det is 0 never hits, whatever eps_det)
    for (int c0 = 0; c0 < t_pad; c0 += CHUNK) {
        const int n = min(CHUNK, t_pad - c0);
        __syncthreads();
        for (int i = threadIdx.x; i < n * PRIM; i += TILE) {
            const int k = i / PRIM, col = i - k * PRIM;
            const float* sr = su + (size_t)(c0 + k) * PS;
            smem[i] = col < 10 ? sr[col]
                    : col == 10 && sr[0] == 0.0f && sr[1] == 0.0f &&
                              sr[2] == 0.0f ? 1.0f : 0.0f;
        }
        __syncthreads();
#pragma unroll 2
        for (int k = 0; k < n; ++k) {
            const float4 p2 = rows[3 * k + 2];
            if (p2.z != 0.0f) continue;          // a dead row
            const float4 p0 = rows[3 * k], p1 = rows[3 * k + 1];
            // s0..s2 = p0.xyz, s3..s5 = p0.w p1.xy, s6..s8 = p1.zw p2.x,
            // s9 = p2.y
            bool cand[RPT], any = false;
            float det[RPT];
#pragma unroll
            for (int j = 0; j < RPT; ++j) {
                const Tri m = primary(p0.x, p0.y, p0.z, p0.w, p1.x, p1.y,
                                      p1.z, p1.w, p2.x, dx[j], dy[j], dz[j]);
                det[j] = m.det;
                const float ad = fabsf(m.det);
                const float sd = m.det > 0.0f ? 1.0f : -1.0f;
                const float pu = m.uu * sd, pv = m.vv * sd;
                // the barycentric test first: only a row that passes it
                // needs t, so only it pays for the division
                cand[j] = ad > o.eps_det && pu >= 0.0f && pv >= 0.0f &&
                          pu + pv <= ad;
                any = any || cand[j];
            }
            if (!any) continue;
#pragma unroll
            for (int j = 0; j < RPT; ++j) {
                if (!cand[j]) continue;
                const float t = p2.y * (1.0f / det[j]);
                // strict: the lowest index wins a tie
                if (t > o.t_min && t < o.t_max && t < b[j].t)
                    b[j] = Best{t, c0 + k};
            }
        }
    }

    // ---- shadow sweep: affine in t_best, for rays without a hit too;
    // columns 10..23 staged as four float4 a triangle
    float occ[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) occ[j] = 0.0f;
    if (o.shadows) {
        for (int c0 = 0; c0 < t_pad; c0 += CHUNK) {
            const int n = min(CHUNK, t_pad - c0);
            __syncthreads();
            for (int i = threadIdx.x; i < n * SHAD; i += TILE) {
                const int k = i / SHAD, col = i - k * SHAD;
                smem[i] = col < PS - 10
                              ? su[(size_t)(c0 + k) * PS + 10 + col] : 0.0f;
            }
            __syncthreads();
            for (int k = 0; k < n; ++k) {
                // s10..s13 = q0, s14..s17 = q1, s18..s21 = q2, s22 s23 =
                // q3.xy
                const float4 q3 = rows[4 * k + 3];
                const float ads = q3.x;
                if (!(ads > o.eps_det)) continue;
                const float4 q0 = rows[4 * k], q1 = rows[4 * k + 1],
                             q2 = rows[4 * k + 2];
#pragma unroll
                for (int j = 0; j < RPT; ++j) {
                    const float m1 =
                        q0.y * dx[j] + q0.z * dy[j] + q0.w * dz[j];
                    const float m2 =
                        q1.y * dx[j] + q1.z * dy[j] + q1.w * dz[j];
                    const float m3 =
                        q2.y * dx[j] + q2.z * dy[j] + q2.w * dz[j];
                    const float pu_s = q0.x + b[j].t * m1;
                    const float pv_s = q1.x + b[j].t * m2;
                    const float ts_s = q2.x + b[j].t * m3;
                    if (pu_s >= 0.0f && pv_s >= 0.0f && pu_s + pv_s <= ads &&
                        ts_s > q3.y)
                        occ[j] = 1.0f;
                }
            }
        }
    }

    // ---- per ray: the winner's attributes (zero without a hit), by
    // index, the compose and the eight planes, each written coalesced
    const float* at = attrs + (size_t)wv * FA * t_pad;
#pragma unroll 1
    for (int j = 0; j < RPT; ++j) {
        const int r = r0 + j * TILE;
        if (r >= r_pad) break;
        // ray j's registers, by selects (an index would spill the arrays)
        Best bj = b[0];
        float occ_j = occ[0], dx_j = dx[0], dy_j = dy[0], dz_j = dz[0];
#pragma unroll
        for (int i = 1; i < RPT; ++i)
            if (i == j) {
                bj = b[i];
                occ_j = occ[i];
                dx_j = dx[i];
                dy_j = dy[i];
                dz_j = dz[i];
            }
        const int win = bj.win;
        const float t_best = bj.t;
        const bool hit_any = t_best < o.t_max;
        float a[FA];
        for (int k = 0; k < FA; ++k)
            a[k] = win >= 0 ? at[(size_t)k * t_pad + win] : 0.0f;
        // the winner's u, v (with materials only): its row's terms again,
        // formed as the sweep forms them, so the bits are the sweep's
        float u_win = 0.0f, v_win = 0.0f;
        if (o.use_materials && win >= 0) {
            const float* sw = su + (size_t)win * PS;
            const Tri m = primary(sw[0], sw[1], sw[2], sw[3], sw[4], sw[5],
                                  sw[6], sw[7], sw[8], dx_j, dy_j, dz_j);
            const float inv = 1.0f / m.det;
            u_win = m.uu * inv;
            v_win = m.vv * inv;
        }

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
        const float occf = occ_j * (hit_any ? 1.0f : 0.0f);
        float rgb[3];
        if (o.use_lights) {
            const float shade =
                fmaxf(o.ambient, lam_b + lam_s * (1.0f - occf));
            for (int c = 0; c < 3; ++c)
                rgb[c] = fminf(fmaxf(alb[c] * shade, 0.0f), 1.0f);
        } else {
            const float scale = 1.0f - occf * o.one_minus_shadow_ambient;
            const float shade =
                o.ambient + o.one_minus_ambient * lam_b * scale;
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
    const int n_tiles = (r_pad + RAYS - 1) / RAYS;
    const long long blocks = (long long)wv * n_tiles;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int smem_bytes =
        CHUNK * (shadows ? SHAD : PRIM) * (int)sizeof(float);
    if (blocks > 0)
        raycast_kernel<<<(unsigned)blocks, TILE, smem_bytes,
                         (cudaStream_t)stream>>>(
            (const float*)setup, (const float*)attrs, (const float*)dl,
            (const float*)atlas, (float*)out, t_pad, r_pad, n_tiles, a_cols,
            o);
    return (int)cudaGetLastError();
}
