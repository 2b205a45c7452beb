#!/usr/bin/env python3
"""The lidar kernel (B4) against the kernel it replaced, on the card.

    python3 scripts/torch_lidar_compare.py

``THREAD_A_RAY_SOURCE`` below is the lidar kernel before its redesign,
kept verbatim: one thread a (world, agent, ray) in blocks of 128 threads,
every thread looping over all boxes with the box's rotation, the origin's
box-local coordinates and nine divisions formed again for every ray.
``csrc/lidar.cu`` replaced it: a block takes a tile of whole worlds, the
boxes and each (world, agent, box) origin in the box frame are staged in
shared memory once, and a box the self-mask hides is skipped before any
arithmetic.

This script builds the old source with nvcc (the flags of ``lidar.cu``,
into ``madrona_tpu_torch/_build/``), then, on chip_smoke.py's Escape Room
probe state at 4096 worlds and on its random box scene: both kernels'
depth against the plain version (both must be equal to it), the device
ms of each (chip_smoke.timed_device: the calls enqueued behind a sleep
kernel), and the new kernel's device ms at every tile it can take
(``lidar_launch_tiled``; each tile's depth must equal the default
launch's). Prints the card's name and power limit first. chip_smoke.py
runs the same comparison through :func:`start_build`, :func:`load` and
:func:`compare`.

Needs CUDA and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from madrona_tpu_torch.ops import cuda_build, lidar_cuda      # noqa: E402

THREAD_A_RAY_SOURCE = r"""// Lidar: rings of rays against oriented boxes, one thread per (world, ray).
//
// Replaces the Pallas TPU kernel madrona_tpu/ops/lidar_pallas.py
// (_lidar_kernel, built by make_lidar_obb, wrapper lidar_obb). Its plain
// PyTorch version is madrona_tpu_torch/render/raycast.py::trace_rays_obb;
// the two agree to float32 rounding (pinned to 1e-5).
//
// What it computes: for each ray (origin = its agent's position), the
// nearest hit among I boxes by the exact slab test in each box's local
// frame: inside-the-box rays report the exit face (t = lo > 1e-3 ? lo :
// hi), hits need hi >= max(lo, 0), t > 1e-3 and t < t_max, and the static
// [A, I] self-mask hides the caster's own box. Misses report t_max.
//
// What bounds it on the H100: arithmetic. Per (ray, box) about 80 float
// operations (two quaternion rotations, three divisions, the slab
// min/max), against ~(10*I + 3*R + 3 + R) floats of input per world: at
// the Escape Room shape (I = 20, A = 2, R = 60 rays) the operation count
// dominates the bytes by ~30x.
//
// What the design does about it: no work is wasted on layout. The rays of
// one world are neighbouring threads; they read the same box data (served
// by L1 as broadcasts) and their own direction; the box loop keeps the
// running minimum in a register and writes each depth once. The W-major
// [W, I, 3|4|3] env tensors are read as they are, with no transposes.
//
// Compiled with --fmad=false and without --use_fast_math: the guards
// (max(half, 1e-12), |d| > 1e-12 ? 1/d : 1e30) and IEEE division repeat
// the plain version's rounding; an approximate reciprocal would not.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct V3 {
    float x, y, z;
};

__device__ inline V3 cross(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}

// v + 2*(w*(u x v) + u x (u x v)), as math3d.quat_rotate
__device__ inline V3 quat_rotate(float w, V3 u, V3 v) {
    const V3 uv = cross(u, v);
    const V3 uuv = cross(u, uv);
    return {v.x + 2.0f * (w * uv.x + uuv.x), v.y + 2.0f * (w * uv.y + uuv.y),
            v.z + 2.0f * (w * uv.z + uuv.z)};
}

__device__ inline float inv_or_big(float d) {
    return fabsf(d) > 1e-12f ? 1.0f / d : 1e30f;
}

__global__ void lidar_kernel(
    const float* __restrict__ inst_pos, const float* __restrict__ inst_rot,
    const float* __restrict__ inst_half, const uint8_t* __restrict__ mask,
    const float* __restrict__ origins, const float* __restrict__ dirs,
    float* __restrict__ depth, int num_worlds, int n_inst, int n_agents,
    int n_rays, float t_max) {
    const int per_world = n_agents * n_rays;
    const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (long long)num_worlds * per_world) return;
    const int w = (int)(t / per_world);
    const int ar = (int)(t % per_world);
    const int a = ar / n_rays;

    const float* o = origins + ((size_t)w * n_agents + a) * 3;
    const float* d = dirs + (size_t)t * 3;
    const V3 org{o[0], o[1], o[2]};
    const V3 dir{d[0], d[1], d[2]};

    float best = t_max;
    for (int i = 0; i < n_inst; ++i) {
        const size_t wi = (size_t)w * n_inst + i;
        const float* p = inst_pos + wi * 3;
        const float* q = inst_rot + wi * 4;
        const float* hf = inst_half + wi * 3;
        // conjugate = inverse of a unit quaternion
        const float qw = q[0];
        const V3 u{-q[1], -q[2], -q[3]};
        const V3 half{fmaxf(hf[0], 1e-12f), fmaxf(hf[1], 1e-12f),
                      fmaxf(hf[2], 1e-12f)};
        const V3 ro = quat_rotate(qw, u, {org.x - p[0], org.y - p[1],
                                          org.z - p[2]});
        const V3 rd = quat_rotate(qw, u, dir);
        const V3 ol{ro.x / half.x, ro.y / half.y, ro.z / half.z};
        const V3 dl{rd.x / half.x, rd.y / half.y, rd.z / half.z};
        const V3 inv{inv_or_big(dl.x), inv_or_big(dl.y), inv_or_big(dl.z)};
        const float t0x = (-1.0f - ol.x) * inv.x, t1x = (1.0f - ol.x) * inv.x;
        const float t0y = (-1.0f - ol.y) * inv.y, t1y = (1.0f - ol.y) * inv.y;
        const float t0z = (-1.0f - ol.z) * inv.z, t1z = (1.0f - ol.z) * inv.z;
        const float lo = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                               fminf(t0z, t1z));
        const float hi = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                               fmaxf(t0z, t1z));
        const float th = lo > 1e-3f ? lo : hi;   // inside -> exit face
        const bool hit = hi >= fmaxf(lo, 0.0f) && th > 1e-3f &&
                         th < t_max && mask[a * n_inst + i] != 0;
        if (hit) best = fminf(best, th);
    }
    depth[t] = best;
}

}  // namespace

extern "C" int lidar_launch(
    const void* inst_pos, const void* inst_rot, const void* inst_half,
    const void* mask, const void* origins, const void* dirs, void* depth,
    int num_worlds, int n_inst, int n_agents, int n_rays, float t_max,
    void* stream) {
    const long long total = (long long)num_worlds * n_agents * n_rays;
    const int threads = 128;
    const long long blocks = (total + threads - 1) / threads;
    if (blocks > 0)
        lidar_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
            (const float*)inst_pos, (const float*)inst_rot,
            (const float*)inst_half, (const uint8_t*)mask,
            (const float*)origins, (const float*)dirs, (float*)depth,
            num_worlds, n_inst, n_agents, n_rays, t_max);
    return (int)cudaGetLastError();
}
"""


def library_path():
    """Where the old source's library lives, keyed by the source and the
    flags."""
    flags = cuda_build._flags("lidar.cu")
    h = hashlib.sha256((THREAD_A_RAY_SOURCE + " ".join(flags)).encode())
    return cuda_build.BUILD_DIR / f"lidar_thread_a_ray-{h.hexdigest()[:16]}.so"


def start_build():
    """Start nvcc on the old source (None where its library exists);
    pass the result to :func:`load`."""
    lib = library_path()
    if lib.exists():
        return None
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = lib.with_suffix(".cu")
    src.write_text(THREAD_A_RAY_SOURCE)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cuda_build._nvcc(), *cuda_build._flags("lidar.cu"),
           f"-I{cuda_build.CSRC}", "-o", str(tmp), str(src)]
    return lib, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)


def load(started):
    """The old source's ``lidar_launch`` entry (its argument list is the
    wrapper's launch), after the build that :func:`start_build` started.
    Returns (entry, nvcc's register report)."""
    report = ""
    if started is not None:
        lib, tmp, proc = started
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the old lidar source:\n{log}")
        os.replace(tmp, lib)
        report = "\n".join(line.strip() for line in log.splitlines()
                            if "registers" in line or "spill" in line)
    fn = getattr(ctypes.CDLL(str(library_path())), "lidar_launch")
    fn.argtypes = lidar_cuda.KERNEL.argtypes
    fn.restype = ctypes.c_int
    return fn, report


def launch_old(fn, args):
    """Depth [W, A, R] of the old kernel's ``lidar_launch`` entry on the
    wrapper's arguments."""
    import torch

    pos, rot, half, mask, origins, dirs, t_max = args
    w, n_inst = pos.shape[:2]
    n_agents, n_rays = dirs.shape[1], dirs.shape[2]
    depth = torch.empty((w, n_agents, n_rays), dtype=torch.float32,
                        device=pos.device)
    err = fn(pos.data_ptr(), rot.data_ptr(), half.data_ptr(),
             mask.data_ptr(), origins.data_ptr(), dirs.data_ptr(),
             depth.data_ptr(), w, n_inst, n_agents, n_rays, float(t_max),
             cuda_build.stream_ptr())
    if err:
        raise RuntimeError(f"old lidar_launch: CUDA error {err}")
    return depth


def compare(old_fn, args, plain, timer):
    """(largest difference of the old kernel from ``plain``, its device
    ms, the new kernel's device ms), both timed by ``timer`` on ``args``
    in this call."""
    old = launch_old(old_fn, args)
    err = float((old - plain).abs().max())
    old_ms = timer(lambda: launch_old(old_fn, args))
    new_ms = timer(lambda: lidar_cuda.lidar_obb(*args))
    return err, old_ms, new_ms


def sweep(args, timer):
    """{tile: device ms} of the new kernel at every tile it can take;
    each tile's depth must equal the default launch's."""
    import torch

    fn = cuda_build.entry("lidar.cu", "lidar_launch_tiled",
                          lidar_cuda.TILED_ARGTYPES)
    ref = lidar_cuda.lidar_obb(*args)
    default = lidar_cuda.tiling(args[0].shape[0], args[0].shape[1],
                                *args[5].shape[1:3])
    lanes = default["threads"] // default["tile"]
    out = {}
    tile = 1
    while tile <= 16 and tile * lanes <= 1024:
        got = lidar_cuda._launch(*args, tiled=(fn, tile))
        if not torch.equal(got, ref):
            raise AssertionError(f"lidar tile {tile}: depth differs from "
                                 "the default launch")
        out[tile] = timer(lambda: lidar_cuda._launch(*args,
                                                     tiled=(fn, tile)))
        tile *= 2
    return out


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch

    argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]).parse_args(argv)

    if not torch.cuda.is_available():
        print("torch_lidar_compare: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from madrona_tpu_torch import make_sim
    from madrona_tpu_torch.models.escape_room import EscapeRoom

    card = cs.card_line()
    print(card)
    started = start_build()
    cuda_build.build(["lidar.cu"])
    for line in cuda_build.BUILD_LOG.get("lidar.cu", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  lidar.cu: {line.strip()}")
    old_fn, report = load(started)
    for line in report.splitlines():
        print(f"  old lidar source: {line}")
    acts = EscapeRoom.random_actions(np.random.RandomState(0), 3, cs.W)
    sim = make_sim(EscapeRoom(), num_worlds=cs.W, seed=1, device="cuda")
    for i in range(3):
        sim.step({"action": acts[i].cuda(),
                  "reset": torch.zeros((cs.W,), dtype=torch.int32,
                                       device="cuda")})
    er_args = cs.lidar_inputs(sim)
    tiling = lidar_cuda.tiling(cs.W, er_args[0].shape[1],
                               *er_args[5].shape[1:3])
    print("lidar tiling (occupancy API): " + ", ".join(
        f"{k} {v}" for k, v in tiling.items()))
    for name, args in (("escape_room", er_args),
                       ("random", cs.random_lidar_args())):
        plain = cs.plain_lidar(args)
        new_err = float((lidar_cuda.lidar_obb(*args) - plain).abs().max())
        err, old_ms, new_ms = compare(old_fn, args, plain, cs.timed_device)
        print(f"lidar [{name}] W={cs.W}: one thread a ray {old_ms:.4f} ms, "
              f"tiles of worlds {new_ms:.4f} ms (device); max_abs_diff "
              f"{err!r} / {new_err!r} ({card})")
        tiles = sweep(args, cs.timed_device)
        print(f"lidar [{name}] by tile (worlds a block): " + ", ".join(
            f"{t} {ms:.4f}" for t, ms in tiles.items()) + f" ms ({card})")
        if err != 0.0 or new_err != 0.0:
            raise AssertionError(f"lidar [{name}]: a kernel differs from "
                                 "the plain version")
    return 0


if __name__ == "__main__":
    sys.exit(main())
