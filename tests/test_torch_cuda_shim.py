"""The g++ stand-in for the CUDA runtime (tests/cuda_cpu_shim/
cuda_runtime.h): its warp intrinsics against their definitions.

The kernel sources under madrona_tpu_torch/csrc run on the CPU through
this shim (tests/test_torch_kernels_cpu_build.py), and the broadphase and
contacts kernels compact and reduce with warp votes and shuffles. A probe
kernel here calls each one they use on seeded values, in a block of 40
threads: a full warp (mask of all 32 lanes) and a partial last warp of 8
(mask of its 8 lanes, shuffles within segments of 8), and the results
are held against the CUDA programming guide's definitions computed with
numpy. Exact: every value is an integer or a copied float."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

import torch_kernel_shim as shim

THREADS = 40          # warp 0: 32 lanes; warp 1: 8 lanes
PROBE = r"""
#include <cuda_runtime.h>

__global__ void probe(const int* in, const float* fin, int* out, float* fout,
                      int n) {
    const int t = threadIdx.x, lane = t % 32, warp = t / 32;
    const int width = min(32, (int)blockDim.x - warp * 32);
    const unsigned mask = width == 32 ? 0xffffffffu : (1u << width) - 1u;
    const int v = in[t];
    out[0 * n + t] = (int)__ballot_sync(mask, v & 1);
    out[1 * n + t] = __shfl_sync(mask, v, (lane * 7 + 3) % width);
    out[2 * n + t] = __shfl_xor_sync(mask, v, 5, width == 32 ? 32 : 8);
    out[3 * n + t] = __popc((unsigned)v * 2654435761u);
    out[4 * n + t] = __ffs(v << (lane % 9));
    fout[t] = __shfl_xor_sync(mask, fin[t], 2, width == 32 ? 32 : 8);
}

extern "C" int probe_launch(const int* in, const float* fin, int* out,
                            float* fout, int n) {
    probe<<<1, n>>>(in, fin, out, fout, n);
    return (int)cudaGetLastError();
}
"""
INTRINSICS = ("ballot", "shfl", "shfl_xor", "popc", "ffs")


@pytest.fixture(scope="module")
def probe(tmp_path_factory):
    """(int inputs, float inputs, int outputs [5, n], float outputs)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the probe with")
    out_dir = tmp_path_factory.mktemp("cuda_shim")
    cpp = out_dir / "probe.cpp"
    cpp.write_text(shim._rewrite(PROBE))
    lib = out_dir / "libprobe.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-pthread", f"-I{shim.SHIM}", "-o", str(lib), str(cpp)],
                   check=True, capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).probe_launch
    fn.restype = ctypes.c_int
    rs = np.random.RandomState(0)
    vals = rs.randint(1, 100, THREADS).astype(np.int32)
    fvals = rs.randn(THREADS).astype(np.float32)
    out = np.zeros((len(INTRINSICS), THREADS), np.int32)
    fout = np.zeros(THREADS, np.float32)
    ptr = lambda a: a.ctypes.data_as(ctypes.c_void_p)     # noqa: E731
    assert fn(ptr(vals), ptr(fvals), ptr(out), ptr(fout), THREADS) == 0
    return vals, fvals, out, fout


def expected(name, v):
    """One warp's results by the definition: v [width] the lanes'
    values, shuffles within segments of seg lanes."""
    width = len(v)
    seg = 32 if width == 32 else 8
    lane = np.arange(width)
    if name == "ballot":
        bits = sum(int(b) << i for i, b in enumerate(v & 1))
        return np.full(width, np.uint32(bits).view(np.int32))
    if name == "shfl":
        return v[(lane * 7 + 3) % width]
    if name == "shfl_xor":
        src = lane ^ 5
        src = np.where(src < (lane // seg) * seg + seg, src, lane)
        return v[src]
    if name == "popc":
        return np.array([bin((int(x) * 2654435761) & 0xffffffff).count("1")
                         for x in v])
    if name == "ffs":
        shifted = [int(x) << (int(i) % 9) for x, i in zip(v, lane)]
        return np.array([(x & -x).bit_length() for x in shifted])
    raise KeyError(name)


@pytest.mark.parametrize("warp", ["full", "partial"])
@pytest.mark.parametrize("name", INTRINSICS)
def test_shim_warp_intrinsic_matches_definition(probe, name, warp):
    vals, _, out, _ = probe
    lo, hi = (0, 32) if warp == "full" else (32, THREADS)
    got = out[INTRINSICS.index(name), lo:hi]
    np.testing.assert_array_equal(got, expected(name, vals[lo:hi]))


@pytest.mark.parametrize("warp", ["full", "partial"])
def test_shim_float_shuffle_copies_bits(probe, warp):
    _, fvals, _, fout = probe
    lo, hi = (0, 32) if warp == "full" else (32, THREADS)
    seg = 32 if warp == "full" else 8
    lane = np.arange(hi - lo)
    src = lane ^ 2
    src = np.where(src < (lane // seg) * seg + seg, src, lane)
    assert np.array_equal(fout[lo:hi].view(np.int32),
                          fvals[lo:hi][src].view(np.int32))
