"""Run the port's CUDA kernel sources on the CPU (tests only).

``build_cpu_kernels`` compiles ``madrona_tpu_torch/csrc/*.cu`` with g++
against ``tests/cuda_cpu_shim/cuda_runtime.h`` (one std::thread per CUDA
thread), after rewriting each ``kernel<<<grid, block, ...>>>(args)``
launch into a call of the shim and the dynamic shared memory declaration
into a pointer to the shim's buffer. ``-ffp-contract=off`` keeps g++ from
fusing a*b+c, as ``--fmad=false`` does for nvcc, so the arithmetic rounds
as it does on the card. ``on_cpu`` then points a wrapper module's
``KERNEL`` at such a library and lets its launch path take CPU tensors.

This checks the kernels' arithmetic and indexing without a GPU. It says
nothing about whether nvcc accepts a source or how fast a kernel is.
"""

import contextlib
import ctypes
import pathlib
import re
import shutil
import subprocess

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "madrona_tpu_torch" / "csrc"
SHIM = pathlib.Path(__file__).resolve().parent / "cuda_cpu_shim"
SOURCES = ("broadphase", "contacts", "solver", "lidar", "raycast")

_LAUNCH = re.compile(r"(\w+)<<<(.*?)>>>\(\s*(.*?)\);", re.S)


def _rewrite(source: str) -> str:
    def launch(m):
        kernel, config, args = m.groups()
        # grid, block[, shared bytes, stream]: split on top-level commas
        parts = [p.strip() for p in re.split(r",(?![^()]*\))", config)]
        return (f"shim_launch({kernel}, dim3({parts[0]}), "
                f"dim3({parts[1]}), {args});")

    source = source.replace("extern __shared__ float smem[];",
                            "float* smem = shim_smem;")
    return _LAUNCH.sub(launch, source)


def build_cpu_kernels(out_dir) -> dict:
    """{name: shared library path}, or None where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    out_dir = pathlib.Path(out_dir)
    procs = []
    for name in SOURCES:
        cpp = out_dir / f"{name}.cpp"
        cpp.write_text(_rewrite((CSRC / f"{name}.cu").read_text()))
        lib = out_dir / f"lib{name}_cpu.so"
        procs.append((name, lib, subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-shared",
             "-fPIC", "-pthread", f"-I{SHIM}", "-o", str(lib), str(cpp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    libs = {}
    for name, lib, p in procs:
        log, _ = p.communicate(timeout=600)
        if p.returncode != 0:
            raise RuntimeError(f"g++ failed for {name}.cu:\n{log[-4000:]}")
        libs[name] = lib
    return libs


def _check_cpu(t, name, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: dtype/shape/contiguity")


@contextlib.contextmanager
def on_cpu(module, lib_path):
    """Inside the block, ``module.KERNEL.launch`` runs the CPU build and
    the module's launch path accepts CPU tensors."""
    kernel = module.KERNEL
    lib = ctypes.CDLL(str(lib_path))
    fn = getattr(lib, kernel.symbol)
    fn.argtypes = kernel.argtypes
    fn.restype = ctypes.c_int
    saved = (kernel._fn, kernel.launches, module.check_tensor,
             module.stream_ptr)
    kernel._fn = (lib, fn)
    module.check_tensor = _check_cpu
    module.stream_ptr = lambda: None
    try:
        yield
    finally:
        (kernel._fn, kernel.launches, module.check_tensor,
         module.stream_ptr) = saved
