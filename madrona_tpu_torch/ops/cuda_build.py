"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ctypes. The build runs at
first use, into ``madrona_tpu_torch/_build/`` (git-ignored), keyed by a
hash of the source and the flags, so a fresh checkout builds everything
on its first call and later calls load the cached library.
:func:`build` starts one ``nvcc`` per source, all at once.

Every C entry point takes device pointers and the stream as
``void*``, launches on PyTorch's current stream and returns
``cudaGetLastError()``; :meth:`CudaKernel.launch` raises if it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

BASE_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]
# No kernel may contract a*b+c into an FMA: each must repeat its plain
# PyTorch version's rounding (the broadphase and the contacts feed integer
# outputs through comparisons; the raycast picks its nearest hit by them). No --use_fast_math: it approximates
# division and square roots.
SOURCE_FLAGS = {
    "broadphase.cu": ["--fmad=false"],
    "lidar.cu": ["--fmad=false"],
    "contacts.cu": ["--fmad=false"],
    "solver.cu": ["--fmad=false"],
    "raycast.cu": ["--fmad=false"],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _flags(source: str) -> List[str]:
    return BASE_FLAGS + SOURCE_FLAGS.get(source, [])


def library_path(source: str) -> Path:
    """Where the library of ``source`` lives, keyed by content + flags."""
    h = hashlib.sha256((CSRC / source).read_bytes())
    h.update(" ".join(_flags(source)).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


# nvcc's resource report (-Xptxas=-v) of each library built here
BUILD_LOG: Dict[str, str] = {}


def build(sources: Iterable[str]) -> Dict[str, Path]:
    """Compile every source whose library is missing, one nvcc each,
    all started together. Returns {source: library path}."""
    sources = list(sources)
    out = {s: library_path(s) for s in sources}
    todo = [s for s in sources if not out[s].exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for s in todo:
        tmp = out[s].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(s), "-o", str(tmp), str(CSRC / s)]
        procs.append((s, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for s, tmp, p in procs:
        log, _ = p.communicate()
        BUILD_LOG[s] = log
        if p.returncode != 0:
            failed.append(f"{s} (rc {p.returncode}):\n{log}")
        else:
            os.replace(tmp, out[s])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


class CudaKernel:
    """One C entry point of one source, loaded on first launch.

    ``launches`` counts the launches made through :meth:`launch`, and
    nothing else does."""

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    def _load(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(build([self.source])[self.source]))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = (lib, fn)       # keep the library alive
        return self._fn[1]

    def launch(self, *args):
        err = self._load()(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol}: CUDA error {err} at launch"
            )
        self.launches += 1


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def check_tensor(t: torch.Tensor, name: str, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of dtype/shape."""
    if not torch.is_tensor(t) or t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
