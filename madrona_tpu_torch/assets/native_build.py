"""g++ builds of the port's host C++ (``madrona_tpu_torch/native/*.cpp``).

:func:`build` compiles a source with ``g++ -O2 -shared -fPIC -std=c++17``
at first use into ``madrona_tpu_torch/_build/``, keyed by a hash of the
source and the flags, for ctypes to load. Without g++, or if the build
fails, it raises: the port has no Python fallback for that code.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
NATIVE = PKG / "native"
BUILD_DIR = PKG / "_build"
FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]


def library_path(source: Path) -> Path:
    """Where ``source``'s library lives, keyed by the source and flags."""
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(source: Path) -> Path:
    """``source``'s library, built if it is not there yet."""
    out = library_path(source)
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: {source.name} cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([gxx, *FLAGS, "-o", str(tmp), str(source)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed for {source.name} (rc "
                           f"{r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out
