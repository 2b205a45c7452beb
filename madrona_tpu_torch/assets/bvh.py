"""Mesh BVH: the host-side SAH build and a host ray query.

Port of ``madrona_tpu/assets/bvh.py``. The builder is C++ host code of
the port's own (``native/bvh_build.cpp``, a copy of the BVH part of the
JAX package's native importer): :func:`build_mesh_bvh` builds it with
g++ at first use (:mod:`.native_build`) and binds it with ctypes. Without
g++, or if the build fails, it raises: there is no Python builder to
fall back to.

The arrays are numpy, as in the JAX package: ``render/blas.py::bake_blas``
stacks them into device tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np

from . import native_build

SOURCE = native_build.NATIVE / "bvh_build.cpp"


class _BVHOut(ctypes.Structure):
    _fields_ = [
        ("node_min", ctypes.POINTER(ctypes.c_float)),
        ("node_max", ctypes.POINTER(ctypes.c_float)),
        ("node_left", ctypes.POINTER(ctypes.c_int32)),
        ("node_right", ctypes.POINTER(ctypes.c_int32)),
        ("tri_order", ctypes.POINTER(ctypes.c_int32)),
        ("num_nodes", ctypes.c_int64),
    ]


def library_path():
    """Where the builder's library lives, keyed by its source and flags."""
    return native_build.library_path(SOURCE)


_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(native_build.build(SOURCE)))
        lib.bvh_build.restype = ctypes.POINTER(_BVHOut)
        lib.bvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64, ctypes.c_int64,
        ]
        lib.bvh_free.argtypes = [ctypes.POINTER(_BVHOut)]
        _LIB = lib
    return _LIB


@dataclasses.dataclass
class MeshBVH:
    node_min: np.ndarray    # [N, 3]
    node_max: np.ndarray    # [N, 3]
    left: np.ndarray        # [N] child / leaf first-tri
    right: np.ndarray       # [N] child / -count if leaf
    tri_order: np.ndarray   # [T]
    positions: np.ndarray   # [V, 3]
    indices: np.ndarray     # [T, 3]

    @property
    def num_nodes(self) -> int:
        return len(self.left)

    def is_leaf(self, i: int) -> bool:
        return self.right[i] < 0

    def trace_ray(self, origin, direction, t_max=1e30):
        """Stack-based nearest-hit query in float64 (host; validation).
        Returns (t, original triangle index or -1)."""
        o = np.asarray(origin, np.float64)
        d = np.asarray(direction, np.float64)
        inv = np.divide(
            1.0, d, out=np.full(3, 1e30), where=np.abs(d) > 1e-12
        )
        best_t, best_tri = t_max, -1
        stack = [0]
        while stack:
            n = stack.pop()
            t0 = (self.node_min[n] - o) * inv
            t1 = (self.node_max[n] - o) * inv
            lo = np.minimum(t0, t1).max()
            hi = np.maximum(t0, t1).min()
            if hi < max(lo, 0.0) or lo > best_t:
                continue
            if self.is_leaf(n):
                first, count = self.left[n], -self.right[n]
                for k in range(first, first + count):
                    ti = self.tri_order[k]
                    tri = self.indices[ti]
                    v0 = self.positions[tri[0]]
                    e1 = self.positions[tri[1]] - v0
                    e2 = self.positions[tri[2]] - v0
                    p = np.cross(d, e2)
                    det = e1 @ p
                    if abs(det) < 1e-12:
                        continue
                    tvec = o - v0
                    u = (tvec @ p) / det
                    q = np.cross(tvec, e1)
                    v = (d @ q) / det
                    t = (e2 @ q) / det
                    if 0 <= u and 0 <= v and u + v <= 1 and 1e-9 < t < best_t:
                        best_t, best_tri = t, int(ti)
            else:
                stack.append(int(self.left[n]))
                stack.append(int(self.right[n]))
        return best_t, best_tri


def build_mesh_bvh(positions, indices, leaf_size: int = 4) -> MeshBVH:
    """Bake a binary SAH BVH of one triangle mesh (host C++ builder)."""
    lib = _lib()
    pos = np.ascontiguousarray(positions, np.float32)
    idx = np.ascontiguousarray(indices, np.int32)
    nt = len(idx)
    out = lib.bvh_build(
        pos.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(pos),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), nt, leaf_size,
    )
    try:
        nn = out.contents.num_nodes
        arr = lambda p, shape: np.ctypeslib.as_array(p, shape=shape).copy()  # noqa: E731
        return MeshBVH(
            node_min=arr(out.contents.node_min, (nn, 3)),
            node_max=arr(out.contents.node_max, (nn, 3)),
            left=arr(out.contents.node_left, (nn,)),
            right=arr(out.contents.node_right, (nn,)),
            tri_order=arr(out.contents.tri_order, (nt,)),
            positions=pos,
            indices=idx,
        )
    finally:
        lib.bvh_free(out)
