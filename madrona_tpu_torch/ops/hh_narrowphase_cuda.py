"""The hull-hull record narrowphase on its hand-written CUDA kernel
(``csrc/hh_narrowphase.cu``).

The counterpart of the JAX package's two hull-hull-only Pallas kernels,
``ops/narrowphase_pallas.make_hh_narrowphase_sublane``
(``narrowphase="pallas_sublane"``, the port's ``"kernel_sublane"``) and
``make_hh_narrowphase`` (``"pallas"``, the port's ``"kernel"``, which
always sweeps edge pairs): one kernel serves both, since their outputs are
the same function. Per (candidate, world) it emits the JAX package's
22-float record, worlds-minor:

  rec [P, 22, W]   0 ref | 1 alt | 2 num | 3:6 normal | 6:10 x | 10:14 y
                   | 14:18 z | 18:22 depth   (of the 4 manifold points)

with ref = alt = N and num = 0 where there is no contact (the kernel's
floats are zero there; the plain version's are what the math left, as
in the JAX package). Inputs: ``hh`` [W, P, 2] int32 candidate rows as the
broadphase leaves them, ``poses`` [N, 10, W] (pos | rot | scale) and
``obj`` [N, W] int32 (``contacts_cuda.pack_poses``), and the
ObjectManager of the tensors' device.

For a CPU tensor :func:`hh_record` runs the plain version
(:func:`hh_record_plain`: ``physics.narrowphase.hull_hull_lanes``); for a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..physics import narrowphase as np_
from .contacts_cuda import check_tables
from .cuda_build import CudaKernel, check_tensor, entry, stream_ptr

REC_F = 22
_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel(
    "hh_narrowphase.cu", "hh_record_launch", [_P] * 6 + [_I] * 10 + [_P],
)


class TierCount:
    """The launches of :data:`KERNEL` in one SAT tier, counted beside
    KERNEL's own count where :func:`_launch` launches it: B6
    (``edge_dirs``, ``narrowphase="kernel_sublane"``) and B7
    (``edge_pairs``, ``"kernel"``) are one kernel, so only this tells
    their launches apart."""

    def __init__(self, tier: str):
        self.symbol = f"{KERNEL.symbol}[{tier}]"
        self.launches = 0


# the tier counts, keyed by edge_dirs
TIERS = {True: TierCount("edge_dirs"), False: TierCount("edge_pairs")}
# hh_record_launch_tiled's arguments: hh_record_launch's, then the tile
# width and the warp-lane limit, before the stream
TILED_ARGTYPES = KERNEL.argtypes[:-1] + [_I] * 2 + [_P]


def record(ref, alt, points, num, normal):
    """The W-major hull-hull lanes (ref, alt [W, P], points
    [W, P, 4, 4], num [W, P], normal [W, P, 3]) as records [P, 22, W]."""
    w, p = ref.shape
    f32 = torch.float32
    rec = torch.cat([
        ref.to(f32)[..., None], alt.to(f32)[..., None],
        num.to(f32)[..., None], normal,
        points.transpose(-1, -2).reshape(w, p, 16),
    ], dim=-1)
    return rec.permute(1, 2, 0).contiguous()


def lanes(rec):
    """The records [P, 22, W] as W-major (ref, alt, points, num, normal),
    as the JAX package's ``narrowphase_hh_pallas`` unpacks them."""
    r = rec.permute(2, 0, 1)                          # [W, P, 22]
    i32 = torch.int32
    points = r[..., 6:22].reshape(r.shape[:2] + (4, 4)).transpose(-1, -2)
    return (r[..., 0].to(i32), r[..., 1].to(i32), points,
            r[..., 2].to(i32), r[..., 3:6])


def hh_record_plain(hh, poses, obj, om, edge_dirs=True):
    """The plain version: the tensor hull-hull lanes, as records."""
    nb = poses.permute(2, 0, 1)                       # [W, N, 10]
    return record(*np_.hull_hull_lanes(
        nb[..., 0:3], nb[..., 3:7], nb[..., 7:10], obj.t(), om, hh,
        sat_dirs=edge_dirs,
    ))


def tiling(w, p, om):
    """(tile width, warp-lane limit) of the kernel's default launch at W
    worlds and P candidate slots: a tile whose live lanes number at most
    the limit gives each a warp, else each a thread."""
    dims = tuple(om.hull_dims)
    tile, limit = ctypes.c_int(), ctypes.c_int()
    fn = entry("hh_narrowphase.cu", "hh_record_tiling",
               [_I] * 8 + [ctypes.POINTER(_I)] * 2)
    err = fn(w, p, om.hull_pack.shape[0], *dims, om.n_edge_dirs,
             ctypes.byref(tile), ctypes.byref(limit))
    if err:
        raise RuntimeError(f"hh_record_tiling: CUDA error {err}")
    return tile.value, limit.value


def _launch(hh, poses, obj, om, edge_dirs=True, tiled=None):
    """The launch. ``tiled``: (the ``hh_record_launch_tiled`` entry, tile
    width, warp-lane limit), called in place of the counted kernel (the
    sweep and the tests)."""
    n, _, w = poses.shape
    p = hh.shape[1]
    f32, i32 = torch.float32, torch.int32
    check_tensor(hh, "hh", i32, (w, p, 2))
    check_tensor(poses, "poses", f32, (n, 10, w))
    check_tensor(obj, "obj", i32, (n, w))
    n_obj, k = om.hull_pack.shape
    check_tensor(om.hull_pack, "hull_pack", f32, (n_obj, k))
    check_tensor(om.hull_dirs_pack, "hull_dirs_pack", f32,
                 (n_obj, om.hull_dirs_pack.shape[1]))
    check_tables(om)
    dims = tuple(om.hull_dims)
    rec = torch.empty((p, REC_F, w), dtype=f32, device=poses.device)
    if p == 0:
        return rec
    args = (hh.data_ptr(), poses.data_ptr(), obj.data_ptr(),
            om.hull_pack.data_ptr(), om.hull_dirs_pack.data_ptr(),
            rec.data_ptr(), n, w, p, n_obj, dims[0], dims[1], dims[2],
            dims[3], om.n_edge_dirs, 0 if edge_dirs else 1)
    if tiled is None:
        KERNEL.launch(*args, stream_ptr())
        TIERS[bool(edge_dirs)].launches += 1
    else:
        fn, *setting = tiled
        err = fn(*args, *setting, stream_ptr())
        if err:
            raise RuntimeError(f"hh_record_launch_tiled: CUDA error {err}")
    return rec


def hh_record(hh, poses, obj, om, edge_dirs=True):
    """rec [P, 22, W] of the hull-hull candidates: the kernel on CUDA, the
    plain version on a CPU tensor. ``edge_dirs`` picks the SAT tier."""
    if poses.device.type == "cpu":
        return hh_record_plain(hh, poses, obj, om, edge_dirs)
    return _launch(hh, poses, obj, om, edge_dirs)
