"""Broadphase on its hand-written CUDA kernel (``csrc/broadphase.cu``).

The kernel route of the all-pairs broadphase: the counterpart of the
JAX package's ``find_candidates_pallas``. For a CPU tensor
:func:`find_candidates_kernel` runs the plain version
(``physics.broadphase.find_candidates``); for a CUDA tensor it launches
the kernel or raises. The two produce equal Candidates.
"""

from __future__ import annotations

import ctypes

import torch

from ..physics import broadphase as bp
from ..physics.bodies import RESPONSE_STATIC
from .cuda_build import CudaKernel, check_tensor, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel(
    "broadphase.cu", "broadphase_launch",
    [_P, _I, _I, ctypes.c_float, _P, _P, _I, _P, _P, _I,
     _P, _P, _P, _I, _P, _P],
)
MAX_BODIES = 64
PACK_F = 22   # pos 3 | rot 4 | scale 3 | vel 3 | aabb lo 3 | hi 3 | type | live | static


def pack_bodies(body, om) -> torch.Tensor:
    """The kernel's input: [PACK_F, N, W] float32, worlds minor."""
    params = om.obj_params(body.obj_id)
    f32 = lambda b: b.to(torch.float32)[..., None]   # noqa: E731
    pack = torch.cat([
        body.pos, body.rot, body.scale, body.vel,
        params["aabb_min"], params["aabb_max"],
        f32(params["prim_type"]), f32(body.active),
        f32(body.response == RESPONSE_STATIC),
    ], dim=-1)                                        # [W, N, PACK_F]
    return pack.permute(2, 1, 0).contiguous()


def broadphase(pack: torch.Tensor, caps: bp.CandidateCaps,
               expansion_dt: float) -> bp.Candidates:
    """Launch the kernel on a packed block [PACK_F, N, W]."""
    _, n, w = pack.shape
    check_tensor(pack, "pack", torch.float32, (PACK_F, n, w))
    if n > MAX_BODIES:
        raise ValueError(f"broadphase kernel takes <= {MAX_BODIES} bodies")
    dev = pack.device
    i32 = dict(dtype=torch.int32, device=dev)
    ch, cp, cs = caps.hull_hull, caps.hull_plane, caps.sphere_any
    out = bp.Candidates(
        hh=torch.empty((w, ch, 2), **i32), hh_num=torch.empty((w,), **i32),
        hp=torch.empty((w, cp, 2), **i32), hp_num=torch.empty((w,), **i32),
        sp=torch.empty((w, cs, 2), **i32), sp_num=torch.empty((w,), **i32),
        sp_kind=torch.empty((w, cs), **i32),
        overflow=torch.empty((w,), dtype=torch.bool, device=dev),
    )
    KERNEL.launch(
        pack.data_ptr(), n, w, float(expansion_dt),
        out.hh.data_ptr(), out.hh_num.data_ptr(), ch,
        out.hp.data_ptr(), out.hp_num.data_ptr(), cp,
        out.sp.data_ptr(), out.sp_num.data_ptr(), out.sp_kind.data_ptr(), cs,
        out.overflow.data_ptr(), stream_ptr(),
    )
    return out


def find_candidates_kernel(body, om, caps: bp.CandidateCaps,
                           expansion_dt: float) -> bp.Candidates:
    """All-pairs candidates: the kernel on CUDA, the plain version on a
    CPU tensor."""
    if body.pos.device.type == "cpu":
        return bp.find_candidates(body, om, caps, expansion_dt)
    return broadphase(pack_bodies(body, om), caps, expansion_dt)
