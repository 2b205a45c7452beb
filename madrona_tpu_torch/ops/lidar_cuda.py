"""Lidar on its hand-written CUDA kernel (``csrc/lidar.cu``).

The counterpart of the JAX package's ``ops/lidar_pallas.lidar_obb``,
with its shapes. For a CPU tensor :func:`lidar_obb` runs the plain
version (``render.raycast.trace_rays_obb``); for a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..render.raycast import trace_rays_obb
from .cuda_build import CudaKernel, check_tensor, entry, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float]
KERNEL = CudaKernel("lidar.cu", "lidar_launch", _ARGS + [_P])
# the same launch at a given tile (worlds a block), uncounted: the tests
# and the sweep bind it from a build with cuda_build.entry or ctypes
TILED_ARGTYPES = _ARGS + [_I, _P]
TILING_FIELDS = ("tile", "threads", "blocks", "shared_bytes",
                 "blocks_per_sm", "waves")


def lidar_obb_plain(inst_pos, inst_rot, inst_half, self_mask, origins,
                    dirs, t_max):
    """The plain version at the kernel's shapes (trace_rays_obb with the
    boxes broadcast over agents and each agent's origin over its rays)."""
    return trace_rays_obb(
        inst_pos[:, None], inst_rot[:, None], inst_half[:, None],
        self_mask, origins[:, :, None, :], dirs, t_max,
    )


def lidar_obb(inst_pos, inst_rot, inst_half, self_mask, origins, dirs,
              t_max):
    """Depth [W, A, R] of rings of rays against oriented boxes.

    inst_pos/inst_rot/inst_half: [W, I, 3|4|3]; self_mask: [A, I] bool
    (instance i visible to agent a's rays); origins [W, A, 3] (each
    agent's rays share its origin); dirs [W, A, R, 3]. Misses report
    t_max."""
    if inst_pos.device.type == "cpu":
        return lidar_obb_plain(inst_pos, inst_rot, inst_half, self_mask,
                               origins, dirs, t_max)
    return _launch(inst_pos, inst_rot, inst_half, self_mask, origins, dirs,
                   t_max)


def tiling(w, n_inst, n_agents, n_rays):
    """The default launch's {tile, threads, blocks, shared_bytes,
    blocks_per_sm, waves} at W worlds, I boxes, A agents of R rays: the
    tile (worlds a block) whose grid takes the fewest waves, then the
    most threads an SM (the occupancy API on the current card)."""
    out = (_I * len(TILING_FIELDS))()
    fn = entry("lidar.cu", "lidar_tiling", [_I] * 4 + [ctypes.POINTER(_I)])
    err = fn(w, n_inst, n_agents, n_rays, out)
    if err:
        raise RuntimeError(f"lidar_tiling: CUDA error {err}")
    return dict(zip(TILING_FIELDS, out))


def _launch(inst_pos, inst_rot, inst_half, self_mask, origins, dirs, t_max,
            tiled=None):
    """The launch. ``tiled``: (the ``lidar_launch_tiled`` entry, tile),
    called in place of the counted kernel (the sweep and the tests)."""
    w, n_inst = inst_pos.shape[:2]
    n_agents, n_rays = dirs.shape[1], dirs.shape[2]
    f32 = torch.float32
    check_tensor(inst_pos, "inst_pos", f32, (w, n_inst, 3))
    check_tensor(inst_rot, "inst_rot", f32, (w, n_inst, 4))
    check_tensor(inst_half, "inst_half", f32, (w, n_inst, 3))
    check_tensor(self_mask, "self_mask", torch.bool, (n_agents, n_inst))
    check_tensor(origins, "origins", f32, (w, n_agents, 3))
    check_tensor(dirs, "dirs", f32, (w, n_agents, n_rays, 3))
    depth = torch.empty((w, n_agents, n_rays), dtype=f32,
                        device=inst_pos.device)
    args = (inst_pos.data_ptr(), inst_rot.data_ptr(), inst_half.data_ptr(),
            self_mask.data_ptr(), origins.data_ptr(), dirs.data_ptr(),
            depth.data_ptr(), w, n_inst, n_agents, n_rays, float(t_max))
    if tiled is None:
        KERNEL.launch(*args, stream_ptr())
    else:
        fn, tile = tiled
        err = fn(*args, tile, stream_ptr())
        if err:
            raise RuntimeError(f"lidar_launch_tiled: CUDA error {err}")
    return depth
