"""Contacts on their hand-written CUDA kernel (``csrc/contacts.cu``).

The counterpart of the JAX package's ``ops/physics_megakernel.
make_contacts_kernel`` (with the SAT body it calls, ``ops/
narrowphase_pallas.hh_sat_planes``): hull-hull SAT with its clipped
manifold, the hull-plane lane, and each manifold's reduction to an
average point, largest penetration and ok flag. The five buffers it
returns are the substep-solver kernel's contact inputs as they stand
(``ops/solver_cuda``), worlds-minor:

  ref, alt, num [C, W] int32      row N = no contact
  con [CON_F, C, W]               0:3 normal | 3:6 average point
                                  | 6 largest penetration | 7 ok
  pts [PTS_F, C, W]               4 x (xyz, depth)

with C = PH + PP lanes: the hull-hull candidates, then the hull-plane
ones. The hull-hull SAT runs either tier of ``PhysicsConfig.sat_tier``. Inputs: ``hh`` [W, PH, 2] and ``hp`` [W, PP, 2] int32 candidate
rows as the broadphase leaves them (hp: hull row, plane row), ``poses``
[N, 10, W] (pos | rot | scale, at the predicted poses), ``obj`` [N, W]
int32 object ids, and the ObjectManager of the tensors' device.

For a CPU tensor :func:`contacts` runs the plain version
(:func:`contacts_plain`: ``physics.narrowphase.narrowphase_lanes`` and
``solver_cuda.pack_contacts``); for a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..physics import narrowphase as np_
from ..physics import xpbd
from .cuda_build import CudaKernel, check_tensor, stream_ptr
from .solver_cuda import CON_F, PTS_F, pack_contacts

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = CudaKernel(
    "contacts.cu", "contacts_launch",
    [_P] * 11 + [_I] * 11 + [_P],
)
# contacts_launch_tiled's arguments: contacts_launch's, then the tile
# width and the warp-lane limit, before the stream
TILED_ARGTYPES = KERNEL.argtypes[:-1] + [_I] * 2 + [_P]
# the narrowphase kernels' per-thread hull tables (csrc/sat.cuh) are
# sized for these
MAX_DIMS = (8, 6, 4, 12)      # verts, faces, verts per face, edges
MAX_DIRS = 6
MAX_SHARED = 48 * 1024


def pack_poses(pred, obj_id):
    """(poses [N, 10, W], obj [N, W] int32) of predicted pos/rot and the
    un-integrated body's scale and object ids."""
    nb = torch.cat([pred.pos, pred.rot, pred.scale], dim=-1)   # [W, N, 10]
    return nb.permute(1, 2, 0).contiguous(), obj_id.t().contiguous()


def contacts_plain(hh, hp, poses, obj, om, edge_dirs=True):
    """The plain version: the tensor narrowphase on the same lanes, then
    the manifold reduction, in the kernel's layout."""
    nb = poses.permute(2, 0, 1)                                # [W, N, 10]
    ref, alt, points, num, normal = np_.narrowphase_lanes(
        nb[..., 0:3], nb[..., 3:7], nb[..., 7:10], obj.t(), om, hh, hp,
        sat_dirs=edge_dirs,
    )
    return pack_contacts(xpbd.Contacts(
        ref=ref, alt=alt, points=points, num=num, normal=normal,
        lambda_n=None,
    ))


def check_tables(om):
    """Raise unless the ObjectManager's hull tables fit the per-thread
    tables of the narrowphase kernels (csrc/sat.cuh) and their shared
    memory; a larger hull is refused, never truncated."""
    n_obj, k = om.hull_pack.shape
    kd = om.hull_dirs_pack.shape[1]
    dims, d = tuple(om.hull_dims), om.n_edge_dirs
    if any(x > m for x, m in zip(dims, MAX_DIMS)) or d > MAX_DIRS:
        raise ValueError(
            f"the narrowphase kernels take hull dims <= {MAX_DIMS} and <= "
            f"{MAX_DIRS} edge directions, got {dims} and {d}"
        )
    if n_obj * (k + kd) * 4 > MAX_SHARED:
        raise ValueError("hull tables exceed the kernels' shared memory")


def _launch(hh, hp, poses, obj, om, edge_dirs=True, tiled=None):
    """The launch. ``tiled``: (the ``contacts_launch_tiled`` entry, tile
    width, warp-lane limit), called in place of the counted kernel (the
    sweep script)."""
    n, _, w = poses.shape
    ph, pp = hh.shape[1], hp.shape[1]
    c = ph + pp
    f32, i32 = torch.float32, torch.int32
    check_tensor(hh, "hh", i32, (w, ph, 2))
    check_tensor(hp, "hp", i32, (w, pp, 2))
    check_tensor(poses, "poses", f32, (n, 10, w))
    check_tensor(obj, "obj", i32, (n, w))
    n_obj, k = om.hull_pack.shape
    kd = om.hull_dirs_pack.shape[1]
    check_tensor(om.hull_pack, "hull_pack", f32, (n_obj, k))
    check_tensor(om.hull_dirs_pack, "hull_dirs_pack", f32, (n_obj, kd))
    check_tables(om)
    dims, d = tuple(om.hull_dims), om.n_edge_dirs
    dev = poses.device
    ref = torch.empty((c, w), dtype=i32, device=dev)
    alt = torch.empty((c, w), dtype=i32, device=dev)
    num = torch.empty((c, w), dtype=i32, device=dev)
    con = torch.empty((CON_F, c, w), dtype=f32, device=dev)
    pts = torch.empty((PTS_F, c, w), dtype=f32, device=dev)
    args = (hh.data_ptr(), hp.data_ptr(), poses.data_ptr(), obj.data_ptr(),
            om.hull_pack.data_ptr(), om.hull_dirs_pack.data_ptr(),
            ref.data_ptr(), alt.data_ptr(), con.data_ptr(), pts.data_ptr(),
            num.data_ptr(),
            n, w, ph, pp, n_obj, dims[0], dims[1], dims[2], dims[3], d,
            0 if edge_dirs else 1)
    if tiled is None:
        KERNEL.launch(*args, stream_ptr())
    else:
        fn, *setting = tiled
        err = fn(*args, *setting, stream_ptr())
        if err:
            raise RuntimeError(f"contacts_launch_tiled: CUDA error {err}")
    return ref, alt, con, pts, num


def contacts(hh, hp, poses, obj, om, edge_dirs=True):
    """(ref, alt, con, pts, num) of the candidate lanes: the kernel on
    CUDA, the plain version on a CPU tensor. ``edge_dirs`` picks the SAT
    tier (PhysicsConfig.sat_tier == "edge_dirs"), else edge pairs."""
    if poses.device.type == "cpu":
        return contacts_plain(hh, hp, poses, obj, om, edge_dirs)
    return _launch(hh, hp, poses, obj, om, edge_dirs)
