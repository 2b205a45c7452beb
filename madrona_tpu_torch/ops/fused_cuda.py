"""The fused physics step on its hand-written CUDA kernel
(``csrc/fused_step.cu``).

The counterpart of the JAX package's ``ops/physics_megakernel.
make_fused_step`` and of its input pack ``physics/api.
megakernel_fused_step`` (``PhysicsConfig.megakernel_fused``): in one
launch, integrate at the predicted pose, every narrowphase lane
(hull-hull in the config's SAT tier, hull-plane, sphere) and every XPBD
substep on those contacts, which never leave the kernel. It solves over
all rows: the env's ``solver_dynamic_range`` and ``solver_ref_dyn_lanes``
do not apply.

Buffers, worlds-minor as in ``ops/solver_cuda``:

  state [STATE_F, N, W], param [PARAM_F, N, W]  (solver_cuda.pack_state)
  scale [3, N, W]; obj [N, W] int32 object ids
  hh [W, PH, 2], hp [W, PP, 2], sp [W, PS, 2] int32 candidate rows and
  sp_kind [W, PS] int32, as the broadphase leaves them
  je1, je2 [J, W] int32; jnt [JNT_F, J, W]  (solver_cuda.pack_joints)
  out [OUT_F, N, W]

The sphere lanes exist only where the candidate buffers have them: a
sphere cap of 0 means no sphere lane (the JAX package feeds one
all-sentinel lane there because Mosaic refuses empty tiles; a dead lane
changes nothing).

For a CPU tensor :func:`fused_step` runs the plain version
(:func:`fused_step_plain`); for a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ..physics import geo
from ..physics import narrowphase as np_
from ..physics import xpbd
from ..utils import math3d as m3
from . import solver_cuda
from .contacts_cuda import check_tables
from .cuda_build import CudaKernel, check_tensor, entry, stream_ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
KERNEL = CudaKernel(
    "fused_step.cu", "fused_launch", [_P] * 20 + [_I] * 17 + [_F] * 8 + [_P],
)
# fused_launch_tiled's arguments: fused_launch's, then the tile width, the
# warp-lane limit, the threads a block and the blocks an SM of its launch
# bounds, before the stream
TILED_ARGTYPES = KERNEL.argtypes[:-1] + [_I] * 4 + [_P]
# the (threads, blocks an SM) of its launch bounds that fused_launch_tiled
# has; (0, 0) is fused_launch's
VARIANTS = ((256, 1), (256, 2), (128, 2), (128, 3))


def pack_fused(body, om):
    """(state, param, scale [3, N, W], obj [N, W] int32) of a BodyState."""
    state, param = solver_cuda.pack_state(body, om)
    return (state, param, body.scale.permute(2, 1, 0).contiguous(),
            body.obj_id.to(torch.int32).t().contiguous())


def fused_contacts_plain(cfg, state, param, scale, obj, hh, hp, sp,
                         sp_kind, om):
    """The plain version's first half: integrate to the predicted poses,
    the tensor narrowphase there and the manifold reduction -> (ref, alt,
    con, pts, num), the substep solver's contact tables. The predicted
    rotation is renormalized in the kernel's rounding: a resting
    contact's vertex set can turn on one rounding of the predicted pose,
    so kernel and plain version must start the narrowphase from the same
    bits."""
    body, params = solver_cuda.unpack_state(state, param)
    pred = xpbd.integrate(body, None, cfg.dt / cfg.substeps, cfg.gravity,
                          params, normalize=m3.quat_normalize_rcp)
    ref, alt, points, num, normal = np_.narrowphase_lanes(
        pred.pos, pred.rot, scale.permute(2, 1, 0), obj.t(), om, hh, hp,
        sp, sp_kind, sat_dirs=cfg.sat_tier == "edge_dirs",
    )
    return solver_cuda.pack_contacts(xpbd.Contacts(
        ref=ref, alt=alt, points=points, num=num, normal=normal,
        lambda_n=None,
    ))


def fused_step_plain(cfg, state, param, scale, obj, hh, hp, sp, sp_kind, om,
                     je1=None, je2=None, jnt=None):
    """The plain version: :func:`fused_contacts_plain`, then the plain
    substep solver over all rows."""
    cargs = fused_contacts_plain(cfg, state, param, scale, obj, hh, hp, sp,
                                 sp_kind, om)
    spec = dataclasses.replace(cfg, solver_dynamic_range=None,
                               solver_ref_dyn_lanes=0)
    return solver_cuda.substep_solver_plain(spec, state, param, *cargs, je1,
                                            je2, jnt)


def step_floats(cfg):
    """The substep kernel's float arguments, with h * gravity rounded as
    the plain version's integrate rounds it (float32 h times float32
    gravity), so that the predicted poses equal the plain version's bit
    for bit."""
    floats = list(solver_cuda.step_floats(cfg))
    h = np.float32(floats[0])
    floats[1:4] = [float(h * np.float32(g)) for g in cfg.gravity]
    return floats


def tiling(state, hh, hp, sp, om, n_joints=0):
    """(tile width, warp-lane limit, threads a block, blocks an SM) of the
    kernel's default launch on these shapes: a tile whose live hull-hull
    lanes number at most the limit gives each a warp, else each a
    thread."""
    _, n, w = state.shape
    c = hh.shape[1] + hp.shape[1] + sp.shape[1]
    out = [ctypes.c_int() for _ in range(4)]
    fn = entry("fused_step.cu", "fused_tiling",
               [_I] * 10 + [ctypes.POINTER(_I)] * 4)
    err = fn(n, c, n_joints, w, om.hull_pack.shape[0],
             *tuple(om.hull_dims), om.n_edge_dirs,
             *(ctypes.byref(x) for x in out))
    if err:
        raise RuntimeError(f"fused_tiling: CUDA error {err}")
    return tuple(x.value for x in out)


def _launch(cfg, state, param, scale, obj, hh, hp, sp, sp_kind, om,
            je1=None, je2=None, jnt=None, lanes=False, substeps=None,
            tiled=None):
    """The launch. ``substeps``: the kernel's substep count where not
    the config's (0 runs the integrate, the narrowphase and the I/O
    alone: the sweep's split of a step's time). ``tiled``: (the
    ``fused_launch_tiled`` entry, tile width, warp-lane limit, threads a
    block, blocks an SM), called in place of the counted kernel (the
    sweep and the tests)."""
    _, n, w = state.shape
    ph, pp, ps = hh.shape[1], hp.shape[1], sp.shape[1]
    j = 0 if jnt is None else je1.shape[0]
    f32, i32 = torch.float32, torch.int32
    check_tensor(state, "state", f32, (solver_cuda.STATE_F, n, w))
    check_tensor(param, "param", f32, (solver_cuda.PARAM_F, n, w))
    check_tensor(scale, "scale", f32, (3, n, w))
    check_tensor(obj, "obj", i32, (n, w))
    check_tensor(hh, "hh", i32, (w, ph, 2))
    check_tensor(hp, "hp", i32, (w, pp, 2))
    check_tensor(sp, "sp", i32, (w, ps, 2))
    check_tensor(sp_kind, "sp_kind", i32, (w, ps))
    if j:
        check_tensor(je1, "je1", i32, (j, w))
        check_tensor(je2, "je2", i32, (j, w))
        check_tensor(jnt, "jnt", f32, (solver_cuda.JNT_F, j, w))
    n_obj, k = om.hull_pack.shape
    check_tensor(om.hull_pack, "hull_pack", f32, (n_obj, k))
    check_tensor(om.hull_dirs_pack, "hull_dirs_pack", f32,
                 (n_obj, om.hull_dirs_pack.shape[1]))
    check_tables(om)
    radius = om.body_pack[:, 12].contiguous()
    dims = tuple(om.hull_dims)
    out = torch.empty((solver_cuda.OUT_F, n, w), dtype=f32,
                      device=state.device)
    ptr = lambda t: t.data_ptr() if j else 0          # noqa: E731
    c = ph + pp + ps
    tables = [torch.empty(shape, dtype=dt, device=state.device)
              for shape, dt in (((c, w), i32), ((c, w), i32),
                                ((solver_cuda.CON_F, c, w), f32),
                                ((solver_cuda.PTS_F, c, w), f32),
                                ((c, w), i32))] if lanes else []
    args = (
        state.data_ptr(), param.data_ptr(), scale.data_ptr(),
        obj.data_ptr(), hh.data_ptr(), hp.data_ptr(), sp.data_ptr(),
        sp_kind.data_ptr(), om.hull_pack.data_ptr(),
        om.hull_dirs_pack.data_ptr(), radius.data_ptr(), ptr(je1), ptr(je2),
        ptr(jnt), out.data_ptr(),
        *([t.data_ptr() for t in tables] if lanes else [0] * 5),
        n, ph, pp, ps, j, w,
        cfg.substeps if substeps is None else substeps, cfg.jacobi_iters,
        n_obj, dims[0], dims[1], dims[2], dims[3], om.n_edge_dirs,
        0 if cfg.sat_tier == "edge_dirs" else 1, geo.TYPE_PLANE,
        geo.TYPE_HULL, *step_floats(cfg),
    )
    if tiled is None:
        KERNEL.launch(*args, stream_ptr())
    else:
        fn, *setting = tiled
        err = fn(*args, *setting, stream_ptr())
        if err:
            raise RuntimeError(f"fused_launch_tiled: CUDA error {err}")
    return (out, tuple(tables)) if lanes else out


def fused_step(cfg, state, param, scale, obj, hh, hp, sp, sp_kind, om,
               je1=None, je2=None, jnt=None):
    """out [OUT_F, N, W] after one whole physics step of the
    PhysicsConfig ``cfg``: the kernel on CUDA, the plain version on a CPU
    tensor."""
    if state.device.type == "cpu":
        return fused_step_plain(cfg, state, param, scale, obj, hh, hp, sp,
                                sp_kind, om, je1, je2, jnt)
    return _launch(cfg, state, param, scale, obj, hh, hp, sp, sp_kind, om,
                   je1, je2, jnt)


def fused_step_lanes(cfg, state, param, scale, obj, hh, hp, sp, sp_kind, om,
                     je1=None, je2=None, jnt=None):
    """(out, (ref, alt, con, pts, num)): :func:`fused_step` and the
    contact tables its narrowphase computed, for holding the kernel's
    lanes against :func:`fused_contacts_plain`. No step of the physics
    node calls it."""
    if state.device.type == "cpu":
        return (fused_step_plain(cfg, state, param, scale, obj, hh, hp, sp,
                                 sp_kind, om, je1, je2, jnt),
                fused_contacts_plain(cfg, state, param, scale, obj, hh, hp,
                                     sp, sp_kind, om))
    return _launch(cfg, state, param, scale, obj, hh, hp, sp, sp_kind, om,
                   je1, je2, jnt, lanes=True)
