"""Substep solver on its hand-written CUDA kernel (``csrc/solver.cu``).

The counterpart of the JAX package's ``ops/solver_pallas.
make_substep_solver`` and of its input pack ``physics/api.
megakernel_substeps``: every XPBD substep of one step (integrate, Jacobi
contact position solve, joints, velocity derivation, velocity solve) in
one launch, on contacts frozen for the step.

All buffers are worlds-minor, field axes leading:

  state  [STATE_F, N, W]  0:3 pos | 3:7 rot | 7:10 vel | 10:13 omega
  param  [PARAM_F, N, W]  0 inv_m (static-masked) | 1:4 inv_i (masked)
         | 4 mu_s | 5 mu_d | 6 dynamic | 7 moving | 8 static
         | 9:12 ext_force | 12:15 ext_torque | 15 active
         | 16 inv_m raw (integrate) | 17:20 inv_i raw
  ref, alt, num [C, W] int32 (row N = no contact)
  con    [CON_F, C, W]    0:3 normal | 3:6 average point | 6 largest
         penetration | 7 ok
  pts    [PTS_F, C, W]    4 x (xyz, depth)
  je1, je2 [J, W] int32;  jnt [JNT_F, J, W]  0:3 r1 | 3:6 r2
         | 6:10 attach_q1 | 10:14 attach_q2 | 14 separation
         | 15:18 a1_local | 18:21 a2_local | 21 ok | 22 is_fixed
  out    [OUT_F, N, W]    state | 13:16 prev_x | 16:20 prev_q
         | 20:23 presolve_x | 23:27 presolve_q | 27:30 presolve_v
         | 30:33 presolve_w

For a CPU tensor :func:`substep_solver` runs the plain version
(:func:`substep_solver_plain`, the loop of ``physics.xpbd`` and
``physics.joints`` functions); for a CUDA tensor it launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import torch

from ..physics import joints as _joints
from ..physics import xpbd
from ..physics.bodies import (
    RESPONSE_DYNAMIC, RESPONSE_KINEMATIC, RESPONSE_STATIC,
)
from .cuda_build import CudaKernel, check_tensor, stream_ptr

STATE_F = 13
OUT_F = 33
PARAM_F = 20
CON_F = 8
PTS_F = 16
JNT_F = 23

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
KERNEL = CudaKernel(
    "solver.cu", "solver_launch",
    [_P] * 11 + [_I] * 9 + [_F] * 8 + [_P],
)


def _planar(x):
    """[W, R, F] -> [F, R, W] contiguous."""
    return x.permute(2, 1, 0).contiguous()


def pack_state(body, om):
    """(state [STATE_F, N, W], param [PARAM_F, N, W]) of a BodyState."""
    params = om.obj_params(body.obj_id)
    static = body.response == RESPONSE_STATIC
    dynamic = body.response == RESPONSE_DYNAMIC
    moving = (~static) & body.active
    f32 = lambda b: b.to(torch.float32)[..., None]   # noqa: E731
    param = torch.cat([
        torch.where(static, 0.0, params["inv_m"])[..., None],
        torch.where(static[..., None], 0.0, params["inv_i"]),
        params["mu_s"][..., None], params["mu_d"][..., None],
        f32(dynamic), f32(moving), f32(static),
        body.ext_force, body.ext_torque, f32(body.active),
        params["inv_m"][..., None], params["inv_i"],
    ], dim=-1)
    state = torch.cat([body.pos, body.rot, body.vel, body.omega], dim=-1)
    return _planar(state), _planar(param)


def pack_contacts(contacts):
    """(ref, alt, con, pts, num) of a W-major Contacts buffer: the
    reduction of each manifold to its average point, largest penetration
    and ok flag, in the kernel's layout."""
    w, c = contacts.ref.shape
    avg, max_pen, ok = xpbd._reduced(contacts)
    con = torch.cat([
        contacts.normal, avg, max_pen[..., None],
        ok.to(torch.float32)[..., None],
    ], dim=-1)
    t2 = lambda a: a.t().contiguous()                # noqa: E731
    return (t2(contacts.ref), t2(contacts.alt), _planar(con),
            _planar(contacts.points.reshape(w, c, PTS_F)), t2(contacts.num))


def pack_joints(jbuf, n):
    """(je1, je2 [J, W] int32, jnt [JNT_F, J, W]) of a joint buffer."""
    ok = (jbuf.active & (jbuf.e1 >= 0) & (jbuf.e1 < n)
          & (jbuf.e2 >= 0) & (jbuf.e2 < n))
    f32 = lambda b: b.to(torch.float32)[..., None]   # noqa: E731
    jnt = torch.cat([
        jbuf.r1, jbuf.r2, jbuf.attach_q1, jbuf.attach_q2,
        jbuf.separation[..., None], jbuf.a1_local, jbuf.a2_local,
        f32(ok), f32(jbuf.jtype == _joints.JOINT_FIXED),
    ], dim=-1)
    return jbuf.e1.t().contiguous(), jbuf.e2.t().contiguous(), _planar(jnt)


def unpack_out(body, out):
    """The BodyState of an out buffer [OUT_F, N, W]."""
    o = out.permute(2, 1, 0)
    return dataclasses.replace(
        body, pos=o[..., 0:3], rot=o[..., 3:7], vel=o[..., 7:10],
        omega=o[..., 10:13], prev_x=o[..., 13:16], prev_q=o[..., 16:20],
        presolve_x=o[..., 20:23], presolve_q=o[..., 23:27],
        presolve_v=o[..., 27:30], presolve_w=o[..., 30:33],
    )


def unpack_state(state, param):
    """(BodyState, per-body params) of packed state and param buffers, as
    the plain solver reads them; scratch fields zero, no scale or
    object ids."""
    s = state.permute(2, 1, 0)
    p = param.permute(2, 1, 0)
    flag = lambda i: p[..., i] > 0.5                 # noqa: E731
    response = torch.where(
        flag(8), RESPONSE_STATIC,
        torch.where(flag(6), RESPONSE_DYNAMIC, RESPONSE_KINEMATIC),
    ).to(torch.int32)
    z3 = torch.zeros_like(s[..., 0:3])
    z4 = torch.zeros_like(s[..., 3:7])
    body = xpbd.BodyState(
        pos=s[..., 0:3], rot=s[..., 3:7], scale=None, vel=s[..., 7:10],
        omega=s[..., 10:13], obj_id=None, response=response,
        ext_force=p[..., 9:12], ext_torque=p[..., 12:15],
        prev_x=z3, prev_q=z4, presolve_x=z3, presolve_q=z4,
        presolve_v=z3, presolve_w=z3, active=flag(15),
    )
    params = dict(inv_m=p[..., 16], inv_i=p[..., 17:20],
                  mu_s=p[..., 4], mu_d=p[..., 5])
    return body, params


def substep_solver_plain(cfg, state, param, ref, alt, con, pts, num,
                         je1=None, je2=None, jnt=None):
    """The plain version: the same buffers through the tensor solver.
    ``cfg`` is the step's PhysicsConfig."""
    h = cfg.dt / cfg.substeps
    body, params = unpack_state(state, param)
    w = state.shape[2]
    c = con.permute(2, 1, 0)
    contacts = xpbd.Contacts(
        ref=ref.t(), alt=alt.t(), num=num.t(), normal=c[..., 0:3],
        points=pts.permute(2, 1, 0).reshape(w, -1, 4, 4),
        lambda_n=torch.zeros_like(c[..., 6]),
    )
    reduced = (c[..., 3:6], c[..., 6], c[..., 7] > 0.5)
    jbuf = None
    if jnt is not None:
        j = jnt.permute(2, 1, 0)
        fixed = j[..., 22] > 0.5
        jbuf = _joints.Joints(
            e1=je1.t(), e2=je2.t(),
            jtype=torch.where(fixed, _joints.JOINT_FIXED,
                              _joints.JOINT_HINGE).to(torch.int32),
            r1=j[..., 0:3], r2=j[..., 3:6], attach_q1=j[..., 6:10],
            attach_q2=j[..., 10:14], separation=j[..., 14],
            a1_local=j[..., 15:18], a2_local=j[..., 18:21],
            active=j[..., 21] > 0.5,
        )
    for _ in range(cfg.substeps):
        body = xpbd.integrate(body, None, h, cfg.gravity, params)
        body, contacts = xpbd.solve_positions_jacobi(
            body, contacts, None, cfg.jacobi_iters, params, reduced
        )
        if jbuf is not None:
            body = _joints.solve_joints_jacobi(body, jbuf, None, params)
        body = xpbd.set_velocities(body, h)
        body = xpbd.solve_velocities_jacobi(
            body, contacts, None, h, cfg.restitution,
            cfg.restitution_threshold, params, reduced,
        )
    return _planar(torch.cat([
        body.pos, body.rot, body.vel, body.omega, body.prev_x, body.prev_q,
        body.presolve_x, body.presolve_q, body.presolve_v, body.presolve_w,
    ], dim=-1))


def step_floats(cfg):
    """The float arguments of a substep kernel: h, h * gravity (3),
    h / 2, 2 / h, restitution and its threshold."""
    h = cfg.dt / cfg.substeps
    g = [float(x) for x in cfg.gravity]
    return (h, h * g[0], h * g[1], h * g[2], 0.5 * h, 2.0 / h,
            float(cfg.restitution), float(cfg.restitution_threshold))


def _launch(cfg, state, param, ref, alt, con, pts, num, je1, je2, jnt):
    _, n, w = state.shape
    c = ref.shape[0]
    j = 0 if jnt is None else je1.shape[0]
    f32, i32 = torch.float32, torch.int32
    check_tensor(state, "state", f32, (STATE_F, n, w))
    check_tensor(param, "param", f32, (PARAM_F, n, w))
    check_tensor(ref, "ref", i32, (c, w))
    check_tensor(alt, "alt", i32, (c, w))
    check_tensor(con, "con", f32, (CON_F, c, w))
    check_tensor(pts, "pts", f32, (PTS_F, c, w))
    check_tensor(num, "num", i32, (c, w))
    if j:
        check_tensor(je1, "je1", i32, (j, w))
        check_tensor(je2, "je2", i32, (j, w))
        check_tensor(jnt, "jnt", f32, (JNT_F, j, w))
    # only rows in [d0, d1) can move; every other row is static
    d0, d1 = cfg.solver_dynamic_range or (0, n)
    if not 0 <= d0 < d1 <= n:
        raise ValueError(
            f"bad solver_dynamic_range {cfg.solver_dynamic_range} for N={n}"
        )
    # contact lanes >= ref_live have a static ref row: a promise that only
    # means something under the dynamic range
    ref_live = cfg.solver_ref_dyn_lanes if cfg.solver_dynamic_range else 0
    out = torch.empty((OUT_F, n, w), dtype=f32, device=state.device)
    ptr = lambda t: 0 if t is None else t.data_ptr()   # noqa: E731
    KERNEL.launch(
        state.data_ptr(), param.data_ptr(), ref.data_ptr(), alt.data_ptr(),
        con.data_ptr(), pts.data_ptr(), num.data_ptr(),
        ptr(je1 if j else None), ptr(je2 if j else None),
        ptr(jnt if j else None), out.data_ptr(),
        n, c, j, w, cfg.substeps, cfg.jacobi_iters, d0, d1,
        ref_live or c, *step_floats(cfg), stream_ptr(),
    )
    return out


def substep_solver(cfg, state, param, ref, alt, con, pts, num,
                   je1=None, je2=None, jnt=None):
    """out [OUT_F, N, W] after ``cfg.substeps`` substeps of the step's
    PhysicsConfig: the kernel on CUDA, the plain version on a CPU
    tensor."""
    if state.device.type == "cpu":
        return substep_solver_plain(cfg, state, param, ref, alt, con, pts,
                                    num, je1, je2, jnt)
    return _launch(cfg, state, param, ref, alt, con, pts, num,
                   je1, je2, jnt)
