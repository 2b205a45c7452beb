"""XPBD rigid-body solver: substepped position-based dynamics.

Port of ``madrona_tpu/physics/xpbd.py`` (the reference's
``src/physics/xpbd.cpp`` math): integrate, set_velocities, and the
contact solves in both of the JAX package's orders.

  * Jacobi (``solver="jacobi"``): every contact is solved against a
    snapshot of the body state and the per-body corrections are
    averaged. Per-contact body reads are index gathers of one packed
    block. The averaged scatter is a batched product with a 0/1
    incidence matrix: its summation order is fixed, so a step is
    bit-reproducible on the card, which a float ``scatter_add_``
    (atomics) would not be.
  * Gauss-Seidel (``solver="gauss_seidel"``, the oracle):
    :func:`solve_positions` and :func:`solve_velocities` walk the C
    contact slots in slot order, each slot one [W]-wide step over all
    worlds, as the JAX package's ``fori_loop`` does and the reference's
    serial per-world solve does. Each slot reads the bodies as the slots
    before it left them.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from ..utils import math3d as m3
from .bodies import RESPONSE_DYNAMIC, RESPONSE_STATIC


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    """The physics step's settings: the JAX package's fields that change
    results. Three of its fields only lay out the TPU kernels' VMEM tiles
    and have no counterpart here: ``narrowphase_pair_tile``,
    ``narrowphase_tile_w`` and ``fused_pair_chunk`` (the JAX package's own
    tests show the output does not change with them), nor do its VMEM and
    tile knobs (``megakernel_tile``, ``megakernel_loop``,
    ``megakernel_vmem_mb``, ``narrowphase_vmem_mb``)."""

    dt: float = 1.0 / 30.0
    substeps: int = 4
    gravity: tuple = (0.0, 0.0, -9.8)
    restitution: float = 0.3        # the reference hardcodes e=0.3
    restitution_threshold: float = 0.2
    jacobi_iters: int = 2           # Jacobi position iterations per substep
    # "xla": contacts from the plain tensor narrowphase (the name is the
    # JAX package's). "kernel_mega": hull-hull SAT, the hull-plane lane
    # and the manifold reduction on the contacts kernel
    # (ops/contacts_cuda; the JAX package's "pallas_mega"), feeding the
    # substep-solver kernel without a W-major Contacts buffer.
    # "kernel_sublane" and "kernel" (the JAX package's "pallas_sublane"
    # and "pallas"): the hull-hull lane on the hull-hull record kernel
    # (ops/hh_narrowphase_cuda), the hull-plane and sphere lanes in plain
    # tensor ops; "kernel" always sweeps edge pairs, "kernel_sublane"
    # follows sat_tier (one CUDA kernel serves both). The JAX names are
    # accepted and resolved to the port's in __post_init__
    narrowphase: str = "xla"
    # True: contacts generated once per step at the first substep's
    # predicted poses and reused across substeps
    narrowphase_once: bool = False
    # True: every substep of a step in one call of the substep-solver
    # kernel (ops/solver_cuda); needs narrowphase_once
    megakernel: bool = False
    # env layout contracts read by the substep-solver kernel; validated
    # at setup (see api.make_physics_node). The fused step ignores them.
    solver_dynamic_range: Optional[tuple] = None
    solver_ref_dyn_lanes: int = 0
    # the hull-hull SAT's edge-edge axes: "edge_dirs" (unique edge
    # direction pairs, support separation, faces preferred within 1e-5)
    # or "edge_pairs" (every edge pair with the Gauss-map test, the
    # reference's sweep)
    sat_tier: str = "edge_dirs"
    # True: the whole step (predicted-pose integrate, every narrowphase
    # lane, every substep) in one call of the fused-step kernel
    # (ops/fused_cuda); needs narrowphase_once and supersedes
    # narrowphase and megakernel
    megakernel_fused: bool = False
    # "kernel": the all-pairs broadphase on its hand-written CUDA kernel
    # (ops/broadphase_cuda; up to 64 bodies a world); on a CPU tensor the
    # wrapper runs the plain version. The JAX package's names "pallas"
    # and "all_pairs" (its default) name this tier too (its candidates
    # equal the plain all-pairs tier's bit for bit). "swept": sort-by-x sweep and prune,
    # the many-body tier (broadphase.find_candidates_swept, plain
    # PyTorch: the JAX package runs it in XLA), exact while no world
    # saturates its window of broadphase_window later bodies
    # (Candidates.overflow reports it)
    broadphase: str = "kernel"
    broadphase_window: int = 32
    # "jacobi": every contact solved against a body snapshot and the
    # corrections averaged. "gauss_seidel": the slot-order serial solve
    # (solve_positions / solve_velocities, the oracle). "tgs": the
    # velocity-level soft-contact solver of physics/tgs.py
    solver: str = "jacobi"

    def __post_init__(self):
        # a config written for the JAX package runs unchanged
        for field, names in (("narrowphase", JAX_NARROWPHASES),
                             ("broadphase", JAX_BROADPHASES)):
            name = getattr(self, field)
            if name in names:
                object.__setattr__(self, field, names[name])


# the JAX package's tier names -> the port's
JAX_NARROWPHASES = {"pallas_mega": "kernel_mega",
                    "pallas_sublane": "kernel_sublane", "pallas": "kernel"}
JAX_BROADPHASES = {"pallas": "kernel", "all_pairs": "kernel"}


@dataclasses.dataclass
class BodyState:
    """All rigid bodies of all worlds: [W, N, ...] tensors."""

    pos: torch.Tensor          # [W, N, 3]
    rot: torch.Tensor          # [W, N, 4] (w, x, y, z)
    scale: torch.Tensor        # [W, N, 3]
    vel: torch.Tensor          # [W, N, 3]
    omega: torch.Tensor        # [W, N, 3]
    obj_id: torch.Tensor       # [W, N] int32
    response: torch.Tensor     # [W, N] int32
    ext_force: torch.Tensor    # [W, N, 3]
    ext_torque: torch.Tensor   # [W, N, 3]
    prev_x: torch.Tensor
    prev_q: torch.Tensor
    presolve_x: torch.Tensor
    presolve_q: torch.Tensor
    presolve_v: torch.Tensor
    presolve_w: torch.Tensor
    active: torch.Tensor       # [W, N] bool — row liveness


@dataclasses.dataclass
class Contacts:
    """Fixed-capacity per-world contact buffer: [W, C, ...]."""

    ref: torch.Tensor        # [W, C] int32 body row (N = invalid sentinel)
    alt: torch.Tensor        # [W, C] int32
    points: torch.Tensor     # [W, C, 4, 4] (xyz on the ref surface, depth)
    num: torch.Tensor        # [W, C] int32 (0 = inactive)
    normal: torch.Tensor     # [W, C, 3] ref -> other
    lambda_n: torch.Tensor   # [W, C] accumulated normal impulse


@functools.lru_cache(maxsize=None)
def const_f32(values: tuple, device) -> torch.Tensor:
    """A small float32 constant on ``device``, built once and reused: a
    fresh ``torch.tensor`` per call is a pageable host-to-device copy
    that stalls the host on the card."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def integrate(body: BodyState, om, h: float, gravity, params=None,
              normalize=m3.quat_normalize) -> BodyState:
    """substepRigidBodies: save the previous pose, apply gravity and the
    external force, integrate velocity -> position, the gyroscopic omega
    update and the quaternion update (xpbd.cpp:98-185). ``normalize``
    renormalizes the updated rotation (``m3.quat_normalize_rcp`` rounds as
    the CUDA kernels do)."""
    g = const_f32(tuple(gravity), body.pos.device)
    params = params if params is not None else om.obj_params(body.obj_id)
    inv_m = params["inv_m"]
    inv_i = params["inv_i"]
    dynamic = body.response == RESPONSE_DYNAMIC
    static = body.response == RESPONSE_STATIC
    moving = (~static) & body.active
    mv = moving[..., None]

    v = body.vel + torch.where(dynamic[..., None], h * g, 0.0)
    v = v + h * inv_m[..., None] * body.ext_force
    x = body.pos + h * v

    inertia = torch.where(
        inv_i == 0.0, 0.0, 1.0 / torch.where(inv_i == 0, 1.0, inv_i)
    )
    q_inv = m3.quat_inv(body.rot)
    tau_local = m3.quat_rotate(q_inv, body.ext_torque)
    w_local = m3.quat_rotate(q_inv, body.omega)
    i_w_local = inertia * w_local
    w_local = w_local + h * inv_i * (
        tau_local - m3.cross(w_local, i_w_local)
    )
    omega = m3.quat_rotate(body.rot, w_local)

    # q += fromAngularVec(0.5*h*omega) * q; normalize
    q = normalize(body.rot + m3.quat_mul(_pure(0.5 * h * omega), body.rot))

    x = torch.where(mv, x, body.pos)
    q = torch.where(mv, q, body.rot)
    v_out = torch.where(mv, v, 0.0)
    w_out = torch.where(mv, omega, 0.0)
    st = static[..., None]
    return dataclasses.replace(
        body, pos=x, rot=q,
        vel=torch.where(st, body.vel, v_out),
        omega=torch.where(st, body.omega, w_out),
        prev_x=body.pos, prev_q=body.rot,
        presolve_x=x, presolve_q=q, presolve_v=v_out, presolve_w=w_out,
    )


def _generalized_inv_mass(torque_axis, rot_axis, inv_m):
    return inv_m + m3.dot(torque_axis, rot_axis)


def _pure(v):
    return torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)


def _apply_positional_update(x1, x2, q1, q2, r1, r2, inv_m1, inv_m2,
                             inv_i1, inv_i2, n_world, c, alpha_tilde):
    """applyPositionalUpdate (xpbd.cpp:254-307): updated
    (x1, x2, q1, q2, lambda)."""
    n_l1 = m3.quat_rotate(m3.quat_inv(q1), n_world)
    n_l2 = m3.quat_rotate(m3.quat_inv(q2), n_world)
    t_axis1 = m3.cross(r1, n_l1)
    t_axis2 = m3.cross(r2, n_l2)
    rot_axis1 = inv_i1 * t_axis1
    rot_axis2 = inv_i2 * t_axis2
    w1 = _generalized_inv_mass(t_axis1, rot_axis1, inv_m1)
    w2 = _generalized_inv_mass(t_axis2, rot_axis2, inv_m2)
    # two immovable bodies (all inverse masses 0) would divide 0/0
    denom = w1 + w2 + alpha_tilde
    pos_d = denom > 0
    lam = torch.where(pos_d, -c / torch.where(pos_d, denom, 1.0), 0.0)

    x1 = x1 + (lam * inv_m1)[..., None] * n_world
    x2 = x2 - (lam * inv_m2)[..., None] * n_world
    half = 0.5 * lam
    dq1 = m3.quat_rotate(q1, half[..., None] * rot_axis1)
    dq2 = m3.quat_rotate(q2, half[..., None] * rot_axis2)
    q1 = m3.quat_normalize(q1 + m3.quat_mul(_pure(dq1), q1))
    q2 = m3.quat_normalize(q2 - m3.quat_mul(_pure(dq2), q2))
    return x1, x2, q1, q2, lam


def _solve_contact(x1, x2, q1, q2, prev_x1, prev_q1, prev_x2, prev_q2,
                   inv_m1, inv_m2, inv_i1, inv_i2, r1, r2, n_world,
                   avg_mu_s):
    """handleContactConstraint (xpbd.cpp:322-421): normal positional
    correction, then static friction. Returns (x1, x2, q1, q2, lam_n)."""
    p1 = m3.quat_rotate(q1, r1) + x1
    p2 = m3.quat_rotate(q2, r2) + x2
    d = m3.dot(p1 - p2, n_world)
    pen = d > 0.0
    pv = pen[..., None]

    nx1, nx2, nq1, nq2, lam_n = _apply_positional_update(
        x1, x2, q1, q2, r1, r2, inv_m1, inv_m2, inv_i1, inv_i2,
        n_world, d, 0.0,
    )
    x1 = torch.where(pv, nx1, x1)
    x2 = torch.where(pv, nx2, x2)
    q1 = torch.where(pv, nq1, q1)
    q2 = torch.where(pv, nq2, q2)
    lam_n = torch.where(pen, lam_n, 0.0)

    # static friction (only where the normal correction fired)
    p1_hat = m3.quat_rotate(prev_q1, r1) + prev_x1
    p2_hat = m3.quat_rotate(prev_q2, r2) + prev_x2
    p1 = m3.quat_rotate(q1, r1) + x1
    p2 = m3.quat_rotate(q2, r2) + x2
    delta_p = (p1 - p1_hat) - (p2 - p2_hat)
    delta_p_t = delta_p - m3.dot(delta_p, n_world)[..., None] * n_world
    t_mag = torch.sqrt(torch.clamp(m3.dot(delta_p_t, delta_p_t), min=1e-30))
    t_world = delta_p_t / t_mag[..., None]

    t_l1 = m3.quat_rotate(m3.quat_inv(q1), t_world)
    t_l2 = m3.quat_rotate(m3.quat_inv(q2), t_world)
    ft_axis1 = m3.cross(r1, t_l1)
    ft_axis2 = m3.cross(r2, t_l2)
    fr_axis1 = inv_i1 * ft_axis1
    fr_axis2 = inv_i2 * ft_axis2
    w1 = _generalized_inv_mass(ft_axis1, fr_axis1, inv_m1)
    w2 = _generalized_inv_mass(ft_axis2, fr_axis2, inv_m2)
    den_t = w1 + w2
    pos_t = den_t > 0
    lam_t = torch.where(pos_t, -t_mag / torch.where(pos_t, den_t, 1.0), 0.0)
    # apply when lambda_t > lambda_n * mu_s (both negative)
    fric = (pen & (t_mag > 0.0) & (lam_t > lam_n * avg_mu_s))[..., None]
    fx1 = x1 + lam_t[..., None] * inv_m1[..., None] * t_world
    fx2 = x2 - lam_t[..., None] * inv_m2[..., None] * t_world
    half = 0.5 * lam_t
    dq1 = m3.quat_rotate(q1, half[..., None] * fr_axis1)
    dq2 = m3.quat_rotate(q2, half[..., None] * fr_axis2)
    fq1 = m3.quat_normalize(q1 + m3.quat_mul(_pure(dq1), q1))
    fq2 = m3.quat_normalize(q2 - m3.quat_mul(_pure(dq2), q2))
    return (
        torch.where(fric, fx1, x1), torch.where(fric, fx2, x2),
        torch.where(fric, fq1, q1), torch.where(fric, fq2, q2), lam_n,
    )


def _local_contacts(b1, b2, avg_pt, depth, normal):
    """getLocalSpaceContacts (xpbd.cpp:424-441): contact points in each
    body's presolve local frame."""
    contact2 = avg_pt - normal * depth[..., None]
    r1 = m3.quat_rotate(m3.quat_inv(b1["presolve_q"]),
                        avg_pt - b1["presolve_x"])
    r2 = m3.quat_rotate(m3.quat_inv(b2["presolve_q"]),
                        contact2 - b2["presolve_x"])
    return r1, r2


def set_velocities(body: BodyState, h: float) -> BodyState:
    """setVelocities (xpbd.cpp:738-779): velocity from the substep delta."""
    v = (body.pos - body.prev_x) / h
    delta_q = m3.quat_mul(body.rot, m3.quat_inv(body.prev_q))
    same = torch.all(body.rot == body.prev_q, dim=-1)
    new_omega = (2.0 / h) * delta_q[..., 1:4]
    new_omega = torch.where(delta_q[..., 0:1] > 0.0, new_omega, -new_omega)
    new_omega = torch.where(same[..., None], 0.0, new_omega)
    static = body.response == RESPONSE_STATIC
    keep = (static | ~body.active)[..., None]
    return dataclasses.replace(
        body,
        vel=torch.where(keep, body.vel, v),
        omega=torch.where(keep, body.omega, new_omega),
    )


# Packed body block: every float field a contact gather needs, so one
# gather per side fetches them all.
_PACK_SLOTS = (
    ("x", 3), ("q", 4), ("prev_x", 3), ("prev_q", 4),
    ("presolve_x", 3), ("presolve_q", 4), ("presolve_v", 3),
    ("presolve_w", 3), ("v", 3), ("w", 3),
    ("inv_m", 1), ("inv_i", 3), ("mu_s", 1), ("mu_d", 1),
)
def pack_bodies(body: BodyState, om, params=None):
    """[W, N, 39] solver view of the body state (_PACK_SLOTS order)."""
    params = params if params is not None else om.obj_params(body.obj_id)
    static = body.response == RESPONSE_STATIC
    inv_m = torch.where(static, 0.0, params["inv_m"])
    inv_i = torch.where(static[..., None], 0.0, params["inv_i"])
    parts = dict(
        x=body.pos, q=body.rot, prev_x=body.prev_x, prev_q=body.prev_q,
        presolve_x=body.presolve_x, presolve_q=body.presolve_q,
        presolve_v=body.presolve_v, presolve_w=body.presolve_w,
        v=body.vel, w=body.omega,
        inv_m=inv_m[..., None], inv_i=inv_i,
        mu_s=params["mu_s"][..., None], mu_d=params["mu_d"][..., None],
    )
    return torch.cat([parts[k] for k, _ in _PACK_SLOTS], dim=-1)


def _unpack(block):
    out = {}
    off = 0
    for name, d in _PACK_SLOTS:
        v = block[..., off:off + d]
        out[name] = v[..., 0] if d == 1 else v
        off += d
    return out


def gather_rows(table, rows):
    """table [W, N, ...] at rows [W, K] -> [W, K, ...]. Rows are clamped
    into [0, N): sentinel rows (N) read row N-1, and their lanes are
    masked by the caller, as in the JAX package."""
    n = table.shape[1]
    w = table.shape[0]
    r = rows.long().clamp(0, n - 1)
    widx = torch.arange(w, device=table.device)[:, None]
    return table[widx, r]


def _gather_packed(packed, rows):
    return _unpack(gather_rows(packed, rows))


def _scatter_avg_packed(rows, deltas, ok, n):
    """Mean of deltas [W, C, D] per body row [W, C] -> [W, N, D]; masked
    lanes contribute nothing. A batched product with the 0/1 incidence
    matrix (fixed summation order: bit-reproducible)."""
    inc = (
        (rows[..., None].long()
         == torch.arange(n, device=rows.device)) & ok[..., None]
    ).to(deltas.dtype)                                      # [W, C, N]
    payload = torch.cat(
        [torch.where(ok[..., None], deltas, 0.0),
         torch.ones_like(deltas[..., :1])], dim=-1,
    )
    acc = torch.bmm(inc.transpose(1, 2), payload)           # [W, N, D+1]
    dd = deltas.shape[-1]
    cnt = torch.clamp(acc[..., dd:], min=1.0)
    return acc[..., :dd] / cnt


def _avg_contacts_batch(points, num):
    """Penetration-weighted average point, max depth and zero-total flag
    over [W, C, 4, 4] (getAvgContact, xpbd.cpp:420-448)."""
    live = torch.arange(4, device=points.device) < num[..., None]
    wgt = torch.where(live, points[..., 3], 0.0)
    total = m3.sum_in_order(wgt)
    zero = total == 0.0
    avg = m3.sum_in_order(
        (wgt / torch.where(zero, 1.0, total)[..., None])[..., None]
        * points[..., :3], dim=-2)
    max_pen = torch.where(live, points[..., 3], -3e38).amax(dim=-1)
    return avg, max_pen, zero


def _reduced(contacts: Contacts):
    """(average point, largest penetration, ok) of each manifold."""
    avg, max_pen, zero = _avg_contacts_batch(contacts.points, contacts.num)
    return avg, max_pen, (contacts.num > 0) & (~zero)


def solve_positions_jacobi(body: BodyState, contacts: Contacts, om,
                           iters: int = 2, params=None, reduced=None):
    """Vectorized position solve: every contact at once, averaged.
    ``reduced``: the manifolds' (average point, largest penetration, ok)
    where the caller already holds them."""
    ref, alt = contacts.ref, contacts.alt
    avg, max_pen, ok = reduced if reduced is not None else _reduced(contacts)
    nrm = contacts.normal
    lam_total = torch.zeros_like(contacts.lambda_n)
    n = body.pos.shape[1]
    static = (body.response == RESPONSE_STATIC)[..., None]
    rows2 = torch.cat([ref, alt], dim=1)
    ok2 = torch.cat([ok, ok], dim=1)

    for _ in range(iters):
        packed = pack_bodies(body, om, params)
        b1 = _gather_packed(packed, ref)
        b2 = _gather_packed(packed, alt)
        r1, r2 = _local_contacts(b1, b2, avg, max_pen, nrm)
        avg_mu_s = 0.5 * (b1["mu_s"] + b2["mu_s"])
        x1, x2, q1, q2, lam_n = _solve_contact(
            b1["x"], b2["x"], b1["q"], b2["q"],
            b1["prev_x"], b1["prev_q"], b2["prev_x"], b2["prev_q"],
            b1["inv_m"], b2["inv_m"], b1["inv_i"], b2["inv_i"],
            r1, r2, nrm, avg_mu_s,
        )
        lam_total = lam_total + torch.where(ok, lam_n, 0.0)
        d1 = torch.cat([x1 - b1["x"], q1 - b1["q"]], dim=-1)
        d2 = torch.cat([x2 - b2["x"], q2 - b2["q"]], dim=-1)
        mean = _scatter_avg_packed(
            rows2, torch.cat([d1, d2], dim=1), ok2, n
        )
        # static rows are exactly invariant (no delta, no renormalize)
        pos = torch.where(static, body.pos, body.pos + mean[..., :3])
        rot = torch.where(
            static, body.rot, m3.quat_normalize(body.rot + mean[..., 3:7])
        )
        body = dataclasses.replace(body, pos=pos, rot=rot)

    return body, dataclasses.replace(contacts, lambda_n=lam_total)


def solve_velocities_jacobi(body: BodyState, contacts: Contacts, om,
                            h: float, restitution: float,
                            restitution_threshold: float, params=None,
                            reduced=None) -> BodyState:
    """Vectorized velocity solve: restitution on the averaged contact,
    then dynamic friction per manifold point, averaged per body."""
    ref, alt = contacts.ref, contacts.alt
    num = contacts.num
    pts = contacts.points
    nrm = contacts.normal
    lam_n = contacts.lambda_n
    n = body.pos.shape[1]

    packed = pack_bodies(body, om, params)
    b1 = _gather_packed(packed, ref)
    b2 = _gather_packed(packed, alt)
    mu_d = 0.5 * (b1["mu_d"] + b2["mu_d"])

    avg, max_pen, ok = reduced if reduced is not None else _reduced(contacts)

    r1, r2 = _local_contacts(b1, b2, avg, max_pen, nrm)
    r1_pre = m3.quat_rotate(b1["presolve_q"], r1)
    r2_pre = m3.quat_rotate(b2["presolve_q"], r2)
    v_bar = (
        b1["presolve_v"] + m3.cross(b1["presolve_w"], r1_pre)
    ) - (b2["presolve_v"] + m3.cross(b2["presolve_w"], r2_pre))
    vn_bar = m3.dot(nrm, v_bar)

    v1, w1 = b1["v"], b1["w"]
    v2, w2 = b2["v"], b2["w"]
    q1, q2 = b1["q"], b2["q"]

    # restitution on the averaged contact
    r1_world = m3.quat_rotate(q1, r1)
    r2_world = m3.quat_rotate(q2, r2)
    rt_axis1 = m3.cross(r1, m3.quat_rotate(m3.quat_inv(q1), nrm))
    rt_axis2 = m3.cross(r2, m3.quat_rotate(m3.quat_inv(q2), nrm))
    v_now = (v1 + m3.cross(w1, r1_world)) - (v2 + m3.cross(w2, r2_world))
    vn = m3.dot(nrm, v_now)
    e = torch.where(torch.abs(vn_bar) <= restitution_threshold, 0.0,
                    restitution)
    rest_mag = torch.clamp(-e * vn_bar, max=0.0) - vn
    rr_axis1 = b1["inv_i"] * rt_axis1
    rr_axis2 = b2["inv_i"] * rt_axis2
    gw1 = _generalized_inv_mass(rt_axis1, rr_axis1, b1["inv_m"])
    gw2 = _generalized_inv_mass(rt_axis2, rr_axis2, b2["inv_m"])
    den_r = gw1 + gw2
    imp = torch.where(
        ok & (den_r > 0),
        rest_mag / torch.where(den_r > 0, den_r, 1.0), 0.0,
    )
    dv1 = nrm * (imp * b1["inv_m"])[..., None]
    dv2 = -nrm * (imp * b2["inv_m"])[..., None]
    dw1 = m3.quat_rotate(q1, imp[..., None] * rr_axis1)
    dw2 = -m3.quat_rotate(q2, imp[..., None] * rr_axis2)

    # dynamic friction per manifold point (vectorized over the 4 points)
    pen = pts[..., 3]                                     # [W, C, 4]
    live_pt = torch.arange(4, device=pts.device) < num[..., None]
    pen_sum = torch.where(live_pt, pen, 0.0).sum(dim=-1)
    has_pen = pen_sum > 0.0

    cp = pts[..., :3]                                     # [W, C, 4, 3]
    n4 = nrm[..., None, :]

    def expand(v):
        return v[..., None, :] if v.dim() == 3 else v[..., None]

    keys = ("presolve_x", "presolve_q", "inv_m", "inv_i", "q")
    b1e = {k: expand(b1[k]) for k in keys}
    b2e = {k: expand(b2[k]) for k in keys}
    rr1, rr2 = _local_contacts(b1e, b2e, cp, pen, n4)
    rw1 = m3.quat_rotate(b1e["q"], rr1)
    rw2 = m3.quat_rotate(b2e["q"], rr2)
    lam_pt = lam_n[..., None] * (
        pen / torch.where(has_pen, pen_sum, 1.0)[..., None]
    )

    v_rel = (
        v1[..., None, :] + m3.cross(w1[..., None, :] + dw1[..., None, :], rw1)
    ) - (
        v2[..., None, :] + m3.cross(w2[..., None, :] + dw2[..., None, :], rw2)
    )
    # include the restitution delta on linear velocity too
    v_rel = v_rel + (dv1 - dv2)[..., None, :]
    vn_f = m3.dot(n4, v_rel)
    vt = v_rel - n4 * vn_f[..., None]
    vt_len = torch.sqrt(torch.clamp(m3.dot(vt, vt), min=1e-30))
    has_t = vt_len > 1e-15
    t_dir = vt / vt_len[..., None]
    t_l1 = m3.quat_rotate(m3.quat_inv(b1e["q"]), t_dir)
    t_l2 = m3.quat_rotate(m3.quat_inv(b2e["q"]), t_dir)
    fta1 = m3.cross(rr1, t_l1)
    fta2 = m3.cross(rr2, t_l2)
    fra1 = b1e["inv_i"] * fta1
    fra2 = b2e["inv_i"] * fta2
    fw1 = _generalized_inv_mass(fta1, fra1, b1e["inv_m"])
    fw2 = _generalized_inv_mass(fta2, fra2, b2e["inv_m"])
    den_f = fw1 + fw2
    inv_scale = torch.where(
        den_f > 0, 1.0 / torch.where(den_f > 0, den_f, 1.0), 0.0
    )
    # inv_scale appears twice on purpose: the reference deviates from
    # the XPBD paper here (xpbd.cpp:834-836)
    dyn_mag = mu_d[..., None] * torch.abs(lam_pt) * inv_scale / h
    corrected = -torch.minimum(dyn_mag, vt_len)
    f_imp = torch.where(
        ok[..., None] & live_pt & has_pen[..., None] & has_t,
        corrected * inv_scale, 0.0,
    )
    fdv1 = (t_dir * (f_imp * b1e["inv_m"])[..., None]).sum(dim=-2)
    fdv2 = -(t_dir * (f_imp * b2e["inv_m"])[..., None]).sum(dim=-2)
    fdw1 = m3.quat_rotate(b1e["q"], f_imp[..., None] * fra1).sum(dim=-2)
    fdw2 = -m3.quat_rotate(b2e["q"], f_imp[..., None] * fra2).sum(dim=-2)

    rows2 = torch.cat([ref, alt], dim=1)
    ok2 = torch.cat([ok, ok], dim=1)
    d1 = torch.cat([dv1 + fdv1, dw1 + fdw1], dim=-1)
    d2 = torch.cat([dv2 + fdv2, dw2 + fdw2], dim=-1)
    mean = _scatter_avg_packed(rows2, torch.cat([d1, d2], dim=1), ok2, n)
    return dataclasses.replace(
        body, vel=body.vel + mean[..., :3], omega=body.omega + mean[..., 3:6]
    )


# ---------------------------------------------------------------------------
# The Gauss-Seidel oracle: one contact slot at a time, in slot order.
#
# A slot reads the bodies as the slots before it left them; only the
# poses change in the position pass and only the velocities in the
# velocity pass, so everything else a slot reads (previous and presolve
# state, object parameters, the manifold's reduction and local anchors)
# is computed for all slots before the loop. Inside it, the two bodies
# of a contact are one [2, W, ...] batch (ref first): each operation on
# the pair is one launch, and the ref's update adds what the alt's
# subtracts, as the JAX package writes them.


def _gather_pair(body: BodyState, om, row1, row2):
    """The solver's views of two bodies per world, rows [W] (clamped into
    [0, N); the caller masks sentinel rows)."""
    both = _unpack(gather_rows(pack_bodies(body, om),
                               torch.stack([row1, row2], dim=1)))
    return ({k: v[:, 0] for k, v in both.items()},
            {k: v[:, 1] for k, v in both.items()})


def _row_mask(body: BodyState, row, ok):
    """[W, N, 1] bool: the body ``row`` [W] of each world where ``ok``.
    A row outside [0, N) selects nothing (the JAX scatter drops it)."""
    n = body.pos.shape[1]
    hit = torch.arange(n, device=row.device) == row.long()[:, None]
    return (hit & ok[:, None])[..., None]


def _scatter_pose(body: BodyState, row, x, q, ok):
    sel = _row_mask(body, row, ok)
    return dataclasses.replace(
        body, pos=torch.where(sel, x[:, None, :], body.pos),
        rot=torch.where(sel, q[:, None, :], body.rot),
    )


def _scatter_vel(body: BodyState, row, v, omg, ok):
    sel = _row_mask(body, row, ok)
    return dataclasses.replace(
        body, vel=torch.where(sel, v[:, None, :], body.vel),
        omega=torch.where(sel, omg[:, None, :], body.omega),
    )


def _slot_views(body: BodyState, contacts: Contacts, om):
    """What every slot of a Gauss-Seidel pass reads that the pass does
    not change: both bodies' solver views [2, W, C, ...] (ref first; their
    x, q, v and w as at the start of the pass), the manifolds' ok [W, C]
    and the anchors r [2, W, C, 3] of their average points in each body's
    presolve frame."""
    packed = pack_bodies(body, om)
    b1 = _gather_packed(packed, contacts.ref)
    b2 = _gather_packed(packed, contacts.alt)
    avg, max_pen, zero = _avg_contacts_batch(contacts.points, contacts.num)
    ok = (contacts.num > 0) & (~zero)
    r1, r2 = _local_contacts(b1, b2, avg, max_pen, contacts.normal)
    both = {k: torch.stack([b1[k], b2[k]]) for k in b1}
    return both, ok, torch.stack([r1, r2])


def _take_pair(table, ref, alt):
    """table [W, N, D] at the rows ref, alt [W] -> [2, W, D]."""
    n = table.shape[1]
    widx = torch.arange(ref.shape[0], device=ref.device)
    rows = torch.stack([ref, alt]).long().clamp(0, n - 1)
    return table[widx[None], rows]


@functools.lru_cache(maxsize=None)
def _pair_sign(device) -> torch.Tensor:
    """[2, 1, 1]: +1 for the ref's update, -1 for the alt's."""
    return torch.tensor([1.0, -1.0], device=device).reshape(2, 1, 1)


def solve_positions(body: BodyState, contacts: Contacts, om):
    """Gauss-Seidel position solve (solvePositions, xpbd.cpp:720-736):
    slot by slot, each slot reading the poses the slots before it wrote.
    Returns (body, contacts with each slot's normal lambda)."""
    b, ok, r = _slot_views(body, contacts, om)
    avg_mu_s = 0.5 * (b["mu_s"][0] + b["mu_s"][1])
    lam = torch.zeros_like(contacts.lambda_n)
    for i in range(contacts.ref.shape[1]):
        ref, alt = contacts.ref[:, i], contacts.alt[:, i]
        pose = _take_pair(torch.cat([body.pos, body.rot], dim=-1), ref, alt)
        x1, x2, q1, q2, lam_n = _solve_contact(
            pose[0, :, :3], pose[1, :, :3], pose[0, :, 3:], pose[1, :, 3:],
            b["prev_x"][0, :, i], b["prev_q"][0, :, i],
            b["prev_x"][1, :, i], b["prev_q"][1, :, i],
            b["inv_m"][0, :, i], b["inv_m"][1, :, i],
            b["inv_i"][0, :, i], b["inv_i"][1, :, i],
            r[0, :, i], r[1, :, i], contacts.normal[:, i], avg_mu_s[:, i],
        )
        body = _scatter_pose(body, ref, x1, q1, ok[:, i])
        body = _scatter_pose(body, alt, x2, q2, ok[:, i])
        lam[:, i] = torch.where(ok[:, i], lam_n, 0.0)
    return body, dataclasses.replace(contacts, lambda_n=lam)


def solve_velocities(body: BodyState, contacts: Contacts, om, h: float,
                     restitution: float, restitution_threshold: float
                     ) -> BodyState:
    """Gauss-Seidel velocity solve (solveVelocities, xpbd.cpp:1041-1053):
    slot by slot, restitution on the averaged contact, then dynamic
    friction at each manifold point in turn, lambda_n shared out by
    penetration."""
    b, ok, r = _slot_views(body, contacts, om)
    nrm = contacts.normal
    num = contacts.num
    sign = _pair_sign(nrm.device)
    q = b["q"]                                            # [2, W, C, 4]
    q_inv = m3.quat_inv(q)
    mu_d = 0.5 * (b["mu_d"][0] + b["mu_d"][1])

    # restitution's parts that the velocities do not change
    r_pre = m3.quat_rotate(b["presolve_q"], r)
    vb = b["presolve_v"] + m3.cross(b["presolve_w"], r_pre)
    vn_bar = m3.dot(nrm, vb[0] - vb[1])
    r_world = m3.quat_rotate(q, r)
    rt_axis = m3.cross(r, m3.quat_rotate(q_inv, nrm))
    rr_axis = b["inv_i"] * rt_axis
    gw = _generalized_inv_mass(rt_axis, rr_axis, b["inv_m"])
    den_r = gw[0] + gw[1]
    e = torch.where(torch.abs(vn_bar) <= restitution_threshold, 0.0,
                    restitution)
    rest_bar = torch.clamp(-e * vn_bar, max=0.0)
    imp_ok = ok & (den_r > 0)
    den_r = torch.where(den_r > 0, den_r, 1.0)

    # friction's: each manifold point's anchors and share of lambda_n
    pts = contacts.points                                 # [W, C, 4, 4]
    depth = pts[..., 3]
    live4 = torch.arange(4, device=num.device) < num[..., None]
    pen_sum = m3.sum_in_order(torch.where(live4, depth, 0.0))
    live_pt = ok[..., None] & live4 & (pen_sum > 0.0)[..., None]
    lam_pt = torch.abs(contacts.lambda_n[..., None] * (
        depth / torch.where(pen_sum > 0, pen_sum, 1.0)[..., None]))
    pt_view = {k: b[k][..., None, :] for k in ("presolve_x", "presolve_q")}
    r_pt = torch.stack(_local_contacts(
        {k: v[0] for k, v in pt_view.items()},
        {k: v[1] for k, v in pt_view.items()},
        pts[..., :3], depth, nrm[..., None, :]))         # [2, W, C, 4, 3]
    rw_pt = m3.quat_rotate(q[..., None, :], r_pt)

    for i in range(contacts.ref.shape[1]):
        ref, alt = contacts.ref[:, i], contacts.alt[:, i]
        vw = _take_pair(torch.cat([body.vel, body.omega], dim=-1), ref, alt)
        v, w = vw[..., :3], vw[..., 3:]                   # [2, W, 3]
        n_i = nrm[:, i]
        q_i, q_inv_i = q[:, :, i], q_inv[:, :, i]
        inv_m, inv_i = b["inv_m"][:, :, i, None], b["inv_i"][:, :, i]

        # restitution (applyRestitutionVelocityUpdate)
        u = v + m3.cross(w, r_world[:, :, i])
        vn = m3.dot(n_i, u[0] - u[1])
        imp = torch.where(imp_ok[:, i],
                          (rest_bar[:, i] - vn) / den_r[:, i], 0.0)
        v = v + sign * (n_i * (imp[:, None] * inv_m))
        w = w + sign * m3.quat_rotate(q_i, imp[:, None] * rr_axis[:, :, i])

        # dynamic friction, one manifold point after another
        for p in range(4):
            rr, rw = r_pt[:, :, i, p], rw_pt[:, :, i, p]
            u = v + m3.cross(w, rw)
            v_rel = u[0] - u[1]
            vt = v_rel - n_i * m3.dot(n_i, v_rel)[..., None]
            vt_len = torch.sqrt(torch.clamp(m3.dot(vt, vt), min=1e-30))
            t_dir = vt / vt_len[..., None]
            fta = m3.cross(rr, m3.quat_rotate(q_inv_i, t_dir))
            fra = inv_i * fta
            fw = _generalized_inv_mass(fta, fra, inv_m[..., 0])
            den_f = fw[0] + fw[1]
            inv_scale = torch.where(
                den_f > 0, 1.0 / torch.where(den_f > 0, den_f, 1.0), 0.0)
            # inv_scale twice on purpose (xpbd.cpp:834-836)
            dyn_mag = mu_d[:, i] * lam_pt[:, i, p] * inv_scale / h
            f_imp = torch.where(
                live_pt[:, i, p] & (vt_len > 1e-15),
                -torch.minimum(dyn_mag, vt_len) * inv_scale, 0.0)
            v = v + sign * (t_dir * (f_imp[:, None] * inv_m))
            w = w + sign * m3.quat_rotate(q_i, f_imp[:, None] * fra)

        body = _scatter_vel(body, ref, v[0], w[0], ok[:, i])
        body = _scatter_vel(body, alt, v[1], w[1], ok[:, i])
    return body
