"""TGS-Soft solver: the soft-constraint, velocity-level alternative to XPBD.

Port of ``madrona_tpu/physics/tgs.py`` (the reference's
``src/physics/tgs.cpp`` scheme, after Solver2D's ``solve_tgs_soft``).
Per substep: integrate velocities, solve contact impulses at the
velocity level with a soft Baumgarte bias (mass-spring-damper gains
from the contact hertz and damping ratio), friction bounded by the
normal impulse, integrate positions, the joints' XPBD positional pass,
then a bias-free relax pass. Every contact is solved at once and the
impulses averaged per body, as the Jacobi XPBD path does.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..utils import math3d as m3
from . import joints as _joints
from . import xpbd as _x
from .bodies import RESPONSE_DYNAMIC, RESPONSE_STATIC


@dataclasses.dataclass(frozen=True)
class TGSConfig:
    contact_hertz: float = 30.0
    contact_zeta: float = 10.0
    friction: bool = True


def _soft_params(hertz, zeta, h):
    """Solver2D's soft-constraint coefficients (bias rate, mass scale,
    impulse scale), in double on the host as the JAX package forms them."""
    omega = 2.0 * math.pi * hertz
    a1 = 2.0 * zeta + h * omega
    a2 = h * omega * a1
    a3 = 1.0 / (1.0 + a2)
    return omega / a1, a2 * a3, a3


def _eff_mass(b1, b2, r1, r2, axis):
    """Effective inverse mass of the pair along ``axis``."""
    ra1 = m3.cross(r1, axis)
    ra2 = m3.cross(r2, axis)
    return (b1["inv_m"] + b2["inv_m"] + m3.dot(ra1, b1["inv_i"] * ra1)
            + m3.dot(ra2, b2["inv_i"] * ra2)), ra1, ra2


def solve_contacts_velocity(body: _x.BodyState, contacts: _x.Contacts, om,
                            h: float, cfg: TGSConfig, use_bias: bool):
    """One velocity-impulse pass over all contacts, averaged per body.
    Returns (body, the normal impulses [W, C])."""
    ref, alt = contacts.ref, contacts.alt
    nrm = contacts.normal
    n = body.pos.shape[1]

    avg, max_pen, zero = _x._avg_contacts_batch(contacts.points,
                                                contacts.num)
    ok = (contacts.num > 0) & (~zero)

    packed = _x.pack_bodies(body, om)
    b1 = _x._gather_packed(packed, ref)
    b2 = _x._gather_packed(packed, alt)

    r1 = avg - b1["x"]
    r2 = (avg - nrm * max_pen[..., None]) - b2["x"]
    v1, w1 = b1["v"], b1["w"]
    v2, w2 = b2["v"], b2["w"]

    # the normal points ref (1) -> other (2): the separating speed is the
    # other body's velocity along n relative to the ref's
    v_rel = (v2 + m3.cross(w2, r2)) - (v1 + m3.cross(w1, r1))
    vn = m3.dot(nrm, v_rel)

    k_n, rn1, rn2 = _eff_mass(b1, b2, r1, r2, nrm)
    inv_k = torch.where(k_n > 0, 1.0 / torch.clamp(k_n, min=1e-12), 0.0)

    if use_bias:
        bias_rate, mass_scale, _ = _soft_params(
            cfg.contact_hertz, cfg.contact_zeta, h)
        bias = torch.clamp(-max_pen, max=0.0) * bias_rate
        lam = -mass_scale * inv_k * (vn + bias)
    else:
        lam = -inv_k * vn
    lam = torch.clamp(lam, min=0.0)           # no pulling (no warm start)
    lam = torch.where(ok, lam, 0.0)

    # push body 2 along +n, body 1 along -n
    dv1 = -nrm * (lam * b1["inv_m"])[..., None]
    dv2 = nrm * (lam * b2["inv_m"])[..., None]
    dw1 = -(b1["inv_i"] * rn1) * lam[..., None]
    dw2 = (b2["inv_i"] * rn2) * lam[..., None]

    if cfg.friction:
        mu = 0.5 * (b1["mu_d"] + b2["mu_d"])
        v_rel2 = ((v2 + dv2 + m3.cross(w2 + dw2, r2))
                  - (v1 + dv1 + m3.cross(w1 + dw1, r1)))
        vt = v_rel2 - nrm * m3.dot(nrm, v_rel2)[..., None]
        vt_len = torch.sqrt(torch.clamp(m3.dot(vt, vt), min=1e-30))
        t_dir = vt / vt_len[..., None]
        k_t, rt1, rt2 = _eff_mass(b1, b2, r1, r2, t_dir)
        lam_t = torch.minimum(
            torch.clamp(vt_len / torch.clamp(k_t, min=1e-12), min=0.0),
            mu * lam)
        lam_t = torch.where(ok & (vt_len > 1e-10), lam_t, 0.0)
        # oppose body 2's tangential motion relative to body 1
        dv1 = dv1 + t_dir * (lam_t * b1["inv_m"])[..., None]
        dv2 = dv2 - t_dir * (lam_t * b2["inv_m"])[..., None]
        dw1 = dw1 + (b1["inv_i"] * rt1) * lam_t[..., None]
        dw2 = dw2 - (b2["inv_i"] * rt2) * lam_t[..., None]

    rows2 = torch.cat([ref, alt], dim=1)
    ok2 = torch.cat([ok, ok], dim=1)
    d1 = torch.cat([dv1, dw1], dim=-1)
    d2 = torch.cat([dv2, dw2], dim=-1)
    mean = _x._scatter_avg_packed(rows2, torch.cat([d1, d2], dim=1), ok2, n)
    body = dataclasses.replace(
        body, vel=body.vel + mean[..., :3], omega=body.omega + mean[..., 3:6]
    )
    return body, lam


def integrate_velocities(body: _x.BodyState, om, h: float, gravity):
    """integrateVelocities (tgs.cpp:93-140): forces -> velocities only."""
    g = _x.const_f32(tuple(gravity), body.pos.device)
    params = om.obj_params(body.obj_id)
    dynamic = body.response == RESPONSE_DYNAMIC
    moving = ((body.response != RESPONSE_STATIC) & body.active)[..., None]
    v = body.vel + torch.where(dynamic[..., None], h * g, 0.0)
    v = v + h * params["inv_m"][..., None] * body.ext_force
    w = body.omega + h * params["inv_i"] * body.ext_torque
    return dataclasses.replace(
        body, vel=torch.where(moving, v, body.vel),
        omega=torch.where(moving, w, body.omega),
    )


def integrate_positions(body: _x.BodyState, h: float):
    moving = ((body.response != RESPONSE_STATIC) & body.active)[..., None]
    x = body.pos + h * body.vel
    q = m3.quat_normalize(
        body.rot + m3.quat_mul(_x._pure(0.5 * h * body.omega), body.rot))
    return dataclasses.replace(
        body, pos=torch.where(moving, x, body.pos),
        rot=torch.where(moving, q, body.rot),
    )


def substep(body, contacts_fn, om, h, gravity, cfg: TGSConfig, jbuf=None):
    """One TGS substep: integrate velocities -> biased solve -> integrate
    positions -> the joints' positional pass -> relax (bias-free) pass.

    ``contacts_fn(body)`` gives the substep's contacts. ``jbuf``: the
    joint buffer, enforced with the Jacobi XPBD joint solve after the
    position integration (TGS is velocity-level)."""
    body = integrate_velocities(body, om, h, gravity)
    contacts = contacts_fn(body)
    body, _ = solve_contacts_velocity(body, contacts, om, h, cfg, True)
    body = integrate_positions(body, h)
    if jbuf is not None:
        body = _joints.solve_joints_jacobi(body, jbuf, om)
    body, _ = solve_contacts_velocity(body, contacts, om, h, cfg, False)
    return body
