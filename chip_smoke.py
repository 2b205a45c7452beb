#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (madrona_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. the card (nvidia-smi name and power limit) and the kernel build
     (one nvcc per csrc/*.cu source, all four started together);
  2. the broadphase kernel against its plain PyTorch version at 4096
     worlds, on random scenes (caps-saturating ones included) and on a
     real Escape Room body state: every field exactly equal;
  3. the lidar kernel against its plain version at the Escape Room shape
     (4096 worlds, 20 boxes, 2 agents x 30 rays): max abs diff <= 1e-5;
  4. the contacts kernel against its plain version at 4096 worlds, on a
     real Escape Room state and on a crowded scene of rotated, scaled
     boxes on a plane (caps 8/8/0, live hull-hull face and edge
     contacts): ref, alt, num equal; normal, average point, penetration
     within 1e-4 on ok lanes; manifold points within 1e-3, unordered;
  5. the substep-solver kernel against its plain version at 4096 worlds,
     on the Escape Room state with grab joints on in part of the worlds
     and on the crowded scene's contacts: all 33 output fields within
     pose 1e-3, velocity 5e-2, angular velocity 2e-1; static rows
     bit-equal to their inputs;
  6. the main path: make_sim(EscapeRoom(), 4096 worlds, seed 0) on the
     card, stepped with seeded random actions; every export finite, each
     of the four kernels launched once per step, a fresh sim with the
     same seed bit-identical; env-steps/s; ms per taskgraph node;
  7. the same env at 8 worlds on the card against the port's CPU path;
     and, with the kernels' libraries and the compiler taken away, a step
     on the card raises (no fallback to the plain versions);
  8. per-kernel times (CUDA events) beside their bounds, as one JSON line.

Any failure raises (non-zero exit). The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs CUDA and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

DEV = "cuda"
W = 4096                  # the Escape Room world count of the repo's bench
STEPS = 20
SMALL_W = 8
SMALL_STEPS = 3
SMALL_TOL = 1e-3          # card vs CPU, float exports after 3 steps
LIDAR_TOL = 1e-5          # kernel vs plain version
# contacts and solver kernels vs their plain versions: the JAX package's
# golden bounds (tests/golden_inputs.py:484-492)
CON_TOL = 1e-4            # normal, average point, largest penetration
PTS_TOL = 1e-3            # manifold points, compared unordered
POSE_TOL, VEL_TOL, OMEGA_TOL = 1e-3, 5e-2, 2e-1
TIMING_ITERS = 200
PLAIN_PHYSICS_ITERS = 3   # the plain contacts/solver take ~0.1 s a call

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 non-tensor op/s
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# operation counts of the two kernels' arithmetic (see csrc/*.cu):
# broadphase: ~111 per body (rotation matrix 33, center/extent 21,
# center row sums 18, extent row sums 24, velocity expansion 15) and ~12
# per pair (6 compares, 6 ands/branches); lidar: ~120 per (ray, box)
# (two quaternion rotations 60, guards and divisions 27, slab 22, the
# hit test and running min 11).
BP_OPS_PER_BODY = 111
BP_OPS_PER_PAIR = 12
LIDAR_OPS_PER_RAY_BOX = 120
# contacts (csrc/contacts.cu), counted per lane from this run's data.
# A hull to world space ~825 (8 vertices x 36, 6 planes x 85, center 27).
# A hull-hull candidate up to its separation test ~3,800: two hulls 1,650,
# face queries both ways 672 (2 x 6 faces x 8 vertices x 7), edge query
# ~1,500 (9 direction pairs x ~125, the directions' transforms ~400).
# A face manifold ~3,300 (two polygons 288, side planes 68, 20 clip
# candidates ~860, projection 240, the reduction over 20 points ~1,800);
# an edge contact ~2,000 (two witness-edge sweeps of 12 edges x ~80,
# closest point ~60). A hull-plane candidate ~910 (hull 825, vertex
# distances 56, plane normal 30); its manifold ~610 (incident face 30,
# polygon 144, projection 48, reduction over 4 points ~350, tail 40).
HH_OPS_CANDIDATE = 3800
HH_OPS_FACE = 3300
HH_OPS_EDGE = 2000
HP_OPS_CANDIDATE = 910
HP_OPS_CONTACT = 610
# solver (csrc/solver.cu), per substep: integrate ~200 per movable body;
# a live contact's position pass ~700 per Jacobi iteration, its velocity
# pass ~350 plus ~450 per live manifold point; a live joint ~900.
SOLVER_OPS_BODY = 200
SOLVER_OPS_CONTACT_POS = 700
SOLVER_OPS_CONTACT_VEL = 350
SOLVER_OPS_POINT = 450
SOLVER_OPS_JOINT = 900


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def timed(fn, iters=TIMING_ITERS):
    """Mean ms of fn() over iters launches (CUDA events, after warm-up)."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def random_scene(rs, om, n_obj_hi, n, crowded):
    """A random BodyState [W, n] on the card (the JAX package's
    broadphase test scene, at the main path's world count)."""
    import torch
    from madrona_tpu_torch.physics import xpbd

    def q_rand(shape):
        q = rs.randn(*shape, 4).astype(np.float32)
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    spread = 0.8 if crowded else 2.5
    pos = rs.uniform(-spread, spread, (W, n, 3)).astype(np.float32)
    pos[..., 2] = rs.uniform(0.0, 1.2 if crowded else 3.0, (W, n))
    pos[:, 0] = 0.0
    obj = rs.randint(1, n_obj_hi, (W, n)).astype(np.int32)
    obj[:, 0] = 0                           # row 0: the floor plane
    resp = np.full((W, n), xpbd.RESPONSE_DYNAMIC, np.int32)
    resp[:, :2] = xpbd.RESPONSE_STATIC      # plane + one static box
    active = np.ones((W, n), bool)
    active[:, -2:] = rs.rand(W, 2) < 0.5    # some dead rows
    rot = q_rand((W, n))
    rot[:, 0] = [1, 0, 0, 0]
    scale = rs.uniform(0.5, 1.8, (W, n, 3)).astype(np.float32)
    vel = (1.5 * rs.randn(W, n, 3)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(DEV)      # noqa: E731
    z3 = torch.zeros((W, n, 3), device=DEV)
    z4 = torch.zeros((W, n, 4), device=DEV)
    return xpbd.BodyState(
        pos=t(pos), rot=t(rot), scale=t(scale), vel=t(vel), omega=z3,
        obj_id=t(obj), response=t(resp), ext_force=z3, ext_torque=z3,
        prev_x=z3, prev_q=z4, presolve_x=z3, presolve_q=z4,
        presolve_v=z3, presolve_w=z3, active=t(active),
    )


def check_broadphase(sim):
    """Phase 2. Returns the max abs difference (0: all fields equal)."""
    import torch
    from madrona_tpu_torch.ops import broadphase_cuda as bpc
    from madrona_tpu_torch.physics import api as papi
    from madrona_tpu_torch.physics import bodies as pb
    from madrona_tpu_torch.physics import broadphase as bp
    from madrona_tpu_torch.physics import geo

    reg = pb.ObjectRegistry()
    reg.add_plane()
    reg.add_hull(geo.box_hull((0.5, 0.5, 0.5)), mass=1.0)
    reg.add_hull(geo.box_hull((0.4, 0.8, 0.3)), mass=2.5)
    reg.add_sphere(0.45, mass=0.8)
    om_rand = reg.build().to(DEV)
    env = sim.env
    om_er = env.om.to(DEV)
    body_er = papi.body_state(sim.executor.sm, sim.state)
    cases = [
        ("random", om_rand, random_scene(np.random.RandomState(0), om_rand,
                                         4, 21, False),
         bp.CandidateCaps(hull_hull=48, hull_plane=20, sphere_any=48), False),
        ("crowded", om_rand, random_scene(np.random.RandomState(1), om_rand,
                                          4, 21, True),
         bp.CandidateCaps(hull_hull=48, hull_plane=20, sphere_any=48), False),
        ("saturating", om_rand, random_scene(np.random.RandomState(3),
                                             om_rand, 4, 21, True),
         bp.CandidateCaps(hull_hull=2, hull_plane=1, sphere_any=1), True),
        ("escape_room", om_er, body_er, env.caps, False),
    ]
    fields = ("hh", "hh_num", "hp", "hp_num", "sp", "sp_num", "sp_kind",
              "overflow")
    worst = 0
    for name, om, body, caps, must_overflow in cases:
        got = bpc.find_candidates_kernel(body, om, caps, env.cfg.dt)
        ref = bp.find_candidates(body, om, caps, env.cfg.dt)
        torch.cuda.synchronize()
        for f in fields:
            a, b = getattr(got, f), getattr(ref, f)
            if a.shape != b.shape:
                raise AssertionError(f"broadphase {name}: {f} shape differs")
            if a.numel():
                worst = max(worst, int((a.long() - b.long()).abs().max()))
            if not torch.equal(a, b):
                raise AssertionError(f"broadphase {name}: field {f} differs")
        n_ovf = int(got.overflow.sum())
        if must_overflow and n_ovf == 0:
            raise AssertionError(f"broadphase {name}: no world saturated")
        print(f"broadphase kernel == plain [{name}]: W={W} "
              f"hh={int(got.hh_num.sum())} hp={int(got.hp_num.sum())} "
              f"sp={int(got.sp_num.sum())} overflow_worlds={n_ovf}")
    return float(worst)


def lidar_inputs(sim):
    """The env's lidar arguments at the sim's current state."""
    return sim.env.lidar_inputs(sim.state)


def plain_lidar(args):
    from madrona_tpu_torch.ops.lidar_cuda import lidar_obb_plain

    return lidar_obb_plain(*args)


def check_lidar(sim):
    """Phase 3. Returns the max abs diff over both scenes."""
    import torch
    from madrona_tpu_torch.ops import lidar_cuda

    rs = np.random.RandomState(11)
    n_inst, n_ag, n_rays = 20, 2, 30
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(DEV)  # noqa
    q = rs.randn(W, n_inst, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    ang = rs.uniform(0, 2 * np.pi, (W, n_ag, n_rays))
    mask = np.ones((n_ag, n_inst), bool)
    mask[0, 2] = mask[1, 5] = False
    rand_args = (
        t(rs.uniform(-8, 8, (W, n_inst, 3))), t(q),
        t(rs.uniform(0.2, 3.0, (W, n_inst, 3))),
        torch.from_numpy(mask).to(DEV), t(rs.uniform(-6, 6, (W, n_ag, 3))),
        t(np.stack([-np.sin(ang), np.cos(ang),
                    0.1 * rs.randn(W, n_ag, n_rays)], -1)),
        50.0,
    )
    worst = 0.0
    for name, args in (("random", rand_args), ("escape_room",
                                                lidar_inputs(sim))):
        got = lidar_cuda.lidar_obb(*args)
        ref = plain_lidar(args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        n_hit = int((got < args[-1]).sum())
        print(f"lidar kernel vs plain [{name}]: W={W} max_abs_diff={err!r} "
              f"hits={n_hit}/{got.numel()}")
        if not err <= LIDAR_TOL:
            raise AssertionError(f"lidar {name}: {err} > {LIDAR_TOL}")
        worst = max(worst, err)
    return worst


def crowded_scene():
    """(om, BodyState [W, 21], caps): rotated, scaled boxes crowded on a
    plane, no sphere objects, the Escape Room's caps 8/8/0."""
    from madrona_tpu_torch.physics import bodies as pb
    from madrona_tpu_torch.physics import broadphase as bp
    from madrona_tpu_torch.physics import geo

    reg = pb.ObjectRegistry()
    reg.add_plane()
    reg.add_hull(geo.box_hull((0.5, 0.5, 0.5)), mass=1.0)
    reg.add_hull(geo.box_hull((0.4, 0.8, 0.3)), mass=2.5)
    om = reg.build().to(DEV)
    body = random_scene(np.random.RandomState(21), om, 3, 21, True)
    return om, body, bp.CandidateCaps(hull_hull=8, hull_plane=8, sphere_any=0)


def with_grab_joints(sim):
    """The sim's state with a fixed grab joint (agent 0 holds cube 0) on
    in the even worlds and a hinge (agent 1, cube 1) in every fourth."""
    import dataclasses

    import torch
    from madrona_tpu_torch.models import escape_room as er
    from madrona_tpu_torch.physics import api as papi

    state = sim.state
    jb = {k: v.clone() for k, v in state.singletons[papi.JOINT_BUFFER].items()}
    f32 = lambda *v: torch.tensor(v, dtype=torch.float32,   # noqa: E731
                                  device=DEV)
    even, fourth = slice(0, W, 2), slice(1, W, 4)
    jb["e1"][even, 0] = er.ROW_AGENT0
    jb["e2"][even, 0] = er.ROW_CUBE0
    jb["jtype"][even, 0] = 0
    jb["r1"][even, 0] = f32(0.0, 0.6, 0.0)
    jb["r2"][even, 0] = f32(0.0, -0.6, 0.0)
    jb["attach_q1"][even, 0] = f32(1.0, 0.0, 0.0, 0.0)
    jb["attach_q2"][even, 0] = f32(1.0, 0.0, 0.0, 0.0)
    jb["active"][even, 0] = True
    jb["e1"][fourth, 1] = er.ROW_AGENT0 + 1
    jb["e2"][fourth, 1] = er.ROW_CUBE0 + 1
    jb["jtype"][fourth, 1] = 1
    jb["r1"][fourth, 1] = f32(0.0, 0.5, 0.1)
    jb["r2"][fourth, 1] = f32(0.0, -0.5, 0.0)
    jb["a1_local"][fourth, 1] = f32(0.0, 0.0, 1.0)
    jb["a2_local"][fourth, 1] = f32(0.0, 0.1, 1.0)
    jb["active"][fourth, 1] = True
    singles = dict(state.singletons)
    singles[papi.JOINT_BUFFER] = jb
    return dataclasses.replace(state, singletons=singles)


def contacts_inputs(body, om, caps, cfg):
    """(hh, hp, poses, obj) as the physics node hands them to the
    contacts kernel: candidates from the broadphase kernel, poses
    predicted by one integrate."""
    from madrona_tpu_torch.ops import broadphase_cuda, contacts_cuda
    from madrona_tpu_torch.physics import xpbd

    cands = broadphase_cuda.find_candidates_kernel(body, om, caps, cfg.dt)
    pred = xpbd.integrate(body, om, cfg.dt / cfg.substeps, cfg.gravity)
    poses, obj = contacts_cuda.pack_poses(pred, body.obj_id)
    return cands.hh, cands.hp, poses, obj


def sorted_points(pts, num):
    """[16, C, W] manifold rows -> live points sorted per lane (numpy)."""
    c, w = num.shape
    p = np.transpose(pts.reshape(4, 4, c, w), (2, 3, 0, 1)).reshape(-1, 4, 4)
    p = p.astype(np.float64)
    live = np.arange(4)[None] < num.reshape(-1, 1)
    p = np.where(live[..., None], p, 0.0)
    order = np.lexsort((p[..., 3], p[..., 2], p[..., 1], p[..., 0]), axis=-1)
    return np.take_along_axis(p, order[..., None], axis=1)


def check_contacts(name, args, om, n_hh, want_face_and_edge):
    """Phase 4 on one scene. Returns (kernel outputs, largest float
    difference, the scene's lane counts for the operation count)."""
    import torch
    from madrona_tpu_torch.ops import contacts_cuda

    got = contacts_cuda.contacts(*args, om)
    ref = contacts_cuda.contacts_plain(*args, om)
    torch.cuda.synchronize()
    for f, a, b in zip(("ref", "alt", "con", "pts", "num"), got, ref):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"contacts {name}: {f} shape/dtype differs")
    for i, f in ((0, "ref"), (1, "alt"), (4, "num")):
        if not torch.equal(got[i], ref[i]):
            bad = int((got[i] != ref[i]).sum())
            raise AssertionError(
                f"contacts {name}: {f} differs in {bad} of "
                f"{got[i].numel()} lanes")
    num = ref[4]
    ok = ref[2][7] > 0.5
    if not torch.equal(got[2][7], ref[2][7]):
        raise AssertionError(f"contacts {name}: ok flags differ")
    con_err = float(torch.where(ok[None], (got[2] - ref[2]).abs(),
                                0.0).max())
    num_ok = torch.where(ok, num, 0).cpu().numpy()
    pts_err = float(np.abs(
        sorted_points(got[3].cpu().numpy(), num_ok)
        - sorted_points(ref[3].cpu().numpy(), num_ok)).max())
    hh_num = num[:n_hh]
    counts = {
        "hh_candidates": int((args[0][..., 0] < args[2].shape[0]).sum()),
        "hp_candidates": int((args[1][..., 0] < args[2].shape[0]).sum()),
        "hh_live": int((hh_num > 0).sum()),
        "hh_4pt": int((hh_num == 4).sum()),
        "hh_1pt": int((hh_num == 1).sum()),
        "hp_live": int((num[n_hh:] > 0).sum()),
        "ok": int(ok.sum()),
    }
    print(f"contacts kernel vs plain [{name}]: W={W} ref/alt/num equal; "
          f"con max_abs_diff={con_err!r} pts max_abs_diff={pts_err!r}; "
          + " ".join(f"{k}={v}" for k, v in counts.items()))
    if not con_err <= CON_TOL:
        raise AssertionError(f"contacts {name}: con {con_err} > {CON_TOL}")
    if not pts_err <= PTS_TOL:
        raise AssertionError(f"contacts {name}: pts {pts_err} > {PTS_TOL}")
    if want_face_and_edge and not (counts["hh_4pt"] > 0
                                   and counts["hh_1pt"] > 0):
        raise AssertionError(f"contacts {name}: no live hull-hull face "
                             "and edge contacts")
    return got, max(con_err, pts_err), counts


def check_solver(name, cfg, state, param, cargs, jargs):
    """Phase 5 on one scene. Returns the largest difference relative to
    its field's tolerance, and the largest absolute one."""
    import torch
    from madrona_tpu_torch.ops import solver_cuda

    got = solver_cuda.substep_solver(cfg, state, param, *cargs, *jargs)
    ref = solver_cuda.substep_solver_plain(cfg, state, param, *cargs,
                                           *jargs)
    torch.cuda.synchronize()
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"solver {name}: bad shape or not finite")
    fields = (("pos", 0, 3, POSE_TOL), ("rot", 3, 7, POSE_TOL),
              ("vel", 7, 10, VEL_TOL), ("omega", 10, 13, OMEGA_TOL),
              ("prev_x", 13, 16, POSE_TOL), ("prev_q", 16, 20, POSE_TOL),
              ("presolve_x", 20, 23, POSE_TOL),
              ("presolve_q", 23, 27, POSE_TOL),
              ("presolve_v", 27, 30, VEL_TOL),
              ("presolve_w", 30, 33, OMEGA_TOL))
    diffs = {f: float((got[lo:hi] - ref[lo:hi]).abs().max())
             for f, lo, hi, _ in fields}
    print(f"solver kernel vs plain [{name}]: W={W} max_abs_diff "
          + " ".join(f"{k}={v:.3g}" for k, v in diffs.items()))
    # how heavy the tail is: worlds where some field is off by more than a
    # tenth of its tolerance (a contact branch taken the other way)
    rel = torch.stack([
        (got[lo:hi] - ref[lo:hi]).abs().amax(dim=(0, 1)) / tol
        for _, lo, hi, tol in fields]).amax(dim=0)
    print(f"solver kernel vs plain [{name}]: {int((rel > 0.1).sum())} of "
          f"{W} worlds differ by more than a tenth of a tolerance")
    for f, _, _, tol in fields:
        if not diffs[f] <= tol:
            raise AssertionError(f"solver {name}: {f} {diffs[f]} > {tol}")
    static = param[8] > 0.5                               # [N, W]
    if cfg.solver_dynamic_range:
        d0, d1 = cfg.solver_dynamic_range
        static = static.clone()
        static[:d0] = True
        static[d1:] = True
    same = (
        torch.equal(got[:13][:, static], state[:, static])
        and torch.equal(got[13:20][:, static], state[:7][:, static])
        and torch.equal(got[20:27][:, static], state[:7][:, static])
    )
    if not same:
        raise AssertionError(f"solver {name}: a static row moved")
    moved = float((got[:3] - state[:3]).abs().max())
    print(f"solver kernel [{name}]: {int(static.sum())} static rows "
          f"bit-equal to their inputs; largest move {moved:.3g}")
    if not moved > 1e-3:
        raise AssertionError(f"solver {name}: nothing moved")
    return max(diffs.values())


def check_physics_kernels(probe):
    """Phases 4 and 5. Returns (contacts err, solver err, what the timing
    phase needs of the Escape Room scene)."""
    import dataclasses

    import torch
    from madrona_tpu_torch.models import escape_room as er
    from madrona_tpu_torch.ops import solver_cuda
    from madrona_tpu_torch.physics import api as papi

    env = probe.env
    cfg = env.cfg
    om_er = env.om.to(DEV)
    state = with_grab_joints(probe)
    body = papi.body_state(probe.executor.sm, state)
    er_args = contacts_inputs(body, om_er, env.caps, cfg)
    er_c, er_err, er_counts = check_contacts("escape_room", er_args, om_er,
                                             env.caps.hull_hull, False)
    om_cr, body_cr, caps_cr = crowded_scene()
    cr_args = contacts_inputs(body_cr, om_cr, caps_cr, cfg)
    cr_c, cr_err, _ = check_contacts("crowded", cr_args, om_cr,
                                     caps_cr.hull_hull, True)

    st, pr = solver_cuda.pack_state(body, om_er)
    jargs = solver_cuda.pack_joints(papi.joints_view(state), er.N_BODIES)
    s_err = check_solver("escape_room + joints", cfg, st, pr, er_c, jargs)
    spec_cr = dataclasses.replace(cfg, solver_dynamic_range=None,
                                  solver_ref_dyn_lanes=0)
    st_cr, pr_cr = solver_cuda.pack_state(body_cr, om_cr)
    s_err = max(s_err, check_solver("crowded", spec_cr, st_cr, pr_cr, cr_c,
                                    ()))
    n_joints = int((jargs[2][21] > 0.5).sum())
    print(f"solver scenes: escape_room has {n_joints} live joints in "
          f"{W} worlds")
    torch.cuda.synchronize()
    scene = dict(om=om_er, args=er_args, contacts=er_c, counts=er_counts,
                 state=st, param=pr, jargs=jargs,
                 n_joints=n_joints)
    return max(er_err, cr_err), s_err, scene


def physics_route(body, om, env, jargs):
    """The physics node's device work on one body state, as
    physics/api.py strings it together."""
    from madrona_tpu_torch.ops import contacts_cuda, solver_cuda

    cfg = env.cfg
    cargs = contacts_cuda.contacts(*contacts_inputs(body, om, env.caps, cfg),
                                   om)
    state, param = solver_cuda.pack_state(body, om)
    return solver_cuda.substep_solver(cfg, state, param, *cargs, *jargs)


def check_no_fallback(make_sim, EscapeRoom, kernels):
    """With every kernel's library unloaded, missing on disk and no
    compiler to be found, a step on the card must raise: it may not go
    on with the plain versions."""
    import torch
    from madrona_tpu_torch.ops import cuda_build

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    saved = (cuda_build._nvcc, cuda_build.library_path,
             [k._fn for k in kernels])
    sim = make_sim(EscapeRoom(), num_worlds=SMALL_W, seed=0, device=DEV)
    try:
        cuda_build._nvcc = no_nvcc
        cuda_build.library_path = (
            lambda src: cuda_build.BUILD_DIR / f"missing-{src}.so")
        for k in kernels:
            k._fn = None
        try:
            sim.step({"action": torch.zeros((SMALL_W, 2, 4),
                                            dtype=torch.int32, device=DEV),
                      "reset": torch.zeros((SMALL_W,), dtype=torch.int32,
                                           device=DEV)})
        except RuntimeError as e:
            print(f"no fallback: without its kernels the step raises ({e})")
        else:
            raise AssertionError("the step ran without its kernels")
    finally:
        cuda_build._nvcc, cuda_build.library_path = saved[:2]
        for k, fn in zip(kernels, saved[2]):
            k._fn = fn


def run_main_path(make_sim, EscapeRoom, acts, counters):
    """Phase 6: step a fresh sim with every counter of ``counters`` set to
    0 first; returns (sim, per-step exports, seconds of steps 2..STEPS,
    the counters' launches in this run)."""
    import torch

    sim = make_sim(EscapeRoom(), num_worlds=W, seed=0, device=DEV)
    reset = torch.zeros((W,), dtype=torch.int32, device=DEV)
    for k in counters:
        k.launches = 0
    outs = []
    t0 = None
    for i in range(STEPS):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out = sim.step({"action": acts[i], "reset": reset})
        outs.append(out)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return sim, outs, secs, [k.launches for k in counters]


def node_times(sim, acts, steps=5):
    """Host seconds per step of each taskgraph node, each node fenced by
    torch.cuda.synchronize() (eager PyTorch: a node's time is its host
    dispatch plus whatever device work it waits on)."""
    import torch

    nodes = sim.executor.graphs["step"].nodes
    totals = {n.name: 0.0 for n in nodes}

    def fenced(name, fn):
        def run(sm, state, key):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(sm, state, key)
            torch.cuda.synchronize()
            totals[name] += time.perf_counter() - t0
            return out
        return run

    saved = [n.fn for n in nodes]
    try:
        for n in nodes:
            n.fn = fenced(n.name, n.fn)
        reset = torch.zeros((W,), dtype=torch.int32, device=DEV)
        for i in range(steps):
            sim.step({"action": acts[i], "reset": reset})
    finally:
        for n, fn in zip(nodes, saved):
            n.fn = fn
    return {k: v / steps for k, v in totals.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from madrona_tpu_torch import make_sim
    from madrona_tpu_torch.models.escape_room import EscapeRoom
    from madrona_tpu_torch.ops import (
        broadphase_cuda, contacts_cuda, cuda_build, lidar_cuda, solver_cuda,
    )

    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)

    # ---- 1. build
    t0 = time.perf_counter()
    libs = cuda_build.build(["broadphase.cu", "contacts.cu", "solver.cu",
                             "lidar.cu"])
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          + ", ".join(p.name for p in libs.values()))
    for src, log in cuda_build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    # ---- 2-5: kernels against their plain versions, on random scenes
    # and on a real Escape Room state (a probe sim, 3 steps in)
    acts = EscapeRoom.random_actions(np.random.RandomState(0), STEPS, W)
    acts = acts.to(DEV)
    probe = make_sim(EscapeRoom(), num_worlds=W, seed=1, device=DEV)
    for i in range(3):
        probe.step({"action": acts[i],
                    "reset": torch.zeros((W,), dtype=torch.int32,
                                         device=DEV)})
    bp_err = check_broadphase(probe)
    li_err = check_lidar(probe)
    co_err, so_err, scene = check_physics_kernels(probe)

    # ---- 6: the main path, its kernel launches counted
    kernels = [broadphase_cuda.KERNEL, contacts_cuda.KERNEL,
               solver_cuda.KERNEL, lidar_cuda.KERNEL]
    sim, outs, secs, launches = run_main_path(make_sim, EscapeRoom, acts,
                                              kernels)
    for k, n in zip(kernels, launches):
        print(f"main path: {k.symbol} launched {n} times in {STEPS} steps")
        if n != STEPS:
            raise AssertionError(f"{k.symbol}: {n} launches != {STEPS}")
    for i, out in enumerate(outs):
        for name, v in out.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise AssertionError(f"step {i}: export {name} not finite")
    final = outs[-1]
    if tuple(final["flat_obs"].shape) != (W, 2, 101):
        raise AssertionError(f"flat_obs shape {tuple(final['flat_obs'].shape)}")
    if not bool((final["steps_taken"] == STEPS).all()):
        raise AssertionError("steps_taken != steps")
    sps = W * (STEPS - 1) / secs
    print(f"main path: {W} worlds x {STEPS} steps, exports finite; "
          f"{secs * 1e3 / (STEPS - 1):.2f} ms/step, "
          f"{sps:.1f} env-steps/s ({card})")

    _, outs2, _, _ = run_main_path(make_sim, EscapeRoom, acts, [])
    for i, (a, b) in enumerate(zip(outs, outs2)):
        for name in a:
            if not torch.equal(a[name], b[name]):
                raise AssertionError(f"step {i}: {name} differs across "
                                     "fresh sims")
    print("main path: a fresh sim with the same seed is bit-identical")
    per_node = node_times(sim, acts)
    print("main path, ms/step by node (synchronized): " + ", ".join(
        f"{k} {v * 1e3:.2f}" for k, v in per_node.items()) + f" ({card})")

    # ---- 7: the card against the port's CPU path, small
    small_acts = EscapeRoom.random_actions(np.random.RandomState(5),
                                           SMALL_STEPS, SMALL_W)
    sims = {d: make_sim(EscapeRoom(), num_worlds=SMALL_W, seed=3, device=d)
            for d in ("cpu", DEV)}
    worst = 0.0
    for i in range(SMALL_STEPS):
        o = {d: s.step({"action": small_acts[i].to(d),
                        "reset": torch.zeros(SMALL_W, dtype=torch.int32,
                                             device=d)})
             for d, s in sims.items()}
        for name, g in o[DEV].items():
            c, g = o["cpu"][name], g.cpu()
            if g.is_floating_point():
                worst = max(worst, float((g - c).abs().max()))
            elif not torch.equal(g, c):
                raise AssertionError(f"small run step {i}: {name} differs")
    if not worst <= SMALL_TOL:
        raise AssertionError(f"card vs CPU: {worst} > {SMALL_TOL}")
    print(f"card vs CPU path: {SMALL_W} worlds x {SMALL_STEPS} steps, "
          f"int exports equal, float max_abs_diff={worst!r}")

    check_no_fallback(make_sim, EscapeRoom, kernels)

    # ---- 8: times at the main path's shapes
    from madrona_tpu_torch.physics import api as papi
    from madrona_tpu_torch.physics import broadphase as bp

    env = sim.env
    om = env.om.to(DEV)
    body = papi.body_state(sim.executor.sm, sim.state)
    pack = broadphase_cuda.pack_bodies(body, om)
    cands = broadphase_cuda.broadphase(pack, env.caps, env.cfg.dt)
    n = pack.shape[1]
    bp_bytes = nbytes(pack, *[getattr(cands, f) for f in (
        "hh", "hh_num", "hp", "hp_num", "sp", "sp_num", "sp_kind",
        "overflow")])
    bp_ops = W * (BP_OPS_PER_BODY * n + BP_OPS_PER_PAIR * n * (n - 1) // 2)
    bp_ms = timed(lambda: broadphase_cuda.broadphase(pack, env.caps,
                                                     env.cfg.dt))
    bp_route_ms = timed(lambda: broadphase_cuda.find_candidates_kernel(
        body, om, env.caps, env.cfg.dt))
    bp_plain_ms = timed(lambda: bp.find_candidates(body, om, env.caps,
                                                   env.cfg.dt), 50)

    largs = lidar_inputs(sim)
    depth = lidar_cuda.lidar_obb(*largs)
    li_bytes = nbytes(*largs[:6], depth)
    li_ops = (depth.numel() * largs[0].shape[1]) * LIDAR_OPS_PER_RAY_BOX
    li_ms = timed(lambda: lidar_cuda.lidar_obb(*largs))
    li_plain_ms = timed(lambda: plain_lidar(largs), 50)
    print(f"broadphase route (pack + kernel): {bp_route_ms:.4f} ms")

    # contacts and solver on the probe's Escape Room scene (phases 4, 5)
    c_in, c_out, cnt = scene["args"], scene["contacts"], scene["counts"]
    om_s = scene["om"]
    co_bytes = nbytes(*c_in, om_s.hull_pack, om_s.hull_dirs_pack, *c_out)
    co_ops = (HH_OPS_CANDIDATE * cnt["hh_candidates"]
              + HH_OPS_FACE * (cnt["hh_live"] - cnt["hh_1pt"])
              + HH_OPS_EDGE * cnt["hh_1pt"]
              + HP_OPS_CANDIDATE * cnt["hp_candidates"]
              + HP_OPS_CONTACT * cnt["hp_live"])
    co_ms = timed(lambda: contacts_cuda.contacts(*c_in, om_s))
    co_plain_ms = timed(lambda: contacts_cuda.contacts_plain(*c_in, om_s),
                        PLAIN_PHYSICS_ITERS)
    cfg = env.cfg
    s_in = (scene["state"], scene["param"], *c_out, *scene["jargs"])
    s_out = solver_cuda.substep_solver(cfg, *s_in)
    so_bytes = nbytes(*s_in, s_out)
    live_points = int(torch.where(c_out[2][7] > 0.5, c_out[4], 0).sum())
    d0, d1 = cfg.solver_dynamic_range
    so_ops = cfg.substeps * (
        SOLVER_OPS_BODY * (d1 - d0) * W
        + (SOLVER_OPS_CONTACT_POS * cfg.jacobi_iters
           + SOLVER_OPS_CONTACT_VEL)
        * cnt["ok"]
        + SOLVER_OPS_POINT * live_points
        + SOLVER_OPS_JOINT * scene["n_joints"])
    so_ms = timed(lambda: solver_cuda.substep_solver(cfg, *s_in))
    so_plain_ms = timed(
        lambda: solver_cuda.substep_solver_plain(cfg, *s_in),
        PLAIN_PHYSICS_ITERS)
    route_ms = timed(lambda: physics_route(body, om, env, scene["jargs"]),
                     50)
    print(f"physics route (B1 + integrate + packs + B2 + B3): "
          f"{route_ms:.4f} ms")

    def bound(b, ops):
        t_bytes, t_ops = b / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    rows = []
    for name, src, rep, k, err, ms, plain_ms, b, ops in (
        ("broadphase", "madrona_tpu_torch/csrc/broadphase.cu",
         "madrona_tpu/ops/broadphase_pallas.py:160", broadphase_cuda.KERNEL,
         bp_err, bp_ms, bp_plain_ms, bp_bytes, bp_ops),
        ("contacts", "madrona_tpu_torch/csrc/contacts.cu",
         "madrona_tpu/ops/physics_megakernel.py:560", contacts_cuda.KERNEL,
         co_err, co_ms, co_plain_ms, co_bytes, co_ops),
        ("substep_solver", "madrona_tpu_torch/csrc/solver.cu",
         "madrona_tpu/ops/solver_pallas.py:709", solver_cuda.KERNEL,
         so_err, so_ms, so_plain_ms, so_bytes, so_ops),
        ("lidar", "madrona_tpu_torch/csrc/lidar.cu",
         "madrona_tpu/ops/lidar_pallas.py:53", lidar_cuda.KERNEL,
         li_err, li_ms, li_plain_ms, li_bytes, li_ops),
    ):
        b_ms, b_by = bound(b, ops)
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches[kernels.index(k)], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
        })
        print(f"{name}: {ms:.4f} ms/launch, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.5f} ms ({b_by}: {b} B, {ops} ops) ({card})")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
