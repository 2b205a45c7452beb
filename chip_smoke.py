#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (madrona_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. the card (nvidia-smi name and power limit) and the kernel build
     (one nvcc per csrc/*.cu source, all seven started together);
  2. the broadphase kernel against its plain PyTorch version at 4096
     worlds, on random scenes (caps-saturating ones included, and one of
     64 bodies, MAX_BODIES) and on a real Escape Room body state: every
     field exactly equal;
  3. the lidar kernel against its plain version at the Escape Room shape
     (4096 worlds, 20 boxes, 2 agents x 30 rays): max abs diff <= 1e-5;
  4. the contacts kernel against its plain version at 4096 worlds, on a
     real Escape Room state and on a crowded scene of rotated, scaled
     boxes on a plane (caps 8/8/0, live hull-hull face and edge
     contacts), in both SAT tiers: ref, alt, num equal; normal, average
     point, penetration within 1e-4 on ok lanes; manifold points within
     1e-3, unordered;
  5. the substep-solver kernel against its plain version at 4096 worlds,
     on the Escape Room state with grab joints on in part of the worlds
     and on the crowded scene's contacts: all 33 output fields within
     pose 1e-3, velocity 5e-2, angular velocity 2e-1; static rows
     bit-equal to their inputs;
  6. the hull-hull record kernel (B6, and B7 in the edge_pairs tier)
     against its plain version at 4096 worlds, in both SAT tiers, on the
     Escape Room state and the crowded scene: ref, alt, num equal;
     normal within 1e-4 on live lanes; points within 1e-3, unordered;
  7. the fused-step kernel (B8) against its plain version with phase 5's
     tolerances, static rows bit-equal to their inputs: on the Escape
     Room state with joints at 4096 worlds and on a scene of a plane, two
     box sizes and spheres with hull-hull, hull-plane and sphere lanes
     live at 4096 worlds (the Hide & Seek scene follows in phase 11);
  8. the main path: make_sim(EscapeRoom(), 4096 worlds, seed 0) on the
     card, stepped with seeded random actions; every export finite, each
     of the four kernels launched once per step, a fresh sim with the
     same seed bit-identical; env-steps/s; ms per taskgraph node;
  9. the same env at 8 worlds on the card against the port's CPU path;
     and, with the kernels' libraries and the compiler taken away, a step
     on the card raises (no fallback to the plain versions);
 10. the raycast kernel against its plain version: on a real Hide & Seek
     state at 1024 worlds x 4 views x 64 x 64 rays (flat colours, as the
     dense render tier runs it) and on synthetic planes with the shadow,
     light and material options at 256 views: all eight planes within
     RAY_TOL (expected: equal);
 11. the broadphase, contacts, solver and fused-step kernels against
     their plain versions on an arranged Hide & Seek state at 16,384
     worlds (ramp wedges in contact, 4 joint slots, a locked box in half
     the worlds), with phase 2, 4 and 5's tolerances;
 12. Hide & Seek's two launches: make_sim(HideSeek(render_size=64), 1024
     worlds) through ("step", "render"), and make_sim(HideSeek(pixels=
     False), 16,384 worlds) through ("step",), 20 steps of seeded random
     actions each: exports finite and of the expected shapes, broadphase,
     contacts, solver (and raycast) launched once per step each and the
     lidar not at all, a fresh sim bit-identical, ms per node, env-steps/s;
 13. Hide & Seek at 8 worlds on the card against the port's CPU path: int
     exports equal, float exports within SMALL_TOL, pixels differing by
     more than PIX_TOL at under PIX_FRAC of the pixels; and, with the
     raycast library and the compiler taken away, a render step raises;
 14. the physics tiers of this slice at full width, 20 steps of seeded
     random actions each, every kernel's launches counted: Escape Room
     with megakernel_fused (B1, B8, B4 once per step; no B2, B3), Hide &
     Seek state only with it (B1, B8), Escape Room with narrowphase=
     "kernel_sublane" (B1, B6, B3, B4) and "kernel" (B1, B7, B3, B4);
     exports finite, a fresh sim bit-identical, ms per node,
     env-steps/s; then the split and the fused Escape Room step timed in
     turns (split, fused, fused, split);
 15. the fused Escape Room at 8 worlds on the card against the port's CPU
     path; and, with the fused library and the compiler taken away, a
     fused step raises;
 16. per-kernel times (CUDA events) beside their bounds, as one JSON line
     of all eight kernels; B1, B2, B3 and B8 also at Hide & Seek's
     shape with their bounds there; B5's bound counts the live rows, and
     its bound over every row is printed beside it. Each kernel has two
     times: "wrapper ms" (timed: events around the calls as the host
     enqueues them, the host's pace where its work per call outlasts the
     kernel) and "device ms" (timed_device: the calls enqueued behind a
     sleep kernel, so the card runs them back to back; it raises if the
     host fell behind). The contacts kernel is also timed on its
     hull-hull and its hull-plane candidates alone, and on the crowded
     scene in both SAT tiers. After the build, each
     kernel's registers, stack frame and local memory (cuobjdump).

Any failure raises (non-zero exit). The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs CUDA and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import functools
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
HS_W = 1024               # Hide & Seek with pixels (render_size 64)
HS_STATE_W = 16384        # Hide & Seek state only: the repo's bench count
HS_RENDER = 64
RAY_TOL = 1e-5            # raycast kernel vs plain version, every plane
RAY_SYN_WV = 256          # views of the synthetic option-set planes
PIX_TOL, PIX_FRAC = 0.02, 0.002   # card vs CPU: rgb / depth per pixel
TIMING_ITERS = 200
DEVICE_ITERS = 100        # calls a device-only timing enqueues behind a sleep
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
# raycast (csrc/raycast.cu). Per (ray, triangle) primary test ~30 (three
# 3-term dot products 15, abs, sign folds 2, division, t, six compares
# and their ands, the running minimum); the shadow test ~28 more where on
# (three dot products 15, three affine terms 6, add, five compares and
# ands). Per ray ~40 (16 attribute reads, shade 6, compose and sky select
# 9, eight plane writes), ~90 more with materials (uv 8, texel addresses
# ~40, 12 taps and their weights 36).
# hull-hull record (csrc/hh_narrowphase.cu): the contacts kernel's
# hull-hull lane, so HH_OPS_* in the edge_dirs tier. In the edge_pairs
# tier a candidate costs ~19,600 up to its separation test: two hulls
# 1,650, face queries 672, 24 edges to world space (2 points x 36, 2
# normals x 85: ~240 each, 5,800), 144 pairs x ~80 (Gauss-map test 38,
# cross and length 14, normalize 5, orientation 8, separation 8, the
# running best 7); its edge contact ~60 (no witness sweep).
HH_OPS_CANDIDATE_PAIRS = 19600
HH_OPS_EDGE_PAIRS = 60
# fused step (csrc/fused_step.cu): the predicted-pose integrate ~200 per
# body; the lanes as above; a sphere lane ~3,100 against a hull (hull 825,
# face distances 42, vertices 64, 12 edges x ~50, 6 faces x ~260, tail
# 40), ~40 against a plane, ~30 against a sphere; then the solver's
# counts over all rows.
SPHERE_OPS_HULL = 3100
SPHERE_OPS_PLANE = 40
SPHERE_OPS_SPHERE = 30
RAY_OPS_PAIR = 30
RAY_OPS_PAIR_SHADOW = 28
RAY_OPS_RAY = 40
RAY_OPS_RAY_MATERIALS = 90


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def timed(fn, iters=TIMING_ITERS, warmup=5):
    """Mean ms of fn() over iters launches (CUDA events, after warm-up).
    The events bracket the host's enqueueing too: where a call's host
    work (checks, allocations, the ctypes call) outlasts its kernel, this
    is the host's pace ("wrapper ms")."""
    import torch

    for _ in range(warmup):
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


@functools.lru_cache(maxsize=None)
def sleep_cycles_per_ms() -> float:
    """Clock cycles that torch.cuda._sleep spins in one ms on this card
    (measured once, over a 20 ms sleep)."""
    import torch

    cycles = 20_000_000
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def timed_device(fn, iters=DEVICE_ITERS, warmup=5):
    """Mean device-only ms of fn() over iters calls ("device ms"): a sleep
    kernel holds the stream while the host enqueues all the calls, so the
    card runs them back to back and the events time the card alone. The
    sleep lasts twice the calls' measured enqueue time plus 2 ms. Raises
    if the start event had completed when the host finished enqueueing
    (the card reached the calls first: a host-paced time)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2.0 * enqueue_ms + 2.0) * sleep_cycles_per_ms()))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    ahead = not start.query()
    torch.cuda.synchronize()
    if not ahead:
        raise AssertionError("timed_device: the card reached the timed "
                             "calls before the host had enqueued them all")
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters=TIMING_ITERS, warmup=5):
    """(wrapper ms, device ms) of fn(): timed, then timed_device with at
    most DEVICE_ITERS calls."""
    return (timed(fn, iters, warmup),
            timed_device(fn, min(iters, DEVICE_ITERS), warmup))


def resource_usage(libs):
    """Print each kernel's registers, stack frame, shared and local memory
    from cuobjdump --dump-resource-usage of its built library, a line per
    kernel (the spill bytes are nvcc's report, printed at the build)."""
    tool = "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        tool = "cuobjdump"
    for src, lib in libs.items():
        try:
            out = subprocess.run([tool, "--dump-resource-usage", str(lib)],
                                 capture_output=True, text=True, timeout=120)
        except OSError as e:
            print(f"  resources {src}: {e}")
            continue
        fn, shown = None, 0
        for line in out.stdout.splitlines():
            line = line.strip()
            if line.startswith("Function "):
                fn = line[len("Function "):].rstrip(":")
            elif line.startswith("REG:") and fn:
                print(f"  resources {src} {fn}: {line}")
                shown += 1
        if not shown:
            print(f"  resources {src}: cuobjdump rc {out.returncode}: "
                  f"{(out.stdout + out.stderr).strip()[-400:]}")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def referenced_row_bytes(poses, obj, *cands) -> int:
    """Bytes of poses [N, F, W] and obj [N, W] that a narrowphase kernel
    must read: the rows that a live candidate of ``cands`` ([W, P, 2]
    rows, sentinel N) names, each (row, world) once."""
    import torch

    n, f, w = poses.shape
    used = torch.zeros((n + 1, w), dtype=torch.bool, device=poses.device)
    worlds = torch.arange(w, device=poses.device)
    for c in cands:
        live = (c[..., 0] < n) & (c[..., 1] < n)                # [W, P]
        for side in (0, 1):
            rows = torch.where(live, c[..., side], n).long()
            used[rows, worlds[:, None].expand_as(rows)] = True
    return int(used[:n].sum()) * (f * poses.element_size()
                                  + obj.element_size())


def live_lane_bytes(ref, alt, con, pts, num) -> int:
    """Bytes of contact tables [.., C, W] that a solver must read: every
    lane's count, and the rows, reduced contact and points of the live
    lanes."""
    per_lane = (ref.element_size() + alt.element_size()
                + con.shape[0] * con.element_size()
                + pts.shape[0] * pts.element_size())
    return nbytes(num) + int((num > 0).sum()) * per_lane


def broadphase_cost(pack, cands):
    """(bytes, operations) of one broadphase launch: the body pack in,
    the candidate lists out; every body transformed, every pair tested."""
    _, n, w = pack.shape
    b = nbytes(pack, *[getattr(cands, f) for f in (
        "hh", "hh_num", "hp", "hp_num", "sp", "sp_num", "sp_kind",
        "overflow")])
    return b, w * (BP_OPS_PER_BODY * n + BP_OPS_PER_PAIR * n * (n - 1) // 2)


def contacts_cost(c_in, om, c_out, cnt):
    """(bytes, operations) of one contacts launch on inputs c_in (hh, hp,
    poses, obj) with outputs c_out and the scene's lane counts (from
    check_contacts): the pose rows a live candidate names, the hull
    tables, the tables out; the live lanes' arithmetic."""
    b = (nbytes(c_in[0], c_in[1], om.hull_pack, om.hull_dirs_pack, *c_out)
         + referenced_row_bytes(c_in[2], c_in[3], c_in[0], c_in[1]))
    ops = (HH_OPS_CANDIDATE * cnt["hh_candidates"]
           + HH_OPS_FACE * (cnt["hh_live"] - cnt["hh_1pt"])
           + HH_OPS_EDGE * cnt["hh_1pt"]
           + HP_OPS_CANDIDATE * cnt["hp_candidates"]
           + HP_OPS_CONTACT * cnt["hp_live"])
    return b, ops


def contacts_split(name, c_in, om, card):
    """Device ms of the contacts kernel on the hull-hull candidates alone
    (no hull-plane slot) and on the hull-plane candidates alone: how its
    time divides between the two lane kinds."""
    from madrona_tpu_torch.ops import contacts_cuda

    hh, hp, poses, obj = c_in
    hh0, hp0 = hh[:, :0].contiguous(), hp[:, :0].contiguous()
    hh_ms = timed_device(lambda: contacts_cuda.contacts(hh, hp0, poses, obj,
                                                        om))
    hp_ms = timed_device(lambda: contacts_cuda.contacts(hh0, hp, poses, obj,
                                                        om))
    print(f"contacts at the {name} shape, device ms: hull-hull lanes alone "
          f"(P={hh.shape[1]}) {hh_ms:.4f}, hull-plane lanes alone "
          f"(P={hp.shape[1]}) {hp_ms:.4f} ({card})")


def solver_cost(cfg, state, param, c_out, jargs, cnt, n_joints, s_out):
    """(bytes, operations) of one substep-solver launch: state, params,
    joints and out once, the live contact lanes; per substep every row
    of the dynamic range, each ok contact, live manifold point and live
    joint."""
    import torch

    b = nbytes(state, param, *jargs, s_out) + live_lane_bytes(*c_out)
    live_points = int(torch.where(c_out[2][7] > 0.5, c_out[4], 0).sum())
    n, w = state.shape[1:]
    d0, d1 = cfg.solver_dynamic_range or (0, n)
    ops = cfg.substeps * (
        SOLVER_OPS_BODY * (d1 - d0) * w
        + (SOLVER_OPS_CONTACT_POS * cfg.jacobi_iters + SOLVER_OPS_CONTACT_VEL)
        * cnt["ok"]
        + SOLVER_OPS_POINT * live_points
        + SOLVER_OPS_JOINT * n_joints)
    return b, ops


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
        ("bodies_64", om_rand, random_scene(np.random.RandomState(4),
                                            om_rand, 4, 64, False),
         bp.CandidateCaps(hull_hull=96, hull_plane=64, sphere_any=96),
         False),
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


def compare_tables(what, name, got, ref):
    """Contact tables (ref, alt, con, pts, num) [.., C, W] of a kernel
    against its plain version's: rows, counts and ok flags equal; on ok
    lanes the reduced contact (normal, average point, largest
    penetration) within CON_TOL and the manifold points within PTS_TOL,
    unordered. Returns (con difference, points difference)."""
    import torch

    for f, a, b in zip(("ref", "alt", "con", "pts", "num"), got, ref):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{what} {name}: {f} shape/dtype differs")
    for i, f in ((0, "ref"), (1, "alt"), (4, "num")):
        if not torch.equal(got[i], ref[i]):
            bad = int((got[i] != ref[i]).sum())
            raise AssertionError(
                f"{what} {name}: {f} differs in {bad} of "
                f"{got[i].numel()} lanes")
    ok = ref[2][7] > 0.5
    if not torch.equal(got[2][7], ref[2][7]):
        raise AssertionError(f"{what} {name}: ok flags differ")
    con_err = float(torch.where(ok[None], (got[2] - ref[2]).abs(),
                                0.0).max())
    num_ok = torch.where(ok, ref[4], 0).cpu().numpy()
    pts_err = float(np.abs(
        sorted_points(got[3].cpu().numpy(), num_ok)
        - sorted_points(ref[3].cpu().numpy(), num_ok)).max())
    if not con_err <= CON_TOL:
        raise AssertionError(f"{what} {name}: con {con_err} > {CON_TOL}")
    if not pts_err <= PTS_TOL:
        raise AssertionError(f"{what} {name}: pts {pts_err} > {PTS_TOL}")
    return con_err, pts_err


def check_contacts(name, args, om, n_hh, want_face_and_edge,
                   edge_dirs=True):
    """Phase 4 on one scene, in one SAT tier (edge_dirs, else edge
    pairs). Returns (kernel outputs, largest float difference, the
    scene's lane counts for the operation count)."""
    import torch
    from madrona_tpu_torch.ops import contacts_cuda

    got = contacts_cuda.contacts(*args, om, edge_dirs)
    ref = contacts_cuda.contacts_plain(*args, om, edge_dirs)
    torch.cuda.synchronize()
    con_err, pts_err = compare_tables("contacts", name, got, ref)
    num = ref[4]
    ok = ref[2][7] > 0.5
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
    print(f"contacts kernel vs plain [{name}]: W={num.shape[1]} "
          "ref/alt/num equal; "
          f"con max_abs_diff={con_err!r} pts max_abs_diff={pts_err!r}; "
          + " ".join(f"{k}={v}" for k, v in counts.items()))
    if want_face_and_edge and not (counts["hh_4pt"] > 0
                                   and counts["hh_1pt"] > 0):
        raise AssertionError(f"contacts {name}: no live hull-hull face "
                             "and edge contacts")
    return got, max(con_err, pts_err), counts


def check_solver(name, cfg, state, param, cargs, jargs):
    """Phase 5 on one scene. Returns the largest difference."""
    import torch
    from madrona_tpu_torch.ops import solver_cuda

    got = solver_cuda.substep_solver(cfg, state, param, *cargs, *jargs)
    ref = solver_cuda.substep_solver_plain(cfg, state, param, *cargs,
                                           *jargs)
    torch.cuda.synchronize()
    return compare_steps("solver", name, got, ref, state, param,
                         cfg.solver_dynamic_range)


def compare_steps(what, name, got, ref, state, param, dyn_range):
    """A step kernel's out [33, N, W] against its plain version's: every
    field within its tolerance, static rows (and rows outside the
    dynamic range) bit-equal to their inputs, something moved. Returns
    the largest absolute difference."""
    import torch

    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what} {name}: bad shape or not finite")
    fields = (("pos", 0, 3, POSE_TOL), ("rot", 3, 7, POSE_TOL),
              ("vel", 7, 10, VEL_TOL), ("omega", 10, 13, OMEGA_TOL),
              ("prev_x", 13, 16, POSE_TOL), ("prev_q", 16, 20, POSE_TOL),
              ("presolve_x", 20, 23, POSE_TOL),
              ("presolve_q", 23, 27, POSE_TOL),
              ("presolve_v", 27, 30, VEL_TOL),
              ("presolve_w", 30, 33, OMEGA_TOL))
    diffs = {f: float((got[lo:hi] - ref[lo:hi]).abs().max())
             for f, lo, hi, _ in fields}
    print(f"{what} kernel vs plain [{name}]: W={got.shape[2]} max_abs_diff "
          + " ".join(f"{k}={v!r}" for k, v in diffs.items()))
    # how heavy the tail is: worlds where some field is off by more than a
    # tenth of its tolerance (a contact branch taken the other way)
    rel = torch.stack([
        (got[lo:hi] - ref[lo:hi]).abs().amax(dim=(0, 1)) / tol
        for _, lo, hi, tol in fields]).amax(dim=0)
    print(f"{what} kernel vs plain [{name}]: {int((rel > 0.1).sum())} of "
          f"{got.shape[2]} worlds differ by more than a tenth of a tolerance")
    for f, _, _, tol in fields:
        if not diffs[f] <= tol:
            raise AssertionError(f"{what} {name}: {f} {diffs[f]} > {tol}")
    static = param[8] > 0.5                               # [N, W]
    if dyn_range:
        d0, d1 = dyn_range
        static = static.clone()
        static[:d0] = True
        static[d1:] = True
    same = (
        torch.equal(got[:13][:, static], state[:, static])
        and torch.equal(got[13:20][:, static], state[:7][:, static])
        and torch.equal(got[20:27][:, static], state[:7][:, static])
    )
    if not same:
        raise AssertionError(f"{what} {name}: a static row moved")
    moved = float((got[:3] - state[:3]).abs().max())
    print(f"{what} kernel [{name}]: {int(static.sum())} static rows "
          f"bit-equal to their inputs; largest move {moved:.3g}")
    if not moved > 1e-3:
        raise AssertionError(f"{what} {name}: nothing moved")
    return max(diffs.values())


def check_physics_kernels(probe):
    """Phases 4 to 7. Returns (contacts err, solver err, hull-hull record
    err, fused err, what the timing phase needs of the Escape Room
    scene)."""
    import torch
    from madrona_tpu_torch.models import escape_room as er
    from madrona_tpu_torch.ops import broadphase_cuda, solver_cuda
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
    for name, args, om_, n_hh, want in (
            ("escape_room", er_args, om_er, env.caps.hull_hull, False),
            ("crowded", cr_args, om_cr, caps_cr.hull_hull, True)):
        cr_err = max(cr_err, check_contacts(f"{name} edge_pairs", args, om_,
                                            n_hh, want, False)[1])

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

    # ---- 6: the hull-hull record kernel, both SAT tiers
    hh_err, hh_counts = check_hh_record("escape_room", er_args, om_er)
    cr_hh_err, cr_hh_counts = check_hh_record("crowded", cr_args, om_cr)
    if hh_counts["edge_dirs"]["hh_live"] != er_counts["hh_live"]:
        raise AssertionError("hh record and contacts disagree on the "
                             "Escape Room's live hull-hull lanes")

    # ---- 7: the fused-step kernel on the Escape Room state with joints
    # and on a scene with every lane kind live
    f_cfg = dataclasses.replace(cfg, **FUSED)
    cands = broadphase_cuda.find_candidates_kernel(body, om_er, env.caps,
                                                   cfg.dt)
    f_err, f_args, f_counts = check_fused("escape_room + joints", f_cfg,
                                          body, om_er, cands, jargs)
    om_sp, body_sp, caps_sp = sphere_scene()
    cands_sp = broadphase_cuda.find_candidates_kernel(body_sp, om_sp,
                                                      caps_sp, cfg.dt)
    spheres = {}
    for tier in ("edge_dirs", "edge_pairs"):
        sp_cfg = dataclasses.replace(f_cfg, sat_tier=tier)
        e, sp_args, sp_counts = check_fused(f"spheres {tier}", sp_cfg,
                                            body_sp, om_sp, cands_sp, (),
                                            True)
        f_err = max(f_err, e)
        spheres[tier] = dict(fused_cfg=sp_cfg, fused_args=sp_args,
                             fused_counts=sp_counts, jargs=())
    torch.cuda.synchronize()
    scene = dict(om=om_er, args=er_args, contacts=er_c, counts=er_counts,
                 state=st, param=pr, jargs=jargs, n_joints=n_joints,
                 hh_counts=hh_counts, fused_cfg=f_cfg, fused_args=f_args,
                 fused_counts=f_counts, crowded_args=cr_args,
                 crowded_om=om_cr, crowded_hh_counts=cr_hh_counts,
                 spheres=spheres)
    return (max(er_err, cr_err), s_err, max(hh_err, cr_hh_err), f_err,
            scene)


def physics_route(body, om, env, jargs):
    """The physics node's device work on one body state, as
    physics/api.py strings it together."""
    from madrona_tpu_torch.ops import contacts_cuda, solver_cuda

    cfg = env.cfg
    cargs = contacts_cuda.contacts(*contacts_inputs(body, om, env.caps, cfg),
                                   om)
    state, param = solver_cuda.pack_state(body, om)
    return solver_cuda.substep_solver(cfg, state, param, *cargs, *jargs)


def record_points(rec):
    """The record's points [P, 22, W] -> [16, P, W] rows of 4 x (xyz,
    depth), the contacts kernel's layout (for sorted_points)."""
    p, _, w = rec.shape
    return rec[:, 6:22].reshape(p, 4, 4, w).permute(2, 1, 0, 3).reshape(
        16, p, w)


def check_hh_record(name, args, om):
    """Phase 6 on one scene, in both SAT tiers. Returns (largest float
    difference, lane counts per tier for the operation count)."""
    import torch
    from madrona_tpu_torch.ops import hh_narrowphase_cuda as hhc

    hh, _, poses, obj = args
    n = poses.shape[0]
    worst, counts = 0.0, {}
    for tier, dirs in (("edge_dirs", True), ("edge_pairs", False)):
        got = hhc.hh_record(hh, poses, obj, om, dirs)
        ref = hhc.hh_record_plain(hh, poses, obj, om, dirs)
        torch.cuda.synchronize()
        if got.shape != ref.shape:
            raise AssertionError(f"hh record {name}: shape differs")
        for i, f in ((0, "ref"), (1, "alt"), (2, "num")):
            if not torch.equal(got[:, i], ref[:, i]):
                bad = int((got[:, i] != ref[:, i]).sum())
                raise AssertionError(f"hh record {name} {tier}: {f} differs "
                                     f"in {bad} lanes")
        num = ref[:, 2].to(torch.int32)
        live = num > 0
        nrm_err = float(torch.where(live[:, None], (got[:, 3:6]
                                                    - ref[:, 3:6]).abs(),
                                    0.0).max())
        num_np = num.cpu().numpy()
        pts_err = float(np.abs(
            sorted_points(record_points(got).cpu().numpy(), num_np)
            - sorted_points(record_points(ref).cpu().numpy(), num_np)).max())
        c = {"hh_candidates": int((hh[..., 0] < n).sum()),
             "hh_live": int(live.sum()), "hh_4pt": int((num == 4).sum()),
             "hh_1pt": int((num == 1).sum())}
        counts[tier] = c
        print(f"hh record kernel vs plain [{name} {tier}]: W={num.shape[1]} "
              f"ref/alt/num equal; normal max_abs_diff={nrm_err!r} pts "
              f"max_abs_diff={pts_err!r}; "
              + " ".join(f"{k}={v}" for k, v in c.items()))
        if not nrm_err <= CON_TOL:
            raise AssertionError(f"hh record {name}: normal {nrm_err}")
        if not pts_err <= PTS_TOL:
            raise AssertionError(f"hh record {name}: pts {pts_err}")
        worst = max(worst, nrm_err, pts_err)
    return worst, counts


def fused_args(body, om, cands):
    """The fused-step kernel's arguments before the joints."""
    from madrona_tpu_torch.ops import fused_cuda

    return (*fused_cuda.pack_fused(body, om), cands.hh.contiguous(),
            cands.hp.contiguous(), cands.sp.contiguous(),
            cands.sp_kind.contiguous(), om)


def fused_lane_counts(cfg, args):
    """Live lanes of the fused step's narrowphase by kind, from the plain
    version's first half (integrate, then the tensor narrowphase): the
    scene check and the operation count of the bound."""
    import torch
    from madrona_tpu_torch.ops import solver_cuda
    from madrona_tpu_torch.physics import geo, xpbd
    from madrona_tpu_torch.physics import narrowphase as np_

    state, param, scale, obj, hh, hp, sp, sp_kind, om = args
    body, params = solver_cuda.unpack_state(state, param)
    pred = xpbd.integrate(body, None, cfg.dt / cfg.substeps, cfg.gravity,
                          params)
    ref, _, _, num, _ = np_.narrowphase_lanes(
        pred.pos, pred.rot, scale.permute(2, 1, 0), obj.t(), om, hh, hp, sp,
        sp_kind, sat_dirs=cfg.sat_tier == "edge_dirs")
    n = state.shape[1]
    ph, pp = hh.shape[1], hp.shape[1]
    hh_num, sp_num = num[:, :ph], num[:, ph + pp:]
    kind_live = lambda t: int(((sp_num > 0) & (sp_kind == t)).sum())  # noqa
    kind_cand = lambda t: int(((sp[..., 0] < n) & (sp_kind == t)).sum())  # noqa
    return {
        "hh_candidates": int((hh[..., 0] < n).sum()),
        "hh_live": int((hh_num > 0).sum()), "hh_1pt": int((hh_num == 1).sum()),
        "hp_candidates": int((hp[..., 0] < n).sum()),
        "hp_live": int((num[:, ph:ph + pp] > 0).sum()),
        "sp_hull": kind_cand(geo.TYPE_HULL),
        "sp_plane": kind_cand(geo.TYPE_PLANE),
        "sp_sphere": kind_cand(geo.TYPE_SPHERE),
        "sp_live_hull": kind_live(geo.TYPE_HULL),
        "sp_live_plane": kind_live(geo.TYPE_PLANE),
        "sp_live_sphere": kind_live(geo.TYPE_SPHERE),
        "ok": int((num > 0).sum()), "points": int(num.sum()),
        "movable": int((param[8] <= 0.5).sum()),
    }


def check_fused(name, cfg, body, om, cands, jargs, want_spheres=False):
    """Phase 7 (and 11) on one scene: the kernel's narrowphase lanes
    (its contact tables before the substeps) against the plain
    version's, then its step. Returns (largest difference, the kernel's
    arguments, the scene's lane counts)."""
    import torch
    from madrona_tpu_torch.ops import fused_cuda, solver_cuda

    args = fused_args(body, om, cands)
    got, lanes = fused_cuda.fused_step_lanes(cfg, *args, *jargs)
    ref_lanes = fused_cuda.fused_contacts_plain(cfg, *args)
    ref = fused_cuda.fused_step_plain(cfg, *args, *jargs)
    torch.cuda.synchronize()
    counts = fused_lane_counts(cfg, args)
    print(f"fused scene [{name}]: " + " ".join(
        f"{k}={v}" for k, v in counts.items()))
    if want_spheres and not (counts["hh_live"] and counts["hp_live"]
                             and counts["sp_live_hull"]
                             and counts["sp_live_plane"]
                             and counts["sp_live_sphere"]):
        raise AssertionError(f"fused {name}: not every lane kind is live")
    con_err, pts_err = compare_tables("fused lanes", name, lanes, ref_lanes)
    ok = ref_lanes[2][7] > 0.5
    nrm_err, avg_err, pen_err = (
        float(torch.where(ok[None], (lanes[2][lo:hi] - ref_lanes[2][lo:hi])
                          .abs(), 0.0).max())
        for lo, hi in ((0, 3), (3, 6), (6, 7)))
    print(f"fused lanes vs plain [{name}]: ref/alt/num/ok equal on "
          f"{ok.numel()} lanes; normal max_abs_diff={nrm_err!r} average "
          f"point {avg_err!r} penetration {pen_err!r} points {pts_err!r}")
    err = compare_steps("fused", name, got, ref, args[0], args[1], None)
    # where the step's difference arises: the plain substep solver on the
    # kernel's own lanes against the kernel's step
    spec = dataclasses.replace(cfg, solver_dynamic_range=None,
                               solver_ref_dyn_lanes=0)
    on_lanes = solver_cuda.substep_solver_plain(spec, args[0], args[1],
                                                *lanes, *jargs)
    print(f"fused kernel vs the plain substeps on its own lanes [{name}]: "
          f"max_abs_diff {float((got - on_lanes).abs().max())!r}, the "
          f"plain step vs the same {float((ref - on_lanes).abs().max())!r}")
    return max(err, con_err, pts_err), args, counts


def sphere_scene():
    """(om, BodyState [W, 21], caps): a plane, two box sizes and spheres,
    rotated and scaled, crowded (the JAX package's fused_case objects);
    caps 8/8/8."""
    from madrona_tpu_torch.physics import bodies as pb
    from madrona_tpu_torch.physics import broadphase as bp
    from madrona_tpu_torch.physics import geo

    reg = pb.ObjectRegistry()
    reg.add_plane()
    reg.add_hull(geo.box_hull((0.5, 0.5, 0.5)), mass=1.0)
    reg.add_hull(geo.box_hull((0.4, 0.8, 0.3)), mass=2.5)
    reg.add_sphere(0.45, mass=0.8)
    om = reg.build().to(DEV)
    body = random_scene(np.random.RandomState(23), om, 4, 21, True)
    return om, body, bp.CandidateCaps(hull_hull=8, hull_plane=8, sphere_any=8)


# the physics tiers of this slice, as PhysicsConfig changes of an env
FUSED = dict(megakernel_fused=True, megakernel=False, narrowphase="xla")
SUBLANE = dict(narrowphase="kernel_sublane")
LANE_MAJOR = dict(narrowphase="kernel")


def with_physics(env, **change):
    """``env`` with its PhysicsConfig changed, as the JAX package's tests
    change it."""
    env.cfg = dataclasses.replace(env.cfg, **change)
    return env


def check_no_fallback(sim, kernels, launch=None, label=None):
    """With the library of every kernel in ``kernels`` unloaded, missing
    on disk and no compiler to be found, a step of ``sim`` (on the card)
    over ``launch`` must raise: it may not go on with the plain
    versions."""
    import torch
    from madrona_tpu_torch.ops import cuda_build

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    saved = (cuda_build._nvcc, cuda_build.library_path,
             [k._fn for k in kernels])
    w = sim.executor.num_worlds
    what = label or f"{sim.env.name} {launch or sim.env.default_launch}"
    try:
        cuda_build._nvcc = no_nvcc
        cuda_build.library_path = (
            lambda src: cuda_build.BUILD_DIR / f"missing-{src}.so")
        for k in kernels:
            k._fn = None
        try:
            sim.step({"action": torch.zeros((w,) + sim.env.action_shape,
                                            dtype=torch.int32, device=DEV),
                      "reset": torch.zeros((w,), dtype=torch.int32,
                                           device=DEV)}, launch=launch)
        except RuntimeError as e:
            print(f"no fallback [{what}]: without "
                  f"{', '.join(k.source for k in kernels)} the step raises "
                  f"({e})")
        else:
            raise AssertionError(f"{what} ran without its kernels")
    finally:
        cuda_build._nvcc, cuda_build.library_path = saved[:2]
        for k, fn in zip(kernels, saved[2]):
            k._fn = fn


def run_main_path(make_sim, make_env, acts, counters, w=None):
    """A main path: step a fresh sim of ``make_env()`` at ``w`` worlds
    through its default launch, with every counter of ``counters`` set to
    0 first; returns (sim, per-step exports, seconds of steps 2..STEPS,
    the counters' launches in this run)."""
    import torch

    w = W if w is None else w
    sim = make_sim(make_env(), num_worlds=w, seed=0, device=DEV)
    reset = torch.zeros((w,), dtype=torch.int32, device=DEV)
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

    nodes = [n for g in sim.env.default_launch
             for n in sim.executor.graphs[g].nodes]
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
        reset = torch.zeros((sim.executor.num_worlds,), dtype=torch.int32,
                            device=DEV)
        for i in range(steps):
            sim.step({"action": acts[i], "reset": reset})
    finally:
        for n, fn in zip(nodes, saved):
            n.fn = fn
    return {k: v / steps for k, v in totals.items()}


def arrange_hide_seek(sim):
    """The sim's Hide & Seek state arranged so that the physics kernels
    see what the env can give them: a box on a ramp's low end, an agent
    on a ramp's slope, an agent against a ramp's triangular side, a box
    against a wall (each with a little seeded jitter); box 0 locked (a
    static row inside the solver's dynamic range) in the even worlds;
    seeker 0 holding box 2 by a fixed joint in slot 2 of every fourth
    world, the other slots inactive with e1 = e2 = -1; random kicks."""
    import dataclasses

    import torch
    from madrona_tpu_torch.models import hide_seek as hs
    from madrona_tpu_torch.physics import api as papi
    from madrona_tpu_torch.physics import xpbd

    state = sim.state
    w = sim.executor.num_worlds
    rs = np.random.RandomState(31)
    dev_t = lambda a: torch.from_numpy(                      # noqa: E731
        np.asarray(a, np.float32)).to(sim.device)
    t = state.tables[hs.RIGID_BODY]
    c = dict(t.columns)
    pos, rot = c["Position"].clone(), c["Rotation"].clone()
    place = {
        hs.ROW_RAMP0: (0.0, 0.0, 0.0), hs.ROW_RAMP0 + 1: (6.0, 0.0, 0.0),
        hs.ROW_BOX0: (1.5, 0.2, 0.9), hs.ROW_BOX0 + 1: (-19.15, 3.0, 0.9),
        hs.ROW_BOX0 + 2: (-18.0, -16.6, 0.9),
        hs.ROW_AGENT0: (6.3, 0.0, 1.1), hs.ROW_AGENT0 + 1: (-0.5, 1.45, 0.8),
        hs.ROW_AGENT0 + 2: (-18.0, -18.0, 0.8),
        hs.ROW_AGENT0 + 3: (10.0, 10.0, 0.8),
    }
    for row, xyz in place.items():
        jit = rs.uniform(-0.05, 0.05, (w, 3)) * [1.0, 1.0, 0.0]
        pos[:, row] = dev_t(np.asarray(xyz) + jit)
    yaw = rs.uniform(-0.3, 0.3, (w, hs.N_MOVABLE))
    zero = np.zeros_like(yaw)
    rot[:, hs.ROW_BOX0:hs.ROW_BOX0 + hs.N_MOVABLE] = dev_t(np.stack(
        [np.cos(yaw / 2), zero, zero, np.sin(yaw / 2)], -1))
    rot[:, hs.ROW_AGENT0 + 2] = dev_t([1.0, 0.0, 0.0, 0.0])
    dyn = (np.arange(hs.N_BODIES) >= hs.ROW_BOX0)[None, :, None]
    kick = lambda sc: dev_t(                                 # noqa: E731
        sc * rs.randn(w, hs.N_BODIES, 3) * dyn)
    resp = c["ResponseType"].clone()
    resp[0::2, hs.ROW_BOX0] = xpbd.RESPONSE_STATIC
    c.update(Position=pos, Rotation=rot, ResponseType=resp,
             Velocity={"linear": kick(0.5), "angular": kick(0.3)},
             ExternalForce=kick(1.0))
    tables = dict(state.tables)
    tables[hs.RIGID_BODY] = dataclasses.replace(t, columns=c)
    singles = dict(state.singletons)
    jb = {k: v.clone() for k, v in singles[papi.JOINT_BUFFER].items()}
    jb["e1"][:] = -1
    jb["e2"][:] = -1
    jb["active"][:] = False
    fourth = slice(0, w, 4)
    jb["e1"][fourth, 2] = hs.ROW_AGENT0 + 2
    jb["e2"][fourth, 2] = hs.ROW_BOX0 + 2
    jb["jtype"][:] = 0
    jb["r1"][fourth, 2] = dev_t([0.0, 0.7, 0.1])
    jb["r2"][fourth, 2] = dev_t([0.0, -0.7, 0.0])
    jb["attach_q1"][..., 0] = 1.0
    jb["attach_q2"][..., 0] = 1.0
    jb["active"][fourth, 2] = True
    singles[papi.JOINT_BUFFER] = jb
    return dataclasses.replace(state, tables=tables, singletons=singles)


def check_hide_seek_physics(sim):
    """Phase 11: B1, B2, B3 and B8 against their plain versions on the
    arranged Hide & Seek state. Returns (largest differences of the
    four, what the timing phase needs)."""
    import torch
    from madrona_tpu_torch.models import hide_seek as hs
    from madrona_tpu_torch.ops import broadphase_cuda, solver_cuda
    from madrona_tpu_torch.physics import api as papi
    from madrona_tpu_torch.physics import broadphase as bp

    env, cfg = sim.env, sim.env.cfg
    om = env.om.to(DEV)
    state = arrange_hide_seek(sim)
    body = papi.body_state(sim.executor.sm, state)
    w = body.pos.shape[0]

    got = broadphase_cuda.find_candidates_kernel(body, om, env.caps, cfg.dt)
    ref = bp.find_candidates(body, om, env.caps, cfg.dt)
    torch.cuda.synchronize()
    for f in ("hh", "hh_num", "hp", "hp_num", "sp", "sp_num", "sp_kind",
              "overflow"):
        if not torch.equal(getattr(got, f), getattr(ref, f)):
            raise AssertionError(f"broadphase hide_seek: field {f} differs")
    n_locked = int((body.response[:, hs.ROW_BOX0] == 2).sum())
    print(f"broadphase kernel == plain [hide_seek]: W={w} "
          f"hh={int(got.hh_num.sum())} hp={int(got.hp_num.sum())} "
          f"overflow_worlds={int(got.overflow.sum())} "
          f"locked_boxes={n_locked}")
    if int(got.hh_num.sum()) < 3 * w or int(got.overflow.sum()):
        raise AssertionError("broadphase hide_seek: scene not as arranged")

    c_args = contacts_inputs(body, om, env.caps, cfg)
    c_out, co_err, counts = check_contacts("hide_seek", c_args, om,
                                           env.caps.hull_hull, False)
    co_err = max(co_err, check_contacts("hide_seek edge_pairs", c_args, om,
                                        env.caps.hull_hull, False, False)[1])
    if counts["hh_live"] < 2 * w:
        raise AssertionError("contacts hide_seek: too few live wedge lanes")
    st, pr = solver_cuda.pack_state(body, om)
    jargs = solver_cuda.pack_joints(papi.joints_view(state), hs.N_BODIES)
    so_err = check_solver("hide_seek + joint", cfg, st, pr, c_out, jargs)
    n_joints = int((jargs[2][21] > 0.5).sum())
    print(f"solver scenes: hide_seek has {n_joints} live joints in {w} "
          f"worlds, {4 * w - n_joints} inactive slots")
    f_cfg = dataclasses.replace(cfg, **FUSED)
    fu_err, f_args, f_counts = check_fused("hide_seek + joint", f_cfg, body,
                                           om, got, jargs)
    return (0.0, co_err, so_err, fu_err), dict(
        body=body, om=om, c_args=c_args, c_out=c_out, counts=counts,
        state=st, param=pr, jargs=jargs, n_joints=n_joints,
        fused_cfg=f_cfg, fused_args=f_args, fused_counts=f_counts)


def raycast_compare(name, planes, opts):
    """The raycast kernel against its plain version on one set of
    planes. Returns (largest difference over all planes, kernel out)."""
    import torch
    from madrona_tpu_torch.ops import raycast_cuda as rck

    got = rck.raytrace(*planes, **opts)
    ref = rck.raytrace_plain(*planes, **opts)
    torch.cuda.synchronize()
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"raycast {name}: bad shape or not finite")
    d = (got - ref).abs().amax(dim=(0, 2)).tolist()
    hits = float((ref[:, rck.O_T] < opts["t_max"]).float().mean())
    n_diff = int(((got - ref).abs() > RAY_TOL).any(dim=1).sum())
    print(f"raycast kernel vs plain [{name}]: WV={got.shape[0]} "
          f"T_pad={planes[0].shape[1]} R_pad={got.shape[2]} max_abs_diff "
          f"rgb={max(d[0:3])!r} depth={d[3]!r} occ={d[4]!r} "
          f"uv={max(d[5:7])!r}; hit share {hits:.3f}, occluded share "
          f"{float(ref[:, rck.O_OCC].mean()):.3f}, rays differing {n_diff}")
    if not max(d) <= RAY_TOL:
        raise AssertionError(f"raycast {name}: {max(d)} > {RAY_TOL}")
    return max(d), got


def synthetic_ray_planes(rs, wv, t_pad, r_pad, tex, device):
    """Random raycast inputs (setup, attrs, dl, atlas) on ``device`` with
    exact ties, disabled shadow rows and dead rows; the CPU tests make
    theirs with this function too. The last four rows are padding."""
    import torch
    from madrona_tpu_torch.ops import raycast_cuda as rck
    from madrona_tpu_torch.render import kernel as rkernel
    from madrona_tpu_torch.render.raycast import RenderConfig

    t = t_pad - 4
    setup = np.zeros((wv, t_pad, rck.PS), np.float32)
    setup[:, :t] = rs.randn(wv, t, rck.PS)
    setup[:, :t, 9] *= 20.0
    setup[:, :t, 22] = 6.0 * np.abs(setup[:, :t, 22])
    setup[:, :t, 23] = 2e-2 * setup[:, :t, 22]
    setup[:, 3:t:7, 22:24] = 0.0
    setup[:, 20:26] = setup[:, 8:14]
    setup[:, 30] = 0.0
    attrs = np.zeros((wv, rck.FA, t_pad), np.float32)
    attrs[:, :, :t] = rs.rand(wv, rck.FA, t)
    attrs[:, rck.A_TEX, :t] = rs.randint(-1, 2, (wv, t))
    attrs[:, rck.A_UV0X:rck.A_DU2Y + 1, :t] = rs.uniform(-2, 2, (wv, 6, t))
    attrs[:, 15] = 0.0
    side = int(round(r_pad ** 0.5))
    dl, _ = rkernel._local_dir_grid(RenderConfig(width=side, height=side))
    atlas = rs.rand(3 * tex, 2 * tex).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device)
                 for x in (setup, attrs, dl, atlas))


def check_raycast(sim):
    """Phase 8. Returns (largest difference, the real scene's planes and
    options for the timing phase)."""
    from madrona_tpu_torch.render import kernel as rkernel

    env = sim.env
    planes, opts, n_rays = rkernel.kernel_inputs(
        env.rcfg, *env.rsys.render_inputs(sim.state))
    if opts["shadows"] or opts["use_lights"] or opts["use_materials"]:
        raise AssertionError("the dense tier runs flat colours")
    if planes[0].shape[0] != HS_W * 4 or n_rays != HS_RENDER ** 2:
        raise AssertionError(f"raycast shapes {planes[0].shape}, {n_rays}")
    worst, _ = raycast_compare("hide_seek flat", planes, opts)
    rs = np.random.RandomState(41)
    tex = 8
    for i, (name, sh, li, ma) in enumerate((
            ("shadows", True, False, False),
            ("lights+shadows", True, True, False),
            ("materials+lights", False, True, True),
            ("materials+shadows", True, False, True))):
        syn = synthetic_ray_planes(rs, RAY_SYN_WV, planes[0].shape[1],
                                   planes[2].shape[1], tex, DEV)
        o = dict(t_max=50.0, shadows=sh, use_lights=li, use_materials=ma,
                 ambient=0.35, shadow_ambient=0.3, sky=(0.1, 0.2, 0.4),
                 tex_size=tex)
        worst = max(worst, raycast_compare(f"synthetic {name}", syn, o)[0])
    return worst, (planes, opts, n_rays)


def check_exports(outs, shapes, what):
    """Every float export of every step finite; the last step's shapes."""
    import torch

    for i, out in enumerate(outs):
        for name, v in out.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{what} step {i}: {name} not finite")
    for name, shape in shapes.items():
        if tuple(outs[-1][name].shape) != shape:
            raise AssertionError(
                f"{what}: {name} shape {tuple(outs[-1][name].shape)}")


def check_path(make_sim, make_env, w, counters, want, what, shapes, card):
    """Phases 12 and 14 for one path: the counted run (each counter's
    launches must equal its ``want``), its checks, a fresh sim's
    bit-identical rerun, ms by node. Returns (sim, per-step exports,
    env-steps/s, ms/step, launches)."""
    import torch

    acts = make_env().random_actions(np.random.RandomState(0), STEPS, w)
    acts = acts.to(DEV)
    sim, outs, secs, launches = run_main_path(make_sim, make_env, acts,
                                              counters, w)
    for k, n, must in zip(counters, launches, want):
        print(f"{what}: {k.symbol} launched {n} times in {STEPS} steps")
        if n != must:
            raise AssertionError(f"{what}: {k.symbol} {n} launches != {must}")
    check_exports(outs, shapes, what)
    sps = w * (STEPS - 1) / secs
    ms = secs * 1e3 / (STEPS - 1)
    print(f"{what}: {w} worlds x {STEPS} steps through "
          f"{sim.env.default_launch}, exports finite; {ms:.2f} ms/step, "
          f"{sps:.1f} env-steps/s ({card})")
    _, outs2, _, _ = run_main_path(make_sim, make_env, acts, [], w)
    for i, (a, b) in enumerate(zip(outs, outs2)):
        for name in a:
            if not torch.equal(a[name], b[name]):
                raise AssertionError(f"{what} step {i}: {name} differs "
                                     "across fresh sims")
    print(f"{what}: a fresh sim with the same seed is bit-identical")
    per_node = node_times(sim, acts)
    print(f"{what}, ms/step by node (synchronized): " + ", ".join(
        f"{k} {v * 1e3:.2f}" for k, v in per_node.items()) + f" ({card})")
    return sim, outs, sps, ms, launches


def check_card_vs_cpu(make_sim, make_env, what):
    """Phases 9 and 15: ``make_env()`` at 8 worlds on the card against the
    port's CPU path: int exports equal, float exports within SMALL_TOL."""
    import torch

    acts = make_env().random_actions(np.random.RandomState(5), SMALL_STEPS,
                                     SMALL_W)
    sims = {d: make_sim(make_env(), num_worlds=SMALL_W, seed=3, device=d)
            for d in ("cpu", DEV)}
    worst = 0.0
    for i in range(SMALL_STEPS):
        o = {d: s.step({"action": acts[i].to(d),
                        "reset": torch.zeros(SMALL_W, dtype=torch.int32,
                                             device=d)})
             for d, s in sims.items()}
        for name, g in o[DEV].items():
            c, g = o["cpu"][name], g.cpu()
            if g.is_floating_point():
                worst = max(worst, float((g - c).abs().max()))
            elif not torch.equal(g, c):
                raise AssertionError(f"{what} small run step {i}: {name} "
                                     "differs")
    if not worst <= SMALL_TOL:
        raise AssertionError(f"{what} card vs CPU: {worst} > {SMALL_TOL}")
    print(f"{what} card vs CPU path: {SMALL_W} worlds x {SMALL_STEPS} steps, "
          f"int exports equal, float max_abs_diff={worst!r}")


def step_ms(make_sim, make_env, acts):
    """ms per step of a fresh sim of ``make_env()`` at W worlds over
    steps 2..STEPS (host clock, synchronized at both ends)."""
    import torch

    sim = make_sim(make_env(), num_worlds=W, seed=0, device=DEV)
    reset = torch.zeros((W,), dtype=torch.int32, device=DEV)
    sim.step({"action": acts[0], "reset": reset})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, STEPS):
        sim.step({"action": acts[i], "reset": reset})
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (STEPS - 1)


def check_hide_seek_small(make_sim, HideSeek):
    """Phase 13: 8 worlds on the card against the port's CPU path."""
    import torch

    acts = HideSeek.random_actions(np.random.RandomState(5), SMALL_STEPS,
                                   SMALL_W)
    sims = {d: make_sim(HideSeek(render_size=16), num_worlds=SMALL_W, seed=3,
                        device=d) for d in ("cpu", DEV)}
    worst, worst_frac = 0.0, 0.0
    for i in range(SMALL_STEPS):
        o = {d: s.step({"action": acts[i].to(d),
                        "reset": torch.zeros(SMALL_W, dtype=torch.int32,
                                             device=d)})
             for d, s in sims.items()}
        for name, g in o[DEV].items():
            c, g = o["cpu"][name], g.cpu()
            if name in ("rgb", "depth"):
                bad = (g - c).abs() > PIX_TOL
                worst_frac = max(worst_frac, float(bad.float().mean()))
            elif g.is_floating_point():
                worst = max(worst, float((g - c).abs().max()))
            elif not torch.equal(g, c):
                raise AssertionError(f"hide_seek small step {i}: {name} "
                                     "differs")
    if not worst <= SMALL_TOL:
        raise AssertionError(f"hide_seek card vs CPU: {worst} > {SMALL_TOL}")
    if not worst_frac <= PIX_FRAC:
        raise AssertionError(f"hide_seek card vs CPU: pixel share "
                             f"{worst_frac} > {PIX_FRAC}")
    print(f"hide_seek card vs CPU path: {SMALL_W} worlds x {SMALL_STEPS} "
          f"steps, int exports equal, float max_abs_diff={worst!r}, share "
          f"of pixels off by more than {PIX_TOL}: {worst_frac!r}")
    return sims[DEV]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from madrona_tpu_torch import make_sim
    from madrona_tpu_torch.models.escape_room import EscapeRoom
    from madrona_tpu_torch.models.hide_seek import HideSeek
    from madrona_tpu_torch.ops import (
        broadphase_cuda, contacts_cuda, cuda_build, fused_cuda,
        hh_narrowphase_cuda, lidar_cuda, raycast_cuda, solver_cuda,
    )

    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)

    # ---- 1. build
    t0 = time.perf_counter()
    libs = cuda_build.build(cuda_build.SOURCES)
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          + ", ".join(p.name for p in libs.values()))
    for src, log in cuda_build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")
    resource_usage(libs)

    # ---- 2-7: kernels against their plain versions, on random scenes
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
    co_err, so_err, hh_err, fu_err, scene = check_physics_kernels(probe)

    # ---- 8: the main path, its kernel launches counted
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
    del outs, outs2

    # ---- 9: the card against the port's CPU path, small; no fallback
    check_card_vs_cpu(make_sim, EscapeRoom, "escape_room")
    check_no_fallback(
        make_sim(EscapeRoom(), num_worlds=SMALL_W, seed=0, device=DEV),
        kernels)

    # ---- 10: the raycast kernel against its plain version, on a real
    # Hide & Seek state (a probe sim, 3 steps in) and on synthetic planes
    def pixels():
        return HideSeek(render_size=HS_RENDER)

    def state_only():
        return HideSeek(pixels=False)

    hs_acts = HideSeek.random_actions(np.random.RandomState(2), 3, HS_W)
    hs_probe = make_sim(pixels(), num_worlds=HS_W, seed=1, device=DEV)
    for i in range(3):
        hs_probe.step({"action": hs_acts[i].to(DEV),
                       "reset": torch.zeros((HS_W,), dtype=torch.int32,
                                            device=DEV)})
    ra_err, ray_scene = check_raycast(hs_probe)
    del hs_probe

    # ---- 11: B1-B3 and B8 on an arranged Hide & Seek state
    hs_state_probe = make_sim(state_only(), num_worlds=HS_STATE_W, seed=1,
                              device=DEV)
    hs_state_probe.step({})
    hs_errs, hs_scene = check_hide_seek_physics(hs_state_probe)
    fu_err = max(fu_err, hs_errs[3])
    del hs_state_probe

    # ---- 12: Hide & Seek's two launches, their kernel launches counted
    hs_kernels = [broadphase_cuda.KERNEL, contacts_cuda.KERNEL,
                  solver_cuda.KERNEL, raycast_cuda.KERNEL, lidar_cuda.KERNEL]
    _, hs_outs, _, _, hs_launches = check_path(
        make_sim, pixels, HS_W, hs_kernels, [STEPS] * 4 + [0],
        "hide_seek pixels", {
            "rgb": (HS_W, 4, HS_RENDER, HS_RENDER, 3),
            "depth": (HS_W, 4, HS_RENDER, HS_RENDER),
            "flat_obs": (HS_W, 4, 46), "visible": (HS_W, 2, 2)}, card)
    rgb, depth = hs_outs[-1]["rgb"], hs_outs[-1]["depth"]
    hit = float((depth < 80.0).float().mean())
    print(f"hide_seek pixels: rgb in [{float(rgb.min()):.3f}, "
          f"{float(rgb.max()):.3f}], depth in [{float(depth.min()):.3f}, "
          f"{float(depth.max()):.3f}], share of rays that hit {hit:.3f}")
    if not (float(rgb.min()) >= 0.0 and float(rgb.max()) <= 1.0
            and float(depth.min()) > 0.0 and float(depth.max()) <= 80.0
            and 0.5 < hit < 1.0):
        raise AssertionError("hide_seek pixels: rgb or depth out of range")
    del hs_outs, rgb, depth
    hs_shapes = {"flat_obs": (HS_STATE_W, 4, 46),
                 "self_obs": (HS_STATE_W, 4, 10),
                 "visible": (HS_STATE_W, 2, 2)}
    check_path(make_sim, state_only, HS_STATE_W, hs_kernels,
               [STEPS] * 3 + [0, 0], "hide_seek state only", hs_shapes, card)

    # ---- 13: Hide & Seek, the card against the CPU path; no fallback
    small_hs = check_hide_seek_small(make_sim, HideSeek)
    check_no_fallback(small_hs, [raycast_cuda.KERNEL], launch=("render",))
    check_no_fallback(small_hs, hs_kernels[:3], launch=("step",))
    del small_hs
    torch.cuda.empty_cache()

    # ---- 14: the physics tiers of this slice at full width: each path's
    # launches of all seven kernels counted
    all_k = [broadphase_cuda.KERNEL, contacts_cuda.KERNEL,
             solver_cuda.KERNEL, lidar_cuda.KERNEL, raycast_cuda.KERNEL,
             hh_narrowphase_cuda.KERNEL, fused_cuda.KERNEL]
    er_shapes = {"flat_obs": (W, 2, 101)}
    path_launches = {}
    for what, make_env, w, want, shapes in (
        ("escape_room fused", lambda: with_physics(EscapeRoom(), **FUSED),
         W, (STEPS, 0, 0, STEPS, 0, 0, STEPS), er_shapes),
        ("hide_seek state only fused",
         lambda: with_physics(state_only(), **FUSED), HS_STATE_W,
         (STEPS, 0, 0, 0, 0, 0, STEPS), hs_shapes),
        ("escape_room kernel_sublane",
         lambda: with_physics(EscapeRoom(), **SUBLANE), W,
         (STEPS, 0, STEPS, STEPS, 0, STEPS, 0), er_shapes),
        ("escape_room kernel", lambda: with_physics(EscapeRoom(), **LANE_MAJOR),
         W, (STEPS, 0, STEPS, STEPS, 0, STEPS, 0), er_shapes),
    ):
        _, p_outs, _, _, path_launches[what] = check_path(
            make_sim, make_env, w, all_k, want, what, shapes, card)
        del p_outs
        torch.cuda.empty_cache()

    def split_er():
        return EscapeRoom()

    def fused_er():
        return with_physics(EscapeRoom(), **FUSED)

    turns = [("split", step_ms(make_sim, split_er, acts)),
             ("fused", step_ms(make_sim, fused_er, acts)),
             ("fused", step_ms(make_sim, fused_er, acts)),
             ("split", step_ms(make_sim, split_er, acts))]
    print(f"escape_room step, {W} worlds, in turns (ms/step): " + ", ".join(
        f"{k} {v:.2f}" for k, v in turns) + f" ({card})")

    # ---- 15: the fused path, the card against the CPU path; no fallback
    # on the fused and the two hull-hull record paths
    check_card_vs_cpu(make_sim, fused_er, "escape_room fused")
    check_no_fallback(
        make_sim(fused_er(), num_worlds=SMALL_W, seed=0, device=DEV),
        [fused_cuda.KERNEL])
    for what, change in (("kernel_sublane", SUBLANE), ("kernel", LANE_MAJOR)):
        check_no_fallback(
            make_sim(with_physics(EscapeRoom(), **change),
                     num_worlds=SMALL_W, seed=0, device=DEV),
            [hh_narrowphase_cuda.KERNEL], label=f"escape_room {what}")
    torch.cuda.empty_cache()

    # ---- 16: times at the main paths' shapes
    from madrona_tpu_torch.physics import api as papi
    from madrona_tpu_torch.physics import broadphase as bp

    env = sim.env
    om = env.om.to(DEV)
    body = papi.body_state(sim.executor.sm, sim.state)
    pack = broadphase_cuda.pack_bodies(body, om)
    cands = broadphase_cuda.broadphase(pack, env.caps, env.cfg.dt)
    bp_bytes, bp_ops = broadphase_cost(pack, cands)
    bp_ms = kernel_ms(lambda: broadphase_cuda.broadphase(pack, env.caps,
                                                         env.cfg.dt))
    bp_route_ms = timed(lambda: broadphase_cuda.find_candidates_kernel(
        body, om, env.caps, env.cfg.dt))
    bp_plain_ms = timed(lambda: bp.find_candidates(body, om, env.caps,
                                                   env.cfg.dt), 50)

    largs = lidar_inputs(sim)
    depth = lidar_cuda.lidar_obb(*largs)
    li_bytes = nbytes(*largs[:6], depth)
    li_ops = (depth.numel() * largs[0].shape[1]) * LIDAR_OPS_PER_RAY_BOX
    li_ms = kernel_ms(lambda: lidar_cuda.lidar_obb(*largs))
    li_plain_ms = timed(lambda: plain_lidar(largs), 50)
    print(f"broadphase route (pack + kernel): {bp_route_ms:.4f} ms")

    # contacts and solver on the probe's Escape Room scene (phases 4, 5)
    c_in, c_out, cnt = scene["args"], scene["contacts"], scene["counts"]
    om_s = scene["om"]
    co_bytes, co_ops = contacts_cost(c_in, om_s, c_out, cnt)
    co_ms = kernel_ms(lambda: contacts_cuda.contacts(*c_in, om_s))
    contacts_split("escape_room", c_in, om_s, card)
    for tier, dirs in (("edge_dirs", True), ("edge_pairs", False)):
        cr_ms = timed_device(lambda: contacts_cuda.contacts(
            *scene["crowded_args"], scene["crowded_om"], dirs))
        print(f"contacts {tier} at the crowded scene (W={W}, caps 8/8/0): "
              f"device {cr_ms:.4f} ms ({card})")
    co_plain_ms = timed(lambda: contacts_cuda.contacts_plain(*c_in, om_s),
                        PLAIN_PHYSICS_ITERS)
    cfg = env.cfg
    s_in = (scene["state"], scene["param"], *c_out, *scene["jargs"])
    so_bytes, so_ops = solver_cost(
        cfg, scene["state"], scene["param"], c_out, scene["jargs"], cnt,
        scene["n_joints"], solver_cuda.substep_solver(cfg, *s_in))
    so_ms = kernel_ms(lambda: solver_cuda.substep_solver(cfg, *s_in))
    so_plain_ms = timed(
        lambda: solver_cuda.substep_solver_plain(cfg, *s_in),
        PLAIN_PHYSICS_ITERS)
    route_ms = timed(lambda: physics_route(body, om, env, scene["jargs"]),
                     50)
    print(f"physics route (B1 + integrate + packs + B2 + B3): "
          f"{route_ms:.4f} ms")

    # the hull-hull record (phase 6's Escape Room scene): B6 in the
    # edge_dirs tier, B7 in the edge_pairs tier; on the crowded box scene
    # their times and bounds only
    def hh_cost(args, om_, h_cnt, dirs, plain_iters):
        hh_in = (args[0], args[2], args[3])
        rec = hh_narrowphase_cuda.hh_record(*hh_in, om_, dirs)
        h_bytes = (nbytes(hh_in[0], om_.hull_pack, rec)
                   + (nbytes(om_.hull_dirs_pack) if dirs else 0)
                   + referenced_row_bytes(hh_in[1], hh_in[2], hh_in[0]))
        face = h_cnt["hh_live"] - h_cnt["hh_1pt"]
        h_ops = (HH_OPS_FACE * face + (
            HH_OPS_CANDIDATE * h_cnt["hh_candidates"]
            + HH_OPS_EDGE * h_cnt["hh_1pt"] if dirs else
            HH_OPS_CANDIDATE_PAIRS * h_cnt["hh_candidates"]
            + HH_OPS_EDGE_PAIRS * h_cnt["hh_1pt"]))
        h_ms = kernel_ms(lambda: hh_narrowphase_cuda.hh_record(*hh_in, om_,
                                                               dirs))
        h_plain_ms = (timed(lambda: hh_narrowphase_cuda.hh_record_plain(
            *hh_in, om_, dirs), plain_iters, 1) if plain_iters else None)
        return h_ms, h_plain_ms, h_bytes, h_ops

    hh_rows = {}
    for tier, dirs in (("edge_dirs", True), ("edge_pairs", False)):
        hh_rows[tier] = hh_cost(c_in, om_s, scene["hh_counts"][tier], dirs,
                                PLAIN_PHYSICS_ITERS)
        k_ms, _, b, ops = hh_cost(scene["crowded_args"], scene["crowded_om"],
                                  scene["crowded_hh_counts"][tier], dirs, 0)
        b_ms, b_by = bound(b, ops)
        print(f"hh_narrowphase {tier} at the crowded scene (W={W}, P=8): "
              f"wrapper {k_ms[0]:.4f} ms/launch, device {k_ms[1]:.4f} ms, "
              f"bound {b_ms:.5f} ms ({b_by}: {b} B, {ops} ops) ({card})")

    # the fused step: the Escape Room state with joints (phase 7) and the
    # arranged Hide & Seek state (phase 11)
    def fused_cost(scene_):
        f_cfg, f_args, fc = (scene_["fused_cfg"], scene_["fused_args"],
                             scene_["fused_counts"])
        f_in = (*f_args[:8], f_args[8].hull_pack, f_args[8].hull_dirs_pack,
                *scene_["jargs"])
        out = fused_cuda.fused_step(f_cfg, *f_args, *scene_["jargs"])
        f_bytes = nbytes(*f_in, out)
        n_live_j = (int((scene_["jargs"][2][21] > 0.5).sum())
                    if scene_["jargs"] else 0)
        f_ops = (
            SOLVER_OPS_BODY * fc["movable"]
            + HH_OPS_CANDIDATE * fc["hh_candidates"]
            + HH_OPS_FACE * (fc["hh_live"] - fc["hh_1pt"])
            + HH_OPS_EDGE * fc["hh_1pt"]
            + HP_OPS_CANDIDATE * fc["hp_candidates"]
            + HP_OPS_CONTACT * fc["hp_live"]
            + SPHERE_OPS_HULL * fc["sp_hull"]
            + SPHERE_OPS_PLANE * fc["sp_plane"]
            + SPHERE_OPS_SPHERE * fc["sp_sphere"]
            + f_cfg.substeps * (
                SOLVER_OPS_BODY * fc["movable"]
                + (SOLVER_OPS_CONTACT_POS * f_cfg.jacobi_iters
                   + SOLVER_OPS_CONTACT_VEL) * fc["ok"]
                + SOLVER_OPS_POINT * fc["points"]
                + SOLVER_OPS_JOINT * n_live_j))
        k_ms = kernel_ms(lambda: fused_cuda.fused_step(f_cfg, *f_args,
                                                       *scene_["jargs"]))
        pl_ms = timed(lambda: fused_cuda.fused_step_plain(
            f_cfg, *f_args, *scene_["jargs"]), PLAIN_PHYSICS_ITERS, 1)
        return k_ms, pl_ms, f_bytes, f_ops

    fu_ms, fu_plain_ms, fu_bytes, fu_ops = fused_cost(scene)
    hs_fu = fused_cost(hs_scene)
    for tier, sp_scene in scene["spheres"].items():
        k_ms, pl_ms, b, ops = fused_cost(sp_scene)
        b_ms, b_by = bound(b, ops)
        print(f"fused_step {tier} at the sphere scene (W={W}, N=21, caps "
              f"8/8/8): wrapper {k_ms[0]:.4f} ms/launch, device "
              f"{k_ms[1]:.4f} ms, plain {pl_ms:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by}: {b} B, {ops} ops) ({card})")

    # raycast at the pixel path's shapes (phase 10's real scene)
    r_planes, r_opts, n_rays = ray_scene
    r_out = raycast_cuda.raytrace(*r_planes, **r_opts)
    ra_bytes = nbytes(*r_planes, r_out)
    wv, t_pad = r_planes[0].shape[:2]
    # what this run's data needs: the real rays, and for the primary test
    # only the live rows (a row whose columns 0..2, A, are all zero has
    # det 0 for every ray and cannot hit)
    live_rows = int((r_planes[0][..., :3] != 0).any(dim=-1).sum())
    per_ray = RAY_OPS_RAY + (RAY_OPS_RAY_MATERIALS if r_opts["use_materials"]
                             else 0)
    shadow = RAY_OPS_PAIR_SHADOW if r_opts["shadows"] else 0
    ra_ops = n_rays * (live_rows * RAY_OPS_PAIR + wv * t_pad * shadow
                       + wv * per_ray)
    # every (view, padded ray, row): the yardstick of the kernel before it
    # skipped dead rows, the same work before and after
    r_pad = r_out.shape[2]
    all_ops = r_pad * wv * (t_pad * (RAY_OPS_PAIR + shadow) + per_ray)
    all_ms, all_by = bound(ra_bytes, all_ops)
    print(f"raycast: {live_rows} of {wv * t_pad} rows live; bound over "
          f"every row (the same-work yardstick of the kernel that tested "
          f"them all) {all_ms:.5f} ms ({all_by}: {all_ops} ops) ({card})")
    del r_out
    ra_ms = kernel_ms(lambda: raycast_cuda.raytrace(*r_planes, **r_opts),
                      20, 2)
    ra_plain_ms = timed(
        lambda: raycast_cuda.raytrace_plain(*r_planes, **r_opts), 2, 1)

    # B1-B3 and B8 at Hide & Seek's shapes (phase 11's arranged scene,
    # 16,384 worlds), with bounds by the Escape Room rows' counts, beside
    # the rows of the Escape Room shapes
    hb, hom, hcfg = hs_scene["body"], hs_scene["om"], HideSeek(pixels=False)
    h_in = (hs_scene["state"], hs_scene["param"], *hs_scene["c_out"],
            *hs_scene["jargs"])
    h_pack = broadphase_cuda.pack_bodies(hb, hom)
    hs_cost = {
        "broadphase": broadphase_cost(
            h_pack, broadphase_cuda.broadphase(h_pack, hcfg.caps,
                                               hcfg.cfg.dt)),
        "contacts": contacts_cost(hs_scene["c_args"], hom, hs_scene["c_out"],
                                  hs_scene["counts"]),
        "substep_solver": solver_cost(
            hcfg.cfg, hs_scene["state"], hs_scene["param"],
            hs_scene["c_out"], hs_scene["jargs"], hs_scene["counts"],
            hs_scene["n_joints"],
            solver_cuda.substep_solver(hcfg.cfg, *h_in)),
        "fused_step": hs_fu[2:],
    }
    hs_ms = {
        "broadphase": (
            kernel_ms(lambda: broadphase_cuda.broadphase(h_pack, hcfg.caps,
                                                         hcfg.cfg.dt)),
            timed(lambda: bp.find_candidates(hb, hom, hcfg.caps,
                                             hcfg.cfg.dt), 20)),
        "contacts": (
            kernel_ms(lambda: contacts_cuda.contacts(*hs_scene["c_args"],
                                                     hom)),
            timed(lambda: contacts_cuda.contacts_plain(*hs_scene["c_args"],
                                                       hom),
                  PLAIN_PHYSICS_ITERS, 1)),
        "substep_solver": (
            kernel_ms(lambda: solver_cuda.substep_solver(hcfg.cfg, *h_in)),
            timed(lambda: solver_cuda.substep_solver_plain(hcfg.cfg, *h_in),
                  PLAIN_PHYSICS_ITERS, 1)),
        "fused_step": hs_fu[:2],
    }
    for (name, (k_ms, pl_ms)), err in zip(hs_ms.items(), hs_errs):
        b, ops = hs_cost[name]
        b_ms, b_by = bound(b, ops)
        print(f"{name} at the hide_seek shape (W={HS_STATE_W}, N=14, caps "
              f"7/9, J=4): wrapper {k_ms[0]:.4f} ms/launch, device "
              f"{k_ms[1]:.4f} ms, plain {pl_ms:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by}: {b} B, {ops} ops), max_abs_diff {err!r} ({card})")
    contacts_split("hide_seek", hs_scene["c_args"], hom, card)

    rows = []
    sub = path_launches["escape_room kernel_sublane"]
    lane = path_launches["escape_room kernel"]
    fused_l = path_launches["escape_room fused"]
    i_hh, i_fu = all_k.index(hh_narrowphase_cuda.KERNEL), all_k.index(
        fused_cuda.KERNEL)
    for name, src, rep, n_launch, err, ms, plain_ms, b, ops in (
        ("broadphase", "madrona_tpu_torch/csrc/broadphase.cu",
         "madrona_tpu/ops/broadphase_pallas.py:160",
         launches[kernels.index(broadphase_cuda.KERNEL)],
         bp_err, bp_ms, bp_plain_ms, bp_bytes, bp_ops),
        ("contacts", "madrona_tpu_torch/csrc/contacts.cu",
         "madrona_tpu/ops/physics_megakernel.py:560",
         launches[kernels.index(contacts_cuda.KERNEL)],
         co_err, co_ms, co_plain_ms, co_bytes, co_ops),
        ("substep_solver", "madrona_tpu_torch/csrc/solver.cu",
         "madrona_tpu/ops/solver_pallas.py:709",
         launches[kernels.index(solver_cuda.KERNEL)],
         so_err, so_ms, so_plain_ms, so_bytes, so_ops),
        ("lidar", "madrona_tpu_torch/csrc/lidar.cu",
         "madrona_tpu/ops/lidar_pallas.py:53",
         launches[kernels.index(lidar_cuda.KERNEL)],
         li_err, li_ms, li_plain_ms, li_bytes, li_ops),
        ("raycast", "madrona_tpu_torch/csrc/raycast.cu",
         "madrona_tpu/ops/raycast_pallas.py:150",
         hs_launches[hs_kernels.index(raycast_cuda.KERNEL)],
         ra_err, ra_ms, ra_plain_ms, ra_bytes, ra_ops),
        ("hh_narrowphase_sublane", "madrona_tpu_torch/csrc/hh_narrowphase.cu",
         "madrona_tpu/ops/narrowphase_pallas.py:1227", sub[i_hh], hh_err,
         *hh_rows["edge_dirs"]),
        ("hh_narrowphase", "madrona_tpu_torch/csrc/hh_narrowphase.cu",
         "madrona_tpu/ops/narrowphase_pallas.py:403", lane[i_hh], hh_err,
         *hh_rows["edge_pairs"]),
        ("fused_step", "madrona_tpu_torch/csrc/fused_step.cu",
         "madrona_tpu/ops/physics_megakernel.py:287", fused_l[i_fu], fu_err,
         fu_ms, fu_plain_ms, fu_bytes, fu_ops),
    ):
        b_ms, b_by = bound(b, ops)
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": n_launch, "max_abs_err": err,
            "ms": ms[0], "device_ms": ms[1], "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
        print(f"{name}: wrapper {ms[0]:.4f} ms/launch, device {ms[1]:.4f} "
              f"ms, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
              f"{b} B, {ops} ops) ({card})")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


def bound(b, ops):
    """(least ms the card could take, "bytes" or "operations"): the
    larger of the bytes over the memory rate and the operations over the
    float32 rate."""
    t_bytes, t_ops = b / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


if __name__ == "__main__":
    sys.exit(main())
