#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (madrona_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. the card (nvidia-smi name and power limit) and the kernel build
     (one nvcc per csrc/*.cu source, all started together);
  2. the broadphase kernel against its plain PyTorch version at 4096
     worlds, on random scenes (caps-saturating ones included) and on a
     real Escape Room body state: every field exactly equal;
  3. the lidar kernel against its plain version at the Escape Room shape
     (4096 worlds, 20 boxes, 2 agents x 30 rays): max abs diff <= 1e-5;
  4. the main path: make_sim(EscapeRoom(), 4096 worlds, seed 0) on the
     card, stepped with seeded random actions; every export finite, each
     kernel launched once per step, a fresh sim with the same seed
     bit-identical; env-steps/s;
  5. the same env at 8 worlds on the card against the port's CPU path;
  6. per-kernel times (CUDA events) beside their bounds, as one JSON line.

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

W = 4096                  # the Escape Room world count of the repo's bench
STEPS = 20
SMALL_W = 8
SMALL_STEPS = 3
SMALL_TOL = 1e-3          # card vs CPU, float exports after 3 steps
LIDAR_TOL = 1e-5          # kernel vs plain version
TIMING_ITERS = 200

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
    t = lambda a: torch.from_numpy(a).cuda()      # noqa: E731
    z3 = torch.zeros((W, n, 3), device="cuda")
    z4 = torch.zeros((W, n, 4), device="cuda")
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
    om_rand = reg.build().to("cuda")
    env = sim.env
    om_er = env.om.to("cuda")
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
    t = lambda a: torch.from_numpy(a.astype(np.float32)).cuda()  # noqa
    q = rs.randn(W, n_inst, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    ang = rs.uniform(0, 2 * np.pi, (W, n_ag, n_rays))
    mask = np.ones((n_ag, n_inst), bool)
    mask[0, 2] = mask[1, 5] = False
    rand_args = (
        t(rs.uniform(-8, 8, (W, n_inst, 3))), t(q),
        t(rs.uniform(0.2, 3.0, (W, n_inst, 3))),
        torch.from_numpy(mask).cuda(), t(rs.uniform(-6, 6, (W, n_ag, 3))),
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


def run_main_path(make_sim, EscapeRoom, acts, counters):
    """Phase 4: step a fresh sim with every counter of ``counters`` set to
    0 first; returns (sim, per-step exports, seconds of steps 2..STEPS,
    the counters' launches in this run)."""
    import torch

    sim = make_sim(EscapeRoom(), num_worlds=W, seed=0)
    reset = torch.zeros((W,), dtype=torch.int32, device="cuda")
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
        reset = torch.zeros((W,), dtype=torch.int32, device="cuda")
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
    from madrona_tpu_torch.ops import broadphase_cuda, cuda_build, lidar_cuda

    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)

    # ---- 1. build
    t0 = time.perf_counter()
    libs = cuda_build.build(["broadphase.cu", "lidar.cu"])
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          + ", ".join(p.name for p in libs.values()))
    for src, log in cuda_build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")

    # ---- 2, 3: kernels against their plain versions, on random scenes
    # and on a real Escape Room state (a probe sim, 3 steps in)
    acts = EscapeRoom.random_actions(np.random.RandomState(0), STEPS, W)
    acts = acts.cuda()
    probe = make_sim(EscapeRoom(), num_worlds=W, seed=1)
    for i in range(3):
        probe.step({"action": acts[i],
                    "reset": torch.zeros((W,), dtype=torch.int32,
                                         device="cuda")})
    bp_err = check_broadphase(probe)
    li_err = check_lidar(probe)

    # ---- 4: the main path, its kernel launches counted
    kernels = [broadphase_cuda.KERNEL, lidar_cuda.KERNEL]
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

    # ---- 5: the card against the port's CPU path, small
    small_acts = EscapeRoom.random_actions(np.random.RandomState(5),
                                           SMALL_STEPS, SMALL_W)
    sims = {d: make_sim(EscapeRoom(), num_worlds=SMALL_W, seed=3, device=d)
            for d in ("cpu", "cuda")}
    worst = 0.0
    for i in range(SMALL_STEPS):
        o = {d: s.step({"action": small_acts[i].to(d),
                        "reset": torch.zeros(SMALL_W, dtype=torch.int32,
                                             device=d)})
             for d, s in sims.items()}
        for name, g in o["cuda"].items():
            c, g = o["cpu"][name], g.cpu()
            if g.is_floating_point():
                worst = max(worst, float((g - c).abs().max()))
            elif not torch.equal(g, c):
                raise AssertionError(f"small run step {i}: {name} differs")
    if not worst <= SMALL_TOL:
        raise AssertionError(f"card vs CPU: {worst} > {SMALL_TOL}")
    print(f"card vs CPU path: {SMALL_W} worlds x {SMALL_STEPS} steps, "
          f"int exports equal, float max_abs_diff={worst!r}")

    # ---- 6: times at the main path's shapes
    from madrona_tpu_torch.physics import api as papi
    from madrona_tpu_torch.physics import broadphase as bp

    env = sim.env
    om = env.om.to("cuda")
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

    def bound(b, ops):
        t_bytes, t_ops = b / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    rows = []
    for name, src, rep, k, err, ms, plain_ms, b, ops in (
        ("broadphase", "madrona_tpu_torch/csrc/broadphase.cu",
         "madrona_tpu/ops/broadphase_pallas.py:160", broadphase_cuda.KERNEL,
         bp_err, bp_ms, bp_plain_ms, bp_bytes, bp_ops),
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
