#!/usr/bin/env python3
"""Where one env step of the PyTorch port spends its time on the GPU.

    python3 scripts/torch_step_profile.py [--env escape_room] [--worlds N]
                                          [--steps 20] [--phases]

``--env`` is ``escape_room`` (default, 4096 worlds), ``hide_seek`` (Hide &
Seek with 64 x 64 pixels through its ("step", "render") launch, 1024
worlds), ``hide_seek_blas`` (the same through the mesh-BVH render tier,
``render_tier="blas"``: materials, the sun and its shadow),
``hide_seek_state`` (state only, 16384 worlds), ``pile`` (256 bodies a
world through the swept broadphase, 64 worlds), ``cartpole`` (16384
worlds), ``hanabi`` (2 players, compact observations, 16384 worlds) or
``overcooked`` (cramped_room, 4096 worlds). Prints, for
make_sim(env, worlds) on the card after a warm-up:
  * the card's name and power limit;
  * the unfenced step time (host clock around `steps` steps ending in a
    synchronize) and env-steps/s;
  * the time of the executor's per-step key splitting alone (the
    Threefry splits TaskGraph.step makes: one step key per graph of the
    launch and one key per node);
  * from torch.profiler over 5 steps: device kernel time per step and
    the device's busy share, kernel launches per step, and the largest
    kernels by device time and operators by host time.
With ``--phases`` (a physics env: escape_room, hide_seek or
hide_seek_state), the counterpart of scripts/profile_step.py instead: the
card's name and power limit, then a table of ms: the whole step, each
physics phase alone on the step's own state on the plain route (the
broadphase, the narrowphase, integrate, the position solve and the
velocity solve, profile_step.py:78-92), and the broadphase (B1),
contacts (B2) and substep-solver (B3) kernels alone on the kernel route,
their inputs packed beforehand. Each time is the best of 3 runs of 20
calls, fenced by torch.cuda.synchronize(); a phase alone pays
for reading and writing state that the step keeps between its ops, so
its time is an upper bound of its share of the step.
Needs CUDA; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from madrona_tpu_torch import make_sim                      # noqa: E402
from madrona_tpu_torch.models.cartpole import Cartpole      # noqa: E402
from madrona_tpu_torch.models.escape_room import EscapeRoom  # noqa: E402
from madrona_tpu_torch.models.hanabi import Hanabi          # noqa: E402
from madrona_tpu_torch.models.hide_seek import HideSeek     # noqa: E402
from madrona_tpu_torch.models.overcooked import Overcooked  # noqa: E402
from madrona_tpu_torch.models.pile import Pile              # noqa: E402
from madrona_tpu_torch.utils import rng as _rng             # noqa: E402
from madrona_tpu_torch.utils import tracing                 # noqa: E402

PROFILED_STEPS = 5
PHASE_ENVS = ("escape_room", "hide_seek", "hide_seek_state")
# name -> (env factory, default world count)
ENVS = {
    "escape_room": (EscapeRoom, 4096),
    "hide_seek": (lambda: HideSeek(render_size=64), 1024),
    "hide_seek_blas": (lambda: HideSeek(render_size=64, render_tier="blas"),
                       1024),
    "hide_seek_state": (lambda: HideSeek(pixels=False), 16384),
    "pile": (Pile, 64),
    "cartpole": (Cartpole, 16384),
    "hanabi": (Hanabi, 16384),
    "overcooked": (Overcooked, 4096),
}


def best_ms(fn, sync, reps: int) -> float:
    """ms a call of ``fn``: the best of 3 runs of ``reps`` calls after one
    call of warm-up, each run fenced by ``sync``."""
    fn()
    sync()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        best = min(best, (time.perf_counter() - t0) / reps)
    return best * 1e3


def phase_times(sim, inputs, sync, reps: int = 20):
    """[(phase, ms)]: the whole step of ``sim`` on ``inputs``, then each
    physics phase alone on the step's own state, on the plain route and
    then B1-B3 on the kernel route (each kernel's wrapper on inputs
    packed beforehand; on a CPU tensor a wrapper runs its plain
    version)."""
    from madrona_tpu_torch.ops import broadphase_cuda, contacts_cuda
    from madrona_tpu_torch.ops import solver_cuda
    from madrona_tpu_torch.physics import api, xpbd
    from madrona_tpu_torch.physics import broadphase as bp

    step = sim.step_fn()
    state = step(sim.state, inputs)[0]
    env, sm = sim.env, sim.executor.sm
    cfg, caps = env.cfg, env.caps
    body = api.body_state(sm, state)
    om = env.om.to(body.pos.device)
    h = cfg.dt / cfg.substeps
    dirs = cfg.sat_tier == "edge_dirs"
    cands = bp.find_candidates(body, om, caps, cfg.dt)
    contacts = api._narrowphase_all(body, om, cands, sat_dirs=dirs)
    pack = broadphase_cuda.pack_bodies(body, om)
    poses, obj = contacts_cuda.pack_poses(
        xpbd.integrate(body, om, h, cfg.gravity), body.obj_id)
    # the kernel route's candidates (B1's, equal to the plain tier's)
    k_cands = broadphase_cuda.find_candidates_kernel(body, om, caps, cfg.dt)
    cargs = contacts_cuda.contacts(k_cands.hh, k_cands.hp, poses, obj, om,
                                   dirs)
    s_state, s_param = solver_cuda.pack_state(body, om)
    jargs = (solver_cuda.pack_joints(api.joints_view(state),
                                     body.pos.shape[1])
             if api.JOINT_BUFFER in sm.singletons else ())
    phases = {
        "full step": lambda: step(state, inputs),
        "broadphase (plain)": lambda: bp.find_candidates(body, om, caps,
                                                         cfg.dt),
        "narrowphase (plain)": lambda: api._narrowphase_all(
            body, om, cands, sat_dirs=dirs),
        "integrate": lambda: xpbd.integrate(body, om, h, cfg.gravity),
        "solve_positions (Jacobi)": lambda: xpbd.solve_positions_jacobi(
            body, contacts, om, cfg.jacobi_iters),
        "solve_velocities (Jacobi)": lambda: xpbd.solve_velocities_jacobi(
            body, contacts, om, h, cfg.restitution,
            cfg.restitution_threshold),
        # the kernel alone on the card; its wrapper's plain version (which
        # packs nothing) on the CPU
        "B1 broadphase kernel": (
            (lambda: broadphase_cuda.broadphase(pack, caps, cfg.dt))
            if pack.is_cuda else
            (lambda: broadphase_cuda.find_candidates_kernel(body, om, caps,
                                                            cfg.dt))),
        "B2 contacts kernel": lambda: contacts_cuda.contacts(
            k_cands.hh, k_cands.hp, poses, obj, om, dirs),
        "B3 substep-solver kernel": lambda: solver_cuda.substep_solver(
            cfg, s_state, s_param, *cargs, *jargs),
    }
    return [(name, best_ms(fn, sync, reps)) for name, fn in phases.items()]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def print_phases(what, w, rows, card):
    print(f"{what}: {w} worlds, ms a call (best of 3 runs, each fenced by "
          f"torch.cuda.synchronize()) ({card})")
    full = rows[0][1]
    for name, ms in rows:
        rate = (f"  {w / ms * 1e3:,.1f} env-steps/s" if name == "full step"
                else f"  {ms / full:6.1%} of the step")
        print(f"  {name:28s} {ms:10.4f}{rate}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", choices=sorted(ENVS), default="escape_room")
    ap.add_argument("--worlds", type=int, default=None)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--phases", action="store_true",
                    help="time the step and each physics phase alone")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_step_profile: CUDA is not available", file=sys.stderr)
        return 2
    if args.phases and args.env not in PHASE_ENVS:
        print(f"torch_step_profile: --phases takes {PHASE_ENVS}",
              file=sys.stderr)
        return 2
    card = card_line()
    print(card)
    make_env, default_w = ENVS[args.env]
    w = args.worlds or default_w
    if args.phases:
        sim = make_sim(make_env(), num_worlds=w, seed=0)
        acts = sim.env.random_actions(np.random.RandomState(0), 1, w)
        inputs = {"action": acts[0].cuda(),
                  "reset": torch.zeros((w,), dtype=torch.int32,
                                       device="cuda")}
        for _ in range(10):
            sim.step(inputs)
        print_phases(f"{args.env} phases", w,
                     phase_times(sim, inputs, torch.cuda.synchronize), card)
        return 0
    total = 10 + args.steps + PROFILED_STEPS
    sim = make_sim(make_env(), num_worlds=w, seed=0)
    acts = sim.env.random_actions(np.random.RandomState(0), total, w).cuda()
    reset = torch.zeros((w,), dtype=torch.int32, device="cuda")
    launch = sim.env.default_launch
    print(f"{args.env}: {w} worlds, launch {launch}")
    step = 0
    for _ in range(10):
        sim.step({"action": acts[step], "reset": reset})
        step += 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        sim.step({"action": acts[step], "reset": reset})
        step += 1
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / args.steps
    print(f"unfenced: {ms:.3f} ms/step, {w / ms * 1e3:.1f} env-steps/s "
          f"({w} worlds, {args.steps} steps after 10 of warm-up)")

    state = sim.state
    n_nodes = [len(sim.executor.graphs[g].nodes) for g in launch]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        for n in n_nodes:
            key = _rng.split_i(state.rng, state.step.to(torch.int64))
            for node_id in range(n):
                _rng.split_i(key, node_id)
    torch.cuda.synchronize()
    split_ms = (time.perf_counter() - t0) * 1e3 / args.steps
    print(f"key splitting alone: {split_ms:.3f} ms/step "
          f"({len(n_nodes) + sum(n_nodes)} Threefry splits)")

    def run():
        nonlocal step
        sim.step({"action": acts[step], "reset": reset})
        step += 1

    t0 = time.perf_counter()
    events = tracing.profile_events(run, PROFILED_STEPS)
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    dev_us = sum(e.self_device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    if dev_us == 0:
        print("profiler: no device time recorded")
        return 0
    print(f"profiled {PROFILED_STEPS} steps: wall {wall_ms / PROFILED_STEPS:.3f} "
          f"ms/step (profiler on), device kernels "
          f"{dev_us / 1e3 / PROFILED_STEPS:.3f} ms/step, device busy share "
          f"{dev_us / 1e3 / wall_ms:.3f}, {launches / PROFILED_STEPS:.0f} "
          "kernel launches/step")
    print("largest kernels by device time (ms/step, launches/step):")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3 / PROFILED_STEPS:8.4f} "
              f"{e.count / PROFILED_STEPS:7.1f}  {e.key[:90]}")
    ops = [e for e in events if e.device_type.name == "CPU"]
    print("largest operators by host self time (ms/step, calls/step):")
    for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:12]:
        print(f"  {e.self_cpu_time_total / 1e3 / PROFILED_STEPS:8.4f} "
              f"{e.count / PROFILED_STEPS:7.1f}  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
