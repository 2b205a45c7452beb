#!/usr/bin/env python3
"""Where one env step of the PyTorch port spends its time on the GPU.

    python3 scripts/torch_step_profile.py [--env escape_room] [--worlds N]
                                          [--steps 20]

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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", choices=sorted(ENVS), default="escape_room")
    ap.add_argument("--worlds", type=int, default=None)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_step_profile: CUDA is not available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(card)
    make_env, default_w = ENVS[args.env]
    w = args.worlds or default_w
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
