#!/usr/bin/env python3
"""What the Overcooked PPO learner is paid for, update by update.

    python3 scripts/torch_overcooked_rewards.py [--worlds 4096]
        [--updates 300] [--every 50] [--device cuda|cpu]

Trains examples/torch_train_ppo_overcooked.py's learner (the same
make_train, update, seeds and hyperparameters as its main) and prints,
every ``--every`` updates, over the rollouts of that window: the
deliveries per finished episode, the shaped reward per episode (reward
per world-step x 400), and how often each nonzero step reward occurred.
The shaped rewards are +3 an onion into a pot, +3 a dish pickup, +5 a
soup pickup, +20 a delivery (summed over both agents in a step). A pot
takes 3 onions and is full until its soup is taken, so in an episode
with no +5 at most 3 of the +3 events a pot are onions: the rest are
dish pickups. Prints the device it ran on; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
from collections import Counter

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "examples"))

from madrona_tpu_torch.models.overcooked import EPISODE_LEN  # noqa: E402
from torch_train_ppo import PPOConfig, generator, update     # noqa: E402
from torch_train_ppo_overcooked import (                     # noqa: E402
    delivery_stats, make_train)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=4096)
    ap.add_argument("--updates", type=int, default=300)
    ap.add_argument("--every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()

    cfg = dataclasses.replace(PPOConfig(), horizon=64, ent_coef=0.02,
                              lr=5e-4)
    sim, pi, v, obs_of = make_train(args.worlds, cfg, args.seed,
                                    args.device)
    dev = sim.device
    print("device:", torch.cuda.get_device_name(dev) if dev.type == "cuda"
          else "cpu")
    gen = generator(args.seed + 7, dev)
    step_fn = sim.step_fn()
    state = sim.state
    t0 = time.perf_counter()
    window, rewards = [], []
    for u in range(args.updates):
        state, frames = update(step_fn, state, pi, v, gen, cfg, obs_of,
                               keep=("deliveries",))
        window.append(delivery_stats(frames))
        rewards.append(frames["rew"][..., 0])         # [T, W], shared
        if (u + 1) % args.every == 0:
            delivered = float(sum(d for d, _ in window))
            finished = float(sum(f for _, f in window))
            rew = torch.cat(rewards)
            values, counts = torch.unique(rew[rew != 0], return_counts=True)
            hist = Counter({float(a): int(n) for a, n in zip(
                values.tolist(), counts.tolist())})
            print(f"update {u + 1:4d}  deliveries/episode "
                  f"{delivered / max(finished, 1.0):.3f}  shaped reward/"
                  f"episode {float(rew.mean()) * EPISODE_LEN:.2f}  nonzero "
                  f"step rewards {dict(sorted(hist.items()))}  "
                  f"{time.perf_counter() - t0:.0f}s", flush=True)
            window, rewards = [], []
    return 0


if __name__ == "__main__":
    sys.exit(main())
