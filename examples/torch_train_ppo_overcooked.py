#!/usr/bin/env python
"""PPO on Overcooked (cramped_room) with the PyTorch port.

The counterpart of ``examples/train_ppo_overcooked.py``: PPO with one
set of parameters shared by both agents, 128-128 MLPs, overcooked_ai's
shaped rewards, ``ent_coef = 0.02`` and ``lr = 5e-4``; the env steps on
the card (unless ``--device cpu``) inside the learner's loop, the
observations never leave it. Prints the deliveries per finished episode
every 50 updates (episodes last 400 steps, a rollout ``horizon``, so the
host sums over the window).

Usage: python examples/torch_train_ppo_overcooked.py [--worlds 4096]
       [--updates 300] [--horizon 64] [--device cuda|cpu]
"""

import argparse
import dataclasses
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from madrona_tpu_torch import make_sim                        # noqa: E402
from madrona_tpu_torch.models.overcooked import Overcooked    # noqa: E402

from torch_train_ppo import MLP, PPOConfig, generator, update  # noqa: E402

N_ACTIONS = 6


def make_train(num_worlds: int, cfg: PPOConfig, seed: int = 0,
               device=None):
    """(sim, policy, value net, obs_of) on ``device`` (default: the
    card); the weights drawn from a generator seeded with ``seed``."""
    env = Overcooked(shaped_rewards=True)
    sim = make_sim(env, num_worlds=num_worlds, seed=seed, device=device)
    obs_dim = env.H * env.W * env.obs_channels
    gen = generator(seed, sim.device)
    pi = MLP([obs_dim, 128, 128, N_ACTIONS], generator=gen,
             device=sim.device)
    v = MLP([obs_dim, 128, 128, 1], generator=gen, device=sim.device)

    def obs_of(state):
        return state.singletons["Obs"].reshape(num_worlds, 2, obs_dim)

    return sim, pi, v, obs_of


def delivery_stats(frames):
    """(deliveries, finished episodes) summed over a rollout (tensors):
    the deliveries of each episode are read at its last step."""
    ep_done = frames["ep_done"]
    return (frames["deliveries"].to(torch.float32) * ep_done).sum(), \
        ep_done.sum()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=4096)
    ap.add_argument("--updates", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--horizon", type=int, default=64)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(PPOConfig(), horizon=args.horizon,
                              ent_coef=0.02, lr=5e-4)
    sim, pi, v, obs_of = make_train(args.worlds, cfg, args.seed,
                                    args.device)
    gen = generator(args.seed + 7, sim.device)     # the actions' stream
    step_fn = sim.step_fn()
    state = sim.state

    t0 = time.perf_counter()
    window = []
    per_ep = 0.0
    for u in range(args.updates):
        state, frames = update(step_fn, state, pi, v, gen, cfg, obs_of,
                               keep=("deliveries",))
        window.append(delivery_stats(frames))
        if (u + 1) % 50 == 0:
            delivered = float(sum(d for d, _ in window))
            finished = float(sum(f for _, f in window))
            window = []
            per_ep = delivered / max(finished, 1.0)
            dt = time.perf_counter() - t0
            sps = (u + 1) * cfg.horizon * args.worlds / dt
            print(f"update {u+1:4d}  deliveries/episode {per_ep:5.2f}"
                  f"  ({sps:,.0f} env-steps/s incl. learner)  {dt:.0f}s")
    sim.state = state
    print("done in", round(time.perf_counter() - t0, 1), "s")
    return per_ep


if __name__ == "__main__":
    main()
