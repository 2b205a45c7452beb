#!/usr/bin/env python
"""A torch learner on the PyTorch port through ``TrainInterface``.

The counterpart of ``examples/train_torch_reinforce.py``: a torch
policy (REINFORCE with reward-to-go, Adam) steps Cartpole through
``madrona_tpu_torch.interop.TrainInterface.torch_step``. The sim's
exports arrive as the state's own tensors on the sim's device (the card
unless ``--device cpu``), and the actions go back in on that device:
no host copy on the way.

Usage: python examples/torch_train_reinforce.py [--worlds 256]
       [--updates 60] [--horizon 64] [--device cuda|cpu]
"""

import argparse
import os
import sys
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from madrona_tpu_torch import make_sim                    # noqa: E402
from madrona_tpu_torch.interop import TrainInterface      # noqa: E402
from madrona_tpu_torch.models.cartpole import Cartpole    # noqa: E402


def make_policy(device):
    return torch.nn.Sequential(
        torch.nn.Linear(4, 64), torch.nn.Tanh(), torch.nn.Linear(64, 2),
    ).to(device)


def train(ti, policy, updates, horizon, log_every=10):
    """``updates`` REINFORCE updates of ``horizon`` steps each through
    ``ti``; returns (mean episode length of the last rollout, the loss
    of each update as tensors)."""
    dev = ti.sim.device
    w = ti.sim.executor.num_worlds
    opt = torch.optim.Adam(policy.parameters(), lr=1e-2)
    reset = torch.zeros(w, dtype=torch.int32, device=dev)
    t0 = time.perf_counter()
    ep_len, losses = 0.0, []
    for u in range(updates):
        logps, rews, dones = [], [], []
        obs = ti.step_outputs["obs"][:, 0, :]
        for _ in range(horizon):
            dist = torch.distributions.Categorical(logits=policy(obs))
            act = dist.sample()
            outs = ti.torch_step(action=act.to(torch.int32), reset=reset)
            logps.append(dist.log_prob(act))
            rews.append(outs["reward"])
            dones.append(outs["done"].to(torch.float32))
            obs = outs["obs"][:, 0, :]

        # reward-to-go with done masking
        ret = torch.zeros(w, device=dev)
        returns = []
        for r, d in zip(reversed(rews), reversed(dones)):
            ret = r + 0.99 * ret * (1.0 - d)
            returns.append(ret)
        returns.reverse()
        rstack = torch.stack(returns)
        rstack = (rstack - rstack.mean()) / (rstack.std() + 1e-6)
        loss = -(torch.stack(logps) * rstack).mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.detach())

        ep_len = 1.0 / max(torch.stack(dones).mean().item(), 1e-4)
        if log_every and (u + 1) % log_every == 0:
            print(f"update {u+1:3d}  avg episode length ~{ep_len:6.1f}  "
                  f"({(u+1)*horizon*w/(time.perf_counter()-t0):,.0f} "
                  "env-steps/s through the train interface)")
    return ep_len, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=256)
    ap.add_argument("--updates", type=int, default=60)
    ap.add_argument("--horizon", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    torch.manual_seed(args.seed)
    sim = make_sim(Cartpole(), num_worlds=args.worlds, seed=args.seed,
                   device=args.device)
    ti = TrainInterface(sim)
    assert "action" in ti.step_inputs and "obs" in ti.step_outputs
    t0 = time.perf_counter()
    ep_len, _ = train(ti, make_policy(sim.device), args.updates,
                      args.horizon)
    print("done in", round(time.perf_counter() - t0, 1), "s")
    return ep_len


if __name__ == "__main__":
    main()
