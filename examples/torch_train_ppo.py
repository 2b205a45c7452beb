#!/usr/bin/env python
"""PPO on Cartpole with the PyTorch port: the sim and the learner on one
device (the card unless ``--device cpu``).

The counterpart of ``examples/train_ppo.py``, written as plain
functions on tensors: a rollout of ``horizon`` steps through the sim's
pure step function, generalised advantage estimation, and ``epochs``
full-batch Adam steps on the clipped PPO loss whose moments restart at
zero in every update (as the JAX example's ``adam_step`` under
``lax.scan`` does; ``torch.optim.Adam`` keeps its moments across
updates, which is another algorithm). Observations never leave the
device. Actions are drawn with the Gumbel-max rule from an explicit
``torch.Generator`` on the sim's device.

Run: python examples/torch_train_ppo.py [--worlds 1024] [--updates 150]
                                        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from madrona_tpu_torch import make_sim                    # noqa: E402
from madrona_tpu_torch.models.cartpole import Cartpole    # noqa: E402


# ------------------------------------------------------------------ model

class MLP(torch.nn.Module):
    """tanh hidden layers and a linear head: ``x @ w + b`` per layer with
    ``w`` of shape [in, out] (the JAX example's ``mlp``); He-normal
    weights, zero biases."""

    def __init__(self, sizes, generator=None, device=None):
        super().__init__()
        self.w = torch.nn.ParameterList()
        self.b = torch.nn.ParameterList()
        for a, b in zip(sizes[:-1], sizes[1:]):
            w = torch.randn((a, b), generator=generator, device=device)
            self.w.append(torch.nn.Parameter(w * math.sqrt(2.0 / a)))
            self.b.append(torch.nn.Parameter(torch.zeros(b, device=device)))

    def forward(self, x):
        n = len(self.w)
        for i in range(n - 1):
            x = torch.tanh(x @ self.w[i] + self.b[i])
        return x @ self.w[n - 1] + self.b[n - 1]


def mlp_from_numpy(params, device=None) -> MLP:
    """The MLP whose layers are ``params``: the JAX example's
    ``init_mlp`` list of ``{"w": [in, out], "b": [out]}`` arrays."""
    sizes = [params[0]["w"].shape[0]] + [p["w"].shape[1] for p in params]
    net = MLP(sizes, device=device)
    with torch.no_grad():
        for i, p in enumerate(params):
            net.w[i].copy_(torch.tensor(p["w"]))
            net.b[i].copy_(torch.tensor(p["b"]))
    return net


# -------------------------------------------------------------------- PPO

@dataclasses.dataclass(frozen=True)
class PPOConfig:
    horizon: int = 32
    lr: float = 3e-4
    gamma: float = 0.99
    lam: float = 0.95
    clip: float = 0.2
    epochs: int = 4
    vf_coef: float = 0.5
    ent_coef: float = 0.01


def sample_actions(logits, generator):
    """Categorical draws over the last axis (Gumbel-max), int64."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def gae(rew, done, val, last_val, cfg: PPOConfig):
    """Advantages [T, ...] from rewards, done flags (float) and values
    [T, ...] and the value after the last step, backwards in time."""
    adv = torch.zeros_like(last_val)
    nxt = last_val
    out = []
    for t in range(rew.shape[0] - 1, -1, -1):
        keep = 1 - done[t]
        adv = rew[t] + cfg.gamma * keep * nxt - val[t] \
            + cfg.gamma * cfg.lam * keep * adv
        nxt = val[t]
        out.append(adv)
    return torch.stack(out[::-1])


def normalize_adv(adv, allreduce_mean=None):
    """Advantages less their mean, over their population std. With
    ``allreduce_mean`` (a list of tensors -> their means over the
    learner's ranks, each rank holding an equal shard) the mean and std
    are those of the whole batch."""
    if allreduce_mean is None:
        return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    mean = allreduce_mean([adv.mean()])[0]
    var = allreduce_mean([((adv - mean) ** 2).mean()])[0]
    return (adv - mean) / (torch.sqrt(var) + 1e-8)


def ppo_loss(pi, v, batch, cfg: PPOConfig, allreduce_mean=None):
    """The clipped PPO objective with the value and entropy terms, the
    advantages normalised by their mean and population std (over all
    ranks' shards with ``allreduce_mean``; the loss itself is the mean
    over this rank's shard)."""
    logp_all = torch.log_softmax(pi(batch["obs"]), dim=-1)
    logp = torch.gather(logp_all, -1, batch["act"][..., None])[..., 0]
    ratio = torch.exp(logp - batch["logp"])
    adv = normalize_adv(batch["adv"], allreduce_mean)
    pg = -torch.minimum(
        ratio * adv, torch.clamp(ratio, 1 - cfg.clip, 1 + cfg.clip) * adv,
    ).mean()
    v_loss = ((v(batch["obs"])[..., 0] - batch["ret"]) ** 2).mean()
    ent = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
    return pg + cfg.vf_coef * v_loss - cfg.ent_coef * ent


def loss_grads(pi, v, batch, cfg: PPOConfig, allreduce_mean=None):
    """(loss, gradients of ``ppo_loss`` for pi's then v's parameters).
    With ``allreduce_mean`` the gradients are averaged over the ranks:
    for equal shards, the whole batch's gradient."""
    params = list(pi.parameters()) + list(v.parameters())
    loss = ppo_loss(pi, v, batch, cfg, allreduce_mean)
    grads = torch.autograd.grad(loss, params)
    if allreduce_mean is not None:
        grads = allreduce_mean(list(grads))
    return loss, grads


def adam_epochs(pi, v, batch, cfg: PPOConfig, allreduce_mean=None):
    """``cfg.epochs`` full-batch Adam steps on ``ppo_loss``, the moments
    starting at zero; the parameters are updated in place. Returns the
    loss of each epoch (tensors). ``allreduce_mean``: see
    :func:`loss_grads`."""
    params = list(pi.parameters()) + list(v.parameters())
    m = [torch.zeros_like(p) for p in params]
    s = [torch.zeros_like(p) for p in params]
    b1 = torch.tensor(0.9, dtype=torch.float32)
    b2 = torch.tensor(0.999, dtype=torch.float32)
    losses = []
    for t in range(cfg.epochs):
        loss, grads = loss_grads(pi, v, batch, cfg, allreduce_mean)
        # bias corrections in float32, as the JAX example's (t + 1.0)
        c1 = float(1 - b1 ** (t + 1.0))
        c2 = float(1 - b2 ** (t + 1.0))
        with torch.no_grad():
            for p, g, mi, si in zip(params, grads, m, s):
                mi.mul_(0.9).add_(0.1 * g)
                si.mul_(0.999).add_(0.001 * g * g)
                p.sub_(cfg.lr * (mi / c1) / (torch.sqrt(si / c2) + 1e-8))
        losses.append(loss.detach())
    return losses


def update(step_fn, state, pi, v, generator, cfg: PPOConfig, obs_of,
           keep=(), allreduce_mean=None):
    """One PPO update: ``cfg.horizon`` steps of ``step_fn`` from
    ``state`` with actions drawn from ``pi``, the advantages, then
    ``adam_epochs`` (``allreduce_mean``: see :func:`loss_grads`).
    ``obs_of(state)`` gives the observations [W, ..., D]; the reward and
    done of a world are shared by its agents. Returns (state, frames):
    frames holds [T, ...] tensors of the rollout (obs, act, logp, rew,
    done, val, the world's ``ep_done`` and the exports named in
    ``keep``) and ``losses``."""
    frames = {k: [] for k in ("obs", "act", "logp", "rew", "done", "val",
                              "ep_done") + tuple(keep)}
    with torch.no_grad():
        for _ in range(cfg.horizon):
            obs = obs_of(state)
            logits = pi(obs)
            act = sample_actions(logits, generator)
            logp = torch.gather(torch.log_softmax(logits, dim=-1), -1,
                                act[..., None])[..., 0]
            w = obs.shape[0]
            state, outs = step_fn(state, {
                "action": act.to(torch.int32),
                "reset": torch.zeros((w,), dtype=torch.int32,
                                     device=obs.device)})
            lead = (w,) + (1,) * (act.dim() - 1)
            ep_done = outs["done"].to(torch.float32)
            frames["obs"].append(obs)
            frames["act"].append(act)
            frames["logp"].append(logp)
            frames["rew"].append(outs["reward"].reshape(lead).expand(
                act.shape))
            frames["done"].append(ep_done.reshape(lead).expand(act.shape))
            frames["val"].append(v(obs)[..., 0])
            frames["ep_done"].append(ep_done)
            for k in keep:
                frames[k].append(outs[k])
        frames = {k: torch.stack(x) for k, x in frames.items()}
        adv = gae(frames["rew"], frames["done"], frames["val"],
                  v(obs_of(state))[..., 0], cfg)
    batch = dict(obs=frames["obs"], act=frames["act"], logp=frames["logp"],
                 adv=adv, ret=adv + frames["val"])
    frames["losses"] = adam_epochs(pi, v, batch, cfg, allreduce_mean)
    return state, frames


def cart_obs(state):
    return state.tables["Cart"].columns["CartState"][:, 0, :]


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def make_train(num_worlds: int, cfg: PPOConfig, seed: int = 0,
               device=None):
    """(sim, policy, value net) for Cartpole on ``device`` (default: the
    card); the weights drawn from a generator seeded with ``seed``."""
    sim = make_sim(Cartpole(), num_worlds=num_worlds, seed=seed,
                   device=device)
    gen = generator(seed, sim.device)
    pi = MLP([4, 64, 64, 2], generator=gen, device=sim.device)
    v = MLP([4, 64, 64, 1], generator=gen, device=sim.device)
    return sim, pi, v


def save_learner(path: str, nets, gen: torch.Generator) -> None:
    """The learner's side of a checkpoint, beside the sim state's npz
    (``madrona_tpu_torch.utils.checkpoint.save_npz``): every parameter
    of ``nets`` in order, as ``p{net}_{i}``, and the action generator's
    state, so that a resumed run draws the same actions."""
    arrays = {f"p{j}_{i}": p.detach().cpu().numpy()
              for j, net in enumerate(nets)
              for i, p in enumerate(net.parameters())}
    np.savez(path, gen=gen.get_state().numpy(), **arrays)


def load_learner(path: str, nets, gen: torch.Generator) -> None:
    """Restore what :func:`save_learner` wrote into ``nets`` and ``gen``
    in place."""
    with np.load(path) as blob:
        with torch.no_grad():
            for j, net in enumerate(nets):
                for i, p in enumerate(net.parameters()):
                    p.copy_(torch.from_numpy(blob[f"p{j}_{i}"]))
        gen.set_state(torch.from_numpy(blob["gen"]))


def episode_length(frames):
    """Mean episode length over a rollout, 1 / the share of done steps
    (a tensor: no host read)."""
    return 1.0 / torch.clamp(frames["ep_done"].mean(), min=1e-4)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=1024)
    ap.add_argument("--updates", type=int, default=150)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    cfg = PPOConfig()
    sim, pi, v = make_train(args.worlds, cfg, args.seed, args.device)
    gen = generator(args.seed + 100, sim.device)   # the actions' stream
    step_fn = sim.step_fn()
    state = sim.state
    t0 = time.perf_counter()
    ep_len = None
    for u in range(args.updates):
        state, frames = update(step_fn, state, pi, v, gen, cfg, cart_obs)
        ep_len = episode_length(frames)
        if (u + 1) % 10 == 0:
            dt = time.perf_counter() - t0
            sps = (u + 1) * cfg.horizon * args.worlds / dt
            print(f"update {u+1:4d}  avg episode length ~{float(ep_len):6.1f}"
                  f"  ({sps:,.0f} env-steps/s incl. learner)")
    sim.state = state
    print("done in", round(time.perf_counter() - t0, 1), "s")
    return float(ep_len)


if __name__ == "__main__":
    main()
