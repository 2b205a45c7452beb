#!/usr/bin/env python
"""Vision PPO on Hide & Seek with the PyTorch port: RGBD pixels from the
batch renderer feed a conv policy; the sim, the render and the learner
on one device (the card unless ``--device cpu``).

The counterpart of ``examples/train_ppo_pixels.py``: the reference's
headline use, agents trained from the batch renderer's pixels. Each
environment step runs the physics (the broadphase, contacts and solver
kernels) and the render (the raycast kernel); the observation is
``concat(rgb, min(depth / t_max, 1))`` a view, 4 channels, and never
leaves the device. The encoder is two 3x3 stride-2 convolutions (16, 32)
in bfloat16, their bias added in bfloat16, with padding "SAME" as XLA
pads it (0 before and 1 after on an even size), then a tanh trunk of 128
and one linear head per action column (4, 8, 5, 2, 2) and a value head
in float32. Log-probabilities and entropies sum over the heads.

The Adam moments and step count carry across updates (the JAX example
threads ``opt_m, opt_v, t_step`` through its jitted update), unlike
``torch_train_ppo.py``'s, which restart every update. Actions are drawn
with the Gumbel-max rule from an explicit ``torch.Generator`` on the
sim's device.

Run: python examples/torch_train_ppo_pixels.py [--worlds 256]
     [--updates 50] [--render-size 16] [--tier dense|blas]
     [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time

import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from madrona_tpu_torch import make_sim                     # noqa: E402
from madrona_tpu_torch.models import hide_seek as hs       # noqa: E402
from torch_train_ppo import gae, generator                 # noqa: E402


# ------------------------------------------------------------- network

def _same_pad(size: int, stride: int = 2, k: int = 3):
    """(before, after) padding of XLA's "SAME" for one axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class ConvNet(torch.nn.Module):
    """The JAX example's ``init_conv_net`` / ``encode``: parameters in
    its layout (conv weights HWIO, linear weights [in, out]) and its
    init scales (He-normal convs and trunk, 0.01 policy heads, unit
    value head, zero biases), drawn from ``generator``."""

    def __init__(self, h, w, c, n_heads, widths=(16, 32), hidden=128,
                 generator=None, device=None):
        super().__init__()
        self.n_heads = tuple(n_heads)
        self.n_conv = len(widths)
        p = {}

        def normal(*shape):
            return torch.randn(shape, generator=generator, device=device)

        def zeros(n):
            return torch.zeros(n, device=device)

        c_in = c
        for i, c_out in enumerate(widths):
            p[f"conv{i}_w"] = normal(3, 3, c_in, c_out) * math.sqrt(
                2.0 / (9 * c_in))
            p[f"conv{i}_b"] = zeros(c_out)
            c_in = c_out
        hh, ww = h, w
        for _ in widths:
            hh, ww = (hh + 1) // 2, (ww + 1) // 2
        flat = hh * ww * widths[-1]
        p["fc_w"] = normal(flat, hidden) * math.sqrt(2.0 / flat)
        p["fc_b"] = zeros(hidden)
        for j, n in enumerate(self.n_heads):
            p[f"pi{j}_w"] = normal(hidden, n) * 0.01
            p[f"pi{j}_b"] = zeros(n)
        p["v_w"] = normal(hidden, 1)
        p["v_b"] = zeros(1)
        self.p = torch.nn.ParameterDict(
            {k: torch.nn.Parameter(v) for k, v in p.items()})

    def forward(self, rgbd):
        """rgbd [B, H, W, C] float -> (per-head logits list, value [B]).
        The convolutions run in bfloat16, the trunk and heads in
        float32."""
        p = self.p
        x = rgbd.to(torch.bfloat16).permute(0, 3, 1, 2)        # NCHW
        for i in range(self.n_conv):
            ph, pw = _same_pad(x.shape[2]), _same_pad(x.shape[3])
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            w = p[f"conv{i}_w"].to(torch.bfloat16).permute(3, 2, 0, 1)
            x = F.conv2d(x, w, stride=2) + p[f"conv{i}_b"].to(
                torch.bfloat16)[None, :, None, None]
            x = torch.relu(x)
        # the JAX example flattens NHWC
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1).float()
        h = torch.tanh(x @ p["fc_w"] + p["fc_b"])
        logits = [h @ p[f"pi{j}_w"] + p[f"pi{j}_b"]
                  for j in range(len(self.n_heads))]
        return logits, (h @ p["v_w"] + p["v_b"])[..., 0]


def conv_net_from_numpy(params, n_heads, device=None) -> ConvNet:
    """The ConvNet holding the JAX example's ``init_conv_net`` params
    ({"conv0": {"w", "b"}, ..., "fc", "pi0", ..., "v"}, numpy arrays)."""
    w0 = params["conv0"]["w"]
    n_conv = sum(1 for k in params if k.startswith("conv"))
    widths = tuple(params[f"conv{i}"]["w"].shape[3] for i in range(n_conv))
    hidden = params["fc"]["w"].shape[1]
    net = ConvNet(1, 1, w0.shape[2], n_heads, widths, hidden, device=device)
    with torch.no_grad():
        for name, sub in params.items():
            for k, arr in sub.items():
                net.p[f"{name}_{k}"] = torch.nn.Parameter(
                    torch.tensor(arr, device=device))
    return net


def sample_multi(logits, generator):
    """One draw a head (Gumbel-max): act [B, K] int32, logp [B] summed
    over the heads."""
    acts, logp = [], 0.0
    for lg in logits:
        u = torch.rand(lg.shape, generator=generator, device=lg.device)
        a = torch.argmax(lg - torch.log(-torch.log(u)), dim=-1)
        logp = logp + torch.gather(torch.log_softmax(lg, dim=-1), -1,
                                   a[:, None])[:, 0]
        acts.append(a)
    return torch.stack(acts, -1).to(torch.int32), logp


def logp_entropy(logits, act):
    """act [B, K] -> (logp [B], entropy [B]) summed over the heads."""
    lp_sum, ent_sum = 0.0, 0.0
    for j, lg in enumerate(logits):
        lsm = torch.log_softmax(lg, dim=-1)
        lp_sum = lp_sum + torch.gather(lsm, -1, act[:, j:j + 1].long())[:, 0]
        ent_sum = ent_sum - (torch.exp(lsm) * lsm).sum(-1)
    return lp_sum, ent_sum


# ----------------------------------------------------------------- PPO

@dataclasses.dataclass(frozen=True)
class VPPOConfig:
    horizon: int = 16
    lr: float = 2.5e-4
    gamma: float = 0.99
    lam: float = 0.95
    clip: float = 0.2
    epochs: int = 2
    vf_coef: float = 0.5
    ent_coef: float = 0.01


def ppo_loss(net, batch, cfg: VPPOConfig):
    """The clipped PPO objective over the heads, with the value and
    entropy terms; advantages normalised by their mean and population
    std."""
    logits, v = net(batch["obs"])
    lp, ent = logp_entropy(logits, batch["act"])
    ratio = torch.exp(lp - batch["logp"])
    adv = batch["adv"]
    adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    pg = -torch.minimum(
        ratio * adv, torch.clamp(ratio, 1 - cfg.clip, 1 + cfg.clip) * adv,
    ).mean()
    v_loss = ((v - batch["ret"]) ** 2).mean()
    return pg + cfg.vf_coef * v_loss - cfg.ent_coef * ent.mean()


def adam_init(net):
    """Zero moments and a float32 step count on the net's device."""
    params = list(net.parameters())
    return {"m": [torch.zeros_like(p) for p in params],
            "v": [torch.zeros_like(p) for p in params],
            "t": torch.zeros((), dtype=torch.float32,
                             device=params[0].device)}


def adam_epochs(net, opt, batch, cfg: VPPOConfig):
    """``cfg.epochs`` full-batch Adam steps on ``ppo_loss``, the moments
    and step count of ``opt`` carried in (and updated in place, as are
    the parameters); the bias corrections in float32 from the step
    count, as the JAX example's ``1 - 0.9 ** t``. Returns the loss of
    each epoch (tensors)."""
    params = list(net.parameters())
    b1 = torch.tensor(0.9, dtype=torch.float32, device=opt["t"].device)
    b2 = torch.tensor(0.999, dtype=torch.float32, device=opt["t"].device)
    losses = []
    for _ in range(cfg.epochs):
        loss = ppo_loss(net, batch, cfg)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            opt["t"] += 1.0
            c1 = 1 - b1 ** opt["t"]
            c2 = 1 - b2 ** opt["t"]
            for p, g, m, s in zip(params, grads, opt["m"], opt["v"]):
                m.mul_(0.9).add_(0.1 * g)
                s.mul_(0.999).add_(0.001 * g * g)
                p.sub_(cfg.lr * (m / c1) / (torch.sqrt(s / c2) + 1e-8))
        losses.append(loss.detach())
    return losses


def update(step_fn, state, obs, net, opt, gen, cfg: VPPOConfig, obs_of):
    """One update: ``cfg.horizon`` steps of ``step_fn`` from ``state``
    with the policy's actions on ``obs`` [W * A, H, W, 4], the
    advantages, then ``adam_epochs``. Returns (state, the last
    observations, frames): frames holds the rollout's [T, ...] tensors
    (obs, act, logp, rew, done, val) and ``losses``."""
    frames = {k: [] for k in ("obs", "act", "logp", "rew", "done", "val")}
    b = obs.shape[0]
    with torch.no_grad():
        for _ in range(cfg.horizon):
            logits, val = net(obs)
            act, logp = sample_multi(logits, gen)
            w = b // hs.N_AGENTS
            state, outs = step_fn(state, {
                "action": act.reshape(w, hs.N_AGENTS, -1),
                "reset": torch.zeros((w,), dtype=torch.int32,
                                     device=obs.device)})
            frames["obs"].append(obs)
            frames["act"].append(act)
            frames["logp"].append(logp)
            frames["rew"].append(outs["reward"].reshape(b))
            frames["done"].append(outs["done"].to(torch.float32)
                                  .repeat_interleave(hs.N_AGENTS))
            frames["val"].append(val)
            obs = obs_of(outs)
        frames = {k: torch.stack(x) for k, x in frames.items()}
        _, last_val = net(obs)
        adv = gae(frames["rew"], frames["done"], frames["val"], last_val,
                  cfg)
    flat = lambda a: a.reshape((-1,) + a.shape[2:])  # noqa: E731
    batch = dict(obs=flat(frames["obs"]), act=flat(frames["act"]),
                 logp=flat(frames["logp"]), adv=flat(adv),
                 ret=flat(adv + frames["val"]))
    frames["losses"] = adam_epochs(net, opt, batch, cfg)
    return state, obs, frames


def make_train(num_worlds: int, cfg: VPPOConfig, seed: int = 0,
               render_size: int = 16, tier: str = "dense", device=None):
    """(sim, step_fn, state, first observations, net, obs_of) for Hide &
    Seek with pixels on ``device`` (default: the card). The dense tier
    culls each view to 8 instances (``tlas_max_instances=8``, as the JAX
    example); the first observations come from one zero-action step."""
    env = hs.HideSeek(render_size=render_size, pixels=True, render_tier=tier,
                      tlas_max_instances=(8 if tier == "dense" else 0))
    sim = make_sim(env, num_worlds=num_worlds, seed=seed, device=device)
    step_fn = sim.step_fn()
    b = num_worlds * hs.N_AGENTS
    net = ConvNet(render_size, render_size, 4, env.action_buckets,
                  generator=generator(seed, sim.device), device=sim.device)
    t_max = env.rcfg.t_max

    def obs_of(outs):
        rgb = outs["rgb"].reshape(b, render_size, render_size, 3)
        dep = outs["depth"].reshape(b, render_size, render_size, 1)
        return torch.cat([rgb, torch.clamp(dep / t_max, max=1.0)], -1)

    state, outs0 = step_fn(sim.state, {
        "action": torch.zeros((num_worlds, hs.N_AGENTS,
                               len(env.action_buckets)),
                              dtype=torch.int32, device=sim.device),
        "reset": torch.zeros((num_worlds,), dtype=torch.int32,
                             device=sim.device)})
    return sim, step_fn, state, obs_of(outs0), net, obs_of


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=256)
    ap.add_argument("--updates", type=int, default=50)
    ap.add_argument("--render-size", type=int, default=16)
    ap.add_argument("--tier", default="dense", choices=("dense", "blas"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    cfg = VPPOConfig()
    sim, step_fn, state, obs, net, obs_of = make_train(
        args.worlds, cfg, args.seed, args.render_size, args.tier,
        args.device)
    opt = adam_init(net)
    gen = generator(args.seed + 7, sim.device)   # the actions' stream
    t0 = time.perf_counter()
    mean_rew = None
    for u in range(args.updates):
        state, obs, frames = update(step_fn, state, obs, net, opt, gen, cfg,
                                    obs_of)
        mean_rew = frames["rew"].mean()
        if (u + 1) % 5 == 0:
            dt = time.perf_counter() - t0
            sps = (u + 1) * cfg.horizon * args.worlds / dt
            print(f"update {u+1:4d}  mean step reward {float(mean_rew):+.4f}"
                  f"  ({sps:,.0f} env-steps/s incl. render + learner)")
    sim.state = state
    print("done in", round(time.perf_counter() - t0, 1), "s")
    return float(mean_rew)


if __name__ == "__main__":
    main()
