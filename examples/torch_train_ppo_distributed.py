#!/usr/bin/env python
"""PPO on Cartpole over several processes: worlds sharded, parameters
replicated (the PyTorch port's counterpart of
``examples/train_ppo_distributed.py``).

Every rank builds the global sim from the seed and keeps its own
contiguous slice of the worlds (``madrona_tpu_torch.parallel.mesh``),
steps only that shard, and draws its actions from a generator seeded
``seed + 100 + rank`` (rank 0 draws the single-process example's
stream). The networks start from rank 0's parameters (a broadcast).
The learner is ``examples/torch_train_ppo.py``'s ``update``: each
rank's loss is the mean over its shard, with the advantages normalised
by the whole batch's mean and std, and the gradients are all-reduced
(sum / world size) before each full-batch Adam step, which for equal
shards is the whole batch's gradient. The env step needs no collective.

Run on the cards of one host (one process a card, NCCL):
    torchrun --nproc_per_node=<cards> examples/torch_train_ppo_distributed.py
Run N gloo processes on the CPU:
    python examples/torch_train_ppo_distributed.py --cpu-procs 2 \
        --worlds 256 --updates 25
Without torchrun and without ``--cpu-procs`` it runs as one process on
the card.
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from madrona_tpu_torch.parallel import distributed as pdist   # noqa: E402
from madrona_tpu_torch.parallel import mesh as pmesh          # noqa: E402

import torch_train_ppo as tpp                                 # noqa: E402


def allreduce_mean(tensors):
    """The mean of each tensor over the group's ranks (one all-reduce of
    their flat concatenation: the sum, then / world size)."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out


def flat_params(nets) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for n in nets
                      for p in n.parameters()])


def params_equal_across_ranks(nets) -> bool:
    """All ranks hold the same parameters, bit for bit (an all_gather of
    a flat copy)."""
    flat = flat_params(nets)
    got = [torch.empty_like(flat) for _ in range(dist.get_world_size())]
    dist.all_gather(got, flat)
    return all(torch.equal(g, got[0]) for g in got)


def train(args, mesh: pmesh.Mesh, log=print):
    """PPO on this rank's shard of ``args.worlds`` worlds. Returns
    (the last update's mean episode length over all ranks, pi, v)."""
    grouped = pdist.is_initialized()
    cfg = tpp.PPOConfig()
    sim, pi, v = tpp.make_train(args.worlds, cfg, args.seed, mesh.device)
    pmesh.shard_sim(sim, mesh)
    reduce = allreduce_mean if grouped else None
    if grouped:
        for p in list(pi.parameters()) + list(v.parameters()):
            dist.broadcast(p.data, src=0)
    gen = tpp.generator(args.seed + 100 + mesh.rank, mesh.device)
    step_fn = sim.step_fn()
    state = sim.state
    log(f"ranks: {mesh.world_size}  worlds/rank: {sim.executor.num_worlds}"
        f"  device: {mesh.device}")
    t0 = time.perf_counter()
    ep_len = None
    for u in range(args.updates):
        state, frames = tpp.update(step_fn, state, pi, v, gen, cfg,
                                   tpp.cart_obs, allreduce_mean=reduce)
        done = frames["ep_done"].mean()
        if grouped:
            done = allreduce_mean([done])[0]
        ep_len = 1.0 / torch.clamp(done, min=1e-4)
        if (u + 1) % 10 == 0:
            dt = time.perf_counter() - t0
            sps = (u + 1) * cfg.horizon * args.worlds / dt
            log(f"update {u+1:4d}  avg episode length ~{float(ep_len):6.1f}"
                f"  ({sps:,.0f} env-steps/s incl. learner, "
                f"{mesh.world_size} ranks)")
    sim.state = state
    log(f"done in {round(time.perf_counter() - t0, 1)} s")
    return float(ep_len), pi, v


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cpu_worker(rank, n, port, args, queue):
    torch.set_num_threads(1)
    pdist.initialize(f"127.0.0.1:{port}", n, rank, device="cpu")
    try:
        ep_len, pi, v = train(args, pdist.global_mesh("cpu"),
                              log=print if rank == 0 else (lambda *a: None))
        same = params_equal_across_ranks([pi, v])
        queue.put((rank, ep_len, same, flat_params([pi, v]).numpy()))
    finally:
        dist.destroy_process_group()


def run_cpu_procs(args):
    """``args.cpu_procs`` gloo ranks on the CPU, spawned; returns rank
    0's (episode length, pi) after checking every rank's parameters
    equal rank 0's."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_cpu_worker,
                         args=(r, args.cpu_procs, port, args, queue))
             for r in range(args.cpu_procs)]
    for p in procs:
        p.start()
    try:
        results = sorted(queue.get(timeout=600) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
    if any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"worker exit codes {[p.exitcode for p in procs]}")
    flat0 = results[0][3]
    if not all(r[2] and np.array_equal(r[3], flat0) for r in results):
        raise RuntimeError("parameters differ across ranks")
    cfg = tpp.PPOConfig()
    _, pi, v = tpp.make_train(8, cfg, args.seed, "cpu")
    torch.nn.utils.vector_to_parameters(
        torch.from_numpy(flat0[:sum(p.numel() for p in pi.parameters())]),
        pi.parameters())
    return results[0][1], pi


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=1024)
    ap.add_argument("--updates", type=int, default=150)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu-procs", type=int, default=0,
                    help="spawn this many gloo ranks on the CPU")
    ap.add_argument("--device", default=None,
                    help="without --cpu-procs: the card (default) or cpu")
    args = ap.parse_args(argv)
    if args.cpu_procs:
        return run_cpu_procs(args)
    # under torchrun: joins the group (NCCL on the card); alone: no-op
    pdist.initialize(device=args.device)
    mesh = pdist.global_mesh(args.device)
    pdist.worlds_per_host(args.worlds)
    ep_len, pi, v = train(args, mesh,
                          log=print if mesh.rank == 0 else (lambda *a: None))
    if pdist.is_initialized() and not params_equal_across_ranks([pi, v]):
        raise RuntimeError("parameters differ across ranks")
    return ep_len, pi


if __name__ == "__main__":
    main()
