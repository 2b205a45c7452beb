#!/usr/bin/env python
"""Weak scaling of the port: env-steps/s at a constant count of worlds a
rank, one rank a card.

The counterpart of scripts/weak_scaling.py, over torch.distributed: each
rank builds the global sim of ``worlds_per_device * n`` worlds, keeps its
shard (``parallel/mesh.py``: a slice of the global state, on its card)
and ``parallel/distributed.weak_scaling`` times ``--steps`` steps of the
shards between two barriers, for n = 1, 2, 4, ... up to the group's
size. NCCL on the card, gloo with ``--cpu``.

Prints one JSON line on rank 0: ``devices`` (the rank counts timed),
``steps_per_sec`` (env-steps/s over all ranks at each count) and
``efficiency`` (the per-rank rate at each count above the smallest,
relative to the smallest; empty with one rank, which has nothing to
compare with).

Usage:
  python3 scripts/torch_weak_scaling.py [--worlds-per-device 512]
      [--steps 30] [--env escape_room|cartpole] [--cpu]
      (one rank: a group of one process, on the card unless --cpu)
  torchrun --nproc_per_node=<cards> scripts/torch_weak_scaling.py ...
"""

import argparse
import json
import os
import socket
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import torch  # noqa: E402

ENVS = ("escape_room", "cartpole")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_step_fn(env_name: str, device):
    """``make_step(num_worlds, mesh)`` for ``distributed.weak_scaling``:
    the global sim's shard of ``mesh``'s rank, zero actions, and the pure
    step (state, inputs) -> state."""
    from madrona_tpu_torch import make_sim
    from madrona_tpu_torch.parallel import mesh as pmesh

    if env_name == "escape_room":
        from madrona_tpu_torch.models.escape_room import EscapeRoom as Env
    else:
        from madrona_tpu_torch.models.cartpole import Cartpole as Env

    def make_step(num_worlds, mesh):
        env = Env()
        sim = pmesh.shard_sim(
            make_sim(env, num_worlds=num_worlds, seed=0, device=device),
            mesh)
        n = sim.executor.num_worlds
        shape = getattr(env, "action_shape", ())
        inputs = {
            "action": torch.zeros((n,) + tuple(shape), dtype=torch.int32,
                                  device=mesh.device),
            "reset": torch.zeros((n,), dtype=torch.int32, device=mesh.device),
        }
        raw = sim.step_fn()
        return sim.state, inputs, lambda s, i: raw(s, i)[0]

    return make_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds-per-device", type=int, default=512)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--env", default="escape_room", choices=ENVS)
    ap.add_argument("--cpu", action="store_true",
                    help="ranks on the CPU over gloo (default: the card, "
                    "NCCL)")
    args = ap.parse_args(argv)

    from madrona_tpu_torch.parallel import distributed as pdist

    device = "cpu" if args.cpu else None
    own_group = not pdist.is_initialized() and "RANK" not in os.environ
    if own_group:
        # alone: a group of one process, so the run takes the same
        # backend (NCCL on the card) as under torchrun
        pdist.initialize(f"127.0.0.1:{_free_port()}", 1, 0, device=device)
    else:
        pdist.initialize(device=device)
    try:
        n_ranks = pdist.process_count()
        counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= n_ranks]
        res = pdist.weak_scaling(make_step_fn(args.env, device),
                                 args.worlds_per_device, counts,
                                 steps=args.steps, device=device)
        backend = torch.distributed.get_backend()
    finally:
        if own_group:
            torch.distributed.destroy_process_group()
    if res is None:
        return None
    base = min(counts)
    out = {
        "devices": counts,
        "steps_per_sec": {str(k): v for k, v in res["steps_per_sec"].items()},
        "efficiency": {str(k): round(v, 4)
                       for k, v in res["efficiency"].items() if k != base},
        "env": args.env,
        "worlds_per_device": args.worlds_per_device,
        "steps": args.steps,
        "backend": backend,
        "device": ("cpu" if args.cpu
                   else torch.cuda.get_device_name(torch.cuda.current_device())),
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
