"""Multi-process runtime: torch.distributed glue and a weak-scaling
harness.

Port of ``madrona_tpu/parallel/distributed.py``. One process drives one
card; worlds are sharded over the processes (``parallel/mesh.py``). A
step holds no collective, so scaling loss can come only from dispatch
skew, which :func:`weak_scaling` measures. Nothing here falls back
silently: a CUDA device takes NCCL (and raises where NCCL is missing),
the CPU takes gloo, and the device is the card unless the caller names
the CPU.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from . import mesh as _mesh


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device=None,
):
    """``torch.distributed.init_process_group``: NCCL for a CUDA device
    (default: the card), gloo for the CPU.

    With explicit arguments, joins that exact group (``coordinator_address``
    is ``host:port`` of rank 0). With none, reads torchrun's ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``, and is a no-op
    where they are absent (a plain single process), as the JAX package's
    auto-detection is. A group already initialized is kept."""
    if is_initialized():
        return
    explicit = (coordinator_address, num_processes, process_id)
    if all(a is None for a in explicit):
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            return                       # single process: nothing to do
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        init_method = "env://"
    elif any(a is None for a in explicit):
        raise ValueError("initialize: give coordinator_address, "
                         "num_processes and process_id together")
    else:
        rank, world_size = int(process_id), int(num_processes)
        init_method = f"tcp://{coordinator_address}"
    dev = _mesh._local_device(device, rank)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA device needs NCCL, which this "
                               "PyTorch build lacks")
        torch.cuda.set_device(dev)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def global_mesh(device=None) -> _mesh.Mesh:
    """This process's place in the group (``mesh.make_mesh``)."""
    return _mesh.make_mesh(device)


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def worlds_per_host(num_worlds_global: int) -> int:
    n = process_count()
    if num_worlds_global % n:
        raise ValueError(
            f"{num_worlds_global} worlds not divisible by {n} hosts"
        )
    return num_worlds_global // n


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def weak_scaling(
    make_step: Callable,
    worlds_per_device: int,
    device_counts,
    steps: int = 20,
    device=None,
):
    """Throughput at each process count with constant work a process.

    Runs in every rank of the group. For each count n (up to the group's
    size; without a group, 1 only), ranks < n call
    ``make_step(worlds_per_device * n, mesh)`` with ``mesh = Mesh(rank,
    n, device)``, which returns ``(state, inputs, fn)`` for this rank's
    shard, ``fn(state, inputs)`` -> state (or a tuple led by it); they
    step it ``steps`` times between two barriers, each rank's card
    synchronized before the second. Rank 0 returns {"steps_per_sec":
    {n: env-steps/s over all n ranks}, "efficiency": {n: per-rank rate
    relative to the smallest count}}; the other ranks return None."""
    grouped = is_initialized()
    base = global_mesh(device)
    results = {}
    for n in device_counts:
        if n > base.world_size:
            break
        active = base.rank < n
        if active:
            state, inputs, fn = make_step(
                worlds_per_device * n, _mesh.Mesh(base.rank, n, base.device))
            out = fn(state, inputs)
            _sync(base.device)
        if grouped:
            dist.barrier()
        t0 = time.perf_counter()
        if active:
            for _ in range(steps):
                out = fn(out[0] if isinstance(out, tuple) else out, inputs)
            _sync(base.device)
        if grouped:
            dist.barrier()
        dt = time.perf_counter() - t0
        results[n] = steps * worlds_per_device * n / dt
    if base.rank != 0:
        return None
    if not results:
        return {"steps_per_sec": {}, "efficiency": {}}
    base_n = min(results)
    per = results[base_n] / base_n
    return {
        "steps_per_sec": results,
        "efficiency": {n: (v / n) / per for n, v in results.items()},
    }
