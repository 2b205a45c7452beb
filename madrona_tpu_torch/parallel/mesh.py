"""World sharding over the processes of a torch.distributed group.

Port of ``madrona_tpu/parallel/mesh.py``. Worlds are the shard unit:
every state tensor with a leading ``[num_worlds]`` axis is split into
contiguous slices, one a process, and a step holds no cross-world
communication (collectives appear only in the learner). In PyTorch one
process drives one card, so a "mesh" is this process's place in the
group and its device: :class:`Mesh` ``(rank, world_size, device)``,
rank r holding worlds ``[r W / n, (r + 1) W / n)``.

The per-world keys are ``split_i(key(seed), arange(W))``
(``core/state.py``), so a shard is a slice of the global sim's state,
as the JAX package's ``device_put`` places it: a sim built with W / n
worlds would repeat worlds ``0 .. W/n - 1`` on every rank. Nothing at
step time reads the global count (the nodes take W from their tensors'
shapes), so a shard steps as a sim of W / n worlds; ``shard_sim`` sets
the executor's ``num_worlds`` to match.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from ..core.device import resolve_device
from ..utils.tree import tree_leaves, tree_map

WORLD_AXIS = "worlds"


class Mesh(NamedTuple):
    """This process's rank, the group's size, and the device it steps
    its worlds on."""

    rank: int
    world_size: int
    device: torch.device


def _local_device(device, rank: int) -> torch.device:
    """``device`` resolved (None: the card); a CUDA device without an
    index becomes this process's card, ``LOCAL_RANK`` (torchrun's) or
    the rank, modulo the cards."""
    import os

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return dev


def make_mesh(device=None) -> Mesh:
    """(rank, world_size, device) of the initialized process group, or
    (0, 1, device) where there is none."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        rank, n = dist.get_rank(), dist.get_world_size()
    else:
        rank, n = 0, 1
    return Mesh(rank, n, _local_device(device, rank))


def _world_count(state) -> int:
    return state.rng.shape[0]


def state_shardings(state):
    """The state's tree with each tensor replaced by :data:`WORLD_AXIS`
    where it is sharded (a leading axis of num_worlds) and None where it
    is replicated (scalars such as the step counter): the JAX rule."""
    w = _world_count(state)
    return tree_map(lambda x: WORLD_AXIS if x.dim() >= 1 and x.shape[0] == w
                    else None, state)


def _slice(mesh: Mesh, w: int):
    if w % mesh.world_size:
        raise ValueError(f"{w} worlds not divisible by {mesh.world_size} "
                         "shards")
    per = w // mesh.world_size
    return mesh.rank * per, (mesh.rank + 1) * per


def shard_tree(tree, w: int, mesh: Mesh):
    """Rank ``mesh.rank``'s slice of every tensor of ``tree`` with a
    leading axis of ``w``, on ``mesh.device`` (a copy); the others whole
    on the device."""
    lo, hi = _slice(mesh, w)

    def place(x):
        if x.dim() >= 1 and x.shape[0] == w:
            return x[lo:hi].to(mesh.device, copy=True)
        return x.to(mesh.device)

    return tree_map(place, tree)


def shard_state(state, mesh: Optional[Mesh] = None):
    """This rank's shard of a SimState: worlds ``[r W/n, (r+1) W/n)`` of
    every sharded tensor, the replicated ones whole, on the mesh's
    device."""
    mesh = mesh or make_mesh()
    return shard_tree(state, _world_count(state), mesh)


def input_shardings(inputs: Any):
    """Inputs (action/reset slots) are [W, ...]: every one sharded."""
    return tree_map(lambda x: WORLD_AXIS, inputs)


def shard_inputs(inputs: Any, num_worlds: int, mesh: Optional[Mesh] = None):
    """This rank's slice of step inputs of ``num_worlds`` worlds."""
    return shard_tree(inputs, num_worlds, mesh or make_mesh())


def shard_sim(sim, mesh: Optional[Mesh] = None):
    """Replace a live Sim's state by this rank's shard, and its
    executor's ``num_worlds`` by the shard's count."""
    mesh = mesh or make_mesh()
    sim.state = shard_state(sim.state, mesh)
    sim.executor.num_worlds = _world_count(sim.state)
    return sim


def join_shards(shards, per_shard_worlds: int):
    """The global tree of per-rank trees in rank order: tensors with a
    leading axis of ``per_shard_worlds`` concatenated, the others taken
    from rank 0."""
    first = shards[0]
    flat = [[t for _, t in tree_leaves(s)] for s in shards]
    it = iter(range(len(flat[0])))

    def join(x):
        j = next(it)
        if x.dim() >= 1 and x.shape[0] == per_shard_worlds:
            return torch.cat([f[j] for f in flat], dim=0)
        return x

    return tree_map(join, first)
