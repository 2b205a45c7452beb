"""Per-world checkpoint and restore, and the state on disk.

Port of ``madrona_tpu/utils/checkpoint.py``: the reference's env
checkpointing (``TrainCheckpointingInterface``, per-world should_save /
should_restore masks) as a masked select of every ``[W, ...]`` tensor
of the state into a snapshot, and back.

:func:`save_npz` / :func:`load_npz` write and read the whole state as
one ``.npz`` file of ``leaf_{i}`` arrays, in the JAX package's
``jax.tree_util.tree_flatten`` order of its ``SimState`` (dataclass
fields in order, dict keys sorted) and with its dtypes (the Threefry
words as uint32), so that a file saved by either package loads into the
other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.archetype import Table
from ..core.entity_store import EntityStore
from ..core.state import SimState
from ..interop import state_from_numpy, state_to_numpy


def _map(fn, *trees):
    """``fn`` over the matching tensors of SimStates (or their parts)."""
    a = trees[0]
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            f.name: _map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(a)})
    if isinstance(a, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in a}
    return fn(*trees)


def snapshot(state: SimState) -> SimState:
    """A checkpoint buffer covering all worlds (a copy of ``state``)."""
    return _map(torch.clone, state)


def _masked_select(mask, new, old, scalars_from_new: bool):
    """Per-world select; global scalars (the step counter) cannot be
    per-world, so they follow the live side of each operation."""

    def sel(n, o):
        if n.dim() == 0:
            return (n if scalars_from_new else o).clone()
        m = mask.to(n.device).reshape(mask.shape + (1,) * (n.dim() - 1))
        return torch.where(m, n, o)

    return _map(sel, new, old)


def _mask(should):
    return torch.as_tensor(should).to(torch.bool)


def save_worlds(ckpt: SimState, state: SimState, should_save) -> SimState:
    """ckpt' = state where should_save [W] else ckpt (the reference's
    save_ckpts); the step counter comes from ``state``."""
    return _masked_select(_mask(should_save), state, ckpt,
                          scalars_from_new=True)


def restore_worlds(state: SimState, ckpt: SimState,
                   should_restore) -> SimState:
    """state' = ckpt where should_restore [W] else state (restore_ckpts).
    The global step counter stays live, so that the RNG streams after a
    restore are fresh rather than replaying the checkpoint's future."""
    return _masked_select(_mask(should_restore), ckpt, state,
                          scalars_from_new=False)


# ------------------------------------------------------------ disk I/O

def _paths(tree):
    """The key paths of the numpy tree's arrays in
    ``jax.tree_util.tree_flatten`` order of the JAX package's SimState:
    dataclass fields in order (the SimState's, a Table's, the
    EntityStore's), every dict (tables, columns, singletons, a
    component's fields) by sorted key."""
    out = []

    def by_key(t, path):
        if isinstance(t, dict):
            for k in sorted(t):
                by_key(t[k], path + (k,))
        else:
            out.append(path)

    for f in dataclasses.fields(SimState):
        if f.name == "tables":
            for name in sorted(tree["tables"]):
                for g in dataclasses.fields(Table):
                    by_key(tree["tables"][name][g.name],
                           ("tables", name, g.name))
        elif f.name == "entities":
            out += [("entities", g.name)
                    for g in dataclasses.fields(EntityStore)]
        else:
            by_key(tree[f.name], (f.name,))
    return out


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _leaves(tree):
    """The numpy tree's arrays in the JAX package's leaf order."""
    return [_get(tree, p) for p in _paths(tree)]


def _unflatten(like, leaves):
    """``like``'s numpy tree with its arrays replaced, in leaf order, by
    ``leaves``."""
    def copy(t):
        return {k: copy(v) for k, v in t.items()} if isinstance(t, dict) \
            else t

    out = copy(like)
    for path, leaf in zip(_paths(like), leaves):
        _get(out, path[:-1])[path[-1]] = leaf
    return out


def save_npz(path: str, state: SimState) -> None:
    leaves = _leaves(state_to_numpy(state))
    np.savez_compressed(
        path, **{f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)})


def load_npz(path: str, like: SimState) -> SimState:
    """A SimState of ``like``'s structure, on ``like``'s device, from a
    saved file; a leaf whose shape or dtype differs raises."""
    ref_tree = state_to_numpy(like)
    refs = _leaves(ref_tree)
    loaded = []
    with np.load(path) as data:
        for i, ref in enumerate(refs):
            arr = data[f"leaf_{i}"]
            if arr.shape != ref.shape or arr.dtype != ref.dtype:
                raise ValueError(
                    f"checkpoint leaf {i} mismatch: saved "
                    f"{arr.shape}/{arr.dtype} vs expected "
                    f"{ref.shape}/{ref.dtype}")
            loaded.append(arr)
    return state_from_numpy(_unflatten(ref_tree, loaded), like.step.device)
