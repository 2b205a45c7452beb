"""State carried across frameworks: SimState <-> a tree of numpy arrays.

The numpy tree is the JAX package's ``SimState`` flattened field by
field: ``{"tables": {arch: {"columns": {comp: array or {field: array}},
"entity_id", "entity_gen", "num_rows", "overflow"}}, "singletons":
{name: array or {field: array}}, "entities": {"gen", "arch", "row",
"free_ids", "free_top"}, "rng": [W, 2] uint32, "step": [] int32}``.
This is how a simulator's "weights" cross over: both packages can start
from the same state at any step.

Threefry words: the port stores ``rng`` as int64 holding 32-bit values
(torch's uint32 lacks the needed arithmetic); the conversion maps
uint32 <-> int64 exactly. Every other array keeps its dtype.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.archetype import Table
from .core.entity_store import EntityStore
from .core.state import SimState


def _to_torch(x, device):
    if isinstance(x, dict):
        return {k: _to_torch(v, device) for k, v in x.items()}
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def _to_numpy(x):
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    return x.detach().cpu().numpy()


def state_from_numpy(tree, device) -> SimState:
    """The port's SimState from a numpy tree (see the module doc)."""
    rng = np.asarray(tree["rng"])
    if rng.dtype != np.uint32:
        raise ValueError(f"rng must be uint32 Threefry words, got {rng.dtype}")
    return SimState(
        tables={
            name: Table(**_to_torch(t, device))
            for name, t in tree["tables"].items()
        },
        singletons=_to_torch(tree["singletons"], device),
        entities=EntityStore(**_to_torch(tree["entities"], device)),
        rng=torch.from_numpy(rng.astype(np.int64)).to(device),
        step=torch.tensor(int(np.asarray(tree["step"])), dtype=torch.int32,
                          device=device),
    )


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def state_to_numpy(state: SimState):
    """The numpy tree of a SimState (inverse of state_from_numpy)."""
    return {
        "tables": {
            name: _to_numpy(_fields(t)) for name, t in state.tables.items()
        },
        "singletons": _to_numpy(state.singletons),
        "entities": _to_numpy(_fields(state.entities)),
        "rng": state.rng.cpu().numpy().astype(np.uint32),
        "step": np.asarray(int(state.step), np.int32),
    }
