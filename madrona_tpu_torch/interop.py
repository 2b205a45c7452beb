"""State and render tables carried across frameworks, through numpy.

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

The render tables cross the same way: :func:`blas_from_numpy`,
:func:`blas4_from_numpy`, :func:`materials_from_numpy` and
:func:`lights_from_numpy` take the fields of the JAX package's
``BlasTables``, ``Blas4Tables``, ``MaterialTables`` and ``Lights`` as a
mapping of numpy arrays (by field name) and give the port's tables on a
named device.

:class:`TrainInterface` is the learner's side: the named step inputs
and outputs of a sim, stepped from torch tensors on the sim's own
device (the JAX package's dlpack hops are the identity here).
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


def _table(cls, tree, device, ints=()):
    """``cls`` from the mapping ``tree`` of its fields: arrays as tensors
    on ``device``, the names in ``ints`` as Python ints. A field the port
    does not have must be None."""
    names = {f.name for f in dataclasses.fields(cls)}
    extra = [k for k, v in tree.items() if k not in names and not (
        np.ndim(v) == 0 and np.asarray(v, object).item() is None)]
    if extra:
        raise ValueError(f"{cls.__name__}: fields the port has no place for: "
                         f"{sorted(extra)}")
    return cls(**{
        k: int(np.asarray(tree[k])) if k in ints else _to_torch(tree[k], device)
        for k in names if k in tree
    })


def blas_from_numpy(tree, device):
    """The port's ``render.blas.BlasTables`` from numpy fields (node_min,
    node_max, left, right, tri_v0, tri_e1, tri_e2, tri_color, tri_uv,
    tri_mat, max_leaf, num_objects, and ``wide``: None or the fields of
    the 4-wide collapse, see :func:`blas4_from_numpy`)."""
    from .render.blas import BlasTables

    tree = dict(tree)
    wide = tree.pop("wide", None)
    blas = _table(BlasTables, tree, device,
                  ints=("max_leaf", "num_objects"))
    if isinstance(wide, dict):
        blas.wide = blas4_from_numpy(wide, device)
    return blas


def blas4_from_numpy(tree, device):
    """The port's ``render.blas.Blas4Tables`` from numpy fields (c_min,
    c_max, c_entry, leaf_first, leaf_count, tri_v0, tri_e1, tri_e2,
    max_leaf). bfloat16 boxes (``np.asarray`` of a JAX bfloat16 array has
    ml_dtypes' bfloat16 dtype) are widened to float32 on the way and
    narrowed back exactly."""
    from .render.blas import Blas4Tables

    tree = dict(tree)
    bf16 = False
    for k in ("c_min", "c_max"):
        a = np.asarray(tree[k])
        if a.dtype.name == "bfloat16":
            bf16 = True
            tree[k] = a.astype(np.float32)
    out = _table(Blas4Tables, tree, device, ints=("max_leaf",))
    if bf16:
        out.c_min = out.c_min.to(torch.bfloat16)
        out.c_max = out.c_max.to(torch.bfloat16)
    return out


def materials_from_numpy(tree, device):
    """The port's ``render.materials.MaterialTables`` from numpy fields
    (base_color, rough_metal, tex_id, atlas)."""
    from .render.materials import MaterialTables

    return _table(MaterialTables, tree, device)


def lights_from_numpy(tree, device):
    """The port's ``render.lights.Lights`` from numpy fields (direction,
    position, is_spot, cutoff, cast_shadow, active, intensity)."""
    from .render.lights import Lights

    return _table(Lights, tree, device)


@dataclasses.dataclass
class TrainInterface:
    """Named step inputs and outputs of a sim, for a torch learner.

    ``step_inputs`` maps each imported slot to ``((W, *shape), dtype)``,
    ``step_outputs`` the exports of the current state. ``torch_step``
    steps the sim with the learner's tensors, which must lie on the
    sim's device (another device raises; nothing is moved), and returns
    the exported tensors: the state's own tensors, with no copy."""

    sim: object

    @property
    def step_inputs(self):
        sm = self.sim.executor.sm
        w = self.sim.executor.num_worlds
        out = {}
        for slot, name in sm.singleton_imports.items():
            spec = sm.singletons[name]
            out[slot] = ((w,) + tuple(spec.shape), spec.dtype)
        for slot, (arch, comp) in sm.imports.items():
            spec = sm.components[comp]
            out[slot] = ((w, sm.archetypes[arch].capacity) + tuple(spec.shape),
                         spec.dtype)
        return out

    @property
    def step_outputs(self):
        return self.sim.executor.sm.collect_exports(self.sim.state)

    def torch_step(self, **inputs):
        for slot, v in inputs.items():
            if not torch.is_tensor(v):
                raise TypeError(f"{slot}: expected a tensor on "
                                f"{self.sim.device}, got {type(v).__name__}")
            if v.device != self.sim.device:
                raise ValueError(f"{slot}: on {v.device}, the sim is on "
                                 f"{self.sim.device}")
        return self.sim.step(inputs)
