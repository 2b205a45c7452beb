"""Taskgraph builder: stage systems, apply them in order each step.

Port of ``madrona_tpu/graph/builder.py``. The JAX package applies the
node list once at trace time to build one jitted function; here the
node list runs eagerly, node by node, every step.

Node kinds (the reference's taskgraph nodes):
  * parallel_for — a per-entity system over an archetype's rows
  * for_worlds   — a per-world system over singletons
  * clear_tmp    — live-row count of a temporary archetype to zero
  * sort         — stable per-world sort of an archetype's rows by a key
  * compact      — stable live-rows-first reorder
  * custom       — a full-state transform

Every node is held as one callable ``fn(sm, state, node_key) -> state``
(``_Node.fn``), whatever its kind.

RNG discipline (unchanged): each step derives
``step_key = split(rng[w], step)`` and each node
``node_key = split(step_key, node_id)``; a parallel_for invocation gets
``split(node_key[w], row)``. So every (step, node, world, row) has its
own reproducible Threefry key, bit-equal to the JAX package's.

An env with several named graphs (Hide & Seek: "step" and "render")
declares them through :class:`TaskGraphManager`; each graph applied
advances ``state.step`` by one, so a ``("step", "render")`` launch
advances it by two, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.func import vmap

from ..core import archetype as _arch
from ..core import entity_store as _estore
from ..core.state import SimState, StateManager
from ..utils import rng as _rng


@dataclasses.dataclass
class Ctx:
    """What a system sees of one invocation (the reference's Context)."""

    world_id: Any
    key: Any                      # Threefry key of this invocation
    singletons: Dict[str, Any]    # read-only per-world singleton values
    row: Any = None               # row index (parallel_for only)
    entity: Any = None            # [2] int32 (gen, id) of this row
    is_valid: Any = None          # bool: the row is live

    def singleton(self, name: str):
        return self.singletons[name]


@dataclasses.dataclass
class _Node:
    kind: str
    name: str
    deps: Tuple[int, ...]
    fn: Callable


class TaskGraphID:
    """Opaque node handle."""

    __slots__ = ("idx",)

    def __init__(self, idx: int):
        self.idx = idx


class TaskGraphBuilder:
    def __init__(self, sm: StateManager, name: str = "step"):
        self.sm = sm
        self.name = name
        self.nodes: List[_Node] = []

    def _add(self, kind, name, deps, fn) -> TaskGraphID:
        dep_idx = tuple(d.idx for d in deps or ())
        for d in dep_idx:
            if d >= len(self.nodes):
                raise ValueError("dependency on not-yet-added node")
        self.nodes.append(_Node(kind, name, dep_idx, fn))
        return TaskGraphID(len(self.nodes) - 1)

    def parallel_for(
        self,
        fn: Callable,
        arch: str,
        read: Sequence[str],
        write: Sequence[str],
        deps: Sequence[TaskGraphID] = (),
        read_singletons: Sequence[str] = (),
        name: Optional[str] = None,
    ) -> TaskGraphID:
        """ParallelForNode: ``fn(ctx, *read_values) -> write_values``.

        ``fn`` sees one entity's component values (mapped over rows, then
        worlds, by ``torch.func.vmap``); it returns the new values of
        ``write`` (one value for one write, else a tuple in order). Rows
        at or past num_rows keep their old values, unless the archetype
        has fixed rows."""
        return self._add(
            "parallel_for", name or getattr(fn, "__name__", "parallel_for"),
            deps, _parallel_for(fn, arch, tuple(read), tuple(write),
                                tuple(read_singletons)))

    def for_worlds(
        self,
        fn: Callable,
        read: Sequence[str] = (),
        write: Sequence[str] = (),
        deps: Sequence[TaskGraphID] = (),
        name: Optional[str] = None,
    ) -> TaskGraphID:
        """Per-world system over singletons: ``fn(ctx, *read) -> write``,
        mapped over the worlds axis."""
        return self._add(
            "for_worlds", name or getattr(fn, "__name__", "for_worlds"),
            deps, _for_worlds(fn, tuple(read), tuple(write)))

    def clear_tmp(self, arch: str, deps: Sequence[TaskGraphID] = ()):
        def run(sm, state, node_key):
            return _with_table(state, arch, _arch.clear(state.tables[arch]))

        return self._add("clear_tmp", f"clear_tmp:{arch}", deps, run)

    def sort(
        self,
        arch: str,
        key_comp: Optional[str] = None,
        key_fn: Optional[Callable] = None,
        deps: Sequence[TaskGraphID] = (),
    ) -> TaskGraphID:
        """SortArchetypeNode: stable per-world sort of the live rows by a
        key: the scalar component ``key_comp``, or ``key_fn(columns) ->
        [W, C]``. Dead rows sort to the end."""
        def run(sm, state, node_key):
            table = state.tables[arch]
            cap = sm.archetypes[arch].capacity
            keys = (table.columns[key_comp] if key_comp is not None
                    else key_fn(table.columns))
            if keys.is_floating_point():
                keys = keys.to(torch.float32)
                big = float("inf")
            else:
                big = torch.iinfo(keys.dtype).max
            masked = torch.where(_arch.row_mask(table, cap), keys, big)
            return _reorder(sm, state, arch, torch.argsort(
                masked, dim=1, stable=True))

        return self._add("sort", f"sort:{arch}", deps, run)

    def compact(self, arch: str, deps: Sequence[TaskGraphID] = ()):
        """CompactArchetypeNode: a stable live-rows-first reorder. Appends
        and destroy_entities keep tables dense already, so this is
        normally the identity."""
        def run(sm, state, node_key):
            live = _arch.row_mask(state.tables[arch],
                                  sm.archetypes[arch].capacity)
            return _reorder(sm, state, arch, torch.argsort(
                (~live).to(torch.int32), dim=1, stable=True))

        return self._add("compact", f"compact:{arch}", deps, run)

    def custom(
        self,
        fn: Callable[[StateManager, SimState, Any], SimState],
        deps: Sequence[TaskGraphID] = (),
        name: Optional[str] = None,
    ) -> TaskGraphID:
        """Full-state node: ``fn(sm, state, node_key) -> state``."""
        return self._add("custom", name or getattr(fn, "__name__", "custom"),
                         deps, fn)

    def build(self) -> "TaskGraph":
        """Freeze; insertion order is topological (deps point backwards)."""
        return TaskGraph(self.sm, self.name, list(self.nodes))


def _with_table(state: SimState, arch: str, table) -> SimState:
    tables = dict(state.tables)
    tables[arch] = table
    return dataclasses.replace(state, tables=tables)


def _reorder(sm: StateManager, state: SimState, arch: str, order):
    """Rows of ``arch`` gathered by ``order`` [W, C]; the entity store's
    rows re-pointed."""
    table = _arch.gather_rows(state.tables[arch], order)
    state = _with_table(state, arch, table)
    spec = sm.archetypes[arch]
    if spec.no_entities:
        return state
    store = _estore.update_rows(state.entities, table.entity_id,
                                table.entity_gen,
                                _arch.row_mask(table, spec.capacity))
    return dataclasses.replace(state, entities=store)


def _as_tuple(out, n_write):
    return (out,) if n_write == 1 and not isinstance(out, tuple) else out


def _tree_cast(new, old):
    if isinstance(old, dict):
        return {k: _tree_cast(new[k], o) for k, o in old.items()}
    return new.to(old.dtype)


def _tree_where(mask, new, old):
    if isinstance(old, dict):
        return {k: _tree_where(mask, new[k], o) for k, o in old.items()}
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - 2)),
                       new, old)


def _parallel_for(fn, arch, read, write, read_singletons):
    """The node of ``TaskGraphBuilder.parallel_for``: ``fn`` under nested
    vmaps, rows inside worlds. Every op the systems of this package use,
    utils/rng.py's split_i included, runs under vmap, so the row key is
    split inside the map as the JAX package does."""

    def per_row(world_id, wkey, singles_w, row, ent, valid, *comps):
        ctx = Ctx(world_id=world_id, key=_rng.split_i(wkey, row),
                  singletons=singles_w, row=row, entity=ent,
                  is_valid=valid)
        return _as_tuple(fn(ctx, *comps), len(write))

    n = len(read)
    mapped = vmap(vmap(per_row, in_dims=(None, None, None, 0, 0, 0) + (0,) * n),
                  in_dims=(0, 0, 0, None, 0, 0) + (0,) * n)

    def run(sm, state, node_key):
        spec = sm.archetypes[arch]
        table = state.tables[arch]
        cap = spec.capacity
        w = table.num_rows.shape[0]
        dev = table.num_rows.device
        mask = _arch.row_mask(table, cap)
        if spec.no_entities:
            ents = torch.full((w, cap, 2), -1, dtype=torch.int32, device=dev)
        else:
            ents = torch.stack([table.entity_gen, table.entity_id], dim=-1)
        outs = mapped(
            torch.arange(w, dtype=torch.int32, device=dev), node_key,
            {s: state.singletons[s] for s in read_singletons},
            torch.arange(cap, dtype=torch.int32, device=dev), ents, mask,
            *[table.columns[c] for c in read])
        cols = dict(table.columns)
        for comp, new in zip(write, outs):
            new = _tree_cast(new, cols[comp])
            cols[comp] = new if spec.fixed_rows else _tree_where(
                mask, new, cols[comp])
        return _with_table(state, arch,
                           dataclasses.replace(table, columns=cols))

    return run


def _for_worlds(fn, read, write):
    """The node of ``TaskGraphBuilder.for_worlds``: ``fn`` under a vmap
    over the worlds axis, every singleton visible through ctx."""

    def per_world(world_id, wkey, singles_w, *vals):
        ctx = Ctx(world_id=world_id, key=wkey, singletons=singles_w)
        return _as_tuple(fn(ctx, *vals), len(write))

    mapped = vmap(per_world)

    def run(sm, state, node_key):
        w = state.rng.shape[0]
        outs = mapped(
            torch.arange(w, dtype=torch.int32, device=state.rng.device),
            node_key, state.singletons,
            *[state.singletons[s] for s in read])
        singles = dict(state.singletons)
        for name, new in zip(write, outs):
            singles[name] = _tree_cast(new, singles[name])
        return dataclasses.replace(state, singletons=singles)

    return run


class TaskGraphManager:
    """Hands out named builders so one env declares several taskgraphs
    (``mgr.init("step")``, ``mgr.init("render")``); ``build_all``
    freezes them into the dict the Executor takes, and a launch such as
    ``("step", "render")`` applies them in order."""

    def __init__(self, sm: StateManager):
        self.sm = sm
        self._builders: Dict[str, TaskGraphBuilder] = {}

    def init(self, name: str) -> TaskGraphBuilder:
        if name in self._builders:
            raise ValueError(f"taskgraph {name!r} already declared")
        b = TaskGraphBuilder(self.sm, name)
        self._builders[name] = b
        return b

    def build_all(self) -> Dict[str, "TaskGraph"]:
        if not self._builders:
            raise ValueError("no taskgraphs declared")
        return {n: b.build() for n, b in self._builders.items()}


class TaskGraph:
    """A frozen node list, applied to a SimState."""

    def __init__(self, sm: StateManager, name: str, nodes: List[_Node]):
        self.sm = sm
        self.name = name
        self.nodes = nodes

    def step(self, state: SimState) -> SimState:
        """Apply every node once and advance the step counter."""
        step_key = _rng.split_i(state.rng, state.step.to(torch.int64))
        for node_id, node in enumerate(self.nodes):
            node_key = _rng.split_i(step_key, node_id)
            state = node.fn(self.sm, state, node_key)
        return dataclasses.replace(state, step=state.step + 1)
