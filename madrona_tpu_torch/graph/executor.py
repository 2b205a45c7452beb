"""Executor: owns the SimState and runs the step functions.

Port of ``madrona_tpu/graph/executor.py`` without ``jit`` or buffer
donation: a step is an eager call that returns the new state and the
exported tensors. :meth:`Executor.build_launch_graph` composes
taskgraphs into one step function, built once per launch and kept
under its key, which :meth:`Executor.run` and :meth:`Executor.step_fn`
take.

Capacity growth: an append that does not fit an archetype's capacity is
dropped and counted into the table's ``overflow``. Between steps,
:meth:`Executor.maybe_grow` reads those counts (its one host read) and
grows each archetype that overflowed to a capacity that holds the
dropped rows: every column is padded with zeros and the id columns with
-1, the spec's capacity is bumped and ``overflow`` cleared. The JAX
package re-traces its step at the new capacity; the port has no trace
to drop, and its nodes read the capacity at run time.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from ..core.state import SimState, StateManager
from .builder import TaskGraph


class Executor:
    def __init__(
        self,
        sm: StateManager,
        graphs: Dict[str, TaskGraph],
        num_worlds: int,
        seed: int = 0,
        init_fn: Optional[Callable[[StateManager, SimState], SimState]] = None,
        max_entities: Optional[int] = None,
        device=None,
    ):
        self.sm = sm
        self.num_worlds = num_worlds
        self.graphs = dict(graphs)
        state = sm.init_state(num_worlds, seed=seed,
                              max_entities=max_entities, device=device)
        if init_fn is not None:
            state = init_fn(sm, state)
        self.state = state
        # launch key (a tuple of graph names) -> its composed step
        self._launches: Dict[tuple, Callable] = {}

    def _compose(self, key: tuple) -> Callable:
        sm = self.sm
        graphs = [self.graphs[n] for n in key]

        def step(state: SimState, inputs: Dict[str, Any]):
            state = sm.apply_imports(state, inputs)
            for g in graphs:
                state = g.step(state)
            return state, sm.collect_exports(state)

        return step

    def build_launch_graph(self, graph_names: Sequence[str]) -> tuple:
        """Compose taskgraphs into one launch (the reference's
        ``buildLaunchGraph``): the pure step over the named graphs, in
        order, built once and kept. Returns its key for :meth:`run` and
        :meth:`step_fn`."""
        key = (graph_names,) if isinstance(graph_names, str) \
            else tuple(graph_names)
        if key not in self._launches:
            self._launches[key] = self._compose(key)
        return key

    def step_fn(self, launch: Sequence[str] = ("step",)) -> Callable:
        """Pure ``(state, inputs) -> (state, exports)`` over the named
        graphs (a graph name, a tuple of names or a key of
        :meth:`build_launch_graph`), applied in order; the same function
        on every call."""
        return self._launches[self.build_launch_graph(launch)]

    def run(self, launch=("step",), inputs: Optional[Dict[str, Any]] = None):
        """One step over all worlds; returns the exported tensors."""
        self.state, outputs = self.step_fn(launch)(self.state, inputs or {})
        return outputs

    def get_exported(self, slot: str):
        """The export ``slot`` of the current state (the reference's
        ``getExported``)."""
        return self.sm.collect_exports(self.state)[slot]

    # -- capacity growth ---------------------------------------------------

    def overflow_counts(self) -> Dict[str, int]:
        """{archetype: the largest count of rows a world dropped since the
        last growth}, for the archetypes that dropped any (one host
        read)."""
        names = list(self.state.tables)
        maxima = torch.stack([self.state.tables[n].overflow.max()
                              for n in names]).tolist()
        return {n: v for n, v in zip(names, maxima) if v}

    def grow_archetype(self, name: str, new_capacity: int):
        """Pad archetype ``name`` to ``new_capacity`` rows: columns with
        zeros, entity ids and generations with -1; its spec's capacity
        bumped and its overflow cleared."""
        spec = self.sm.archetypes[name]
        if new_capacity <= spec.capacity:
            raise ValueError(
                f"new capacity {new_capacity} <= current {spec.capacity}")
        self.sm.archetypes[name] = dataclasses.replace(
            spec, capacity=new_capacity)
        table = self.state.tables[name]

        def pad(a, fill):
            extra = new_capacity - a.shape[1]
            return torch.cat([a, torch.full(
                (a.shape[0], extra) + tuple(a.shape[2:]), fill,
                dtype=a.dtype, device=a.device)], dim=1)

        cols = {c: ({f: pad(a, 0) for f, a in v.items()}
                    if isinstance(v, dict) else pad(v, 0))
                for c, v in table.columns.items()}
        eid, egen = table.entity_id, table.entity_gen
        if eid.shape[1] > 0:
            eid, egen = pad(eid, -1), pad(egen, -1)
        tables = dict(self.state.tables)
        tables[name] = dataclasses.replace(
            table, columns=cols, entity_id=eid, entity_gen=egen,
            overflow=torch.zeros_like(table.overflow))
        self.state = dataclasses.replace(self.state, tables=tables)

    def maybe_grow(self, factor: int = 2) -> Dict[str, int]:
        """Grow every archetype that overflowed to the first capacity of
        the series cap, cap * factor, ... that holds capacity + dropped
        rows (a capacity of 0 starts the series at 1). Returns {archetype:
        new capacity}, empty when nothing overflowed. Call it between
        steps: it reads the overflow counts on the host."""
        grown = {}
        for name, count in self.overflow_counts().items():
            spec = self.sm.archetypes[name]
            need = spec.capacity + count
            new_cap = max(spec.capacity, 1)
            while new_cap < need:
                new_cap *= factor
            self.grow_archetype(name, new_cap)
            grown[name] = new_cap
        return grown
