"""Taskgraph builder: stage systems, apply them in order each step.

Port of ``madrona_tpu/graph/builder.py``. The JAX package applies the
node list once at trace time to build one jitted function; here the
node list runs eagerly, node by node, every step.

RNG discipline (unchanged): each step derives
``step_key = split(rng[w], step)`` and each node
``node_key = split(step_key, node_id)``, so every (step, node, world)
has its own reproducible Threefry key, bit-equal to the JAX package's.

Only ``custom`` nodes are ported in this slice (the Escape Room graph
uses nothing else); ``parallel_for``, ``for_worlds``, ``sort`` and
``compact``, and several named graphs per env (``TaskGraphManager``),
come with the envs that use them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from ..core.state import SimState, StateManager
from ..utils import rng as _rng


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

    def custom(
        self,
        fn: Callable[[StateManager, SimState, Any], SimState],
        deps: Sequence[TaskGraphID] = (),
        name: Optional[str] = None,
    ) -> TaskGraphID:
        """Full-state node: ``fn(sm, state, node_key) -> state``."""
        dep_idx = tuple(d.idx for d in deps or ())
        for d in dep_idx:
            if d >= len(self.nodes):
                raise ValueError("dependency on not-yet-added node")
        self.nodes.append(_Node(
            "custom", name or getattr(fn, "__name__", "custom"), dep_idx, fn
        ))
        return TaskGraphID(len(self.nodes) - 1)

    def build(self) -> "TaskGraph":
        """Freeze; insertion order is topological (deps point backwards)."""
        return TaskGraph(self.sm, self.name, list(self.nodes))


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
