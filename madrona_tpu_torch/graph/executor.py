"""Executor: owns the SimState and runs the step functions.

Port of ``madrona_tpu/graph/executor.py`` without ``jit`` or buffer
donation: a step is an eager call that returns the new state and the
exported tensors. Capacity growth (``maybe_grow``) comes with the envs
whose archetypes can overflow; the Escape Room's cannot.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

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
        device="cpu",
    ):
        self.sm = sm
        self.num_worlds = num_worlds
        self.graphs = dict(graphs)
        state = sm.init_state(num_worlds, seed=seed,
                              max_entities=max_entities, device=device)
        if init_fn is not None:
            state = init_fn(sm, state)
        self.state = state

    def step_fn(self, launch: Sequence[str] = ("step",)) -> Callable:
        """Pure ``(state, inputs) -> (state, exports)`` over the named
        graphs, applied in order."""
        if isinstance(launch, str):
            launch = (launch,)
        sm = self.sm
        graphs = [self.graphs[n] for n in launch]

        def step(state: SimState, inputs: Dict[str, Any]):
            state = sm.apply_imports(state, inputs)
            for g in graphs:
                state = g.step(state)
            return state, sm.collect_exports(state)

        return step

    def run(self, launch=("step",), inputs: Optional[Dict[str, Any]] = None):
        """One step over all worlds; returns the exported tensors."""
        self.state, outputs = self.step_fn(launch)(self.state, inputs or {})
        return outputs
