"""Environment base: the app-facing shell around the ECS engine.

Port of ``madrona_tpu/models/base.py``. An env registers types, wires
systems into a taskgraph and builds its worlds; :func:`make_sim` puts
them together on one device.

The device is explicit. ``device=None`` means the card: ``"cuda"``.
Without CUDA that raises ``RuntimeError``; the CPU is used only when
the caller asks for it (``device="cpu"``), as the parity tests do.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from ..core.device import resolve_device
from ..core.registry import ECSRegistry
from ..core.state import SimState, StateManager
from ..graph.builder import TaskGraphBuilder, TaskGraphManager
from ..graph.executor import Executor


class EnvBase:
    """Subclass contract:

      * ``register_types(self, reg)``    — components/archetypes/exports
      * ``setup_tasks(self, builder)``   — system wiring
      * ``init_worlds(self, sm, state)`` — world construction

    An env with one graph implements ``setup_tasks(builder)``; one with
    several (Hide & Seek: step and render) implements
    ``setup_graphs(mgr)`` instead. ``default_launch`` names the graphs
    that ``Sim.step()`` applies, in order.
    """

    name = "env"
    default_launch = ("step",)

    def register_types(self, reg: ECSRegistry):
        raise NotImplementedError

    def setup_tasks(self, builder: TaskGraphBuilder):
        raise NotImplementedError

    def setup_graphs(self, mgr: TaskGraphManager):
        """Multi-graph hook; by default ``setup_tasks`` is the "step"
        graph."""
        self.setup_tasks(mgr.init("step"))

    def init_worlds(self, sm: StateManager, state: SimState) -> SimState:
        return state


def make_sim(env: EnvBase, num_worlds: int, seed: int = 0, device=None,
             max_entities: Optional[int] = None) -> "Sim":
    """Build the executor for an env on ``device`` (default: the card)."""
    dev = resolve_device(device)
    sm = StateManager()
    env.register_types(ECSRegistry(sm))
    mgr = TaskGraphManager(sm)
    env.setup_graphs(mgr)
    ex = Executor(
        sm, mgr.build_all(), num_worlds=num_worlds, seed=seed,
        init_fn=env.init_worlds, max_entities=max_entities, device=dev,
    )
    return Sim(env=env, executor=ex)


@dataclasses.dataclass
class Sim:
    """The live simulator: stateful wrapper plus a pure step function."""

    env: EnvBase
    executor: Executor

    @property
    def state(self) -> SimState:
        return self.executor.state

    @state.setter
    def state(self, s: SimState):
        self.executor.state = s

    @property
    def device(self) -> torch.device:
        return self.executor.state.rng.device

    def step(self, inputs: Optional[Dict[str, Any]] = None, launch=None
             ) -> Dict[str, Any]:
        return self.executor.run(launch or self.env.default_launch, inputs)

    def step_fn(self, launch=None) -> Callable:
        """Pure ``(state, inputs) -> (state, exports)`` over the graphs
        of ``launch`` (default: the env's ``default_launch``)."""
        return self.executor.step_fn(launch or self.env.default_launch)
