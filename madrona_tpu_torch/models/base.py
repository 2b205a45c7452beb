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

from ..core.registry import ECSRegistry
from ..core.state import SimState, StateManager
from ..graph.builder import TaskGraphBuilder
from ..graph.executor import Executor


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "madrona_tpu_torch runs on the GPU by default and CUDA is not "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


class EnvBase:
    """Subclass contract:

      * ``register_types(self, reg)``    — components/archetypes/exports
      * ``setup_tasks(self, builder)``   — system wiring
      * ``init_worlds(self, sm, state)`` — world construction
    """

    name = "env"

    def register_types(self, reg: ECSRegistry):
        raise NotImplementedError

    def setup_tasks(self, builder: TaskGraphBuilder):
        raise NotImplementedError

    def init_worlds(self, sm: StateManager, state: SimState) -> SimState:
        return state


def make_sim(env: EnvBase, num_worlds: int, seed: int = 0, device=None,
             max_entities: Optional[int] = None) -> "Sim":
    """Build the executor for an env on ``device`` (default: the card)."""
    dev = resolve_device(device)
    sm = StateManager()
    env.register_types(ECSRegistry(sm))
    builder = TaskGraphBuilder(sm, "step")
    env.setup_tasks(builder)
    ex = Executor(
        sm, {"step": builder.build()}, num_worlds=num_worlds, seed=seed,
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

    def step(self, inputs: Optional[Dict[str, Any]] = None
             ) -> Dict[str, Any]:
        return self.executor.run(("step",), inputs)

    def step_fn(self) -> Callable:
        """Pure ``(state, inputs) -> (state, exports)``."""
        return self.executor.step_fn(("step",))
