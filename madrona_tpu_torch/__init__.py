"""madrona_tpu_torch: the PyTorch / CUDA port of madrona_tpu.

Batch simulation of thousands of ECS worlds in lockstep on one NVIDIA
H100: the same ECS core (node kinds, entity lifecycle), taskgraph, XPBD
physics (the all-pairs and swept broadphase tiers), batch raycaster,
Escape Room, Hide & Seek, Pile, Cartpole, Projectiles, Hanabi and
Overcooked envs and learner interface (``interop.TrainInterface``) as
the JAX package beside it, written as plain PyTorch on tensors, with
the TPU's Pallas kernels replaced by CUDA C++ kernels written by hand
(``csrc/``, bound through ctypes in ``ops/``).

Module paths mirror ``madrona_tpu`` so each counterpart is easy to
find. The package imports neither ``jax`` nor ``madrona_tpu``.

Entry points run on the card unless the caller asks for the CPU:
``make_sim(env, num_worlds, seed, device=None)`` resolves ``None`` to
``"cuda"`` and raises when CUDA is absent.
"""

import torch

# Parity paths are float32 end to end: no TF32 anywhere.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .core.component import (  # noqa: E402
    ArchetypeSpec,
    ComponentSpec,
    Entity,
    NULL_ENTITY,
    entity_ref,
    f32,
    i32,
    u32,
    quat,
    scalar,
    vec2,
    vec3,
    vec4,
)
from .core.state import SimState, StateManager  # noqa: E402
from .core.registry import ECSRegistry  # noqa: E402
from .graph.builder import (  # noqa: E402
    Ctx, TaskGraph, TaskGraphBuilder, TaskGraphID,
)
from .graph.executor import Executor  # noqa: E402
from .models.base import (  # noqa: E402
    EnvBase, Sim, make_sim, rollout, rollout_flat,
)
from .utils import math3d, rng  # noqa: E402

__all__ = [
    "ArchetypeSpec",
    "ComponentSpec",
    "ECSRegistry",
    "Entity",
    "EnvBase",
    "Executor",
    "Ctx",
    "NULL_ENTITY",
    "Sim",
    "SimState",
    "StateManager",
    "TaskGraph",
    "TaskGraphBuilder",
    "TaskGraphID",
    "entity_ref",
    "f32",
    "i32",
    "u32",
    "make_sim",
    "math3d",
    "quat",
    "rng",
    "rollout",
    "rollout_flat",
    "scalar",
    "vec2",
    "vec3",
    "vec4",
]
