"""madrona_tpu_torch: the PyTorch / CUDA port of madrona_tpu.

Batch simulation of thousands of ECS worlds in lockstep on one NVIDIA
H100: the same ECS core, taskgraph, XPBD physics, batch raycaster and
Escape Room and Hide & Seek envs as the JAX package beside it, written
as plain PyTorch on tensors, with
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

from .models.base import EnvBase, Sim, make_sim  # noqa: E402

__all__ = ["EnvBase", "Sim", "make_sim"]
