"""The device rule of the port's entry points.

``make_sim``, ``Executor`` and ``StateManager.init_state`` take a
``device``; ``None`` means the card, ``"cuda"``. Without CUDA that
raises ``RuntimeError``: the CPU is used only when the caller asks for
it (``device="cpu"``), as the parity tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "madrona_tpu_torch runs on the GPU by default and CUDA is not "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev
