"""Recorder: headless episode capture (the reference's viz::Recorder,
src/viz/recorder.cpp: per-step state capture for later playback).

Port of ``madrona_tpu/viz/recorder.py``: each recorded tensor is copied
to the host as a numpy array; :meth:`Recorder.save` writes the JAX
package's ``.npz`` keys and ``[T, W, ...]`` shapes, so a file saved by
either package loads in both.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .viewer import to_numpy


class Recorder:
    """Capture named per-step tensors; save/load .npz trajectories."""

    def __init__(self, capture: Optional[Dict[str, Callable]] = None):
        """capture: name -> fn(state, outputs) extracting a tensor.
        Default captures every step output."""
        self._capture = capture
        self._frames: List[Dict[str, np.ndarray]] = []

    def record(self, state, outputs: Dict[str, Any]):
        if self._capture is None:
            frame = {k: to_numpy(v) for k, v in outputs.items()}
        else:
            frame = {
                k: to_numpy(fn(state, outputs))
                for k, fn in self._capture.items()
            }
        self._frames.append(frame)

    def __len__(self):
        return len(self._frames)

    def stacked(self) -> Dict[str, np.ndarray]:
        """name -> [T, ...] stacked trajectory."""
        if not self._frames:
            return {}
        return {
            k: np.stack([f[k] for f in self._frames])
            for k in self._frames[0]
        }

    def save(self, path: str):
        np.savez_compressed(path, **self.stacked())

    @staticmethod
    def load(path: str) -> Dict[str, np.ndarray]:
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
