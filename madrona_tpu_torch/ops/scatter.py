"""Masked scatter primitives shared by the ECS core.

Port of ``madrona_tpu/ops/scatter.py``. JAX routes disabled lanes to an
out-of-range index and lets ``mode="drop"`` discard them; on CUDA an
out-of-range index is a device-side assert, so here disabled lanes are
removed by the mask before the index is ever formed.
"""

from __future__ import annotations


def masked_set_2d(arr, world_idx, idx, values, mask):
    """arr[w, idx] = values where mask, else untouched (returns a copy).

    arr: [W, N, ...]; world_idx/idx/mask: [W, K]; values: [W, K, ...].
    Enabled lanes must hold idx in [0, N)."""
    out = arr.clone()
    out[world_idx[mask], idx[mask]] = values[mask].to(arr.dtype)
    return out


def masked_add_2d(arr, world_idx, idx, values, mask):
    """arr[w, idx] += values where mask (duplicates accumulate)."""
    out = arr.clone()
    out.index_put_(
        (world_idx[mask], idx[mask]), values[mask].to(arr.dtype),
        accumulate=True,
    )
    return out
