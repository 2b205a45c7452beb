"""Entity id store: generations and Entity -> (archetype, row) lookup.

Port of the state layout of ``madrona_tpu/core/entity_store.py``. The
Escape Room step never allocates or frees entities (its body table is
``fixed_rows``), so this slice carries the store as state only;
``alloc``/``free``/``lookup`` come with the envs that use them.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class EntityStore:
    gen: torch.Tensor        # [W, maxE] int32 — current generation per id
    arch: torch.Tensor       # [W, maxE] int32 — archetype index, -1 if free
    row: torch.Tensor        # [W, maxE] int32 — row within archetype table
    free_ids: torch.Tensor   # [W, maxE] int32 — stack of free ids
    free_top: torch.Tensor   # [W] int32 — number of free ids on the stack


def init(num_worlds: int, max_entities: int, device) -> EntityStore:
    i32 = dict(dtype=torch.int32, device=device)
    ids = torch.arange(max_entities - 1, -1, -1, **i32)
    return EntityStore(
        gen=torch.zeros((num_worlds, max_entities), **i32),
        arch=torch.full((num_worlds, max_entities), -1, **i32),
        row=torch.full((num_worlds, max_entities), -1, **i32),
        free_ids=ids[None, :].repeat(num_worlds, 1),
        free_top=torch.full((num_worlds,), max_entities, **i32),
    )
