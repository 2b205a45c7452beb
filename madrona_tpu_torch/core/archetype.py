"""Archetype tables: struct-of-arrays storage with a leading worlds axis.

Port of the table layout of ``madrona_tpu/core/archetype.py``. Rows
``[0, num_rows[w])`` of world ``w`` are live and dense.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from .component import ArchetypeSpec, ComponentSpec


@dataclasses.dataclass
class Table:
    """One archetype's storage.

    columns:    comp name -> tensor [W, C, ...] (or dict of field tensors)
    entity_id:  [W, C] int32 — entity id of each row (-1 if none)
    entity_gen: [W, C] int32 — generation of that entity
    num_rows:   [W] int32    — live row count per world
    overflow:   [W] int32    — rows dropped by appends
    """

    columns: Dict[str, Any]
    entity_id: torch.Tensor
    entity_gen: torch.Tensor
    num_rows: torch.Tensor
    overflow: torch.Tensor


def make_table(spec: ArchetypeSpec, comp_specs: Dict[str, ComponentSpec],
               num_worlds: int, device) -> Table:
    cap = spec.capacity
    lead = (num_worlds, cap)
    columns = {
        cname: comp_specs[cname].zeros(lead, device)
        for cname in spec.components
    }
    ids_shape = (num_worlds, 0) if spec.no_entities else lead
    i32 = dict(dtype=torch.int32, device=device)
    return Table(
        columns=columns,
        entity_id=torch.full(ids_shape, -1, **i32),
        entity_gen=torch.full(ids_shape, -1, **i32),
        num_rows=torch.full(
            (num_worlds,), cap if spec.fixed_rows else 0, **i32
        ),
        overflow=torch.zeros((num_worlds,), **i32),
    )


def row_mask(table: Table, capacity: int) -> torch.Tensor:
    """[W, C] bool — True for live rows."""
    idx = torch.arange(capacity, dtype=torch.int32,
                       device=table.num_rows.device)
    return idx[None, :] < table.num_rows[:, None]
