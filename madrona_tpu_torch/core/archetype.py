"""Archetype tables: struct-of-arrays storage with a leading worlds axis.

Port of ``madrona_tpu/core/archetype.py``. Rows ``[0, num_rows[w])`` of
world ``w`` are live and dense. Every helper returns a new Table.
Appends that do not fit the capacity are dropped and counted into
``overflow`` (the signal ``Executor.maybe_grow`` reads).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..ops import scatter as _scatter
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


def _map_columns(table: Table, fn) -> Dict[str, Any]:
    """fn(comp name, field name or None, column tensor) over every
    column leaf."""
    out = {}
    for cname, col in table.columns.items():
        if isinstance(col, dict):
            out[cname] = {f: fn(cname, f, a) for f, a in col.items()}
        else:
            out[cname] = fn(cname, None, col)
    return out


def _value(values, cname, field):
    v = values[cname]
    return v if field is None else v[field]


def clear(table: Table) -> Table:
    """Live-row counts to zero (the ClearTmp node). Data stays in place;
    reads are masked by num_rows."""
    return dataclasses.replace(table, num_rows=torch.zeros_like(table.num_rows))


def append_rows(table: Table, values: Dict[str, Any], append_mask) -> Table:
    """One candidate row per world where ``append_mask`` [W] is set,
    written at the world's num_rows. values[comp]: [W, ...]. A world at
    capacity drops its row and counts it into overflow."""
    w = table.num_rows.shape[0]
    cap = _capacity_of(table)
    ok = append_mask & (table.num_rows < cap)
    widx = torch.arange(w, device=ok.device)[:, None]
    dest = table.num_rows.long()[:, None]

    def put(cname, field, col):
        return _scatter.masked_set_2d(
            col, widx, dest, _value(values, cname, field)[:, None], ok[:, None])

    dropped = append_mask & ~ok
    return dataclasses.replace(
        table,
        columns=_map_columns(table, put),
        num_rows=table.num_rows + ok.to(torch.int32),
        overflow=table.overflow + dropped.to(torch.int32),
    )


def append_many(table: Table, values: Dict[str, Any], valid) -> Table:
    """Bulk append: values[comp] is [W, K, ...], valid [W, K] bool. The
    valid candidates are packed in order (an exclusive prefix sum) after
    each world's rows; those past capacity are dropped and counted into
    overflow."""
    w, k = valid.shape
    cap = _capacity_of(table)
    valid_i = valid.to(torch.int32)
    offs = torch.cumsum(valid_i, dim=1, dtype=torch.int32) - valid_i
    dest = table.num_rows[:, None] + offs
    ok = valid & (dest < cap)
    widx = torch.arange(w, device=valid.device)[:, None].expand(w, k)

    def put(cname, field, col):
        return _scatter.masked_set_2d(col, widx, dest.long(),
                                      _value(values, cname, field), ok)

    new_counts = torch.clamp(
        table.num_rows + ok.sum(1, dtype=torch.int32), max=cap)
    dropped = (valid & ~ok).sum(1, dtype=torch.int32)
    return dataclasses.replace(
        table, columns=_map_columns(table, put),
        num_rows=new_counts,
        overflow=table.overflow + dropped,
    )


def gather_rows(table: Table, order) -> Table:
    """Reorder the rows of every column (and the entity ids) by ``order``,
    a [W, C] permutation (the sort and compact nodes)."""
    w = order.shape[0]
    widx = torch.arange(w, device=order.device)[:, None]
    order = order.long()

    def g(col):
        return col[widx, order]

    eid, egen = table.entity_id, table.entity_gen
    if eid.shape[1] > 0:
        eid, egen = g(eid), g(egen)
    return dataclasses.replace(
        table, columns=_map_columns(table, lambda c, f, a: g(a)),
        entity_id=eid, entity_gen=egen,
    )


def _capacity_of(table: Table) -> int:
    any_col = next(iter(table.columns.values()))
    if isinstance(any_col, dict):
        any_col = next(iter(any_col.values()))
    return any_col.shape[1]
