"""Entity id store: generations and Entity -> (archetype, row) lookup.

Port of ``madrona_tpu/core/entity_store.py``. Ids are per world.
Allocation is a batched pop from a free stack, ranked by a prefix sum
over the candidates, so ids are deterministic and equal the JAX
package's bit for bit; ``init`` fills the stack in descending order, so
the first ids handed out are 0, 1, 2, ... Freeing bumps the id's
generation, so stale handles fail :func:`lookup`.
"""

from __future__ import annotations

import dataclasses

import torch

from .component import Entity
from ..ops import scatter as _scatter


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


def _rank(mask):
    """Exclusive prefix count of ``mask`` [W, K] along K (int32)."""
    m = mask.to(torch.int32)
    return torch.cumsum(m, dim=1, dtype=torch.int32) - m


def _widx(w, k, device):
    return torch.arange(w, device=device)[:, None].expand(w, k)


def alloc(store: EntityStore, valid, arch_idx: int, base_row):
    """Allocate ids for up to K candidates a world.

    valid: [W, K] bool; base_row: [W] int32, the table row of the first
    valid candidate (candidate k gets base_row + its rank among the
    valid ones, as ``archetype.append_many`` writes them).

    Returns (store', entity [W, K, 2], row [W, K]); candidates that do not
    allocate (invalid, or the stack ran out) get Entity.none() and row
    -1."""
    w, k = valid.shape
    max_e = store.free_ids.shape[1]
    rank = _rank(valid)
    n_alloc = valid.sum(1, dtype=torch.int32)
    ok = valid & (rank < store.free_top[:, None])
    # the candidate of rank r takes free_ids[top - 1 - r]
    pos = torch.clamp(store.free_top[:, None] - 1 - rank, 0, max_e - 1)
    widx = _widx(w, k, valid.device)
    new_ids = store.free_ids[widx, pos.long()]
    rows = base_row[:, None] + rank
    gen_now = store.gen[widx, torch.clamp(new_ids, min=0).long()]

    def upd(a, v):
        return _scatter.masked_set_2d(a, widx, new_ids.long(), v, ok)

    store = dataclasses.replace(
        store,
        arch=upd(store.arch, torch.full((w, k), arch_idx, dtype=torch.int32,
                                        device=valid.device)),
        row=upd(store.row, rows),
        free_top=store.free_top - torch.minimum(n_alloc, store.free_top),
    )
    ent = torch.where(ok[..., None], Entity.make(gen_now, new_ids),
                      Entity.none((w, k), valid.device))
    return store, ent, torch.where(ok, rows, -1).to(torch.int32)


def free(store: EntityStore, entity, valid):
    """Free the entities [W, K, 2] where valid: the id goes back on the
    stack and its generation is bumped. Stale, out-of-range or null
    handles are ignored, and a handle that appears twice in the batch is
    freed once (its first occurrence)."""
    w, k = valid.shape
    max_e = store.gen.shape[1]
    raw_id = Entity.id(entity)
    in_range = (raw_id >= 0) & (raw_id < max_e)
    eid = torch.clamp(raw_id, 0, max_e - 1).long()
    widx = _widx(w, k, valid.device)
    live = valid & in_range & (store.gen[widx, eid] == Entity.gen(entity)) & (
        Entity.gen(entity) >= 0)
    same = (eid[:, :, None] == eid[:, None, :]) & live[:, :, None] & (
        live[:, None, :])
    earlier = torch.tril(torch.ones((k, k), dtype=torch.bool,
                                    device=valid.device), diagonal=-1)[None]
    live = live & ~torch.any(same & earlier, dim=2)
    pos = store.free_top[:, None] + _rank(live)

    def bump(a, v):
        return _scatter.masked_set_2d(a, widx, eid, v, live)

    minus1 = torch.full((w, k), -1, dtype=torch.int32, device=valid.device)
    return dataclasses.replace(
        store,
        gen=bump(store.gen, store.gen[widx, eid] + 1),
        arch=bump(store.arch, minus1),
        row=bump(store.row, minus1),
        free_ids=_scatter.masked_set_2d(store.free_ids, widx, pos.long(),
                                        eid, live),
        free_top=store.free_top + live.sum(1, dtype=torch.int32),
    )


def lookup(store: EntityStore, entity):
    """Entity [W, ..., 2] -> (arch, row, valid), each [W, ...]; arch and
    row are -1 where the handle is stale, null or out of range."""
    max_e = store.gen.shape[1]
    eid = Entity.id(entity)
    egen = Entity.gen(entity)
    eid_c = torch.clamp(eid, 0, max_e - 1).long()
    w = store.gen.shape[0]
    widx = torch.arange(w, device=eid.device).reshape(
        (w,) + (1,) * (eid.dim() - 1))
    valid = (egen >= 0) & (eid >= 0) & (eid < max_e) & (
        store.gen[widx, eid_c] == egen)
    arch = torch.where(valid, store.arch[widx, eid_c], -1)
    row = torch.where(valid, store.row[widx, eid_c], -1)
    return arch, row, valid


def update_rows(store: EntityStore, table_eid, table_egen, live_mask):
    """Re-point store.row after a table reorder (sort, compact): row r
    of the table now holds entity (table_egen, table_eid)[:, r]. A row
    whose handle is stale (its id freed and handed out again) does not
    re-point the id's current generation."""
    w, c = table_eid.shape
    max_e = store.gen.shape[1]
    widx = _widx(w, c, table_eid.device)
    rows = torch.arange(c, dtype=torch.int32,
                        device=table_eid.device)[None].expand(w, c)
    eid_c = torch.clamp(table_eid, 0, max_e - 1).long()
    # an id past the store is never written (the JAX scatter drops it)
    ok = live_mask & (table_eid >= 0) & (table_eid < max_e) & (
        store.gen[widx, eid_c] == table_egen)
    return dataclasses.replace(store, row=_scatter.masked_set_2d(
        store.row, widx, eid_c, rows, ok))
