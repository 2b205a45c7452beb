"""Entity destruction and table compaction.

Port of ``madrona_tpu/ops/lifecycle.py`` (the reference's
destroyEntityNow and RecycleEntitiesNode): destroyed entities give their
ids back to the store's free stack (their generation bumped), and the
table moves its live rows to the front in one stable gather, keeping
the dense rows that ``parallel_for`` masking relies on.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import archetype as _arch
from ..core import entity_store as _estore
from ..core.state import SimState, StateManager


def destroy_entities(sm: StateManager, state: SimState, arch: str,
                     entities, valid) -> SimState:
    """Destroy up to K entities a world in archetype ``arch``.

    entities: [W, K, 2] (gen, id); valid: [W, K] bool. Stale or null
    handles, and handles of another archetype, are ignored. Raises for
    an archetype with fixed rows."""
    spec = sm.archetypes[arch]
    if spec.fixed_rows:
        raise ValueError(f"archetype {arch!r} has fixed rows")
    table = state.tables[arch]
    cap = spec.capacity
    w = valid.shape[0]
    store = state.entities

    e_arch, e_row, ok = _estore.lookup(store, entities)
    ok = ok & valid & (e_arch == sm.arch_index(arch))

    # mark the dead rows (a row past the table is never marked, as the
    # JAX scatter drops it)
    widx = torch.arange(w, device=valid.device)[:, None].expand(ok.shape)
    mark = ok & (e_row < cap)
    dead = torch.zeros((w, cap), dtype=torch.bool, device=valid.device)
    dead[widx[mark], e_row[mark].long()] = True
    live = _arch.row_mask(table, cap) & ~dead

    # stable compaction: live rows first, in their order
    order = torch.argsort((~live).to(torch.int32), dim=1, stable=True)
    table = _arch.gather_rows(table, order)
    new_counts = live.sum(1, dtype=torch.int32)
    # wipe the entity ids of the now-dead tail
    tail = torch.arange(cap, device=valid.device)[None, :] >= new_counts[:, None]
    table = dataclasses.replace(
        table, num_rows=new_counts,
        entity_id=torch.where(tail, -1, table.entity_id),
        entity_gen=torch.where(tail, -1, table.entity_gen),
    )

    # free the ids, then re-point the surviving rows
    store = _estore.free(store, entities, ok)
    store = _estore.update_rows(store, table.entity_id, table.entity_gen,
                                _arch.row_mask(table, cap))
    tables = dict(state.tables)
    tables[arch] = table
    return dataclasses.replace(state, tables=tables, entities=store)
