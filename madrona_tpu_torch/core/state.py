"""StateManager and SimState: ECS schemas and the state they describe.

Port of ``madrona_tpu/core/state.py``. The schema side (components,
bundles, archetypes, singletons, import/export slots, queries) is plain
Python; the state side is :class:`SimState`, a dataclass of tensors with
an explicit device. Exported tensors are the state's own tensors: no
copy-out. :meth:`StateManager.make_entities` and
:meth:`StateManager.append_temporaries` create rows in a batch, the
same for every world.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from . import archetype as _arch
from .device import resolve_device
from . import entity_store as _estore
from .component import ArchetypeSpec, ComponentSpec, note_int64_leaves
from ..ops import scatter as _scatter
from ..utils import rng as _rng


@dataclasses.dataclass
class SimState:
    tables: Dict[str, _arch.Table]
    singletons: Dict[str, Any]
    entities: _estore.EntityStore
    rng: torch.Tensor     # [W, 2] int64 — Threefry words, masked to 32 bits
    step: torch.Tensor    # [] int32 — global step counter


def _map_leaves(fn, a, b):
    """fn over matching leaves of ``a`` (tensor or dict of tensors) and
    ``b`` (same structure)."""
    if isinstance(a, dict):
        return {k: fn(v, b[k]) for k, v in a.items()}
    return fn(a, b)


def _as_like(old: torch.Tensor, value) -> torch.Tensor:
    return torch.as_tensor(value, device=old.device).to(old.dtype).reshape(
        old.shape
    )


class StateManager:
    """Registry of specs and factory for :class:`SimState`."""

    def __init__(self):
        self.components: Dict[str, ComponentSpec] = {}
        self.archetypes: Dict[str, ArchetypeSpec] = {}
        self.singletons: Dict[str, ComponentSpec] = {}
        self.bundles: Dict[str, Tuple[str, ...]] = {}
        self.exports: Dict[str, Tuple[str, str]] = {}  # slot -> (arch, comp)
        self.singleton_exports: Dict[str, str] = {}    # slot -> singleton
        self.imports: Dict[str, Tuple[str, str]] = {}  # slot -> (arch, comp)
        self.singleton_imports: Dict[str, str] = {}    # slot -> singleton
        self._frozen = False

    # -- registration --------------------------------------------------------

    def register_component(self, spec: ComponentSpec) -> ComponentSpec:
        self._check_open()
        if spec.name in self.components:
            raise ValueError(f"component {spec.name!r} already registered")
        note_int64_leaves(spec)
        self.components[spec.name] = spec
        return spec

    def register_archetype(self, spec: ArchetypeSpec) -> ArchetypeSpec:
        self._check_open()
        if spec.name in self.archetypes:
            raise ValueError(f"archetype {spec.name!r} already registered")
        expanded = self._expand_bundles(spec.components)
        if expanded != spec.components:
            spec = dataclasses.replace(spec, components=expanded)
        for cname in spec.components:
            if cname not in self.components:
                raise ValueError(
                    f"archetype {spec.name!r} references unregistered "
                    f"component {cname!r}"
                )
        self.archetypes[spec.name] = spec
        return spec

    def register_bundle(self, name: str, components) -> Tuple[str, ...]:
        """A named component group, usable inside archetype component
        lists; bundles may nest."""
        self._check_open()
        if name in self.bundles or name in self.components:
            raise ValueError(f"bundle {name!r} collides with existing name")
        expanded = self._expand_bundles(tuple(components))
        for cname in expanded:
            if cname not in self.components:
                raise ValueError(
                    f"bundle {name!r} references unregistered "
                    f"component {cname!r}"
                )
        self.bundles[name] = expanded
        return expanded

    def register_bundle_alias(self, alias: str, bundle: str):
        """A second name for a registered bundle."""
        self._check_open()
        if bundle not in self.bundles:
            raise ValueError(f"bundle {bundle!r} not registered")
        if alias in self.bundles or alias in self.components:
            raise ValueError(f"alias {alias!r} collides with existing name")
        self.bundles[alias] = self.bundles[bundle]
        return self.bundles[alias]

    def _expand_bundles(self, components) -> Tuple[str, ...]:
        """Component names with each bundle replaced by its members, each
        name once (in first-seen order)."""
        out = []
        for cname in components:
            out.extend(self.bundles.get(cname, (cname,)))
        return tuple(dict.fromkeys(out))

    def register_singleton(self, spec: ComponentSpec) -> ComponentSpec:
        self._check_open()
        if spec.name in self.singletons:
            raise ValueError(f"singleton {spec.name!r} already registered")
        note_int64_leaves(spec)
        self.singletons[spec.name] = spec
        return spec

    def export_column(self, arch: str, comp: str, slot: Optional[str] = None):
        slot = slot or f"{arch}.{comp}"
        if comp not in self.archetypes[arch].components:
            raise ValueError(f"{comp!r} not in archetype {arch!r}")
        self.exports[slot] = (arch, comp)
        return slot

    def export_singleton(self, name: str, slot: Optional[str] = None):
        slot = slot or name
        if name not in self.singletons:
            raise ValueError(f"singleton {name!r} not registered")
        self.singleton_exports[slot] = name
        return slot

    def import_column(self, arch: str, comp: str, slot: Optional[str] = None):
        slot = slot or f"{arch}.{comp}"
        if comp not in self.archetypes[arch].components:
            raise ValueError(f"{comp!r} not in archetype {arch!r}")
        self.imports[slot] = (arch, comp)
        return slot

    def import_singleton(self, name: str, slot: Optional[str] = None):
        slot = slot or name
        if name not in self.singletons:
            raise ValueError(f"singleton {name!r} not registered")
        self.singleton_imports[slot] = name
        return slot

    def apply_imports(self, state: SimState, inputs: Dict[str, Any]) -> SimState:
        """Use the caller's tensors as this step's imported columns and
        singletons (cast to the registered dtype, moved to the state's
        device)."""
        if not inputs:
            return state
        tables = dict(state.tables)
        singles = dict(state.singletons)
        for slot, value in inputs.items():
            if slot in self.imports:
                arch, comp = self.imports[slot]
                cols = dict(tables[arch].columns)
                cols[comp] = _map_leaves(_as_like, cols[comp], value)
                tables[arch] = dataclasses.replace(tables[arch], columns=cols)
            elif slot in self.singleton_imports:
                name = self.singleton_imports[slot]
                singles[name] = _map_leaves(_as_like, singles[name], value)
            else:
                raise KeyError(f"unknown input slot {slot!r}")
        return dataclasses.replace(state, tables=tables, singletons=singles)

    def arch_index(self, name: str) -> int:
        """The archetype's index in registration order (the entity
        store's ``arch`` value)."""
        return list(self.archetypes).index(name)

    def _check_open(self):
        if self._frozen:
            raise RuntimeError("StateManager is frozen (state already built)")

    def query(self, *component_names: str):
        """The archetypes holding every one of ``component_names``, in
        registration order."""
        return [
            a.name for a in self.archetypes.values()
            if all(c in a.components for c in component_names)
        ]

    # -- state construction --------------------------------------------------

    def init_state(self, num_worlds: int, seed: int = 0,
                   max_entities: Optional[int] = None,
                   device=None) -> SimState:
        """The zeroed state of ``num_worlds`` worlds on ``device``
        (``None``: the card, as ``core/device.py`` resolves it)."""
        device = resolve_device(device)
        self._frozen = True
        if max_entities is None:
            max_entities = max(1, sum(
                a.capacity for a in self.archetypes.values()
                if not a.no_entities
            ))
        tables = {
            name: _arch.make_table(spec, self.components, num_worlds, device)
            for name, spec in self.archetypes.items()
        }
        singles = {
            name: spec.zeros((num_worlds,), device)
            for name, spec in self.singletons.items()
        }
        world_seeds = torch.full((num_worlds,), seed, dtype=torch.int64,
                                 device=device)
        base = _rng.key(world_seeds)
        keys = _rng.split_i(
            base, torch.arange(num_worlds, dtype=torch.int64, device=device)
        )
        return SimState(
            tables=tables,
            singletons=singles,
            entities=_estore.init(num_worlds, max_entities, device),
            rng=keys,
            step=torch.zeros((), dtype=torch.int32, device=device),
        )

    # -- export ----------------------------------------------------------------

    def collect_exports(self, state: SimState) -> Dict[str, Any]:
        out = {}
        for slot, (arch, comp) in self.exports.items():
            out[slot] = state.tables[arch].columns[comp]
        for slot, name in self.singleton_exports.items():
            out[slot] = state.singletons[name]
        return out

    # -- entity operations ---------------------------------------------------

    def make_entities(self, state: SimState, arch: str, values, valid):
        """Create up to K entities a world in archetype ``arch``.

        values[comp]: [W, K, ...]; valid: [W, K] bool. Returns (state',
        entity [W, K, 2]). The candidates that would overflow the table
        are masked before ids are allocated (so no handle points past
        capacity); they get Entity.none() and count into the table's
        overflow."""
        spec = self.archetypes[arch]
        table = state.tables[arch]
        base_row = table.num_rows
        vi = valid.to(torch.int32)
        rank = torch.cumsum(vi, dim=1, dtype=torch.int32) - vi
        fits = base_row[:, None] + rank < spec.capacity
        store, ent, rows = _estore.alloc(
            state.entities, valid & fits, self.arch_index(arch), base_row)
        ok = rows >= 0
        table = _arch.append_many(table, values, ok)
        table = dataclasses.replace(
            table, overflow=table.overflow + (valid & ~fits).sum(
                1, dtype=torch.int32))
        w, k = ok.shape
        widx = torch.arange(w, device=ok.device)[:, None].expand(w, k)
        rows_l = torch.clamp(rows, min=0).long()
        table = dataclasses.replace(
            table,
            entity_id=_scatter.masked_set_2d(table.entity_id, widx, rows_l,
                                             ent[..., 1], ok),
            entity_gen=_scatter.masked_set_2d(table.entity_gen, widx, rows_l,
                                              ent[..., 0], ok),
        )
        tables = dict(state.tables)
        tables[arch] = table
        return dataclasses.replace(state, tables=tables, entities=store), ent

    def append_temporaries(self, state: SimState, arch: str, values, valid):
        """Append id-less rows to a temporary archetype (makeTemporary)."""
        tables = dict(state.tables)
        tables[arch] = _arch.append_many(state.tables[arch], values, valid)
        return dataclasses.replace(state, tables=tables)
