"""StateManager and SimState: ECS schemas and the state they describe.

Port of ``madrona_tpu/core/state.py``. The schema side (components,
archetypes, singletons, import/export slots) is plain Python; the state
side is :class:`SimState`, a dataclass of tensors with an explicit
device. Exported tensors are the state's own tensors: no copy-out.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from . import archetype as _arch
from . import entity_store as _estore
from .component import ArchetypeSpec, ComponentSpec
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
        self.components[spec.name] = spec
        return spec

    def register_archetype(self, spec: ArchetypeSpec) -> ArchetypeSpec:
        self._check_open()
        if spec.name in self.archetypes:
            raise ValueError(f"archetype {spec.name!r} already registered")
        for cname in spec.components:
            if cname not in self.components:
                raise ValueError(
                    f"archetype {spec.name!r} references unregistered "
                    f"component {cname!r}"
                )
        self.archetypes[spec.name] = spec
        return spec

    def register_singleton(self, spec: ComponentSpec) -> ComponentSpec:
        self._check_open()
        if spec.name in self.singletons:
            raise ValueError(f"singleton {spec.name!r} already registered")
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

    def _check_open(self):
        if self._frozen:
            raise RuntimeError("StateManager is frozen (state already built)")

    # -- state construction --------------------------------------------------

    def init_state(self, num_worlds: int, seed: int = 0,
                   max_entities: Optional[int] = None,
                   device="cpu") -> SimState:
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
