"""ECSRegistry: the app-facing registration facade over StateManager.

Port of ``madrona_tpu/core/registry.py``; dtypes are torch dtypes.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .component import ArchetypeSpec, ComponentSpec
from .state import StateManager


class ECSRegistry:
    def __init__(self, sm: StateManager):
        self._sm = sm

    def register_component(self, name: str, shape=(), dtype=torch.float32,
                           fields=None) -> ComponentSpec:
        return self._sm.register_component(ComponentSpec(
            name=name, shape=tuple(shape), dtype=dtype, fields=fields
        ))

    def register_archetype(self, name: str, components: Sequence[str],
                           capacity: int, fixed_rows: bool = False,
                           temporary: bool = False) -> ArchetypeSpec:
        return self._sm.register_archetype(ArchetypeSpec(
            name=name, components=tuple(components), capacity=capacity,
            fixed_rows=fixed_rows, temporary=temporary,
            no_entities=temporary,
        ))

    def register_bundle(self, name: str, components: Sequence[str]):
        """A named component group, expanded inside archetype component
        lists (the reference's registerBundle); bundles may nest."""
        return self._sm.register_bundle(name, components)

    def register_bundle_alias(self, alias: str, bundle: str):
        """A second name for an existing bundle (registerBundleAlias)."""
        return self._sm.register_bundle_alias(alias, bundle)

    def register_singleton(self, name: str, shape=(), dtype=torch.float32,
                           fields=None) -> ComponentSpec:
        return self._sm.register_singleton(ComponentSpec(
            name=name, shape=tuple(shape), dtype=dtype, fields=fields
        ))

    def export_column(self, arch: str, comp: str, slot: Optional[str] = None):
        return self._sm.export_column(arch, comp, slot)

    def export_singleton(self, name: str, slot: Optional[str] = None):
        return self._sm.export_singleton(name, slot)

    def import_column(self, arch: str, comp: str, slot: Optional[str] = None):
        return self._sm.import_column(arch, comp, slot)

    def import_singleton(self, name: str, slot: Optional[str] = None):
        return self._sm.import_singleton(name, slot)
