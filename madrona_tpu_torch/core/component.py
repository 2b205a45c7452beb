"""Component and archetype specifications.

Port of ``madrona_tpu/core/component.py``: a component is a declarative
schema (name + per-row shape + torch dtype, or named fields), resolved
when the sim is built. Every field is its own dense
``[num_worlds, capacity, ...]`` tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class ComponentSpec:
    """Schema for one component: a plain array (``shape``/``dtype``) or
    a struct with named ``fields`` ({name: (shape, dtype)}), stored one
    tensor per field."""

    name: str
    shape: tuple = ()
    dtype: Any = torch.float32
    fields: Mapping[str, tuple] | None = None

    @property
    def is_struct(self) -> bool:
        return self.fields is not None

    def zeros(self, lead_shape: Sequence[int], device):
        lead = tuple(lead_shape)
        if self.is_struct:
            return {
                fname: torch.zeros(lead + tuple(fshape), dtype=fdtype,
                                   device=device)
                for fname, (fshape, fdtype) in self.fields.items()
            }
        return torch.zeros(lead + tuple(self.shape), dtype=self.dtype,
                           device=device)


@dataclasses.dataclass(frozen=True)
class ArchetypeSpec:
    """Schema for one archetype: a fixed component set and a capacity.

    fixed_rows  — every world always has exactly ``capacity`` live rows.
    temporary   — rows live for one step.
    no_entities — rows carry no Entity ids.
    """

    name: str
    components: tuple
    capacity: int
    fixed_rows: bool = False
    temporary: bool = False
    no_entities: bool = False
