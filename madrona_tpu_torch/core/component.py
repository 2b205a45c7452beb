"""Component and archetype specifications.

Port of ``madrona_tpu/core/component.py``: a component is a declarative
schema (name + per-row shape + torch dtype, or named fields), resolved
when the sim is built. Every field is its own dense
``[num_worlds, capacity, ...]`` tensor. An entity reference is a
``[..., 2]`` int32 pair (generation, id); generation -1 is "none".
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

import torch

f32 = torch.float32
i32 = torch.int32


def scalar(dtype=f32):
    return ((), dtype)


def vec2(dtype=f32):
    return ((2,), dtype)


def vec3(dtype=f32):
    return ((3,), dtype)


def vec4(dtype=f32):
    return ((4,), dtype)


def quat():
    """Quaternion (w, x, y, z), as utils.math3d holds them."""
    return ((4,), f32)


def entity_ref():
    """An entity reference stored in a component: (gen, id) int32."""
    return ((2,), i32)


# Entity::none(): generation -1 (invalid)
NULL_ENTITY = (-1, -1)


class Entity:
    """Entity-reference helpers over [..., 2] int32 tensors (gen, id)."""

    @staticmethod
    def none(shape=(), device=None):
        return torch.full(tuple(shape) + (2,), -1, dtype=i32, device=device)

    @staticmethod
    def make(gen, eid):
        return torch.stack([torch.as_tensor(gen).to(i32),
                            torch.as_tensor(eid).to(i32)], dim=-1)

    @staticmethod
    def gen(e):
        return e[..., 0]

    @staticmethod
    def id(e):
        return e[..., 1]

    @staticmethod
    def is_none(e):
        return e[..., 0] < 0


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
