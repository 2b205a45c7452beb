"""Imported material and texture records.

Port of the two dataclasses of ``madrona_tpu/assets/importer.py`` that
``render/materials.py::bake_materials`` takes. The file loaders (OBJ,
glTF, MTL) are not ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ImportedMaterial:
    """Base colour, metallic/roughness and an optional base-colour
    texture index (the reference's ``SourceMaterial``)."""

    name: str = ""
    base_color: np.ndarray = None      # [4] RGBA factor
    metallic: float = 0.0
    roughness: float = 1.0
    texture: int = -1                  # index into the texture list

    def __post_init__(self):
        if self.base_color is None:
            self.base_color = np.ones(4, np.float32)


@dataclasses.dataclass
class ImportedTexture:
    """An RGBA8 image (the reference's ``SourceTexture``)."""

    name: str
    data: np.ndarray                   # [H, W, 4] u8
