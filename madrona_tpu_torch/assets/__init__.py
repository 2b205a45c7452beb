"""Assets: the host-side mesh BVH build and the material/texture records.

Port of the parts of ``madrona_tpu/assets`` that the renderer's mesh-BVH
tier needs: :mod:`.bvh` (the SAH build, from the port's own C++ source
``native/bvh_build.cpp``) and the two records of :mod:`.importer` that a
material bake takes. The OBJ, glTF and MTL loaders are not ported.
"""

from .bvh import MeshBVH, build_mesh_bvh
from .importer import ImportedMaterial, ImportedTexture

__all__ = ["MeshBVH", "build_mesh_bvh", "ImportedMaterial",
           "ImportedTexture"]
