"""Asset pipeline: import meshes from disk, bake BVHs.

Port of ``madrona_tpu/assets``: the OBJ, glTF (.gltf / .glb) and MTL
importers with their materials and textures (:mod:`.importer`; textures
decoded to PIL's bytes by :mod:`.png`, :mod:`.jpeg`, :mod:`.bmp`,
:mod:`.tga`, :mod:`.gif`, :mod:`.webp`, :mod:`.dds`, :mod:`.ppm`,
:mod:`.qoi` and :mod:`.ico`), the ASCII USD importer with its
xform hierarchy flattened (:mod:`.usd`) and the host-side SAH mesh BVH
build (:mod:`.bvh`, from the port's own C++ source
``native/bvh_build.cpp``).
"""

from .importer import ImportedMesh, load_obj, load_gltf, import_from_disk
from .usd import load_usd
from .bvh import MeshBVH, build_mesh_bvh

__all__ = [
    "ImportedMesh", "load_obj", "load_gltf", "load_usd", "import_from_disk",
    "MeshBVH", "build_mesh_bvh",
]
