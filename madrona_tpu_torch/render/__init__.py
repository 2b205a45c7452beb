"""Batch renderer: mesh tables, raycaster, render-ECS glue.

Port of ``madrona_tpu/render``: the dense tier and the raycast kernel
tier, the per-view cull (``tlas``), the mesh-BVH tier (``blas``: the
gather, one-hot and 4-wide walkers, ``bake_assets_blas`` for imported
assets), and the material and light tables.
"""

from .mesh import MAX_TRIS, MeshRegistry, MeshTables
from .raycast import RenderConfig, camera_rays, render_views
from .ecs import RenderingSystem
from .tlas import (
    TLAS, build_tlas, tlas_candidates, render_views_tlas,
    instance_world_aabbs, object_aabbs,
)
from .blas import (
    BlasTables, bake_blas, render_views_blas, trace_rays_blas,
    trace_scene_blas,
)
from .materials import MaterialTables, bake_materials, sample_materials
from .lights import Lights, make_lights

__all__ = [
    "Lights", "make_lights",
    "MeshRegistry", "MeshTables", "MAX_TRIS",
    "RenderConfig", "render_views", "camera_rays", "RenderingSystem",
    "TLAS", "build_tlas", "tlas_candidates", "render_views_tlas",
    "instance_world_aabbs", "object_aabbs",
    "BlasTables", "bake_blas", "render_views_blas",
    "trace_rays_blas", "trace_scene_blas",
    "MaterialTables", "bake_materials", "sample_materials",
]
