"""Batch renderer: mesh tables, raycaster, render-ECS glue.

Port of ``madrona_tpu/render``: the dense tier and the raycast kernel
tier. The cull tier (``tlas``), the mesh-BVH tier (``blas``), materials
and lights are not ported yet.
"""

from .mesh import MAX_TRIS, MeshRegistry, MeshTables
from .raycast import RenderConfig, camera_rays, render_views
from .ecs import RenderingSystem

__all__ = [
    "MeshRegistry", "MeshTables", "MAX_TRIS",
    "RenderConfig", "render_views", "camera_rays", "RenderingSystem",
]
