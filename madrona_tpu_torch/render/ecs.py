"""RenderingSystem: ECS glue that mirrors sim state into render inputs.

Port of ``madrona_tpu/render/ecs.py`` on its dense branch. Instances are
views of the RigidBody table columns, cameras are derived from agent
body rows each step, and the render node writes the RGBD outputs into
exported singletons. The per-view cull tier (``tlas_max_instances`` > 0,
``maybe_grow_tlas``) and the mesh-BVH tier (``blas``, with materials and
lights) are not ported yet and raise ``NotImplementedError``.

Usage: ``RenderingSystem.register_types`` and ``setup_tasks`` on a
builder (Hide & Seek gives the renderer a graph of its own).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ..core.registry import ECSRegistry
from ..core.state import SimState, StateManager
from ..graph.builder import TaskGraphBuilder
from ..utils import math3d as m3
from .mesh import MeshTables
from .raycast import RenderConfig, render_views


class RenderingSystem:
    """Per-env renderer wiring."""

    def __init__(
        self,
        mesh: MeshTables,
        cfg: RenderConfig,
        body_arch: str,
        render_obj_of_body,          # [N] int: render object per body row
        camera_rows: Sequence[int],  # body rows that carry a camera
        camera_offset=(0.0, 0.0, 0.0),
        exclude_self: bool = True,   # each view drops its own body row
        body_mask=None,              # [N] bool: rows that render
        tlas_max_instances: int = 0,
        blas=None, materials=None, lights=None, lights_fn=None,
    ):
        if tlas_max_instances > 0:
            raise NotImplementedError(
                "the per-view cull tier (render/tlas) is not ported yet"
            )
        if blas is not None:
            raise NotImplementedError(
                "the mesh-BVH render tier (render/blas) is not ported yet"
            )
        self.mesh = mesh
        self.cfg = cfg
        self.body_arch = body_arch
        self.camera_rows = tuple(camera_rows)
        render_obj = torch.as_tensor(render_obj_of_body, dtype=torch.int32)
        n = render_obj.shape[0]
        body_mask = (torch.ones(n, dtype=torch.bool) if body_mask is None
                     else torch.as_tensor(body_mask, dtype=torch.bool))
        # [V, N] per-view mask: an ego camera must not trace its own body
        # (its eye sits inside the agent's mesh)
        view_mask = body_mask[None, :].expand(len(self.camera_rows), n)
        if exclude_self:
            own = (torch.arange(n)[None, :]
                   == torch.tensor(self.camera_rows)[:, None])
            view_mask = view_mask & ~own
        self._host = dict(
            mesh=mesh, render_obj=render_obj, view_mask=view_mask,
            camera_offset=torch.tensor(camera_offset, dtype=torch.float32),
            cam_rows=torch.tensor(self.camera_rows, dtype=torch.long),
        )
        self._on = {}

    def _const(self, device):
        """The mesh tables and index tensors on ``device``."""
        if device not in self._on:
            self._on[device] = {k: v.to(device)
                                for k, v in self._host.items()}
        return self._on[device]

    def register_types(self, reg: ECSRegistry):
        v = len(self.camera_rows)
        h, w = self.cfg.height, self.cfg.width
        reg.register_singleton("RGBOut", (v, h, w, 3), torch.float32)
        reg.register_singleton("DepthOut", (v, h, w), torch.float32)
        reg.export_singleton("RGBOut", "rgb")
        reg.export_singleton("DepthOut", "depth")

    def setup_tasks(self, b: TaskGraphBuilder, deps=()):
        return b.custom(self._render_node, deps=deps, name="render_views")

    # ------------------------------------------------------------- node

    def render_inputs(self, state: SimState):
        """``render_views``' arguments after the config at ``state``:
        mesh, instance pos/rot/scale/obj [W, N, ...], the per-view mask
        [W, V, N] and the cameras [W, V, 3|4]."""
        t = state.tables[self.body_arch]
        pos = t.columns["Position"]               # [W, N, 3]
        rot = t.columns["Rotation"]
        scale = t.columns["Scale"]
        w = pos.shape[0]
        cst = self._const(pos.device)
        cam_rot = rot[:, cst["cam_rows"]]
        cam_pos = pos[:, cst["cam_rows"]] + m3.quat_rotate(
            cam_rot, cst["camera_offset"]
        )
        inst_mask = cst["view_mask"][None].expand(
            (w,) + cst["view_mask"].shape)
        inst_obj = cst["render_obj"][None].expand(pos.shape[:2])
        return (cst["mesh"], pos, rot, scale, inst_obj, inst_mask,
                cam_pos, cam_rot)

    def _render_node(self, sm: StateManager, state: SimState, node_key):
        rgb, depth = render_views(self.cfg, *self.render_inputs(state))
        singles = dict(state.singletons)
        singles["RGBOut"] = rgb
        singles["DepthOut"] = depth
        return dataclasses.replace(state, singletons=singles)
