"""RenderingSystem: ECS glue that mirrors sim state into render inputs.

Port of ``madrona_tpu/render/ecs.py``. Instances are views of the
RigidBody table columns, cameras are derived from agent body rows each
step, and the render node writes the RGBD outputs into exported
singletons. Its tiers, as in the JAX package:

* dense (default): ``render/raycast.py::render_views``, through the
  raycast kernel where the scene fits its budget;
* the per-view cull (``tlas_max_instances`` > 0):
  ``render/tlas.py::render_views_tlas``, with the per-view overlap count
  exported as ``tlas_overlap`` (the ``TlasOverlap`` singleton) and
  :meth:`RenderingSystem.maybe_grow_tlas` to raise K;
* the mesh-BVH tier (``blas``, with ``materials`` and ``lights`` or
  ``lights_fn``): ``render/blas.py::render_views_blas``, the cull too
  where ``tlas_max_instances`` > 0.

The tables may lie on any device; the node moves them to the state's
device once and keeps them there. ``MADRONA_TPU_BLAS_WIDE=1`` (or
``bf16``) attaches the 4-wide collapse (``render/blas.py::with_wide``,
float32 or bfloat16 boxes) to any BLAS tier, as in the JAX package; the
hits are the same.

Usage: ``RenderingSystem.register_types`` and ``setup_tasks`` on a
builder (Hide & Seek gives the renderer a graph of its own).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import torch

from ..core.registry import ECSRegistry
from ..core.state import SimState, StateManager
from ..graph.builder import TaskGraphBuilder
from ..utils import math3d as m3
from .mesh import MeshTables
from .raycast import RenderConfig, render_views


def _to(x, device):
    return None if x is None else x.to(device)


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
        tlas_max_instances: int = 0,  # >0: per-view top-K cull tier
        blas=None,                    # BlasTables: the mesh-BVH tier
        materials=None,               # MaterialTables for the BLAS tier
        lights=None,                  # lights.Lights [W, L] (static)
        lights_fn=None,               # or fn(state) -> Lights (dynamic)
    ):
        self.mesh = mesh
        wide_env = os.environ.get("MADRONA_TPU_BLAS_WIDE", "")
        if blas is not None and wide_env and blas.wide is None:
            from .blas import with_wide

            blas = with_wide(blas, aabb_dtype=(
                "bfloat16" if wide_env in ("bf16", "bfloat16")
                else "float32"))
        self.blas = blas
        self.materials = materials
        self.lights = lights
        self.lights_fn = lights_fn
        self.tlas_max_instances = tlas_max_instances
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
            mesh=mesh, blas=blas, materials=materials, lights=lights,
            render_obj=render_obj, view_mask=view_mask,
            camera_offset=torch.tensor(camera_offset, dtype=torch.float32),
            cam_rows=torch.tensor(self.camera_rows, dtype=torch.long),
        )
        self._on = {}

    def _const(self, device):
        """The mesh tables and index tensors on ``device``."""
        if device not in self._on:
            self._on[device] = {k: _to(v, device)
                                for k, v in self._host.items()}
        return self._on[device]

    def register_types(self, reg: ECSRegistry):
        v = len(self.camera_rows)
        h, w = self.cfg.height, self.cfg.width
        reg.register_singleton("RGBOut", (v, h, w, 3), torch.float32)
        reg.register_singleton("DepthOut", (v, h, w), torch.float32)
        reg.export_singleton("RGBOut", "rgb")
        reg.export_singleton("DepthOut", "depth")
        if self.tlas_max_instances > 0:
            # the true per-view frustum overlap count: the cull tier's
            # overflow signal (the cull is exact while overlap <= K)
            reg.register_singleton("TlasOverlap", (v,), torch.int32)
            reg.export_singleton("TlasOverlap", "tlas_overlap")

    def setup_tasks(self, b: TaskGraphBuilder, deps=()):
        return b.custom(self._render_node, deps=deps, name="render_views")

    # ------------------------------------------------------------- node

    def render_inputs(self, state: SimState):
        """The render function's arguments after the config at ``state``:
        the tables (mesh, or the BLAS tables), instance pos/rot/scale/obj
        [W, N, ...], the per-view mask [W, V, N] and the cameras
        [W, V, 3|4]; in the BLAS tier then the materials and the lights
        (``lights_fn(state)`` where given), which
        ``render/kernel.py::kernel_inputs`` takes in that order too."""
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
        args = (pos, rot, scale, inst_obj, inst_mask, cam_pos, cam_rot)
        if self.blas is None:
            return (cst["mesh"],) + args
        lights = (cst["lights"] if self.lights_fn is None
                  else self.lights_fn(state))
        return (cst["blas"],) + args + (cst["materials"], lights)

    def _render_node(self, sm: StateManager, state: SimState, node_key):
        k = self.tlas_max_instances
        inputs = self.render_inputs(state)
        overlap = None
        if self.blas is not None:
            # the mesh-BVH tier: materials, textures and shadows sampled
            # per hit (through the raycast kernel where it can shade them)
            from .blas import render_views_blas

            out = render_views_blas(
                self.cfg, *inputs[:8], materials=inputs[8],
                lights=inputs[9], max_instances_per_view=k)
            rgb, depth = out[:2]
            if k > 0:
                overlap = out[2]
        elif k > 0:
            from .tlas import render_views_tlas

            rgb, depth, overlap = render_views_tlas(
                self.cfg, *inputs, max_instances_per_view=k)
        else:
            rgb, depth = render_views(self.cfg, *inputs)
        singles = dict(state.singletons)
        singles["RGBOut"] = rgb
        singles["DepthOut"] = depth
        if overlap is not None and "TlasOverlap" in singles:
            singles["TlasOverlap"] = overlap.to(torch.int32)
        return dataclasses.replace(state, singletons=singles)

    # ------------------------------------------------------- adaptive K

    def maybe_grow_tlas(self, executor, margin: float = 1.0) -> int:
        """Adaptive cull K (the capacity-tier pattern): if any view's
        true frustum overlap exceeded the current K, raise K to the
        observed maximum (times ``margin``, rounded up to a multiple of
        4, at most the instance count). Returns the new K (unchanged
        without an overflow). Reads the overlap back to the host: call
        it between rollouts, not every step.

        The JAX package also drops its executor's compiled step
        functions here; the port's executor is eager and keeps none, so
        the next step simply renders at the new K."""
        if self.tlas_max_instances <= 0:
            return self.tlas_max_instances
        seen = int(executor.state.singletons["TlasOverlap"].max())
        if seen <= self.tlas_max_instances:
            return self.tlas_max_instances
        new_k = int(-(-int(seen * margin) // 4) * 4)
        # K past the instance count selects everything
        new_k = min(new_k, int(self._host["render_obj"].shape[0]))
        self.tlas_max_instances = new_k
        return new_k
