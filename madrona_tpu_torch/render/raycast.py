"""Batch raycaster: per-agent RGBD views of every world, plain PyTorch.

Port of ``madrona_tpu/render/raycast.py``: the render config, the
camera-ray grid, the dense masked Möller–Trumbore tracer
(:func:`_trace_rays`, which the envs also use for line-of-sight
queries), :func:`render_views`, and the oriented-box slab tracer
:func:`trace_rays_obb` (the plain version of the lidar kernel,
``ops/lidar_cuda.py``).

:func:`render_views` hands every scene whose flat triangle list fits the
raycast kernel's budget to ``render/kernel.py`` (``ops/raycast_cuda``:
the hand-written CUDA kernel on the card, its plain version on the
CPU); larger scenes go to the dense tracer, either the elementwise
Möller–Trumbore sweep (``tracer="mt"``) or its pinhole-factorised
variant :func:`_trace_rays_matmul` (``tracer="matmul"``).

Outputs: float RGB in [0, 1] (lambert-shaded albedo) and linear depth;
the background is the sky colour at depth ``t_max``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from ..utils import math3d as m3
from .mesh import MeshTables


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 64
    height: int = 64
    fov_deg: float = 90.0
    t_max: float = 200.0
    sky_color: tuple = (0.1, 0.2, 0.4)
    light_dir: tuple = (0.3, -0.3, -0.9)   # directional light (world)
    ambient: float = 0.35
    # compute type of the dense tracer's [I, T, R] test tensors; the
    # kernel tier is float32 throughout
    dtype: str = "float32"
    # "mt": elementwise Möller–Trumbore sweep. "matmul": the pinhole
    # factorisation, per-(instance, triangle) constant rows contracted
    # against the ray directions by one matmul per instance.
    tracer: str = "mt"
    # shadow rays: one occlusion test toward the light per primary hit
    shadows: bool = False
    shadow_ambient: float = 0.25   # light scale inside shadow
    # the mesh-BVH tier's walker: "gather", "onehot" or "wide" (the
    # 4-wide collapse where with_wide attached it); "auto" takes "wide"
    # where it is attached, else "gather". Same hits (render/blas.py)
    blas_walker: str = "auto"
    # the mesh-BVH tier's rays a sequential chunk within a view (bounds
    # the (instance, ray, stack) working set): 0 = the whole view up to
    # 1024 rays, else 1024-ray chunks; must divide height * width
    ray_chunk: int = 0


TRACERS = ("mt", "matmul")


def per_view(a, n_views: int):
    """``a`` [W, ...] seen by each of ``n_views`` views: [W, V, ...] (an
    expanded view, no copy)."""
    return a[:, None].expand((a.shape[0], n_views) + a.shape[1:])


def _norm3(v):
    return torch.sqrt(m3.dot(v, v))[..., None]


@functools.lru_cache(maxsize=32)
def _shade_consts(cfg, device):
    """(direction toward the fixed light, sky colour) on ``device``."""
    light = -np.asarray(cfg.light_dir) / np.linalg.norm(cfg.light_dir)
    return tuple(
        torch.tensor(np.asarray(x), dtype=torch.float32, device=device)
        for x in (light, cfg.sky_color))


def camera_rays(cfg: RenderConfig, cam_pos, cam_rot):
    """Ray origins/dirs [..., h, w, 3] of cameras ``cam_pos`` [..., 3],
    ``cam_rot`` [..., 4] (world-from-camera quat). A camera looks along
    +y, x right, z up."""
    h, w = cfg.height, cfg.width
    dev = cam_pos.device
    half = math.tan(math.radians(cfg.fov_deg) * 0.5)
    xs = (torch.arange(w, device=dev) + 0.5) / w * 2.0 - 1.0
    zs = 1.0 - (torch.arange(h, device=dev) + 0.5) / h * 2.0
    px = xs[None, :].expand(h, w) * half * (w / h)
    pz = zs[:, None].expand(h, w) * half
    d_local = torch.stack([px, torch.ones_like(px), pz], dim=-1)
    d_world = m3.quat_rotate(cam_rot[..., None, None, :], d_local)
    d_world = d_world / _norm3(d_world)
    o = cam_pos[..., None, None, :].expand(d_world.shape)
    return o, d_world


def _trace_rays(cfg, mesh: MeshTables, inst_pos, inst_rot, inst_scale,
                inst_obj, inst_mask, origins, dirs):
    """Nearest-hit trace of rays against instanced meshes.

    inst_pos/inst_rot/inst_scale [..., I, 3|4|3], inst_obj [..., I] int,
    inst_mask [..., I] bool, origins/dirs [..., R, 3]; leading axes
    broadcast. ``mesh`` lies on the rays' device. Returns
    (rgb [..., R, 3], depth [..., R]), float32."""
    ctype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    # rays in each instance's local frame
    inv_q = m3.quat_inv(inst_rot)[..., :, None, :]              # [..., I, 1, 4]
    scale = torch.clamp(inst_scale, min=1e-12)[..., :, None, :]
    o_l = m3.quat_rotate(
        inv_q, origins[..., None, :, :] - inst_pos[..., :, None, :]
    ) / scale                                                   # [..., I, R, 3]
    d_l = m3.quat_rotate(inv_q, dirs[..., None, :, :]) / scale

    obj = inst_obj.long()
    v0 = mesh.tri_v0[obj].to(ctype)                             # [..., I, T, 3]
    e1 = mesh.tri_e1[obj].to(ctype)
    e2 = mesh.tri_e2[obj].to(ctype)
    col = mesh.tri_color[obj]
    tmask = mesh.tri_mask[obj]                                  # [..., I, T]

    def comp(a):        # [..., I, T, 3] -> 3 planes [..., I, T, 1]
        return a[..., 0:1], a[..., 1:2], a[..., 2:3]

    def rays(a):        # [..., I, R, 3] -> 3 planes [..., I, 1, R]
        a = a.to(ctype)
        return (a[..., None, :, 0], a[..., None, :, 1], a[..., None, :, 2])

    ox, oy, oz = rays(o_l)
    dx, dy, dz = rays(d_l)
    v0x, v0y, v0z = comp(v0)
    e1x, e1y, e1z = comp(e1)
    e2x, e2y, e2z = comp(e2)

    # p = d x e2, broadcast to [..., I, T, R]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = torch.where(torch.abs(det) > 1e-9, 1.0 / det, 0.0)
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    # q = t x e1
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det

    eps_det = 1e-9 if ctype == torch.float32 else 1e-5
    hit = (
        (torch.abs(det) > eps_det)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > 1e-3) & (t < cfg.t_max)
        & tmask[..., None]
        & inst_mask[..., :, None, None]
    )
    t_hit = torch.where(hit, t, cfg.t_max).to(torch.float32)

    # geometric normal per (I, T), local frame
    n_l = m3.cross(e1, e2).to(torch.float32)
    return _pick_shade(cfg, t_hit, n_l, col, inst_rot, inst_scale)


def _pick_shade(cfg, t_hit, n_l, col, inst_rot, inst_scale):
    """Winner selection and lambert shading. t_hit [..., I, T, R]
    (t_max where missed), n_l and col [..., I, T, 3]. The winner is the
    first (instance, triangle) at the least t. Returns
    (rgb [..., R, 3], depth [..., R])."""
    t_flat = t_hit.flatten(-3, -2)                              # [..., IT, R]
    depth = t_flat.amin(dim=-2)
    idx = torch.arange(t_flat.shape[-2], device=t_hit.device)[:, None]
    win = torch.where(t_flat <= depth[..., None, :], idx,
                      t_flat.shape[-2]).amin(dim=-2)            # [..., R]

    # normals to world space (rotate, undo the scale as a direction)
    n_w = m3.quat_rotate(
        inst_rot[..., :, None, :],
        n_l / torch.clamp(inst_scale, min=1e-12)[..., :, None, :],
    )
    n_w = n_w / torch.clamp(_norm3(n_w), min=1e-12)
    light, sky = _shade_consts(cfg, t_hit.device)
    lam = torch.abs(m3.dot(n_w, light))                         # [..., I, T]
    shade = cfg.ambient + (1 - cfg.ambient) * lam
    rgb_it = (col * shade[..., None]).flatten(-3, -2)           # [..., IT, 3]
    rgb_it = rgb_it.expand(win.shape[:-1] + rgb_it.shape[-2:])
    rgb = torch.gather(rgb_it, -2, win[..., None].expand(win.shape + (3,)))
    rgb = torch.where((depth >= cfg.t_max)[..., None], sky, rgb)
    return rgb, depth


def _trace_rays_matmul(cfg, mesh: MeshTables, inst_pos, inst_rot,
                       inst_scale, inst_obj, inst_mask, origin, dirs):
    """Pinhole-factorised tracer: every ray shares ``origin`` [..., 3], so
    the Möller–Trumbore numerators are per-(instance, triangle) constant
    vectors contracted against the ray directions [..., R, 3]:

        det   = d . (e2 x e1)
        u*det = d . (e2 x (o_l - v0))
        v*det = d . ((o_l - v0) x e1)
        t*det = e2 . ((o_l - v0) x e1)        (independent of the ray)

    one [T*3, 3] @ [3, R] matmul per instance, its inputs rounded to
    ``cfg.dtype`` and summed in float32. Hits match :func:`_trace_rays`
    up to the order of the sums. Returns (rgb [..., R, 3], depth [..., R])."""
    ctype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    inv_q = m3.quat_inv(inst_rot)                               # [..., I, 4]
    scale = torch.clamp(inst_scale, min=1e-12)
    o_l = m3.quat_rotate(inv_q, origin[..., None, :] - inst_pos) / scale
    d_l = m3.quat_rotate(inv_q[..., :, None, :], dirs[..., None, :, :]) / (
        scale[..., :, None, :])                                 # [..., I, R, 3]

    obj = inst_obj.long()
    v0 = mesh.tri_v0[obj]                                       # [..., I, T, 3]
    e1 = mesh.tri_e1[obj]
    e2 = mesh.tri_e2[obj]
    col = mesh.tri_color[obj]
    tmask = mesh.tri_mask[obj]

    tvec = o_l[..., None, :] - v0
    c_det = m3.cross(e2, e1)
    c_u = m3.cross(e2, tvec)
    c_v = m3.cross(tvec, e1)
    t_num = m3.dot(e2, c_v)                                     # [..., I, T]
    coef = torch.stack([c_det, c_u, c_v], dim=-2)               # [..., I, T, 3, 3]
    # the contraction, on inputs rounded to the compute type
    vals = torch.einsum("...tck,...rk->...tcr",
                        coef.to(ctype).to(torch.float32),
                        d_l.to(ctype).to(torch.float32))        # [..., I, T, 3, R]
    det = vals[..., 0, :]
    eps_det = 1e-9 if ctype == torch.float32 else 1e-5
    inv_det = torch.where(torch.abs(det) > eps_det, 1.0 / det, 0.0)
    u = vals[..., 1, :] * inv_det
    v = vals[..., 2, :] * inv_det
    t = t_num[..., None] * inv_det

    hit = (
        (torch.abs(det) > eps_det)
        & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t > 1e-3) & (t < cfg.t_max)
        & tmask[..., None]
        & inst_mask[..., :, None, None]
    )
    t_hit = torch.where(hit, t, cfg.t_max)
    return _pick_shade(cfg, t_hit, m3.cross(e1, e2), col, inst_rot,
                       inst_scale)


def trace_rays_obb(inst_pos, inst_rot, inst_half, inst_mask,
                   origins, dirs, t_max):
    """Nearest-hit distance of each ray against oriented boxes, by the
    exact slab test. Rays that start inside a box hit its exit face;
    hits need t > 1e-3. All float32.

    inst_pos/inst_rot/inst_half: [..., I, 3|4|3] box centers,
    world-from-local quats and half extents; inst_mask [..., I] bool;
    origins/dirs [..., R, 3] (dirs need not be unit: t is in units of
    |dir|). Leading axes broadcast. Returns depth [..., R] (t_max on a
    miss)."""
    inv_q = m3.quat_inv(inst_rot)[..., :, None, :]            # [..., I, 1, 4]
    half = torch.clamp(inst_half, min=1e-12)[..., :, None, :]
    o_l = m3.quat_rotate(
        inv_q, origins[..., None, :, :] - inst_pos[..., :, None, :]
    ) / half                                                  # [..., I, R, 3]
    d_l = m3.quat_rotate(inv_q, dirs[..., None, :, :]) / half
    inv_d = torch.where(torch.abs(d_l) > 1e-12, 1.0 / d_l, 1e30)
    t0 = (-1.0 - o_l) * inv_d
    t1 = (1.0 - o_l) * inv_d
    lo = torch.minimum(t0, t1).amax(dim=-1)                   # [..., I, R]
    hi = torch.maximum(t0, t1).amin(dim=-1)
    t = torch.where(lo > 1e-3, lo, hi)       # inside the box -> exit face
    hit = (
        (hi >= torch.clamp(lo, min=0.0)) & (t > 1e-3) & (t < t_max)
        & inst_mask[..., :, None]
    )
    return torch.where(hit, t, t_max).amin(dim=-2)


def render_views(cfg: RenderConfig, mesh: MeshTables, inst_pos, inst_rot,
                 inst_scale, inst_obj, inst_mask, cam_pos, cam_rot):
    """Render all camera views of all worlds.

    instances [W, I, ...]; cameras [W, V, ...]; inst_mask [W, I] (shared
    by the views) or [W, V, I] (per view, e.g. each ego camera without
    its own body). Returns (rgb [W, V, H, Wpx, 3], depth [W, V, H, Wpx]).
    """
    n_views = cam_pos.shape[1]
    if cfg.tracer not in TRACERS:
        raise ValueError(f"unknown tracer {cfg.tracer!r}")
    if inst_mask.dim() == 2:
        inst_mask = per_view(inst_mask, n_views)

    from .kernel import kernel_eligible, render_views_kernel

    if kernel_eligible(cfg, mesh, None, 0, inst_pos.shape[1]):
        # the raycast kernel tier: MeshTables' padded triangle tables are
        # the flat geometry (pad triangles are degenerate, never hit)
        return render_views_kernel(
            cfg, mesh, inst_pos, inst_rot, inst_scale, inst_obj,
            inst_mask, cam_pos, cam_rot,
        )

    # scenes past the kernel's triangle budget: the dense tracer, one
    # view at a time
    outs = [trace_view(cfg, mesh, inst_pos, inst_rot, inst_scale, inst_obj,
                       inst_mask[:, v], cam_pos[:, v], cam_rot[:, v])
            for v in range(n_views)]
    return (torch.stack([o[0] for o in outs], dim=1),
            torch.stack([o[1] for o in outs], dim=1))


def trace_view(cfg: RenderConfig, mesh: MeshTables, inst_pos, inst_rot,
               inst_scale, inst_obj, inst_mask, cam_pos, cam_rot):
    """One view of every world through the dense tracer ``cfg.tracer``:
    instances [W, I, ...], ``inst_mask`` [W, I], the camera [W, 3|4].
    Returns (rgb [W, H, Wpx, 3], depth [W, H, Wpx])."""
    h, w = cfg.height, cfg.width
    o, d = camera_rays(cfg, cam_pos, cam_rot)
    d = d.reshape(-1, h * w, 3)
    args = (cfg, mesh, inst_pos, inst_rot, inst_scale, inst_obj, inst_mask)
    if cfg.tracer == "matmul":
        # pinhole: every ray of the view starts at the camera
        rgb, dep = _trace_rays_matmul(*args, cam_pos, d)
    elif cfg.tracer == "mt":
        rgb, dep = _trace_rays(*args, o.reshape(-1, h * w, 3), d)
    else:
        raise ValueError(f"unknown tracer {cfg.tracer!r}")
    return rgb.reshape(-1, h, w, 3), dep.reshape(-1, h, w)
