"""Glue for the raycast kernel (``ops/raycast_cuda``).

Port of ``madrona_tpu/render/kernel.py``: builds the per-(world, view)
triangle setup rows and per-triangle attribute rows the kernel reads,
and reshapes its per-ray planes into the renderer's contract
(rgb [W, V, H, Wpx, 3], depth [W, V, H, Wpx]). Everything per pixel
(trace, shadow test, material and texture sample, shade and sky
compose) happens inside the kernel; this module is plain tensor code,
batched over worlds and views.

The "acceleration structure" is the flat per-view triangle list itself:
for batch-sim scenes (tens of instances of tens of triangles) no tree is
needed. Scenes past ``MAX_FLAT_TRIS`` go to the dense tracer (or, in the
mesh-BVH tier, the BVH walk).

Eligibility (:func:`kernel_eligible`): flat triangle count within the
budget, lights either absent or all directional with at most one
shadow caster (the kernel's shadow test needs one shared direction).
``lights`` is a ``render/lights.Lights`` table [W, L] and ``materials`` a
``render/materials.MaterialTables``; the per-triangle uvs and material
ids are ``blas.tri_uv [O, T, 3, 2]`` and ``blas.tri_mat [O, T]``
(``render/blas.BlasTables``). :func:`view_overlap_counts` is the cull
tier's per-view overlap count, computed beside the kernel's full trace.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops import raycast_cuda as rck
from ..utils import math3d as m3

MAX_FLAT_TRIS = 2048
SHADOW_EPS = 2e-2


def _host(x):
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _static_lights_info(lights, want_shadows):
    """Host-side analysis of a (static) light table. Returns
    (ok, shadow_idx): whether the kernel can shade it, and the one
    shadow-casting slot or -1.

    The flags are read back to the host once per table and the answer is
    kept on the table object: a light table is static, and one whose
    flags change is a new table (``Lights.map``, ``make_lights``)."""
    if lights is None:
        return True, -1
    seen = vars(lights).setdefault("_kernel_lights_info", {})
    if want_shadows not in seen:
        seen[want_shadows] = _lights_info(lights, want_shadows)
    return seen[want_shadows]


def _lights_info(lights, want_shadows):
    spot = _host(lights.is_spot)
    active = _host(lights.active)
    cast = _host(lights.cast_shadow)
    if (spot & active).any():
        return False, -1
    if not want_shadows:
        return True, -1
    sh = active & cast
    # the shadow caster must be one slot, the same in every world
    per_slot = sh.any(axis=0) if sh.ndim == 2 else sh
    idx = np.nonzero(per_slot)[0]
    if len(idx) > 1:
        return False, -1
    if len(idx) == 1 and sh.ndim == 2 and not (
        sh[:, idx[0]] == sh[0, idx[0]]
    ).all():
        return False, -1
    return True, int(idx[0]) if len(idx) else -1


def kernel_eligible(cfg, blas, lights, max_instances_per_view, n_inst):
    """Static gate of the kernel tier. A per-view cull
    (``max_instances_per_view`` > 0) does not matter: the kernel traces
    the full instance set."""
    if n_inst * blas.tri_v0.shape[1] > MAX_FLAT_TRIS:
        return False
    ok, _ = _static_lights_info(lights, bool(cfg.shadows))
    return ok


def _world_tris(blas, inst_pos, inst_rot, inst_scale, inst_obj):
    """World-space triangles of every world, flattened over (instance,
    triangle): dict of [W, IT, ...] tensors."""
    obj = inst_obj.long()
    scale = torch.clamp(inst_scale, min=1e-12)[:, :, None, :]
    rot = inst_rot[:, :, None, :]
    v0w = inst_pos[:, :, None, :] + m3.quat_rotate(rot, blas.tri_v0[obj] * scale)
    e1w = m3.quat_rotate(rot, blas.tri_e1[obj] * scale)
    e2w = m3.quat_rotate(rot, blas.tri_e2[obj] * scale)
    out = dict(v0=v0w.flatten(1, 2), e1=e1w.flatten(1, 2),
               e2=e2w.flatten(1, 2), col=blas.tri_color[obj].flatten(1, 2))
    if getattr(blas, "tri_uv", None) is not None:
        uv = blas.tri_uv.reshape(blas.tri_uv.shape[:2] + (6,))
        out["uv"] = uv[obj].flatten(1, 2)                  # [W, IT, 6]
        out["mat"] = blas.tri_mat[obj].flatten(1, 2)       # [W, IT]
    return out


def _vec_mat(v, r):
    """Row vectors v [..., 3] times matrices r [..., 3, 3], the three
    terms summed left to right."""
    return (v[..., 0:1] * r[..., 0, :] + v[..., 1:2] * r[..., 1, :]
            + v[..., 2:3] * r[..., 2, :])


def _view_setup(tris, view_mask_tri, cam_pos, cam_rot, shadow_dir, t_pad):
    """Setup rows of every (world, view): [W, V, T_pad, PS].

    tris: [W, IT, 3] tensors; view_mask_tri [W, V, IT]; cameras
    [W, V, 3|4]; shadow_dir [3] or [W, 3] (toward the light) or None."""
    v0, e1, e2 = (tris[k][:, None] for k in ("v0", "e1", "e2"))  # [W,1,IT,3]
    r = m3.quat_to_mat3(cam_rot)[:, :, None]           # [W, V, 1, 3, 3]
    mask = view_mask_tri.to(torch.float32)[..., None]  # [W, V, IT, 1]

    cdet = m3.cross(e2, e1)
    tvec = cam_pos[:, :, None, :] - v0                 # [W, V, IT, 3]
    cu = m3.cross(e2, tvec)
    cv = m3.cross(tvec, e1)
    s = m3.dot(e2, cv)[..., None]
    # A' = R^T A as rows: the camera rotation folded into the constants
    rows = [_vec_mat(cdet, r) * mask, _vec_mat(cu, r) * mask,
            _vec_mat(cv, r) * mask, s * mask]          # 10 columns
    if shadow_dir is not None:
        sdir = shadow_dir.reshape((-1, 1, 1, 3))       # [1|W, 1, 1, 3]
        pvec = m3.cross(sdir, e2)
        det_s = m3.dot(e1, pvec)[..., None]
        sds = torch.sign(det_s)            # sign(0) = 0 disables a row
        ads = torch.abs(det_s) * mask
        qdir = m3.cross(e1, sdir)
        n_t = m3.cross(e1, e2)
        rows += [
            m3.dot(tvec, pvec)[..., None] * sds, _vec_mat(pvec * sds, r),
            m3.dot(tvec, qdir)[..., None] * sds, _vec_mat(qdir * sds, r),
            m3.dot(tvec, n_t)[..., None] * sds, _vec_mat(n_t * sds, r),
            ads, ads * SHADOW_EPS,
        ]                                              # +14 = 24
    shape = mask.shape[:3]
    setup = torch.cat([x.expand(shape + x.shape[-1:]) for x in rows], dim=-1)
    pad = (0, rck.PS - setup.shape[-1], 0, t_pad - setup.shape[2])
    return torch.nn.functional.pad(setup, pad)


def _tri_attrs(tris, lam_b, lam_s, materials, t_pad):
    """Attribute rows shared by the views of a world: [W, FA, T_pad]."""
    col = tris["col"]
    zero = torch.zeros_like(lam_b)
    if materials is not None and "uv" in tris:
        m_id = torch.clamp(tris["mat"].long(), 0,
                           materials.base_color.shape[0] - 1)
        base = materials.base_color[:, :3][m_id]
        tex = materials.tex_id.to(torch.float32)[m_id]
        uv = tris["uv"]
        uv0 = uv[..., 0:2]
        du1 = uv[..., 2:4] - uv[..., 0:2]
        du2 = uv[..., 4:6] - uv[..., 0:2]
    else:
        base = torch.zeros_like(col)
        tex = torch.full_like(lam_b, -1.0)
        uv0 = du1 = du2 = torch.zeros_like(col[..., :2])
    attrs = torch.stack(
        [lam_b, lam_s,
         base[..., 0], base[..., 1], base[..., 2], tex,
         uv0[..., 0], uv0[..., 1], du1[..., 0], du1[..., 1], du2[..., 0],
         du2[..., 1],
         col[..., 0], col[..., 1], col[..., 2],
         zero],
        dim=1,
    )                                                  # [W, FA, IT]
    return torch.nn.functional.pad(attrs, (0, t_pad - attrs.shape[-1]))


def _local_dir_grid(cfg):
    """The constant unit pixel-direction grid [8, R_pad] in raster order
    (``raycast.camera_rays`` before the rotation), numpy, and R."""
    h, w = cfg.height, cfg.width
    aspect = w / h
    half = float(np.tan(np.deg2rad(cfg.fov_deg) * 0.5))
    xs = (np.arange(w) + 0.5) / w * 2.0 - 1.0
    zs = 1.0 - (np.arange(h) + 0.5) / h * 2.0
    px = np.broadcast_to(xs[None, :], (h, w)) * half * aspect
    pz = np.broadcast_to(zs[:, None], (h, w)) * half
    d = np.stack(
        [px, np.ones_like(px), pz], axis=-1
    ).reshape(-1, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    r = d.shape[0]
    r_pad = -(-r // 128) * 128
    out = np.zeros((8, r_pad), np.float32)
    out[:3, :r] = d.T
    if r_pad > r:
        out[:3, r:] = d[0][:, None]                    # harmless pad rays
    return out, r


def _pack_atlas(materials, device):
    """[A, S, S, 3] -> ([3*S, A*S], S): rows c*S + x, columns a*S + y."""
    if materials is None:
        return torch.zeros((8, 128), dtype=torch.float32, device=device), 8
    a = materials.atlas                                # [A, S(y), S(x), 3]
    s = a.shape[1]
    packed = a.permute(3, 2, 0, 1).reshape(3 * s, a.shape[0] * s)
    return packed.contiguous(), s


def _light_rows(lights, n_hat, shadow_idx):
    """Per-triangle lambert rows (lam_base, lam_shadow, shadow_dir|None)
    of every world; ``n_hat`` [W, IT, 3] world normals, lights [W, L]."""
    lam_b = torch.zeros_like(n_hat[..., 0])
    lam_s = torch.zeros_like(lam_b)
    shadow_dir = None
    for i in range(lights.direction.shape[-2]):
        ldir = -lights.direction[:, i]                 # toward the light
        ndl = m3.dot(n_hat, ldir[:, None, :])
        lam = torch.clamp(ndl, 0.0, 1.0) * lights.intensity[:, i, None]
        lam = torch.where(lights.active[:, i, None], lam, 0.0)
        if i == shadow_idx:
            lam_s = lam_s + lam
            shadow_dir = ldir
        else:
            lam_b = lam_b + lam
    return lam_b, lam_s, shadow_dir


@functools.lru_cache(maxsize=32)
def _device_consts(cfg, device):
    """(dl [8, R_pad] on ``device``, R, the fixed light direction)."""
    dl, n_rays = _local_dir_grid(cfg)
    light = -np.array(cfg.light_dir) / np.linalg.norm(cfg.light_dir)
    return (torch.from_numpy(dl).to(device), n_rays,
            torch.tensor(light, dtype=torch.float32, device=device))


def kernel_inputs(
    cfg, blas, inst_pos, inst_rot, inst_scale, inst_obj, inst_mask,
    cam_pos, cam_rot, materials=None, lights=None,
):
    """What ``ops.raycast_cuda.raytrace`` takes for these views:
    ((setup, attrs, dl, atlas), static options, the live ray count)."""
    w, i_n = inst_pos.shape[:2]
    n_views = cam_pos.shape[1]
    t_tab = blas.tri_v0.shape[1]
    it = i_n * t_tab
    t_pad = -(-it // 8) * 8
    dev = inst_pos.device

    use_lights = lights is not None
    use_materials = (materials is not None
                     and getattr(blas, "tri_uv", None) is not None)
    _, shadow_idx = _static_lights_info(lights, bool(cfg.shadows))
    want_shadows = bool(cfg.shadows) and (
        (use_lights and shadow_idx >= 0) or not use_lights
    )
    dl, n_rays, fixed_light = _device_consts(cfg, dev)
    atlas, tex_size = _pack_atlas(materials if use_materials else None, dev)

    tris = _world_tris(blas, inst_pos, inst_rot, inst_scale, inst_obj)
    n_t = m3.cross(tris["e1"], tris["e2"])
    n_hat = n_t / torch.clamp(torch.sqrt(m3.dot(n_t, n_t))[..., None],
                              min=1e-12)
    if use_lights:
        lam_b, lam_s, sdir = _light_rows(
            lights, n_hat, shadow_idx if want_shadows else -1
        )
        if not want_shadows:
            sdir = None
    else:
        lam_b = torch.abs(m3.dot(n_hat, fixed_light))
        lam_s = torch.zeros_like(lam_b)
        sdir = fixed_light if want_shadows else None
    mask_t = torch.repeat_interleave(inst_mask, t_tab, dim=-1)  # [W, V, IT]
    attrs = _tri_attrs(tris, lam_b, lam_s,
                       materials if use_materials else None, t_pad)
    setup = _view_setup(tris, mask_t, cam_pos, cam_rot, sdir, t_pad)

    wv = w * n_views
    setup = setup.reshape(wv, t_pad, rck.PS)
    attrs = attrs[:, None].expand(w, n_views, rck.FA, t_pad).reshape(
        wv, rck.FA, t_pad)
    opts = dict(
        t_max=float(cfg.t_max), shadows=want_shadows, use_lights=use_lights,
        use_materials=use_materials, ambient=float(cfg.ambient),
        shadow_ambient=float(cfg.shadow_ambient),
        sky=tuple(cfg.sky_color), tex_size=int(tex_size),
    )
    return (setup, attrs, dl, atlas), opts, n_rays


def render_views_kernel(
    cfg, blas, inst_pos, inst_rot, inst_scale, inst_obj, inst_mask,
    cam_pos, cam_rot, materials=None, lights=None,
):
    """The kernel tier of ``render_views`` (same contract); ``inst_mask``
    is [W, V, I] and ``blas`` (MeshTables or a table with its fields)
    lies on the instances' device."""
    planes, opts, n_rays = kernel_inputs(
        cfg, blas, inst_pos, inst_rot, inst_scale, inst_obj, inst_mask,
        cam_pos, cam_rot, materials=materials, lights=lights,
    )
    out = rck.raytrace(*planes, **opts)                # [WV, PO, R_pad]
    w, n_views = cam_pos.shape[:2]
    out = out[:, :, :n_rays].reshape(w, n_views, rck.PO, cfg.height,
                                     cfg.width)
    rgb = out[:, :, rck.O_R:rck.O_B + 1].permute(0, 1, 3, 4, 2)
    depth = out[:, :, rck.O_T]
    return rgb.contiguous(), depth.contiguous()


def view_overlap_counts(obj_lo, obj_hi, inst_pos, inst_rot, inst_scale,
                        inst_obj, inst_mask, cam_pos, cam_rot, cfg):
    """[W, V] per-view frustum overlap counts: the cull tier's overflow
    signal (``render/tlas.py::cull_view_topk``), computed without tracing
    a culled set. The kernel traces the full instance list, so the count
    only informs callers (``RenderingSystem.maybe_grow_tlas``).
    ``inst_mask`` is [W, V, I]."""
    from .raycast import per_view
    from .tlas import cull_view_topk, instance_world_aabbs

    lo, hi = instance_world_aabbs(obj_lo, obj_hi, inst_pos, inst_rot,
                                  inst_scale, inst_obj)       # [W, I, 3]
    n_views = cam_pos.shape[1]
    return cull_view_topk(per_view(lo, n_views), per_view(hi, n_views),
                          inst_mask, cam_pos, cam_rot, 1, cfg.fov_deg,
                          cfg.width / cfg.height, cfg.t_max)[2]
