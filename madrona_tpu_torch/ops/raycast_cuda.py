"""Raycast on its hand-written CUDA kernel (``csrc/raycast.cu``).

The counterpart of the JAX package's ``ops/raycast_pallas.make_raytrace``
with its arrays, planes and static options: the whole per-view render of
a flat triangle list (``render/kernel.py`` builds the arrays).

    setup [WV, T_pad, PS]   per-(world, view) triangle rows, PS = 24:
        0:3 A | 3:6 B | 6:9 C | 9 s       primary Möller–Trumbore, pinhole-
            factorised: det = d.A, u*det = d.B, v*det = d.C, t*det = s with
            d the view-local pixel direction
        10 cu | 11:14 Pu | 14 cv | 15:18 Pv | 18 ct | 19:22 Pt
            the directional shadow test, affine in the primary hit
            distance: X = c + t_best * (P . d), folded by sign(det_s)
        22 |det_s| (0 disables the row) | 23 eps * |det_s|
    attrs [WV, FA, T_pad]   FA = 16: lam_base, lam_shadow, base rgb,
        tex_id (-1 = untextured), uv0 xy, duv1 xy, duv2 xy, flat rgb, pad
    dl    [8, R_pad]        rows 0:3 the unit pixel directions, view-local
    atlas [3*S, A*S]        texel (layer a, row y, column x, channel c) at
        [c*S + x, a*S + y]
    out   [WV, PO, R_pad]   PO = 8: r, g, b, depth, occ, u, v, pad

Dead triangles (pad rows, masked instances) carry all-zero setup rows
and fail by ``|det| > eps_det`` and ``t > t_min`` alone. The nearest hit
is the lowest triangle index among the hits at the least t. All float32.

For a CPU tensor :func:`raytrace` runs the plain version
(:func:`raytrace_plain`); for a CUDA tensor it launches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel, check_tensor, stream_ptr

PS = 24        # setup columns
FA = 16        # attribute rows
PO = 8         # output planes

# output plane indices (shared with render/kernel.py)
O_R, O_G, O_B, O_T, O_OCC, O_U, O_V = 0, 1, 2, 3, 4, 5, 6

# attribute row indices
A_LAMB, A_LAMS = 0, 1
A_BR, A_BG, A_BB, A_TEX = 2, 3, 4, 5
A_UV0X, A_UV0Y, A_DU1X, A_DU1Y, A_DU2X, A_DU2Y = 6, 7, 8, 9, 10, 11
A_FR, A_FG, A_FB = 12, 13, 14

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
KERNEL = CudaKernel(
    "raycast.cu", "raycast_launch",
    [_P] * 5 + [_I] * 9 + [_F] * 3 + [ctypes.c_double] * 2 + [_F] * 3 + [_P],
)

# elements of one [chunk, T, R] temporary of the plain version
PLAIN_CHUNK_ELEMS = 1 << 25

# the static options of make_raytrace (t_max has no default)
DEFAULT_OPTIONS = dict(
    shadows=True, use_lights=False, use_materials=False, ambient=0.35,
    shadow_ambient=0.25, sky=(0.1, 0.2, 0.4), tex_size=64, t_min=1e-3,
    eps_det=1e-9,
)


def _options(opts):
    """``opts`` over the defaults; an unknown or missing name raises."""
    unknown = set(opts) - set(DEFAULT_OPTIONS) - {"t_max"}
    if unknown or "t_max" not in opts:
        raise TypeError(f"raytrace options: unknown {sorted(unknown)}, "
                        f"t_max given: {'t_max' in opts}")
    return {**DEFAULT_OPTIONS, **opts}


def _sample_atlas_plain(atlas, tex_id, uvx, uvy, s):
    """Bilinear GL_REPEAT fetch for [B, R] uv planes; three [B, R]
    channels (1.0 where tex_id < 0)."""
    n_cols = atlas.shape[1]
    x = (uvx - torch.floor(uvx)) * s - 0.5
    y = (1.0 - (uvy - torch.floor(uvy))) * s - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0

    def wrap(v):
        return v - s * torch.floor(v / s)

    base = torch.clamp(tex_id, min=0.0) * s
    rows = [wrap(y0) + base, wrap(y0 + 1.0) + base]
    cols = [wrap(x0), wrap(x0 + 1.0)]
    wts = [(1 - fx) * (1 - fy), fx * (1 - fy), (1 - fx) * fy, fx * fy]
    out = [None, None, None]
    for yi, yrow in enumerate(rows):
        for xi, xcol in enumerate(cols):
            w = wts[yi * 2 + xi]
            # a texel outside the table (a tex id past the atlas) is 0
            inside = ((yrow >= 0) & (yrow < n_cols)
                      & (xcol >= 0) & (xcol < s))
            yl = torch.where(inside, yrow, 0.0).long()
            xl = torch.where(inside, xcol, 0.0).long()
            for c in range(3):
                v = torch.where(inside, atlas[c * s + xl, yl], 0.0)
                out[c] = v * w if out[c] is None else out[c] + v * w
    untex = tex_id < 0.0
    return tuple(torch.where(untex, 1.0, out[c]) for c in range(3))


def raytrace_plain(setup, attrs, dl, atlas, **opts):
    """The plain version: the same function in tensor ops, on [T, R]
    planes, in chunks of (world, view). Options as :func:`raytrace`."""
    opts = _options(opts)
    wv, t_pad, _ = setup.shape
    r_pad = dl.shape[1]
    out = torch.empty((wv, PO, r_pad), dtype=torch.float32,
                      device=setup.device)
    chunk = max(1, PLAIN_CHUNK_ELEMS // max(1, t_pad * r_pad))
    for lo in range(0, wv, chunk):
        out[lo:lo + chunk] = _raytrace_chunk(
            setup[lo:lo + chunk], attrs[lo:lo + chunk], dl, atlas, **opts)
    return out


def _raytrace_chunk(setup, attrs, dl, atlas, *, t_max, t_min, eps_det,
                    shadows, use_lights, use_materials, ambient,
                    shadow_ambient, sky, tex_size):
    t_pad = setup.shape[1]
    dlx, dly, dlz = dl[0], dl[1], dl[2]                 # [R]

    def col(p):                                         # [B, T, 1]
        return setup[:, :, p:p + 1]

    def dot_d(p):                                       # [B, T, R]
        return col(p) * dlx + col(p + 1) * dly + col(p + 2) * dlz

    det = dot_d(0)
    uu = dot_d(3)
    vv = dot_d(6)
    ad = torch.abs(det)
    sd = torch.sign(det)
    pu = uu * sd
    pv = vv * sd
    inv = torch.where(ad > eps_det, 1.0 / det, 0.0)
    t = col(9) * inv
    hit = (
        (ad > eps_det) & (pu >= 0.0) & (pv >= 0.0) & (pu + pv <= ad)
        & (t > t_min) & (t < t_max)
    )
    t_hit = torch.where(hit, t, t_max)
    t_best = t_hit.amin(dim=1)                          # [B, R]

    # the winner: lowest triangle index among the hits at the least t
    idx = torch.arange(t_pad, device=setup.device)[:, None]
    is_min = hit & (t_hit <= t_best[:, None, :])
    win = torch.where(is_min, idx, t_pad).amin(dim=1)   # [B, R]
    hit_any = t_best < t_max
    win_c = torch.clamp(win, max=t_pad - 1)
    # its attribute rows (zero without a hit)
    fetched = torch.gather(
        attrs, 2, win_c[:, None, :].expand(-1, FA, -1)
    ) * (win < t_pad)[:, None, :]                       # [B, FA, R]

    def frow(k):
        return fetched[:, k]

    if use_materials:
        at_win = win_c[:, None, :]
        live = win < t_pad
        u_win = torch.gather(uu * inv, 1, at_win)[:, 0] * live
        v_win = torch.gather(vv * inv, 1, at_win)[:, 0] * live
    else:
        u_win = v_win = torch.zeros_like(t_best)

    if shadows:
        tb = t_best[:, None, :]
        pu_s = col(10) + tb * dot_d(11)
        pv_s = col(14) + tb * dot_d(15)
        ts_s = col(18) + tb * dot_d(19)
        ads = col(22)
        s_hit = (
            (ads > eps_det) & (pu_s >= 0.0) & (pv_s >= 0.0)
            & (pu_s + pv_s <= ads) & (ts_s > col(23))
        )
        occ = s_hit.any(dim=1).to(torch.float32)
    else:
        occ = torch.zeros_like(t_best)

    if use_materials:
        uvx = (frow(A_UV0X) + u_win * frow(A_DU1X)) + v_win * frow(A_DU2X)
        uvy = (frow(A_UV0Y) + u_win * frow(A_DU1Y)) + v_win * frow(A_DU2Y)
        tex = _sample_atlas_plain(atlas, frow(A_TEX), uvx, uvy, tex_size)
        alb = (frow(A_BR) * tex[0], frow(A_BG) * tex[1],
               frow(A_BB) * tex[2])
    else:
        alb = (frow(A_FR), frow(A_FG), frow(A_FB))

    lam_b = frow(A_LAMB)
    lam_s = frow(A_LAMS)
    occf = occ * hit_any.to(torch.float32)
    if use_lights:
        # shade = max(ambient floor, sum of the lights), clamped
        shade = torch.clamp(lam_b + lam_s * (1.0 - occf), min=ambient)
        rgb = [torch.clamp(a * shade, 0.0, 1.0) for a in alb]
    else:
        # one fixed light: |n.l| lambert, no clamp
        scale = 1.0 - occf * (1.0 - shadow_ambient)
        shade = ambient + (1.0 - ambient) * lam_b * scale
        rgb = [a * shade for a in alb]
    rgb = [torch.where(hit_any, rgb[c], float(sky[c])) for c in range(3)]
    return torch.stack(
        [rgb[0], rgb[1], rgb[2], t_best, occf, u_win, v_win,
         torch.zeros_like(t_best)], dim=1,
    )


def raytrace(setup, attrs, dl, atlas, **opts):
    """out [WV, PO, R_pad] of the four arrays (see the module doc): the
    kernel on CUDA, the plain version on a CPU tensor. Options: ``t_max``
    and any of ``DEFAULT_OPTIONS``."""
    if setup.device.type == "cpu":
        return raytrace_plain(setup, attrs, dl, atlas, **opts)
    return _launch(setup, attrs, dl, atlas, **_options(opts))


def _launch(setup, attrs, dl, atlas, *, t_max, shadows, use_lights,
            use_materials, ambient, shadow_ambient, sky, tex_size, t_min,
            eps_det):
    wv, t_pad, _ = setup.shape
    r_pad = dl.shape[1]
    a_rows, a_cols = atlas.shape
    f32 = torch.float32
    check_tensor(setup, "setup", f32, (wv, t_pad, PS))
    check_tensor(attrs, "attrs", f32, (wv, FA, t_pad))
    check_tensor(dl, "dl", f32, (8, r_pad))
    check_tensor(atlas, "atlas", f32, (a_rows, a_cols))
    if use_materials and a_rows != 3 * tex_size:
        raise ValueError(
            f"atlas has {a_rows} rows, expected 3 * tex_size = {3 * tex_size}"
        )
    out = torch.empty((wv, PO, r_pad), dtype=f32, device=setup.device)
    KERNEL.launch(
        setup.data_ptr(), attrs.data_ptr(), dl.data_ptr(), atlas.data_ptr(),
        out.data_ptr(),
        wv, t_pad, r_pad, a_rows, a_cols, int(tex_size),
        int(bool(shadows)), int(bool(use_lights)), int(bool(use_materials)),
        float(t_max), float(t_min), float(eps_det), float(ambient),
        float(shadow_ambient), float(sky[0]), float(sky[1]), float(sky[2]),
        stream_ptr(),
    )
    return out
