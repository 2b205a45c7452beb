"""The port's TLAS tier (render/tlas.py) and matmul tracer vs the JAX
package's, on the CPU, from the same numpy inputs (JAX jitted).
Tolerances:
  build_tlas (the Karras LBVH) and tlas_candidates: every field and
    every candidate equal (integers and float boxes alike);
  cull_view_topk on a scene where most instances lie outside the
    frustum and tie at -BIG: indices, valid mask and count equal;
  render_views_tlas past the raycast kernel's budget with the "mt" and
    "matmul" tracers (float32 and bfloat16), and _trace_rays_matmul
    itself: depth within 1e-4, rgb differing by more than 0.02 at under
    0.2 % of pixels (tests/test_raycast_kernel.py:92-93); overlap equal;
  view_overlap_counts (the kernel tier's overlap export) equal."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu.render import kernel as j_kernel
from madrona_tpu.render import raycast as j_ray
from madrona_tpu.render import tlas as j_tlas
from madrona_tpu_torch.render import MeshRegistry
from madrona_tpu_torch.render import kernel as t_kernel
from madrona_tpu_torch.render import raycast as t_ray
from madrona_tpu_torch.render import tlas as t_tlas

from test_tlas import _random_aabbs, _toy_scene
from torch_port import jax_tree

torch.set_num_threads(1)

DEPTH_TOL = 1e-4
PIX_TOL, PIX_FRAC = 0.02, 0.002
T_MAX = 60.0


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("n", [0, 3, 40])
def test_build_tlas_and_candidates_equal(n):
    rs = np.random.RandomState(n)
    if n:
        lo, hi, mask = _random_aabbs(rs, n, dead=n // 5)
    else:
        lo = hi = jnp.zeros((0, 3), jnp.float32)
        mask = jnp.zeros((0,), bool)
    bounds = ([-25.0] * 3, [25.0] * 3)
    ref = jax.jit(lambda a, b, m: j_tlas.build_tlas(a, b, m, *bounds))(
        lo, hi, mask)
    got = t_tlas.build_tlas(*_t(lo, hi, mask), *bounds)
    tree = jax_tree(ref)
    for f in ("node_lo", "node_hi", "left", "skip", "inst"):
        a = getattr(got, f).numpy()
        assert a.dtype == tree[f].dtype, f
        np.testing.assert_array_equal(a, tree[f], err_msg=f)
    assert got.num_leaves == ref.num_leaves

    # rays aimed at instance centres, so some see more than K
    r, k = 64, 1
    o = rs.uniform(-30, 30, (r, 3)).astype(np.float32)
    tgt = (np.asarray(lo)[rs.randint(0, max(n, 1), r)] if n
           else np.zeros((r, 3), np.float32))
    d = (tgt - o + rs.randn(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    r_c, r_n = jax.jit(lambda t, oo, dd: j_tlas.tlas_candidates(
        t, oo, dd, k, 100.0))(ref, jnp.asarray(o), jnp.asarray(d))
    g_c, g_n = t_tlas.tlas_candidates(got, *_t(o, d), k, 100.0)
    np.testing.assert_array_equal(g_c.numpy(), np.asarray(r_c))
    np.testing.assert_array_equal(g_n.numpy(), np.asarray(r_n))
    if n == 40:
        assert np.asarray(r_n).max() > k


def _scene(w=2, n_inst=24, n_views=2):
    """tests/test_tlas.py's toy scene in both packages; the second view
    looks sideways and low, so most instances lie outside its frustum."""
    rs = np.random.RandomState(7)
    j_mesh, *args = _toy_scene(rs, w, n_inst, n_views)
    reg = MeshRegistry()
    reg.add_box(0.5, color=(0.9, 0.2, 0.2))
    reg.add_box((0.3, 0.8, 0.4), color=(0.2, 0.9, 0.2))
    reg.add_quad(40.0)
    args = [np.array(a) for a in args]
    args[5][:, 1] = [8.0, -12.0, 0.6]
    args[6][:, 1] = [np.cos(-0.7), 0.0, 0.0, np.sin(-0.7)]
    args[4][1, 5] = False
    return j_mesh, reg.build(), args


def test_cull_view_topk_equal_with_ties():
    j_mesh, t_mesh, args = _scene()
    pos, rot, scale, obj, mask, cam_pos, cam_rot = args
    j_lo, j_hi = j_tlas.object_aabbs(j_mesh)
    t_lo, t_hi = t_tlas.object_aabbs(t_mesh)
    np.testing.assert_array_equal(t_lo.numpy(), np.asarray(j_lo))
    np.testing.assert_array_equal(t_hi.numpy(), np.asarray(j_hi))
    g_lo, g_hi = t_tlas.instance_world_aabbs(t_lo, t_hi, *_t(pos, rot, scale,
                                                             obj))
    seen_ties = 0
    for wi in range(pos.shape[0]):
        r_lo, r_hi = j_tlas.instance_world_aabbs(j_lo, j_hi, pos[wi], rot[wi],
                                                 scale[wi], obj[wi])
        np.testing.assert_allclose(g_lo[wi].numpy(), np.asarray(r_lo),
                                   rtol=0, atol=1e-5)
        for v in range(cam_pos.shape[1]):
            for k in (1, 6, 24):
                ref = j_tlas.cull_view_topk(
                    r_lo, r_hi, mask[wi], cam_pos[wi, v], cam_rot[wi, v], k,
                    90.0, 1.5, T_MAX)
                got = t_tlas.cull_view_topk(
                    *_t(r_lo, r_hi, mask[wi], cam_pos[wi, v],
                        cam_rot[wi, v]), k, 90.0, 1.5, T_MAX)
                for a, b in zip(got, ref):
                    np.testing.assert_array_equal(a.numpy(), np.asarray(b))
                seen_ties += int((~np.asarray(ref[1])).sum())
    assert seen_ties > 40


def _j_no_kernel(fn):
    os.environ["MADRONA_TPU_RENDER_KERNEL"] = "0"
    try:
        return fn()
    finally:
        del os.environ["MADRONA_TPU_RENDER_KERNEL"]


@pytest.mark.parametrize("tracer,dtype", [("mt", "float32"),
                                          ("matmul", "float32"),
                                          ("matmul", "bfloat16")])
def test_render_views_tlas_matches_jax(tracer, dtype, monkeypatch):
    """The culled dense tier (K = 8 of 24), the kernel tier off on both
    sides."""
    j_mesh, t_mesh, args = _scene()
    kw = dict(width=24, height=16, t_max=T_MAX, tracer=tracer, dtype=dtype)
    j_cfg = j_ray.RenderConfig(**kw)
    ref = _j_no_kernel(lambda: jax.jit(lambda *a: j_tlas.render_views_tlas(
        j_cfg, j_mesh, *a, max_instances_per_view=8))(
            *(jnp.asarray(a) for a in args)))
    monkeypatch.setattr(t_kernel, "MAX_FLAT_TRIS", 8)
    got = t_tlas.render_views_tlas(t_ray.RenderConfig(**kw), t_mesh, *_t(*args),
                                   max_instances_per_view=8)
    r_rgb, r_dep, r_ov = (np.asarray(x) for x in ref)
    assert got[0].shape == r_rgb.shape == (2, 2, 16, 24, 3)
    assert np.abs(got[1].numpy() - r_dep).max() <= DEPTH_TOL
    assert (np.abs(got[0].numpy() - r_rgb) > PIX_TOL).mean() < PIX_FRAC
    np.testing.assert_array_equal(got[2].numpy(), r_ov)
    assert r_ov.max() > 8 and 0.3 < (r_dep < T_MAX).mean() < 1.0


def test_trace_rays_matmul_matches_jax():
    """The pinhole tracer itself on one view's rays over all 24
    instances (render_views with tracer="matmul" is in
    tests/test_torch_raycast.py)."""
    j_mesh, t_mesh, args = _scene()
    pos, rot, scale, obj, mask, cam_pos, cam_rot = args
    cfg = j_ray.RenderConfig(width=24, height=16, t_max=T_MAX)
    _, d = j_ray.camera_rays(cfg, jnp.asarray(cam_pos[0, 0]),
                             jnp.asarray(cam_rot[0, 0]))
    d = np.asarray(d).reshape(-1, 3)
    inst = (pos[0], rot[0], scale[0], obj[0], mask[0])
    ref = jax.jit(lambda *a: j_ray._trace_rays_matmul(cfg, j_mesh, *a))(
        *(jnp.asarray(x) for x in inst + (cam_pos[0, 0], d)))
    got = t_ray._trace_rays_matmul(
        t_ray.RenderConfig(width=24, height=16, t_max=T_MAX), t_mesh,
        *_t(*inst, cam_pos[0, 0], d))
    assert np.abs(got[1].numpy() - np.asarray(ref[1])).max() <= DEPTH_TOL
    assert (np.abs(got[0].numpy() - np.asarray(ref[0])) > PIX_TOL).mean() \
        < PIX_FRAC


def test_view_overlap_counts_equal():
    """The kernel tier's overlap export (render_views_tlas inside the
    budget) and view_overlap_counts itself."""
    j_mesh, t_mesh, args = _scene()
    cfg = j_ray.RenderConfig(width=24, height=16, t_max=T_MAX)
    t_cfg = t_ray.RenderConfig(width=24, height=16, t_max=T_MAX)
    j_lo, j_hi = j_tlas.object_aabbs(j_mesh)
    args[4] = np.repeat(args[4][:, None], 2, axis=1)       # [W, V, I]
    args[4][0, 1, 3] = False
    j_args = [jnp.asarray(a) for a in args]
    ref = jax.jit(lambda *a: j_kernel.view_overlap_counts(
        j_lo, j_hi, *a, cfg))(*j_args)
    got = t_kernel.view_overlap_counts(*t_tlas.object_aabbs(t_mesh),
                                       *_t(*args), t_cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    _, _, ov = t_tlas.render_views_tlas(t_cfg, t_mesh, *_t(*args),
                                        max_instances_per_view=8)
    np.testing.assert_array_equal(ov.numpy(), np.asarray(ref))
    assert got.dtype == torch.int32 and np.asarray(ref).min() < 10
