"""The port's BLAS walkers vs the JAX package's (tests/test_blas.py's
cases: the 4-wide walker in float32 and bfloat16 boxes, the single-leaf
object, the wiring through the scene, _bf16_outward, the one-hot walker),
and the walker choice, the MADRONA_TPU_BLAS_WIDE knob and
RenderConfig.ray_chunk. Both packages bake the same BVHs (the JAX tables
carried across with blas_from_numpy / blas4_from_numpy) and trace the
same numpy rays; the JAX functions are jitted. Tolerances:
- widen_blas: every table equal to the JAX package's bit for bit (the
  bfloat16 boxes too);
- the 4-wide walker against the JAX package's 4-wide walker and against
  the port's binary walker: hit or miss equal for every ray, t within
  rtol 1e-4, atol 1e-5 (tests/test_torch_blas.py's bound, the JAX
  test's own), the triangle equal wherever t is not a tie; dead lanes
  miss; on the JAX package's own wide tables carried across the same
  hits as on the port's (equal bit for bit);
- trace_scene_blas with the wide tables attached: depth within 1e-4,
  rgb within 1e-5 of the JAX package's and of the port's binary walk;
- _bf16_outward: equal to the JAX package's bit for bit on
  tests/test_blas.py's values (denormals, -0.0, infinities), lo_q <= lo
  and hi_q >= hi;
- the one-hot walker: equal to the port's gather walker bit for bit (t,
  tri, u, v), and to the JAX package's one-hot walker within the
  gather walker's bounds above;
- "auto" walks the wide tables where attached, else the gather walker;
  the knob attaches them in float32 or bfloat16 to Hide & Seek's BLAS
  tier;
- ray_chunk: the plain tier's planes for chunks of 16 and 32 rays equal
  the default's bit for bit and the JAX package's with the same chunk
  within 1e-5 (rgb) and 1e-4 (depth); a chunk that does not divide the
  rays of a view raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu.assets.bvh import build_mesh_bvh as j_build
from madrona_tpu.render import blas as j_blas
from madrona_tpu.render import kernel as j_kernel
from madrona_tpu.render import raycast as j_ray
from madrona_tpu_torch.interop import blas4_from_numpy, blas_from_numpy
from madrona_tpu_torch.render import blas as t_blas
from madrona_tpu_torch.render import kernel as t_kernel
from madrona_tpu_torch.render import raycast as t_ray

from test_blas import _random_rays, bumpy_terrain, uv_sphere
from torch_port import jax_tree

torch.set_num_threads(1)

T_TOL = dict(rtol=1e-4, atol=1e-5)
RGB_TOL = 1e-5
DEPTH_TOL = 1e-4


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _same_hits(got, ref):
    """Hit or miss equal, t within T_TOL, the triangle equal but at a
    tie (another hit at the same t)."""
    g_t, g_tri = (np.asarray(x) for x in got[:2])
    r_t, r_tri = (np.asarray(x) for x in ref[:2])
    np.testing.assert_array_equal(g_tri >= 0, r_tri >= 0)
    np.testing.assert_allclose(g_t, r_t, **T_TOL)
    other = g_tri != r_tri
    assert other.mean() < 0.02
    for i in np.nonzero(other)[0]:
        assert abs(g_t[i] - r_t[i]) <= 1e-5 * max(1.0, abs(r_t[i]))


@pytest.fixture(scope="module")
def objects():
    """Two objects (the sphere and the bumpy terrain) baked by the JAX
    package, the port's tables from them, and 512 rays over both."""
    blas = j_blas.bake_blas([j_build(*uv_sphere()), j_build(*bumpy_terrain())])
    o, d = _random_rays(512, seed=3)
    obj = (np.arange(512) % 2).astype(np.int32)
    return blas, blas_from_numpy(jax_tree(blas), "cpu"), (obj, o, d)


@pytest.mark.parametrize("aabb_dtype", ["float32", "bfloat16"])
def test_wide4_walker_matches_jax(objects, aabb_dtype):
    j_tab, t_tab, (obj, o, d) = objects
    live = np.ones(512, bool)
    j_w4 = j_blas.widen_blas(j_tab, aabb_dtype=aabb_dtype)
    t_w4 = t_blas.widen_blas(t_tab, aabb_dtype=aabb_dtype)
    ref4 = jax_tree(j_w4)
    for f in ("c_min", "c_max"):
        g = getattr(t_w4, f)
        assert g.dtype == (torch.bfloat16 if aabb_dtype == "bfloat16"
                           else torch.float32)
        np.testing.assert_array_equal(g.float().numpy(),
                                      ref4[f].astype(np.float32))
    for f in ("c_entry", "leaf_first", "leaf_count"):
        np.testing.assert_array_equal(getattr(t_w4, f).numpy(), ref4[f])
    assert t_w4.max_leaf == j_w4.max_leaf

    ref = jax.jit(lambda a, b: j_blas.trace_rays_blas4(
        j_w4, jnp.asarray(obj), a, b, jnp.asarray(live), 100.0))(
            jnp.asarray(o), jnp.asarray(d))
    args = (torch.from_numpy(obj), *_t(o, d, live), 100.0)
    got = t_blas.trace_rays_blas4(t_w4, *args)
    _same_hits(got, ref)
    _same_hits(got, t_blas.trace_rays_blas(t_tab, *args))
    assert 0.3 < (got[1] >= 0).float().mean() < 1.0
    carried = t_blas.trace_rays_blas4(blas4_from_numpy(ref4, "cpu"), *args)
    assert all(torch.equal(a, b) for a, b in zip(carried, got))

    # dead lanes stay missed
    t_w, tri_w, _, _ = t_blas.trace_rays_blas4(
        t_w4, torch.zeros(8, dtype=torch.int32), torch.zeros(8, 3),
        torch.ones(8, 3), torch.zeros(8, dtype=torch.bool), 100.0)
    assert (tri_w == -1).all() and (t_w == 100.0).all()


def test_wide4_single_leaf_object():
    v = np.asarray([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    blas = j_blas.bake_blas([j_build(v, np.asarray([[0, 1, 2]], np.int32))])
    t_w4 = t_blas.widen_blas(blas_from_numpy(jax_tree(blas), "cpu"))
    assert t_w4.c_entry.shape[1] == 1 and int(t_w4.c_entry[0, 0, 0]) == -1
    tt, tri, _, _ = t_blas.trace_rays_blas4(
        t_w4, torch.zeros(2, dtype=torch.int32),
        torch.tensor([[0.0, 0.0, 5.0], [3.0, 3.0, 5.0]]),
        torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]]),
        torch.ones(2, dtype=torch.bool), 100.0)
    assert int(tri[0]) == 0 and int(tri[1]) == -1
    np.testing.assert_allclose(float(tt[0]), 5.0, rtol=1e-5)


def _scene_args():
    inst = (np.asarray([[0.0, 0, 1.5], [0, 0, 0]], np.float32),
            np.asarray([[1.0, 0, 0, 0]] * 2, np.float32),
            np.ones((2, 3), np.float32), np.asarray([0, 1], np.int32),
            np.ones((2,), bool))
    o, d = _random_rays(128, seed=9, r0=6.0)
    return inst + (o, d)


def test_wide4_plumbing_through_scene():
    blas = j_blas.bake_blas([j_build(*uv_sphere()), j_build(*bumpy_terrain())],
                            colors=[(0.8, 0.2, 0.2), (0.2, 0.8, 0.2)])
    args = _scene_args()
    j_cfg = j_ray.RenderConfig(width=8, height=8, t_max=100.0)
    t_cfg = t_ray.RenderConfig(width=8, height=8, t_max=100.0)
    ref = jax.jit(lambda *a: j_blas.trace_scene_blas(
        j_cfg, j_blas.with_wide(blas), *a))(*(jnp.asarray(x) for x in args))
    t_tab = blas_from_numpy(jax_tree(blas), "cpu")
    wide = t_blas.with_wide(t_tab)
    assert wide.wide is not None and t_tab.wide is None
    got = t_blas.trace_scene_blas(t_cfg, wide, *_t(*args))
    binary = t_blas.trace_scene_blas(t_cfg, t_tab, *_t(*args))
    for other in (ref, binary):
        assert np.abs(got[1].numpy() - np.asarray(other[1])).max() \
            <= DEPTH_TOL
        assert np.abs(got[0].numpy() - np.asarray(other[0])).max() <= RGB_TOL
    assert (got[1].numpy() < 100.0).mean() > 0.3


def test_bf16_outward_matches_jax():
    rs = np.random.RandomState(11)
    vals = np.concatenate([
        rs.uniform(-100, 100, 256).astype(np.float32),
        rs.uniform(-1e-38, 1e-38, 64).astype(np.float32),   # denormals
        np.asarray([0.0, -0.0, -5e-41, 5e-41, 1e-30, -1e-30, 3.4e38,
                    -3.4e38, np.inf, -np.inf], np.float32),
    ])
    lo = vals.copy()
    hi = (vals + np.abs(rs.uniform(0, 1, vals.shape))).astype(np.float32)
    shape = lambda a: a.reshape(-1, 1, 1, 1).repeat(3, -1)  # noqa: E731
    r_lo, r_hi = j_blas._bf16_outward(shape(lo), shape(hi))
    g_lo, g_hi = t_blas._bf16_outward(torch.from_numpy(shape(lo)),
                                      torch.from_numpy(shape(hi)))
    np.testing.assert_array_equal(g_lo.numpy().view(np.uint32),
                                  np.asarray(r_lo).view(np.uint32))
    np.testing.assert_array_equal(g_hi.numpy().view(np.uint32),
                                  np.asarray(r_hi).view(np.uint32))
    g_lo, g_hi = g_lo.numpy()[..., 0].ravel(), g_hi.numpy()[..., 0].ravel()
    fin = np.isfinite(lo)
    assert (g_lo[fin] <= lo[fin]).all()
    # no bound of modest size explodes (a sign-naive step below -0.0)
    small = np.abs(lo) < 1e30
    assert (np.abs(g_lo[small]) < 1e30).all()
    assert (g_hi[np.isfinite(hi)] >= hi[np.isfinite(hi)]).all()
    # bfloat16 values exactly: the low 16 bits are zero
    assert not (g_lo.view(np.uint32) & 0xFFFF).any()
    assert not (g_hi.view(np.uint32) & 0xFFFF).any()


def test_onehot_walker_matches_gather_and_jax(objects):
    j_tab, t_tab, _ = objects
    rs = np.random.RandomState(5)
    b = 256
    obj = rs.randint(0, 2, b).astype(np.int32)
    o = (rs.uniform(-3, 3, (b, 3)) + [0, 0, 4]).astype(np.float32)
    d = rs.randn(b, 3).astype(np.float32)
    d[:, 2] -= 1.5
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    live = rs.rand(b) < 0.9
    ref = jax.jit(lambda *a: j_blas.trace_rays_blas_onehot(j_tab, *a, 50.0))(
        *(jnp.asarray(x) for x in (obj, o, d, live)))
    args = (*_t(obj, o, d, live), 50.0)
    got = t_blas.trace_rays_blas_onehot(t_tab, *args)
    gather = t_blas.trace_rays_blas(t_tab, *args)
    assert all(torch.equal(a, b) for a, b in zip(got, gather))
    _same_hits(got, ref)
    assert 0.2 < (got[1] >= 0).float().mean() < 1.0


def test_auto_walker_and_wide_knob(objects, monkeypatch):
    _, t_tab, _ = objects
    args = _t(*_scene_args())
    cfg = t_ray.RenderConfig(width=8, height=8, t_max=100.0)
    calls = []
    for name in ("trace_rays_blas", "trace_rays_blas4",
                 "trace_rays_blas_onehot"):
        real = getattr(t_blas, name)
        monkeypatch.setattr(t_blas, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    wide = t_blas.with_wide(t_tab)
    for walker, tab, want in (("auto", t_tab, "trace_rays_blas"),
                              ("auto", wide, "trace_rays_blas4"),
                              ("wide", t_tab, "trace_rays_blas"),
                              ("onehot", wide, "trace_rays_blas_onehot"),
                              ("gather", wide, "trace_rays_blas")):
        calls.clear()
        t_blas.trace_scene_blas(dataclasses.replace(cfg, blas_walker=walker),
                                tab, *args)
        assert calls and set(calls) == {want}, (walker, calls)

    from madrona_tpu_torch.models.hide_seek import HideSeek

    for knob, dtype in (("1", torch.float32), ("bf16", torch.bfloat16)):
        monkeypatch.setenv("MADRONA_TPU_BLAS_WIDE", knob)
        env = HideSeek(render_size=8, render_tier="blas")
        w4 = env.rsys.blas.wide
        assert w4 is not None and w4.c_min.dtype == dtype
        moved = env.rsys._const(torch.device("cpu"))["blas"]
        assert moved.wide is not None and moved.wide.c_min.dtype == dtype
    monkeypatch.delenv("MADRONA_TPU_BLAS_WIDE")
    assert HideSeek(render_size=8, render_tier="blas").rsys.blas.wide is None


def _kernel_tier_taken(*a, **kw):
    raise AssertionError("the raycast kernel tier was taken")


def test_ray_chunk(objects, monkeypatch):
    """The plain tier (the kernel tier off on both sides) of one world,
    two views of 8 x 8 rays."""
    j_tab, t_tab, _ = objects
    inst = [np.asarray(x)[None] for x in _scene_args()[:5]]
    mask = np.ones((1, 2, 2), bool)
    cam_pos = np.asarray([[[0, -6, 2.0], [4, -4, 3.0]]], np.float32)
    ang = np.asarray([[0.0, 0.7]])
    cam_rot = np.zeros((1, 2, 4), np.float32)
    cam_rot[..., 0] = np.cos(ang / 2)
    cam_rot[..., 3] = np.sin(ang / 2)
    args = (*inst[:4], mask, cam_pos, cam_rot)
    monkeypatch.setenv("MADRONA_TPU_RENDER_KERNEL", "0")
    monkeypatch.setattr(j_kernel, "render_views_kernel", _kernel_tier_taken)
    monkeypatch.setattr(t_kernel, "MAX_FLAT_TRIS", 0)
    monkeypatch.setattr(t_kernel, "render_views_kernel", _kernel_tier_taken)
    cfg = t_ray.RenderConfig(width=8, height=8, t_max=100.0)
    default = t_blas.render_views_blas(cfg, t_tab, *_t(*args))
    assert (default[1].numpy() < 100.0).mean() > 0.2
    for chunk in (16, 32):
        got = t_blas.render_views_blas(
            dataclasses.replace(cfg, ray_chunk=chunk), t_tab, *_t(*args))
        assert all(torch.equal(a, b) for a, b in zip(got, default))
    ref = jax.jit(lambda *a: j_blas.render_views_blas(
        j_ray.RenderConfig(width=8, height=8, t_max=100.0, ray_chunk=16),
        j_tab, *a))(*(jnp.asarray(x) for x in args))
    assert np.abs(default[1].numpy() - np.asarray(ref[1])).max() <= DEPTH_TOL
    assert np.abs(default[0].numpy() - np.asarray(ref[0])).max() <= RGB_TOL
    with pytest.raises(ValueError, match="ray_chunk 24"):
        t_blas.render_views_blas(dataclasses.replace(cfg, ray_chunk=24),
                                 t_tab, *_t(*args))
