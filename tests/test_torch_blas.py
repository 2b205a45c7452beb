"""The port's mesh-BVH (BLAS) tier vs the JAX package's, on the CPU.

Both packages bake the same BVHs (the JAX tables are carried across with
madrona_tpu_torch.interop.blas_from_numpy, as are its materials and
lights) and trace the same numpy rays; the JAX functions are jitted.
Tolerances:
  trace_rays_blas on tests/test_blas.py's _random_rays (sphere and bumpy
    terrain): hit or miss equal for every ray; t within rtol 1e-4, atol
    1e-5 (the JAX test's own bound, tests/test_blas.py:106-107); the
    triangle equal wherever t is not a tie;
  trace_scene_blas on a scene of a textured terrain and two spheres
    (flat colours, materials, lights: directional with a shadow, a
    spotlight with a shadow and an inactive slot), with and without
    shadows: rgb within 1e-5, depth within 1e-4;
  render_views_blas with max_instances_per_view > 0 and the raycast
    kernel tier off on both sides (the culled plain tier): rgb within
    1e-5, depth within 1e-4, overlap equal.
The walkers' names: an unknown one raises, "onehot" and "wide" (without
a 4-wide collapse attached, the gather walk, as in the JAX package) give
the gather walker's pixels exactly; the walkers themselves are held
against the JAX package's in tests/test_torch_blas_walkers.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu.assets.bvh import build_mesh_bvh as j_build
from madrona_tpu.assets.importer import ImportedMaterial as JMat
from madrona_tpu.assets.importer import ImportedTexture as JTex
from madrona_tpu.render import blas as j_blas
from madrona_tpu.render import kernel as j_kernel
from madrona_tpu.render import lights as j_lights
from madrona_tpu.render import materials as j_mat
from madrona_tpu.render import raycast as j_ray
from madrona_tpu_torch.interop import (
    blas_from_numpy, lights_from_numpy, materials_from_numpy,
)
from madrona_tpu_torch.render import blas as t_blas
from madrona_tpu_torch.render import kernel as t_kernel
from madrona_tpu_torch.render import raycast as t_ray

from test_blas import _random_rays, bumpy_terrain, uv_sphere
from torch_port import jax_tree

torch.set_num_threads(1)

T_TOL = dict(rtol=1e-4, atol=1e-5)
RGB_TOL = 1e-5
DEPTH_TOL = 1e-4
T_MAX = 50.0


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("mesh", [uv_sphere, bumpy_terrain],
                         ids=["sphere", "terrain"])
def test_trace_rays_blas_matches_jax(mesh):
    blas = j_blas.bake_blas([j_build(*mesh())])
    t_tab = blas_from_numpy(jax_tree(blas), "cpu")
    o, d = _random_rays(256, seed=1)
    live = np.ones(256, bool)
    live[::17] = False
    ref = jax.jit(lambda oo, dd: j_blas.trace_rays_blas(
        blas, jnp.zeros((256,), jnp.int32), oo, dd, jnp.asarray(live),
        100.0))(jnp.asarray(o), jnp.asarray(d))
    got = t_blas.trace_rays_blas(t_tab, torch.zeros(256, dtype=torch.int32),
                                 *_t(o, d, live), 100.0)
    r_t, r_tri, r_u, r_v = (np.asarray(x) for x in ref)
    g_t, g_tri, g_u, g_v = (x.numpy() for x in got)
    assert g_tri.dtype == r_tri.dtype
    np.testing.assert_array_equal(g_tri >= 0, r_tri >= 0)
    assert 0.5 < (r_tri >= 0).mean() < 1.0 and (g_tri[~live] < 0).all()
    np.testing.assert_allclose(g_t, r_t, **T_TOL)
    # a triangle may differ only at a tie: another hit at the same t
    other = g_tri != r_tri
    assert other.mean() < 0.02
    for i in np.nonzero(other)[0]:
        assert abs(g_t[i] - r_t[i]) <= 1e-5 * max(1.0, abs(r_t[i]))
    same = ~other & (r_tri >= 0)
    np.testing.assert_allclose(g_u[same], r_u[same], rtol=0, atol=1e-4)
    np.testing.assert_allclose(g_v[same], r_v[same], rtol=0, atol=1e-4)


def _scene():
    """A textured terrain (material 2, checker) and two spheres (material
    1, a flat colour), the rays of one 16 x 16 camera above it, and the
    lights: a directional sun with a shadow, a spotlight with a shadow
    and an inactive slot."""
    sv, st = uv_sphere(12, 16)
    tv, tt = bumpy_terrain(10, span=8.0)
    suv = np.stack([np.arctan2(sv[:, 1], sv[:, 0]) / np.pi, sv[:, 2]], -1)
    blas = j_blas.bake_blas(
        [j_build(sv, st), j_build(tv, tt)],
        colors=[(0.9, 0.3, 0.2), (0.3, 0.7, 0.3)],
        uvs=[suv.astype(np.float32), (tv[:, :2] / 2.0).astype(np.float32)],
        materials=[1, 2])
    n = 8
    yy, xx = np.mgrid[0:n, 0:n]
    img = np.full((n, n, 4), 255, np.uint8)
    img[..., :3] = np.where(((yy // 2 + xx // 2) % 2)[..., None] > 0, 220, 60)
    mats = j_mat.bake_materials(
        [JMat("sphere", (0.9, 0.4, 0.3, 1.0)),
         JMat("ground", (1.0, 1.0, 1.0, 1.0), texture=0)],
        [JTex("checker", img)], tex_size=n)
    lights = jax_tree(j_lights.make_lights(1, [
        {"direction": (0.3, -0.4, -1.0), "cast_shadow": True},
        {"position": (2.0, -2.0, 4.0), "direction": (-0.3, 0.3, -1.0),
         "cutoff": 0.6, "cast_shadow": True, "intensity": 0.7},
        {"direction": (0.0, 0.0, -1.0)},
    ]))
    lights["active"] = lights["active"].copy()
    lights["active"][:, 2] = False
    inst = (np.array([[0, 0, 2.0], [1.5, 1.0, 1.6], [0, 0, 0]], np.float32),
            np.array([[1, 0, 0, 0], [np.cos(.3), 0, 0, np.sin(.3)],
                      [1, 0, 0, 0]], np.float32),
            np.array([[1, 1, 1], [.6, .8, .7], [1, 1, 1]], np.float32),
            np.array([0, 0, 1], np.int32), np.array([True, True, True]))
    cfg = j_ray.RenderConfig(width=16, height=16, t_max=T_MAX)
    o, d = j_ray.camera_rays(cfg, jnp.asarray([0.0, -6.0, 4.0]), jnp.asarray(
        [np.cos(-.4), np.sin(-.4), 0, 0], jnp.float32))
    rays = (np.asarray(o).reshape(-1, 3), np.asarray(d).reshape(-1, 3))
    return blas, mats, lights, inst, rays


@pytest.fixture(scope="module")
def scene():
    return _scene()


OPTIONS = {
    "flat_shadows": (False, False, True),
    "materials": (True, False, False),
    "materials_shadows": (True, False, True),
    "lights_shadows": (True, True, True),
}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_trace_scene_blas_matches_jax(scene, name):
    use_mats, use_lights, shadows = OPTIONS[name]
    blas, mats, lights, inst, rays = scene
    j_kw, t_kw = {}, {}
    if use_mats:
        j_kw["materials"] = mats
        t_kw["materials"] = materials_from_numpy(jax_tree(mats), "cpu")
    if use_lights:
        j_kw["lights"] = j_lights.Lights(
            **{k: jnp.asarray(v[0]) for k, v in lights.items()})
        t_kw["lights"] = lights_from_numpy(
            {k: v[0] for k, v in lights.items()}, "cpu")
    j_cfg = j_ray.RenderConfig(width=16, height=16, t_max=T_MAX,
                               shadows=shadows)
    t_cfg = t_ray.RenderConfig(width=16, height=16, t_max=T_MAX,
                               shadows=shadows)
    ref = jax.jit(lambda *a: j_blas.trace_scene_blas(j_cfg, blas, *a, **j_kw))(
        *(jnp.asarray(x) for x in inst + rays))
    t_blas_tab = blas_from_numpy(jax_tree(blas), "cpu")
    got = t_blas.trace_scene_blas(t_cfg, t_blas_tab, *_t(*inst, *rays), **t_kw)
    r_rgb, r_dep = (np.asarray(x) for x in ref)
    assert np.abs(got[1].numpy() - r_dep).max() <= DEPTH_TOL
    assert np.abs(got[0].numpy() - r_rgb).max() <= RGB_TOL
    assert 0.5 < (r_dep < T_MAX).mean() < 1.0
    if shadows:
        # the option does something here: shadows darken some hits
        flat = t_blas.trace_scene_blas(
            dataclasses.replace(t_cfg, shadows=False), t_blas_tab,
            *_t(*inst, *rays), **t_kw)[0].numpy()
        assert (np.abs(flat - r_rgb).max(axis=-1) > 0.02).mean() > 0.02


def _kernel_tier_taken(*a, **kw):
    raise AssertionError("the raycast kernel tier was taken")


def test_render_views_blas_culled_matches_jax(scene, monkeypatch):
    """The cull-then-trace plain tier (k = 2 of 4 instances, one behind
    the camera) with materials and the sun, two worlds, two views. The
    small sphere sits nearer the cameras than the terrain, so the cull
    drops the terrain from the primary rays (not from the shadow rays)
    wherever all three are in view. The scene fits the raycast kernel's
    budget, so the kernel tier is turned off on both sides
    (MADRONA_TPU_RENDER_KERNEL=0 for the JAX package, a budget of 8
    triangles for the port) and taking it fails."""
    blas, mats, lights, inst, _ = scene
    pos, rot, scale, obj, _ = inst
    w, v = 2, 2
    pos = np.concatenate([pos, [[0.0, -30.0, 1.0]]]).astype(np.float32)
    pos[1] = (1.5, -1.0, 2.5)
    rot = np.concatenate([rot, [[1, 0, 0, 0]]]).astype(np.float32)
    scale = np.concatenate([scale, [[1, 1, 1]]]).astype(np.float32)
    obj = np.array([0, 0, 1, 0], np.int32)
    rep = lambda a: np.broadcast_to(a, (w,) + a.shape).copy()  # noqa: E731
    mask = np.ones((w, v, 4), bool)
    mask[1, 1, 1] = False
    cam_pos = np.array([[[0, -6, 4.0], [3, -5, 3.0]]] * w, np.float32)
    ang = np.array([-.3, -.2])
    cam_rot = np.zeros((w, v, 4), np.float32)
    cam_rot[..., 0] = np.cos(ang / 2)
    cam_rot[..., 1] = np.sin(ang / 2)
    args = (rep(pos), rep(rot), rep(scale), rep(obj), mask, cam_pos, cam_rot)
    # the sun alone: each light is one more shadow walk to compile
    lt = {k: np.broadcast_to(a[:, :1], (w, 1) + a.shape[2:]).copy()
          for k, a in lights.items()}
    j_cfg = j_ray.RenderConfig(width=8, height=8, t_max=T_MAX, shadows=True)
    t_cfg = t_ray.RenderConfig(width=8, height=8, t_max=T_MAX, shadows=True)
    monkeypatch.setenv("MADRONA_TPU_RENDER_KERNEL", "0")
    monkeypatch.setattr(j_kernel, "render_views_kernel", _kernel_tier_taken)
    monkeypatch.setattr(t_kernel, "MAX_FLAT_TRIS", 8)
    monkeypatch.setattr(t_kernel, "render_views_kernel", _kernel_tier_taken)
    ref = jax.jit(lambda *a: j_blas.render_views_blas(
        j_cfg, blas, *a, materials=mats,
        lights=j_lights.Lights(**{k: jnp.asarray(x) for k, x in lt.items()}),
        max_instances_per_view=2))(*(jnp.asarray(x) for x in args))
    t_kw = dict(materials=materials_from_numpy(jax_tree(mats), "cpu"),
                lights=lights_from_numpy(lt, "cpu"))
    t_tab = blas_from_numpy(jax_tree(blas), "cpu")
    got = t_blas.render_views_blas(t_cfg, t_tab, *_t(*args),
                                   max_instances_per_view=2, **t_kw)
    r_rgb, r_dep, r_ov = (np.asarray(x) for x in ref)
    assert got[0].shape == r_rgb.shape == (w, v, 8, 8, 3)
    assert np.abs(got[1].numpy() - r_dep).max() <= DEPTH_TOL
    assert np.abs(got[0].numpy() - r_rgb).max() <= RGB_TOL
    np.testing.assert_array_equal(got[2].numpy(), r_ov)
    # world 1's second view (the small sphere masked) traces all of the
    # rest; elsewhere the terrain is culled and the spheres are hit
    assert r_ov.max() > 2 and (r_dep[1, 1] < T_MAX).mean() > 0.3
    assert (r_dep < T_MAX).mean() > 0.1
    # the cull shows: without it the terrain fills many more pixels
    uncut = t_blas.render_views_blas(t_cfg, t_tab, *_t(*args),
                                     max_instances_per_view=4, **t_kw)[1]
    assert (uncut.numpy() != r_dep).mean() > 0.2


def test_unported_walkers_raise(scene):
    """The walkers are all ported now: an unknown walker name raises
    ValueError, and "onehot" and "wide" give the gather walker's planes
    bit for bit."""
    blas = blas_from_numpy(jax_tree(scene[0]), "cpu")
    _, _, _, inst, rays = scene
    args = _t(*inst, *rays)
    cfg = t_ray.RenderConfig(width=16, height=16, blas_walker="no_such")
    with pytest.raises(ValueError, match="blas_walker"):
        t_blas.trace_scene_blas(cfg, blas, *args)
    ref = t_blas.trace_scene_blas(
        dataclasses.replace(cfg, blas_walker="gather"), blas, *args)
    for walker in ("onehot", "wide"):
        got = t_blas.trace_scene_blas(
            dataclasses.replace(cfg, blas_walker=walker), blas, *args)
        assert all(torch.equal(a, b) for a, b in zip(got, ref)), walker
