"""The port's raycast glue and dense tracer vs the JAX package, on the CPU.

(a) the port's ``render_views_kernel`` glue against the JAX one on a
    random scene of tests/test_raycast_kernel.py::_scene's kind built
    from ``MeshRegistry.build()``: setup and attribute planes within 1e-5
    of each plane's largest magnitude (the rows hold products of world
    coordinates of the order of 1e4, where one float32 rounding is
    1e-3), final depth within 1e-3, rgb differing by more than 0.02 at
    under 0.2 % of pixels (the JAX test's own bounds,
    tests/test_raycast_kernel.py:92-93). Three cases: flat colours,
    shadows, and materials + lights + shadows (the tables read by field
    name on both sides).
(b) the port's dense tracer ``_trace_rays`` against the JAX one on the
    same kind of scene, float32: depth within 1e-4, rgb differing by more
    than 0.02 at under 0.2 % of pixels.
The kernel's plain version against the Pallas kernel is in
tests/test_torch_raycast.py.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu.render import MeshRegistry as JMeshRegistry
from madrona_tpu.render import RenderConfig as JRenderConfig
from madrona_tpu.render import kernel as j_kernel
from madrona_tpu.render import raycast as j_raycast
from madrona_tpu.render.lights import make_lights as j_make_lights
from madrona_tpu_torch.ops import raycast_cuda as rck
from madrona_tpu_torch.render import MeshRegistry, RenderConfig
from madrona_tpu_torch.render import kernel as t_kernel
from madrona_tpu_torch.render import raycast as t_raycast

from torch_port import raycast_scene

torch.set_num_threads(1)

TEX = 8


def _materials(seed, n_obj, n_tri):
    """Per-triangle uvs and material ids for the mesh tables, and a small
    material table, read by field name on both sides."""
    rs = np.random.RandomState(seed)
    tri_uv = rs.uniform(0, 3, (n_obj, n_tri, 3, 2)).astype(np.float32)
    tri_mat = rs.randint(0, 3, (n_obj, n_tri)).astype(np.int32)
    base = rs.uniform(0.2, 1.0, (3, 4)).astype(np.float32)
    tex_id = np.array([-1, 0, 1], np.int32)
    atlas = rs.rand(2, TEX, TEX, 3).astype(np.float32)
    return tri_uv, tri_mat, base, tex_id, atlas


LIGHT_SPECS = [
    {"direction": (0.4, -0.2, -1.0), "cast_shadow": True},
    {"direction": (-0.5, 0.5, -0.5)},
]

GLUE_CASES = {
    "flat": dict(shadows=False, lights=False, materials=False),
    "shadows": dict(shadows=True, lights=False, materials=False),
    "materials_lights_shadows": dict(shadows=True, lights=True,
                                     materials=True),
}


@pytest.mark.parametrize("name", list(GLUE_CASES))
def test_glue_matches_jax(name, monkeypatch):
    case = GLUE_CASES[name]
    seed = list(GLUE_CASES).index(name)
    kw = dict(width=24, height=16, fov_deg=85.0, t_max=60.0,
              shadows=case["shadows"])
    j_mesh, args = raycast_scene(JMeshRegistry, seed)
    t_mesh, _ = raycast_scene(MeshRegistry, seed)
    w = args[0].shape[0]
    j_extra, t_extra = {}, {}
    if case["materials"]:
        n_obj, n_tri = t_mesh.tri_v0.shape[:2]
        tri_uv, tri_mat, base, tex_id, atlas = _materials(seed, n_obj, n_tri)
        j_mesh = types.SimpleNamespace(
            **{f.name: getattr(j_mesh, f.name)
               for f in dataclasses.fields(j_mesh)},
            tri_uv=jnp.asarray(tri_uv), tri_mat=jnp.asarray(tri_mat))
        t_mesh = types.SimpleNamespace(
            **{f.name: getattr(t_mesh, f.name)
               for f in dataclasses.fields(t_mesh)},
            tri_uv=torch.from_numpy(tri_uv), tri_mat=torch.from_numpy(tri_mat))
        j_extra["materials"] = types.SimpleNamespace(
            base_color=jnp.asarray(base), tex_id=jnp.asarray(tex_id),
            atlas=jnp.asarray(atlas))
        t_extra["materials"] = types.SimpleNamespace(
            base_color=torch.from_numpy(base),
            tex_id=torch.from_numpy(tex_id), atlas=torch.from_numpy(atlas))
    if case["lights"]:
        lights = j_make_lights(w, LIGHT_SPECS)
        j_extra["lights"] = lights
        t_extra["lights"] = types.SimpleNamespace(**{
            f.name: torch.from_numpy(np.array(getattr(lights, f.name)))
            for f in dataclasses.fields(lights)})

    # the planes each side hands to its kernel
    seen = {}
    j_make = j_kernel.make_trace_cached

    def j_spy(*a):
        fn = j_make(*a)

        def run(setup, attrs, dl, atlas):
            seen["jax"] = [np.asarray(x) for x in (setup, attrs, dl, atlas)]
            return fn(setup, attrs, dl, atlas)
        return run

    t_trace = rck.raytrace

    def t_spy(setup, attrs, dl, atlas, **opts):
        seen["torch"] = [x.numpy() for x in (setup, attrs, dl, atlas)]
        seen["opts"] = opts
        return t_trace(setup, attrs, dl, atlas, **opts)

    monkeypatch.setattr(j_kernel, "make_trace_cached", j_spy)
    monkeypatch.setattr(rck, "raytrace", t_spy)
    j_rgb, j_dep = j_kernel.render_views_kernel(
        JRenderConfig(**kw), j_mesh, *(jnp.asarray(a) for a in args),
        interpret=True, **j_extra)
    t_rgb, t_dep = t_kernel.render_views_kernel(
        RenderConfig(**kw), t_mesh, *(torch.from_numpy(a) for a in args),
        **t_extra)

    assert seen["opts"]["shadows"] == case["shadows"]
    assert seen["opts"]["use_lights"] == case["lights"]
    assert seen["opts"]["use_materials"] == case["materials"]
    for k, (got, ref) in enumerate(zip(seen["torch"], seen["jax"])):
        assert got.shape == ref.shape, k
        # per plane (setup column / attribute row), relative to its size
        axis = (0, 1) if k == 0 else (0, 2) if k == 1 else None
        scale = np.maximum(1.0, np.abs(ref).max(axis=axis, keepdims=True))
        assert (np.abs(got - ref) / scale).max() <= 1e-5, k
    j_rgb, j_dep = np.asarray(j_rgb), np.asarray(j_dep)
    assert t_rgb.shape == j_rgb.shape == (w, 2, 16, 24, 3)
    assert np.abs(t_dep.numpy() - j_dep).max() < 1e-3
    assert (np.abs(t_rgb.numpy() - j_rgb) > 0.02).mean() < 0.002
    assert (j_dep < 60.0).mean() > 0.3


def test_dense_tracer_matches_jax():
    kw = dict(width=24, height=16, fov_deg=85.0, t_max=60.0)
    j_mesh, args = raycast_scene(JMeshRegistry, 5)
    t_mesh, _ = raycast_scene(MeshRegistry, 5)
    pos, rot, scale, obj, mask, cam_pos, cam_rot = args
    w = pos.shape[0]
    tt = torch.from_numpy
    for v in range(2):
        o, d = t_raycast.camera_rays(RenderConfig(**kw), tt(cam_pos[:, v]),
                                     tt(cam_rot[:, v]))
        t_rgb, t_dep = t_raycast._trace_rays(
            RenderConfig(**kw), t_mesh, tt(pos), tt(rot), tt(scale), tt(obj),
            tt(mask[:, v]), o.reshape(w, -1, 3), d.reshape(w, -1, 3))
        for wi in range(w):
            jo, jd = j_raycast.camera_rays(
                JRenderConfig(**kw), jnp.asarray(cam_pos[wi, v]),
                jnp.asarray(cam_rot[wi, v]))
            np.testing.assert_allclose(d[wi].numpy(), np.asarray(jd),
                                       rtol=0, atol=1e-6)
            j_rgb, j_dep = j_raycast._trace_rays(
                JRenderConfig(**kw), j_mesh, *(jnp.asarray(a[wi]) for a in
                                               (pos, rot, scale, obj)),
                jnp.asarray(mask[wi, v]), jo.reshape(-1, 3),
                jd.reshape(-1, 3))
            j_dep = np.asarray(j_dep)
            assert np.abs(t_dep[wi].numpy() - j_dep).max() <= 1e-4
            bad = np.abs(t_rgb[wi].numpy() - np.asarray(j_rgb)) > 0.02
            assert bad.mean() < 0.002
            assert (j_dep < 60.0).mean() > 0.3
