"""The port's raycast kernel path vs the JAX package, on the CPU.

``ops/raycast_cuda.raytrace_plain`` (the plain version of the CUDA
raycast kernel) against the Pallas kernel
``ops/raycast_pallas.make_raytrace(..., interpret=True)``, called
un-jitted, on numpy-made setup, attribute, direction and atlas planes
(WV = 4, T = 36 with duplicated rows that force exact ties, R = 256), for
the four option sets flat / shadows / lights+shadows / materials+lights.
Depth and occ within 1e-5 everywhere; u, v and rgb within 1e-5 except at
pixels where the two sides picked another winner among equal hits
(counted; at most 0.2 %).

Then ``render_views`` of the port alone: inside the kernel's triangle
budget it equals the glue's output; past it, it takes the dense tracer,
whose depth agrees within 1e-3 and whose rgb differs by more than 0.02 at
under 0.2 % of pixels, and so do the "matmul" tracer's. The glue and the
dense tracer against the JAX ones are in tests/test_torch_raycast_glue.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu.ops import raycast_pallas as j_rpk
from madrona_tpu_torch.ops import raycast_cuda as rck
from madrona_tpu_torch.render import MeshRegistry, RenderConfig
from madrona_tpu_torch.render import kernel as t_kernel
from madrona_tpu_torch.render import raycast as t_raycast

from torch_port import raycast_planes, raycast_scene

torch.set_num_threads(1)

OPTION_SETS = {
    "flat": dict(shadows=False, use_lights=False, use_materials=False),
    "shadows": dict(shadows=True, use_lights=False, use_materials=False),
    "lights_shadows": dict(shadows=True, use_lights=True,
                           use_materials=False),
    "materials_lights": dict(shadows=False, use_lights=True,
                             use_materials=True),
}
T_MAX = 50.0
TEX = 8


@pytest.mark.parametrize("name", list(OPTION_SETS))
def test_plain_matches_pallas_interpret(name):
    opts = OPTION_SETS[name]
    setup, attrs, dl, atlas = raycast_planes(
        list(OPTION_SETS).index(name), TEX)
    common = dict(ambient=0.35, shadow_ambient=0.25, sky=(0.1, 0.2, 0.4),
                  tex_size=TEX)
    run = j_rpk.make_raytrace(36, 256, T_MAX, interpret=True, tile_r=256,
                              **opts, **common)
    ref = np.asarray(run(*(jnp.asarray(x) for x in
                           (setup, attrs, dl, atlas))))
    got = rck.raytrace_plain(
        *(torch.from_numpy(x) for x in (setup, attrs, dl, atlas)),
        t_max=T_MAX, **opts, **common).numpy()
    assert got.shape == ref.shape == (4, rck.PO, 256)
    hits = ref[:, rck.O_T] < T_MAX
    assert 0.3 < hits.mean() < 1.0
    for plane in (rck.O_T, rck.O_OCC):
        assert np.abs(got[:, plane] - ref[:, plane]).max() <= 1e-5, plane
    if opts["shadows"]:
        assert 0.02 < ref[:, rck.O_OCC].mean() < 0.98
    rest = [rck.O_R, rck.O_G, rck.O_B, rck.O_U, rck.O_V]
    bad = (np.abs(got[:, rest] - ref[:, rest]) > 1e-5).any(axis=1)
    assert bad.mean() <= 0.002, bad.mean()
    if opts["use_materials"]:
        assert np.abs(ref[:, rck.O_U]).max() > 0


def test_render_views_takes_the_kernel_tier_or_the_dense_tracer(monkeypatch):
    """render_views on a scene inside the kernel's budget equals the
    glue's output; past the budget it takes the dense tracer, whose depth
    agrees with the kernel tier's within 1e-3."""
    kw = dict(width=12, height=8, fov_deg=85.0, t_max=60.0)
    t_mesh, args = raycast_scene(MeshRegistry, 7)
    targs = [torch.from_numpy(a) for a in args]
    cfg = RenderConfig(**kw)
    rgb, dep = t_raycast.render_views(cfg, t_mesh, *targs)
    rgb_k, dep_k = t_kernel.render_views_kernel(cfg, t_mesh, *targs)
    assert torch.equal(rgb, rgb_k) and torch.equal(dep, dep_k)
    monkeypatch.setattr(t_kernel, "MAX_FLAT_TRIS", 8)
    rgb_d, dep_d = t_raycast.render_views(cfg, t_mesh, *targs)
    assert rgb_d.shape == rgb.shape
    assert float((dep_d - dep).abs().max()) < 1e-3
    assert float(((rgb_d - rgb).abs() > 0.02).float().mean()) < 0.002
    # the pinhole-factorised dense tracer past the budget: the same bounds
    rgb_m, dep_m = t_raycast.render_views(
        dataclasses.replace(cfg, tracer="matmul"), t_mesh, *targs)
    assert float((dep_m - dep).abs().max()) < 1e-3
    assert float(((rgb_m - rgb).abs() > 0.02).float().mean()) < 0.002
    with pytest.raises(ValueError):
        t_raycast.render_views(dataclasses.replace(cfg, tracer="nope"),
                               t_mesh, *targs)
