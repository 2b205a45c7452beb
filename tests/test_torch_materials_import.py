"""Materials and textures of imported assets on the port vs the JAX
package (which resizes and decodes with PIL; every test here skips
where PIL is missing):
- render.materials.resize_bilinear against PIL's Image.resize(...,
  BILINEAR), byte for byte: RGBA and RGB, up and down, non-square, one
  axis only, alpha 0, 255 and in between (RGBA is premultiplied by
  alpha and divided back, as PIL does);
- bake_materials and bake_assets_blas on chip_smoke.py's imported files
  (the OBJ with its MTL and a 24 x 20 RGBA texture, the textured .gltf
  quad and .glb cube) equal the JAX package's bit for bit, every field
  of the BLAS and material tables (the atlas resampled to 64 and to
  16);
- tests/test_materials.py's cases on the port: the glTF material and
  texture import, the OBJ .mtl import, bilinear sampling with wrap, the
  textured trace (the checker pattern, exact colour classes) and the
  shadow rays (the floor under a slab darkens; the open floor does not,
  within 1e-6 of the trace without shadows).
"""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("PIL")

from madrona_tpu.assets.importer import import_assets as j_import_assets
from madrona_tpu.render import blas as j_blas
from madrona_tpu_torch.assets.bvh import build_mesh_bvh
from madrona_tpu_torch.assets.importer import (
    ImportedMaterial, ImportedTexture, import_assets,
)
from madrona_tpu_torch.render import blas as t_blas
from madrona_tpu_torch.render.materials import (
    bake_materials, resize_bilinear, sample_materials,
)
from madrona_tpu_torch.render.raycast import RenderConfig

import chip_smoke
from test_materials import _write_quad_gltf
from torch_port import jax_tree

torch.set_num_threads(1)


def test_resize_matches_pil():
    from PIL import Image

    rs = np.random.RandomState(0)
    cases = [((64, 64), (8, 8)), ((8, 8), (64, 64)), ((20, 24), (64, 64)),
             ((37, 5), (16, 48)), ((64, 64), (3, 7)), ((16, 16), (16, 40)),
             ((16, 33), (16, 9)), ((1, 1), (5, 5)), ((100, 3), (64, 64))]
    n = 0
    for (h, w), (oh, ow) in cases:
        for c in (3, 4):
            for alpha in ("random", 0, 255, "mixed"):
                if c == 3 and alpha != "random":
                    continue
                img = rs.randint(0, 256, (h, w, c)).astype(np.uint8)
                if alpha == "mixed":
                    img[..., 3] = rs.choice([0, 1, 128, 254, 255], (h, w))
                elif alpha != "random":
                    img[..., 3] = alpha
                ref = np.asarray(Image.fromarray(img).resize(
                    (ow, oh), Image.BILINEAR))
                got = resize_bilinear(img, (ow, oh))
                assert got.dtype == np.uint8 and got.shape == ref.shape
                np.testing.assert_array_equal(got, ref)
                n += 1
    assert n == len(cases) * 5
    with pytest.raises(ValueError):
        resize_bilinear(np.zeros((4, 4), np.uint8), (2, 2))


def test_bake_assets_blas_matches_jax(tmp_path):
    paths = chip_smoke.write_assets(str(tmp_path))
    for tex_size in (64, 16):
        for k in ("obj", "gltf", "glb"):
            got_b, got_m, ids = t_blas.bake_assets_blas(
                import_assets(paths[k]), tex_size=tex_size, device="cpu")
            ref_b, ref_m, ref_ids = j_blas.bake_assets_blas(
                j_import_assets(paths[k]), tex_size=tex_size)
            assert ids == ref_ids
            rb = jax_tree(ref_b)
            for f in dataclasses.fields(got_b):
                g = getattr(got_b, f.name)
                if f.name == "wide":
                    assert g is None
                elif torch.is_tensor(g):
                    np.testing.assert_array_equal(g.numpy(), rb[f.name],
                                                  err_msg=f.name)
                else:
                    assert g == rb[f.name], f.name
            for f, r in jax_tree(ref_m).items():
                np.testing.assert_array_equal(getattr(got_m, f).numpy(), r,
                                              err_msg=f)
            assert got_m.tex_size == tex_size


def test_gltf_material_texture_import(tmp_path):
    p = _write_quad_gltf(str(tmp_path))
    assets = import_assets(p)
    assert len(assets.meshes) == 1
    m = assets.meshes[0]
    assert m.uvs is not None and m.uvs.shape == (4, 2)
    assert m.material == 0
    assert len(assets.materials) == 1
    mat = assets.materials[0]
    assert mat.roughness == 0.5 and mat.metallic == 0.25
    assert mat.texture == 0
    assert len(assets.textures) == 1
    assert assets.textures[0].data.shape == (8, 8, 4)
    ref = j_import_assets(p)
    np.testing.assert_array_equal(assets.textures[0].data,
                                  ref.textures[0].data)


def test_obj_mtl_import(tmp_path):
    (tmp_path / "cube.mtl").write_text("newmtl red\nKd 0.9 0.1 0.2\nNs 250\n")
    obj = tmp_path / "cube.obj"
    obj.write_text("mtllib cube.mtl\nusemtl red\n"
                   "v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    assets = import_assets(str(obj))
    assert assets.meshes[0].material == 0
    np.testing.assert_allclose(assets.materials[0].base_color[:3],
                               [0.9, 0.1, 0.2])
    ref = j_import_assets(str(obj))
    assert assets.materials[0].roughness == ref.materials[0].roughness


def test_sample_materials_bilinear_wrap():
    img = np.zeros((4, 4, 4), np.uint8)
    img[..., 3] = 255
    img[0, 0] = (255, 0, 0, 255)     # v = 1 corner (row 0)
    tables = bake_materials([ImportedMaterial(name="m", texture=0)],
                            [ImportedTexture("t", img)], tex_size=4,
                            device="cpu")

    def sample(mat, uv):
        return sample_materials(tables, torch.tensor([mat]),
                                torch.tensor([uv]))[0].numpy()

    # texel centres: uv = (0.125, 0.875) hits texel (0, 0) exactly
    np.testing.assert_allclose(sample(1, [0.125, 0.875]), [1, 0, 0],
                               atol=1e-5)
    # wrap: uv + 1 samples the same point
    np.testing.assert_allclose(sample(1, [1.125, -0.125]), [1, 0, 0],
                               atol=1e-5)
    # the default material (slot 0): white
    np.testing.assert_allclose(sample(0, [0.5, 0.5]), [1, 1, 1], atol=1e-6)


def test_textured_trace_golden(tmp_path):
    """The textured quad traced straight on: pixel colours follow the
    checker pattern."""
    assets = import_assets(_write_quad_gltf(str(tmp_path)))
    blas, mats, _ = t_blas.bake_assets_blas(assets, device="cpu")
    cfg = RenderConfig(width=4, height=4, t_max=10.0, ambient=1.0)
    centers = [-0.75, -0.25, 0.25, 0.75]
    origins = [(x, -3.0, z) for z in reversed(centers) for x in centers]
    dirs = [(0.0, 1.0, 0.0)] * 16
    rgb, depth = t_blas.trace_scene_blas(
        cfg, blas, torch.zeros((1, 3)), torch.tensor([[1.0, 0, 0, 0]]),
        torch.ones((1, 3)), torch.zeros((1,), dtype=torch.int32),
        torch.ones((1,), dtype=torch.bool), torch.tensor(origins),
        torch.tensor(dirs), materials=mats)
    rgb = rgb.numpy().reshape(4, 4, 3)
    assert (depth.numpy() < 10.0).all()
    red, blue = rgb[..., 0] > 0.6, rgb[..., 2] > 0.6
    assert (red | blue).all() and red.any() and blue.any()
    for iy, z in enumerate(reversed(centers)):
        for ix, x in enumerate(centers):
            tx, ty = int((x + 1) / 2 * 8), int((1 - (z + 1) / 2) * 8)
            assert red[iy, ix] == (((ty // 2 + tx // 2) % 2) == 0), (iy, ix)


def test_shadow_rays():
    """A slab above a floor: floor pixels under the slab darken with
    cfg.shadows on."""
    floor_v = np.array([[-5, -5, 0], [5, -5, 0], [5, 5, 0], [-5, 5, 0]],
                       np.float32)
    tris = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    slab_v = np.array([[-1, -1, 2], [1, -1, 2], [1, 1, 2], [-1, 1, 2]],
                      np.float32)
    blas = t_blas.bake_blas(
        [build_mesh_bvh(floor_v, tris), build_mesh_bvh(slab_v, tris)],
        colors=[(0.8, 0.8, 0.8), (0.5, 0.2, 0.2)], device="cpu")
    inst = dict(inst_pos=torch.zeros((2, 3)),
                inst_rot=torch.tensor([[1.0, 0, 0, 0]] * 2),
                inst_scale=torch.ones((2, 3)),
                inst_obj=torch.tensor([0, 1], dtype=torch.int32),
                inst_mask=torch.ones((2,), dtype=torch.bool))
    on = RenderConfig(t_max=20.0, shadows=True, light_dir=(0.0, 0.0, -1.0))
    off = dataclasses.replace(on, shadows=False)
    org = torch.tensor([[0.0, 0.0, 5.0], [3.0, 3.0, 5.0]])
    down = torch.tensor([[0, 0, -1.0], [0, 0, -1.0]])
    r_on = t_blas.trace_scene_blas(on, blas, origins=org, dirs=down,
                                   **inst)[0].numpy()
    r_off = t_blas.trace_scene_blas(off, blas, origins=org, dirs=down,
                                    **inst)[0].numpy()
    np.testing.assert_allclose(r_on[1], r_off[1], atol=1e-6)
    # a ray that reaches the floor under the slab past its edge
    org = torch.tensor([[3.0, 0.0, 5.0]])
    d = torch.tensor([[-2.5, 0.0, -5.0]])
    d = d / torch.linalg.norm(d)
    rgb_on, d_on = t_blas.trace_scene_blas(on, blas, origins=org, dirs=d,
                                           **inst)
    rgb_off, d_off = t_blas.trace_scene_blas(off, blas, origins=org, dirs=d,
                                             **inst)
    assert float(d_on[0]) < 20.0
    assert float(d_on[0]) == float(d_off[0])
    assert (rgb_on.numpy()[0] < rgb_off.numpy()[0] - 0.05).all()
