"""Assets whose textures are DDS, QOI and PPM, through the JAX package's
importers (PIL's decoding) and the port's (its own decoders), on
chip_smoke.py's phase 31d files (write_format2_assets: an OBJ + MTL
whose map_Kd is a BC1 DDS with punch-through alpha, a .glb cube whose
bufferView image is a BC7 DDS with a mip chain, a .gltf quad whose image
is a QOI data URI, and OBJ + MTL cubes with a 30 x 18 BC3 DDS and a
binary P6 PPM at maxval 1023):
  * meshes, materials and decoded textures equal bit for bit, and the
    textures equal to the committed goldens' PIL RGBA
    (tests/goldens/torch_images.npz, which the card's run checks too);
  * bake_assets_blas' BLAS and material tables (the atlas resampled to
    64^2) equal the JAX package's bit for bit, every field.
Both skip where PIL is missing (the JAX package decodes with it)."""

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("PIL")

from madrona_tpu.assets.importer import import_assets as j_import_assets
from madrona_tpu.render import blas as j_blas
from madrona_tpu_torch.assets.importer import import_assets
from madrona_tpu_torch.render import blas as t_blas

import chip_smoke
from torch_port import jax_tree

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    files, _, _ = chip_smoke.load_image_goldens()
    return chip_smoke.write_format2_assets(
        str(tmp_path_factory.mktemp("a")), files)


def test_imports_match_jax_and_goldens(paths):
    _, rgba, _ = chip_smoke.load_image_goldens()
    assert sorted(paths) == sorted(chip_smoke.FORMAT2_SCENE)
    for k, path in paths.items():
        got, ref = import_assets(path), j_import_assets(path)
        assert len(got.meshes) == len(ref.meshes) >= 1
        for g, r in zip(got.meshes, ref.meshes):
            np.testing.assert_array_equal(g.positions, r.positions)
            np.testing.assert_array_equal(g.indices, r.indices)
            assert (g.uvs is None) == (r.uvs is None)
            if g.uvs is not None:
                np.testing.assert_array_equal(g.uvs, r.uvs)
            assert (g.name, g.material) == (r.name, r.material)
        assert len(got.materials) == len(ref.materials) == 1
        for g, r in zip(got.materials, ref.materials):
            np.testing.assert_array_equal(g.base_color, r.base_color)
            assert (g.name, g.metallic, g.roughness, g.texture) == (
                r.name, r.metallic, r.roughness, r.texture)
        assert len(got.textures) == len(ref.textures) == 1
        g, r = got.textures[0], ref.textures[0]
        assert g.name == r.name and g.data.dtype == np.uint8
        np.testing.assert_array_equal(g.data, r.data)
        np.testing.assert_array_equal(
            g.data, rgba[chip_smoke.FORMAT2_TEXTURES[k]])
    # the textures are what the names say: the BC1's punch-through alpha
    # gives 0, the others are opaque; the BC3 is 30 x 18, the BC7 the first
    # surface of its mip chain (32 x 32)
    alpha = {k: rgba[v][..., 3] for k, v in
             chip_smoke.FORMAT2_TEXTURES.items()}
    assert 0 < float((alpha["bc1_obj"] == 0).mean()) < 1
    assert int(alpha["ppm_obj"].min()) == 255
    assert rgba["fmt2_dds_bc3_30x18"].shape == (18, 30, 4)
    assert rgba["fmt2_dds_bc7_mips"].shape == (32, 32, 4)


def test_bake_matches_jax(paths):
    tex_size = 64
    for k, path in paths.items():
        got_b, got_m, ids = t_blas.bake_assets_blas(
            import_assets(path), tex_size=tex_size, device="cpu")
        ref_b, ref_m, ref_ids = j_blas.bake_assets_blas(
            j_import_assets(path), tex_size=tex_size)
        assert ids == ref_ids
        rb = jax_tree(ref_b)
        for f in dataclasses.fields(got_b):
            g = getattr(got_b, f.name)
            if f.name == "wide":
                assert g is None
            elif torch.is_tensor(g):
                np.testing.assert_array_equal(g.numpy(), rb[f.name],
                                              err_msg=f"{k} {f.name}")
            else:
                assert g == rb[f.name], f.name
        rm = jax_tree(ref_m)
        for f, r in rm.items():
            np.testing.assert_array_equal(getattr(got_m, f).numpy(), r,
                                          err_msg=f"{k} {f}")
        assert got_m.tex_size == tex_size
        # the atlas holds the texture (not a flat colour)
        assert float(rm["atlas"].std()) > 0.01
