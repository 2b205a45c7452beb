"""The port's render tables vs the JAX package's, on the CPU.

Each table is built by both packages from the same inputs and carried
across (madrona_tpu_torch.interop: blas_from_numpy, materials_from_numpy,
lights_from_numpy); integers and floats must be equal, bit for bit:
  morton3d codes (utils/morton.py);
  the mesh BVH (assets/bvh.py, the port's own g++ build of
    native/bvh_build.cpp) of tests/test_blas.py's sphere and bumpy
    terrain: node_min, node_max, left, right, tri_order;
  bake_blas, through MeshRegistry.build_blas of Hide & Seek's meshes;
  bake_materials (Hide & Seek's _make_materials; a texture of another
    size resampled to the atlas's) and sample_materials (bilinear,
    wrapped) on random ids and uvs: the sample within 1e-6;
  make_lights (directional and spot specs).
The tables default to the card: without CUDA, building one without a
device raises."""

import numpy as np
import pytest
import torch

from madrona_tpu.assets import bvh as j_bvh
from madrona_tpu.models import hide_seek as j_hs
from madrona_tpu.render import lights as j_lights
from madrona_tpu.render import materials as j_mat
from madrona_tpu.utils.morton import morton3d as j_morton
from madrona_tpu_torch.assets import bvh as t_bvh
from madrona_tpu_torch.assets.importer import ImportedTexture
from madrona_tpu_torch.interop import (
    blas_from_numpy, lights_from_numpy, materials_from_numpy,
)
from madrona_tpu_torch.models import hide_seek as t_hs
from madrona_tpu_torch.render import blas as t_blas
from madrona_tpu_torch.render import lights as t_lights
from madrona_tpu_torch.render import materials as t_mat
from madrona_tpu_torch.utils.morton import morton3d as t_morton

from test_blas import bumpy_terrain, uv_sphere
from torch_port import jax_tree

torch.set_num_threads(1)

BLAS_FIELDS = ("node_min", "node_max", "left", "right", "tri_v0", "tri_e1",
               "tri_e2", "tri_color", "tri_uv", "tri_mat")
LIGHT_SPECS = [
    {"direction": (0.3, -0.4, -1.0), "cast_shadow": True},
    {"position": (2.0, -1.0, 5.0), "direction": (0.0, 0.2, -1.0),
     "cutoff": 0.5, "intensity": 0.6},
    {"position": (-3.0, 0.0, 2.0)},
]


def _equal_tables(got, ref, fields):
    for f in fields:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f


def test_morton3d_bit_exact():
    rs = np.random.RandomState(3)
    pos = rs.uniform(-30, 30, (4, 500, 3)).astype(np.float32)
    pos[0, :8] = [[-25, -25, -25], [25, 25, 25], [0, 0, 0], [24.99] * 3,
                  [-25.01] * 3, [1e-7, 0, 0], [25, -25, 0], [-1e9, 1e9, 0]]
    ref = np.asarray(j_morton(pos, [-25.0] * 3, [25.0] * 3))
    got = t_morton(torch.from_numpy(pos), [-25.0] * 3, [25.0] * 3)
    assert ref.dtype == np.uint32 and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    assert len(np.unique(ref)) > 1000


@pytest.mark.parametrize("mesh", [uv_sphere, bumpy_terrain],
                         ids=["sphere", "terrain"])
def test_mesh_bvh_build_equal(mesh):
    v, t = mesh()
    ref = j_bvh.build_mesh_bvh(v, t)
    got = t_bvh.build_mesh_bvh(v, t)
    assert t_bvh.library_path().parent.name == "_build"
    for f in ("node_min", "node_max", "left", "right", "tri_order"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert got.num_nodes > 100 and (got.right < 0).any()
    # the host query agrees too
    for o, d in (((0.0, -5.0, 0.3), (0.0, 1.0, 0.05)),
                 ((0.3, 0.2, 6.0), (0.0, 0.1, -1.0))):
        assert got.trace_ray(o, d) == ref.trace_ray(o, d)


def test_bake_blas_equal():
    """Hide & Seek's meshes baked by both packages (MeshRegistry.build_blas:
    the BVH build, leaf-order triangles, uvs and material slots), and the
    blas of the sphere and terrain with colours and uvs."""
    j_reg, _ = j_hs._make_meshes()
    t_reg, _ = t_hs._make_meshes()
    ref = j_reg.build_blas()
    got = t_reg.build_blas(device="cpu")
    _equal_tables(got, blas_from_numpy(jax_tree(ref), "cpu"), BLAS_FIELDS)
    assert (got.max_leaf, got.num_objects) == (ref.max_leaf, ref.num_objects)
    assert got.tri_mat.unique().tolist() == list(range(7))   # 0: pads
    assert float(got.tri_uv.abs().max()) == 8.0

    meshes = [uv_sphere(8, 12), bumpy_terrain(6)]
    uvs = [m[0][:, :2] * 0.5 for m in meshes]
    kw = dict(colors=[(0.9, 0.3, 0.2), (0.3, 0.7, 0.3)], uvs=uvs,
              materials=[2, 1])
    ref = j_bvh_bake(meshes, kw)
    got = t_blas.bake_blas([t_bvh.build_mesh_bvh(*m) for m in meshes],
                           device="cpu", **kw)
    _equal_tables(got, blas_from_numpy(jax_tree(ref), "cpu"), BLAS_FIELDS)
    assert got.max_leaf == ref.max_leaf


def j_bvh_bake(meshes, kw):
    from madrona_tpu.render.blas import bake_blas

    return bake_blas([j_bvh.build_mesh_bvh(*m) for m in meshes], **kw)


def test_materials_equal_and_sampled_alike():
    ref = j_hs._make_materials()
    got = t_hs._make_materials(device="cpu")
    fields = ("base_color", "rough_metal", "tex_id", "atlas")
    _equal_tables(got, materials_from_numpy(jax_tree(ref), "cpu"), fields)
    assert got.tex_size == 32 and got.num_materials == 7
    d_ref, d_got = j_mat.default_materials(), t_mat.default_materials("cpu")
    _equal_tables(d_got, materials_from_numpy(jax_tree(d_ref), "cpu"), fields)

    rs = np.random.RandomState(5)
    mat_id = rs.randint(-1, 8, (600,)).astype(np.int32)
    uv = rs.uniform(-3, 3, (600, 2)).astype(np.float32)
    uv[:40] = np.round(uv[:40] * 4) / 4            # texel and tile edges
    a = np.asarray(j_mat.sample_materials(ref, mat_id, uv))
    b = t_mat.sample_materials(got, torch.from_numpy(mat_id),
                               torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    assert len(np.unique(np.round(a[mat_id == 1], 4), axis=0)) > 10


def test_bake_materials_takes_no_other_size():
    """A texture of another size is resampled to the atlas's (PIL's
    bilinear resize in the JAX package): the atlases equal bit for
    bit."""
    from madrona_tpu.assets.importer import ImportedTexture as JTex

    img = np.random.RandomState(5).randint(0, 256, (16, 8, 4)).astype(
        np.uint8)
    got = t_mat.bake_materials([], [ImportedTexture("t", img)], tex_size=8,
                               device="cpu")
    ref = j_mat.bake_materials([], [JTex("t", img)], tex_size=8)
    assert got.atlas.shape == (1, 8, 8, 3)
    np.testing.assert_array_equal(got.atlas.numpy(), np.asarray(ref.atlas))


def test_make_lights_equal():
    for specs in (LIGHT_SPECS, [], LIGHT_SPECS[:1]):
        ref = j_lights.make_lights(3, specs)
        got = t_lights.make_lights(3, specs, device="cpu")
        carried = lights_from_numpy(jax_tree(ref), "cpu")
        _equal_tables(got, carried, [f for f in jax_tree(ref)])
        assert got.capacity == max(len(specs), 1)


def test_tables_default_to_the_card():
    """Without a device the tables go to the card; without CUDA that
    raises and nothing lands on the CPU quietly."""
    reg, _ = t_hs._make_meshes()
    makers = (lambda: reg.build_blas(), lambda: t_hs._make_materials(),
              lambda: t_lights.make_lights(2, LIGHT_SPECS))
    for make in makers:
        if torch.cuda.is_available():
            t = make()
            first = getattr(t, "node_min", getattr(t, "atlas", None))
            first = t.direction if first is None else first
            assert first.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                make()
