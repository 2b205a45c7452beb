"""The port's asset importers (madrona_tpu_torch.assets) vs the JAX
package's, on the same files (tests/test_assets.py's cases and
chip_smoke.py's writers); every array equal bit for bit, names and
material indices equal:
- OBJ: the unit cube (quads fan-triangulated) and a triangle with
  negative indices; the port's parser against the JAX package's Python
  parser and its native one (import_from_disk's dispatch too);
- glTF: tests/test_assets.py's data-URI triangle, chip_smoke.py's
  textured quad (.gltf, data-URI PNG) and cube (.glb, its PNG in the
  binary chunk): load_gltf's meshes (positions, normals, indices, UVs,
  material) and import_assets' materials and decoded textures;
- USD: the five cases of tests/test_assets.py (the cube under two
  Xforms, a transform matrix with leftHanded winding, rotateXYZ with
  normals, rotateZYX with attributes after a child prim) and
  chip_smoke.py's pillar; a crate file (.usdc magic) is refused;
- the PNG decoder against PIL.Image.open(...).convert("RGBA"), byte for
  byte: PNGs that PIL writes (1-bit, L, LA, RGB, RGBA, 4-bit P with
  and without transparency), chip_smoke.png_bytes' PNGs with each of the five
  filters (and mixed per row) in every colour type, a palette with
  tRNS; a 16-bit palette, an unknown interlace method and a JPEG file
  raise ValueError (that test skips where PIL is missing; 16-bit and
  interlaced files are held to PIL in tests/test_torch_image_decode.py).
"""

import io
import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from madrona_tpu.assets import import_from_disk as j_import_from_disk
from madrona_tpu.assets import load_gltf as j_load_gltf
from madrona_tpu.assets import load_obj as j_load_obj
from madrona_tpu.assets import load_usd as j_load_usd
from madrona_tpu.assets.importer import _load_obj_py as j_load_obj_py
from madrona_tpu.assets.importer import import_assets as j_import_assets
from madrona_tpu_torch.assets import (
    import_from_disk, load_gltf, load_obj, load_usd,
)
from madrona_tpu_torch.assets.importer import import_assets
from madrona_tpu_torch.assets.png import decode_png

import chip_smoke
from test_assets import CUBE_OBJ, CUBE_USDA

torch.set_num_threads(1)


def _same_mesh(a, b):
    for f in ("positions", "normals", "indices"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.name == b.name and a.material == b.material
    assert (a.uvs is None) == (b.uvs is None)
    if a.uvs is not None:
        np.testing.assert_array_equal(a.uvs, b.uvs)


def _same_assets(a, b):
    assert len(a.meshes) == len(b.meshes)
    for x, y in zip(a.meshes, b.meshes):
        _same_mesh(x, y)
    assert len(a.materials) == len(b.materials)
    for x, y in zip(a.materials, b.materials):
        assert (x.name, x.metallic, x.roughness, x.texture) == (
            y.name, y.metallic, y.roughness, y.texture)
        np.testing.assert_array_equal(x.base_color, y.base_color)
    assert len(a.textures) == len(b.textures)
    for x, y in zip(a.textures, b.textures):
        assert x.name == y.name and x.data.dtype == y.data.dtype
        np.testing.assert_array_equal(x.data, y.data)


def test_obj_matches_jax(tmp_path):
    cube = os.path.join(tmp_path, "cube.obj")
    with open(cube, "w") as f:
        f.write(CUBE_OBJ)
    tri = os.path.join(tmp_path, "tri.obj")
    with open(tri, "w") as f:
        f.write("v 0 0 0\nv 1 0 0\nv 0 1 0\nf -3 -2 -1\n")
    for p in (cube, tri):
        got = load_obj(p)
        _same_mesh(got, j_load_obj_py(p))
        native = j_load_obj(p)
        np.testing.assert_array_equal(got.positions, native.positions)
        np.testing.assert_array_equal(got.indices, native.indices)
        (via,) = import_from_disk(p)
        _same_mesh(via, got)
    assert load_obj(cube).indices.shape == (12, 3)
    np.testing.assert_array_equal(load_obj(tri).indices, [[0, 1, 2]])
    with pytest.raises(ValueError, match="unsupported"):
        import_from_disk(os.path.join(tmp_path, "mesh.fbx"))


def test_gltf_and_glb_match_jax(tmp_path):
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    buf = pos.tobytes() + np.array([0, 1, 2], np.uint16).tobytes()
    import base64
    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"uri": "data:application/octet-stream;base64,"
                     + base64.b64encode(buf).decode(),
                     "byteLength": len(buf)}],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": 36},
            {"buffer": 0, "byteOffset": 36, "byteLength": 6}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 3,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5123, "count": 3,
             "type": "SCALAR"}],
        "meshes": [{"name": "tri", "primitives": [
            {"attributes": {"POSITION": 0}, "indices": 1}]}],
    }
    tri = os.path.join(tmp_path, "tri.gltf")
    with open(tri, "w") as f:
        json.dump(doc, f)
    (m,) = load_gltf(tri)
    np.testing.assert_array_equal(m.positions, pos)
    np.testing.assert_array_equal(m.indices, [[0, 1, 2]])
    paths = chip_smoke.write_assets(str(tmp_path))
    for p in (tri, paths["gltf"], paths["glb"]):
        got, ref = load_gltf(p), j_load_gltf(p)
        assert len(got) == len(ref) == 1
        _same_mesh(got[0], ref[0])
        (via,) = import_from_disk(p)
        _same_mesh(via, ref[0])
        (jvia,) = j_import_from_disk(p)
        _same_mesh(via, jvia)
    for k in ("gltf", "glb", "obj"):
        got, ref = import_assets(paths[k]), j_import_assets(paths[k])
        _same_assets(got, ref)
        assert len(got.textures) == 1 and got.meshes[0].material == 0
    assert int(import_assets(paths["obj"]).textures[0].data[..., 3].min()) \
        < 255


USD_TRANSFORM = """#usda 1.0
def Xform "g"
{
    matrix4d xformOp:transform = ( (0, 1, 0, 0), (-1, 0, 0, 0),
                                   (0, 0, 1, 0), (5, 0, 0, 1) )
    uniform token[] xformOpOrder = ["xformOp:transform"]

    def Mesh "tri" (
        active = true
    )
    {
        int[] faceVertexCounts = [3]
        int[] faceVertexIndices = [0, 1, 2]
        point3f[] points = [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
        uniform token orientation = "leftHanded"
    }
}
"""

USD_ROTATE = """#usda 1.0
def Mesh "quad"
{
    float3 xformOp:rotateXYZ = (0, 0, 90)
    uniform token[] xformOpOrder = ["xformOp:rotateXYZ"]
    int[] faceVertexCounts = [3]
    int[] faceVertexIndices = [0, 1, 2]
    point3f[] points = [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
    normal3f[] normals = [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
}
"""

USD_ZYX = """#usda 1.0
def Xform "g"
{
    float3 xformOp:rotateZYX = (0, 0, 90)
    uniform token[] xformOpOrder = ["xformOp:rotateZYX"]

    def Mesh "tri"
    {
        def GeomSubset "mat0"
        {
            int[] indices = [0]
        }
        int[] faceVertexCounts = [3]
        int[] faceVertexIndices = [0, 1, 2]
        point3f[] points = [(1, 0, 0), (0, 1, 0), (0, 0, 1)]
    }
}
"""


@pytest.mark.parametrize("case", ["cube", "transform", "rotate_normals",
                                  "zyx_attrs_after_child", "pillar"])
def test_usd_matches_jax(case, tmp_path):
    if case == "pillar":
        p = chip_smoke.write_assets(str(tmp_path))["usda"]
    else:
        p = os.path.join(tmp_path, f"{case}.usda")
        with open(p, "w") as f:
            f.write({"cube": CUBE_USDA, "transform": USD_TRANSFORM,
                     "rotate_normals": USD_ROTATE,
                     "zyx_attrs_after_child": USD_ZYX}[case])
    got, ref = load_usd(p), j_load_usd(p)
    assert len(got) == len(ref) == 1
    _same_mesh(got[0], ref[0])
    (via,) = import_from_disk(p)
    _same_mesh(via, ref[0])
    if case == "cube":
        np.testing.assert_allclose(got[0].positions.min(axis=0), [8, -2, -2])
        np.testing.assert_allclose(got[0].positions.max(axis=0), [12, 2, 2])
    if case == "transform":
        np.testing.assert_array_equal(got[0].indices, [[0, 2, 1]])


def test_usdc_refused(tmp_path):
    p = os.path.join(tmp_path, "bin.usd")
    with open(p, "wb") as f:
        f.write(b"PXR-USDC" + b"\x00" * 64)
    with pytest.raises(ValueError, match="usdc"):
        load_usd(p)
    with pytest.raises(ValueError, match="usdc"):
        import_from_disk(p)


def _pil_rgba(data):
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def _pil_png(img, mode=None, **kw):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img, mode).save(buf, format="PNG", **kw)
    return buf.getvalue()


def test_png_decoder_matches_pil():
    pytest.importorskip("PIL")
    from PIL import Image

    rs = np.random.RandomState(0)
    files = []
    # PNGs that PIL writes (it picks its own filters per row)
    for shape in ((13, 17), (13, 17, 2), (9, 31, 3), (20, 11, 4)):
        img = rs.randint(0, 256, shape).astype(np.uint8)
        files.append(_pil_png(img))
        # smooth images make the adaptive filters pick Sub, Up, Paeth
        yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
        smooth = ((yy * 7 + xx * 3) % 256).astype(np.uint8)
        smooth = np.broadcast_to(smooth[..., None], shape[:2] + (
            shape[2] if len(shape) == 3 else 1,))
        files.append(_pil_png(np.ascontiguousarray(
            smooth if len(shape) == 3 else smooth[..., 0])))
    pal = Image.fromarray(rs.randint(0, 256, (15, 10, 3)).astype(
        np.uint8)).quantize(7)
    files.append(_pil_png(rs.rand(9, 21) > 0.5))          # 1-bit grey
    for transparency in (None, 2):
        buf = io.BytesIO()
        kw = {} if transparency is None else {"transparency": transparency}
        pal.save(buf, format="PNG", **kw)
        files.append(buf.getvalue())
    # each filter type in every colour type, and a mix per row
    for c in (1, 2, 3, 4):
        img = rs.randint(0, 256, (12, 9, c)).astype(np.uint8)
        img[3:6] = img[2]             # runs that the filters act on
        for filt in (0, 1, 2, 3, 4, [0, 1, 2, 3, 4, 4, 3, 2, 1, 0, 1, 2]):
            files.append(chip_smoke.png_bytes(img if c > 1 else img[..., 0],
                                              filters=filt))
    # a palette with per-entry alpha (shorter than the palette)
    idx = rs.randint(0, 6, (7, 8)).astype(np.uint8)
    palette = rs.randint(0, 256, (6, 3)).astype(np.uint8)
    for filt in range(5):
        files.append(chip_smoke.png_bytes(idx, filters=filt, palette=palette,
                                          trns=[0, 128, 255, 7]))
    for data in files:
        got = decode_png(data)
        ref = _pil_rgba(data)
        assert got.dtype == np.uint8 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
    assert len(files) == 40

    # what is not decoded raises, naming it
    def with_header(depth, ctype, interlace):
        img = _pil_png(rs.randint(0, 256, (4, 4, 3)).astype(np.uint8))
        body = struct.pack(">IIBBBBB", 4, 4, depth, ctype, 0, 0, interlace)
        ihdr = (struct.pack(">I", 13) + b"IHDR" + body
                + struct.pack(">I", zlib.crc32(b"IHDR" + body)))
        return img[:8] + ihdr + img[8 + 25:]

    with pytest.raises(ValueError, match="16-bit samples of colour type 3"):
        decode_png(with_header(16, 3, 0))
    with pytest.raises(ValueError, match="interlace method 2"):
        decode_png(with_header(8, 2, 2))
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(buf, format="JPEG")
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(buf.getvalue())
