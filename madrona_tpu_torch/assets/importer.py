"""Mesh importers: OBJ, glTF 2.0 (.gltf / .glb), MTL and USD dispatch.

Port of ``madrona_tpu/assets/importer.py``, the reference's
``AssetImporter::importFromDisk`` dispatching on the file extension. OBJ
follows the JAX package's Python parser (``_load_obj_py``: 1-based and
negative indices, polygon fan triangulation); the port loads no native
OBJ library. glTF is parsed in Python (data URIs, ``.bin`` buffers and
``.glb``), with its materials and images; an OBJ's ``.mtl`` gives Kd,
Ns and map_Kd. Images are decoded to the bytes of the JAX package's
``PIL.Image.open(...).convert("RGBA")`` without PIL, which the machines
with the card lack: :func:`_decode_image` tries the formats in Pillow's
order by their magic bytes and takes PNG (:func:`.png.decode_png`), JPEG
(:func:`.jpeg.decode_jpeg`), BMP and DIB (:func:`.bmp.decode_bmp`), GIF's
first frame (:func:`.gif.decode_gif`), WebP's first frame
(:func:`.webp.decode_webp`), DDS's first surface (:func:`.dds.decode_dds`),
PBM, PGM, PPM and PFM (:func:`.ppm.decode_ppm`), QOI
(:func:`.qoi.decode_qoi`), ICO and CUR (:func:`.ico.decode_ico`,
:func:`.ico.decode_cur`; tried, as Pillow tries them, before TGA, where a
whole directory lets Pillow take the file), TIFF's first image
(:func:`.tiff.decode_tiff`) and, where no other format takes the file,
TGA by its header checks (:func:`.tga.decode_tga`); see those modules
for the variants each refuses. The other formats Pillow opens (PSD, SGI,
PCX, AVIF, JPEG 2000, ...) raise ``ValueError`` naming the format as
Pillow identifies it; a TGA header that PCX's weak test also takes is
read as TGA.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import struct
from typing import List

import numpy as np

from . import bmp, dds, gif, ico, ppm, qoi, tga, tiff, webp
from .jpeg import MAGIC as JPEG_MAGIC
from .jpeg import decode_jpeg
from .png import SIGNATURE as PNG_SIGNATURE
from .png import decode_png


@dataclasses.dataclass
class ImportedMesh:
    positions: np.ndarray    # [V, 3] f32
    normals: np.ndarray      # [V, 3] f32 (zeros if absent)
    indices: np.ndarray      # [T, 3] i32
    name: str = ""
    uvs: np.ndarray = None   # [V, 2] f32 (None if absent)
    material: int = -1       # index into ImportedAssets.materials


@dataclasses.dataclass
class ImportedMaterial:
    """Base colour, metallic/roughness and an optional base-colour
    texture index (the reference's ``SourceMaterial``)."""

    name: str = ""
    base_color: np.ndarray = None      # [4] RGBA factor
    metallic: float = 0.0
    roughness: float = 1.0
    texture: int = -1                  # index into ImportedAssets.textures

    def __post_init__(self):
        if self.base_color is None:
            self.base_color = np.ones(4, np.float32)


@dataclasses.dataclass
class ImportedTexture:
    """An RGBA8 image (the reference's ``SourceTexture``)."""

    name: str
    data: np.ndarray                   # [H, W, 4] u8


@dataclasses.dataclass
class ImportedAssets:
    """Everything one asset file contributes (the reference's
    ``ImportedAssets``)."""

    meshes: List[ImportedMesh]
    materials: List[ImportedMaterial]
    textures: List[ImportedTexture]


def _u32be(d, o=0):
    return int.from_bytes(d[o:o + 4], "big")


# The formats Pillow 12.1.0 opens after BMP, GIF, JPEG, PNG and WebP, by
# Pillow's order, each with the test of its plugin's _accept (a plugin
# without one, by the test its _open makes first) and the port's decoder,
# or None where the port refuses the format.
_FORMATS = (
    ("AVIF", lambda d: d[4:8] == b"ftyp"
     and d[8:12] in (b"avif", b"avis", b"mif1", b"msf1"), None),
    ("BLP", lambda d: d[:4] in (b"BLP1", b"BLP2"), None),
    ("BUFR", lambda d: d[:4] in (b"BUFR", b"ZCZC"), None),
    ("CUR", ico.accept_cur, ico.decode_cur),
    ("DCX", lambda d: d[:4] == b"\xb1\x68\xde\x3a", None),
    ("DDS", lambda d: d[:4] == dds.MAGIC, dds.decode_dds),
    ("EPS", lambda d: d[:4] == b"%!PS" or d[:4] == b"\xc5\xd0\xd3\xc6", None),
    ("FITS", lambda d: d[:6] == b"SIMPLE", None),
    ("FTEX", lambda d: d[:4] == b"FTEX", None),
    ("GRIB", lambda d: d[:4] == b"GRIB" and d[7:8] == b"\x01", None),
    ("HDF5", lambda d: d[:8] == b"\x89HDF\r\n\x1a\n", None),
    ("JPEG2000", lambda d: d[:4] == b"\xff\x4f\xff\x51"
     or d[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n", None),
    ("ICNS", lambda d: d[:4] == b"icns", None),
    ("ICO", ico.accept_ico, ico.decode_ico),
    ("IM", lambda d: d[:11] == b"Image type:", None),
    ("MPEG", lambda d: d[:4] == b"\x00\x00\x01\xb3", None),
    ("TIFF", tiff.accept, tiff.decode_tiff),
    ("MSP", lambda d: d[:4] in (b"DanM", b"LinS"), None),
    ("PIXAR", lambda d: d[:4] == b"\x80\xe8\x00\x00", None),
    ("PSD", lambda d: d[:4] == b"8BPS", None),
    ("QOI", lambda d: d[:4] == qoi.MAGIC, qoi.decode_qoi),
    ("SUN", lambda d: _u32be(d) == 0x59A66A95, None),
    ("XPM", lambda d: d[:9] == b"/* XPM */", None),
    ("XVTHUMB", lambda d: d[:6] == b"P7 332", None),
    ("XBM", lambda d: d.lstrip()[:7] == b"#define", None),
    ("PPM", ppm.accept, ppm.decode_ppm),
    ("SGI", lambda d: d[:2] == b"\x01\xda", None),
    ("WMF", lambda d: d[:6] == b"\xd7\xcd\xc6\x9a\x00\x00"
     or d[:4] == b"\x01\x00\x00\x00", None),
)
# a weak test that a TGA header can pass: tried after TGA's
_FORMATS_AFTER_TGA = (
    ("PCX", lambda d: d[:1] == b"\x0a" and d[1:2] != b""
     and d[1] in (0, 2, 3, 5), None),
)
_DECODED = ("PNG, JPEG, BMP, TGA, GIF, WebP, DDS, PBM/PGM/PPM/PFM, QOI, "
            "ICO, CUR and TIFF are")


def _decode_as(data, name, table):
    """The texture of the first format of ``table`` whose test takes
    ``data`` (a ValueError naming it where the port refuses it), or None
    where none does."""
    for kind, test, decode in table:
        if test(data):
            if decode is None:
                raise ValueError(f"texture {name!r}: {kind} images are not "
                                 f"decoded ({_DECODED})")
            return ImportedTexture(name, decode(data))
    return None


def _decode_image(data: bytes, name: str = "") -> ImportedTexture:
    """A texture of an image file's bytes, decoded by its magic bytes."""
    data = bytes(data)
    if data.startswith(bmp.MAGIC) or bmp.dib_accept(data):
        return ImportedTexture(name, bmp.decode_bmp(data))
    if data.startswith(gif.MAGICS):
        return ImportedTexture(name, gif.decode_gif(data))
    if data.startswith(JPEG_MAGIC):
        return ImportedTexture(name, decode_jpeg(data))
    if data.startswith(PNG_SIGNATURE):
        return ImportedTexture(name, decode_png(data))
    if webp.accept(data):
        return ImportedTexture(name, webp.decode_webp(data))
    tex = _decode_as(data, name, _FORMATS)
    if tex is None and tga.accept(data):
        tex = ImportedTexture(name, tga.decode_tga(data))
    if tex is None:
        tex = _decode_as(data, name, _FORMATS_AFTER_TGA)
    if tex is None:
        raise ValueError(f"texture {name!r}: not an image file Pillow opens "
                         f"(no magic bytes it knows, not a TGA header; "
                         f"{_DECODED} decoded)")
    return tex


def load_obj(path: str) -> ImportedMesh:
    """Positions and fan-triangulated faces of an OBJ file (normals
    zero, as the JAX package's parser leaves them)."""
    pos: List[List[float]] = []
    tris: List[List[int]] = []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                pos.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                refs = []
                for tok in line.split()[1:]:
                    vi = int(tok.split("/")[0])
                    refs.append(vi - 1 if vi > 0 else len(pos) + vi)
                for k in range(1, len(refs) - 1):
                    tris.append([refs[0], refs[k], refs[k + 1]])
    p = np.asarray(pos, np.float32)
    return ImportedMesh(
        p, np.zeros_like(p), np.asarray(tris, np.int32),
        os.path.basename(path),
    )


# ------------------------------------------------------------------ glTF

_CTYPE = {5120: np.int8, 5121: np.uint8, 5122: np.int16,
          5123: np.uint16, 5125: np.uint32, 5126: np.float32}
_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4}


def load_gltf(path: str) -> List[ImportedMesh]:
    """Geometry-only glTF read (see ``import_assets`` for materials)."""
    return _load_gltf_raw(path)[0]


def _load_gltf_raw(path: str):
    """Minimal glTF 2.0 reader: embedded/.bin buffers, triangle prims,
    UVs + material indices (reference: src/importer/gltf.cpp)."""
    if path.endswith(".glb"):
        with open(path, "rb") as f:
            magic, _ver, _len = struct.unpack("<III", f.read(12))
            if magic != 0x46546C67:
                raise ValueError("not a glb file")
            clen, ctype = struct.unpack("<II", f.read(8))
            doc = json.loads(f.read(clen))
            buffers = []
            while True:
                hdr = f.read(8)
                if len(hdr) < 8:
                    break
                clen, ctype = struct.unpack("<II", hdr)
                buffers.append(f.read(clen))
    else:
        with open(path) as f:
            doc = json.load(f)
        buffers = []
        base = os.path.dirname(path)
        for buf in doc.get("buffers", []):
            uri = buf["uri"]
            if uri.startswith("data:"):
                buffers.append(base64.b64decode(uri.split(",", 1)[1]))
            else:
                with open(os.path.join(base, uri), "rb") as bf:
                    buffers.append(bf.read())

    def read_accessor(idx):
        acc = doc["accessors"][idx]
        view = doc["bufferViews"][acc["bufferView"]]
        dtype = _CTYPE[acc["componentType"]]
        ncomp = _NCOMP[acc["type"]]
        offset = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        data = buffers[view.get("buffer", 0)]
        count = acc["count"]
        stride = view.get("byteStride") or ncomp * np.dtype(dtype).itemsize
        if stride == ncomp * np.dtype(dtype).itemsize:
            arr = np.frombuffer(
                data, dtype, count * ncomp, offset
            ).reshape(count, ncomp)
        else:
            arr = np.zeros((count, ncomp), dtype)
            for i in range(count):
                arr[i] = np.frombuffer(
                    data, dtype, ncomp, offset + i * stride
                )
        return arr

    out = []
    for mesh in doc.get("meshes", []):
        for prim in mesh.get("primitives", []):
            if prim.get("mode", 4) != 4:   # triangles only
                continue
            pos = read_accessor(prim["attributes"]["POSITION"]).astype(
                np.float32
            )
            nrm = (
                read_accessor(prim["attributes"]["NORMAL"]).astype(np.float32)
                if "NORMAL" in prim["attributes"]
                else np.zeros_like(pos)
            )
            uv = (
                read_accessor(
                    prim["attributes"]["TEXCOORD_0"]
                ).astype(np.float32)
                if "TEXCOORD_0" in prim["attributes"]
                else None
            )
            if "indices" in prim:
                idx = read_accessor(prim["indices"]).reshape(-1, 3)
            else:
                idx = np.arange(len(pos), dtype=np.int32).reshape(-1, 3)
            out.append(
                ImportedMesh(
                    pos, nrm, idx.astype(np.int32),
                    mesh.get("name", ""),
                    uvs=uv, material=prim.get("material", -1),
                )
            )
    return out, doc, buffers


def _gltf_materials(doc, buffers, base_dir):
    """Parse glTF materials + decode their images (gltf.cpp's material
    section)."""
    textures = []
    tex_of_image = {}

    def image_texture(img_idx):
        if img_idx in tex_of_image:
            return tex_of_image[img_idx]
        img = doc["images"][img_idx]
        if "uri" in img:
            uri = img["uri"]
            if uri.startswith("data:"):
                data = base64.b64decode(uri.split(",", 1)[1])
            else:
                with open(os.path.join(base_dir, uri), "rb") as f:
                    data = f.read()
        else:
            view = doc["bufferViews"][img["bufferView"]]
            off = view.get("byteOffset", 0)
            data = buffers[view.get("buffer", 0)][
                off:off + view["byteLength"]
            ]
        tex = _decode_image(data, img.get("name", f"image{img_idx}"))
        tex_of_image[img_idx] = len(textures)
        textures.append(tex)
        return tex_of_image[img_idx]

    materials = []
    for m in doc.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        tex = -1
        if "baseColorTexture" in pbr:
            src = doc["textures"][
                pbr["baseColorTexture"]["index"]
            ].get("source")
            if src is not None:
                tex = image_texture(src)
        materials.append(ImportedMaterial(
            name=m.get("name", ""),
            base_color=np.asarray(
                pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32
            ),
            metallic=float(pbr.get("metallicFactor", 1.0)),
            roughness=float(pbr.get("roughnessFactor", 1.0)),
            texture=tex,
        ))
    return materials, textures


def import_from_disk(path: str) -> List[ImportedMesh]:
    """AssetImporter::importFromDisk dispatch (geometry only)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        return [load_obj(path)]
    if ext in (".gltf", ".glb"):
        return load_gltf(path)
    if ext in (".usd", ".usda"):
        from .usd import load_usd

        return load_usd(path)
    raise ValueError(f"unsupported asset format: {ext}")


def _load_obj_mtl(path: str):
    """OBJ sidecar .mtl: Kd, Ns and map_Kd of each material; the mesh's
    first ``usemtl`` wins (reference obj.cpp)."""
    mtllib = None
    usemtl = None
    with open(path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "mtllib" and mtllib is None:
                mtllib = line.split(None, 1)[1].strip()
            elif t[0] == "usemtl" and usemtl is None:
                usemtl = t[1]
    if mtllib is None or usemtl is None:
        return [], [], -1
    mtl_path = os.path.join(os.path.dirname(path), mtllib)
    if not os.path.exists(mtl_path):
        return [], [], -1
    materials, textures = [], []
    cur = None
    sel = -1
    with open(mtl_path) as f:
        for line in f:
            t = line.split()
            if not t:
                continue
            if t[0] == "newmtl":
                cur = ImportedMaterial(name=t[1])
                materials.append(cur)
                if t[1] == usemtl:
                    sel = len(materials) - 1
            elif cur is not None and t[0] == "Kd":
                cur.base_color = np.asarray(
                    [float(t[1]), float(t[2]), float(t[3]), 1.0],
                    np.float32,
                )
            elif cur is not None and t[0] == "Ns":
                # shininess -> rough approximation
                cur.roughness = float(
                    np.clip(1.0 - float(t[1]) / 1000.0, 0.0, 1.0)
                )
            elif cur is not None and t[0] == "map_Kd":
                tex_file = os.path.join(
                    os.path.dirname(mtl_path), line.split(None, 1)[1].strip()
                )
                if os.path.exists(tex_file):
                    with open(tex_file, "rb") as tf:
                        textures.append(
                            _decode_image(tf.read(), os.path.basename(tex_file))
                        )
                    cur.texture = len(textures) - 1
    return materials, textures, sel


def import_assets(path: str) -> ImportedAssets:
    """Full import: geometry + materials + decoded textures (reference
    ``AssetImporter::importFromDisk`` -> ``ImportedAssets``)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".gltf", ".glb"):
        meshes, doc, buffers = _load_gltf_raw(path)
        materials, textures = _gltf_materials(
            doc, buffers, os.path.dirname(path)
        )
        return ImportedAssets(meshes, materials, textures)
    if ext == ".obj":
        mesh = load_obj(path)
        materials, textures, sel = _load_obj_mtl(path)
        mesh.material = sel
        return ImportedAssets([mesh], materials, textures)
    return ImportedAssets(import_from_disk(path), [], [])
