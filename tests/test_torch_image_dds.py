"""The port's DDS decoder (madrona_tpu_torch.assets.dds over
native/bcn_decode.cpp) against PIL.Image.open(...).convert("RGBA"),
which the JAX package's importers decode with, byte for byte (no
tolerance), through the importer's dispatch (_decode_image):
  * files PIL writes from seeded images: L, LA, RGB and RGBA, DXT1 (with
    punch-through alpha), DXT3, DXT5, BC2, BC3 and BC5, at sizes that are
    not multiples of 4;
  * files this module writes (chip_smoke.dds_bytes) around random blocks,
    4096 or more of each format: BC1-BC5 under every fourcc and DXGI code
    Pillow takes, BC5S, BC6H UF16 and SF16 with each of the 14 modes
    forced by its leading bits (and the reserved codes), 4096 of each,
    BC7 with each of its 8 modes forced (and the reserved mode byte 0),
    4096 of each;
  * uncompressed layouts: dds_rgb with 3 and 4 masks at 0 to 48 bits,
    masks padded with zeros (0b1100 ...), gaps inside a mask and zero
    masks, data cut short (read as zeros, as Pillow reads it); 8-bit
    luminance, 16-bit luminance with alpha, 8-bit palettes with their
    alpha, DX10 R8G8B8A8 typeless, unorm and sRGB;
  * odd sizes (1 x 1 to 30 x 18), mip chains and array slices after the
    first surface, and files cut short (refused by both);
  * every fourcc and DXGI format Pillow refuses, and the formats the port
    still refuses, each with a ValueError naming it;
  * the decoder's g++ build into a fresh directory, and the time of the
    two 1024^2 files chip_smoke.py builds (a BC7 and a BC1 of random
    blocks, their bytes and RGBA by the SHA-256 in the goldens; printed
    with -s).

golden_files() lists the DDS, PBM/PGM/PPM/PFM, QOI and ICO/CUR files
(``fmt2_*``) that tests/goldens/torch_images.npz holds for the card,
written with the others by ``python tests/test_torch_image_decode.py
--write-goldens``."""

import hashlib
import io
import os
import re
import struct
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

Image = pytest.importorskip("PIL.Image")

import chip_smoke  # noqa: E402
from chip_smoke import dds_bytes  # noqa: E402
from madrona_tpu_torch.assets import dds, native_build  # noqa: E402
from madrona_tpu_torch.assets.importer import _decode_image  # noqa: E402
from test_torch_image_netpbm_qoi_ico import (  # noqa: E402
    check, dib_frame, icon_dir, pil_file, pil_rgba, plain_with_comments,
    pnm, pfm, qoi_header, qoi_stream, seeded)

GOLDENS = os.path.join(ROOT, "tests", "goldens", "torch_images.npz")
DECODE_LIMIT_S = 2.0        # each timed decode on the CPU

# name -> (header arguments, bytes a block)
BLOCK_FORMATS = {
    "DXT1": ({"fourcc": b"DXT1"}, 8), "DXT3": ({"fourcc": b"DXT3"}, 16),
    "DXT5": ({"fourcc": b"DXT5"}, 16), "BC4U": ({"fourcc": b"BC4U"}, 8),
    "ATI1": ({"fourcc": b"ATI1"}, 8), "BC5U": ({"fourcc": b"BC5U"}, 16),
    "ATI2": ({"fourcc": b"ATI2"}, 16), "BC5S": ({"fourcc": b"BC5S"}, 16),
    "BC1_TYPELESS": ({"dxgi": 70}, 8), "BC1_UNORM": ({"dxgi": 71}, 8),
    "BC2_TYPELESS": ({"dxgi": 73}, 16), "BC2_UNORM": ({"dxgi": 74}, 16),
    "BC3_TYPELESS": ({"dxgi": 76}, 16), "BC3_UNORM": ({"dxgi": 77}, 16),
    "BC4_TYPELESS": ({"dxgi": 79}, 8), "BC4_UNORM": ({"dxgi": 80}, 8),
    "BC5_TYPELESS": ({"dxgi": 82}, 16), "BC5_UNORM": ({"dxgi": 83}, 16),
    "BC5_SNORM": ({"dxgi": 84}, 16), "BC6H_UF16": ({"dxgi": 95}, 16),
    "BC6H_SF16": ({"dxgi": 96}, 16), "BC7_TYPELESS": ({"dxgi": 97}, 16),
    "BC7_UNORM": ({"dxgi": 98}, 16), "BC7_UNORM_SRGB": ({"dxgi": 99}, 16),
}
ACCEPTED_DXGI = {27, 28, 29} | {v[0]["dxgi"] for v in BLOCK_FORMATS.values()
                                if "dxgi" in v[0]}


def blocks(rs, n, size):
    return rs.randint(0, 256, (n, size)).astype(np.uint8)


def bc6h_modes(rs, n):
    """[16 * n, 16] random BC6H blocks: n of each of the 14 modes and of
    the 4 reserved codes, forced by the leading 2 or 5 bits."""
    out = []
    codes = [(m, 2) for m in (0, 1)] + [((m << 2) | 2, 5) for m in range(8)]
    codes += [((m << 2) | 3, 5) for m in range(8)]
    for code, nbits in codes:
        b = blocks(rs, n, 16)
        b[:, 0] = (b[:, 0] & ~np.uint8((1 << nbits) - 1)) | code
        out.append(b)
    return np.concatenate(out)


def bc7_modes(rs, n):
    """[9 * n, 16] random BC7 blocks: n of each mode 0-7 (its bit the
    first set) and of the reserved mode byte 0."""
    out = []
    for m in range(9):
        b = blocks(rs, n, 16)
        b[:, 0] = ((b[:, 0] & ~np.uint8((2 << m) - 1)) | (1 << m)
                   if m < 8 else 0)
        out.append(b)
    return np.concatenate(out)


def surface(w, h, body, **kw):
    """A DDS file whose surface is ``body`` [n, block] blocks, in rows of
    ceil(w / 4)."""
    return dds_bytes(w, h, np.ascontiguousarray(body).tobytes(), **kw)


def pil_dds(img, mode=None, **kw):
    return pil_file(img, "DDS", mode, **kw)


def rgb_layouts(rs):
    """dds_rgb files: (bit count, masks) with 3 and 4 masks."""
    layouts = [
        (16, (0xF800, 0x7E0, 0x1F, 0)), (16, (0x7C00, 0x3E0, 0x1F, 0x8000)),
        (16, (0xF00, 0xF0, 0xF, 0xF000)), (8, (0xE0, 0x1C, 0x3, 0)),
        (32, (0x3FF00000, 0xFFC00, 0x3FF, 0xC0000000)),
        (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
        (24, (0xFF, 0xFF00, 0xFF0000, 0)), (16, (0b1100, 0b110000, 0b101, 0)),
        (48, (0xFF, 0, 0xFF000000, 0xFFFF00)), (0, (0xFF, 0xFF, 0xFF, 0)),
        (12, (0xF, 0xF0, 0xF00, 0)), (32, (0x1, 0x80000000, 0x7FFE, 0x18000)),
        (8, (0, 0, 0, 0))]
    files = []
    for bits, masks in layouts:
        for alpha in (0, 1):
            for w, h in ((11, 13), (1, 1), (5, 2)):
                n = bits // 8 * w * h
                body = blocks(rs, 1, n + 3)[0].tobytes()
                kw = dict(pfflags=0x40 | alpha, bitcount=bits, masks=masks)
                files.append(dds_bytes(w, h, body[:n], **kw))
                files.append(dds_bytes(w, h, body[:n // 2], **kw))
                files.append(dds_bytes(w, h, body, **kw))
    return files


# ---------------------------------------------------------------- tests

def test_pil_written_dds_match_pil():
    """PIL's own DDS files at every mode and pixel format it writes, at
    sizes that are not multiples of 4: equal to PIL's RGBA."""
    files = []
    for h, w in ((1, 1), (3, 5), (13, 11), (18, 30), (32, 32), (4, 4)):
        for kind, seed in (("noise", h), ("smooth", w)):
            img = seeded(h, w, 4, seed, kind)
            alpha = img.copy()
            alpha[..., 3] = np.where(img[..., 0] > 128, 255, 0)
            for mode in ("L", "LA", "RGB", "RGBA"):
                files.append(pil_dds(img, mode))
            for pf in ("DXT1", "DXT3", "DXT5", "BC2", "BC3"):
                files.append(pil_dds(img, pixel_format=pf))
            files.append(pil_dds(alpha, pixel_format="DXT1"))
            files.append(pil_dds(img[..., :3], pixel_format="BC5"))
    assert check(files) == 0
    punch = pil_rgba(files[-2])
    assert (punch[..., 3] == 0).any()


def test_block_formats_match_pil():
    """Random blocks, 4096 or more of each: BC1-BC5 and BC5S under every
    fourcc and DXGI code Pillow takes, BC6H UF16 and SF16 with 4096 of each
    mode and reserved code forced, BC7 with each mode and the reserved
    mode byte forced (4096 of each under BC7_UNORM): equal to PIL's
    RGBA."""
    rs = np.random.RandomState(11)
    files = []
    for name, (kw, size) in BLOCK_FORMATS.items():
        if name.startswith("BC6H"):
            body = bc6h_modes(rs, 4096)                 # of each mode
        elif name.startswith("BC7"):
            body = bc7_modes(rs, 4096 if name == "BC7_UNORM" else 512)
        else:
            body = blocks(rs, 4096, size)
        files.append(surface(256, len(body) // 64 * 4, body, **kw))
    assert check(files) == 0


def test_uncompressed_layouts_match_pil():
    """dds_rgb with 3 and 4 masks at 0 to 48 bits (padded masks, gaps
    inside masks, zero masks, data cut short), 8-bit luminance, 16-bit
    luminance with alpha, 8-bit palettes and DX10 R8G8B8A8 (typeless,
    unorm, sRGB): equal to PIL's RGBA, or refused by both."""
    rs = np.random.RandomState(12)
    files = rgb_layouts(rs)
    for w, h in ((11, 13), (1, 1), (4, 7)):
        px = blocks(rs, 1, 4 * w * h)[0].tobytes()
        files.append(dds_bytes(w, h, px[:w * h], pfflags=0x20000,
                               bitcount=8))
        files.append(dds_bytes(w, h, px[:2 * w * h], pfflags=0x20001,
                               bitcount=16))
        pal = blocks(rs, 1, 1024)[0].tobytes()
        files.append(dds_bytes(w, h, pal + px[:w * h], pfflags=0x20,
                               bitcount=8))
        for fmt in (27, 28, 29):
            files.append(dds_bytes(w, h, px, dxgi=fmt))
    assert check(files) == 0


def test_odd_sizes_mips_and_truncation_match_pil():
    """Every block format at sizes that are not multiples of 4, with mip
    chains and array slices after the first surface, and cut short
    (refused by both, as Pillow finds the file truncated)."""
    rs = np.random.RandomState(13)
    files, cut = [], []
    for name, (kw, size) in BLOCK_FORMATS.items():
        for w, h in ((1, 1), (5, 3), (30, 18), (7, 13)):
            n = ((w + 3) // 4) * ((h + 3) // 4)
            body = (bc7_modes(rs, 1)[rs.randint(0, 9, n)]
                    if name.startswith("BC7") else blocks(rs, n, size))
            mips = blocks(rs, n // 2 + 3, size)
            files.append(surface(w, h, body, **kw))
            files.append(surface(w, h, np.concatenate([body, mips]),
                                 mips=4, **kw))
            cut.append(surface(w, h, body, **kw)[:-1])
    assert check(files) == 0
    assert check(cut) == len(cut)


def test_refused_variants_name_themselves():
    """Every DXGI format and fourcc Pillow refuses, luminance it does not
    take, unknown pixel flags and header sizes raise ValueError naming DDS
    and the format; formats Pillow opens that the port does not decode
    raise ValueError naming the format as Pillow identifies it."""
    rs = np.random.RandomState(14)
    body = blocks(rs, 1, 4096)[0].tobytes()
    refused = {f"DXGI format {f}": dds_bytes(8, 8, body, dxgi=f)
               for f in list(range(133)) + [189, 190]
               if f not in ACCEPTED_DXGI}
    for fourcc in (b"DXT2", b"DXT4", b"BC4S", b"RGBG", b"GRGB", b"YUY2",
                   b"UYVY", b"MET1", b"\x24\0\0\0", b"\x71\0\0\0"):
        code = struct.unpack("<I", fourcc)[0]
        refused[f"({code})"] = dds_bytes(8, 8, body, fourcc=fourcc)
    refused["luminance at 16 bits"] = dds_bytes(8, 8, body, pfflags=0x20000,
                                                bitcount=16)
    refused["luminance at 24 bits"] = dds_bytes(8, 8, body, pfflags=0x20001,
                                                bitcount=24)
    refused["flags 0x2"] = dds_bytes(8, 8, body, pfflags=0x2, bitcount=8)
    refused["header size 100"] = (b"DDS " + struct.pack("<I", 100)
                                  + dds_bytes(8, 8, body)[8:])
    for what, data in refused.items():
        with pytest.raises(Exception):
            pil_rgba(data)
        with pytest.raises(ValueError, match=re.escape(what)) as err:
            _decode_image(data, what)
        assert "DDS" in str(err.value)
    img = seeded(16, 16, 3, 0)
    others = {"TIFF": pil_file(img, "TIFF"), "PCX": pil_file(img, "PCX"),
              "SGI": pil_file(img, "SGI"), "IM": pil_file(img, "IM"),
              "JPEG2000": pil_file(img, "JPEG2000"),
              "PSD": (b"8BPS" + struct.pack(">H6xHIIHH", 1, 3, 16, 16, 8, 3)
                      + struct.pack(">IIIH", 0, 0, 0, 0)
                      + img.transpose(2, 0, 1).tobytes())}
    for name, data in others.items():
        assert Image.open(io.BytesIO(data)).format == name
        with pytest.raises(ValueError, match=re.escape(name)):
            _decode_image(data, name)


def test_bcn_decoder_builds_from_source(tmp_path, monkeypatch):
    """The block decoder's library is built by g++ from
    native/bcn_decode.cpp into the build directory, keyed by a hash of
    the source and flags, and decodes there."""
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(dds, "_LIB", None)
    lib = native_build.library_path(dds.SOURCE)
    assert lib.parent == tmp_path and not lib.exists()
    data = golden_files()["fmt2_dds_bc7_mips"]
    np.testing.assert_array_equal(dds.decode_dds(data), pil_rgba(data))
    assert [p.name for p in tmp_path.iterdir()] == [lib.name]


def test_decode_time_1024():
    """chip_smoke.py's 1024^2 BC7 and BC1 files: their bytes and the
    port's RGBA equal to the SHA-256s in the goldens (PIL's RGBA), each
    decoded in under 2 s on the CPU (the best of 3 calls, printed)."""
    with np.load(GOLDENS) as z:
        for name, data in chip_smoke.big_dds_files().items():
            assert hashlib.sha256(data).digest() == bytes(
                z[name + ".file_sha256"])
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                got = _decode_image(data, name).data
                best = min(best, time.perf_counter() - t0)
            assert hashlib.sha256(got.tobytes()).digest() == bytes(
                z[name + ".sha256"])
            print(f"{name} ({len(data)} bytes): {best * 1e3:.2f} ms on the "
                  "CPU")
            assert best < DECODE_LIMIT_S


# --------------------------------------------------------------- goldens

def golden_files():
    """{name: file bytes} of the files the card decodes (phase 31d of
    chip_smoke.py): the textures of 31d's scene and one file of each
    other class of DDS, Netpbm, QOI, ICO and CUR. (The two 1024^2 DDS
    files are chip_smoke.big_dds_files().)"""
    rs = np.random.RandomState(19)
    out = {}
    # the scene's textures (chip_smoke.FORMAT2_TEXTURES)
    holes = seeded(24, 32, 4, 21)
    holes[..., 3] = np.where((np.arange(32)[None] // 4 + np.arange(24)[:, None]
                              // 4) % 3 == 0, 0, 255)
    out["fmt2_dds_bc1_alpha"] = pil_dds(holes, pixel_format="DXT1")
    mips = [bc7_modes(rs, 8)[rs.randint(0, 72, (s + 3) // 4 * ((s + 3) // 4))]
            for s in (32, 16, 8, 4, 2, 1)]
    out["fmt2_dds_bc7_mips"] = surface(32, 32, np.concatenate(mips),
                                       dxgi=98, mips=6)
    out["fmt2_qoi"] = pil_file(seeded(20, 24, 4, 22), "QOI")
    out["fmt2_dds_bc3_30x18"] = pil_dds(seeded(18, 30, 4, 23),
                                        pixel_format="BC3")
    out["fmt2_ppm_1023"] = pnm(b"P6", 26, 22, 1023,
                               rs.randint(0, 1024, (22, 26, 3)))
    # one of each other class the tests hold
    out["fmt2_dds_bc6h_uf16"] = surface(16, 16, bc6h_modes(rs, 1)[:16],
                                        dxgi=95)
    out["fmt2_dds_bc6h_sf16"] = surface(16, 16, bc6h_modes(rs, 1)[2:],
                                        dxgi=96)
    out["fmt2_dds_bc7_modes"] = surface(12, 12, bc7_modes(rs, 1), dxgi=99)
    out["fmt2_dds_bc5s"] = surface(8, 8, blocks(rs, 4, 16), fourcc=b"BC5S")
    out["fmt2_dds_bc4"] = surface(7, 5, blocks(rs, 4, 8), fourcc=b"ATI1")
    out["fmt2_dds_bc2"] = pil_dds(seeded(6, 10, 4, 24), pixel_format="BC2")
    out["fmt2_dds_rgb565"] = dds_bytes(
        9, 7, blocks(rs, 1, 126)[0].tobytes(), pfflags=0x40, bitcount=16,
        masks=(0xF800, 0x7E0, 0x1F, 0))
    out["fmt2_dds_padded_masks"] = dds_bytes(
        9, 7, blocks(rs, 1, 126)[0].tobytes(), pfflags=0x41, bitcount=16,
        masks=(0b1100, 0b110000, 0b101, 0xF000))
    out["fmt2_dds_pal8"] = dds_bytes(
        9, 7, blocks(rs, 1, 1024 + 63)[0].tobytes(), pfflags=0x20,
        bitcount=8)
    out["fmt2_dds_la"] = pil_dds(seeded(7, 9, 4, 25), "LA")
    out["fmt2_dds_rgba_srgb"] = dds_bytes(
        5, 4, blocks(rs, 1, 80)[0].tobytes(), dxgi=29)
    out["fmt2_pbm_plain"] = plain_with_comments(
        b"P1", 11, 5, None, rs.randint(0, 2, (5, 11)), rs)
    out["fmt2_pgm_1000"] = plain_with_comments(
        b"P2", 12, 5, 1000, rs.randint(0, 1001, (5, 12)), rs)
    out["fmt2_pgm_65535"] = pnm(b"P5", 9, 4, 65535,
                                rs.randint(0, 65536, (4, 9)))
    out["fmt2_pfm_le"] = pfm(6, 4, -1.0, np.concatenate(
        [[0.6, 1.5, 254.5, 300.0, -0.5, np.nan], rs.uniform(-20, 280, 18)]))
    out["fmt2_pfm_be"] = pfm(6, 4, 2.0, rs.uniform(-20, 280, 24))
    out["fmt2_p0cmyk"] = pnm(b"P0CMYK", 5, 4, 255,
                             rs.randint(0, 256, (4, 5, 4)))
    out["fmt2_qoi_ops"] = qoi_header(9, 7, 4) + qoi_stream(rs, 80)
    out["fmt2_ico_png"] = pil_file(seeded(32, 32, 4, 26), "ICO",
                                   sizes=[(16, 16), (32, 32)])
    out["fmt2_ico_bmp"] = icon_dir([
        (8, 8, 0, 8, dib_frame(rs, 8, 8, 8)),
        (12, 10, 0, 4, dib_frame(rs, 12, 10, 4)),
        (12, 10, 0, 24, dib_frame(rs, 12, 10, 24)),
        (6, 6, 0, 32, dib_frame(rs, 6, 6, 32))])
    out["fmt2_ico_bmp32"] = pil_file(seeded(16, 16, 4, 28), "ICO",
                                     sizes=[(16, 16)], bitmap_format="bmp")
    out["fmt2_cur"] = icon_dir([(9, 6, 0, 24, dib_frame(rs, 9, 6, 24)),
                                (13, 7, 0, 8, dib_frame(rs, 13, 7, 8))],
                               kind=2)
    return out


def golden_arrays():
    """The npz's arrays of these files: each file's bytes (``<name>.file``)
    and PIL's RGBA (``<name>.rgba``); for chip_smoke.big_dds_files() the
    SHA-256 of the file (``<name>.file_sha256``) and of PIL's RGBA
    (``<name>.sha256``) and its shape (``<name>.shape``)."""
    out = {}
    for name, data in golden_files().items():
        out[name + ".file"] = np.frombuffer(data, np.uint8)
        out[name + ".rgba"] = pil_rgba(data)
    for name, data in chip_smoke.big_dds_files().items():
        rgba = pil_rgba(data)
        out[name + ".file_sha256"] = np.frombuffer(
            hashlib.sha256(data).digest(), np.uint8)
        out[name + ".sha256"] = np.frombuffer(
            hashlib.sha256(rgba.tobytes()).digest(), np.uint8)
        out[name + ".shape"] = np.array(rgba.shape, np.int64)
    return out
