"""The port's TIFF decoder (madrona_tpu_torch.assets.tiff over
native/tiff_decode.cpp) against PIL.Image.open(...).convert("RGBA"),
which the JAX package's importers decode with, byte for byte (no
tolerance), through the importer's dispatch (_decode_image):
  * Pillow's unpackers and conversions, one by one: every rawmode the
    decoder uses on random bytes (all 256 x 256 colour and alpha pairs of
    the associated-alpha modes) against Image.frombytes, and each
    Orientation's transpose;
  * every key of Pillow's OPEN_INFO (120) written by chip_smoke.tiff_bytes
    under no compression, PackBits, LZW and both Deflates, with
    predictors 1-3 where libtiff takes them, in two of whole-image strips,
    4-row strips and 16 x 16 tiles (partial edge tiles), under planar
    configuration 1 and 2, in its own byte order (one little-endian file
    in three a BigTIFF); photometric YCbCr and
    CIELab refused by name (Pillow decodes both: YCbCr through libtiff's
    RGBA path, CIELab through LittleCMS);
  * files PIL writes: every mode it saves as TIFF under each compression
    it writes with and without the horizontal predictor;
  * containers and layouts PIL does not write: BigTIFF (Pillow reads a
    big-endian BigTIFF's header as classic TIFF's, and both refuse it),
    big-endian, several IFDs (the first is read), the IFD before the data, offsets as
    SHORT and LONG8, one BitsPerSample for all samples and more than
    SamplesPerPixel, a per-band SampleFormat, strips out of file order
    and over each other, RowsPerStrip past the height or missing,
    Orientation 1-8 on non-square images and XMP's tiff:Orientation;
  * damaged data and the codecs' edges (both refuse, or both decode the
    same): files cut short, byte counts short or missing, LZW without a
    first clear code, with a code past the table, an early end code, no
    end code, a table run past 4094 without a clear code, old-style LZW
    and an old-style strip after a new-style one, Deflate with a broken
    checksum or cut short, PackBits no-ops and runs past the strip,
    predictors libtiff refuses and the raw path ignores; 400 files with a
    few random bytes changed (where Pillow and libtiff read a damaged
    directory apart: a short read that ends Pillow's IFD, twin tags,
    counts and types libtiff refuses);
  * the compressions the port does not decode, each refused by name;
  * the decoder's g++ build into a fresh directory, and the time of the
    two 1024^2 files chip_smoke.py builds (an RGBA LZW file with predictor
    2 in strips and a 16-bit RGB Deflate file in 256^2 tiles under planar
    configuration 2, their bytes and RGBA by the SHA-256 in the goldens;
    printed with -s).

golden_files() lists the TIFFs (``fmt3_*``) that
tests/goldens/torch_images.npz holds for the card, written with the
others by ``python tests/test_torch_image_decode.py --write-goldens``."""

import hashlib
import io
import os
import struct
import sys
import time
import warnings
import zlib

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

Image = pytest.importorskip("PIL.Image")

import chip_smoke  # noqa: E402
from chip_smoke import lzw_bytes, tiff_bytes  # noqa: E402
from madrona_tpu_torch.assets import native_build, tiff  # noqa: E402
from madrona_tpu_torch.assets.importer import _decode_image  # noqa: E402
from test_torch_image_netpbm_qoi_ico import check, seeded  # noqa: E402

torch.set_num_threads(1)
warnings.simplefilter("ignore")

GOLDENS = os.path.join(ROOT, "tests", "goldens", "torch_images.npz")
DECODE_LIMIT_S = 2.0        # each timed decode on the CPU
# Pillow's names of the compressions the port refuses
REFUSED = {2: "tiff_ccitt", 3: "group3", 4: "group4", 6: "tiff_jpeg",
           7: "jpeg", 32771: "tiff_raw_16", 32809: "tiff_thunderscan",
           34676: "tiff_sgilog", 34677: "tiff_sgilog24", 34925: "lzma",
           50000: "zstd", 50001: "webp"}


def pil_rgba(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def refused_by_name(data, *names):
    with pytest.raises(ValueError) as err:
        _decode_image(data, "t")
    assert "TIFF" in str(err.value)
    for name in names:
        assert name in str(err.value), (name, str(err.value))


def key_samples(rs, key, h, w):
    """Samples [h, w, s] for an OPEN_INFO key and its SampleFormat: floats
    with NaN and values either side of 0 and 255; 32-bit words mostly
    small; 16-bit words a third below 300 (the clip shows)."""
    _, _, sf, _, bps, _ = key
    s, bits, fmt = len(bps), bps[0], sf[0]
    if fmt == 3:
        v = rs.uniform(-50, 300, (h, w, s)).astype(np.float32)
        v.flat[::7] = np.nan
        return v, fmt
    if bits == 32:
        v = rs.randint(-300, 300, (h, w, s)).astype(np.int64)
        v.flat[::5] = rs.randint(-2 ** 31, 2 ** 31 - 1, v.flat[::5].shape)
        return (v if fmt == 2 else v % 2 ** 32), fmt
    if bits == 16 and fmt == 2:
        return rs.randint(-32768, 32768, (h, w, s)), fmt
    if bits == 16:
        v = rs.randint(0, 65536, (h, w, s))
        v.flat[::3] = rs.randint(0, 300, v.flat[::3].shape)
        return v, fmt
    return rs.randint(0, 1 << bits, (h, w, s)), fmt


def key_file(rs, key, h, w, **kw):
    """A file of OPEN_INFO ``key`` of ``h`` x ``w`` seeded samples."""
    order, photo, _, fill, bps, extra = key
    px, fmt = key_samples(rs, key, h, w)
    cmap = (rs.randint(0, 65536, 3 << bps[0]).tolist() if photo == 3
            else None)
    return tiff_bytes(px, bits=bps[0], photo=photo,
                      end="<" if order == b"II" else ">", fill=fill, fmt=fmt,
                      extra=extra or None, colormap=cmap, **kw)


def pil_tiff(img, mode=None, **kw):
    im = Image.fromarray(img)
    if mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "TIFF", **kw)
    return buf.getvalue()


# ---------------------------------------------------------------- goldens

def golden_files():
    """{name: file bytes} of the TIFFs the card decodes (phase 31e of
    chip_smoke.py): the textures of 31e's scene and one file of each
    other class above. (The two 1024^2 files are
    chip_smoke.big_tiff_files().)"""
    rs = np.random.RandomState(20)
    out = {}
    # the scene's textures (chip_smoke.FORMAT3_TEXTURES)
    holes = seeded(24, 32, 4, 31)
    holes[..., 3] = np.where((np.arange(32)[None] // 4 + np.arange(24)[:, None]
                              // 4) % 3 == 0, 0, 255)
    out["fmt3_lzw_rgba"] = tiff_bytes(holes, extra=[2], compression=5,
                                      predictor=2, rows=5)
    out["fmt3_deflate_tiles"] = tiff_bytes(seeded(36, 40, 3, 32),
                                           compression=8, predictor=2,
                                           tile=(16, 16))
    cmap = rs.randint(0, 65536, 48).tolist()
    out["fmt3_packbits_p4"] = tiff_bytes(
        seeded(18, 20, 1, 33) // 16, bits=4, photo=3, colormap=cmap,
        compression=32773)
    rgba16 = seeded(20, 24, 4, 34).astype(np.uint16) * 257
    rgba16[..., :3] = rgba16[..., :3] * (rgba16[..., 3:] / 65535.0)
    out["fmt3_rgba16_planar"] = tiff_bytes(
        rgba16, bits=16, end=">", extra=[1], planar=2, compression=5,
        predictor=2, rows=7)
    out["fmt3_miniswhite_o6"] = tiff_bytes(seeded(18, 30, 1, 35), photo=0,
                                           orientation=6, rows=4)
    # one file of each other class the tests hold
    grey = seeded(12, 16, 1, 36)
    out["fmt3_old_lzw"] = tiff_bytes(grey, photo=1, compression=5,
                                     old_lzw=True)
    out["fmt3_bigtiff"] = tiff_bytes(seeded(12, 16, 3, 37), big=True,
                                     compression=32946)
    out["fmt3_float_p3"] = tiff_bytes(
        rs.uniform(-40, 300, (10, 12, 1)).astype(np.float32), bits=32,
        photo=1, fmt=3, compression=5, predictor=3, rows=3)
    out["fmt3_fill2_lzw"] = tiff_bytes(grey, photo=1, compression=5,
                                       fill=2)
    out["fmt3_raw_tiles_cmyk"] = tiff_bytes(seeded(20, 18, 4, 38), photo=5,
                                            tile=(16, 16))
    out["fmt3_i16b_packbits"] = tiff_bytes(
        rs.randint(0, 600, (9, 11, 1)), bits=16, photo=1, end=">",
        compression=32773)
    out["fmt3_bilevel"] = tiff_bytes(rs.randint(0, 2, (13, 21, 1)), bits=1,
                                     photo=1, compression=32773, rows=5)
    out["fmt3_12bit"] = tiff_bytes(rs.randint(0, 4096, (7, 9, 1)), bits=12,
                                   photo=1)
    out["fmt3_la_planar"] = tiff_bytes(seeded(10, 14, 2, 39), photo=1,
                                       extra=[2], planar=2, compression=8)
    out["fmt3_rgba_o5"] = tiff_bytes(seeded(10, 17, 4, 40), extra=[2],
                                     orientation=5, compression=32773)
    out["fmt3_two_ifds"] = tiff_bytes(
        seeded(8, 12, 3, 41), compression=5,
        then=dict(px=seeded(6, 6, 1, 42), photo=1))
    out["fmt3_pil_lzw_p2"] = pil_tiff(seeded(14, 19, 3, 43),
                                      compression="tiff_lzw",
                                      tiffinfo={317: 2})
    return out


def golden_arrays():
    """The npz's arrays of these files: each file's bytes (``<name>.file``)
    and PIL's RGBA (``<name>.rgba``); for chip_smoke.big_tiff_files() the
    SHA-256 of the file (``<name>.file_sha256``) and of PIL's RGBA
    (``<name>.sha256``) and its shape (``<name>.shape``)."""
    out = {}
    for name, data in golden_files().items():
        out[name + ".file"] = np.frombuffer(data, np.uint8)
        out[name + ".rgba"] = pil_rgba(data)
    for name, data in chip_smoke.big_tiff_files().items():
        rgba = pil_rgba(data)
        out[name + ".file_sha256"] = np.frombuffer(
            hashlib.sha256(data).digest(), np.uint8)
        out[name + ".sha256"] = np.frombuffer(
            hashlib.sha256(rgba.tobytes()).digest(), np.uint8)
        out[name + ".shape"] = np.array(rgba.shape, np.int64)
    return out


# ------------------------------------------------------------------ tests

def test_unpackers_and_transposes_match_pil():
    """Each (mode, rawmode) unpacker the decoder uses, on random rows,
    equals Image.frombytes' image converted to RGBA (every colour and
    alpha pair of the associated-alpha modes); each Orientation's
    transpose equals exif_transpose on a non-square image."""
    rs = np.random.RandomState(0)
    keys = (list(tiff._GREY) + list(tiff._WORDS) + list(tiff._BANDS)
            + list(tiff._PLANE) + [("I;16", "I;12"), ("P", "PX"),
                                   ("LA", "LA"), ("PA", "PA"),
                                   ("RGB", "RGB;R")])
    palette = rs.randint(0, 256, (256, 3)).astype(np.uint8)
    for mode, rawmode in keys:
        bits, fn, band = tiff._unpacker(mode, rawmode)
        w, h = 37, 5
        line = (w * bits + 7) // 8
        rows = rs.randint(0, 256, (h, line)).astype(np.uint8)
        if mode == "F":
            rows = rs.uniform(-50, 300, (h, w)).astype(
                "<f4" if rawmode != "F;32BF" else ">f4").view(
                np.uint8).reshape(h, line)
        im = Image.frombytes(mode, (w, h), rows.tobytes(), "raw", rawmode)
        got = tiff._blank(mode, h, w)
        if band is None:
            got[...] = fn(rows, w)
        else:
            got[..., band] = fn(rows, w)
        if mode in ("P", "PA"):
            im.putpalette(palette.tobytes())
        want = np.asarray(im.convert("RGBA"))
        np.testing.assert_array_equal(
            tiff._to_rgba(got, mode, palette), want,
            err_msg=f"{mode} {rawmode}")
    # every (colour, alpha) pair through the associated-alpha unpackers
    c, a = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    px = np.stack([c, 255 - c, c, a], -1).astype(np.uint8).reshape(1, -1, 4)
    for rawmode, raw in (("RGBa", px), ("RGBa;16L", np.stack(
            [rs.randint(0, 256, px.shape), px], -1).astype(np.uint8)),
                         ("RGBa;16B", np.stack(
            [px, rs.randint(0, 256, px.shape)], -1).astype(np.uint8))):
        im = Image.frombytes("RGBA", (65536, 1), raw.tobytes(), "raw",
                             rawmode)
        got = tiff._unpacker("RGBA", rawmode)[1](
            raw.reshape(1, -1), 65536)
        np.testing.assert_array_equal(got, np.asarray(im), err_msg=rawmode)
    # the rawmodes Pillow has no unpacker for
    for mode, rawmode in (("L", "L;IR"), ("P", "P;1R"), ("P", "P;4R"),
                          ("LA", "L"), ("PA", "A"), ("RGB", "X"),
                          ("RGBA", "a"), ("I;16", "I")):
        assert tiff._unpacker(mode, rawmode) is None
        with pytest.raises(ValueError):
            Image.frombytes(mode, (2, 2), bytes(64), "raw", rawmode)
    # Orientation 1-8 on a non-square image, through the importer
    img = seeded(7, 12, 3, 1)
    for o in range(1, 9):
        data = tiff_bytes(img, orientation=o, compression=5)
        im = Image.open(io.BytesIO(data))
        want = np.asarray(im.convert("RGBA"))
        assert want.shape[:2] == ((12, 7) if o > 4 else (7, 12))
        np.testing.assert_array_equal(_decode_image(data, "o").data, want)


def test_every_open_info_key_matches_pil():
    """All 120 OPEN_INFO keys under every in-slice compression and the
    predictors libtiff takes with it, each in two of the three layouts
    (whole-image strip, 4-row strips, 16 x 16 tiles) under alternating
    planar configurations (each key in its own byte order; one
    little-endian file in three a BigTIFF): PIL's bytes or both refuse;
    YCbCr and CIELab refused by name."""
    rs = np.random.RandomState(1)
    assert len(tiff.OPEN_INFO) == 120
    layouts = ({}, {"rows": 4}, {"tile": (16, 16)})
    files, n = [], 0
    for key in tiff.OPEN_INFO:
        fmt = key[2][0]
        for comp in (1, 5, 8, 32946, 32773):
            for pred in (1, 2, 3):
                if (pred == 3 and fmt != 3) or (pred > 1 and comp in (
                        1, 32773)) or (comp == 32946 and pred == 3):
                    continue
                for k in range(2):
                    n += 1
                    data = key_file(rs, key, 11, 19, compression=comp,
                                    predictor=pred, planar=1 + n % 2,
                                    big=n % 3 == 0 and key[0] == b"II",
                                    **layouts[(n + k) % 3])
                    if key[1] == 6:
                        refused_by_name(data, "YCbCr")
                    elif key[1] == 8:
                        refused_by_name(data, "CIELab")
                    else:
                        files.append(data)
    n_refused = check(files)
    # raw planar data of LA, PA, RGBa and extra samples, libtiff's planes
    # of bits other than 8 and 16, predictors on 1-, 2-, 4- and 12-bit
    # samples: refused by both
    assert 100 < n_refused < len(files) // 4, (n_refused, len(files))


def test_pil_written_files_match_pil():
    """Every mode PIL saves as TIFF, under each compression it writes,
    with and without the horizontal predictor (but on 1-bit data), at odd
    sizes."""
    files = []
    for h, w, seed in ((1, 1, 0), (5, 7, 1), (17, 33, 2)):
        rgb = seeded(h, w, 4, seed)
        for mode in ("1", "L", "LA", "P", "PA", "I", "I;16", "F", "RGB",
                     "RGBA", "CMYK"):
            img = Image.fromarray(rgb).convert(
                "RGBA" if mode in ("LA", "PA") else "RGB")
            im = img.convert(mode)
            for comp in ("raw", "packbits", "tiff_lzw",
                         "tiff_adobe_deflate", "tiff_deflate"):
                for info in ({}, {317: 2}):
                    # (libtiff's encoder refuses the predictor on 1-bit
                    # data, and the next TIFF save in the process crashes)
                    if info and (comp in ("raw", "packbits") or mode == "1"):
                        continue
                    buf = io.BytesIO()
                    try:
                        im.save(buf, "TIFF", compression=comp,
                                tiffinfo=info)
                    except (OSError, ValueError):
                        continue
                    files.append(buf.getvalue())
    assert len(files) > 200
    check(files)


def test_containers_and_layouts_match_pil():
    """BigTIFF and big-endian containers, several IFDs, the IFD first,
    offsets as SHORT and LONG8, one or too many BitsPerSample, a per-band
    SampleFormat, strips out of order and over each other, RowsPerStrip
    past the height or missing, XMP's tiff:Orientation."""
    img, grey = seeded(13, 21, 3, 3), seeded(13, 21, 1, 4)
    files = []
    for end in "<>":
        for big in (False, True):
            for comp in (1, 5, 8, 32773):
                files.append(tiff_bytes(img, end=end, big=big,
                                        compression=comp, rows=5))
                files.append(tiff_bytes(img, end=end, big=big,
                                        compression=comp, ifd_first=True,
                                        then=dict(px=grey, photo=1)))
                files.append(tiff_bytes(
                    img, end=end, big=big, compression=comp,
                    types={273: 3, 279: 3} if not big else {273: 16}))
                files.append(tiff_bytes(img, end=end, compression=comp,
                                        tile=(16, 16), big=big,
                                        types={322: 3, 323: 3}))
    for comp in (1, 5):
        # one BitsPerSample for three samples; four values for three
        files.append(tiff_bytes(img, compression=comp, tags={258: (3, [8])}))
        files.append(tiff_bytes(img, compression=comp,
                                tags={258: (3, [8, 8, 8, 8])}))
        files.append(tiff_bytes(img, compression=comp,
                                tags={339: (3, [1, 1, 1])}))
        files.append(tiff_bytes(img, compression=comp,
                                tags={339: (3, [1, 2, 1])}))
        # RowsPerStrip past the height, and missing
        files.append(tiff_bytes(img, compression=comp,
                                tags={278: (4, [1000])}))
        files.append(tiff_bytes(img, compression=comp, drop=(278,)))
        # a one-value tag given twice, and as a BYTE
        files.append(tiff_bytes(img, compression=comp,
                                tags={277: (3, [3, 9])}))
        files.append(tiff_bytes(img, compression=comp,
                                tags={256: (1, bytes([21]))}))
        # XMP's orientation where the tag is missing, and under the tag
        xmp = b'<x:xmpmeta><rdf:Description tiff:Orientation="7"/>'
        files.append(tiff_bytes(img, compression=comp, tags={700: (1, xmp)}))
        files.append(tiff_bytes(img, compression=comp, orientation=3,
                                tags={700: (1, xmp)}))
        files.append(tiff_bytes(img, compression=comp, orientation=9))
    # raw strips stored out of order, and two strips at one offset (the
    # later tile in file order wins)
    data = bytearray(tiff_bytes(img, rows=4))
    tags = tiff._ifd(bytes(data), "<", False,
                     struct.unpack_from("<L", data, 4)[0])
    offs = list(tags[273])
    for perm in ([3, 1, 2, 0], [0, 0, 2, 3], [0, 1, 2, 2]):
        d = bytearray(data)
        at = d.find(struct.pack("<4L", *offs))
        struct.pack_into("<4L", d, at, *[offs[i] for i in perm])
        files.append(bytes(d))
    # the swapped magic numbers Pillow takes (libtiff does not)
    for magic in (b"MM\x2a\x00", b"II\x00\x2a"):
        for comp in (1, 5):
            d = tiff_bytes(img, end="<" if magic[:2] == b"II" else ">",
                           compression=comp)
            files.append(magic + d[4:])
    assert check(files) < len(files) // 3
    # no IFD, and a directory cut inside its entries
    check([b"II*\0\0\0\0\0", b"MM\0+\0\x08\0\0" + bytes(8),
           tiff_bytes(grey)[:-30]])


def test_damaged_data_and_codec_edges_match_pil():
    """Files cut short, byte counts short or missing, the codecs' edges
    and 400 files with random bytes changed: both refuse, or both decode
    the same."""
    rs = np.random.RandomState(3)
    img = seeded(13, 21, 4, 5)
    files = []
    for comp, pred in ((1, 1), (5, 2), (8, 1), (32773, 1)):
        for layout in ({"rows": 4}, {"tile": (16, 16)}):
            data = tiff_bytes(img, extra=[2], compression=comp,
                              predictor=pred, ifd_first=True, **layout)
            files += [data[:n] for n in (len(data) - 1, len(data) * 2 // 3,
                                         len(data) // 3)]
        # byte counts short by one and by half; missing (one strip, and
        # four strips)
        for cut in (1, 50):
            d = tiff_bytes(img, extra=[2], compression=comp, predictor=pred,
                           rows=13)
            tags = tiff._ifd(d, "<", False, struct.unpack_from("<L", d, 4)[0])
            n = tags[279][0]
            files.append(tiff_bytes(img, extra=[2], compression=comp,
                                    predictor=pred,
                                    tags={279: (4, [max(1, n - cut)])}))
        files.append(tiff_bytes(img, extra=[2], compression=comp,
                                predictor=pred, drop=(279,)))
        files.append(tiff_bytes(img, extra=[2], compression=comp,
                                predictor=pred, rows=4, drop=(279,)))
        # predictors: 2 on 4-bit, 3 on integers, 5; the raw path and
        # PackBits ignore the tag
        files.append(tiff_bytes(img[..., :1] // 16, bits=4, photo=1,
                                compression=comp, tags={317: (3, [2])}))
        files.append(tiff_bytes(img, extra=[2], compression=comp,
                                tags={317: (3, [3])}))
        files.append(tiff_bytes(img, extra=[2], compression=comp,
                                tags={317: (3, [5])}))
    grey = seeded(9, 40, 1, 6)
    raw = grey.tobytes()

    good = lzw_bytes(raw)
    # one strip's stream swapped in by hand: without its first clear code
    # (the 9 bits after it), an early end code, no end code, garbage tail
    files.append(tiff_bytes(grey, photo=1, compression=5))
    body = np.unpackbits(np.frombuffer(good, np.uint8))
    for edit in (body[9:], np.concatenate([body[:9 * 20], np.unpackbits(
            np.frombuffer(struct.pack(">H", 257 << 7), np.uint8))]),
                 body[:-12], np.concatenate([body, np.ones(40, np.uint8)])):
        stream = np.packbits(edit).tobytes()
        files.append(_with_strip(grey, stream))
    # a code past the next free entry
    codes = [256, 65, 66, 300, 257]
    files.append(_with_strip(grey, _pack_codes(codes, 9)))
    # a table run past 4094 without a clear code (libtiff's 1024 spare
    # entries at 12 bits), and past those
    long_src = rs.randint(0, 256, 300 * 40).astype(np.uint8)
    wide = long_src.reshape(300, 40, 1)
    for extra_codes in (900, 1100):
        files.append(_with_strip(wide, _no_clear_lzw(long_src, extra_codes),
                                 photo=1))
    # old-style LZW, in one and several strips; an old-style strip after
    # a new-style one, and the other way
    for rows in (None, 3):
        files.append(tiff_bytes(grey, photo=1, compression=5, old_lzw=True,
                                rows=rows))
        files.append(tiff_bytes(img, extra=[2], compression=5, predictor=2,
                                old_lzw=True, rows=rows, fill=1))
    files.append(_mixed_lzw(grey, old_first=False))
    files.append(_mixed_lzw(grey, old_first=True))
    # Deflate: a broken checksum, cut before it, cut inside the data
    z = zlib.compress(raw)
    for stream in (z[:-4] + bytes(4), z[:-4], z[:len(z) // 2],
                   b"\x78\x9c" + bytes(10)):
        files.append(_with_strip(grey, stream, compression=8))
    # PackBits: no-ops, a run past the strip, a literal past the strip,
    # data that ends inside a literal
    pb = chip_smoke.packbits_bytes(raw)
    for stream in (b"\x80\x80" + pb, pb + b"\xfe\x07", pb[:-1] + b"\x05AB",
                   pb[:-3], bytes([0x81, 9]) * 3):
        files.append(_with_strip(grey, stream, compression=32773))
    # fill order 2 under each codec, and for 1-bit data
    for comp in (1, 5, 8, 32773):
        files.append(tiff_bytes(grey, photo=1, compression=comp, fill=2))
        files.append(tiff_bytes(rs.randint(0, 2, (9, 21, 1)), bits=1,
                                photo=0, compression=comp, fill=2))
    n_refused = check(files)
    assert 30 < n_refused < len(files) - 20, (n_refused, len(files))
    # files with a few random bytes changed (the directory or the data),
    # some cut short
    base = [tiff_bytes(img, extra=[1], compression=comp, planar=planar,
                       end=end, predictor=2 if comp in (5, 8) else 1,
                       **layout)
            for comp in (1, 5, 8, 32773) for planar in (1, 2)
            for end in "<>" for layout in ({"rows": 4}, {"tile": (16, 16)})]
    base += [tiff_bytes(grey, photo=1, compression=5, old_lzw=True, rows=3),
             tiff_bytes(grey // 16, bits=4, photo=3, big=True,
                        colormap=list(range(48)), compression=32773)]
    mutated = []
    for _ in range(400):
        d = bytearray(base[rs.randint(len(base))])
        for pos in rs.randint(0, len(d), rs.randint(1, 5)):
            d[pos] = rs.randint(0, 256)
        mutated.append(bytes(d[:rs.randint(8, len(d))] if rs.rand() < 0.1
                             else d))
    check(mutated)


def _pack_codes(codes, nbits):
    bits = np.concatenate([np.unpackbits(np.frombuffer(
        struct.pack(">H", c << (16 - nbits)), np.uint8))[:nbits]
        for c in codes])
    return np.packbits(bits).tobytes()


def _no_clear_lzw(data, past):
    """LZW of ``data`` whose encoder, where its table reaches 4094, writes
    ``past`` more 12-bit codes before its clear code (libtiff's decoder
    keeps adding entries there, 1024 past 4095 at most)."""
    codes, widths = [256], [9]
    table, free, nbits, w, extra = {}, 258, 9, -1, 0
    for c in bytes(data):
        if w < 0:
            w = c
            continue
        k = (w << 8) | c
        if k in table:
            w = table[k]
            continue
        codes.append(w)
        widths.append(nbits)
        w = c
        if free < 4094:
            table[k] = free
            free += 1
            if free > (1 << nbits) - 1:
                nbits += 1
        else:
            extra += 1
            if extra == past:
                codes.append(256)
                widths.append(12)
                table.clear()
                free, nbits, extra = 258, 9, 0
    codes += [w, 257]
    widths += [nbits, nbits]
    bits = np.concatenate([np.unpackbits(np.frombuffer(struct.pack(
        ">H", c << (16 - n)), np.uint8))[:n] for c, n in zip(codes, widths)])
    return np.packbits(bits).tobytes()


def _with_strip(px, stream, compression=5, photo=1):
    """A one-strip TIFF of 8-bit samples of ``px``'s size whose strip is
    ``stream``."""
    h, w, s = px.shape
    body = bytearray(b"II*\0\0\0\0\0")
    body += stream + (b"\0" if len(stream) % 2 else b"")
    ifd = len(body)
    entries = [(256, 4, w), (257, 4, h), (258, 3, 8), (259, 3, compression),
               (262, 3, photo), (273, 4, 8), (277, 3, s), (278, 4, h),
               (279, 4, len(stream))]
    body += struct.pack("<H", len(entries))
    for t, typ, v in entries:
        body += struct.pack("<HHL", t, typ, 1) + struct.pack(
            "<H2x" if typ == 3 else "<L", v)
    body += bytes(4)
    struct.pack_into("<L", body, 4, ifd)
    return bytes(body)


def _mixed_lzw(px, old_first):
    """A two-strip LZW TIFF whose strips are old-style and new-style
    codes."""
    h, w, _ = px.shape
    half = (h + 1) // 2
    a = lzw_bytes(px[:half].tobytes(), old_first)
    b = lzw_bytes(px[half:].tobytes(), not old_first)
    body = bytearray(b"II*\0\0\0\0\0")
    starts = []
    for s in (a, b):
        starts.append(len(body))
        body += s + (b"\0" if len(s) % 2 else b"")
    off = len(body)
    body += struct.pack("<2L", *starts) + struct.pack("<2L", len(a), len(b))
    ifd = len(body)
    entries = [(256, 4, 1, w), (257, 4, 1, h), (258, 3, 1, 8),
               (259, 3, 1, 5), (262, 3, 1, 1), (273, 4, 2, off),
               (278, 4, 1, half), (279, 4, 2, off + 8)]
    body += struct.pack("<H", len(entries))
    for t, typ, n, v in entries:
        body += struct.pack("<HHL", t, typ, n) + struct.pack(
            "<H2x" if typ == 3 else "<L", v)
    body += bytes(4)
    struct.pack_into("<L", body, 4, ifd)
    return bytes(body)


def test_out_of_slice_variants_refused_by_name():
    """Every compression the port does not decode raises ValueError
    naming TIFF and Pillow's name for it (PIL's own JPEG and Group 4
    TIFFs too); photometric YCbCr and CIELab by theirs."""
    img = seeded(8, 16, 3, 7)
    for code, name in REFUSED.items():
        refused_by_name(tiff_bytes(img, tags={259: (3, [code])}), "TIFF",
                        name)
    refused_by_name(pil_tiff(img, compression="jpeg"), "jpeg")
    refused_by_name(pil_tiff(img, "1", compression="group4"), "group4")
    refused_by_name(pil_tiff(img, "YCbCr"), "YCbCr")
    refused_by_name(pil_tiff(img, "LAB"), "CIELab")
    refused_by_name(tiff_bytes(img, tags={259: (3, [99])}), "compression 99")


def test_decoder_builds_from_source(tmp_path, monkeypatch):
    """The TIFF codecs' library is built by g++ from
    native/tiff_decode.cpp into the build directory, keyed by a hash of
    the source and flags, and decodes there."""
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tiff, "_LIB", None)
    lib = native_build.library_path(tiff.SOURCE)
    assert lib.parent == tmp_path and not lib.exists()
    files = golden_files()
    for name in ("fmt3_lzw_rgba", "fmt3_packbits_p4", "fmt3_float_p3"):
        np.testing.assert_array_equal(
            _decode_image(files[name], name).data, pil_rgba(files[name]))
    assert [p.name for p in tmp_path.iterdir()] == [lib.name]


def test_decode_time_1024():
    """chip_smoke.py's two 1024^2 TIFFs: their bytes and RGBA equal to
    the goldens' SHA-256 (PIL's RGBA), each decoded in under 2 s on the
    CPU (the best of 3 calls, printed)."""
    with np.load(GOLDENS) as z:
        for name, data in chip_smoke.big_tiff_files().items():
            assert hashlib.sha256(data).digest() == bytes(
                z[name + ".file_sha256"])
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                got = _decode_image(data, name).data
                best = min(best, time.perf_counter() - t0)
            assert got.shape == tuple(z[name + ".shape"])
            assert hashlib.sha256(got.tobytes()).digest() == bytes(
                z[name + ".sha256"])
            print(f"{name} ({len(data)} bytes): {best * 1e3:.2f} ms on the "
                  "CPU")
            assert best < DECODE_LIMIT_S
