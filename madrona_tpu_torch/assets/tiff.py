"""TIFF decoding to RGBA8, as Pillow reads it.

The JAX package decodes textures with ``PIL.Image.open(...).convert(
"RGBA")``. :func:`decode_tiff` gives the same bytes for the TIFFs
Pillow 12.1.0 opens (``TiffImagePlugin``) whose compression is none (1),
PackBits (32773), LZW (5) or Deflate (8, 32946):

* the container: classic TIFF in either byte order, little-endian
  BigTIFF (Pillow tells BigTIFF by the third byte, so it reads a
  big-endian BigTIFF's header as classic TIFF's, finds no IFD there and
  refuses it, and so does this module), and the two swapped magic
  numbers Pillow takes; the first IFD only, its tags
  read as Pillow's ``ImageFileDirectory_v2`` reads them (an entry whose
  data lies past the file's end is dropped, a directory cut short keeps
  the entries before the cut, a one-value tag takes the first of many);
* the pixel mode from :data:`OPEN_INFO`, Pillow's table keyed by byte
  order, photometric, sample format, fill order, bits and extra samples
  (a per-band sample format of all 1s counts as one; BitsPerSample
  stretched or cut to SamplesPerPixel), and each mode converted to RGBA
  as Pillow converts it: ``1`` and ``L`` grey; ``I;16`` and ``I`` clipped
  to 255; ``F`` truncated into [0, 255]; ``P`` and ``PA`` through the
  ColorMap's high bytes; ``LA``; ``RGB`` and ``RGBX`` opaque; ``RGBA``;
  ``CMYK`` through Pillow's ``cmyk2rgb``; 16-bit colour by each sample's
  high byte; ``RGBa`` (associated alpha) un-premultiplied by Pillow's
  unpacker (``c * 255 // a``, clipped);
* uncompressed data as Pillow's own raw decoder reads it, tile by tile
  in file order (a later tile over an earlier one wins): a strip or tile
  a row of the rawmode's bytes a line, partial right-edge tiles at the
  full tile's stride, and under planar configuration 2 one band a layer,
  unpacked with the rawmode's letter for that layer (16-bit planes read
  as 8-bit, and ``LA``, ``PA`` and the ``;R`` modes that Pillow cannot
  unpack refused); the predictor is not applied;
* compressed data as Pillow's libtiff decoder (libtiff 4.7) reads it:
  each strip or tile decompressed (bits reversed first where FillOrder is
  2; LZW, old-style LZW where the first chunk begins with its codes,
  PackBits, zlib), the predictor undone (2 on 8-, 16- and 32-bit samples
  after the byte swap; 3 on 32-bit floats, whose result stays in the
  host's order), 16- and 32-bit samples of big-endian files swapped to
  the host's order, then unpacked with Pillow's rawmode as it rewrites it
  (16-bit modes read in the host's order, so big-endian ``I;16BS``,
  ``I;32BS`` and ``F;32BF`` come out byte-swapped, as in Pillow); under
  planar configuration 2 each plane of an image of more than one band is
  copied into its band (8 or 16 bits, the high byte), alpha into the
  second band of ``LA`` and ``PA`` (so their alpha is 0), planar RGBA
  un-premultiplied unless ExtraSamples says unassociated; libtiff reads
  the IFD again by its own rules (:func:`_libtiff_tags`: the first of
  twin tags, strict sizes and sample counts, a usable ColorMap for a
  palette under 8 bits, byte counts estimated where missing), and
  Pillow's decoder refuses interleaved samples that do not add up to its
  mode's bits;
* the Orientation tag (or XMP's ``tiff:Orientation`` where the tag is
  absent) applied after the decode as ``ImageOps.exif_transpose``.

Where each step runs: the IFD, the layout, zlib, the unpacking and the
conversions in numpy and Python; LZW, PackBits and the predictors in
``native/tiff_decode.cpp``, built with g++ at first use by
:mod:`.native_build` and bound with ctypes (without g++ it raises).

Refused with ``ValueError`` naming TIFF as Pillow refuses them: no first
IFD, missing or invalid sizes, an unknown pixel mode, a palette without
a ColorMap, LAB (``convert`` has no LAB to RGBA), data that ends early
or does not decode, a predictor libtiff cannot undo. The compressions
this module does not decode (2, 3, 4, 6, 7, 32771, 32809, 34676, 34677,
34925, 50000, 50001) and photometric YCbCr raise ``ValueError`` naming
TIFF and Pillow's name for them; so does a missing StripByteCounts of a
compressed image with more than one strip (libtiff estimates those).
"""

from __future__ import annotations

import ctypes
import re
import struct
import zlib

import numpy as np

from . import native_build
from .dds import MAX_PIXELS
from .ppm import _cmyk2rgb

SOURCE = native_build.NATIVE / "tiff_decode.cpp"
MAGICS = (b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00", b"II\x00\x2a",
          b"MM\x00\x2b", b"II\x2b\x00")

# Pillow's COMPRESSION_INFO: tag value -> its name
COMPRESSION_INFO = {
    1: "raw", 2: "tiff_ccitt", 3: "group3", 4: "group4", 5: "tiff_lzw",
    6: "tiff_jpeg", 7: "jpeg", 8: "tiff_adobe_deflate", 32771: "tiff_raw_16",
    32773: "packbits", 32809: "tiff_thunderscan", 32946: "tiff_deflate",
    34676: "tiff_sgilog", 34677: "tiff_sgilog24", 34925: "lzma",
    50000: "zstd", 50001: "webp"}
DECODED = ("raw", "packbits", "tiff_lzw", "tiff_adobe_deflate",
           "tiff_deflate")

II, MM = b"II", b"MM"


def _open_info():
    """Pillow 12.1.0's OPEN_INFO (``TiffImagePlugin.py``): (byte order,
    photometric, sample format, fill order, bits, extra samples) ->
    (mode, rawmode); every key comes in both byte orders but the 16- and
    32-bit ones."""
    both = [
        (0, (1,), 1, (1,), (), "1", "1;I"), (0, (1,), 2, (1,), (), "1", "1;IR"),
        (1, (1,), 1, (1,), (), "1", "1"), (1, (1,), 2, (1,), (), "1", "1;R"),
        (0, (1,), 1, (2,), (), "L", "L;2I"),
        (0, (1,), 2, (2,), (), "L", "L;2IR"),
        (1, (1,), 1, (2,), (), "L", "L;2"), (1, (1,), 2, (2,), (), "L", "L;2R"),
        (0, (1,), 1, (4,), (), "L", "L;4I"),
        (0, (1,), 2, (4,), (), "L", "L;4IR"),
        (1, (1,), 1, (4,), (), "L", "L;4"), (1, (1,), 2, (4,), (), "L", "L;4R"),
        (0, (1,), 1, (8,), (), "L", "L;I"), (0, (1,), 2, (8,), (), "L", "L;IR"),
        (1, (1,), 1, (8,), (), "L", "L"), (1, (2,), 1, (8,), (), "L", "L"),
        (1, (1,), 2, (8,), (), "L", "L;R"),
        (1, (1,), 1, (8, 8), (2,), "LA", "LA"),
        (2, (1,), 1, (8, 8, 8), (), "RGB", "RGB"),
        (2, (1,), 2, (8, 8, 8), (), "RGB", "RGB;R"),
        (2, (1,), 1, (8, 8, 8, 8), (), "RGBA", "RGBA"),
        (2, (1,), 1, (8, 8, 8, 8), (0,), "RGB", "RGBX"),
        (2, (1,), 1, (8,) * 5, (0, 0), "RGB", "RGBXX"),
        (2, (1,), 1, (8,) * 6, (0, 0, 0), "RGB", "RGBXXX"),
        (2, (1,), 1, (8, 8, 8, 8), (1,), "RGBA", "RGBa"),
        (2, (1,), 1, (8,) * 5, (1, 0), "RGBA", "RGBaX"),
        (2, (1,), 1, (8,) * 6, (1, 0, 0), "RGBA", "RGBaXX"),
        (2, (1,), 1, (8, 8, 8, 8), (2,), "RGBA", "RGBA"),
        (2, (1,), 1, (8,) * 5, (2, 0), "RGBA", "RGBAX"),
        (2, (1,), 1, (8,) * 6, (2, 0, 0), "RGBA", "RGBAXX"),
        (2, (1,), 1, (8, 8, 8, 8), (999,), "RGBA", "RGBA"),
        (3, (1,), 1, (1,), (), "P", "P;1"), (3, (1,), 2, (1,), (), "P", "P;1R"),
        (3, (1,), 1, (2,), (), "P", "P;2"), (3, (1,), 2, (2,), (), "P", "P;2R"),
        (3, (1,), 1, (4,), (), "P", "P;4"), (3, (1,), 2, (4,), (), "P", "P;4R"),
        (3, (1,), 1, (8,), (), "P", "P"),
        (3, (1,), 1, (8, 8), (0,), "P", "PX"),
        (3, (1,), 1, (8, 8), (2,), "PA", "PA"),
        (3, (1,), 2, (8,), (), "P", "P;R"),
        (5, (1,), 1, (8, 8, 8, 8), (), "CMYK", "CMYK"),
        (5, (1,), 1, (8,) * 5, (0,), "CMYK", "CMYKX"),
        (5, (1,), 1, (8,) * 6, (0, 0), "CMYK", "CMYKXX"),
        (6, (1,), 1, (8,), (), "L", "L"),
        (6, (1,), 1, (8, 8, 8), (), "RGB", "RGBX"),
        (8, (1,), 1, (8, 8, 8), (), "LAB", "LAB"),
    ]
    info = {(order,) + k[:5]: k[5:] for k in both for order in (II, MM)}
    for k in [
        (II, 1, (1,), 1, (12,), (), "I;16", "I;12"),
        (II, 0, (1,), 1, (16,), (), "I;16", "I;16"),
        (II, 1, (1,), 1, (16,), (), "I;16", "I;16"),
        (MM, 1, (1,), 1, (16,), (), "I;16B", "I;16B"),
        (II, 1, (1,), 2, (16,), (), "I;16", "I;16R"),
        (II, 1, (2,), 1, (16,), (), "I", "I;16S"),
        (MM, 1, (2,), 1, (16,), (), "I", "I;16BS"),
        (II, 0, (3,), 1, (32,), (), "F", "F;32F"),
        (MM, 0, (3,), 1, (32,), (), "F", "F;32BF"),
        (II, 1, (1,), 1, (32,), (), "I", "I;32N"),
        (II, 1, (2,), 1, (32,), (), "I", "I;32S"),
        (MM, 1, (2,), 1, (32,), (), "I", "I;32BS"),
        (II, 1, (3,), 1, (32,), (), "F", "F;32F"),
        (MM, 1, (3,), 1, (32,), (), "F", "F;32BF"),
    ]:
        info[k[:6]] = k[6:]
    for order, end in ((II, "L"), (MM, "B")):
        for photo, extra, mode, raw in (
                (2, (), "RGB", "RGB"), (2, (0,), "RGB", "RGBX"),
                (2, (1,), "RGBA", "RGBa"), (2, (2,), "RGBA", "RGBA"),
                (5, (), "CMYK", "CMYK")):
            bits = (16,) * (3 + (photo == 5) + len(extra))
            info[(order, photo, (1,), 1, bits, extra)] = (mode, f"{raw};16{end}")
        info[(order, 2, (1,), 1, (16,) * 4, ())] = ("RGBA", f"RGBA;16{end}")
    return info


OPEN_INFO = _open_info()
MAX_SAMPLESPERPIXEL = 6
_SINGLE = {256, 257, 259, 262, 266, 274, 277, 278, 284, 317, 322, 323}
_TAGS = _SINGLE | {258, 273, 279, 320, 324, 325, 338, 339, 700, 0xBC01}
_BITREV = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)

_LIB = None
_LZW_ERRORS = {1: "the LZW data ends early", 2: "a code not yet in the LZW "
               "table"}


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(native_build.build(SOURCE)))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.tiff_lzw.restype = ctypes.c_int
        lib.tiff_lzw.argtypes = [ctypes.c_char_p, ctypes.c_int64, u8p,
                                 ctypes.c_int64, ctypes.c_int]
        lib.tiff_packbits.restype = ctypes.c_int
        lib.tiff_packbits.argtypes = [ctypes.c_char_p, ctypes.c_int64, u8p,
                                      ctypes.c_int64]
        lib.tiff_predict.restype = ctypes.c_int
        lib.tiff_predict.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_int]
        _LIB = lib
    return _LIB


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def accept(data: bytes) -> bool:
    """Whether Pillow's TIFF plugin takes the file (its ``_accept``)."""
    return data[:4] in MAGICS


class _Refused(ValueError):
    pass


def _refuse(why):
    raise _Refused(f"TIFF: {why}")


# ----------------------------------------------------------------- the IFD

def _ifd(data, end, big, offset):
    """{tag: value} of the IFD at ``offset`` as Pillow's
    ImageFileDirectory_v2 reads it (the tags this module reads): a tuple,
    or one value for the one-value tags; bytes for BYTE and UNDEFINED;
    RATIONAL and the floats as floats. An entry of a type Pillow does not
    know is skipped; one whose data runs past the file's end ends the
    directory (Pillow's short read)."""
    tags = {}
    head, entry, ptr = (8, 20, "Q") if big else (2, 12, "L")
    if offset + head > len(data):
        return tags
    (count,) = struct.unpack_from(end + ("Q" if big else "H"), data, offset)
    pos = offset + head
    for _ in range(count):
        if pos + entry > len(data):
            break
        tag, typ, n = struct.unpack_from(end + ("HHQ" if big else "HHL"),
                                         data, pos)
        field = data[pos + entry - (8 if big else 4):pos + entry]
        pos += entry
        size = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
                11: 4, 12: 8, 13: 4, 16: 8}.get(typ)
        if size is None:
            continue
        size *= n
        if size > len(field):
            (at,) = struct.unpack(end + ptr, field)
            raw = data[at:at + size]
            if len(raw) != size:
                break
        else:
            raw = field[:size]
        if not raw or tag not in _TAGS:
            continue
        if typ in (1, 7):
            val = (raw,)
        elif typ == 2:
            val = (raw[:-1] if raw.endswith(b"\0") else raw).decode(
                "latin-1", "replace")
            val = (val,)
        elif typ in (5, 10):
            nums = struct.unpack(end + f"{n * 2}{'L' if typ == 5 else 'l'}",
                                 raw)
            val = tuple(a / b if b else float("nan")
                        for a, b in zip(nums[::2], nums[1::2]))
        else:
            code = {3: "H", 4: "L", 6: "b", 8: "h", 9: "l", 11: "f", 12: "d",
                    13: "L", 16: "Q"}[typ]
            val = struct.unpack(end + f"{n}{code}", raw)
        if tag in _SINGLE or typ == 1:
            val = val[0]
        tags[tag] = val
    return tags


def _directory(data):
    """(byte order, "<" or ">", BigTIFF, the first IFD's offset, its
    tags)."""
    if not accept(data):
        _refuse("not a TIFF file")
    order = data[:2]
    end = ">" if order == MM else "<"
    big = data[2] == 43
    need = 16 if big else 8
    if len(data) < need:
        _refuse("the header is cut short")
    (first,) = struct.unpack_from(end + ("Q" if big else "L"), data,
                                  8 if big else 4)
    if not first:
        _refuse("no image in the file (the first IFD offset is 0)")
    if first >= 2 ** 63:
        _refuse("the first IFD offset is out of range")
    return order, end, big, first, _ifd(data, end, big, first)


# ------------------------------------------------------------- unpacking

def _fields(rows, w, bits):
    """[r, w] ints of ``bits``-bit fields, most significant first, of
    byte rows [r, n]."""
    if bits == 8:
        return rows[:, :w]
    shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
    v = (rows[:, :, None] >> shifts) & ((1 << bits) - 1)
    return v.reshape(len(rows), -1)[:, :w]


def _words(rows, w, k, dtype):
    """[r, w, k] of ``dtype`` samples of byte rows."""
    size = np.dtype(dtype).itemsize
    return np.ascontiguousarray(rows[:, :w * k * size]).view(dtype).reshape(
        len(rows), w, k)


def _unpremultiply(px):
    """Pillow's unpackRGBa on [..., 4] uint8."""
    a = px[..., 3:].astype(np.int32)
    c = px[..., :3].astype(np.int32)
    out = px.copy()
    safe = np.maximum(a, 1)
    out[..., :3] = np.where(a == 0, 0, np.where(
        a == 255, c, np.minimum(c * 255 // safe, 255)))
    return out


def _quad(*bands):
    """[r, w, 4] uint8 of up to four [r, w] bands."""
    out = np.zeros(bands[0].shape + (4,), np.uint8)
    for i, b in enumerate(bands):
        out[..., i] = b
    return out


# Pillow's unpackers this module uses (Unpack.c), by (mode, rawmode).
# One-band 1, L and P: (bits, inverted, bits reversed in each byte).
_GREY = {("1", "1"): (1, 0, 0), ("1", "1;I"): (1, 1, 0),
         ("1", "1;R"): (1, 0, 1), ("1", "1;IR"): (1, 1, 1),
         ("L", "L;2"): (2, 0, 0), ("L", "L;2I"): (2, 1, 0),
         ("L", "L;2R"): (2, 0, 1), ("L", "L;2IR"): (2, 1, 1),
         ("L", "L;4"): (4, 0, 0), ("L", "L;4I"): (4, 1, 0),
         ("L", "L;4R"): (4, 0, 1), ("L", "L;4IR"): (4, 1, 1),
         ("L", "L"): (8, 0, 0), ("L", "L;I"): (8, 1, 0),
         ("L", "L;R"): (8, 0, 1), ("P", "P;1"): (1, 0, 0),
         ("P", "P;2"): (2, 0, 0), ("P", "P;4"): (4, 0, 0),
         ("P", "P"): (8, 0, 0), ("P", "P;R"): (8, 0, 1)}
# One-band words: numpy dtype (bits reversed first for I;16R).
_WORDS = {("I;16", "I;16"): "<u2", ("I;16", "I;16N"): "<u2",
          ("I;16", "I;16B"): ">u2", ("I;16", "I;16R"): "<u2",
          ("I;16B", "I;16B"): ">u2", ("I;16B", "I;16N"): "<u2",
          ("I", "I;16S"): "<i2", ("I", "I;16BS"): ">i2",
          ("I", "I;32N"): "<i4", ("I", "I;32S"): "<i4",
          ("I", "I;32BS"): ">i4", ("I", "I"): "<i4",
          ("F", "F;32F"): "<f4", ("F", "F;32BF"): ">f4", ("F", "F"): "<f4"}
_WORD_MODES = {"I;16": np.uint16, "I;16B": np.uint16, "I": np.int32,
               "F": np.float32}
# Pixel-interleaved bands: (samples a pixel, bytes a sample, the byte of a
# sample kept, un-premultiply); the first 3 (RGB) or 4 samples are kept.
_BANDS = {}
for _mode, _names in (("RGB", ("RGB", "RGBX", "RGBXX", "RGBXXX")),
                      ("RGBA", ("RGBA", "RGBa", "RGBaX", "RGBaXX", "RGBAX",
                                "RGBAXX")),
                      ("CMYK", ("CMYK", "CMYKX", "CMYKXX"))):
    for _name in _names:
        _BANDS[(_mode, _name)] = (len(_name), 1, 0, "a" in _name)
for _mode, _name in (("RGB", "RGB"), ("RGB", "RGBX"), ("RGBA", "RGBA"),
                     ("RGBA", "RGBa"), ("CMYK", "CMYK")):
    for _end, _hi in (("L", 1), ("B", 0), ("N", 1)):
        _BANDS[(_mode, f"{_name};16{_end}")] = (len(_name), 2, _hi,
                                               "a" in _name)
# One band of a plane (planar configuration 2 without libtiff).
_PLANE = {(m, c): m.index(c) for m in ("RGB", "RGBA", "CMYK") for c in m}


def _unpacker(mode, rawmode):
    """(bits a pixel, fn(byte rows [r, n], w) -> pixels, band) of
    Pillow's unpacker for ``rawmode`` into ``mode``, or None where Pillow
    has none. Pixels: [r, w] for the one-band modes ("1", "L", "P" uint8,
    "I;16"/"I;16B" uint16, "I" int32, "F" float32), else [r, w, 4] uint8
    as Pillow lays them out (LA and PA: the grey or index in bytes 0-2,
    alpha in byte 3); or where ``band`` is not None, [r, w] uint8 of that
    band alone (one plane of planar data)."""
    key = (mode, rawmode)
    if key in _GREY:
        bits, inv, rev = _GREY[key]
        top = (1 << bits) - 1
        scale = 1 if mode == "P" else 255 // top

        def grey(rows, w):
            v = _fields(_BITREV[rows] if rev else rows, w, bits)
            if inv:
                v = top - v
            return (v * scale).astype(np.uint8)
        return bits, grey, None
    if key in _WORDS:
        dt, out = _WORDS[key], _WORD_MODES[mode]
        rev = rawmode == "I;16R"
        return 8 * np.dtype(dt).itemsize, lambda rows, w: _words(
            _BITREV[rows] if rev else rows, w, 1, dt)[..., 0].astype(
                out), None
    if key == ("I;16", "I;12"):
        def i12(rows, w):
            n = (w + 1) // 2 * 3
            r = np.zeros((len(rows), n), np.int32)
            r[:, :min(n, rows.shape[1])] = rows[:, :n]
            t = r.reshape(len(rows), -1, 3)
            a = (t[..., 0] << 4) | (t[..., 1] >> 4)
            b = ((t[..., 1] & 15) << 8) | t[..., 2]
            return np.stack([a, b], -1).reshape(len(rows), -1)[
                :, :w].astype(np.uint16)
        return 12, i12, None
    if key == ("P", "PX"):
        return 16, lambda rows, w: _words(rows, w, 2, np.uint8)[
            ..., 0], None
    if key in (("LA", "LA"), ("PA", "PA")):
        return 16, lambda rows, w: _words(rows, w, 2, np.uint8)[
            ..., [0, 0, 0, 1]], None
    if key == ("LAB", "LAB"):
        def lab(rows, w):
            px = _words(rows, w, 3, np.uint8) ^ np.uint8([0, 128, 128])
            return _quad(px[..., 0], px[..., 1], px[..., 2],
                         np.full(px.shape[:2], 255, np.uint8))
        return 24, lab, None
    if key == ("RGB", "RGB;R"):
        return 24, lambda rows, w: _quad(
            *np.moveaxis(_words(_BITREV[rows], w, 3, np.uint8), -1, 0),
            np.full((len(rows), w), 255, np.uint8)), None
    if key in _PLANE:
        return 8, lambda rows, w: rows[:, :w], _PLANE[key]
    if key not in _BANDS:
        return None
    n, size, hi, premultiplied = _BANDS[key]

    def bands(rows, w):
        px = _words(rows, w, n * size, np.uint8)[..., hi::size]
        if mode == "RGB":
            return _quad(px[..., 0], px[..., 1], px[..., 2],
                         np.full(px.shape[:2], 255, np.uint8))
        px = np.ascontiguousarray(px[..., :4])
        return _unpremultiply(px) if premultiplied else px
    return 8 * size * n, bands, None


# ------------------------------------------------------------ conversion

def _to_rgba(im, mode, palette):
    """[H, W, 4] uint8 of Pillow's image ``im`` in ``mode``, as
    ``convert("RGBA")`` gives it."""
    h, w = im.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    if mode in ("1", "L"):
        out[..., :3] = im[..., None]
    elif mode in ("I;16", "I;16B", "I"):
        out[..., :3] = np.clip(im, 0, 255).astype(np.uint8)[..., None]
    elif mode == "F":
        grey = np.zeros(im.shape, np.uint8)
        mid = (im > 0) & (im < 255)
        grey[mid] = im[mid].astype(np.uint8)
        grey[im >= 255] = 255
        out[..., :3] = grey[..., None]
    elif mode in ("P", "PA"):
        idx = im if mode == "P" else im[..., 0]
        out[..., :3] = palette[idx]
        if mode == "PA":
            out[..., 3] = im[..., 3]
    elif mode == "LA":
        out[..., :3] = im[..., :1]
        out[..., 3] = im[..., 3]
    elif mode == "RGB":
        out[..., :3] = im[..., :3]
    elif mode == "RGBA":
        out[:] = im
    elif mode == "CMYK":
        out[..., :3] = _cmyk2rgb(im)
    else:
        _refuse(f"conversion from {mode} to RGBA is not supported")
    return out


def _transpose(im, orientation):
    """``ImageOps.exif_transpose``'s method for ``orientation``."""
    if orientation == 2:
        return im[:, ::-1]
    if orientation == 3:
        return im[::-1, ::-1]
    if orientation == 4:
        return im[::-1]
    if orientation == 5:
        return im.swapaxes(0, 1)
    if orientation == 6:
        return np.rot90(im, -1)
    if orientation == 7:
        return im[::-1, ::-1].swapaxes(0, 1)
    if orientation == 8:
        return np.rot90(im, 1)
    return im


def _blank(mode, h, w):
    dtype = {"I;16": np.uint16, "I;16B": np.uint16, "I": np.int32,
             "F": np.float32}.get(mode, np.uint8)
    shape = (h, w) if mode in ("1", "L", "P", "I;16", "I;16B", "I",
                               "F") else (h, w, 4)
    return np.zeros(shape, dtype)


# ----------------------------------------------------------- Pillow's raw

def _raw_load(data, tags, im, mode, rawmode, size, planar, bps, bps_count):
    """Pillow's tile list for uncompressed data, decoded as ImageFile.load
    decodes it (tiles sorted by offset, consecutive twins dropped)."""
    xsize, ysize = size
    if 273 in tags:
        offsets = tags[273]
        h = tags.get(278, ysize)
        w = xsize
    elif 324 in tags:
        offsets = tags[324]
        w, h = tags.get(322), tags.get(323)
        if not isinstance(w, int) or not isinstance(h, int):
            _refuse("invalid tile dimensions")
    else:
        _refuse("unknown data organization (no strip or tile offsets)")
    if w == xsize and h == ysize and planar != 2:
        offsets = offsets[-1:]
    tiles = []
    x = y = layer = 0
    for offset in offsets:
        stride = w * sum(bps) / 8 if x + w > xsize else 0
        tile_rawmode = rawmode
        if planar == 2:
            if layer >= len(rawmode):
                _refuse("more planes than the pixel mode has bands")
            tile_rawmode = rawmode[layer]
            stride /= bps_count
        tiles.append(((x, y, min(x + w, xsize), min(y + h, ysize)), offset,
                      tile_rawmode, int(stride)))
        x += w
        if x >= xsize:
            x, y = 0, y + h
            if y >= ysize:
                y = 0
                layer += 1
    tiles.sort(key=lambda t: t[1])
    kept = [t for i, t in enumerate(tiles)
            if i + 1 == len(tiles) or (t[0], t[2], t[3]) != (
                tiles[i + 1][0], tiles[i + 1][2], tiles[i + 1][3])]
    err = 0
    for (x0, y0, x1, y1), offset, tile_rawmode, stride in kept:
        unpack = _unpacker(mode, tile_rawmode)
        if unpack is None:
            _refuse(f"unknown raw mode {tile_rawmode!r} for mode {mode}")
        bits, fn, band = unpack
        if x0 == x1 == 0:           # ImageFile's setimage: the whole image
            x1, y0, y1 = xsize, 0, ysize
        tw, th = x1 - x0, y1 - y0
        if tw <= 0 or th <= 0:
            _refuse("a tile outside the image")
        line = (tw * bits + 7) // 8
        step = stride or line
        if step < line:
            err = -8        # the decoder's config error: this tile is left
            continue
        err = 0
        if offset < 0:
            _refuse("a negative data offset")
        need = (th - 1) * step + line
        if offset + need > len(data):
            _refuse("image file is truncated")
        buf = np.frombuffer(data, np.uint8, need, offset)
        rows = np.lib.stride_tricks.as_strided(buf, (th, line), (step, 1))
        dst = im[y0:y1, x0:x1] if band is None else im[y0:y1, x0:x1, band]
        dst[...] = fn(np.ascontiguousarray(rows), tw)
    if err:
        _refuse("decoder error (a tile's stride is shorter than its line)")


# ------------------------------------------------------- Pillow's libtiff

def _chunk(data, offset, count, occ, compression, fill, compat):
    """``occ`` bytes of one strip or tile decompressed, as libtiff's
    TIFFFillStrip and codec give them (uint8 array)."""
    if count == 0:
        _refuse("a strip or tile byte count of 0")
    if count > len(data) or offset > len(data) - count:
        _refuse("a strip or tile reaches past the end of the file")
    raw = data[offset:offset + count]
    if fill == 2:
        raw = _BITREV[np.frombuffer(raw, np.uint8)].tobytes()
    out = np.empty(occ, np.uint8)
    if compression == "tiff_lzw":
        err = _lib().tiff_lzw(raw, len(raw), _ptr(out), occ, int(compat))
        if err:
            _refuse(_LZW_ERRORS[err])
    elif compression == "packbits":
        if _lib().tiff_packbits(raw, len(raw), _ptr(out), occ):
            _refuse("the PackBits data ends early")
    else:
        try:
            got = zlib.decompressobj().decompress(raw, occ)
        except zlib.error as e:
            _refuse(f"Deflate: {e}")
        if len(got) < occ:
            _refuse("the Deflate data ends early")
        out[:] = np.frombuffer(got, np.uint8)
    return out


# libtiff's field types: bytes a value (TIFFDataWidth), and the struct
# code of those it reads into integers
_WIDTH = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8,
          11: 4, 12: 8, 13: 4, 16: 8, 17: 8, 18: 8}
_INTS = {1: "B", 3: "H", 4: "L", 6: "b", 8: "h", 9: "l", 16: "Q", 17: "q"}


def _libtiff_tags(data, end, big, offset, size):
    """The IFD at ``offset`` as libtiff's TIFFReadDirectory reads it
    where that differs from Pillow: the header must carry 42 or 43 in its
    byte order and the whole directory (at most 4096 entries) lie in the
    file; sizes, layout and SamplesPerPixel are one integer each in range
    (PlanarConfiguration 1 or 2); BitsPerSample, SampleFormat and
    Compression one integer or one a sample, all equal; ExtraSamples at
    most one a sample, each 0, 1, 2 or 999 (read as 2); offsets and byte
    counts the first integers of as many as there are strips or tiles
    (zeros past the entry's count), a missing or zero single byte count
    estimated from the file's size as EstimateStripByteCounts does; else
    it refuses the directory. A FillOrder or Predictor it cannot read as
    one integer keeps its default. Returns {tag: value}, the offsets and
    byte counts under "offsets" and "counts", and "tiled"."""
    if struct.unpack_from(end + "H", data, 2)[0] not in (42, 43) or (
            big and struct.unpack_from(end + "HH", data, 4) != (8, 0)):
        _refuse("libtiff refuses the header")
    head, entry = (8, 20) if big else (2, 12)
    room = 8 if big else 4
    if offset + head > len(data):
        _refuse("libtiff cannot read the directory")
    (n,) = struct.unpack_from(end + ("Q" if big else "H"), data, offset)
    if n > 4096 or offset + head + n * entry > len(data):
        _refuse("libtiff cannot read the directory")
    entries, space, order = {}, 0, []
    for i in range(n):
        pos = offset + head + i * entry
        tag, typ, count = struct.unpack_from(
            end + ("HHQ" if big else "HHL"), data, pos)
        field = data[pos + entry - room:pos + entry]
        if tag not in entries:          # a later twin is ignored
            entries[tag] = (typ, count, field)
            order.append(tag)
        if _WIDTH.get(typ, 0) * count > room:
            space += _WIDTH[typ] * count

    def ints(tag, limit=None):
        """The entry's first ``limit`` integers (all where None), or None
        where libtiff cannot read them as unsigned integers."""
        typ, count, field = entries[tag]
        if typ not in _INTS or _WIDTH[typ] * count >= 2 ** 64:
            return None
        k = count if limit is None else min(count, limit)
        width = _WIDTH[typ]
        if width * count > room:
            (at,) = struct.unpack(end + ("Q" if big else "L"), field)
            raw = data[at:at + width * k]
        else:
            raw = field[:width * k]
        if len(raw) < width * k:
            return None
        vals = struct.unpack(end + f"{k}{_INTS[typ]}", raw)
        return None if any(v < 0 for v in vals) else vals

    def single(tag, default, top, strict=True):
        if tag not in entries:
            return default
        vals = ints(tag)
        if vals is None or len(vals) != 1 or vals[0] > top:
            if strict:
                _refuse(f"libtiff refuses tag {tag}")
            return default
        return vals[0]

    out = {}
    for tag in (256, 257, 278, 322, 323):
        out[tag] = single(tag, None, 2 ** 32 - 1)
    spp = out[277] = single(277, 1, 65535)
    if spp == 0:
        _refuse("libtiff refuses SamplesPerPixel 0")
    out[284] = single(284, 1, 65535)
    if out[284] not in (1, 2):
        _refuse("libtiff refuses the PlanarConfiguration value")
    for tag, default in ((258, 1), (259, 1), (339, 1)):
        if tag not in entries:
            out[tag] = default
            continue
        vals = ints(tag)
        if vals is None or (len(vals) != 1 and (
                len(vals) < spp or len(set(vals[:spp])) != 1)):
            _refuse(f"libtiff refuses tag {tag}")
        out[tag] = vals[0]
    if not 1 <= out[339] <= 6:
        _refuse("libtiff refuses the SampleFormat value")
    extra = ints(338) if 338 in entries else ()
    if extra is None or len(extra) > spp or any(
            v not in (0, 1, 2, 999) for v in extra):
        _refuse("libtiff refuses ExtraSamples")
    out[338] = tuple(2 if v == 999 else v for v in extra)
    fill = single(266, 1, 65535, strict=False)
    out[266] = fill if fill in (1, 2) else 1
    out[317] = single(317, 1, 65535, strict=False)
    if single(262, None, 65535, strict=False) == 3 and out[258] < 8:
        # a ColorMap counts only with 3 << bits values, after
        # BitsPerSample in the directory; a palette of fewer bits needs one
        cmap = entries.get(320)
        if (cmap is None or 258 not in order
                or order.index(320) < order.index(258)
                or cmap[1] != 3 << out[258] or ints(320) is None):
            _refuse("libtiff finds no usable ColorMap")
    xsize, ysize = size
    if (out[256], out[257]) != (xsize, ysize):
        _refuse("libtiff reads another size than Pillow")
    tiled = out["tiled"] = 322 in entries or 323 in entries
    separate = out[284] == 2
    if tiled:
        tw, tl = out[322] or 0, out[323] or 0
        nstrips = (0 if not tw or not tl else -(-xsize // tw)
                   * -(-ysize // tl))
    else:
        rps = out[278] if out[278] is not None else ysize
        if rps == 0:
            _refuse("libtiff refuses RowsPerStrip 0")
        nstrips = -(-ysize // min(rps, ysize))
    nstrips *= spp if separate else 1
    if nstrips == 0:
        _refuse("libtiff cannot handle zero tiles")
    # StripOffsets and TileOffsets fill one field: the later entry wins
    offs = [t for t in order if t in (273, 324)]
    cnts = [t for t in order if t in (279, 325)]
    if not offs:
        _refuse("no strip or tile offsets")
    offsets = ints(offs[-1], nstrips)
    if offsets is None:
        _refuse("libtiff cannot read the strip or tile offsets")
    out["offsets"] = list(offsets) + [0] * (nstrips - len(offsets))
    counts = ints(cnts[-1], nstrips) if cnts else None
    if cnts and counts is None:
        _refuse("libtiff cannot read the strip or tile byte counts")
    if counts is not None:
        counts = list(counts) + [0] * (nstrips - len(counts))
    if counts is None or (nstrips == 1 and not tiled and counts[0] == 0
                          and out["offsets"][0] != 0):
        if counts is None and (nstrips != spp if separate else nstrips > 1):
            _refuse("no StripByteCounts (libtiff requires them)")
        if any(t not in _WIDTH or _WIDTH[t] * c >= 2 ** 64
               for t, c, _ in entries.values()):
            _refuse("libtiff cannot size the directory's entries")
        used = (16 + 8 + n * 20 + 8) if big else (8 + 2 + n * 12 + 4)
        est = len(data) - (used + space) if len(data) >= used + space else (
            len(data))
        if separate:
            est //= spp
        counts = [est] * nstrips
        last = out["offsets"][-1]
        if last + est > len(data):
            counts[-1] = len(data) - last if last < len(data) else 0
    out["counts"] = counts
    return out


def _libtiff_load(data, tags, end, im, mode, unpack, size):
    """The image as Pillow's libtiff decoder (TiffDecode.c over libtiff
    4.7) fills it, unpacking rows with ``unpack`` (bits a pixel, fn);
    ``tags`` as :func:`_libtiff_tags` reads them."""
    xsize, ysize = size
    fill, spp, bps, sf = tags[266], tags[277], tags[258], tags[339]
    compression = COMPRESSION_INFO.get(tags[259])
    if compression not in DECODED[1:]:
        _refuse(f"libtiff reads compression {tags[259]}")
    bits_per_pixel = unpack[0]
    separate = tags[284] == 2
    if not separate and bits_per_pixel != bps * spp:
        # Pillow's mode (from its own reading of the IFD) against libtiff's
        # interleaved samples: its decoder refuses a mismatch
        _refuse(f"libtiff reads {spp} samples of {bps} bits, Pillow's mode "
                f"{bits_per_pixel} bits")
    predictor = tags[317] if compression != "packbits" else 1
    bands = {"LA": 2, "PA": 2, "RGB": 3, "RGBA": 4, "CMYK": 4,
             "LAB": 3}.get(mode, 1)
    if separate and bands > 1:
        if bps not in (8, 16):
            _refuse(f"{bps}-bit planes (libtiff decodes 8 and 16)")
        planes = bands
    else:
        planes = 1
    pixel_bits = bps * (1 if separate else spp)
    tiled = tags["tiled"]
    offsets, counts = tags["offsets"], tags["counts"]
    n_chunks = len(offsets)
    if tiled:
        tw, tl = tags[322], tags[323]
        across, down = -(-xsize // tw), -(-ysize // tl)
        row_bytes = (tw * pixel_bits + 7) // 8
        chunk_bytes = row_bytes * tl
        if chunk_bytes > ((tl * bits_per_pixel // planes + 7) // 8) * tw:
            _refuse("the tile size is not what the pixel mode expects")
    else:
        rps = tags[278]
        if rps is not None and 2 ** 31 <= rps < 2 ** 32 - 1:
            # TiffDecode.c takes it as a negative row count
            _refuse(f"RowsPerStrip {rps} (Pillow's decoder runs out of "
                    "memory)")
        rps = min(rps or ysize, ysize)
        per_plane = -(-ysize // rps)
        row_bytes = (xsize * pixel_bits + 7) // 8
        if row_bytes < (xsize * bits_per_pixel // planes + 7) // 8:
            _refuse("the strip is too small for the pixel mode")
    if tiled and chunk_bytes > 2 ** 31 - 2:
        _refuse("a tile of 2 GiB or more")
    swab = end == ">" and bps in (16, 32) and predictor != 3
    if predictor not in (1, 2, 3):
        _refuse(f"predictor {predictor} is not supported")
    if predictor == 2 and bps not in (8, 16, 32):
        _refuse(f"horizontal differencing with {bps}-bit samples")
    if predictor == 3 and (sf != 3 or bps not in (16, 24, 32, 64)):
        _refuse("the floating-point predictor on data that is not float")
    if predictor == 3 and bps != 32:
        _refuse(f"the floating-point predictor on {bps}-bit floats")
    stride = 1 if separate else spp
    compat = None

    def read(index, occ):
        nonlocal compat
        if index >= n_chunks:
            _refuse("a strip or tile out of range")
        off, cnt = offsets[index], counts[index]
        if compat is None and compression == "tiff_lzw":
            head = data[off:off + 2] if cnt >= 2 else b""
            if fill == 2:
                head = bytes(_BITREV[np.frombuffer(head, np.uint8)])
            compat = len(head) == 2 and head[0] == 0 and head[1] & 1
        buf = _chunk(data, off, cnt, occ, compression, fill, compat)
        if swab:
            buf = buf.view(end + f"u{bps // 8}").byteswap().view(np.uint8)
            buf = np.ascontiguousarray(buf)
        if predictor in (2, 3):
            err = _lib().tiff_predict(_ptr(buf), occ, row_bytes, predictor,
                                      bps // 8, stride)
            if err:
                _refuse("the predictor's rows do not split into samples")
        return buf

    def put(buf, n, y, x, w, plane):
        # TiffDecode.c unpacks row r of n from byte r * row_bytes of the
        # buffer, reading on into the next row where the pixels need it
        line = (w * (bits_per_pixel if planes == 1 else bps) + 7) // 8
        if (n - 1) * row_bytes + line > len(buf):
            _refuse("the pixel mode reads past the end of a tile")
        rows = np.lib.stride_tricks.as_strided(buf, (n, line),
                                               (row_bytes, 1))
        if planes == 1:
            im[y:y + n, x:x + w] = unpack[1](rows, w)
        else:
            hi = 1 if bps == 16 else 0
            im[y:y + n, x:x + w, plane] = _words(
                rows, w, bps // 8, np.uint8)[..., hi]

    if tiled:
        for ty in range(0, ysize, tl):
            for plane in range(planes):
                for tx in range(0, xsize, tw):
                    index = (ty // tl) * across + tx // tw + plane * (
                        across * down)
                    cw, cl = min(tw, xsize - tx), min(tl, ysize - ty)
                    put(read(index, chunk_bytes), cl, ty, tx, cw, plane)
    else:
        for y in range(0, ysize, rps):
            rows_here = min(rps, ysize - y)
            for plane in range(planes):
                index = y // rps + plane * per_plane
                put(read(index, rows_here * row_bytes), rows_here, y, 0,
                    xsize, plane)
    if mode == "RGBA" and planes > 3:
        # TiffDecode.c: planes of RGBA whose first extra sample libtiff
        # takes as unspecified (it names the samples past the colours
        # that ExtraSamples leaves out so) or associated are RGBa
        extra = tags[338]
        if (extra[0] if extra else 0) in (0, 1):
            im[...] = _unpremultiply(im)


# ---------------------------------------------------------------- decode

def _xmp_orientation(tags):
    xmp = tags.get(700)
    if isinstance(xmp, tuple) and len(xmp) == 1:
        xmp = xmp[0]
    if not xmp:
        return None
    if not isinstance(xmp, bytes):
        _refuse("an XMP packet that is not bytes")
    m = re.search(rb'tiff:Orientation(="|>)([0-9])', xmp)
    return int(m[2]) if m else None


def _decode(data):
    order, end, big, ifd, tags = _directory(data)
    if 0xBC01 in tags:
        _refuse("Windows Media Photo files are not supported")
    code = tags.get(259, 1)
    if code not in COMPRESSION_INFO:
        _refuse(f"unknown compression {code!r}")
    compression = COMPRESSION_INFO[code]
    planar = tags.get(284, 1)
    photo = tags.get(262, 0)
    if compression == "tiff_jpeg":
        photo = 6
    if compression not in DECODED:
        _refuse(f"compression {code} ({compression}) is not decoded")
    if photo == 6:
        _refuse("photometric 6 (YCbCr) is not decoded")
    fill = tags.get(266, 1)
    if 256 not in tags or 257 not in tags:
        _refuse("missing dimensions")
    xsize, ysize = tags[256], tags[257]
    if type(xsize) is not int or type(ysize) is not int:
        _refuse("invalid dimensions")
    sample_format = tags.get(339, (1,))
    if len(sample_format) > 1 and max(sample_format) == min(
            sample_format) == 1:
        sample_format = (1,)
    bps = tags.get(258, (1,))
    extra = tags.get(338, ())
    bps_count = (3 if photo in (2, 6, 8) else 4 if photo == 5 else 1) + len(
        extra)
    spp = tags.get(277, 1)
    if spp > MAX_SAMPLESPERPIXEL:
        _refuse("invalid value for samples per pixel")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        _refuse("unknown data organization (BitsPerSample against "
                "SamplesPerPixel)")
    key = (order, photo, sample_format, fill, bps, extra)
    if key not in OPEN_INFO:
        _refuse(f"unknown pixel mode {key[1:]}")
    mode, rawmode = OPEN_INFO[key]
    palette = None
    if mode in ("P", "PA"):
        if 320 not in tags:
            _refuse("a palette image without a ColorMap")
        cmap = np.asarray(tags[320], np.int64) // 256
        n = len(cmap) // 3
        palette = np.zeros((256, 3), np.uint8)   # past the map: black
        palette[:n] = np.stack([cmap[:n], cmap[n:2 * n], cmap[2 * n:3 * n]],
                               -1).astype(np.uint8)
    if mode == "LAB":
        _refuse("photometric 8 (CIELab) is not decoded (Pillow converts it "
                "to RGBA through LittleCMS)")
    if xsize * ysize > MAX_PIXELS:
        _refuse(f"size {xsize} x {ysize}")
    im = _blank(mode, ysize, xsize)
    if compression == "raw":
        _raw_load(data, tags, im, mode, rawmode, (xsize, ysize), planar, bps,
                  bps_count)
    else:
        if fill == 2:
            key = key[:3] + (1,) + key[4:]
            mode, rawmode = OPEN_INFO[key]
        if rawmode == "I;16":
            rawmode = "I;16N"
        elif rawmode.endswith((";16B", ";16L")):
            rawmode = rawmode[:-1] + "N"
        unpack = _unpacker(mode, rawmode)
        if unpack is None:
            _refuse(f"unknown raw mode {rawmode!r} for mode {mode}")
        _libtiff_load(data, _libtiff_tags(data, end, big, ifd,
                                          (xsize, ysize)),
                      end, im, mode, unpack, (xsize, ysize))
    orientation = tags.get(274)
    if 274 not in tags:
        orientation = _xmp_orientation(tags)
    return _to_rgba(_transpose(im, orientation), mode, palette)


def decode_tiff(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a TIFF's first image (see the module
    doc)."""
    data = bytes(data)
    try:
        return np.ascontiguousarray(_decode(data))
    except _Refused:
        raise
    except (TypeError, KeyError, IndexError, struct.error, OverflowError,
            ValueError) as e:
        raise ValueError(f"TIFF: a malformed directory ({e})") from e
