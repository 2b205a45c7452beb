"""DDS decoding to RGBA8, as Pillow reads it.

The JAX package decodes textures with ``PIL.Image.open(...).convert(
"RGBA")``. :func:`decode_dds` gives the same bytes for what Pillow's
``DdsImagePlugin`` opens (Pillow 12.1.0): the first surface of the file
(mip levels, cube faces and array slices after it are ignored), read
from a 124-byte header and its pixel format, tried in the plugin's
order:

* ``DDPF_RGB``: Pillow's ``dds_rgb`` decoder. Each pixel is ``bitcount //
  8`` little-endian bytes with no row padding; each of the 3 masks (4
  with ``DDPF_ALPHAPIXELS``) is shifted down past its trailing zeros and
  scaled as ``int(v / (mask >> shift) * 255)`` in floating point, so a
  5-bit 31 is 255 and a 5-bit 30 is 246 (truncated). A zero mask gives
  0. Data that ends early reads as zero bytes (Pillow's decoder reads on
  past the end without complaint);
* ``DDPF_LUMINANCE``: 8-bit grey, or 16-bit grey and alpha with
  ``DDPF_ALPHAPIXELS``;
* ``DDPF_PALETTEINDEXED8``: 8-bit indices into the 1024-byte RGBA palette
  after the header, its alpha kept;
* ``DDPF_FOURCC``: DXT1, DXT3, DXT5, BC4U/ATI1, BC5U/ATI2 and BC5S, and
  after a DX10 header (20 bytes; pixel data at byte 148) the DXGI formats
  BC1, BC2, BC3, BC4 and BC5 (typeless and unorm), BC5 snorm, BC6H UF16
  and SF16, BC7 (typeless, unorm and sRGB) and R8G8B8A8 (typeless, unorm
  and sRGB; sRGB only tags the gamma, so the bytes are the file's). The
  block formats are decoded by ``native/bcn_decode.cpp`` (built with g++
  at first use by :mod:`.native_build`, bound with ctypes; without g++ it
  raises): BC4 is grey, BC5 and BC6H are RGB with alpha 255.

Refused with ``ValueError`` naming DDS and the format, as Pillow refuses
them: a header size other than 124, a zero width or height, 16-bit
luminance without alpha and luminance at other depths, every other
fourcc (DXT2, DXT4, BC4S, ...) and DXGI format (the sRGB BC1-BC3,
B8G8R8A8, R16G16B16A16_FLOAT, ...), pixel flags with none of the four
kinds, and pixel data that ends before the surface does (all but
``dds_rgb``: Pillow finds the file truncated).
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import native_build

SOURCE = native_build.NATIVE / "bcn_decode.cpp"
MAGIC = b"DDS "

DDPF_ALPHAPIXELS, DDPF_FOURCC = 0x1, 0x4
DDPF_PALETTEINDEXED8, DDPF_RGB, DDPF_LUMINANCE = 0x20, 0x40, 0x20000

# fourcc -> (BCn number, signed)
FOURCCS = {b"DXT1": (1, 0), b"DXT3": (2, 0), b"DXT5": (3, 0),
           b"BC4U": (4, 0), b"ATI1": (4, 0), b"BC5U": (5, 0),
           b"ATI2": (5, 0), b"BC5S": (5, 1)}
# DXGI format -> (BCn number, signed); 0 for raw RGBA
DXGI = {70: (1, 0), 71: (1, 0), 73: (2, 0), 74: (2, 0), 76: (3, 0),
        77: (3, 0), 79: (4, 0), 80: (4, 0), 82: (5, 0), 83: (5, 0),
        84: (5, 1), 95: (6, 0), 96: (6, 1), 97: (7, 0), 98: (7, 0),
        99: (7, 0), 27: (0, 0), 28: (0, 0), 29: (0, 0)}

# Pillow's DecompressionBombError: images of more pixels are refused
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(native_build.build(SOURCE)))
        lib.bcn_decode.restype = ctypes.c_int
        lib.bcn_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
        _LIB = lib
    return _LIB


def _u32(b, o):
    return int.from_bytes(b[o:o + 4], "little")


def _raw(data, pos, n):
    """``n`` bytes of pixel data at ``pos``, or the truncated file's
    refusal."""
    if pos + n > len(data):
        raise ValueError("DDS: image file is truncated")
    return np.frombuffer(data, np.uint8, n, pos)


def _rgb_masks(data, w, h, bitcount, masks):
    """Pillow's dds_rgb decoder: [h, w, len(masks)] uint8."""
    nbytes = bitcount // 8
    value = np.zeros(w * h, np.uint64)
    start = 128 + np.arange(w * h, dtype=np.int64) * nbytes
    body = np.frombuffer(data, np.uint8)
    # the masks are 32-bit: a pixel's bytes past its fourth do not count
    for k in range(min(nbytes, 4)):
        at = start + k
        byte = np.where(at < len(body), body[np.minimum(at, len(body) - 1)],
                        0)
        value |= byte.astype(np.uint64) << np.uint64(8 * k)
    out = np.zeros((w * h, len(masks)), np.uint8)
    for i, mask in enumerate(masks):
        if not mask:
            continue
        shift = (mask & -mask).bit_length() - 1
        total = mask >> shift
        v = ((value & np.uint64(mask)) >> np.uint64(shift)).astype(
            np.float64)
        out[:, i] = np.floor(v / total * 255).astype(np.uint8)
    return out.reshape(h, w, len(masks))


def decode_dds(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a DDS file's first surface (see the module
    doc)."""
    data = bytes(data)
    if not data.startswith(MAGIC) or len(data) < 8:
        raise ValueError("not a DDS file")
    if _u32(data, 4) != 124:
        raise ValueError(f"DDS: unsupported header size {_u32(data, 4)}")
    if len(data) < 128:
        raise ValueError(f"DDS: incomplete header ({len(data) - 8} bytes)")
    height, width = _u32(data, 12), _u32(data, 16)
    pfflags, fourcc, bitcount = _u32(data, 80), data[84:88], _u32(data, 88)
    w, h = width, height
    if not w or not h or w * h > MAX_PIXELS:
        raise ValueError(f"DDS: size {w} x {h}")
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    if pfflags & DDPF_RGB:
        n = 4 if pfflags & DDPF_ALPHAPIXELS else 3
        masks = [_u32(data, 92 + 4 * i) for i in range(n)]
        out[..., :n] = _rgb_masks(data, w, h, bitcount, masks)
        return out
    if pfflags & DDPF_LUMINANCE:
        if bitcount == 8:
            out[..., :3] = _raw(data, 128, w * h).reshape(h, w, 1)
        elif bitcount == 16 and pfflags & DDPF_ALPHAPIXELS:
            la = _raw(data, 128, 2 * w * h).reshape(h, w, 2)
            out[..., :3] = la[..., :1]
            out[..., 3] = la[..., 1]
        else:
            raise ValueError(f"DDS: luminance at {bitcount} bits (pixel "
                             f"format flags {pfflags:#x}) is not decoded")
        return out
    if pfflags & DDPF_PALETTEINDEXED8:
        palette = data[128:1152]
        idx = _raw(data, 128 + len(palette), w * h).reshape(h, w)
        return np.frombuffer(palette, np.uint8).reshape(256, 4)[idx]
    if not pfflags & DDPF_FOURCC:
        raise ValueError(f"DDS: unknown pixel format flags {pfflags:#x}")
    offset = 128
    if fourcc == b"DX10":
        if len(data) < 132:
            raise ValueError("DDS: the DX10 header is cut short")
        dxgi = _u32(data, 128)
        if dxgi not in DXGI:
            raise ValueError(f"DDS: DXGI format {dxgi} is not decoded")
        kind, signed = DXGI[dxgi]
        offset = 148
        if not kind:
            return _raw(data, offset, 4 * w * h).reshape(h, w, 4).copy()
    elif fourcc in FOURCCS:
        kind, signed = FOURCCS[fourcc]
    else:
        raise ValueError(f"DDS: pixel format {fourcc!r} "
                         f"({_u32(data, 84)}) is not decoded")
    err = _lib().bcn_decode(data[offset:], len(data) - offset, kind, signed,
                            w, h, out.ctypes.data_as(
                                ctypes.POINTER(ctypes.c_uint8)))
    if err:
        raise ValueError("DDS: image file is truncated")
    return out
