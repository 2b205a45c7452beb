"""QOI decoding to RGBA8, as Pillow reads it.

The JAX package decodes textures with ``PIL.Image.open(...).convert(
"RGBA")``. :func:`decode_qoi` gives the same bytes for what Pillow's
``QoiImagePlugin`` opens (Pillow 12.1.0): a 14-byte header (``qoif``, the
big-endian width and height, the channel count: 3 gives mode RGB, whose
alpha ``convert`` makes 255, anything else RGBA; the colour space byte is
not read) and the ops as Pillow's ``QoiDecoder`` runs them
(``native/qoi_decode.cpp``, built with g++ at first use by
:mod:`.native_build` and bound with ctypes; without g++ it raises).

Refused with ``ValueError`` as Pillow refuses them: a header cut short, a
zero width or height, and ops that end before the last pixel.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import native_build
from .dds import MAX_PIXELS

SOURCE = native_build.NATIVE / "qoi_decode.cpp"
MAGIC = b"qoif"

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(native_build.build(SOURCE)))
        lib.qoi_decode.restype = ctypes.c_int
        lib.qoi_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8)]
        _LIB = lib
    return _LIB


def decode_qoi(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a QOI file's bytes (see the module doc)."""
    data = bytes(data)
    if not data.startswith(MAGIC):
        raise ValueError("not a QOI file")
    if len(data) < 13:
        raise ValueError("QOI: the header is cut short")
    w, h = (int.from_bytes(data[4:8], "big"),
            int.from_bytes(data[8:12], "big"))
    if not w or not h or w * h > MAX_PIXELS:
        raise ValueError(f"QOI: size {w} x {h}")
    out = np.empty((h, w, 4), np.uint8)
    if _lib().qoi_decode(data, len(data), 14, w * h,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))):
        raise ValueError("QOI: the data ends before the last pixel")
    if data[12] == 3:
        out[..., 3] = 255
    return out
