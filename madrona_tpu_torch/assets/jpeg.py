"""JPEG decoding to RGBA8, by host C++ of the port's own.

The JAX package decodes textures with PIL (``Image.open(...).convert(
"RGBA")``, through libjpeg-turbo), which the machines with the card
lack. :func:`decode_jpeg` gives the same bytes for the files asset
packages carry: baseline, extended-sequential and progressive Huffman
JPEG at 8 bits; 1 component (grey), 3 (YCbCr, or RGB under an Adobe
transform 0 or with component ids R, G, B) and 4 (Adobe CMYK, and YCCK
under an Adobe transform 2, taken as Pillow takes them: inverted CMYK
converted by its ``cmyk2rgb``); sampling factors of 1 or 2 (4:4:4,
4:2:2, 4:2:0, 4:4:0 and their mixtures); restart intervals; any size.
The decoder repeats libjpeg-turbo's arithmetic: the integer "islow"
IDCT, fancy upsampling, the fixed-point YCbCr -> RGB tables, and the
block smoothing of a progressive file whose scans leave one of the
first nine coefficients unrefined. No EXIF orientation is applied
(PIL's ``open`` and ``convert`` apply none).

Refused with ``ValueError`` naming the variant: arithmetic coding,
12-bit samples, lossless and hierarchical JPEG, sampling factors above 2,
and 2-component files.

The decoder is ``native/jpeg_decode.cpp`` (entropy decoding is a serial
bit loop), built with g++ at first use (:mod:`.native_build`) and bound
with ctypes. Without g++, or if the build fails, it raises: there is no
fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import native_build

SOURCE = native_build.NATIVE / "jpeg_decode.cpp"
MAGIC = b"\xff\xd8\xff"

_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(native_build.build(SOURCE)))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.jpeg_decode.restype = ctypes.c_int
        lib.jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(u8p),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p, ctypes.c_int64,
        ]
        lib.jpeg_free.argtypes = [u8p]
        _LIB = lib
    return _LIB


def decode_jpeg(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a JPEG file's bytes (see the module doc)."""
    data = bytes(data)
    if not data.startswith(MAGIC):
        raise ValueError("not a JPEG file (no SOI marker)")
    lib = _lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    w, h = ctypes.c_int32(), ctypes.c_int32()
    err = ctypes.create_string_buffer(256)
    if lib.jpeg_decode(data, len(data), ctypes.byref(out), ctypes.byref(w),
                       ctypes.byref(h), err, len(err)):
        raise ValueError(err.value.decode())
    try:
        return np.ctypeslib.as_array(out, shape=(h.value, w.value, 4)).copy()
    finally:
        lib.jpeg_free(out)
