"""WebP decoding to RGBA8, by host C++ of the port's own.

The JAX package decodes textures with ``PIL.Image.open(...).convert(
"RGBA")``. Pillow 12.1.0 decodes every WebP through libwebp's
``WebPAnimDecoder`` and takes its first frame; :func:`decode_webp`
gives the same bytes:

* the RIFF container: a simple ``VP8 `` or ``VP8L`` file, or ``VP8X``
  with an ``ALPH`` chunk beside a ``VP8 `` one, or an animation
  (``ANIM`` and ``ANMF``) of which the first frame is taken;
* the canvas holds the first frame at its offset; the rest is
  transparent black (the anim decoder clears its canvas, it does not
  paint the background colour);
* Pillow's mode is RGBA where the file says it has alpha (the ``VP8X``
  alpha flag, or the alpha hint of a simple ``VP8L`` header), else RGB:
  then every alpha is 255, outside the frame too;
* the bitstreams as libwebp decodes them (``native/webp_decode.cpp``:
  VP8 lossy with its loop filters, fancy upsampling and fixed-point
  YUV -> RGB; VP8L lossless with its four transforms, colour cache,
  meta prefix codes and LZ77; ``ALPH`` raw or VP8L-coded, with its
  filters), built with g++ at first use by :mod:`.native_build` and
  bound with ctypes. Without g++ it raises: there is no fallback.

A file whose chunks are missing or cut short, and a bitstream the
decoder cannot read, raise ``ValueError``.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import native_build

SOURCE = native_build.NATIVE / "webp_decode.cpp"
FOURCCS = (b"VP8 ", b"VP8X", b"VP8L")

_LIB = None


def accept(data: bytes) -> bool:
    """Pillow's WebP test (``WebPImagePlugin._accept``)."""
    return (data.startswith(b"RIFF") and data[8:12] == b"WEBP"
            and data[12:16] in FOURCCS)


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(native_build.build(SOURCE)))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.webp_frame.restype = ctypes.c_int
        lib.webp_frame.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_char_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int64,
            ctypes.c_char_p, ctypes.c_int64]
        _LIB = lib
    return _LIB


def _u24(b, o):
    return int.from_bytes(b[o:o + 3], "little")


def _chunks(data, pos, end):
    """[(fourcc, payload)] of the chunks in data[pos:end]."""
    out = []
    while pos + 8 <= end:
        tag = data[pos:pos + 4]
        size = int.from_bytes(data[pos + 4:pos + 8], "little")
        if pos + 8 + size > end:
            raise ValueError(f"WebP: chunk {tag!r} is cut short")
        out.append((tag, data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def _frame(chunks):
    """(kind, bitstream, ALPH payload or None) of a frame's chunks."""
    alph = None
    for tag, payload in chunks:
        if tag == b"ALPH" and alph is None:
            alph = payload
        elif tag == b"VP8 ":
            return 0, payload, alph
        elif tag == b"VP8L":
            return 1, payload, None
    raise ValueError("WebP: no VP8 or VP8L bitstream in the frame")


def _size(kind, bitstream):
    """The width and height a bitstream's header gives."""
    if kind == 0:
        if len(bitstream) < 10:
            raise ValueError("WebP: the VP8 header is cut short")
        return (int.from_bytes(bitstream[6:8], "little") & 0x3FFF,
                int.from_bytes(bitstream[8:10], "little") & 0x3FFF)
    if len(bitstream) < 5 or bitstream[0] != 0x2F:
        raise ValueError("WebP: bad VP8L header")
    bits = int.from_bytes(bitstream[1:5], "little")
    return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1


def decode_webp(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a WebP file's first frame (see the module
    doc)."""
    data = bytes(data)
    if not accept(data):
        raise ValueError("not a WebP file")
    end = min(len(data), 8 + int.from_bytes(data[4:8], "little"))
    chunks = _chunks(data, 12, end)
    tag, payload = chunks[0]
    x0 = y0 = 0
    if tag == b"VP8X":
        if len(payload) < 10:
            raise ValueError("WebP: the VP8X chunk is cut short")
        flags = payload[0]
        cw, ch = 1 + _u24(payload, 4), 1 + _u24(payload, 7)
        has_alpha = bool(flags & 0x10)
        if flags & 0x02:
            anmf = next((p for t, p in chunks if t == b"ANMF"), None)
            if anmf is None or len(anmf) < 16:
                raise ValueError("WebP: an animation without a frame")
            x0, y0 = 2 * _u24(anmf, 0), 2 * _u24(anmf, 3)
            fw, fh = 1 + _u24(anmf, 6), 1 + _u24(anmf, 9)
            kind, bitstream, alph = _frame(_chunks(anmf, 16, len(anmf)))
        else:
            kind, bitstream, alph = _frame(chunks[1:])
            fw, fh = cw, ch
        if x0 + fw > cw or y0 + fh > ch:
            raise ValueError("WebP: the frame reaches past the canvas")
    else:
        kind, bitstream, alph = _frame(chunks)
        fw, fh = cw, ch = _size(kind, bitstream)
        has_alpha = kind == 1 and bool(bitstream[4] & 0x10)
    out = np.zeros((ch, cw, 4), np.uint8)
    err = ctypes.create_string_buffer(256)
    view = out[y0:, x0:]
    if _lib().webp_frame(
            bitstream, len(bitstream), kind, alph,
            0 if alph is None else len(alph), fw, fh,
            view.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), 4 * cw,
            err, len(err)):
        raise ValueError(f"WebP: {err.value.decode()}")
    if not has_alpha:
        out[..., 3] = 255
    return out
