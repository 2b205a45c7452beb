"""The first frame of a GIF as RGBA8, as Pillow gives it.

The JAX package decodes textures with ``PIL.Image.open(...).convert(
"RGBA")``, which for a GIF is its first frame under Pillow's default
``LOADING_STRATEGY`` (``RGB_AFTER_FIRST``; Pillow 12.1.0).
:func:`decode_gif` gives the same bytes:

* the image is the logical screen, grown to hold the first frame's
  rectangle where that reaches past it; outside the rectangle it holds
  index 0, or the frame's transparency index where its graphic control
  extension sets one;
* the frame's local palette, else the global one; a palette equal to
  the grey ramp ``(i, i, i)`` is no palette to Pillow, and the frame is
  then grey (mode ``"L"``): each index is its own grey level. Indices
  past the palette are opaque black;
* the transparency index gives alpha 0: in a palette frame to that
  palette entry (its colour kept), in a grey frame to every pixel of
  that value;
* interlaced rows, and LZW as Pillow's ``GifDecode.c`` runs it
  (``native/gif_decode.cpp``, built with g++ at first use by
  :mod:`.native_build` and bound with ctypes; without g++ it raises).

A frame whose data ends before its last pixel (Pillow reads on past an
early end code and finds the file truncated), broken LZW data and a
file with no frame raise ``ValueError``, as Pillow raises for them.
"""

from __future__ import annotations

import ctypes

import numpy as np

from . import native_build

SOURCE = native_build.NATIVE / "gif_decode.cpp"
MAGICS = (b"GIF87a", b"GIF89a")

_LIB = None
_ERRORS = {1: "image file is truncated", 2: "broken LZW data",
           3: "LZW code size above 12 bits"}


def _lib():
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(native_build.build(SOURCE)))
        lib.gif_lzw.restype = ctypes.c_int
        lib.gif_lzw.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8)]
        _LIB = lib
    return _LIB


def _u16(b, o):
    return int.from_bytes(b[o:o + 2], "little")


def _palette(p):
    """An RGBA [256, 4] table of a colour table, or None where Pillow
    needs none (the grey ramp)."""
    n = len(p) // 3
    if n * 3 != len(p):
        raise ValueError("GIF: a colour table is cut short")
    rgb = np.frombuffer(p, np.uint8).reshape(n, 3)
    if np.array_equal(rgb, np.repeat(np.arange(n, dtype=np.uint8)[:, None],
                                     3, 1)):
        return None
    table = np.zeros((256, 4), np.uint8)
    table[:, 3] = 255
    table[:n, :3] = rgb
    return table


def decode_gif(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a GIF's first frame (see the module doc)."""
    data = bytes(data)
    if not data.startswith(MAGICS) or len(data) < 13:
        raise ValueError("not a GIF file")
    size = [_u16(data, 6), _u16(data, 8)]
    flags, pos = data[10], 13
    global_pal = None
    if flags & 128:
        n = 3 << ((flags & 7) + 1)
        global_pal = _palette(data[pos:pos + n])
        pos += n

    def block(pos):
        """Pillow's data(): one sub-block and the position after it."""
        if pos < len(data) and data[pos]:
            k = data[pos]
            return data[pos + 1:pos + 1 + k], pos + 1 + k
        return None, pos + 1

    transparency = frame = None
    local = None
    while pos < len(data):
        s = data[pos]
        pos += 1
        if s == 0x3B:                                   # trailer
            break
        if s == 0x21:                                   # extension
            label = data[pos] if pos < len(data) else 0
            pos += 1
            blk, pos = block(pos)
            if label == 0xFE:                           # comment
                while blk:
                    blk, pos = block(pos)
                continue
            if label == 0xF9 and blk is not None and blk[0] & 1:
                if len(blk) < 4:
                    raise ValueError("GIF: a graphic control block is cut "
                                     "short")
                transparency = blk[3]
            elif (label == 0xFF and blk is not None
                  and blk.startswith(b"NETSCAPE2.0")):
                _, pos = block(pos)        # the loop count's block
            while True:
                blk, pos = block(pos)
                if not blk:
                    break
        elif s == 0x2C:                                 # image descriptor
            d = data[pos:pos + 9]
            if len(d) < 9:
                raise ValueError("GIF: an image descriptor is cut short")
            pos += 9
            x0, y0, fw, fh = (_u16(d, 0), _u16(d, 2), _u16(d, 4),
                              _u16(d, 6))
            size = [max(x0 + fw, size[0]), max(y0 + fh, size[1])]
            if d[8] & 128:
                n = 3 << ((d[8] & 7) + 1)
                local = _palette(data[pos:pos + n])
                local = False if local is None else local
                pos += n
            if pos >= len(data):
                raise ValueError("GIF: the image data is missing")
            frame = (x0, y0, fw, fh, bool(d[8] & 64), data[pos], pos + 1)
            break
    if frame is None:
        raise ValueError("GIF: no image in the file")
    x0, y0, fw, fh, interlace, bits, start = frame
    pal = local if local is not None else global_pal
    w, h = size
    canvas = np.full((h, w), transparency or 0, np.uint8)
    if fw and fh:
        rect = np.ascontiguousarray(canvas[y0:y0 + fh, x0:x0 + fw])
        err = _lib().gif_lzw(
            data, len(data), start, bits, int(interlace), fw, fh,
            rect.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if err:
            raise ValueError(f"GIF: {_ERRORS[err]}")
        canvas[y0:y0 + fh, x0:x0 + fw] = rect
    if pal is None or pal is False:
        out = np.empty((h, w, 4), np.uint8)
        out[..., :3] = canvas[..., None]
        out[..., 3] = 255
        if transparency is not None:
            out[..., 3][canvas == transparency] = 0
        return out
    if transparency is not None:
        pal = pal.copy()
        pal[transparency, 3] = 0
    return pal[canvas]
