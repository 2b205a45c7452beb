"""ICO and CUR decoding to RGBA8 in numpy, as Pillow reads them.

The JAX package decodes textures with ``PIL.Image.open(...).convert(
"RGBA")``. :func:`decode_ico` and :func:`decode_cur` give the same bytes
for what Pillow's ``IcoImagePlugin`` and ``CurImagePlugin`` open (Pillow
12.1.0).

ICO: the entry Pillow loads is the first after two stable sorts of the
directory, by colour depth (the entry's bit count, else ``ceil(log2)`` of
its colour count, else 256) and then by width x height, largest first (a
size byte of 0 is 256): the largest entry at its lowest depth. Its data
is

* a PNG (by its signature), decoded by :func:`.png.decode_png` without its
  ``tRNS`` chunk: Pillow's icon keeps the frame's pixels and palette and
  not the transparency the PNG reader puts in its ``info``;
* else a DIB (an info header, no file header), decoded by
  :func:`.bmp.decode_dib` at half its height, the XOR image. Where the
  entry's bit count is 32, alpha is every fourth byte of the pixel data,
  rows bottom-up; else it is the 1-bit AND mask (1 is transparent) that
  ends at the entry's offset + size, rows padded to 32 bits, bottom-up.

CUR: the first entry, unless a later one is larger in both size bytes
(0 read as 0); its DIB at half its height, with no mask. A 32-bit
cursor's fourth bytes are dropped, as a BMP's are, except where its
bitmap starts at byte 22 (one entry, the bitmap straight after it):
Pillow then reads them as alpha.

Refused with ``ValueError`` as Pillow refuses them: a directory or frame
cut short, a frame :mod:`.bmp` or :mod:`.png` refuses, a mask or alpha
that ends before its last row, and a PNG cursor.
"""

from __future__ import annotations

import math

import numpy as np

from . import bmp
from .png import SIGNATURE as PNG_SIGNATURE
from .png import decode_png

ICO_MAGIC = b"\x00\x00\x01\x00"
CUR_MAGIC = b"\x00\x00\x02\x00"


def _u16(b, o):
    return int.from_bytes(b[o:o + 2], "little")


def _u32(b, o):
    return int.from_bytes(b[o:o + 4], "little")


def _entries(data, kind):
    """The directory's 16-byte entries."""
    n = _u16(data, 4)
    out = [data[6 + 16 * i:22 + 16 * i] for i in range(n)]
    if len(data) < 6 or any(len(e) < 16 for e in out):
        raise ValueError(f"{kind}: the directory is cut short")
    if not out:
        raise ValueError(f"{kind}: no image in the directory")
    return out


def accept_ico(data: bytes) -> bool:
    """Whether Pillow's ICO plugin takes the file: its magic bytes and a
    directory of at least one whole entry (else Pillow tries the next
    format)."""
    try:
        return data[:4] == ICO_MAGIC and bool(_entries(data, "ICO"))
    except ValueError:
        return False


def accept_cur(data: bytes) -> bool:
    """Whether Pillow's CUR plugin takes the file: its magic bytes, a
    directory of at least one whole entry, and the chosen bitmap's header
    size in the file (else Pillow tries the next format)."""
    if data[:4] != CUR_MAGIC:
        return False
    try:
        m = _chosen_cursor(_entries(data, "CUR"))
    except ValueError:
        return False
    return _u32(m, 12) + 4 <= len(data)


def _chosen_cursor(entries):
    m = None
    for e in entries:
        if m is None or (e[0] > m[0] and e[1] > m[1]):
            m = e
    return m


def _depth(e):
    bpp, colors = _u16(e, 6), e[2]
    return bpp or (colors != 0 and math.ceil(math.log(colors, 2))) or 256


def decode_ico(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of an icon's largest image at its lowest
    colour depth (see the module doc)."""
    data = bytes(data)
    if not data.startswith(ICO_MAGIC):
        raise ValueError("not an ICO file")
    entries = sorted(_entries(data, "ICO"), key=_depth)
    e = sorted(entries, key=lambda e: (e[0] or 256) * (e[1] or 256),
               reverse=True)[0]
    bpp, size, offset = _u16(e, 6), _u32(e, 8), _u32(e, 12)
    if data[offset:offset + 8] == PNG_SIGNATURE:
        return decode_png(data[offset:], transparency=False)
    rgba, start = bmp.decode_dib(data, offset, halve=True)
    h, w = rgba.shape[:2]
    if bpp == 32:
        alpha = data[start:start + 4 * w * h][3::4]
        if len(alpha) < w * h:
            raise ValueError("ICO: the alpha of a 32-bit image is cut short")
        mask = np.frombuffer(alpha, np.uint8).reshape(h, w)
    else:
        stride = (w + 31) // 32 * 4
        at = offset + size - stride * h
        if at < 0 or at + stride * h > len(data):
            raise ValueError("ICO: the AND mask is cut short")
        rows = np.frombuffer(data, np.uint8, stride * h, at).reshape(h, stride)
        mask = (1 - np.unpackbits(rows, axis=1)[:, :w]) * 255
    rgba[..., 3] = mask[::-1]
    return rgba


def decode_cur(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a cursor's chosen image (see the module
    doc)."""
    data = bytes(data)
    if not data.startswith(CUR_MAGIC):
        raise ValueError("not a CUR file")
    offset = _u32(_chosen_cursor(_entries(data, "CUR")), 12)
    if data[offset:offset + 8] == PNG_SIGNATURE:
        raise ValueError("CUR: a PNG cursor is not read (Pillow reads "
                         "cursors as bitmaps)")
    return bmp.decode_dib(data, offset, halve=True,
                          raw_alpha=offset == 22)[0]
