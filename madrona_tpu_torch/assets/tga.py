"""TGA decoding to RGBA8 in numpy, as Pillow reads it.

The JAX package decodes textures with ``PIL.Image.open(...).convert(
"RGBA")``. :func:`decode_tga` gives the same bytes for what Pillow's
``TgaImagePlugin`` opens (Pillow 12.1.0):

* image types 1 and 9 (colour-mapped, 8-bit indices), 2 and 10
  (true colour: 16 bits as 5-5-5 with bit 15 an inverted alpha, which
  Pillow calls ``BGRA;15Z``; 24 bits BGR; 32 bits BGRA) and 3 and 11
  (grey: 1 bit, 8 bits, 16 bits grey + alpha); the types above 8 are
  run-length coded;
* colour maps of 16- and 24-bit entries, the first ``start`` entries
  zero bytes (decoded as that entry's format decodes zeros), indices
  past the map opaque black. Pillow opens a map of 32-bit entries but
  cannot load it (its RGB palette has no ``BGRA`` unpacker): such files
  raise;
* the two orientation bits: rows from the bottom unless bit 5 is set,
  and a horizontal flip where bit 4 is set;
* run-length packets as Pillow's ``TgaRleDecode.c`` runs them: a raw
  packet may run on across the end of a row, a repeated packet may not.

TGA has no magic bytes: :func:`accept` repeats the header checks of
Pillow's ``_open`` (colour map type 0 or 1, a positive size, a depth of
1, 8, 16, 24 or 32, a known image type, a map depth of 16, 24 or 32),
which decide whether Pillow takes a file for a TGA at all. A header it
takes whose type and depth Pillow has no unpacker for (type 2 at 8 bits,
say), and pixel data that stops early, raise ``ValueError``.
"""

from __future__ import annotations

import numpy as np

# (image type & 7, depth) -> Pillow's rawmode
MODES = {(1, 8): "P", (3, 1): "1", (3, 8): "L", (3, 16): "LA",
         (2, 16): "BGRA;15Z", (2, 24): "BGR", (2, 32): "BGRA"}


def _u16(b, o):
    return int.from_bytes(b[o:o + 2], "little")


def accept(data: bytes) -> bool:
    """Whether Pillow's TGA ``_open`` takes the header."""
    if len(data) < 18:
        return False
    cmap_type, imtype, depth = data[1], data[2], data[16]
    if (cmap_type not in (0, 1) or _u16(data, 12) <= 0
            or _u16(data, 14) <= 0 or depth not in (1, 8, 16, 24, 32)):
        return False
    if imtype not in (1, 2, 3, 9, 10, 11):
        return False
    return not cmap_type or data[7] in (16, 24, 32)


def _bgr15z(v):
    """[..., 4] RGBA of 16-bit little-endian ``BGRA;15Z`` values."""
    v = v.astype(np.uint32)
    return np.stack([((v >> 10) & 31) * 255 // 31,
                     ((v >> 5) & 31) * 255 // 31, (v & 31) * 255 // 31,
                     np.where(v >> 15, 0, 255)], -1).astype(np.uint8)


def _rle(data, pos, h, row_bytes, depth):
    """TgaRleDecode: [h, row_bytes] of the run-length coded rows."""
    out = bytearray(h * row_bytes)
    n_out = len(out)
    o, end = 0, len(data)
    while o < n_out:
        if pos >= end:
            raise ValueError("TGA: the run-length data is cut short")
        head = data[pos]
        n = depth * ((head & 0x7F) + 1)
        if head & 0x80:
            if pos + 1 + depth > end:
                raise ValueError("TGA: the run-length data is cut short")
            if o % row_bytes + n > row_bytes:
                raise ValueError("TGA: a run-length packet runs past a row")
            out[o:o + n] = data[pos + 1:pos + 1 + depth] * (n // depth)
            pos += 1 + depth
        else:
            if pos + 1 + n > end:
                raise ValueError("TGA: the run-length data is cut short")
            n = min(n, n_out - o)
            out[o:o + n] = data[pos + 1:pos + 1 + n]
            pos += 1 + n
        o += n
    return np.frombuffer(bytes(out), np.uint8).reshape(h, row_bytes)


def decode_tga(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a TGA file's bytes (see the module doc)."""
    data = bytes(data)
    if not accept(data):
        raise ValueError("not a TGA file")
    id_len, cmap_type, imtype = data[0], data[1], data[2]
    w, h, depth, flags = _u16(data, 12), _u16(data, 14), data[16], data[17]
    if imtype in (3, 11):
        mode = {1: "1", 16: "LA"}.get(depth, "L")
    elif imtype in (1, 9):
        mode = "P" if cmap_type else "L"
    else:
        mode = "RGB" if depth == 24 else "RGBA"
    orient = flags & 0x30
    pos = 18 + id_len
    palette = None
    if cmap_type:
        start, size, mdepth = _u16(data, 3), _u16(data, 5), data[7]
        if mdepth == 32:
            raise ValueError("TGA: a 32-bit colour map is not decoded "
                             "(Pillow cannot load one)")
        nb = mdepth // 8
        raw = bytes(nb * start) + data[pos:pos + nb * size]
        pos += nb * size
        n = len(raw) // nb
        p = np.frombuffer(raw[:n * nb], np.uint8).reshape(n, nb)
        palette = np.zeros((256, 4), np.uint8)
        palette[:, 3] = 255
        n = min(n, 256)
        if mdepth == 16:
            palette[:n] = _bgr15z(p[:n, 0] | (p[:n, 1].astype(np.uint16)
                                              << 8))
        else:
            palette[:n, :3] = p[:n, 2::-1]
    raw_mode = MODES.get((imtype & 7, depth))
    if raw_mode is None or (raw_mode == "P" and mode != "P"):
        raise ValueError(f"TGA: image type {imtype} at {depth} bits is not "
                         "decoded (Pillow has no unpacker for it)")
    row_bytes = (w * depth + 7) // 8
    if imtype & 8:
        rows = _rle(data, pos, h, row_bytes, (depth + 7) // 8)
    else:
        if pos + h * row_bytes > len(data):
            raise ValueError("TGA: the pixel data is cut short")
        rows = np.frombuffer(data, np.uint8, h * row_bytes,
                             pos).reshape(h, row_bytes)
    if orient in (0, 0x10):
        rows = rows[::-1]
    out = np.empty((h, w, 4), np.uint8)
    if raw_mode == "1":
        out[..., :3] = (np.unpackbits(rows, axis=1)[:, :w] * 255)[..., None]
        out[..., 3] = 255
    elif raw_mode in ("P", "L"):
        idx = rows[:, :w]
        if palette is not None:
            out = palette[idx]
        else:
            out[..., :3] = idx[..., None]
            out[..., 3] = 255
    elif raw_mode == "LA":
        px = rows[:, :2 * w].reshape(h, w, 2)
        out[..., :3] = px[..., :1]
        out[..., 3] = px[..., 1]
    elif raw_mode == "BGRA;15Z":
        px = rows[:, :2 * w].reshape(h, w, 2)
        out = _bgr15z(px[..., 0] | (px[..., 1].astype(np.uint16) << 8))
    else:
        nb = depth // 8
        px = rows[:, :nb * w].reshape(h, w, nb)
        out[..., :3] = px[..., 2::-1]
        out[..., 3] = px[..., 3] if nb == 4 else 255
    if orient in (0x10, 0x30):
        out = out[:, ::-1]
    return np.ascontiguousarray(out)
