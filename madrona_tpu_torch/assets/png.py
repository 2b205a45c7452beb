"""PNG decoding to RGBA8, in numpy and zlib.

The JAX package decodes textures with PIL (``Image.open(...).convert(
"RGBA")``), which the machines with the card lack. This module decodes
the PNG variants asset files carry to the same bytes, not interlaced:
colour types 2 (RGB), 4 (grey and alpha) and 6 (RGBA) at 8 bits a
sample, 0 (grey) and 3 (palette, with ``tRNS`` alpha) at 1, 2, 4 or 8
bits (PIL writes small palettes at 4 bits), every scanline filter (None,
Sub, Up, Average, Paeth). A ``tRNS`` colour key on grey or RGB makes the
matching pixels transparent, as PIL's conversion does. Any other format
or variant (JPEG, 16-bit samples, Adam7 interlacing) raises
``ValueError`` naming it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n


def _average_paeth(lines, kinds, prior, bpp: int) -> np.ndarray:
    """Rows ``lines`` [n, stride] under Average (3) or Paeth (4) below the
    decoded row ``prior``. A pixel (bpp bytes) needs its left, upper and
    upper-left neighbours decoded, so every pixel of an anti-diagonal
    (y + x fixed) is decoded at once: n + w - 1 numpy steps."""
    n, stride = lines.shape
    w = stride // bpp
    line = lines.reshape(n, w, bpp).astype(np.int16)
    # decoded pixels below ``prior`` and right of a zero column
    out = np.zeros((n + 1, w + 1, bpp), np.int16)
    out[0, 1:] = prior.reshape(w, bpp)
    for d in range(n + w - 1):
        y = np.arange(max(0, d - w + 1), min(n, d + 1))
        x = d - y
        a, b, c = out[y + 1, x], out[y, x + 1], out[y, x]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.where(kinds[y][:, None] == 3, (a + b) >> 1, paeth)
        out[y + 1, x + 1] = (line[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8).reshape(n, stride)


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The [h, stride] samples of filtered scanlines (a filter-type byte
    before each row): None, Sub and Up a row at a time, each run of
    Average and Paeth rows by :func:`_average_paeth`."""
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(
        h, stride + 1)
    kinds = rows[:, 0]
    if (kinds > 4).any():
        raise ValueError(f"PNG: unknown scanline filter {kinds.max()}")
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    y = 0
    while y < h:
        kind, line = int(kinds[y]), rows[y, 1:]
        if kind >= 3:
            end = y + 1
            while end < h and kinds[end] >= 3:
                end += 1
            out[y:end] = _average_paeth(rows[y:end, 1:], kinds[y:end],
                                        prior, bpp)
            y = end
        else:
            if kind == 0:
                out[y] = line
            elif kind == 1:      # Sub: a running sum along each channel
                out[y] = np.cumsum(line.reshape(-1, bpp), axis=0,
                                   dtype=np.uint8).reshape(-1)
            else:                # Up
                out[y] = line + prior
            y += 1
        prior = out[y - 1]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a PNG file's bytes (see the module doc)."""
    if not data.startswith(SIGNATURE):
        kind = ("JPEG" if data[:3] == b"\xff\xd8\xff" else
                "an unknown format")
        raise ValueError(f"texture image is {kind}; only PNG is decoded")
    header, palette, trns, idat = None, None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in CHANNELS:
        raise ValueError(f"PNG: colour type {ctype} is not defined")
    if depth != 8 and not (ctype in (0, 3) and depth in (1, 2, 4)):
        raise ValueError(f"PNG: {depth}-bit samples of colour type {ctype} "
                         "are not decoded")
    if interlace:
        raise ValueError("PNG: Adam7 interlacing is not decoded")
    n = CHANNELS[ctype]
    stride = (w * n * depth + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, stride,
                     max(n * depth // 8, 1))
    if depth < 8:
        # samples packed from the high bits of each byte
        bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(
            h, w, depth)
        px = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(
            -1, dtype=np.uint8)[..., None]
    else:
        px = rows.reshape(h, w, n)
    out = np.full((h, w, 4), 255, np.uint8)
    if ctype == 3:
        if palette is None:
            raise ValueError("PNG: palette image without PLTE")
        alpha = np.full(256, 255, np.uint8)
        if trns is not None:
            alpha[:len(trns)] = np.frombuffer(trns, np.uint8)
        rgb = np.zeros((256, 3), np.uint8)
        rgb[:len(palette)] = palette
        idx = px[..., 0]
        out[..., :3] = rgb[idx]
        out[..., 3] = alpha[idx]
        return out
    if ctype == 0 and depth < 8:
        scaled = px.astype(np.int64) * 255 // ((1 << depth) - 1)
        out[..., :3] = scaled.astype(np.uint8)
    elif ctype in (0, 4):
        out[..., :3] = px[..., :1]
    else:
        out[..., :3] = px[..., :3]
    if ctype in (4, 6):
        out[..., 3] = px[..., -1]
    elif trns is not None:
        # a colour key: 16-bit samples of which 8-bit files use the low
        # byte
        key = np.frombuffer(trns, ">u2").astype(np.int64)
        hit = (px.astype(np.int64) == key).all(axis=-1)
        out[..., 3] = np.where(hit, 0, 255)
    return out
