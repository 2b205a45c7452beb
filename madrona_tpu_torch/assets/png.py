"""PNG decoding to RGBA8, in numpy and zlib.

The JAX package decodes textures with PIL (``Image.open(...).convert(
"RGBA")``), which the machines with the card lack. This module decodes
every PNG PIL reads to the same bytes: colour types 0 (grey) at 1, 2, 4,
8 and 16 bits, 3 (palette, with ``tRNS`` alpha) at 1, 2, 4 and 8, and 2
(RGB), 4 (grey and alpha) and 6 (RGBA) at 8 and 16; every scanline
filter (None, Sub, Up, Average, Paeth); plain or Adam7-interlaced rows.

Pillow opens 16-bit files in its own modes, and its conversion gives:
  * grey ("I;16"): each sample clipped to 255 (not its high byte);
  * RGB ("RGB;16B"), grey and alpha ("LA;16B") and RGBA ("RGBA;16B"):
    the high byte of each sample.
A ``tRNS`` colour key on grey or RGB makes transparent the pixels whose
converted 8-bit samples equal the key's low byte (Pillow's
``rgbT2rgba``), at every depth: at 16 bits, the low byte of the 16-bit
key against the clipped or high-byte samples; at 2 and 4 bits, the raw
key against the scaled grey (so only a key of 0 can match); at 1 bit a
key of 1 means white. Any other variant raises ``ValueError`` naming it.
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


ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))  # (y0, x0, dy, dx)


def _samples(raw: bytes, h: int, w: int, n: int, depth: int) -> np.ndarray:
    """[h, w, n] samples (uint8, or uint16 at 16 bits) of ``h``
    filtered scanlines of ``w`` pixels."""
    stride = (w * n * depth + 7) // 8
    rows = _unfilter(raw, h, stride, max(n * depth // 8, 1))
    if depth == 16:
        return rows.view(">u2").reshape(h, w, n).astype(np.uint16)
    if depth == 8:
        return rows.reshape(h, w, n)
    # samples packed from the high bits of each byte
    bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
    return (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(
        -1, dtype=np.uint8)[..., None]


def decode_png(data: bytes, transparency: bool = True) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a PNG file's bytes (see the module doc);
    ``transparency=False`` ignores the ``tRNS`` chunk (as an icon's PNG
    frame is read)."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file (no PNG signature)")
    header, palette, trns, idat = None, None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS" and transparency:
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
    allowed = {0: (1, 2, 4, 8, 16), 3: (1, 2, 4, 8)}.get(ctype, (8, 16))
    if depth not in allowed:
        raise ValueError(f"PNG: {depth}-bit samples of colour type {ctype} "
                         "are not defined")
    if interlace > 1:
        raise ValueError(f"PNG: interlace method {interlace} is not defined")
    n = CHANNELS[ctype]
    raw = zlib.decompress(b"".join(idat))
    if not interlace:
        px = _samples(raw, h, w, n, depth)
    else:
        px = np.zeros((h, w, n), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for y0, x0, dy, dx in ADAM7:
            ph, pw = -(-(h - y0) // dy), -(-(w - x0) // dx)
            if ph <= 0 or pw <= 0:
                continue
            size = ph * ((pw * n * depth + 7) // 8 + 1)
            px[y0::dy, x0::dx] = _samples(raw[pos:pos + size], ph, pw, n,
                                          depth)
            pos += size
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
    if depth == 16:
        # Pillow: "I;16" grey clipped to 255, the other modes' high bytes
        conv = (np.minimum(px, 255) if ctype == 0 else px >> 8).astype(
            np.uint8)
    elif ctype == 0 and depth < 8:
        conv = (px.astype(np.int64) * 255 // ((1 << depth) - 1)).astype(
            np.uint8)
    else:
        conv = px
    out[..., :3] = conv[..., :1] if ctype in (0, 4) else conv[..., :3]
    if ctype in (4, 6):
        out[..., 3] = conv[..., -1]
    elif trns is not None:
        # a colour key: Pillow compares the converted samples with the
        # key's low byte (a 1-bit key is black or white)
        key = np.frombuffer(trns, ">u2").astype(np.int64)
        if depth == 1:
            key = np.where(key != 0, 255, 0)
        hit = (conv.astype(np.int64) == (key & 0xFF)).all(axis=-1)
        out[..., 3] = np.where(hit, 0, 255)
    return out
