"""BMP and DIB decoding to RGBA8 in numpy, as Pillow reads them.

The JAX package decodes textures with ``PIL.Image.open(...).convert(
"RGBA")``. :func:`decode_bmp` gives the same bytes for what Pillow's
``BmpImagePlugin`` opens (Pillow 12.1.0): a ``BM`` file, or a DIB (the
info header alone, without the 14-byte file header, which Pillow takes
when the file's first four bytes are a header size it knows).

* Info headers of 12 (OS/2 1.x, 16-bit sizes, 3-byte palette entries),
  40, 52, 56, 64, 108 and 124 bytes; a height whose top byte is 0xFF
  marks top-down rows (``2**32 - height`` of them).
* 1, 4 and 8 bits through a palette (entries past the palette are
  opaque black); a palette equal to the grey ramp ``(i, i, i)`` (or to
  black and white at 2 colours) makes the image grey, and Pillow then
  unpacks the rows as 8-bit (or 1-bit) grey whatever the file's depth.
* 16 bits as 5-5-5 and 24 bits as BGR; 32 bits as BGRX: the fourth
  byte is dropped unless the bitfields name an alpha mask (Pillow's
  ``USE_RAW_ALPHA`` is off).
* ``BI_BITFIELDS`` with the masks of Pillow's ``SUPPORTED`` table only:
  16-bit 5-6-5 and 5-5-5, 24-bit BGR, and the 32-bit byte orders.
  5- and 6-bit fields widen as ``v * 255 // 31`` and ``v * 255 // 63``.
* ``BI_RLE8`` and ``BI_RLE4`` as Pillow's ``BmpRleDecoder`` runs them:
  an end of line pads the row with index 0; a delta skips (with index
  0) by the second of the two byte pairs that follow it (Pillow reads
  two pairs there and uses the second); absolute runs align to an even
  offset in the file; a run longer than the row is cut at its end;
  data that stops before the last pixel is refused.

Refused with ``ValueError`` naming the variant, as Pillow refuses it:
another header size, another depth, ``BI_JPEG`` and ``BI_PNG``, other
bitfield masks, palettes of no or more than 65536 colours, RLE at a
depth without a palette, and pixel data that stops early.
"""

from __future__ import annotations

import numpy as np

MAGIC = b"BM"
DIB_HEADERS = (12, 40, 52, 56, 64, 108, 124)

_BIT2RAW = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR",
            32: "BGRX"}
# (bits, masks) -> rawmode: BmpImagePlugin's MASK_MODES
_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_RAW_BITS = {"1": 1, "P;1": 1, "P;4": 4, "P": 8, "L": 8, "BGR;15": 16,
             "BGR;16": 16, "BGR": 24}


def dib_accept(data: bytes) -> bool:
    """Pillow's DIB test: the first four bytes are an info header size."""
    return len(data) >= 4 and _u32(data, 0) in DIB_HEADERS


def _u16(b, o):
    return int.from_bytes(b[o:o + 2], "little")


def _u32(b, o):
    return int.from_bytes(b[o:o + 4], "little")


def _rle(data, pos, w, h, rle4):
    """BmpRleDecoder: the [h * w] indices of the RLE stream at ``pos``
    (file offsets decide the alignment of absolute runs)."""
    out = bytearray()
    x = 0
    n = w * h
    end = len(data)
    while len(out) < n:
        if pos + 2 > end:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            if x + count > w:
                count = max(0, w - x)
            if rle4:
                pair = bytes([byte >> 4, byte & 0x0F])
                out += (pair * ((count + 1) // 2))[:count]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:                     # end of line
            out += bytes(-len(out) % w)
            x = 0
        elif byte == 1:                     # end of bitmap
            break
        elif byte == 2:                     # delta: the second pair
            if pos + 2 > end:
                break
            pos += 2
            if pos + 2 > end:
                raise ValueError("BMP RLE: a delta is cut short")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * w)
            x = len(out) % w
        else:                               # absolute run
            if rle4:
                count = byte // 2
                run = data[pos:pos + count]
                pos += len(run)
                for v in run:
                    out += bytes([v >> 4, v & 0x0F])
            else:
                count = byte
                run = data[pos:pos + count]
                pos += len(run)
                out += run
            if len(run) < count:
                break
            x += byte
            pos += pos % 2
    if len(out) < n:
        raise ValueError("BMP RLE: not enough image data")
    return np.frombuffer(bytes(out[:n]), np.uint8).reshape(h, w)


def _unpack(rows, raw, w):
    """[h, w, c] uint8 of [h, nbytes] rows in Pillow's rawmode ``raw``
    (c = 1 for indices and grey, 3 or 4 for colour)."""
    if raw in ("P;1", "1", "P;4"):
        bits = 1 if raw != "P;4" else 4
        v = np.unpackbits(rows, axis=1) if bits == 1 else np.stack(
            [rows >> 4, rows & 15], -1).reshape(rows.shape[0], -1)
        v = v[:, :w]
        return (v * 255 if raw == "1" else v)[..., None].astype(np.uint8)
    if raw in ("P", "L"):
        return rows[:, :w, None]
    if raw in ("BGR;15", "BGR;16"):
        v = rows[:, :2 * w].astype(np.uint32)
        v = v[:, 0::2] | (v[:, 1::2] << 8)
        if raw == "BGR;15":
            r, g = (v >> 10) & 31, ((v >> 5) & 31) * 255 // 31
        else:
            r, g = (v >> 11) & 31, ((v >> 5) & 63) * 255 // 63
        return np.stack([r * 255 // 31, g, (v & 31) * 255 // 31],
                        -1).astype(np.uint8)
    n = len(raw)
    px = rows[:, :n * w].reshape(rows.shape[0], w, n)
    chans = [px[..., raw.index(c)] for c in "RGB"]
    if "A" in raw:
        chans.append(px[..., raw.index("A")])
    return np.stack(chans, -1)


def decode_bmp(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a BMP or DIB file's bytes (see the module
    doc)."""
    data = bytes(data)
    if data.startswith(MAGIC):
        if len(data) < 18:
            raise ValueError("BMP: the file header is cut short")
        return decode_dib(data, 14, _u32(data, 10))[0]
    if dib_accept(data):
        return decode_dib(data, 0)[0]
    raise ValueError("not a BMP file")


def decode_dib(data: bytes, pos: int, offset: int = 0,
               halve: bool = False, raw_alpha: bool = False):
    """RGBA [H, W, 4] uint8 of the bitmap whose info header starts at
    ``pos`` of ``data``, and where its pixel data starts: at ``offset``,
    or (where it is 0) after the header, its masks and its palette.
    ``halve``: the height is half the header's (rounded down), as an icon
    or cursor's bitmap is read (the second half is its AND mask);
    ``raw_alpha``: uncompressed 32-bit pixels keep their fourth byte as
    alpha (Pillow does so for a cursor whose bitmap starts at byte 22)."""
    header_size = _u32(data, pos)
    head = data[pos + 4:pos + header_size]
    if len(head) < header_size - 4:
        raise ValueError("BMP: the info header is cut short")
    pos += header_size
    masks = None
    if header_size == 12:
        w, h = _u16(head, 0), _u16(head, 2)
        bits, compression, padding, direction = _u16(head, 6), 0, 3, -1
        colors = 0
    elif header_size in DIB_HEADERS:
        y_flip = head[7] == 0xFF
        direction = 1 if y_flip else -1
        w = _u32(head, 0)
        h = 2 ** 32 - _u32(head, 4) if y_flip else _u32(head, 4)
        bits, compression = _u16(head, 10), _u32(head, 12)
        colors, padding = _u32(head, 28), 4
        if compression == 3:
            if len(head) >= 48:
                n = 4 if len(head) >= 52 else 3
                masks = [_u32(head, 36 + 4 * i) for i in range(n)]
            else:
                masks = [_u32(data, pos + 4 * i) for i in range(3)]
                pos += 12
            masks += [0] * (4 - len(masks))
    else:
        raise ValueError(f"BMP: unsupported header type ({header_size})")
    colors = colors or (1 << bits)
    if offset == 14 + header_size and bits <= 8:
        offset += 4 * colors
    if bits not in _BIT2RAW:
        raise ValueError(f"BMP: unsupported pixel depth ({bits})")
    raw = _BIT2RAW[bits]
    mode = "P" if bits <= 8 else "RGB"
    rle = False
    if compression == 3:
        key4, key3 = (bits, tuple(masks)), (bits, tuple(masks[:3]))
        if bits == 32 and key4 in _MASK_MODES:
            raw = _MASK_MODES[key4]
            mode = "RGBA" if "A" in raw else mode
        elif bits in (24, 16) and key3 in _MASK_MODES:
            raw = _MASK_MODES[key3]
        else:
            raise ValueError("BMP: unsupported bitfields layout "
                             f"({bits} bits, masks {masks})")
    elif compression in (1, 2):
        rle = True
    elif compression == 0 and bits == 32 and raw_alpha:
        raw, mode = "BGRA", "RGBA"
    elif compression != 0:
        raise ValueError(f"BMP: unsupported compression ({compression}"
                         f"{', JPEG' if compression == 4 else ''}"
                         f"{', PNG' if compression == 5 else ''})")
    palette = None
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"BMP: unsupported palette size ({colors})")
        pal = data[pos:pos + padding * colors]
        pos += len(pal)
        ramp = (0, 255) if colors == 2 else range(colors)
        grey = all(pal[i * padding:i * padding + 3] == bytes([v & 255]) * 3
                   for i, v in enumerate(ramp))
        if grey:
            mode = "1" if colors == 2 else "L"
            raw = mode
        else:
            n = len(pal) // padding
            p = np.frombuffer(pal[:n * padding], np.uint8).reshape(n, padding)
            palette = np.zeros((256, 4), np.uint8)
            palette[:, 3] = 255
            palette[:min(n, 256), :3] = p[:256, 2::-1]
    start = offset or pos
    if w <= 0 or h <= 0 or w * h > 1 << 28:
        raise ValueError(f"BMP: unsupported size {w} x {h}")
    if halve:
        h //= 2
        if not h:
            raise ValueError("BMP: an icon bitmap of one row")
    if rle:
        if mode not in ("P", "L"):
            raise ValueError(f"BMP: RLE at {bits} bits per pixel")
        px = _rle(data, start, w, h, compression == 2)[..., None]
        if direction == -1:
            px = px[::-1]
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        nbytes = (w * _RAW_BITS.get(raw, 8 * len(raw)) + 7) // 8
        if nbytes > stride:
            raise ValueError(f"BMP: {raw} rows do not fit {bits}-bit rows")
        if start + (h - 1) * stride + nbytes > len(data):
            raise ValueError("BMP: the pixel data is cut short")
        buf = np.frombuffer(data, np.uint8, (h - 1) * stride + nbytes, start)
        rows = np.pad(buf, (0, stride - nbytes)).reshape(h, stride)
        if direction == -1:
            rows = rows[::-1]
        px = _unpack(np.ascontiguousarray(rows), raw, w)
    if palette is not None:
        return palette[px[..., 0]], start
    out = np.empty((h, w, 4), np.uint8)
    if px.shape[-1] == 1:
        out[..., :3] = px
        out[..., 3] = 255
    else:
        out[..., :3] = px[..., :3]
        out[..., 3] = px[..., 3] if px.shape[-1] == 4 else 255
    return out, start
