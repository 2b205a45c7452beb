"""PBM, PGM, PPM and PFM decoding to RGBA8 in numpy, as Pillow reads them.

The JAX package decodes textures with ``PIL.Image.open(...).convert(
"RGBA")``. :func:`decode_ppm` gives the same bytes for what Pillow's
``PpmImagePlugin`` opens (Pillow 12.1.0):

* the magic numbers P1-P6, ``Pf``, ``P0CMYK`` and Pillow's own ``PyP``,
  ``PyRGBA`` and ``PyCMYK``; the header's tokens as Pillow reads them (a
  ``#`` comment runs to the end of its line and does not end a token;
  tokens of more than 10 bytes are refused; exactly one whitespace byte
  after the last token);
* P1 and P4 in mode ``"1"`` (1 is black); P1's digits need no space
  between them;
* a maxval other than 255 scaled by Python's ``round(v / maxval * 255)``
  (half to even), in the plain decoder (P2, P3) and the binary one, whose
  samples are 2 bytes from a maxval of 256 on and which clamps a sample
  above maxval to 255; grey at a maxval above 255 is mode ``"I"``, scaled
  to 65535 (P5 at 65535 read as it is) and clipped to 255 by
  ``convert``;
* ``Pf``: 32-bit floats, big-endian where the scale is positive and
  little-endian where it is negative, the rows bottom-up, converted by
  truncation into [0, 255] (NaN and below 0 give 0);
* CMYK converted by Pillow's ``cmyk2rgb``; mode ``"P"`` (``PyP``) has no
  palette, so every pixel is opaque black.

Refused with ``ValueError`` as Pillow refuses them: a header token that
is not a number, cut short or too long, a size or maxval out of range, a
scale of 0 or not finite, a plain sample out of range or not a number,
and pixel data that ends early.
"""

from __future__ import annotations

import math

import numpy as np

from .dds import MAX_PIXELS

WHITESPACE = b"\x20\x09\x0a\x0b\x0c\x0d"
MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
         b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
         b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
BANDS = {"L": 1, "I": 1, "P": 1, "RGB": 3, "RGBA": 4, "CMYK": 4}
SAFEBLOCK = 1 << 20     # ImageFile.SAFEBLOCK: the plain decoder's reads


class _File:
    """The bytes, read as Pillow's plugin reads its file object."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out


def _magic(f: _File) -> bytes:
    magic = b""
    for _ in range(6):
        c = f.read(1)
        if not c or c in WHITESPACE:
            break
        magic += c
    return magic


def accept(data: bytes) -> bool:
    """Whether Pillow's PPM plugin takes the file (its ``_accept`` and a
    known magic number; another magic number lets Pillow try on)."""
    return (len(data) >= 2 and data[:1] == b"P" and data[1] in b"0123456fy"
            and _magic(_File(data)) in MODES)


def _token(f: _File) -> bytes:
    token = b""
    while len(token) <= 10:
        c = f.read(1)
        if not c:
            break
        if c in WHITESPACE:
            if not token:
                continue
            break
        if c == b"#":
            while f.read(1) not in b"\r\n":
                pass
            continue
        token += c
    if not token:
        raise ValueError("PPM: reached the end of the file in the header")
    if len(token) > 10:
        raise ValueError(f"PPM: header token too long ({token[:11]!r})")
    return token


def _int(token: bytes) -> int:
    try:
        return int(token)
    except ValueError:
        raise ValueError(f"PPM: header token {token!r} is not a number")


class _Plain:
    """Pillow's PpmPlainDecoder on the data after the header."""

    def __init__(self, f: _File):
        self.f, self.spans = f, False

    def block(self) -> bytes:
        return self.f.read(SAFEBLOCK)

    @staticmethod
    def comment_end(block, start=0):
        a, b = block.find(b"\n", start), block.find(b"\r", start)
        return min(a, b) if a * b > 0 else max(a, b)

    def strip_comments(self, block: bytes) -> bytes:
        if self.spans:
            while block:
                end = self.comment_end(block)
                if end != -1:
                    block = block[end + 1:]
                    break
                block = self.block()
        self.spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                break
            end = self.comment_end(block, start)
            if end != -1:
                block = block[:start] + block[end + 1:]
            else:
                block = block[:start]
                self.spans = True
                break
        return block

    def bitonal(self, total: int) -> bytes:
        data = b""
        while len(data) != total:
            block = self.block()
            if not block:
                break
            tokens = b"".join(self.strip_comments(block).split())
            bad = tokens.translate(None, b"01")
            if bad:
                raise ValueError(f"PPM: invalid token {bad[:1]!r} for "
                                 "mode 1")
            data = (data + tokens)[:total]
        return data.translate(bytes.maketrans(b"01", b"\xff\x00"))

    def samples(self, total: int, maxval: int, out_max: int) -> list:
        """The first ``total`` samples, scaled to ``out_max``."""
        data = []
        half = b""
        while len(data) != total:
            block = self.block()
            if not block:
                if not half:
                    break
                block = b" "
            block = self.strip_comments(block)
            if half:
                block, half = half + block, b""
            tokens = block.split()
            if block and not block[-1:].isspace():
                half = tokens.pop()
                if len(half) > 10:
                    raise ValueError("PPM: a token too long in the data")
            for token in tokens:
                if len(token) > 10:
                    raise ValueError("PPM: a token too long in the data")
                try:
                    value = int(token)
                except ValueError:
                    raise ValueError(f"PPM: sample {token!r} is not a "
                                     "number")
                if not 0 <= value <= maxval:
                    raise ValueError(f"PPM: sample {value} outside 0 to "
                                     f"{maxval}")
                data.append(round(value / maxval * out_max))
                if len(data) == total:
                    break
        return data


def _need(data, pos, n):
    if pos + n > len(data):
        raise ValueError("PPM: image file is truncated")
    return np.frombuffer(data, np.uint8, n, pos)


def _cmyk2rgb(cmyk):
    """Pillow's cmyk2rgb on [..., 4] uint8."""
    c = cmyk.astype(np.int32)
    nk = 255 - c[..., 3:]
    tmp = c[..., :3] * nk + 128
    return np.clip(nk - (((tmp >> 8) + tmp) >> 8), 0, 255).astype(np.uint8)


def _rgba(px, mode):
    """[h, w, 4] uint8 of samples ``px`` [h, w, bands] in Pillow's
    ``mode``, as ``convert("RGBA")`` gives them."""
    h, w = px.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    if mode == "F":
        v = px[..., 0].astype(np.float32)
        grey = np.zeros(v.shape, np.uint8)
        mid = (v > 0) & (v < 255)
        grey[mid] = v[mid].astype(np.uint8)
        grey[v >= 255] = 255
        out[..., :3] = grey[..., None]
    elif mode == "I":
        out[..., :3] = np.clip(px[..., :1], 0, 255).astype(np.uint8)
    elif mode == "P":
        out[..., :3] = 0
    elif mode == "CMYK":
        out[..., :3] = _cmyk2rgb(px)
    elif mode == "RGBA":
        out[:] = px
    else:       # "1" (0 or 255), "L", "RGB"
        out[..., :3] = px[..., :3] if mode == "RGB" else px
    return out


def decode_ppm(data: bytes) -> np.ndarray:
    """[H, W, 4] uint8 RGBA of a Netpbm file's bytes (see the module
    doc)."""
    data = bytes(data)
    if not accept(data):
        raise ValueError("not a PPM file")
    f = _File(data)
    magic = _magic(f)
    mode = MODES[magic]
    w, h = _int(_token(f)), _int(_token(f))
    if w <= 0 or h <= 0 or w * h > MAX_PIXELS:
        raise ValueError(f"PPM: size {w} x {h}")
    plain = magic in (b"P1", b"P2", b"P3")
    if mode == "1":
        if plain:
            bits = _Plain(f).bitonal(w * h)
            if len(bits) < w * h:
                raise ValueError("PPM: not enough image data")
            px = np.frombuffer(bits, np.uint8).reshape(h, w, 1)
        else:
            stride = (w + 7) // 8
            rows = _need(data, f.pos, stride * h).reshape(h, stride)
            px = ((1 - np.unpackbits(rows, axis=1)[:, :w]) * 255)[..., None]
        return _rgba(px, mode)
    if mode == "F":
        token = _token(f)
        try:
            scale = float(token)
        except ValueError:
            raise ValueError(f"PPM: scale {token!r} is not a number")
        if scale == 0.0 or not math.isfinite(scale):
            raise ValueError("PPM: the scale must be finite and non-zero")
        order = "<f4" if scale < 0 else ">f4"
        v = _need(data, f.pos, 4 * w * h).view(order).reshape(h, w, 1)
        return _rgba(v[::-1], mode)
    maxval = _int(_token(f))
    if not 0 < maxval < 65536:
        raise ValueError(f"PPM: maxval {maxval} outside 1 to 65535")
    if maxval > 255 and mode == "L":
        mode = "I"
    bands = BANDS[mode]
    n = w * h * bands
    out_max = 65535 if mode == "I" else 255
    if plain:
        samples = _Plain(f).samples(n, maxval, out_max)
        if len(samples) < n:
            raise ValueError("PPM: not enough image data")
        px = np.asarray(samples, np.int64)
    elif maxval == 255:
        px = _need(data, f.pos, n)
    elif maxval == 65535 and mode == "I":
        px = _need(data, f.pos, 2 * n).view(">u2")
    else:
        # PpmDecoder: whole pixels while the data lasts
        size = 1 if maxval < 256 else 2
        if f.pos + n * size > len(data):
            raise ValueError("PPM: not enough image data")
        raw = np.frombuffer(data, np.uint8 if size == 1 else ">u2", n, f.pos)
        px = np.minimum(out_max, np.round(raw / maxval * out_max))
    return _rgba(px.reshape(h, w, bands), mode)
