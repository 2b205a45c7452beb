"""The port's BMP, TGA, GIF and WebP decoders (madrona_tpu_torch.assets.
bmp, .tga, .gif, .webp) against PIL.Image.open(...).convert("RGBA"),
which the JAX package's importers decode with, byte for byte (no
tolerance), through the importer's dispatch (_decode_image):
  * files PIL writes from seeded images: BMP from modes 1, L, P and RGB;
    TGA from 1, L, LA, P, RGB and RGBA with and without RLE; GIF from
    L and P with and without transparency; WebP lossy (qualities 0 to
    100, with alpha at alpha qualities 10 to 100), lossless (methods 0
    to 6, 2 to 256 colours), and animated with and without alpha;
  * files this module's own writers make, for what PIL does not write:
    BMP with each info header size, as a DIB, at 1, 4, 8, 16, 24 and 32
    bits, with short palettes, grey palettes, RLE4 and RLE8 (deltas, end
    of line, absolute runs at odd offsets), every bitfield layout Pillow
    takes, top-down rows; TGA of image types 1, 2, 3, 9, 10 and 11 at
    every depth Pillow takes, with 16- and 24-bit colour maps from a
    nonzero first index, both orientation bits, raw packets running
    across rows; GIF through this module's LZW writer (interlaced, local
    and global palettes, grey ramps, a frame smaller than and reaching
    past the screen, transparency, codes up to 12 bits with and without
    a clear at a full table, no end code); WebP with the ALPH
    chunk rewritten raw and VP8L-coded under each of its four filters,
    animations whose first frame lies at an offset, and random VP8
    bitstreams from this module's bool encoder (segments with their
    quantisers and filter levels, both loop filters at every sharpness,
    filter deltas, 1 to 8 token partitions, skip flags, coefficient
    probability updates, every intra mode);
  * the variants PIL and the port both refuse (a TGA with a 32-bit
    colour map, a 4-bit BMP with the grey ramp, RLE data short of pixels,
    a GIF frame whose data ends early or is cut short, ...), and the
    formats PIL opens that the port does not decode, each with a
    ValueError naming it;
  * the decoders' g++ builds into a fresh directory, and the time of a
    1024 x 1024 lossy WebP with alpha and a 1024 x 1024 GIF (their RGBA
    by the SHA-256 in tests/goldens/torch_images.npz; printed with -s).

The golden files for the card (``golden_files``) are written into
tests/goldens/torch_images.npz with the others by ``python
tests/test_torch_image_decode.py --write-goldens``."""

import hashlib
import io
import os
import re
import struct
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

Image = pytest.importorskip("PIL.Image")

from madrona_tpu_torch.assets import gif, native_build, webp  # noqa: E402
from madrona_tpu_torch.assets.importer import _decode_image  # noqa: E402

GOLDENS = os.path.join(ROOT, "tests", "goldens", "torch_images.npz")
BIG = 1024                  # the timed files' side
DECODE_LIMIT_S = 2.0        # each timed decode on the CPU


def pil_rgba(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def check(files):
    """Each file decodes as PIL decodes it, or both raise."""
    n_refused = 0
    for i, data in enumerate(files):
        try:
            want = pil_rgba(data)
        except Exception:
            want = None
        if want is None:
            with pytest.raises(ValueError):
                _decode_image(data, f"file {i}")
            n_refused += 1
            continue
        got = _decode_image(data, f"file {i}").data
        assert got.shape == want.shape, i
        np.testing.assert_array_equal(got, want, err_msg=f"file {i}")
    return n_refused


def seeded(h, w, c, seed, kind="smooth"):
    """[h, w, c] uint8 of a seed: "noise", or "smooth" (waves, a little
    noise)."""
    rs = np.random.RandomState(seed)
    if kind == "noise":
        return rs.randint(0, 256, (h, w, c)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    a = np.stack([128 + 100 * np.sin(xx / 7 + yy / 11),
                  128 + 90 * np.cos(yy / 5 - xx / 13),
                  (xx * 3 + yy * 5) % 256, 255 - (xx * yy) % 256][:c], -1)
    return np.clip(a + rs.randint(-12, 13, a.shape), 0, 255).astype(
        np.uint8)


def pil_file(img, fmt, mode=None, **kw):
    im = Image.fromarray(img)
    if mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


# ------------------------------------------------------------------- BMP

def bmp_file(rows, w, h, bits, *, header=40, compression=0, palette=None,
             pal_bytes=None, masks=(), colors=None, top_down=False,
             dib=False, offset=None, pre_pad=b""):
    """A BMP (or DIB) of packed ``rows`` (bytes, first row of the file
    first): ``palette`` [n, 3] RGB written with 4-byte (3-byte at header
    12) entries; ``masks`` written after a 40-byte header or inside a
    longer one."""
    if palette is not None:
        k = 3 if header == 12 else 4
        pal = b"".join(bytes([b, g, r] + [0] * (k - 3))
                       for r, g, b in np.asarray(palette, np.uint8))
    else:
        pal = pal_bytes or b""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        hh = (2 ** 32 - h) if top_down else h
        info = struct.pack("<IIIHHIIiiII", header, w, hh, 1, bits,
                           compression, len(rows), 2835, 2835,
                           len(pal) // 4 if colors is None else colors, 0)
        body = b"".join(struct.pack("<I", m) for m in masks)
        if header > 40:
            info += (body + bytes(header - 40))[:header - 40]
        else:
            info += body
    head = info + pal + pre_pad
    if dib:
        return head + rows
    off = 14 + len(head) if offset is None else offset
    return (b"BM" + struct.pack("<IHHI", 14 + len(head) + len(rows), 0, 0,
                                off) + head + rows)


def pack_rows(px, bits, bottom_up=True):
    """[h, w] indices or [h, w, nb] bytes -> padded rows (bytes)."""
    px = np.asarray(px, np.uint8)
    h, w = px.shape[:2]
    stride = ((w * bits + 31) >> 3) & ~3
    if bits < 8:
        per = 8 // bits
        pad = np.zeros((h, -w % per), np.uint8)
        v = np.concatenate([px, pad], 1).reshape(h, -1, per)
        row = np.zeros(v.shape[:2], np.uint8)
        for i in range(per):
            row |= v[..., i] << (8 - bits * (i + 1))
    else:
        row = px.reshape(h, -1)
    out = np.zeros((h, stride), np.uint8)
    out[:, :row.shape[1]] = row
    return (out[::-1] if bottom_up else out).tobytes()


def rle_stream(idx, rle4, rs, start):
    """An RLE8/RLE4 stream of [h, w] indices (bottom row first), from
    file offset ``start`` (absolute runs are padded to even offsets of
    the file, as Pillow reads them), with encoded and absolute runs, the
    end of every row, and an end of bitmap."""
    out = bytearray()
    h, w = idx.shape
    for y in range(h - 1, -1, -1):
        row = idx[y]
        x = 0
        while x < w:
            n = int(rs.randint(1, 9))
            n = min(n, w - x)
            if rs.rand() < 0.5 or n < 3:
                v = row[x]
                if rle4:
                    b = (int(row[x]) << 4) | int(row[x + 1] if n > 1
                                                 and x + 1 < w else row[x])
                    if n > 1:
                        n = 2 if row[x + 1] != row[x] else n
                    out += bytes([n, b])
                    # pixels alternate between the two nibbles
                    seq = [(b >> 4), b & 15] * n
                    row_part = np.array(seq[:n], np.uint8)
                    idx[y, x:x + n] = row_part
                else:
                    out += bytes([n, v])
                    idx[y, x:x + n] = v
            else:
                if rle4:
                    n -= n % 2
                    data = row[x:x + n]
                    out += bytes([0, n]) + bytes(
                        (int(a) << 4) | int(b) for a, b in
                        zip(data[0::2], data[1::2]))
                else:
                    out += bytes([0, n]) + bytes(row[x:x + n])
                if (start + len(out)) % 2:
                    out += b"\x00"
            x += n
        out += b"\x00\x00"
    out += b"\x00\x01"
    return bytes(out)


def bmp_files():
    rs = np.random.RandomState(1)
    files = []
    img = seeded(13, 21, 3, 0)
    for mode in ("1", "L", "P", "RGB"):
        files.append(pil_file(img, "BMP", mode))
    for bits in (1, 4, 8):
        for h, w in ((5, 7), (1, 1), (9, 33)):
            n = 1 << bits
            idx = rs.randint(0, n, (h, w))
            for header in (12, 40, 56, 124):
                pal = rs.randint(0, 256, (n, 3))
                files.append(bmp_file(pack_rows(idx, bits), w, h, bits,
                                      header=header, palette=pal))
            # a short palette: indices past it are black
            files.append(bmp_file(pack_rows(idx, bits), w, h, bits,
                                  palette=rs.randint(0, 256, (n // 2 + 1,
                                                              3))))
            # grey ramp palettes (Pillow drops the palette)
            ramp = np.repeat(np.arange(n)[:, None], 3, 1)
            if bits == 1:
                ramp = np.array([[0] * 3, [255] * 3])
            files.append(bmp_file(pack_rows(idx, bits), w, h, bits,
                                  palette=ramp))
            files.append(bmp_file(pack_rows(idx, bits, False), w, h, bits,
                                  palette=rs.randint(0, 256, (n, 3)),
                                  top_down=True))
    # a palette of 2 grey levels at 8 bits: Pillow unpacks 1-bit rows
    idx = rs.randint(0, 2, (6, 20))
    files.append(bmp_file(pack_rows(idx, 8), 20, 6, 8,
                          palette=[[0] * 3, [255] * 3]))
    # DIB (no file header) and a data offset past the header
    idx = rs.randint(0, 16, (7, 9))
    files.append(bmp_file(pack_rows(idx, 4), 9, 7, 4, dib=True,
                          palette=rs.randint(0, 256, (16, 3))))
    files.append(bmp_file(pack_rows(idx, 4), 9, 7, 4, pre_pad=b"\x55" * 6,
                          palette=rs.randint(0, 256, (16, 3)),
                          offset=14 + 40 + 64 + 6))
    for h, w in ((5, 7), (4, 1), (11, 17)):
        px = rs.randint(0, 256, (h, w, 4)).astype(np.uint8)
        v16 = rs.randint(0, 65536, (h, w)).astype("<u2")
        b16 = v16[..., None].view(np.uint8).reshape(h, w, 2)
        files.append(bmp_file(pack_rows(b16, 16), w, h, 16))
        files.append(bmp_file(pack_rows(px[..., :3], 24), w, h, 24))
        files.append(bmp_file(pack_rows(px, 32), w, h, 32))
        files.append(bmp_file(pack_rows(px, 32, False), w, h, 32,
                              top_down=True, header=108))
        for masks in ((0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)):
            for header in (40, 56, 124):
                files.append(bmp_file(pack_rows(b16, 16), w, h, 16,
                                      header=header, compression=3,
                                      masks=masks + (0,)[:header // 56]))
        files.append(bmp_file(pack_rows(px[..., :3], 24), w, h, 24,
                              compression=3,
                              masks=(0xFF0000, 0xFF00, 0xFF)))
        for masks in ((0xFF0000, 0xFF00, 0xFF, 0x0),
                      (0xFF000000, 0xFF0000, 0xFF00, 0x0),
                      (0xFF000000, 0xFF00, 0xFF, 0x0),
                      (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                      (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                      (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                      (0xFF000000, 0xFF00, 0xFF, 0xFF0000),
                      (0x0, 0x0, 0x0, 0x0)):
            files.append(bmp_file(pack_rows(px, 32), w, h, 32, header=56,
                                  compression=3, masks=masks))
        # 40-byte header: the masks follow it, alpha never
        files.append(bmp_file(pack_rows(px, 32), w, h, 32, compression=3,
                              masks=(0xFF0000, 0xFF00, 0xFF)))
    # RLE8 and RLE4: runs, absolute runs, the end of rows
    for rle4 in (False, True):
        for h, w in ((6, 9), (1, 5), (12, 31)):
            n = 16 if rle4 else 256
            idx = rs.randint(0, n, (h, w)).astype(np.uint8)
            idx[:, w // 2:] = idx[:, :1]
            pal = rs.randint(0, 256, (n, 3))
            start = 14 + 40 + 4 * n
            stream = rle_stream(idx, rle4, rs, start)
            files.append(bmp_file(stream, w, h, 4 if rle4 else 8,
                                  compression=2 if rle4 else 1,
                                  palette=pal))
    # RLE8 end of line in mid row (zeros), a delta (Pillow reads the
    # second byte pair after it), a run cut at the row's end, an
    # absolute run at an odd offset, and data that ends early
    pal = rs.randint(0, 256, (256, 3))
    for stream in (bytes([3, 7, 0, 0, 2, 9, 0, 0, 12, 5, 0, 1]),
                   bytes([2, 7, 0, 2, 1, 1, 1, 1, 1, 3, 0, 0, 6, 4, 0, 1]),
                   bytes([0, 3, 1, 2, 3, 0, 0, 0, 0, 4, 9, 8, 7, 6, 0, 0,
                          6, 1, 0, 1]),
                   bytes([0, 3, 1, 2, 3, 5, 6, 2, 9, 0, 0, 0, 6, 3, 0, 0, 6,
                          4, 0, 1]),
                   bytes([4, 7, 0, 1])):
        files.append(bmp_file(stream, 6, 3, 8, compression=1, palette=pal))
    return files


# ------------------------------------------------------------------- TGA

def tga_file(imtype, depth, w, h, pixels, *, cmap=None, flags=0x20,
             ident=b""):
    """A TGA: ``cmap`` = (first index, entries bytes, entry bits)."""
    start, entries, mdepth = cmap if cmap else (0, b"", 0)
    n = len(entries) // max(mdepth // 8, 1) if cmap else 0
    head = struct.pack("<BBBHHBHHHHBB", len(ident), 1 if cmap else 0, imtype,
                       start, n, mdepth, 0, 0, w, h, depth, flags)
    return head + ident + entries + pixels


def tga_rle(rows, depth, rs, cross=True):
    """Run-length packets of [h, row_bytes] rows (pixels of depth bytes):
    raw packets that may run across a row's end, repeated packets inside
    a row."""
    h = rows.shape[0]
    px = rows.reshape(h, -1, depth)
    w = px.shape[1]
    flat = px.reshape(-1, depth)
    out = bytearray()
    i, total = 0, len(flat)
    while i < total:
        x = i % w
        n = int(rs.randint(1, 12))
        if rs.rand() < 0.4:
            n = min(n, w - x, 128)
            out += bytes([0x80 | (n - 1)]) + flat[i].tobytes()
            flat[i:i + n] = flat[i]
        else:
            n = min(n, (total - i) if cross else (w - x), 128)
            out += bytes([n - 1]) + flat[i:i + n].tobytes()
        i += n
    return bytes(out), flat.reshape(rows.shape)


def tga_files():
    rs = np.random.RandomState(2)
    files = []
    img = seeded(11, 14, 4, 1)
    for mode in ("1", "L", "LA", "P", "RGB", "RGBA"):
        for compression in (None, "tga_rle"):
            files.append(pil_file(img, "TGA", mode, compression=compression))
    for h, w in ((5, 7), (1, 1), (9, 13), (3, 40)):
        for imtype, depth in ((1, 8), (2, 16), (2, 24), (2, 32), (3, 1),
                              (3, 8), (3, 16)):
            row_bytes = (w * depth + 7) // 8
            rows = rs.randint(0, 256, (h, row_bytes)).astype(np.uint8)
            cmaps = [None]
            if imtype == 1:
                cmaps = [(start, rs.randint(0, 256, (k * mb // 8,))
                          .astype(np.uint8).tobytes(), mb)
                         for start, k, mb in ((0, 256, 24), (5, 200, 16),
                                              (17, 100, 32), (3, 250, 24))]
            for cmap in cmaps:
                for flags in (0x00, 0x10, 0x20, 0x30):
                    files.append(tga_file(imtype, depth, w, h,
                                          rows.tobytes(), cmap=cmap,
                                          flags=flags, ident=b"id!"[:h % 4]))
                    if depth >= 8:
                        data, _ = tga_rle(rows.copy(), depth // 8, rs)
                        files.append(tga_file(imtype | 8, depth, w, h, data,
                                              cmap=cmap, flags=flags))
    return files


# ------------------------------------------------------------------- GIF

class BitWriter:
    """LSB-first bits, as GIF's LZW codes are packed."""

    def __init__(self):
        self.out = bytearray()
        self.acc = self.n = 0

    def put(self, v, k):
        self.acc |= v << self.n
        self.n += k
        while self.n >= 8:
            self.out.append(self.acc & 255)
            self.acc >>= 8
            self.n -= 8

    def bytes(self):
        return bytes(self.out) + (bytes([self.acc]) if self.n else b"")


def lzw(indices, bits, *, clear_full=True, clear_every=0, stop=None,
        eoi=True):
    """GIF LZW codes of ``indices`` with code size ``bits``. The decoder's
    code width is followed code by code (it grows when its table's new
    entry is the last of the width; a full table adds nothing). A full
    table is cleared where ``clear_full``, else codes stay 12 bits wide;
    ``clear_every`` clears after so many codes; ``stop`` ends the data
    after so many indices."""
    clear, end = 1 << bits, (1 << bits) + 1
    bw = BitWriter()
    state = {}

    def reset():
        state.update(table={(i,): i for i in range(clear)}, nxt=clear + 2,
                     dnext=clear + 2, dcs=bits + 1, first=True, count=0)

    def emit(code):
        bw.put(code, state["dcs"])
        if not state["first"] and state["dnext"] < 4096:
            if (state["dnext"] == (1 << state["dcs"]) - 1
                    and state["dcs"] < 12):
                state["dcs"] += 1
            state["dnext"] += 1
        state["first"] = False

    reset()
    bw.put(clear, state["dcs"])
    seq = [int(v) for v in indices[:stop]]
    i = 0
    while i < len(seq):
        w = (seq[i],)
        i += 1
        while i < len(seq) and w + (seq[i],) in state["table"]:
            w = w + (seq[i],)
            i += 1
        emit(state["table"][w])
        state["count"] += 1
        if i < len(seq) and state["nxt"] < 4096:
            state["table"][w + (seq[i],)] = state["nxt"]
            state["nxt"] += 1
        if ((clear_full and state["nxt"] >= 4096)
                or (clear_every and state["count"] >= clear_every)):
            bw.put(clear, state["dcs"])
            reset()
    if eoi:
        bw.put(end, state["dcs"])
    return bw.bytes()


def sub_blocks(data, rs, terminate=True):
    out = bytearray()
    i = 0
    while i < len(data):
        k = int(rs.randint(1, 256))
        out += bytes([len(data[i:i + k])]) + data[i:i + k]
        i += k
    return bytes(out) + (b"\x00" if terminate else b"")


def gif_file(screen, frames, *, global_pal=None, rs, version=b"GIF89a",
             trailer=True):
    """A GIF: ``frames`` of dicts (rect (x, y, w, h), indices [h, w],
    bits, local palette, interlace, transparency, LZW options)."""
    w, h = screen
    flags, pal = 0, b""
    if global_pal is not None:
        n = len(global_pal)
        size = max(int(np.ceil(np.log2(n))), 1)
        flags = 0x80 | (size - 1)
        pal = np.zeros((1 << size, 3), np.uint8)
        pal[:n] = global_pal
        pal = pal.tobytes()
    out = bytearray(version + struct.pack("<HHBBB", w, h, flags, 3, 0) + pal)
    for f in frames:
        if f.get("transparency") is not None:
            out += b"\x21\xf9\x04" + bytes([1]) + b"\x05\x00" + bytes(
                [f["transparency"]]) + b"\x00"
        if f.get("comment"):
            out += b"\x21\xfe" + sub_blocks(f["comment"], rs)
        x0, y0, fw, fh = f["rect"]
        fl = 0x40 if f.get("interlace") else 0
        lp = b""
        if f.get("local") is not None:
            n = len(f["local"])
            size = max(int(np.ceil(np.log2(n))), 1)
            fl |= 0x80 | (size - 1)
            lp = np.zeros((1 << size, 3), np.uint8)
            lp[:n] = f["local"]
            lp = lp.tobytes()
        out += b"\x2c" + struct.pack("<HHHHB", x0, y0, fw, fh, fl) + lp
        idx = np.asarray(f["indices"])
        if f.get("interlace"):
            order = (list(range(0, fh, 8)) + list(range(4, fh, 8))
                     + list(range(2, fh, 4)) + list(range(1, fh, 2)))
            idx = idx[order]
        out += bytes([f["bits"]]) + sub_blocks(
            lzw(idx.reshape(-1), f["bits"], **f.get("lzw", {})), rs,
            f.get("terminate", True))
    return bytes(out) + (b"\x3b" if trailer else b"")


def gif_files():
    rs = np.random.RandomState(3)
    files = []
    img = seeded(19, 23, 3, 2)
    for mode, kw in (("L", {}), ("P", {}), ("P", {"transparency": 3}),
                     ("P", {"interlace": True}), ("L", {"transparency": 7})):
        files.append(pil_file(img, "GIF", mode, **kw))
    for (w, h), bits in (((13, 9), 8), ((1, 1), 2), ((40, 17), 4),
                         ((7, 30), 1), ((64, 64), 8)):
        n = 1 << bits
        for kind in range(7):
            rect = (0, 0, w, h)
            if kind == 3:
                rect = (2, 1, max(w - 3, 1), max(h - 2, 1))
            if kind == 4:
                rect = (3, 2, w, h)           # reaches past the screen
            fw, fh = rect[2:]
            idx = rs.randint(0, n, (fh, fw))
            if kind == 6:
                idx = idx % 3                 # long strings: 12-bit codes
            pal = rs.randint(0, 256, (n, 3))
            frame = {"rect": rect, "indices": idx, "bits": max(bits, 2),
                     "interlace": kind in (1, 5)}
            glob = pal
            if kind == 2:
                frame["local"] = rs.randint(0, 256, (n, 3))
            if kind in (3, 4, 5):
                frame["transparency"] = int(rs.randint(0, n))
            if kind == 5:
                glob = np.repeat(np.arange(n)[:, None], 3, 1)   # grey ramp
            if kind == 6:
                frame["lzw"] = {"clear_full": bool(w % 2)}
                frame["comment"] = b"kind six"
            files.append(gif_file((w, h), [frame], global_pal=glob, rs=rs))
    # 12-bit codes over a large frame, full tables kept (no clear) and
    # cleared; clears every few codes; palettes shorter than the indices
    idx = (np.arange(200 * 60).reshape(60, 200) * 7 // 5) % 256
    for opts in ({"clear_full": False}, {"clear_full": True},
                 {"clear_every": 37}):
        files.append(gif_file((200, 60), [{"rect": (0, 0, 200, 60),
                                           "indices": idx, "bits": 8,
                                           "lzw": opts}],
                              global_pal=rs.randint(0, 256, (100, 3)), rs=rs))
    # data that ends early (the end code after a third of the frame: PIL
    # reads on and finds the file truncated), a frame without its end
    # code or block terminator (cut short), no
    # palette at all (grey), a second frame (ignored), GIF87a
    idx = rs.randint(0, 16, (10, 12))
    pal = rs.randint(0, 256, (16, 3))
    base = {"rect": (0, 0, 12, 10), "indices": idx, "bits": 4}
    for extra, kw in (({"lzw": {"stop": 40}}, {}),
                      ({"lzw": {"stop": 40}, "transparency": 5}, {}),
                      ({"lzw": {"eoi": False}, "terminate": False},
                       {"trailer": False}),
                      ({"lzw": {"eoi": False}}, {}),
                      ({}, {"version": b"GIF87a"})):
        files.append(gif_file((12, 10), [dict(base, **extra)],
                              global_pal=pal, rs=rs, **kw))
    files.append(gif_file((12, 10), [base], rs=rs))
    files.append(gif_file((12, 10), [base, dict(base, indices=idx[::-1])],
                          global_pal=pal, rs=rs))
    files.append(gif_file((12, 10), [base], global_pal=pal, rs=rs)[:-20])
    # an early end code more than 64 KiB before the file's end: PIL feeds
    # the next chunk and decodes on through the next frame's bytes
    noise = rs.randint(0, 256, (200, 400))
    files.append(gif_file((400, 200), [
        {"rect": (0, 0, 400, 200), "indices": noise, "bits": 8,
         "lzw": {"stop": 3000}},
        {"rect": (0, 0, 400, 200), "indices": noise[::-1], "bits": 8}],
        global_pal=rs.randint(0, 256, (256, 3)), rs=rs))
    return files


# ------------------------------------------------------------------ WebP

def riff(chunks):
    body = b"".join(tag + struct.pack("<I", len(p)) + p + b"\0" * (len(p) & 1)
                    for tag, p in chunks)
    return b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WEBP" + body


def riff_chunks(data):
    out, pos = [], 12
    while pos + 8 <= len(data):
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + size]))
        pos += 8 + size + (size & 1)
    return out


def u24(v):
    return struct.pack("<I", v)[:3]


def vp8x(flags, w, h):
    return (b"VP8X", bytes([flags, 0, 0, 0]) + u24(w - 1) + u24(h - 1))


def alpha_filtered(a, filt):
    """The ALPH filters' forward direction on [h, w] uint8 alpha."""
    a = a.astype(np.int32)
    out = a.copy()
    h, w = a.shape
    for y in range(h):
        for x in range(w):
            if filt == 0:
                continue
            if y == 0 or filt == 1:
                pred = a[y, x - 1] if x else (a[y - 1, 0] if y else 0)
            elif filt == 2:
                pred = a[y - 1, x]
            else:
                if x == 0:
                    pred = a[y - 1, 0]
                else:
                    pred = int(np.clip(a[y, x - 1] + a[y - 1, x]
                                       - a[y - 1, x - 1], 0, 255))
            out[y, x] = (a[y, x] - pred) & 255
    return out.astype(np.uint8)


def alph_variants(lossy_alpha_file, alpha, rs):
    """The lossy file with its ALPH chunk rewritten: raw and VP8L-coded
    (a VP8L stream of PIL's lossless encoder, green = the filtered
    alpha) under each filter."""
    chunks = riff_chunks(lossy_alpha_file)
    out = []
    for method in (0, 1):
        for filt in range(4):
            f = alpha_filtered(alpha, filt)
            if method == 0:
                payload = bytes([filt << 2]) + f.tobytes()
            else:
                rgb = np.stack([rs.randint(0, 256, f.shape), f,
                                f // 2], -1).astype(np.uint8)
                vp8l = dict(riff_chunks(pil_file(
                    rgb, "WEBP", lossless=True,
                    quality=int(rs.randint(0, 101)),
                    method=int(rs.randint(0, 7)))))
                payload = bytes([1 | (filt << 2)]) + vp8l[b"VP8L"][5:]
            out.append(riff([(t, payload if t == b"ALPH" else p)
                             for t, p in chunks]))
    return out


def animation(canvas, frame_file, x0, y0, alpha_flag):
    """An animated WebP whose first frame is ``frame_file``'s bitstream
    (and ALPH) at (x0, y0), with a second frame after it."""
    sub = [c for c in riff_chunks(frame_file) if c[0] in (b"ALPH", b"VP8 ",
                                                           b"VP8L")]
    fw, fh = Image.open(io.BytesIO(frame_file)).size

    def anmf(x, y, blend):
        return (b"ANMF", u24(x // 2) + u24(y // 2) + u24(fw - 1)
                + u24(fh - 1) + u24(100) + bytes([blend << 1])
                + riff(sub)[12:])
    return riff([vp8x(0x02 | (0x10 if alpha_flag else 0), *canvas),
                 (b"ANIM", bytes([10, 20, 30, 200, 0, 0])),
                 anmf(x0, y0, 0), anmf(0, 0, 1)])


class BoolEncoder:
    """RFC 6386's boolean entropy encoder (section 7.3)."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while i >= 0 and self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, bit, prob=128):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def value(self, v, n):
        for i in range(n - 1, -1, -1):
            self.put((v >> i) & 1)

    def signed(self, v, n):
        self.value(abs(v), n)
        self.put(v < 0)

    def flush(self):
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def cpp_table(name):
    """A constant table of native/webp_decode.cpp, as a flat list."""
    src = (native_build.NATIVE / "webp_decode.cpp").read_text()
    body = re.search(name + r"\[[^\]]*\] = \{(.*?)\};", src, re.S).group(1)
    return [int(v) for v in re.findall(r"\d+", body)]


ZIGZAG = [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15]
BANDS = [0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0]
CATS = [[173, 148, 140], [176, 155, 140, 135], [180, 157, 141, 134, 130],
        [254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129]]
YMODES4 = [0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9]


def _mode_paths():
    paths = {}

    def walk(node, path):
        for bit in (0, 1):
            v = YMODES4[2 * node + bit]
            if v > 0:
                walk(v, path + [(node, bit)])
            else:
                paths[-v] = path + [(node, bit)]
    walk(0, [])
    return paths


def random_vp8(rs, w, h, *, simple, level, sharpness, segments, parts,
               skip, lf_delta, update_probs, quant, amp):
    """A key frame of random modes and coefficients under the given
    headers: a valid VP8 bitstream (its pixels mean nothing). ``amp``
    bounds the coefficients' magnitude: small ones leave the edges
    between blocks small enough for the loop filters to act."""
    upd = np.array(cpp_table("kCoeffsUpdateProba")).reshape(4, 8, 3, 11)
    proba = np.array(cpp_table("kCoeffsProba0")).reshape(4, 8, 3, 11)
    bmodes = np.array(cpp_table("kBModesProba")).reshape(10, 10, 9)
    dc_t, ac_t = cpp_table("kDcTable"), cpp_table("kAcTable")
    paths = _mode_paths()
    mbw, mbh = (w + 15) // 16, (h + 15) // 16
    e = BoolEncoder()
    e.put(0)
    e.put(0)
    e.put(segments is not None)
    seg_q = [0] * 4
    abs_delta, base_q = 0, quant[0]
    if segments is not None:
        update_map, abs_delta, seg_q, seg_f, seg_p = segments
        e.put(update_map)
        e.put(1)
        e.put(abs_delta)
        for v in seg_q:
            e.put(1)
            e.signed(v, 7)
        for v in seg_f:
            e.put(v != 0)
            if v:
                e.signed(v, 6)
        if update_map:
            for p in seg_p:
                e.put(1)
                e.value(p, 8)
    e.put(simple)
    e.value(level, 6)
    e.value(sharpness, 3)
    e.put(lf_delta is not None)
    if lf_delta is not None:
        e.put(1)
        for v in lf_delta:
            e.put(1)
            e.signed(v, 6)
    e.value(parts, 2)
    e.value(base_q, 7)
    for d in quant[1:]:
        e.put(d != 0)
        if d:
            e.signed(d, 4)
    e.put(0)
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    new = update_probs and rs.rand() < 0.15
                    e.put(new, upd[t, b, c, p])
                    if new:
                        proba[t, b, c, p] = rs.randint(1, 256)
                        e.value(proba[t, b, c, p], 8)
    e.put(skip is not None)
    if skip is not None:
        e.value(skip, 8)

    def clip(v, m):
        return min(max(v, 0), m)

    def dq_of(seg):
        q = base_q if segments is None else seg_q[seg] + (0 if abs_delta
                                                           else base_q)
        return {1: (dc_t[clip(q + quant[2], 127)] * 2,
                    max((ac_t[clip(q + quant[3], 127)] * 101581) >> 16, 8)),
                0: (dc_t[clip(q + quant[1], 127)], ac_t[clip(q, 127)]),
                3: (dc_t[clip(q + quant[1], 127)], ac_t[clip(q, 127)]),
                2: (dc_t[clip(q + quant[4], 117)],
                    ac_t[clip(q + quant[5], 127)])}

    tokens = [BoolEncoder() for _ in range(1 << parts)]

    def put_value(t, v, p):
        if v == 1:
            t.put(0, p[2])
            return
        t.put(1, p[2])
        if v <= 4:
            t.put(0, p[3])
            t.put(v > 2, p[4])
            if v > 2:
                t.put(v - 3, p[5])
        elif v <= 10:
            t.put(1, p[3])
            t.put(0, p[6])
            t.put(v > 6, p[7])
            if v <= 6:
                t.put(v - 5, 159)
            else:
                t.put((v - 7) >> 1, 165)
                t.put((v - 7) & 1, 145)
        else:
            t.put(1, p[3])
            t.put(1, p[6])
            cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
            t.put(cat >> 1, p[8])
            t.put(cat & 1, p[9 + (cat >> 1)])
            extra = v - (3 + (8 << cat))
            tab = CATS[cat]
            for i, pr in enumerate(tab):
                t.put((extra >> (len(tab) - 1 - i)) & 1, pr)

    def block(t, typ, ctx, first, limit):
        """Random coefficients at positions first..15 of a block; returns
        the decoder's nz (the position after the last one)."""
        if rs.rand() < 0.5:
            last = first - 1
        else:
            last = min(first + int(rs.geometric(0.5)) - 1, 15)
        p = proba[typ, BANDS[first], ctx]
        n = first
        while n < 16:
            if n > last:
                t.put(0, p[0])
                return n
            t.put(1, p[0])
            while n < last and rs.rand() < 0.3:
                t.put(0, p[1])
                n += 1
                p = proba[typ, BANDS[n], 0]
            t.put(1, p[1])
            big = rs.rand() < 0.1
            v = int(rs.randint(11, 200) if big else rs.randint(1, 11))
            v = max(1, min(v, limit[n > 0], amp))
            put_value(t, v, p)
            t.put(rs.rand() < 0.5)
            p = proba[typ, BANDS[n + 1], 1 if v == 1 else 2]
            n += 1
            if n > last:
                last = n - 1
        return 16

    top_modes = [[0] * 4 for _ in range(mbw)]
    top_nz = [[0] * 9 for _ in range(mbw)]
    for my in range(mbh):
        left_modes = [0] * 4
        left_nz = [0] * 9
        t = tokens[my & ((1 << parts) - 1)]
        for mx in range(mbw):
            seg = 0
            if segments is not None and segments[0]:
                seg = int(rs.randint(0, 4))
                sp = segments[4]
                e.put(seg >= 2, sp[0])
                e.put(seg & 1, sp[1 + (seg >> 1)])
            sk = 0
            if skip is not None:
                sk = int(rs.rand() < 0.3)
                e.put(sk, skip)
            i4 = rs.rand() < 0.5
            e.put(not i4, 145)
            if not i4:
                ymode = int(rs.randint(0, 4))   # DC TM VE HE
                e.put(ymode in (1, 3), 156)
                e.put(ymode == 1 if ymode in (1, 3) else ymode == 2,
                      128 if ymode in (1, 3) else 163)
                top_modes[mx] = [ymode] * 4
                left_modes = [ymode] * 4
            else:
                for y in range(4):
                    for x in range(4):
                        m = int(rs.randint(0, 10))
                        prob = bmodes[top_modes[mx][x], left_modes[y]]
                        for node, bit in paths[m]:
                            e.put(bit, prob[node])
                        top_modes[mx][x] = m
                        left_modes[y] = m
            uv = int(rs.randint(0, 4))
            e.put(uv != 0, 142)
            if uv:
                e.put(uv != 2, 114)
                if uv != 2:
                    e.put(uv == 1, 183)
            if sk:
                top_nz[mx][:8] = [0] * 8
                left_nz[:8] = [0] * 8
                if not i4:
                    top_nz[mx][8] = left_nz[8] = 0
                continue
            dq = dq_of(seg)
            lim = {k: (max(1, 2047 // v[0]), max(1, 2047 // v[1]))
                   for k, v in dq.items()}
            first = 0
            if not i4:
                nz = block(t, 1, top_nz[mx][8] + left_nz[8], 0,
                           (max(1, 1000 // dq[1][0]),
                            max(1, 1000 // dq[1][1])))
                top_nz[mx][8] = left_nz[8] = int(nz > 0)
                first = 1
            typ = 0 if not i4 else 3
            for y in range(4):
                for x in range(4):
                    nz = block(t, typ, top_nz[mx][x] + left_nz[y], first,
                               lim[typ])
                    top_nz[mx][x] = left_nz[y] = int(nz > first)
            for ch in (4, 6):
                for y in range(2):
                    for x in range(2):
                        nz = block(t, 2, top_nz[mx][ch + x]
                                   + left_nz[ch + y], 0, lim[2])
                        top_nz[mx][ch + x] = left_nz[ch + y] = int(nz > 0)
    part0 = e.flush()
    toks = [t.flush() for t in tokens]
    tag = (0 | (0 << 1) | (1 << 4) | (len(part0) << 5))
    head = struct.pack("<I", tag)[:3] + b"\x9d\x01\x2a" + struct.pack(
        "<HH", w, h)
    sizes = b"".join(struct.pack("<I", len(t))[:3] for t in toks[:-1])
    return head + part0 + sizes + b"".join(toks)


def vp8_files(rs, n):
    out = []
    for i in range(n):
        w, h = int(rs.randint(1, 70)), int(rs.randint(1, 50))
        seg = None
        if rs.rand() < 0.6:
            seg = (int(rs.rand() < 0.7), int(rs.rand() < 0.5),
                   [int(v) for v in rs.randint(-30, 60, 4)],
                   [int(v) for v in rs.randint(-20, 40, 4)],
                   [int(v) for v in rs.randint(1, 256, 3)])
        out.append(random_vp8(
            rs, w, h, simple=int(i % 3 == 0), level=int(rs.randint(0, 64)),
            sharpness=int(rs.randint(0, 8)), segments=seg,
            parts=int(rs.randint(0, 4)),
            skip=int(rs.randint(1, 256)) if rs.rand() < 0.6 else None,
            lf_delta=([int(v) for v in rs.randint(-20, 20, 8)]
                      if rs.rand() < 0.4 else None),
            update_probs=bool(rs.rand() < 0.5),
            amp=(1, 2, 4, 2000)[i % 4],
            quant=[int(rs.randint(0, 128))] + [
                int(v) if rs.rand() < 0.4 else 0
                for v in rs.randint(-15, 16, 5)]))
    return out


def webp_files(n_vp8=80):
    rs = np.random.RandomState(4)
    files = []
    for lossless in (False, True):
        for c in (3, 4):
            for (h, w), kind in (((1, 1), "noise"), ((16, 16), "smooth"),
                                 ((17, 33), "noise"), ((37, 53), "smooth"),
                                 ((64, 48), "noise")):
                for q in ((0, 30, 75, 100) if not lossless else (0, 100)):
                    m = int(rs.randint(0, 7))
                    aq = int(rs.randint(10, 101))
                    files.append(pil_file(seeded(h, w, c, h * w + q, kind),
                                          "WEBP", lossless=lossless,
                                          quality=q, method=m,
                                          alpha_quality=aq))
    # palettes of 2 to 256 colours (colour indexing, pixel packing)
    for colors in (2, 3, 4, 11, 16, 17, 256):
        idx = rs.randint(0, colors, (23, 29))
        pal = rs.randint(0, 256, (colors, 4)).astype(np.uint8)
        for method in (0, 3, 6):
            files.append(pil_file(pal[idx], "WEBP", lossless=True,
                                  quality=int(rs.randint(0, 101)),
                                  method=method, exact=True))
    # ALPH rewritten: raw and VP8L-coded under each filter
    a = seeded(21, 30, 4, 9)
    lossy = pil_file(a, "WEBP", quality=60)
    files += alph_variants(lossy, a[..., 3], rs)
    # animations: the first frame at an offset of a larger canvas
    small = pil_file(seeded(9, 14, 4, 5), "WEBP", quality=50)
    small_l = pil_file(seeded(9, 14, 4, 6), "WEBP", lossless=True)
    small_rgb = pil_file(seeded(9, 14, 3, 7), "WEBP", quality=50)
    for frame in (small, small_l, small_rgb):
        for alpha_flag in (True, False):
            files.append(animation((31, 20), frame, 6, 4, alpha_flag))
    frames = [Image.fromarray(seeded(12, 16, 4, k)) for k in range(3)]
    for lossless in (False, True):
        buf = io.BytesIO()
        frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                       lossless=lossless, duration=50)
        files.append(buf.getvalue())
    # random VP8 bitstreams in simple files, and one under VP8X + ALPH
    for bits in vp8_files(rs, n_vp8):
        files.append(riff([(b"VP8 ", bits)]))
    return files


# --------------------------------------------------------------- goldens

def golden_files():
    """{name: file bytes} of the files the card decodes (phase 31c of
    chip_smoke.py): one of each format and variant class, the textures
    of 31c's scene, and the two timed 1024^2 files."""
    rs = np.random.RandomState(5)
    out = {}
    tex = seeded(24, 32, 4, 11)
    # the scene's textures
    idx = (np.arange(24 * 32).reshape(24, 32) // 7 + np.arange(32)) % 16
    pal = rs.randint(0, 256, (16, 3))
    out["fmt_tga_rle"] = tga_file(10, 24, 32, 24, tga_rle(
        tex[::-1, :, 2::-1].reshape(24, -1).copy(), 3, rs)[0], flags=0x00)
    idx8 = (np.arange(20 * 28).reshape(20, 28) * 5 // 3) % 200
    pal8 = rs.randint(0, 256, (256, 3))
    out["fmt_bmp_rle8"] = bmp_file(rle_stream(idx8.astype(np.uint8), False,
                                              rs, 14 + 40 + 1024),
                                   28, 20, 8, compression=1, palette=pal8)
    out["fmt_gif_trns"] = gif_file((32, 24), [{
        "rect": (0, 0, 32, 24), "indices": idx, "bits": 4,
        "transparency": 5}], global_pal=pal, rs=rs)
    out["fmt_webp_alpha"] = pil_file(tex, "WEBP", quality=70)
    out["fmt_webp_lossless"] = pil_file(seeded(20, 26, 4, 12, "noise"),
                                        "WEBP", lossless=True)
    # one more of each class the tests hold
    out["fmt_bmp_565"] = bmp_file(pack_rows(
        rs.randint(0, 256, (9, 13, 2)).astype(np.uint8), 16), 13, 9, 16,
        header=124, compression=3, masks=(0xF800, 0x7E0, 0x1F, 0))
    out["fmt_bmp_rle4"] = bmp_file(rle_stream(
        rs.randint(0, 16, (7, 11)).astype(np.uint8), True, rs,
        14 + 40 + 64), 11, 7, 4, compression=2,
        palette=rs.randint(0, 256, (16, 3)))
    out["fmt_tga_cmap16"] = tga_file(9, 8, 10, 6, tga_rle(
        rs.randint(0, 256, (6, 10)).astype(np.uint8), 1, rs)[0],
        cmap=(3, rs.randint(0, 256, (2 * 120,)).astype(np.uint8).tobytes(),
              16), flags=0x10)
    out["fmt_gif_interlaced"] = gif_file((23, 17), [{
        "rect": (2, 3, 19, 13), "indices": rs.randint(0, 64, (13, 19)),
        "bits": 6, "interlace": True,
        "local": rs.randint(0, 256, (64, 3))}],
        global_pal=rs.randint(0, 256, (4, 3)), rs=rs)
    out["fmt_webp_anim"] = animation(
        (31, 20), pil_file(seeded(9, 14, 4, 5), "WEBP", quality=50), 6, 4,
        True)
    out["fmt_webp_vp8"] = riff([(b"VP8 ", vp8_files(rs, 1)[0])])
    # the timed files
    yy, xx = np.mgrid[0:BIG, 0:BIG]
    big = np.stack([128 + 100 * np.sin(xx / 37 + yy / 53),
                    128 + 90 * np.cos(yy / 29 - xx / 61),
                    (xx + 2 * yy) / 12 % 256,
                    (xx // 3 + yy // 5) % 256], -1).astype(np.uint8)
    out["fmt_big_webp"] = pil_file(big, "WEBP", quality=80)
    big_idx = ((xx // 32) * 3 + (yy // 16) * 5) % 256
    out["fmt_big_gif"] = gif_file((BIG, BIG), [{
        "rect": (0, 0, BIG, BIG), "indices": big_idx.astype(np.uint8),
        "bits": 8}], global_pal=rs.randint(0, 256, (256, 3)), rs=rs)
    return out


BIG_NAMES = ("fmt_big_webp", "fmt_big_gif")


def golden_arrays():
    """The npz's arrays of these files: each file's bytes (``<name>.file``)
    and PIL's RGBA (``<name>.rgba``, or for the 1024^2 files its SHA-256
    ``<name>.sha256`` and ``<name>.shape``)."""
    out = {}
    for name, data in golden_files().items():
        out[name + ".file"] = np.frombuffer(data, np.uint8)
        rgba = pil_rgba(data)
        if name in BIG_NAMES:
            out[name + ".sha256"] = np.frombuffer(
                hashlib.sha256(rgba.tobytes()).digest(), np.uint8)
            out[name + ".shape"] = np.array(rgba.shape, np.int64)
        else:
            out[name + ".rgba"] = rgba
    return out


# ----------------------------------------------------------------- tests

def test_bmp_and_tga_match_pil():
    """BMP (PIL's files; each header size, depth, bitfield layout, RLE4
    and RLE8, top-down, DIB) and TGA (PIL's files; types 1, 2, 3, 9, 10,
    11, colour maps of 16 and 24 bits from a nonzero first index, both
    flips, raw packets across rows): equal to PIL's RGBA, or refused by
    both (a 32-bit colour map, PIL's own 1-bit RLE file, a 4-bit grey
    ramp palette, RLE data short of pixels)."""
    files = bmp_files()
    assert check(files) == 3 and len(files) == 141
    files = tga_files()
    assert check(files) == 33 and len(files) == 316


def test_gif_matches_pil():
    """The first frame of PIL's GIFs and of this module's (interlaced,
    local palette, a frame smaller than or past the screen, transparency
    in P and L frames, 12-bit codes kept or cleared, no end code): equal
    to PIL's RGBA; data that ends early or is cut short, and an early end
    code that PIL decodes on from, are refused by both."""
    files = gif_files()
    assert check(files) == 4 and len(files) == 52


def test_webp_matches_pil():
    """PIL's lossy (with and without alpha), lossless (2 to 256 colours,
    methods 0 to 6) and animated WebPs; the ALPH chunk raw and VP8L-coded
    under each filter; animations whose first frame lies at an offset;
    random VP8 bitstreams over every header option: equal to PIL's
    RGBA."""
    files = webp_files()
    assert check(files) == 0 and len(files) == 177


def test_refused_variants_name_themselves():
    """Variants Pillow refuses raise ValueError naming them in the port
    too; formats Pillow opens that the port does not decode raise
    ValueError naming the format as Pillow identifies it (PIL's DDS, PPM,
    ICO and QOI files, which the port now decodes, equal PIL's RGBA)."""
    rs = np.random.RandomState(6)
    idx = rs.randint(0, 4, (3, 5))
    bad = {
        "header type": bmp_file(b"\0" * 64, 4, 4, 8)[:14] + struct.pack(
            "<I", 20) + b"\0" * 80,
        "pixel depth": bmp_file(pack_rows(idx, 8), 5, 3, 2,
                                palette=rs.randint(0, 256, (4, 3))),
        "compression": bmp_file(b"\0" * 40, 5, 3, 24, compression=4),
        "bitfields": bmp_file(pack_rows(np.zeros((3, 5, 2)), 16), 5, 3, 16,
                              compression=3, masks=(0xF00, 0xF0, 0xF)),
        "not enough image data": bmp_file(bytes([3, 1, 0, 1]), 5, 3, 8,
                                          compression=1,
                                          palette=rs.randint(0, 256, (4, 3))),
        "cut short": bmp_file(pack_rows(idx, 8)[:-9], 5, 3, 8,
                              palette=rs.randint(0, 256, (4, 3))),
        "image type 2 at 8 bits": tga_file(2, 8, 5, 3, bytes(15)),
        "runs past a row": tga_file(10, 24, 4, 2, bytes([0x85, 1, 2, 3])),
        "broken LZW": b"GIF89a" + struct.pack("<HHBBB", 4, 4, 0, 0, 0)
        + b"\x2c" + struct.pack("<HHHHB", 0, 0, 4, 4, 0)
        + bytes([2, 3, 0xFF, 0xFF, 0xFF, 0, 0x3B]),
        "no image": b"GIF89a" + struct.pack("<HHBBB", 4, 4, 0, 0, 0) + b";",
        "VP8L": riff([(b"VP8L", b"\x2f\x00\x00\x00\x00")]),
    }
    for what, data in bad.items():
        with pytest.raises(Exception):
            pil_rgba(data)
        with pytest.raises(ValueError, match=re.escape(what)):
            _decode_image(data, what)
    img = seeded(16, 16, 3, 0)
    others = {}
    for fmt, name, kw in (("DDS", "DDS", {}), ("TIFF", "TIFF", {}),
                          ("PPM", "PPM", {}), ("ICO", "ICO", {}),
                          ("PCX", "PCX", {}), ("SGI", "SGI", {}),
                          ("QOI", "QOI", {}), ("JPEG2000", "JPEG2000", {}),
                          ("IM", "IM", {}), ("MSP", "MSP", {"mode": "1"}),
                          ("XBM", "XBM", {"mode": "1"}),
                          ("PSD", "PSD", None), ("AVIF", "AVIF", {})):
        if kw is None:
            # PIL has no PSD writer: a 3-channel raw PSD header
            data = (b"8BPS" + struct.pack(">H6xHIIHH", 1, 3, 16, 16, 8, 3)
                    + struct.pack(">III", 0, 0, 0) + struct.pack(">H", 0)
                    + img.transpose(2, 0, 1).tobytes())
        else:
            mode = kw.pop("mode", None)
            try:
                data = pil_file(img, fmt, mode, **kw)
            except (KeyError, OSError):
                continue
        assert Image.open(io.BytesIO(data)).format == name
        others[name] = data
    assert {"DDS", "TIFF", "PPM", "ICO", "PCX", "SGI", "PSD"} <= set(others)
    for name, data in others.items():
        if name in ("DDS", "PPM", "ICO", "QOI"):     # decoded since
            np.testing.assert_array_equal(_decode_image(data, name).data,
                                          pil_rgba(data))
            continue
        with pytest.raises(ValueError, match=re.escape(name)):
            _decode_image(data, name)
    with pytest.raises(ValueError, match="not an image"):
        _decode_image(b"\x00" * 40, "zeros")


def test_decoders_build_from_source(tmp_path, monkeypatch):
    """The GIF and WebP decoders' libraries are built by g++ from
    native/gif_decode.cpp and native/webp_decode.cpp into the build
    directory, keyed by a hash of the source and flags, and decode
    there."""
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(gif, "_LIB", None)
    monkeypatch.setattr(webp, "_LIB", None)
    libs = [native_build.library_path(m.SOURCE) for m in (gif, webp)]
    assert all(lib.parent == tmp_path and not lib.exists() for lib in libs)
    files = golden_files()
    for name in ("fmt_gif_trns", "fmt_webp_alpha"):
        np.testing.assert_array_equal(
            _decode_image(files[name], name).data, pil_rgba(files[name]))
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        lib.name for lib in libs)


def test_decode_time_1024():
    """The timed goldens, a 1024^2 lossy WebP with alpha and a 1024^2
    GIF: equal to PIL's RGBA (their SHA-256 in the goldens), each decoded
    in under 2 s on the CPU (the best of 3 calls, printed)."""
    files = golden_files()
    with np.load(GOLDENS) as z:
        for name in BIG_NAMES:
            data = files[name]
            assert data == z[name + ".file"].tobytes()
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                got = _decode_image(data, name).data
                best = min(best, time.perf_counter() - t0)
            assert hashlib.sha256(got.tobytes()).digest() == bytes(
                z[name + ".sha256"])
            print(f"{name} ({len(data)} bytes): {best * 1e3:.2f} ms on the "
                  "CPU")
            assert best < DECODE_LIMIT_S
