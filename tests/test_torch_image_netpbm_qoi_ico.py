"""The port's PBM/PGM/PPM/PFM, QOI and ICO/CUR decoders
(madrona_tpu_torch.assets.ppm, .qoi, .ico) against PIL.Image.open(...).
convert("RGBA"), which the JAX package's importers decode with, byte for
byte (no tolerance), through the importer's dispatch (_decode_image):
  * files PIL writes from seeded images: PBM (P4), PGM (P5 at 255 and
    65535), PPM (P6), PFM (little-endian), QOI (RGB and RGBA), ICO with
    PNG frames and with BMP frames at several sizes;
  * files this module's own writers make, for what PIL does not write:
    plain P1, P2 and P3 with comments inside and between tokens and every
    whitespace byte, maxvals 1, 7, 1000 and 65535 in the plain and binary
    decoders, raw samples above maxval, P0CMYK, PyP, PyRGBA and PyCMYK,
    big- and little-endian PFM with NaN, infinities and values either
    side of 0 and 255; QOI op streams of every op (runs that overshoot
    the image, index hits on slots never written, RGB ops that keep the
    previous alpha); ICO directories of several entries (the sort by
    depth and size, size bytes of 0, colour-count depths) with PNG
    frames (a tRNS chunk Pillow's icon drops), 32-bit frames with their
    own alpha and 1-, 4-, 8- and 24-bit frames with their AND masks; CUR
    with one and several entries (a 32-bit bitmap at byte 22 keeps its
    alpha, elsewhere not);
  * the variants PIL and the port both refuse (a header token cut short or
    too long, maxval 0, a plain sample above maxval, data that ends
    early, a PNG cursor, an AND mask past the file's end), and the
    dispatch of files that more than one format's test takes (an icon
    whose directory TGA's header checks also pass is an icon, as in
    Pillow; a TGA with CUR's magic bytes and no directory is a TGA);
  * the QOI decoder's g++ build into a fresh directory.

The golden files of these formats for the card are written by
``python tests/test_torch_image_decode.py --write-goldens`` (see
test_torch_image_dds.golden_files)."""

import io
import os
import struct
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

Image = pytest.importorskip("PIL.Image")

from madrona_tpu_torch.assets import native_build, qoi  # noqa: E402
from madrona_tpu_torch.assets.importer import _decode_image  # noqa: E402


def pil_rgba(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def check(files):
    """Each file decodes as PIL decodes it, or both raise. Returns the
    number both refused."""
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
    noise, flat patches that make QOI runs)."""
    rs = np.random.RandomState(seed)
    if kind == "noise":
        return rs.randint(0, 256, (h, w, c)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    a = np.stack([128 + 100 * np.sin(xx / 7 + yy / 11),
                  128 + 90 * np.cos(yy / 5 - xx / 13),
                  (xx * 3 + yy * 5) % 256, 255 - (xx * yy) % 256][:c], -1)
    a = a + rs.randint(-3, 4, a.shape)
    a[(xx // 4 + yy // 3) % 5 == 0] = 77
    return np.clip(a, 0, 255).astype(np.uint8)


def pil_file(img, fmt, mode=None, **kw):
    im = Image.fromarray(img)
    if mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


# --------------------------------------------------------------- Netpbm

def pnm(magic, w, h, maxval, samples, *, plain=False, sep=b"\n",
        header=None):
    """A Netpbm file: ``magic``, the size and (unless None) ``maxval``
    separated by ``sep`` (or the whole ``header``), then ``samples``
    (ints; decimal tokens if ``plain``, else 1 or 2 big-endian bytes by
    maxval)."""
    if header is None:
        fields = [b"%d" % w, b"%d" % h] + ([] if maxval is None
                                           else [b"%d" % maxval])
        header = magic + sep + sep.join(fields) + b"\n"
    s = np.asarray(samples).reshape(-1)
    if plain:
        return header + b" ".join(b"%d" % v for v in s) + b"\n"
    dt = ">u2" if maxval is not None and maxval > 255 else np.uint8
    return header + s.astype(dt).tobytes()


def plain_with_comments(magic, w, h, maxval, s, rs):
    """A plain file whose tokens are separated by random whitespace and
    comments (a comment inside a token does not end it)."""
    ws = [b" ", b"\t", b"\n", b"\r", b"\x0b", b"\x0c", b"  \n"]
    out = magic + b"\n# a comment\n%d#inside\n%d" % (w // 10, w % 10) \
        if w >= 10 else magic + b"\n#c\r%d" % w
    out += b"\t%d\n" % h
    if maxval is not None:
        out += b"# maxval next\n%d\n" % maxval
    for i, v in enumerate(np.asarray(s).reshape(-1)):
        out += b"%d" % v + ws[rs.randint(len(ws))]
        if i % 17 == 5:
            out += b"#c %d\n" % i
    return out


def pnm_files():
    rs = np.random.RandomState(3)
    files = []
    img = seeded(9, 13, 3, 1)
    files.append(pil_file(img, "PPM"))                       # P6
    files.append(pil_file(img, "PPM", "L"))                  # P5
    files.append(pil_file(img, "PPM", "1"))                  # P4
    files.append(pil_file((img[..., 0].astype(np.uint16) * 257), "PPM"))
    for w, h in ((1, 1), (7, 3), (13, 9), (17, 2)):
        for maxval in (1, 7, 255, 1000, 65535):
            g = rs.randint(0, maxval + 1, (h, w))
            c = rs.randint(0, maxval + 1, (h, w, 3))
            files.append(pnm(b"P2", w, h, maxval, g, plain=True))
            files.append(pnm(b"P3", w, h, maxval, c, plain=True))
            files.append(pnm(b"P5", w, h, maxval, g))
            files.append(pnm(b"P6", w, h, maxval, c))
            files.append(plain_with_comments(b"P3", w, h, maxval, c, rs))
        b = rs.randint(0, 2, (h, w))
        files.append(pnm(b"P1", w, h, None, b, plain=True))
        files.append(b"P1\n%d %d\n" % (w, h)
                     + b"".join(b"%d" % v for v in b.reshape(-1)) + b"\n")
        files.append(plain_with_comments(b"P1", w, h, None, b, rs))
        files.append(b"P4\n%d %d\n" % (w, h) + np.packbits(
            b.astype(np.uint8), axis=1).tobytes())
        for magic, n in ((b"P0CMYK", 4), (b"PyCMYK", 4), (b"PyRGBA", 4),
                         (b"PyP", 1)):
            for maxval in (255, 100):
                files.append(pnm(magic, w, h, maxval,
                                 rs.randint(0, maxval + 1, (h, w, n))))
    # raw samples above maxval (clamped), at 1 and 2 bytes
    files.append(pnm(b"P6", 3, 2, 100, rs.randint(0, 256, (2, 3, 3))))
    files.append(pnm(b"P5", 3, 2, 1000, rs.randint(0, 65536, (2, 3))))
    files.append(pnm(b"P6", 3, 2, 300, rs.randint(0, 65536, (2, 3, 3))))
    # header layouts: one whitespace byte after maxval, then binary data
    # that starts with whitespace; tokens at the 10-byte limit
    files.append(b"P5 3 2 255\n\n\t\r\x0b\x0c ")
    files.append(b"P5\n0000000003 0000000002\n0000000255\n" + bytes(6))
    files.append(b"P5\n3 2\n255#comment\n\n" + bytes(range(6)))
    return files


def pfm(w, h, scale, values, header=None):
    order = "<f4" if scale < 0 else ">f4"
    head = header or b"Pf\n%d %d\n%s\n" % (w, h, repr(scale).encode())
    return head + np.asarray(values, order).tobytes()


def pfm_files():
    rs = np.random.RandomState(4)
    special = [0.6, 1.5, 254.5, 300.0, -0.5, -3.0, np.nan, np.inf,
               -np.inf, 255.0, 254.9999, 1e10, -1e-30, 0.0, -0.0, 127.5]
    files = [pil_file(seeded(6, 7, 1, 2)[..., 0].astype(np.float32) * 1.7,
                      "PPM")]
    for scale in (1.0, -1.0, 0.5, -2.25):
        v = np.concatenate([special, rs.uniform(-50, 400, 4 * 9 - 16)])
        files.append(pfm(9, 4, scale, v))
    return files


def refused_pnm():
    return [
        b"P5\n3",                                      # header cut short
        b"P5\n3 2\n",                                  # no maxval
        b"P5\n3 2\n0\n" + bytes(6),                    # maxval 0
        b"P5\n3 2\n65536\n" + bytes(12),
        b"P5\n00000000003 2\n255\n" + bytes(6),        # token of 11 bytes
        b"P5\n3 x\n255\n" + bytes(6),
        b"P5\n3 2\n255\n" + bytes(5),                  # data ends early
        b"P6\n3 2\n1000\n" + bytes(35),
        b"P2\n3 2\n7\n1 2 3 4 5 8\n",                  # sample > maxval
        b"P2\n3 2\n7\n1 2 3 4 5\n",                    # too few samples
        b"P1\n3 2\n1 0 2 1 0 1\n",                     # not 0 or 1
        b"P3\n1 1\n255\n1 2 x\n",
        b"Pf\n2 1\n0.0\n" + bytes(8),                  # scale 0
        b"Pf\n2 1\nnan\n" + bytes(8),
        b"Pf\n2 1\n1.0\n" + bytes(7),
        b"P4\n9 2\n" + bytes(3),
        b"P5\n3 2\n255#comment\n" + bytes(range(6)),  # data in the token
    ]


# ------------------------------------------------------------------ QOI

def qoi_header(w, h, channels):
    return b"qoif" + struct.pack(">IIBB", w, h, channels, 0)


def qoi_stream(rs, n_ops):
    """Random ops of every kind (the end marker left off: Pillow does not
    read it)."""
    out = bytearray()
    for _ in range(n_ops):
        k = rs.randint(7)
        if k == 0:
            out += b"\xfe" + bytes(rs.randint(0, 256, 3).tolist())
        elif k == 1:
            out += b"\xff" + bytes(rs.randint(0, 256, 4).tolist())
        elif k == 2:
            out.append(rs.randint(0, 64))                   # index
        elif k == 3:
            out.append(0x40 | rs.randint(0, 64))            # diff
        elif k == 4:
            out += bytes([0x80 | rs.randint(0, 64), rs.randint(0, 256)])
        else:
            out.append(0xc0 | rs.randint(0, 62))            # run 1-62
    return bytes(out)


def qoi_files():
    rs = np.random.RandomState(5)
    files = []
    for h, w in ((1, 1), (5, 7), (16, 16), (23, 9)):
        for c in (3, 4):
            files.append(pil_file(seeded(h, w, c, h + c), "QOI"))
            files.append(pil_file(seeded(h, w, c, w, "noise"), "QOI"))
    for i in range(60):
        w, h = rs.randint(1, 12), rs.randint(1, 12)
        files.append(qoi_header(w, h, (3, 4, 0, 7)[i % 4])
                     + qoi_stream(rs, w * h + 8))
    # an index op on a slot never written first; a run past the end
    files.append(qoi_header(3, 2, 4) + b"\x05\x3f\xc3\xfe\x01\x02\x03\xfd")
    files.append(qoi_header(4, 1, 3) + b"\xfd" + b"\x00" * 8)
    return files


def refused_qoi():
    return [b"qoif" + b"\x00\x00\x00\x02",              # header cut short
            qoi_header(0, 3, 4) + b"\xc0" * 4,          # zero width
            qoi_header(4, 4, 4) + b"\xc3" * 3,          # ops end early
            qoi_header(2, 1, 4) + b"\xff\x01\x02",      # RGBA op cut short
            qoi_header(2, 1, 3) + b"\xc0\x80"]          # luma op cut short


# -------------------------------------------------------------- ICO/CUR

def icon_dir(frames, kind=1):
    """An ICO (``kind`` 1) or CUR (2) of ``frames``: (size bytes w, h,
    colour count, bit count, data) each, the data after the directory in
    order."""
    out = struct.pack("<HHH", 0, kind, len(frames))
    off = 6 + 16 * len(frames)
    body = b""
    for w, h, ncol, bpp, data in frames:
        out += struct.pack("<BBBBHHII", w, h, ncol, 0, 1, bpp, len(data),
                           off + len(body))
        body += data
    return out + body


def dib_frame(rs, w, h, bits, *, mask=True, colors=None):
    """An icon bitmap: a 40-byte info header of height 2h, a palette at
    up to 8 bits, the XOR rows bottom-up and (``mask``) the AND mask rows,
    each padded to 32 bits."""
    ncol = (1 << bits) if bits <= 8 and colors is None else (colors or 0)
    info = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, 0, 0, 0,
                       ncol if bits <= 8 else 0, 0)
    pal = rs.randint(0, 256, (ncol, 4)).astype(np.uint8).tobytes()
    stride = ((w * bits + 31) // 32) * 4
    xor = rs.randint(0, 256, (h, stride)).astype(np.uint8).tobytes()
    mstride = ((w + 31) // 32) * 4
    andm = rs.randint(0, 256, (h, mstride)).astype(np.uint8).tobytes()
    return info + pal + xor + (andm if mask else b"")


def png_frame(img, **kw):
    return pil_file(img, "PNG", **kw)


def ico_files():
    rs = np.random.RandomState(6)
    files = []
    img = seeded(48, 48, 4, 7)
    files.append(pil_file(img, "ICO", sizes=[(16, 16), (32, 32), (48, 48)]))
    files.append(pil_file(img, "ICO", sizes=[(16, 16), (48, 48)],
                          bitmap_format="bmp"))
    files.append(pil_file(img[..., :3], "ICO", sizes=[(24, 24)],
                          bitmap_format="bmp"))
    # 128 x 128 at 32 bits: TGA's header checks also pass this directory
    files.append(pil_file(seeded(128, 128, 4, 8), "ICO", sizes=[(128, 128)],
                          bitmap_format="bmp"))
    pal_png = png_frame(seeded(8, 8, 1, 9)[..., 0] // 32, transparency=3)
    grey_png = png_frame(seeded(6, 10, 1, 9)[..., 0], transparency=77)
    for bits in (1, 4, 8, 24, 32):
        for w, h in ((5, 3), (16, 16), (33, 7)):
            files.append(icon_dir([(w, h, 0, bits,
                                    dib_frame(rs, w, h, bits))]))
    # directory sorts: the same size at two depths (the lower wins), a
    # colour-count depth, a size byte of 0 (256) that is not the largest
    # frame's real size, a larger frame later in the file
    f8, f24 = dib_frame(rs, 8, 8, 8), dib_frame(rs, 8, 8, 24)
    f4 = dib_frame(rs, 8, 8, 4)
    files.append(icon_dir([(8, 8, 0, 24, f24), (8, 8, 0, 8, f8)]))
    files.append(icon_dir([(8, 8, 0, 8, f8), (8, 8, 0, 24, f24)]))
    files.append(icon_dir([(8, 8, 0, 0, f24), (8, 8, 16, 0, f4)]))
    files.append(icon_dir([(8, 8, 1, 0, f8), (8, 8, 3, 0, f4)]))
    files.append(icon_dir([(4, 4, 0, 4, dib_frame(rs, 4, 4, 4)),
                           (0, 0, 0, 32, dib_frame(rs, 6, 5, 32)),
                           (16, 16, 0, 8, dib_frame(rs, 16, 16, 8))]))
    files.append(icon_dir([(8, 8, 0, 32, pal_png), (10, 6, 0, 8, grey_png),
                           (6, 6, 0, 8, dib_frame(rs, 6, 6, 8))]))
    files.append(icon_dir([(6, 10, 0, 32, grey_png)]))
    files.append(icon_dir([(12, 12, 0, 32, png_frame(seeded(12, 12, 4, 3))),
                           (12, 12, 0, 32, png_frame(seeded(12, 12, 3, 4)))]))
    # a 32-bit entry over an 8-bit bitmap: alpha from every fourth byte
    files.append(icon_dir([(8, 4, 0, 32, dib_frame(rs, 8, 4, 8) + bytes(
        rs.randint(0, 256, 96).tolist()))]))
    return files


def cur_files():
    rs = np.random.RandomState(7)
    files = []
    for bits in (1, 4, 8, 24, 32):
        files.append(icon_dir([(9, 6, 0, bits, dib_frame(rs, 9, 6, bits))],
                              kind=2))
    files.append(icon_dir([(8, 8, 0, 8, dib_frame(rs, 8, 8, 8)),
                           (12, 8, 0, 24, dib_frame(rs, 12, 8, 24)),
                           (12, 12, 0, 4, dib_frame(rs, 12, 12, 4))], kind=2))
    files.append(icon_dir([(16, 16, 0, 8, dib_frame(rs, 16, 16, 8)),
                           (32, 32, 0, 24, dib_frame(rs, 5, 5, 24))], kind=2))
    files.append(icon_dir([(8, 8, 0, 32, dib_frame(rs, 8, 8, 32)),
                           (9, 9, 0, 32, dib_frame(rs, 9, 9, 32))], kind=2))
    files.append(icon_dir([(0, 0, 0, 24, dib_frame(rs, 7, 7, 24)),
                           (1, 1, 0, 8, dib_frame(rs, 3, 3, 8))], kind=2))
    return files


def refused_icons():
    rs = np.random.RandomState(8)
    frame = dib_frame(rs, 8, 8, 8)
    return [
        icon_dir([(8, 8, 0, 8, frame[:-40])]),              # mask cut
        icon_dir([(8, 8, 0, 8, frame[:100])]),              # pixels cut
        icon_dir([(8, 8, 0, 32, dib_frame(rs, 8, 8, 32)[:200])]),
        icon_dir([(8, 8, 0, 8, b"\x14\0\0\0" + frame[4:])]),
        icon_dir([(8, 8, 0, 32, png_frame(seeded(8, 8, 4, 1)))], kind=2),
    ]


# ---------------------------------------------------------------- tests

def test_pnm_match_pil():
    """PBM, PGM and PPM, plain and binary, at maxvals 1 to 65535, with
    comments and every whitespace byte, and the P0CMYK and Py* modes:
    equal to PIL's RGBA, or refused by both."""
    files = pnm_files()
    assert check(files) == 0
    assert check(refused_pnm()) == len(refused_pnm())


def test_pfm_match_pil():
    """PFM by the sign of its scale, bottom-up rows, NaN, infinities and
    values either side of 0 and 255: equal to PIL's RGBA."""
    assert check(pfm_files()) == 0


def test_qoi_match_pil():
    """PIL's QOI files and random op streams (every op, runs past the
    end, index slots never written): equal to PIL's RGBA, or refused by
    both."""
    assert check(qoi_files()) == 0
    assert check(refused_qoi()) == len(refused_qoi())


def test_ico_and_cur_match_pil():
    """PIL's icons (PNG and BMP frames) and this module's (several
    entries, every bitmap depth with its AND mask, 32-bit alpha, PNG
    frames with tRNS) and cursors: equal to PIL's RGBA, or refused by
    both."""
    assert check(ico_files()) == 0
    assert check(cur_files()) == 0
    assert check(refused_icons()) == len(refused_icons())


def test_dispatch_follows_pillows_order():
    """An icon whose directory TGA's header checks also take is read as
    an icon (Pillow tries ICO before TGA); a TGA whose first bytes are
    CUR's magic but which has no cursor directory is read as TGA; a
    Netpbm-like magic Pillow does not know is not taken for PPM."""
    from madrona_tpu_torch.assets import tga

    icon = ico_files()[3]
    assert tga.accept(icon)
    assert Image.open(io.BytesIO(icon)).format == "ICO"
    np.testing.assert_array_equal(_decode_image(icon).data, pil_rgba(icon))
    px = seeded(3, 4, 3, 1, "noise")[::-1, :, ::-1].tobytes()
    tga_file = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, 4, 3,
                           24, 0) + px
    assert tga_file[:4] == b"\x00\x00\x02\x00"
    assert Image.open(io.BytesIO(tga_file)).format == "TGA"
    np.testing.assert_array_equal(_decode_image(tga_file).data,
                                  pil_rgba(tga_file))
    with pytest.raises(Exception):
        pil_rgba(b"P7\n3 2\n255\n" + bytes(6))
    with pytest.raises(ValueError, match="not an image"):
        _decode_image(b"P7\n3 2\n255\n" + bytes(6))


def test_qoi_decoder_builds_from_source(tmp_path, monkeypatch):
    """The QOI decoder's library is built by g++ from native/qoi_decode.cpp
    into the build directory, keyed by a hash of the source and flags, and
    decodes there."""
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(qoi, "_LIB", None)
    lib = native_build.library_path(qoi.SOURCE)
    assert lib.parent == tmp_path and not lib.exists()
    data = qoi_files()[0]
    np.testing.assert_array_equal(qoi.decode_qoi(data), pil_rgba(data))
    assert [p.name for p in tmp_path.iterdir()] == [lib.name]
