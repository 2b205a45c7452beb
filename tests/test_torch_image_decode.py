"""The port's image decoders (madrona_tpu_torch.assets.jpeg and .png)
against PIL.Image.open(...).convert("RGBA"), which the JAX package's
importers decode with, byte for byte (no tolerance):
  * JPEG files PIL writes from seeded images: grey, YCbCr at
    subsampling 0, 1 and 2 (4:4:4, 4:2:2, 4:2:0), RGB (keep_rgb, an
    Adobe transform 0), Adobe CMYK, and YCCK (a CMYK file with its Adobe
    transform set to 2); baseline and progressive; qualities 5 to 100;
    sizes from 1 x 1 to 53 x 37 that are not multiples of the MCU;
    restart markers every 1 and 3 MCUs; and every prefix of PIL's
    progressive files (cut after any scan), which libjpeg decodes with
    its block smoothing (DC only, and partly refined AC);
  * JPEG files this module's own baseline encoder writes, for what PIL
    does not write: 4:4:0 and mixed sampling factors (chroma finer than
    luma too), RGB by component ids, CMYK and YCCK with subsampled
    components, non-interleaved scans, restart intervals over them;
  * the variants the decoder refuses, each with a ValueError naming it:
    arithmetic coding, 12-bit samples, lossless and hierarchical JPEG,
    sampling factors above 2, 2 components;
  * PNG at 16 bits in colour types 0, 2, 4 and 6 (with 16-bit tRNS
    keys), and Adam7-interlaced at every depth and colour type;
  * the committed goldens (tests/goldens/torch_images.npz, read by
    chip_smoke.py on the card) equal what PIL gives today;
  * the decoder's g++ build into a fresh directory, the importer's
    dispatch by magic bytes, and the time of a 1024 x 1024 4:2:0 JPEG
    (under 2 s on the CPU).

Write the goldens again with ``python tests/test_torch_image_decode.py
--write-goldens`` (from the repository's root)."""

import hashlib
import io
import os
import struct
import sys
import time

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

Image = pytest.importorskip("PIL.Image")

import chip_smoke  # noqa: E402
from madrona_tpu_torch.assets import importer  # noqa: E402
from madrona_tpu_torch.assets import jpeg, native_build  # noqa: E402
from madrona_tpu_torch.assets.jpeg import decode_jpeg  # noqa: E402
from madrona_tpu_torch.assets.png import decode_png  # noqa: E402

GOLDENS = os.path.join(ROOT, "tests", "goldens", "torch_images.npz")
BIG = 1024                 # the timed JPEG's side
BIG_QUALITY = 85
DECODE_LIMIT_S = 2.0       # the timed JPEG's decode on the CPU


def pil_rgba(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))


def seeded_image(h, w, kind, seed):
    """[h, w, 3] uint8 of a seed: "noise" (uniform), or "smooth" (waves
    and a little noise)."""
    rs = np.random.RandomState(seed)
    if kind == "noise":
        return rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    a = np.stack([128 + 100 * np.sin(xx / 7.0 + yy / 11.0),
                  128 + 90 * np.cos(yy / 5.0 - xx / 13.0),
                  (xx * 3 + yy * 5) % 256], -1)
    return np.clip(a + rs.randint(-12, 13, a.shape), 0, 255).astype(np.uint8)



def pil_jpeg(img, mode="RGB", **kw):
    im = Image.fromarray(img)
    if mode != "RGB":
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


def with_adobe_transform(data, transform):
    """``data`` (a JPEG with an Adobe APP14 segment) with its transform
    flag replaced."""
    b = bytearray(data)
    i = b.find(b"Adobe")
    b[i + 11] = transform
    return bytes(b)


def scan_offsets(data):
    """The offsets of a JPEG file's SOS markers, by walking its
    segments."""
    out, pos = [], 2
    while pos + 4 <= len(data):
        marker = data[pos + 1]
        if marker == 0xD9:
            break
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if marker == 0xDA:
            out.append(pos)
            pos += 2 + length
            # the entropy-coded data ends at a marker other than RSTn
            while not (data[pos] == 0xFF and data[pos + 1] not in (
                    0x00, *range(0xD0, 0xD8))):
                pos += 1
        else:
            pos += 2 + length
    return out


def scans_cut(data, keep):
    """A progressive file cut after its first ``keep`` scans (EOI
    appended)."""
    return data[:scan_offsets(data)[keep]] + b"\xff\xd9"


# -------------------------------------------------- a baseline encoder

def _dct_matrix():
    u = np.arange(8)[:, None]
    m = np.sqrt(2 / 8) * np.cos((2 * np.arange(8)[None] + 1) * u * np.pi
                                / 16)
    m[0] /= np.sqrt(2)
    return m


DCT = _dct_matrix()
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50,
    43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46,
    53, 60, 61, 54, 47, 55, 62, 63])
# fixed-length Huffman codes: 12 DC categories at 4 bits, the 162 AC
# symbols (EOB, ZRL, run/size 1-10) at 8 bits
DC_SYMBOLS = list(range(12))
AC_SYMBOLS = [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                             for s in range(1, 11)]
AC_CODE = {sym: i for i, sym in enumerate(AC_SYMBOLS)}


def _segment(marker, body):
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value, n):
        for i in range(n - 1, -1, -1):
            self.acc = (self.acc << 1) | ((value >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self):
        while self.n:
            self.put(1, 1)


def _size_bits(v):
    """(category, bits) of a coefficient or DC difference."""
    s = int(abs(v)).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def encode_jpeg(planes, factors, size, ids=None, qscale=1, restart=0,
                interleaved=True, jfif=True, app=b""):
    """A baseline JPEG of ``size`` (H, W) from component ``planes``
    (uint8, each at its own sampled size for the ``factors`` [(h, v),
    ...]). Quantisers 1 + qscale * (u + v); restart markers every
    ``restart`` MCUs; one scan of all components or one scan each (a
    single component is always a scan of its own blocks)."""
    n = len(planes)
    ids = ids or list(range(1, n + 1))
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    height, width = size
    interleaved = interleaved and n > 1
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    q = 1 + qscale * (np.arange(8)[:, None] + np.arange(8)[None])
    coefs = []
    for p, (h, v) in zip(planes, factors):
        bh, bw = mcuy * v, mcux * h
        pad = np.pad(p, ((0, bh * 8 - p.shape[0]), (0, bw * 8 - p.shape[1])),
                     mode="edge").astype(np.float64) - 128
        blocks = pad.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        f = DCT @ blocks @ DCT.T
        coefs.append(np.round(f / q).astype(np.int64).reshape(bh, bw, 64)[
            ..., ZIGZAG])
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\0\x01\x01\0\0\x01\0\x01\0\0")
    out += app
    out += _segment(0xDB, bytes([0]) + bytes(q.reshape(-1)[ZIGZAG].tolist()))
    out += _segment(0xC0, struct.pack(">BHHB", 8, height, width, n) + b"".join(
        bytes([i, (h << 4) | v, 0]) for i, (h, v) in zip(ids, factors)))
    out += _segment(0xC4, bytes([0x00]) + bytes(
        [0, 0, 0, len(DC_SYMBOLS)] + [0] * 12) + bytes(DC_SYMBOLS))
    out += _segment(0xC4, bytes([0x10]) + bytes(
        [0] * 7 + [len(AC_SYMBOLS)] + [0] * 8) + bytes(AC_SYMBOLS))
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))

    def block(bits, zz, pred):
        s, val = _size_bits(int(zz[0]) - pred)
        bits.put(s, 4)
        bits.put(val, s)
        run = 0
        for v in zz[1:]:
            if v == 0:
                run += 1
                continue
            while run > 15:
                bits.put(AC_CODE[0xF0], 8)
                run -= 16
            s, val = _size_bits(int(v))
            bits.put(AC_CODE[(run << 4) | s], 8)
            bits.put(val, s)
            run = 0
        if run:
            bits.put(AC_CODE[0x00], 8)
        return int(zz[0])

    def scan(comps, units):
        """``units``: a list of MCUs, each a list of (component, block)."""
        out_ = _segment(0xDA, bytes([len(comps)]) + b"".join(
            bytes([ids[c], 0x00]) for c in comps) + b"\x00\x3f\x00")
        bits, pred = _Bits(), [0] * n
        for i, unit in enumerate(units):
            if restart and i and i % restart == 0:
                bits.flush()
                bits.out += bytes([0xFF, 0xD0 + (i // restart - 1) % 8])
                pred = [0] * n
            for c, zz in unit:
                pred[c] = block(bits, zz, pred[c])
        bits.flush()
        return out_ + bytes(bits.out)

    if interleaved:
        units = [[(c, coefs[c][my * v + y, mx * h + x])
                  for c, (h, v) in enumerate(factors)
                  for y in range(v) for x in range(h)]
                 for my in range(mcuy) for mx in range(mcux)]
        out += scan(list(range(n)), units)
    else:
        for c, p in enumerate(planes):
            wb, hb = -(-p.shape[1] // 8), -(-p.shape[0] // 8)
            out += scan([c], [[(c, coefs[c][by, bx])] for by in range(hb)
                              for bx in range(wb)])
    return bytes(out + b"\xff\xd9")


def sampled_planes(img, factors):
    """The components of ``img`` [H, W, C] at their sampled sizes
    (every k-th sample of a component k times coarser)."""
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    return [np.ascontiguousarray(img[::vmax // v, ::hmax // h, c])
            for c, (h, v) in enumerate(factors)]


ADOBE = {t: _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, t))
         for t in (0, 1, 2)}

OWN = [  # (name, factors, options)
    ("440", [(1, 2), (1, 1), (1, 1)], {}),
    ("mixed", [(2, 2), (1, 2), (2, 1)], {}),
    ("chroma_finer", [(1, 1), (2, 2), (2, 1)], {}),
    ("h2v1_h1v2", [(2, 1), (1, 2), (1, 1)], {}),
    ("rgb_ids", [(2, 2), (1, 1), (1, 1)],
     dict(ids=[ord("R"), ord("G"), ord("B")], jfif=False)),
    ("rgb_adobe", [(1, 2), (1, 1), (1, 1)], dict(jfif=False,
                                                 app=ADOBE[0])),
    ("ycc_adobe", [(2, 1), (1, 1), (1, 1)], dict(jfif=False, app=ADOBE[1])),
    ("cmyk", [(1, 1), (1, 1), (1, 1), (2, 2)], dict(jfif=False,
                                                   app=ADOBE[0])),
    ("ycck", [(2, 2), (1, 1), (1, 1), (2, 2)], dict(jfif=False,
                                                   app=ADOBE[2])),
    ("cmyk_plain", [(2, 1), (2, 1), (1, 1), (1, 1)], dict(jfif=False)),
    ("grey_2x2", [(2, 2)], {}),
    ("separate", [(2, 2), (1, 1), (1, 1)], dict(interleaved=False)),
    ("separate_440", [(1, 2), (1, 1), (1, 1)],
     dict(interleaved=False, restart=5)),
    ("restart", [(2, 2), (1, 2), (1, 1)], dict(restart=2)),
]


def own_jpeg(name, factors, options, h, w, kind, seed, qscale):
    img = seeded_image(h, w, kind, seed)
    if len(factors) == 4:
        img = np.concatenate([img, img[..., :1] // 2 + 60], -1)
    elif len(factors) == 1:
        img = img[..., :1]
    return encode_jpeg(sampled_planes(img, factors), factors, (h, w),
                       qscale=qscale, **options)


# ---------------------------------------------------------------- goldens

def golden_files():
    """{name: file bytes} of the committed goldens: PIL's JPEGs of the
    variants (37 x 53 unless named), this module's own encoder's, the
    timed 1024 x 1024 4:2:0 file, and chip_smoke.py's 16-bit interlaced
    PNG texture."""
    files = {}
    smooth = seeded_image(37, 53, "smooth", 1)
    for sub, tag in ((0, "444"), (1, "422"), (2, "420")):
        files[f"pil_{tag}"] = pil_jpeg(smooth, quality=75, subsampling=sub)
        files[f"pil_{tag}_prog"] = pil_jpeg(smooth, quality=90,
                                            subsampling=sub, progressive=True)
    files["pil_420_rst"] = pil_jpeg(smooth, quality=60, subsampling=2,
                                    restart_marker_blocks=3)
    # progressive files cut short: block smoothing with DC only, and with
    # the luma's AC refined to 1 bit short
    files["pil_420_prog_dc"] = scans_cut(files["pil_420_prog"], 1)
    files["pil_420_prog_cut9"] = scans_cut(files["pil_420_prog"], 9)
    files["pil_grey"] = pil_jpeg(smooth, "L", quality=80)
    files["pil_grey_prog"] = pil_jpeg(smooth, "L", quality=80,
                                      progressive=True)
    files["pil_cmyk"] = pil_jpeg(smooth, "CMYK", quality=80)
    files["pil_ycck"] = with_adobe_transform(files["pil_cmyk"], 2)
    files["pil_rgb"] = pil_jpeg(smooth, quality=85, keep_rgb=True)
    files["pil_noise_q20"] = pil_jpeg(seeded_image(13, 29, "noise", 2),
                                      quality=20, subsampling=2)
    for name, factors, options in OWN:
        files[f"own_{name}"] = own_jpeg(name, factors, options, 29, 45,
                                        "smooth", 3, 2)
    # the scene's textures (chip_smoke.write_image_assets)
    files["glb_420"] = pil_jpeg(seeded_image(48, 40, "smooth", 4), quality=85,
                                subsampling=2)
    files["gltf_prog"] = pil_jpeg(seeded_image(32, 24, "smooth", 5),
                                  quality=90, subsampling=1, progressive=True)
    files["mtl_png16"] = chip_smoke.image_asset_png()
    files["big"] = pil_jpeg(seeded_image(BIG, BIG, "smooth", 6),
                            quality=BIG_QUALITY, subsampling=2)
    return files


def golden_arrays():
    """The npz's arrays: each file's bytes (``<name>.file``) and PIL's
    RGBA (``<name>.rgba``), or for the 1024 x 1024 file the SHA-256 of
    PIL's RGBA (``big.sha256``); and test_torch_image_formats.py's
    (BMP, TGA, GIF and WebP, named ``fmt_*``), test_torch_image_dds.py's
    (DDS, PBM/PGM/PPM/PFM, QOI, ICO and CUR, named ``fmt2_*``) and
    test_torch_image_tiff.py's (TIFF, named ``fmt3_*``)."""
    import test_torch_image_dds
    import test_torch_image_formats
    import test_torch_image_tiff

    out = test_torch_image_formats.golden_arrays()
    out.update(test_torch_image_dds.golden_arrays())
    out.update(test_torch_image_tiff.golden_arrays())
    for name, data in golden_files().items():
        out[f"{name}.file"] = np.frombuffer(data, np.uint8)
        rgba = pil_rgba(data)
        if name == "big":
            out["big.sha256"] = np.frombuffer(
                hashlib.sha256(rgba.tobytes()).digest(), np.uint8)
            out["big.shape"] = np.asarray(rgba.shape, np.int64)
        else:
            out[f"{name}.rgba"] = rgba
    return out


def write_goldens(path=GOLDENS):
    np.savez_compressed(path, **golden_arrays())
    return os.path.getsize(path)


# ------------------------------------------------------------------ tests

def test_jpeg_from_pil_matches_pil():
    """PIL's own JPEGs: every mode, subsampling, progression, quality,
    odd size and restart setting above."""
    n = 0
    for h, w in ((1, 1), (3, 3), (2, 9), (9, 2), (5, 7), (8, 8), (16, 16),
                 (37, 53), (53, 37), (17, 4)):
        for kind, seed in (("noise", h), ("smooth", w)):
            img = seeded_image(h, w, kind, seed)
            for mode, subs in (("RGB", (0, 1, 2)), ("L", (None,)),
                               ("CMYK", (None,))):
                for sub in subs:
                    for prog in (False, True):
                        for q, rst in ((5, 0), (50, 3), (95, 1), (100, 0)):
                            kw = dict(quality=q, progressive=prog)
                            if sub is not None:
                                kw["subsampling"] = sub
                            if rst:
                                kw["restart_marker_blocks"] = rst
                            data = pil_jpeg(img, mode, **kw)
                            np.testing.assert_array_equal(
                                decode_jpeg(data), pil_rgba(data),
                                err_msg=f"{(h, w, kind, mode, kw)}")
                            n += 1
                            if mode == "CMYK":
                                data = with_adobe_transform(data, 2)
                                np.testing.assert_array_equal(
                                    decode_jpeg(data), pil_rgba(data),
                                    err_msg=f"YCCK {(h, w, kind, kw)}")
                                n += 1
            if h * w > 4:      # keep_rgb writes 4:4:4 only
                data = pil_jpeg(img, quality=70, keep_rgb=True)
                np.testing.assert_array_equal(decode_jpeg(data),
                                              pil_rgba(data))
                n += 1
    assert n == 20 * (5 * 8 + 8) + 18
    # every prefix of progressive files: libjpeg's block smoothing
    n = 0
    for h, w in ((24, 40), (17, 33), (37, 53), (9, 48), (33, 17), (8, 16),
                 (70, 5)):
        for kind, seed in (("noise", h), ("smooth", w)):
            img = seeded_image(h, w, kind, seed)
            for mode, sub in (("RGB", 0), ("RGB", 1), ("RGB", 2), ("L", None),
                              ("CMYK", None)):
                kw = dict(quality=60, progressive=True)
                if sub is not None:
                    kw["subsampling"] = sub
                data = pil_jpeg(img, mode, **kw)
                for keep in range(1, len(scan_offsets(data))):
                    cut = scans_cut(data, keep)
                    np.testing.assert_array_equal(
                        decode_jpeg(cut), pil_rgba(cut),
                        err_msg=f"{(h, w, kind, mode, sub)} cut {keep}")
                    n += 1
    assert n == 7 * 2 * (3 * 9 + 5 + 17)


def test_jpeg_from_own_encoder_matches_pil():
    """This module's baseline files: sampling factors PIL does not write,
    RGB by ids or Adobe transform, CMYK/YCCK with subsampled components,
    separate scans, restart intervals; odd sizes, two quantiser scales."""
    n = 0
    for name, factors, options in OWN:
        for h, w in ((29, 45), (1, 1), (3, 5), (17, 2), (16, 32)):
            for kind, qscale in (("smooth", 1), ("noise", 6)):
                data = own_jpeg(name, factors, options, h, w, kind, h + w,
                                qscale)
                ref = pil_rgba(data)
                assert ref.shape == (h, w, 4)
                np.testing.assert_array_equal(
                    decode_jpeg(data), ref,
                    err_msg=f"{name} {h}x{w} {kind}")
                n += 1
    assert n == len(OWN) * 10


def _patched_sof(data, marker=None, precision=None, factors=None):
    b = bytearray(data)
    i = next(k for k in range(len(b) - 1)
             if b[k] == 0xFF and b[k + 1] in (0xC0, 0xC1, 0xC2))
    if marker is not None:
        b[i + 1] = marker
    if precision is not None:
        b[i + 4] = precision
    if factors is not None:
        b[i + 11] = factors
    return bytes(b)


def test_refused_jpeg_variants_name_themselves():
    """Each variant the decoder leaves out raises ValueError naming it."""
    base = pil_jpeg(seeded_image(16, 16, "smooth", 0), quality=80,
                    subsampling=2)
    cases = [
        (_patched_sof(base, marker=0xC9), "arithmetic coding"),
        (_patched_sof(base, marker=0xCA), "arithmetic coding"),
        (_patched_sof(base, marker=0xC1, precision=12), "12-bit samples"),
        (_patched_sof(base, marker=0xC3), "lossless"),
        (_patched_sof(base, marker=0xC5), "hierarchical"),
        (_patched_sof(base, factors=0x41), "sampling factors 4x1"),
        (_patched_sof(base, factors=0x33), "sampling factors 3x3"),
        (encode_jpeg([np.zeros((8, 8), np.uint8)] * 2, [(1, 1)] * 2,
                     (8, 8)), "2-component"),
    ]
    for data, name in cases:
        with pytest.raises(ValueError, match=name):
            decode_jpeg(data)
    with pytest.raises(ValueError, match="not a JPEG"):
        decode_jpeg(chip_smoke.png_bytes(np.zeros((2, 2), np.uint8)))


def test_png_16bit_and_interlaced_match_pil():
    """16-bit grey, grey+alpha, RGB and RGBA (with 16-bit colour keys on
    grey and RGB: Pillow matches the key's low byte); Adam7 at 1, 2, 4,
    8 and 16 bits in every colour type, each filter and a mix."""
    rs = np.random.RandomState(0)
    files = []
    for c in (1, 2, 3, 4):
        for h, w in ((13, 17), (1, 1), (3, 9), (9, 2)):
            img = rs.randint(0, 65536, (h, w, c)).astype(np.uint16)
            img[:, ::3] %= 300            # grey values about 255 too
            img = img if c > 1 else img[..., 0]
            for interlace in (False, True):
                files.append(chip_smoke.png_bytes(
                    img, depth=16, interlace=interlace,
                    filters=[0, 1, 2, 3, 4]))
            if c in (1, 3):
                keys = ([int(img.reshape(-1, c)[0, 0]) & 0xFF | 0x300]
                        * c, [0] * c, list(img.reshape(-1, c)[-1]))
                for key in keys:
                    files.append(chip_smoke.png_bytes(
                        img, depth=16, trns=key[:c], filters=2))
    for h, w in ((13, 17), (1, 1), (2, 3), (8, 8), (9, 31)):
        for depth in (1, 2, 4):
            idx = rs.randint(0, 1 << depth, (h, w)).astype(np.uint8)
            palette = rs.randint(0, 256, (1 << depth, 3))
            for filt in (0, 4, [0, 1, 2, 3, 4]):
                files.append(chip_smoke.png_bytes(
                    idx, depth=depth, interlace=True, filters=filt))
                files.append(chip_smoke.png_bytes(
                    idx, depth=depth, interlace=True, filters=filt,
                    palette=palette, trns=[0, 128]))
            files.append(chip_smoke.png_bytes(idx, depth=depth, trns=[0]))
        for c in (1, 2, 3, 4):
            img = rs.randint(0, 256, (h, w, c)).astype(np.uint8)
            for filt in (1, 3, [4, 2, 0, 1, 3]):
                files.append(chip_smoke.png_bytes(
                    img if c > 1 else img[..., 0], interlace=True,
                    filters=filt))
    for data in files:
        got = decode_png(data)
        np.testing.assert_array_equal(got, pil_rgba(data))
    assert len(files) == 4 * 4 * 2 + 2 * 4 * 3 + 5 * (3 * 7 + 4 * 3)


def test_goldens_match_pil():
    """tests/goldens/torch_images.npz is what this module writes today:
    the same files (PIL's encoders, this module's,
    test_torch_image_formats.py's, test_torch_image_dds.py's and
    test_torch_image_tiff.py's), PIL's RGBA of each (the 1024^2 files'
    SHA-256), and under 1 MB."""
    assert os.path.getsize(GOLDENS) < 1 << 20
    with np.load(GOLDENS) as z:
        stored = {k: z[k] for k in z.files}
    want = golden_arrays()
    assert sorted(stored) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(stored[k], v, err_msg=k)


def test_decoder_builds_from_source(tmp_path, monkeypatch):
    """The decoder's library is built by g++ from native/jpeg_decode.cpp
    into the build directory, keyed by a hash of the source and flags,
    and decodes there."""
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(jpeg, "_LIB", None)
    lib = native_build.library_path(jpeg.SOURCE)
    assert lib.parent == tmp_path and not lib.exists()
    assert lib.name.startswith("jpeg_decode-")
    data = pil_jpeg(seeded_image(9, 7, "noise", 0), quality=90)
    np.testing.assert_array_equal(decode_jpeg(data), pil_rgba(data))
    assert lib.exists() and [p.name for p in tmp_path.iterdir()] == [lib.name]


def test_importer_dispatch():
    """_decode_image takes PNG, JPEG, GIF, BMP, WebP, DDS and TGA by their
    magic bytes (TGA by its header), as PIL would decode them; a variant
    PIL opens that the port does not decode (a JPEG-compressed TIFF)
    raises ValueError naming the format."""
    png = chip_smoke.png_bytes(np.arange(12, dtype=np.uint16).reshape(3, 4)
                               * 5000, depth=16, interlace=True)
    jpg = pil_jpeg(seeded_image(5, 6, "smooth", 0), quality=70,
                   progressive=True)
    img = Image.fromarray(seeded_image(4, 4, "noise", 0))
    files = [png, jpg]
    for fmt in ("GIF", "BMP", "WEBP", "DDS", "TGA"):
        buf = io.BytesIO()
        img.save(buf, fmt)
        files.append(buf.getvalue())
    for data in files:
        assert pil_rgba(data).shape == (4, 4, 4) or data in (png, jpg)
        np.testing.assert_array_equal(
            importer._decode_image(data, "t").data, pil_rgba(data))
    for fmt in ("TIFF",):
        buf = io.BytesIO()
        img.save(buf, fmt, compression="jpeg")
        with pytest.raises(ValueError, match=fmt):
            importer._decode_image(buf.getvalue(), "t")


def test_decode_time_1024():
    """The timed golden, a smooth 1024 x 1024 4:2:0 JPEG at quality 85:
    equal to PIL's RGBA (its SHA-256), decoded in under 2 s on the CPU
    (the best of 3 calls, printed)."""
    data = golden_files()["big"]
    decode_jpeg(data)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        got = decode_jpeg(data)
        best = min(best, time.perf_counter() - t0)
    with np.load(GOLDENS) as z:
        assert hashlib.sha256(got.tobytes()).digest() == bytes(
            z["big.sha256"])
    print(f"decode_jpeg of a {BIG}^2 4:2:0 JPEG at quality {BIG_QUALITY} "
          f"({len(data)} bytes): {best * 1e3:.2f} ms on the CPU")
    assert best < DECODE_LIMIT_S


if __name__ == "__main__":
    if sys.argv[1:] != ["--write-goldens"]:
        sys.exit("usage: python tests/test_torch_image_decode.py "
                 "--write-goldens")
    print(f"{GOLDENS}: {write_goldens()} bytes")
