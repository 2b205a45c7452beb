#!/usr/bin/env python3
"""Seconds to decode a texture with ``madrona_tpu_torch.assets.png``.

Writes square RGBA PNGs with chip_smoke.py's own writer (``png_bytes``),
every row under one scanline filter (0 None, 1 Sub, 2 Up, 3 Average,
4 Paeth), and times ``decode_png`` on each (the best of ``--repeat``
runs, on the host's clock), checking that it gives the image back.
Needs numpy and zlib only.

Run: python3 scripts/torch_png_decode_time.py [--sizes 1024 2048]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main(argv=None):
    import chip_smoke as cs
    from madrona_tpu_torch.assets.png import decode_png

    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", type=int, nargs="+", default=[1024, 2048])
    ap.add_argument("--filters", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--repeat", type=int, default=2)
    args = ap.parse_args(argv)
    rs = np.random.RandomState(0)
    for n in args.sizes:
        # a smooth image with noise, as textures are
        yy, xx = np.mgrid[0:n, 0:n] / n
        base = np.stack([xx, yy, 0.5 * (xx + yy), 1 - 0.5 * xx], -1) * 255
        img = np.clip(base + rs.randint(-8, 9, (n, n, 4)), 0, 255).astype(
            np.uint8)
        for f in args.filters:
            data = cs.png_bytes(img, filters=f)
            best = float("inf")
            for _ in range(args.repeat):
                t0 = time.perf_counter()
                out = decode_png(data)
                best = min(best, time.perf_counter() - t0)
            if not np.array_equal(out, img):
                raise AssertionError(f"{n}^2 filter {f}: decoded image "
                                     "differs")
            print(f"decode_png {n} x {n} RGBA, filter {f}: {best:.4f} s "
                  f"({len(data)} bytes)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
