#!/usr/bin/env python3
"""How often an op rounds apart on the card and on the CPU, from the same
float32 inputs.

For each pattern of the physics path, N random inputs (float32, from a
seed) go through the op on the card and on the CPU, and the script
counts the outputs that differ in any bit and prints the largest
relative difference:

  * ``x / h`` with ``h`` a Python float (the card multiplies by the
    reciprocal) against ``x / h_t`` with ``h_t`` a float32 tensor on the
    device (a true division on both);
  * ``torch.linalg.vector_norm`` over 3 terms against ``math3d.norm``;
  * ``sum(dim=-1)`` over 4 terms against ``math3d.sum_in_order``;
  * ``torch.sqrt``, which no repair of the physics path touches.

Prints the card's name and power limit first, and one JSON line last.

Run on the card: python3 scripts/torch_card_rounding.py [--n 4194304]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from madrona_tpu_torch.utils import math3d as m3  # noqa: E402


def differing(card: torch.Tensor, cpu: torch.Tensor):
    """(outputs that differ in a bit, largest relative difference)."""
    a = card.cpu()
    n = int((a.view(torch.int32) != cpu.view(torch.int32)).sum())
    rel = ((a.double() - cpu.double()).abs()
           / cpu.double().abs().clamp(min=1e-30)).max()
    return n, float(rel)


def patterns(n: int, gen: torch.Generator):
    """{name: (fn, input)}: each fn runs on an input on any device."""
    h = 1.0 / 240.0
    x = torch.randn(n, generator=gen)
    v3 = torch.randn(n, 3, generator=gen)
    v4 = torch.rand(n, 4, generator=gen)
    pos = torch.rand(n, generator=gen) * 10
    return {
        "div by a Python float": (lambda t: t / h, x),
        "div by a device tensor": (
            lambda t: t / torch.tensor([h], dtype=torch.float32,
                                       device=t.device), x),
        "linalg.vector_norm (3 terms)": (
            lambda t: torch.linalg.vector_norm(t, dim=-1), v3),
        "math3d.norm (3 terms)": (m3.norm, v3),
        "sum(dim=-1) (4 terms)": (lambda t: t.sum(dim=-1), v4),
        "math3d.sum_in_order (4 terms)": (m3.sum_in_order, v4),
        "sqrt": (torch.sqrt, pos),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 22)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_card_rounding: CUDA is not available", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip())
    gen = torch.Generator().manual_seed(args.seed)
    out = {}
    for name, (fn, x) in patterns(args.n, gen).items():
        n, rel = differing(fn(x.cuda()), fn(x))
        out[name] = {"differ": n, "of": fn(x).numel(),
                     "largest_rel": rel}
        print(f"{name:32s} {n:9d} of {fn(x).numel()} outputs differ, "
              f"largest relative difference {rel:.3g}")
    print(json.dumps({"n": args.n, "seed": args.seed, "ops": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
