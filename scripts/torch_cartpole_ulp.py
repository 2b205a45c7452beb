#!/usr/bin/env python3
"""How far one ulp of cos and sin a step moves Cartpole's observations.

    python3 scripts/torch_cartpole_ulp.py [--worlds 16384] [--steps 50]

Rolls the port's Cartpole on the CPU at ``bench.py``'s point (seed 0,
``Cartpole.random_actions(RandomState(0), ...)``) once as it is and once
each with ``torch.cos``, ``torch.sin`` or both moved one ulp (up, or
down) at every call, and prints the largest observation difference over
the steps in which the episode clocks still agree, and how many worlds'
done schedules differ. ``chip_smoke.py`` phase 21 bounds the card's
difference from the CPU by two such ulps a step (CUDA's bound for cosf
and sinf). Needs no GPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from madrona_tpu_torch import make_sim, rollout              # noqa: E402
from madrona_tpu_torch.models.cartpole import Cartpole      # noqa: E402


def run(w, t, inputs):
    return rollout(make_sim(Cartpole(), num_worlds=w, seed=0, device="cpu"),
                   inputs)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=16384)
    ap.add_argument("--steps", type=int, default=50)
    args = ap.parse_args()
    w, t = args.worlds, args.steps
    acts = Cartpole.random_actions(np.random.RandomState(0), t, w)
    inputs = {"action": acts, "reset": torch.zeros((t, w), dtype=torch.int32)}
    ref = run(w, t, inputs)
    cos, sin = torch.cos, torch.sin

    def moved(f, to):
        return lambda x: torch.nextafter(f(x), torch.full_like(x, to))

    cases = (("cos up", moved(cos, 2.0), sin), ("sin up", cos, moved(sin, 2.0)),
             ("both down", moved(cos, -2.0), moved(sin, -2.0)))
    for name, fc, fs in cases:
        torch.cos, torch.sin = fc, fs
        try:
            got = run(w, t, inputs)
        finally:
            torch.cos, torch.sin = cos, sin
        flip = got["done"] != ref["done"]
        first = torch.where(flip.any(0), flip.int().argmax(0), t)
        same = torch.arange(t)[:, None] < first[None]
        d = (got["obs"][:, :, 0] - ref["obs"][:, :, 0]).abs().amax(-1)
        print(f"{name}: largest obs difference "
              f"{float(torch.where(same, d, 0.0).max())!r} over {t} steps x "
              f"{w} worlds; worlds whose done schedule differs: "
              f"{int(flip.any(0).sum())}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
