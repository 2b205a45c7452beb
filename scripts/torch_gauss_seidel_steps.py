#!/usr/bin/env python3
"""chip_smoke.py phase 29's card-against-CPU check at every step.

The box stack with a sphere and joints (``chip_smoke.stack_scene``) at
``solver="gauss_seidel"`` runs on the card at 1024 worlds; after each
step, the state of worlds 0-7 is carried to an 8-world executor on the
card and one on the CPU, each takes one step, and the body states are
compared with phase 29's rule: within the golden bounds (pos/rot 1e-3,
vel 5e-2, omega 2e-1), or outside one only where the CPU itself, from
the state with every position scaled by 1 +- 1e-7, is outside it at the
same (world, body) (a witness). Prints one line a step: the largest
difference of each field, and every (world, body, field) outside a
bound with whether a witness covers it. Raises nothing: it maps where
the check would fail.

Run on the card: python3 scripts/torch_gauss_seidel_steps.py [--steps 30]
"""

from __future__ import annotations

import argparse
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def main(argv=None):
    import torch

    import chip_smoke as cs
    from madrona_tpu_torch.physics.xpbd import PhysicsConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--worlds", type=int, default=cs.GS_W)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("CUDA is not available", file=sys.stderr)
        return 2
    print(cs.card_line())
    cfg = PhysicsConfig(solver="gauss_seidel", dt=1.0 / 60.0)
    ex, _, _ = cs.stack_scene(cfg, args.worlds, "cuda")
    step = ex.step_fn()
    worlds = list(cs.CHECK_WORLDS)
    card_fn = cs.stack_scene(cfg, len(worlds), "cuda")[0].step_fn()
    cpu_fn = cs.stack_scene(cfg, len(worlds), "cpu")[0].step_fn()
    state = ex.state
    for t in range(args.steps):
        start = cs.world_slice(state, worlds, "cpu")
        got = cs.body_tree(card_fn(cs.world_slice(state, worlds, "cuda"),
                                   {})[0])
        ref = cs.body_tree(cpu_fn(start, {})[0])
        worst = {k: float((got[k] - ref[k]).abs().max()) for k in cs.GOLDEN}
        off = cs.outside_golden(got, ref)
        wit = {}
        if off:
            for f in cs.PILE_NUDGES:
                nudged = cs.body_tree(cpu_fn(cs.nudged(start, f), {})[0])
                for k, (mask, _) in cs.outside_golden(nudged, ref).items():
                    wit[k] = wit[k] | mask if k in wit else mask
        cases = []
        for k, (mask, _) in off.items():
            d = (got[k] - ref[k]).abs().amax(-1)
            for w_, b_ in torch.nonzero(mask).tolist():
                covered = k in wit and bool(wit[k][w_, b_])
                cases.append(f"world {worlds[w_]} body {b_} {k} "
                             f"{float(d[w_, b_]):.4g}"
                             f"{' (witness)' if covered else ' (NO witness)'}")
        print(f"step {t}: largest differences " + ", ".join(
            f"{k} {v:.3g}" for k, v in worst.items())
            + (f"; outside: {'; '.join(cases)}" if cases else ""),
            flush=True)
        state = step(state, {})[0]
    return 0


if __name__ == "__main__":
    sys.exit(main())
