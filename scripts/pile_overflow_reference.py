#!/usr/bin/env python
"""Where the JAX package's Pile sets its broadphase-overflow flag.

    JAX_PLATFORMS=cpu python scripts/pile_overflow_reference.py [--worlds 64]
                                                               [--steps 100]

Steps the JAX package's ``Pile()`` (256 bodies a world) on the CPU at
``bench.py``'s point, seed 0, twice: with ``bench.py``'s actions
(``RandomState(0).randint(0, 5, (steps, worlds))``: lateral shakes) and
without (action 0), and prints for each world the first step after
which ``summary[:, 5]`` (the flag the physics node keeps, a saturated
candidate list or sweep window) is set, or -1. These are the reference
figures that ``chip_smoke.py`` phase 18 and 20 compare the port's with:
the port on the card must set the flag where the shakes saturate the
lists, as this run does, and never without shakes. Runs the JAX
package on the CPU only; it takes a few minutes.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def onsets(steps, worlds, acts):
    import jax.numpy as jnp

    from madrona_tpu.models.base import make_sim
    from madrona_tpu.models.pile import Pile

    sim = make_sim(Pile(), num_worlds=worlds, seed=0, donate=False)
    step = sim.step_fn()
    state = sim.state
    first = np.full(worlds, -1)
    reset = jnp.zeros((worlds,), jnp.int32)
    for t in range(steps):
        state, out = step(state, {"action": jnp.asarray(acts[t]),
                                  "reset": reset})
        flag = np.asarray(out["summary"])[:, 5] > 0
        first[flag & (first < 0)] = t + 1
    return first


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=64)
    ap.add_argument("--steps", type=int, default=100)
    args = ap.parse_args()
    w, t = args.worlds, args.steps
    shakes = np.random.RandomState(0).randint(0, 5, (t, w)).astype(np.int32)
    for name, acts in (("bench.py's actions", shakes),
                       ("no shakes", np.zeros((t, w), np.int32))):
        first = onsets(t, w, acts)
        set_in = np.nonzero(first > 0)[0]
        print(f"{name}: flag set in {len(set_in)} of {w} worlds over {t} "
              f"steps; first step by world (-1: never): {first.tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
