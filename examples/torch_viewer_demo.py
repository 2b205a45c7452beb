#!/usr/bin/env python
"""Interactive viewer demo on the PyTorch port: fly around live Escape
Room worlds stepped on the card (the counterpart of
``examples/viewer_demo.py``).

Usage: python examples/torch_viewer_demo.py [--port 8787] [--worlds 4]
                                            [--device cuda|cpu]
then open http://127.0.0.1:8787/ in a browser.

Each tick steps the sim through its kernels on the card (the broadphase,
contacts, solver and lidar), and each frame is the dense tracer's view
from the flycam (madrona_tpu_torch/viz/web_viewer.py).
"""

import argparse
import os
import sys

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
)

from madrona_tpu_torch import make_sim                       # noqa: E402
from madrona_tpu_torch.models.escape_room import EscapeRoom  # noqa: E402
from madrona_tpu_torch.render import MeshRegistry            # noqa: E402
from madrona_tpu_torch.viz import WebViewer                  # noqa: E402


def make_viewer(worlds: int, device=None, **kw) -> WebViewer:
    """A viewer of Escape Room at ``worlds`` worlds: every body drawn as
    a unit box scaled by its Scale (the JAX demo's mapping)."""
    sim = make_sim(EscapeRoom(), num_worlds=worlds, seed=0, device=device)
    reg = MeshRegistry()
    box = reg.add_box(0.5, color=(0.85, 0.55, 0.2))
    n = sim.state.tables["RigidBody"].columns["Position"].shape[1]
    return WebViewer(sim, reg.build(), [box] * n, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8787)
    ap.add_argument("--worlds", type=int, default=4)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    make_viewer(args.worlds, args.device, fps=10.0).serve(port=args.port)


if __name__ == "__main__":
    main()
