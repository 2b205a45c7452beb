#!/usr/bin/env python3
"""Device time of the contacts kernel (csrc/contacts.cu) over its launch
parameters, on the card.

    python3 scripts/torch_contacts_tiles.py

The kernel takes a tile of worlds a block and sends a tile's hull-hull
lanes a warp each when the tile has at most ``warp_lanes_max`` of them,
else a thread each; ``contacts_launch`` fixes both (the tile of one
wave, 16 lanes). This script calls its ``contacts_launch_tiled`` entry
point over tile widths, with a thread a hull-hull lane and with a warp a
lane, on chip_smoke.py's scenes at the main paths' shapes: the
Escape Room probe state (4096 worlds), the arranged Hide & Seek state
(16,384 worlds) and the crowded box scene (4096 worlds), both SAT tiers
on the last. Each launch's five tables must equal the default launch's
bit for bit. Prints the card's name and power limit, nvcc's register and
spill report of each function of the kernel, then device ms
(chip_smoke.timed_device: the calls enqueued behind a sleep kernel) a
line per scene and setting. Needs CUDA and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs                                      # noqa: E402
from madrona_tpu_torch import make_sim                       # noqa: E402
from madrona_tpu_torch.models.escape_room import EscapeRoom  # noqa: E402
from madrona_tpu_torch.models.hide_seek import HideSeek      # noqa: E402
from madrona_tpu_torch.ops import contacts_cuda, cuda_build  # noqa: E402
from madrona_tpu_torch.ops.solver_cuda import CON_F, PTS_F   # noqa: E402
from madrona_tpu_torch.physics import api as papi            # noqa: E402

TILES = (0, 16, 32, 64, 128)   # 0: the kernel's one-wave tile
_P, _I = ctypes.c_void_p, ctypes.c_int


def tiled_entry():
    lib = ctypes.CDLL(str(cuda_build.build(["contacts.cu"])["contacts.cu"]))
    for line in cuda_build.BUILD_LOG.get("contacts.cu", "").splitlines():
        if "registers" in line or "spill" in line or "Function" in line:
            print(f"  contacts.cu: {line.strip()}")
    fn = lib.contacts_launch_tiled
    fn.argtypes = [_P] * 11 + [_I] * 13 + [_P]
    fn.restype = ctypes.c_int
    return lib, fn


def launch_tiled(fn, args, om, edge_dirs, tile, lanes_max):
    """contacts_cuda._launch with the tile width and threshold given."""
    hh, hp, poses, obj = args
    n, _, w = poses.shape
    ph, pp = hh.shape[1], hp.shape[1]
    c = ph + pp
    i32, f32 = torch.int32, torch.float32
    out = [torch.empty((c, w), dtype=i32, device="cuda") for _ in range(2)]
    con = torch.empty((CON_F, c, w), dtype=f32, device="cuda")
    pts = torch.empty((PTS_F, c, w), dtype=f32, device="cuda")
    num = torch.empty((c, w), dtype=i32, device="cuda")
    dims = tuple(om.hull_dims)
    err = fn(hh.data_ptr(), hp.data_ptr(), poses.data_ptr(), obj.data_ptr(),
             om.hull_pack.data_ptr(), om.hull_dirs_pack.data_ptr(),
             out[0].data_ptr(), out[1].data_ptr(), con.data_ptr(),
             pts.data_ptr(), num.data_ptr(), n, w, ph, pp,
             om.hull_pack.shape[0], *dims, om.n_edge_dirs,
             0 if edge_dirs else 1, tile, lanes_max,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"contacts_launch_tiled: CUDA error {err}")
    return out[0], out[1], con, pts, num


def scenes():
    """{name: (contacts inputs, ObjectManager, edge_dirs)}."""
    w = cs.W
    acts = EscapeRoom.random_actions(np.random.RandomState(0), 3, w).to("cuda")
    probe = make_sim(EscapeRoom(), num_worlds=w, seed=1, device="cuda")
    for i in range(3):
        probe.step({"action": acts[i],
                    "reset": torch.zeros((w,), dtype=torch.int32,
                                         device="cuda")})
    env = probe.env
    om = env.om.to("cuda")
    body = papi.body_state(probe.executor.sm, probe.state)
    out = {"escape_room": (cs.contacts_inputs(body, om, env.caps, env.cfg),
                           om, True)}
    hs = make_sim(HideSeek(pixels=False), num_worlds=cs.HS_STATE_W, seed=1,
                  device="cuda")
    hs.step({})
    hom = hs.env.om.to("cuda")
    hbody = papi.body_state(hs.executor.sm, cs.arrange_hide_seek(hs))
    out["hide_seek"] = (cs.contacts_inputs(hbody, hom, hs.env.caps,
                                           hs.env.cfg), hom, True)
    om_cr, body_cr, caps_cr = cs.crowded_scene()
    cr = cs.contacts_inputs(body_cr, om_cr, caps_cr, env.cfg)
    out["crowded edge_dirs"] = (cr, om_cr, True)
    out["crowded edge_pairs"] = (cr, om_cr, False)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_contacts_tiles: CUDA is not available", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card)
    _lib, fn = tiled_entry()
    for name, (args, om, dirs) in scenes().items():
        ref = contacts_cuda.contacts(*args, om, dirs)
        hh_live = int(((args[0][..., 0] < args[2].shape[0])
                       & (args[0][..., 1] < args[2].shape[0])).sum())
        default_ms = cs.timed_device(lambda: contacts_cuda.contacts(
            *args, om, dirs))
        print(f"{name}: W={args[2].shape[2]} hull-hull candidates {hh_live}; "
              f"default launch {default_ms:.4f} ms ({card})")
        for tile in TILES:
            row = []
            # 0: a thread a hull-hull lane; 2**30: a warp a lane
            for lanes_max in (0, 1 << 30):
                got = launch_tiled(fn, args, om, dirs, tile, lanes_max)
                if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    raise AssertionError(f"{name}: tile {tile}, threshold "
                                         f"{lanes_max} differs")
                ms = cs.timed_device(lambda: launch_tiled(
                    fn, args, om, dirs, tile, lanes_max))
                row.append(f"{'thread' if lanes_max == 0 else 'warp'}: "
                           f"{ms:.4f}")
            print(f"  {name} tile {tile or 'one wave'}: device ms, a lane "
                  "by " + ", ".join(row))
    return 0


if __name__ == "__main__":
    sys.exit(main())
