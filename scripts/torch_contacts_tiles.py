#!/usr/bin/env python3
"""Device time of the tiled narrowphase kernels over their launch
parameters, on the card.

    python3 scripts/torch_contacts_tiles.py [--kernel contacts|hh_record|fused]
                                            [--split]

``--kernel contacts`` (the default):
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
line per scene and setting.

``--kernel hh_record``: the hull-hull record kernel (csrc/
hh_narrowphase.cu) through ``hh_record_launch_tiled``, the same way, on
the Escape Room probe state and the crowded scene (4096 worlds each),
both SAT tiers; each setting's records must equal the default launch's.

``--kernel fused``: the fused-step kernel (csrc/fused_step.cu) on the
Escape Room state with grab joints (4096 worlds), the arranged Hide &
Seek state (16,384 worlds) and the sphere scene (4096 worlds, both SAT
tiers). First split by phase, for the default launch and each launch
bounds at its default tile: device ms of the full step, of the step with
no substep (the integrate, the narrowphase and the I/O) and of that with
every candidate dead (the integrate and the I/O). Then through
``fused_launch_tiled`` over its launch bounds (threads a block, blocks
an SM), tile widths and the two hull-hull paths; each setting's step and
contact tables must equal the default launch's. A tile whose shared
memory does not fit is reported as such. ``--split`` stops after the
default launch's split (it needs only ``fused_launch``, so it also times
an older source).

Needs CUDA and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
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
from madrona_tpu_torch.models import escape_room as er       # noqa: E402
from madrona_tpu_torch.models import hide_seek as hs_mod     # noqa: E402
from madrona_tpu_torch.ops import (                          # noqa: E402
    broadphase_cuda, contacts_cuda, cuda_build, fused_cuda,
    hh_narrowphase_cuda, solver_cuda,
)
from madrona_tpu_torch.physics import api as papi            # noqa: E402

TILES = (0, 16, 32, 64, 128)   # 0: the kernel's one-wave tile
FUSED_TILES = (0, 4, 8, 16, 24)  # 0: the kernel's pick within one pass
WARP_ALWAYS = 1 << 30            # a warp-lane limit no tile reaches


def tiled_entry(source, symbol, argtypes):
    fn = cuda_build.entry(source, symbol, argtypes)
    for line in cuda_build.BUILD_LOG.get(source, "").splitlines():
        if "registers" in line or "spill" in line or "Function" in line:
            print(f"  {source}: {line.strip()}")
    return fn


def escape_room_probe():
    """chip_smoke.py's Escape Room probe: 4096 worlds, 3 steps in."""
    w = cs.W
    acts = EscapeRoom.random_actions(np.random.RandomState(0), 3, w).to(cs.DEV)
    probe = make_sim(EscapeRoom(), num_worlds=w, seed=1, device=cs.DEV)
    for i in range(3):
        probe.step({"action": acts[i],
                    "reset": torch.zeros((w,), dtype=torch.int32,
                                         device=cs.DEV)})
    return probe


def hide_seek_probe():
    """chip_smoke.py's Hide & Seek state-only probe: 16,384 worlds."""
    hs = make_sim(HideSeek(pixels=False), num_worlds=cs.HS_STATE_W, seed=1,
                  device=cs.DEV)
    hs.step({})
    return hs


def scenes():
    """{name: (contacts inputs, ObjectManager, edge_dirs)}."""
    probe = escape_room_probe()
    env = probe.env
    om = env.om.to(cs.DEV)
    body = papi.body_state(probe.executor.sm, probe.state)
    out = {"escape_room": (cs.contacts_inputs(body, om, env.caps, env.cfg),
                           om, True)}
    hs = hide_seek_probe()
    hom = hs.env.om.to(cs.DEV)
    hbody = papi.body_state(hs.executor.sm, cs.arrange_hide_seek(hs))
    out["hide_seek"] = (cs.contacts_inputs(hbody, hom, hs.env.caps,
                                           hs.env.cfg), hom, True)
    om_cr, body_cr, caps_cr = cs.crowded_scene()
    cr = cs.contacts_inputs(body_cr, om_cr, caps_cr, env.cfg)
    out["crowded edge_dirs"] = (cr, om_cr, True)
    out["crowded edge_pairs"] = (cr, om_cr, False)
    return out


def fused_scenes():
    """{name: (PhysicsConfig, fused-step arguments, joint arguments)}:
    chip_smoke.py's phase 7 and 11 scenes."""
    out = {}
    probe = escape_room_probe()
    env = probe.env
    om = env.om.to(cs.DEV)
    state = cs.with_grab_joints(probe)
    body = papi.body_state(probe.executor.sm, state)
    cands = broadphase_cuda.find_candidates_kernel(body, om, env.caps,
                                                   env.cfg.dt)
    out["escape_room + joints"] = (
        dataclasses.replace(env.cfg, **cs.FUSED),
        cs.fused_args(body, om, cands),
        solver_cuda.pack_joints(papi.joints_view(state), er.N_BODIES))
    hs = hide_seek_probe()
    hom = hs.env.om.to(cs.DEV)
    hstate = cs.arrange_hide_seek(hs)
    hbody = papi.body_state(hs.executor.sm, hstate)
    hcands = broadphase_cuda.find_candidates_kernel(hbody, hom, hs.env.caps,
                                                    hs.env.cfg.dt)
    out["hide_seek + joint"] = (
        dataclasses.replace(hs.env.cfg, **cs.FUSED),
        cs.fused_args(hbody, hom, hcands),
        solver_cuda.pack_joints(papi.joints_view(hstate), hs_mod.N_BODIES))
    om_sp, body_sp, caps_sp = cs.sphere_scene()
    cands_sp = broadphase_cuda.find_candidates_kernel(body_sp, om_sp,
                                                      caps_sp, env.cfg.dt)
    for tier in ("edge_dirs", "edge_pairs"):
        out[f"spheres {tier}"] = (
            dataclasses.replace(env.cfg, **cs.FUSED, sat_tier=tier),
            cs.fused_args(body_sp, om_sp, cands_sp), ())
    return out


def dead_candidates(args):
    """The fused-step arguments with every candidate row the sentinel."""
    n = args[0].shape[1]
    return (*args[:4], *(torch.full_like(c, n) for c in args[4:7]),
            *args[7:])


def fused_split(cfg, args, jargs, tiled=None):
    """Device ms of the fused step (the default launch, or ``tiled``'s):
    (full step, no substep, no substep and no live candidate)."""
    def time(a, **kw):
        return cs.timed_device(lambda: fused_cuda._launch(
            cfg, *a, *jargs, tiled=tiled, **kw))

    return (time(args), time(args, substeps=0),
            time(dead_candidates(args), substeps=0))


def sweep_fused(card, split_only=False):
    scenes = fused_scenes()
    fn = None if split_only else tiled_entry(
        "fused_step.cu", "fused_launch_tiled", fused_cuda.TILED_ARGTYPES)
    for name, (cfg, args, jargs) in scenes.items():
        n, w = args[0].shape[1:]
        c = sum(a.shape[1] for a in args[4:7])
        for bounds in ((0, 0),) + (() if split_only else fused_cuda.VARIANTS):
            tiled = None if bounds == (0, 0) else (fn, 0, -1, *bounds)
            full, no_sub, io = fused_split(cfg, args, jargs, tiled)
            print(f"fused {name}: W={w} N={n} C={c}; "
                  f"{'default launch' if tiled is None else bounds}, device "
                  f"ms: step {full:.4f}, no substep {no_sub:.4f}, no substep "
                  f"and no live candidate {io:.4f} -> I/O + integrate "
                  f"{io:.4f}, narrowphase {no_sub - io:.4f}, substeps "
                  f"{full - no_sub:.4f} ({card})")
    if split_only:
        return
    for name, (cfg, args, jargs) in scenes.items():
        ref = fused_cuda._launch(cfg, *args, *jargs, lanes=True)
        tiling = fused_cuda.tiling(args[0], *args[4:7], args[8],
                                   jargs[0].shape[0] if jargs else 0)
        print(f"{name}: default launch (tile, warp-lane limit, threads, "
              f"blocks an SM) = {tiling}")
        for threads, blocks in fused_cuda.VARIANTS:
            for tile in FUSED_TILES:
                row = []
                for lanes_max in (0, WARP_ALWAYS):
                    setting = (fn, tile, lanes_max, threads, blocks)
                    try:
                        got = fused_cuda._launch(cfg, *args, *jargs,
                                                 lanes=True, tiled=setting)
                    except RuntimeError:
                        row.append("no room")
                        break
                    if not (torch.equal(got[0], ref[0]) and all(
                            torch.equal(a, b) for a, b in zip(got[1],
                                                              ref[1]))):
                        raise AssertionError(f"fused {name}: {setting[1:]} "
                                             "differs")
                    ms = cs.timed_device(lambda: fused_cuda._launch(
                        cfg, *args, *jargs, tiled=setting))
                    row.append(f"{'thread' if lanes_max == 0 else 'warp'}: "
                               f"{ms:.4f}")
                print(f"  {name} ({threads}, {blocks}) tile "
                      f"{tile or 'default'}: device ms, a hull-hull lane by "
                      + ", ".join(row))


def sweep_hh_record(card):
    fn = tiled_entry("hh_narrowphase.cu", "hh_record_launch_tiled",
                     hh_narrowphase_cuda.TILED_ARGTYPES)
    probe = escape_room_probe()
    env = probe.env
    om = env.om.to(cs.DEV)
    body = papi.body_state(probe.executor.sm, probe.state)
    er_in = cs.contacts_inputs(body, om, env.caps, env.cfg)
    om_cr, body_cr, caps_cr = cs.crowded_scene()
    cr_in = cs.contacts_inputs(body_cr, om_cr, caps_cr, env.cfg)
    for name, (hh, _, poses, obj), om_ in (("escape_room", er_in, om),
                                          ("crowded", cr_in, om_cr)):
        hh = hh.contiguous()
        for tier, dirs in (("edge_dirs", True), ("edge_pairs", False)):
            ref = hh_narrowphase_cuda._launch(hh, poses, obj, om_, dirs)
            tiling = hh_narrowphase_cuda.tiling(poses.shape[2], hh.shape[1],
                                                om_)
            default_ms = cs.timed_device(lambda: hh_narrowphase_cuda.hh_record(
                hh, poses, obj, om_, dirs))
            print(f"{name} {tier}: W={poses.shape[2]} live candidates "
                  f"{int(((hh >= 0) & (hh < poses.shape[0])).all(-1).sum())}"
                  f"; default launch (tile, warp-lane limit) {tiling} "
                  f"{default_ms:.4f} ms ({card})")
            for tile in TILES:
                row = []
                for lanes_max in (0, WARP_ALWAYS):
                    setting = (fn, tile, lanes_max)
                    got = hh_narrowphase_cuda._launch(hh, poses, obj, om_,
                                                      dirs, tiled=setting)
                    if not torch.equal(got, ref):
                        raise AssertionError(f"hh record {name} {tier}: "
                                             f"{setting[1:]} differs")
                    ms = cs.timed_device(lambda: hh_narrowphase_cuda._launch(
                        hh, poses, obj, om_, dirs, tiled=setting))
                    row.append(f"{'thread' if lanes_max == 0 else 'warp'}: "
                               f"{ms:.4f}")
                print(f"  {name} {tier} tile {tile or 'one wave'}: device "
                      "ms, a lane by " + ", ".join(row))


def sweep_contacts(card):
    fn = tiled_entry("contacts.cu", "contacts_launch_tiled",
                     contacts_cuda.TILED_ARGTYPES)
    for name, (args, om, dirs) in scenes().items():
        args = tuple(a.contiguous() for a in args)
        ref = contacts_cuda._launch(*args, om, dirs)
        hh_live = int(((args[0][..., 0] < args[2].shape[0])
                       & (args[0][..., 1] < args[2].shape[0])).sum())
        default_ms = cs.timed_device(lambda: contacts_cuda.contacts(
            *args, om, dirs))
        print(f"{name}: W={args[2].shape[2]} hull-hull candidates {hh_live}; "
              f"default launch {default_ms:.4f} ms ({card})")
        for tile in TILES:
            row = []
            # 0: a thread a hull-hull lane, else a warp a lane
            for lanes_max in (0, WARP_ALWAYS):
                setting = (fn, tile, lanes_max)
                got = contacts_cuda._launch(*args, om, dirs, tiled=setting)
                if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                    raise AssertionError(f"{name}: tile {tile}, threshold "
                                         f"{lanes_max} differs")
                ms = cs.timed_device(lambda: contacts_cuda._launch(
                    *args, om, dirs, tiled=setting))
                row.append(f"{'thread' if lanes_max == 0 else 'warp'}: "
                           f"{ms:.4f}")
            print(f"  {name} tile {tile or 'one wave'}: device ms, a lane "
                  "by " + ", ".join(row))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("contacts", "hh_record", "fused"),
                    default="contacts")
    ap.add_argument("--split", action="store_true",
                    help="--kernel fused: the phase split of the default "
                    "launch alone (it needs only fused_launch)")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_contacts_tiles: CUDA is not available", file=sys.stderr)
        return 2
    card = cs.card_line()
    print(card)
    if opts.kernel == "fused":
        sweep_fused(card, opts.split)
    else:
        {"contacts": sweep_contacts,
         "hh_record": sweep_hh_record}[opts.kernel](card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
