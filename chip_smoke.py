#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (madrona_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. the card (nvidia-smi name and power limit) and the kernel build
     (one nvcc per csrc/*.cu source, all seven started together);
  2. the broadphase kernel against its plain PyTorch version at 4096
     worlds, on random scenes (caps-saturating ones included, and one of
     64 bodies, MAX_BODIES) and on a real Escape Room body state: every
     field exactly equal;
  3. the lidar kernel against its plain version at the Escape Room shape
     (4096 worlds, 20 boxes, 2 agents x 30 rays), on a random scene and
     on the Escape Room probe state: equal (max abs diff 0.0); the tile
     its launch takes (worlds a block, from the occupancy API); its
     in-range division path against IEEE division on 2^24 operand sets
     over the kernel's range (scripts/torch_lidar_division.py): equal
     bit for bit;
  4. the contacts kernel against its plain version at 4096 worlds, on a
     real Escape Room state and on a crowded scene of rotated, scaled
     boxes on a plane (caps 8/8/0, live hull-hull face and edge
     contacts), in both SAT tiers: ref, alt, num equal; normal, average
     point, penetration within 1e-4 on ok lanes; manifold points within
     1e-3, unordered;
  5. the substep-solver kernel against its plain version at 4096 worlds,
     on the Escape Room state with grab joints on in part of the worlds
     and on the crowded scene's contacts: all 33 output fields within
     pose 1e-3, velocity 5e-2, angular velocity 2e-1; static rows
     bit-equal to their inputs;
  6. the hull-hull record kernel (B6, and B7 in the edge_pairs tier)
     against its plain version at 4096 worlds, in both SAT tiers, on the
     Escape Room state and the crowded scene: ref, alt, num equal;
     normal within 1e-4 on live lanes; points within 1e-3, unordered;
  7. the fused-step kernel (B8) against its plain version with phase 5's
     tolerances, static rows bit-equal to their inputs: on the Escape
     Room state with joints at 4096 worlds and on a scene of a plane, two
     box sizes and spheres with hull-hull, hull-plane and sphere lanes
     live at 4096 worlds (the Hide & Seek scene follows in phase 11).
     Phases 6, 7 and 11 print, for each scene, how many of the record
     or fused kernel's tiles gave their hull-hull lanes a warp each and
     how many a thread each (from the kernel's default tiling and the
     live candidates); after phase 11 each of the two kernels must have
     taken both paths;
  8. the main path: make_sim(EscapeRoom(), 4096 worlds, seed 0) on the
     card, stepped with seeded random actions; every export finite, each
     of the four kernels launched once per step, a fresh sim with the
     same seed bit-identical; env-steps/s; ms per taskgraph node;
  9. the same env at 8 worlds on the card against the port's CPU path;
     and, with the kernels' libraries and the compiler taken away, a step
     on the card raises (no fallback to the plain versions);
 10. the raycast kernel against its plain version: on a real Hide & Seek
     state at 1024 worlds x 4 views x 64 x 64 rays (flat colours, as the
     dense render tier runs it) and on synthetic planes with the shadow,
     light and material options at 256 views: all eight planes within
     RAY_TOL (expected: equal);
 11. the broadphase, contacts, solver and fused-step kernels against
     their plain versions on an arranged Hide & Seek state at 16,384
     worlds (ramp wedges in contact, 4 joint slots, a locked box in half
     the worlds), with phase 2, 4 and 5's tolerances;
 12. Hide & Seek's two launches: make_sim(HideSeek(render_size=64), 1024
     worlds) through ("step", "render"), and make_sim(HideSeek(pixels=
     False), 16,384 worlds) through ("step",), 20 steps of seeded random
     actions each: exports finite and of the expected shapes, broadphase,
     contacts, solver (and raycast) launched once per step each and the
     lidar not at all, a fresh sim bit-identical, ms per node, env-steps/s;
 13. Hide & Seek at 8 worlds on the card against the port's CPU path: int
     exports equal, float exports within SMALL_TOL, pixels differing by
     more than PIX_TOL at under PIX_FRAC of the pixels; and, with the
     raycast library and the compiler taken away, a render step raises;
 13a. the raycast kernel against its plain version on a real state of
     Hide & Seek's BLAS render tier (HideSeek(render_size=64,
     render_tier="blas"), 1024 worlds x 4 views x 64 x 64 rays, 3 steps
     in): the material, light and shadow options on (one shadow-casting
     sun, the checker-textured floor), all eight planes within RAY_TOL;
 13b. the BLAS tier at full width: make_sim(HideSeek(render_size=64,
     render_tier="blas"), 1024 worlds) through ("step", "render"), 20
     steps of seeded random actions: exports finite and of the expected
     shapes, broadphase, contacts, solver and raycast launched once per
     step each and the lidar not at all, a fresh sim bit-identical, ms
     per node, env-steps/s; then the same with tlas_max_instances=8,
     tlas_overlap exported (int32, in [0, 14]);
 13c. the BLAS tier at 8 worlds on the card against the port's CPU path
     as phase 13 does; and, with the raycast library and the compiler
     taken away, a BLAS-tier render step raises;
 14. the physics tiers of this slice at full width, 20 steps of seeded
     random actions each, every kernel's launches counted (the record
     kernel's also by SAT tier, so that B6 and B7 are told apart by
     what ran, not by the config): Escape Room
     with megakernel_fused (B1, B8, B4 once per step; no B2, B3), Hide &
     Seek state only with it (B1, B8), Escape Room with narrowphase=
     "kernel_sublane" (B1, B6, B3, B4) and "kernel" (B1, B7, B3, B4);
     exports finite, a fresh sim bit-identical, ms per node,
     env-steps/s; then the split and the fused Escape Room step timed in
     turns (split, fused, fused, split);
 15. the fused Escape Room at 8 worlds on the card against the port's CPU
     path; and, with the fused library and the compiler taken away, a
     fused step raises;
 16. per-kernel times (CUDA events) beside their bounds, as one JSON line
     of all eight kernels; B1, B2, B3 and B8 also at Hide & Seek's
     shape with their bounds there; B5's bound counts the live rows, and
     its bound over every row is printed beside it. Each kernel has two
     times: "wrapper ms" (timed: events around the calls as the host
     enqueues them, the host's pace where its work per call outlasts the
     kernel) and "device ms" (timed_device: the calls enqueued behind a
     sleep kernel, so the card runs them back to back; it raises if the
     host fell behind). The contacts kernel is also timed on its
     hull-hull and its hull-plane candidates alone, and on the crowded
     scene in both SAT tiers. After the build, each
     kernel's registers, stack frame and local memory (cuobjdump); the
     JSON line carries the registers and stack of the kernel each
     wrapper launches. Every bound, its byte and operation counts and
     the card's peaks come from madrona_tpu_torch/utils/roofline.py. The
     lidar's bound is what the function needs (the row's bound_ms);
     beside it the same-work yardstick of the source csrc/lidar.cu
     replaced (lidar_same_work_cost, 120 operations every (ray, box); the
     row's same_work_bound_ms; that source is timed by
     scripts/torch_lidar_compare.py). The raycast kernel has a second
     row, "raycast_blas": phase 13a's BLAS-tier planes, its launches from
     phase 13b, its bound counting the shadow test and the atlas sample
     on the live rows;
 17. rollout (models/base.py) of Escape Room at 4096 worlds for 400 steps
     of bench.py's actions (RandomState(0)), through the resets at steps
     200 and 400: broadphase, contacts, solver and lidar launched once a
     step each; no candidate list over its cap at any step (the long
     rollout assertion of tests/test_escape_room.py); done 1 at steps 200
     and 400 for every world and nowhere else; exports and the final
     body state finite; a fresh sim's rollout bit-identical; env-steps/s;
 18. the many-body tier at bench.py's pile point: make_sim(Pile(), 64
     worlds) (256 bodies a world, the swept broadphase, the narrowphase
     at every substep, plain PyTorch: no hand-written kernel runs on this
     path) for 60 steps of Pile.random_actions(RandomState(0)): exports
     finite at every step and of the expected shapes, none of the seven
     kernels launched, a fresh sim bit-identical over 20 steps, ms/step
     and env-steps/s; summary[:, 5] (the broadphase overflow flag) never
     falls, and the worlds where the shakes set it are printed (the JAX
     package sets it from step 33 on the same inputs); then 60 steps
     without shakes, where the flag must stay 0 in every world (as it
     does in the JAX package); then 12 steps at 1024 worlds;
 19. the swept broadphase against the broadphase kernel (B1) on real
     Pile(num_bodies=48) states (53 rows, inside B1's 64) at 64 worlds,
     at steps 12 and 24: per world the same candidate pairs, as sets, in
     every world where neither overflows;
 20. 8 worlds of phase 18's run (those where the flag rises first among
     them) carried to the CPU after steps 1, 16 and 32, and one step taken
     on the card and on the CPU: done and summary's episode step and
     overflow flag equal, the body state within the golden bounds
     (pos/rot 1e-3, vel 5e-2, omega 2e-1); a check outside a bound passes
     only with a witness (the CPU, stepped from the state with every
     position scaled by 1 + 1e-7 or 1 - 1e-7, outside the same bound at
     the same (world, body)), at most twice;
 21. Cartpole at bench.py's point, 16,384 worlds x 500 steps of bench.py's
     actions (RandomState(0), two buckets), through rollout: env-steps/s,
     no kernel launched, a fresh sim bit-identical over 50 steps; over the
     oracle's 50 steps the done schedule equal to the port's CPU run and
     obs within CART_OBS_TOL; a world whose done flips (cosf on the card
     is not torch.cos on the CPU) is reported, and passes only where one
     side's state lay within CART_OBS_TOL of a termination limit;
 22. Projectiles(capacity=8) at 4096 worlds for 40 steps (spawns through
     make_entities, despawns through destroy_entities, the sort by
     height), with one Executor.maybe_grow after step 20, on the card and
     on the CPU in lockstep: every integer output (live counts, the spawn
     and destroy totals, the tables' ids, generations, row counts and
     overflow, the entity store) equal at every step, live positions
     within 1e-5, the growth the same.
 23. Hanabi (no kernel on its path, every counter 0): 2 players with
     compact observations at 16,384 worlds x 200 steps, then 5 players
     with card knowledge at 4096 worlds x 100 steps, through rollout in
     chunks of 50 steps of random_actions(RandomState(0)): at every step
     and in every world the info and life tokens in range (their
     one-hots in the observation hold one 1 each), at least one legal
     move, the score in [0, 25]; a fresh sim bit-identical; the first 8
     worlds equal to the port's CPU run of 8 worlds bit for bit (the
     worlds' Threefry streams depend on the seed and the world alone);
     env-steps/s and kernel launches a step (torch.profiler);
 24. Overcooked, both layouts, at 4096 worlds x 450 steps the same way:
     the episode clock (steps_taken, done at step 400 only), one own
     and one other agent in every observation, rewards a multiple of
     20; a fresh sim bit-identical through the reset (450 steps); the
     first 8 worlds equal to the CPU's over all 450; env-steps/s and
     launches a step;
 25. TrainInterface and REINFORCE on Cartpole
     (examples/torch_train_reinforce.py) at 4096 worlds, 5 updates of 64
     steps: every exported tensor on the card, a CPU tensor refused by
     torch_step, the losses finite, the policy's parameters moved, no
     kernel launched; updates/s;
 26. PPO on Overcooked (examples/torch_train_ppo_overcooked.py) at 4096
     worlds, 3 updates of horizon 64: the losses and parameters finite,
     the parameters moved, no kernel launched; updates/s.
 27. the CollisionEvents export (events_scene: eight boxes, pressed in
     pairs, dropped onto a plane; 16 event slots) at 4096 worlds for 60
     steps on broadphase="pallas" (B1), narrowphase="kernel_sublane"
     (B6) and megakernel=True (B3), each launched once a step and no
     other kernel; the singleton's invariants at every step (counts,
     the clamp flag, live slots naming two live rows with their entity
     handles, the rest -1); the export alone makes no host sync (torch's
     sync debug mode raises on one); ms, device events and device busy
     share a step, and the export's share of the step; 8 worlds carried
     to the CPU after steps 20 and 40, one step on both: every integer of the
     singleton equal, except in a world where a contact lane is live on
     one side only with a depth within 1e-5 of zero there (a witness),
     and the body state within the golden bounds (phase 20's rule);
 28. Escape Room at solver="tgs" with narrowphase="kernel_sublane",
     4096 worlds x 60 steps of random actions: B1 and B4 once a step,
     B6 at each of the 4 substeps, no other kernel; exports finite and
     both agents on the floor (0.4 < z < 1.2) at every step; ms, device
     events and busy share a step; 8 worlds after step 50 carried to
     the CPU, one step within the golden bounds (phase 20's rule);
 29. the box stack with a sphere and joints (stack_scene, the
     Gauss-Seidel and TGS tests' scene) at solver="gauss_seidel", 1024
     worlds x 30 steps: B1 once a step, no other kernel; positions
     finite; ms, device events and busy share a step; 8 worlds after
     steps 10, 16, 20 and 29 carried to the CPU, one step within the
     golden bounds (phase 20's rule), the largest differences in
     position, rotation, velocity and omega printed for each;
 30. physics/query.py and physics/gjk.py on the main path's Escape Room
     state (4096 worlds): raycast_bodies for 2 agents x 30 rays (each
     agent's own row excluded), card against CPU over every world (hit
     rows equal, t within 1e-5 relative), and hull_hull_distance2 for
     every pair of hull rows (190 a world) on the card, held against the
     CPU on the first 256 worlds (within 1e-5 relative); ms a call.
 31. the asset importers: an OBJ with its MTL and a 24 x 20 RGBA PNG
     texture (alpha below 255), a .gltf quad with a data-URI PNG, a .glb
     cube with its PNG in the binary chunk and a .usda pillar under two
     Xforms, written by this script's own writers (png_bytes through
     zlib, write_assets) and imported by madrona_tpu_torch.assets;
     bake_assets_blas (textures resampled to 64^2 without PIL); the
     scene rendered by render_views_blas at 1024 worlds x 4 views of 64 x
     64 with a shadow-casting sun: the raycast kernel launched once and
     no other, its planes equal to its plain version; the gather,
     one-hot and 4-wide (float32 and bfloat16 boxes) walkers on 2^16
     rays of the imported objects: the one-hot walker equal to the
     gather walker, the wide walkers' hits equal (t within 1e-4
     relative, the triangle equal but at ties); on the plain BLAS tier
     (the kernel tier off), ray_chunk 256 and the one-hot walker give the
     default's planes bit for bit and launch no kernel; B5's device,
     wrapper and plain ms on the imported scene beside its render floor
     on the scene's live rows (utils/roofline.render_floor_s) and its
     bound on the run's data;
 31b. the image decoders without PIL (assets/jpeg.py, assets/png.py):
     every file of tests/goldens/torch_images.npz (PIL's JPEGs of each
     variant, 4:4:0 and mixed factors, CMYK and YCCK, a 16-bit Adam7
     PNG) decoded on the host equal to PIL's RGBA byte for byte, the
     1024 x 1024 4:2:0 JPEG by the SHA-256 of PIL's RGBA, its decode ms;
     a .glb cube with a 4:2:0 JPEG, a .gltf quad with a progressive JPEG
     data URI and an OBJ + MTL with the 16-bit interlaced PNG imported
     (textures equal to the goldens), bake_assets_blas, and the scene
     rendered by render_views_blas at 1024 worlds x 4 views of 64 x 64
     with a shadow-casting sun: the raycast kernel launched once and no
     other, its planes equal to its plain version; B5's device ms;
 31c. the BMP, TGA, GIF and WebP decoders without PIL (assets/bmp.py,
     tga.py, gif.py, webp.py): every fmt_* file of
     tests/goldens/torch_images.npz decoded on the host equal to PIL's
     RGBA byte for byte, the 1024 x 1024 lossy WebP with alpha and GIF by
     the SHA-256 of PIL's RGBA, their decode ms; an OBJ + MTL with an RLE
     TGA (bottom-left origin), an OBJ + MTL with an RLE8 BMP, a .gltf quad
     with a GIF data URI (a transparency index), a .glb cube with a lossy
     WebP with ALPH in its binary chunk and an OBJ + MTL with a lossless
     WebP imported (textures equal to the goldens), bake_assets_blas, and
     the scene rendered by render_views_blas at 1024 worlds x 4 views of
     64 x 64 with a shadow-casting sun: the raycast kernel launched once
     and no other, its planes equal to its plain version; B5's device,
     wrapper and plain ms and its bound on the run's data;
 31d. the DDS, PBM/PGM/PPM/PFM, QOI and ICO/CUR decoders without PIL
     (assets/dds.py over native/bcn_decode.cpp, ppm.py, qoi.py over
     native/qoi_decode.cpp, ico.py): every fmt2_* file of
     tests/goldens/torch_images.npz decoded on the host equal to PIL's
     RGBA byte for byte; a 1024 x 1024 BC7 and a 1024 x 1024 BC1 DDS of
     random blocks built here (big_dds_files, np.random.default_rng(19)),
     each held to the SHA-256 of its bytes and of PIL's RGBA, their decode
     ms; an OBJ + MTL with a BC1 DDS with punch-through alpha, a .glb cube
     with a BC7 DDS with a mip chain in its binary chunk, a .gltf quad
     with a QOI data URI, an OBJ + MTL with a 30 x 18 BC3 DDS (partial
     blocks) and an OBJ + MTL with a binary P6 PPM at maxval 1023
     imported (textures equal to the goldens), bake_assets_blas, and the
     scene rendered by render_views_blas at 1024 worlds x 4 views of 64 x
     64 with a shadow-casting sun: the raycast kernel launched once and
     no other, its planes equal to its plain version; B5's device,
     wrapper and plain ms and its bound on the run's data;
 31e. the TIFF decoder without PIL (assets/tiff.py over
     native/tiff_decode.cpp): every fmt3_* file of
     tests/goldens/torch_images.npz decoded on the host equal to PIL's
     RGBA byte for byte; a 1024 x 1024 RGBA LZW TIFF with the horizontal
     predictor in strips and a 1024 x 1024 16-bit RGB Deflate TIFF in
     256^2 tiles under planar configuration 2 built here
     (big_tiff_files, np.random.default_rng(20)), each held to the
     SHA-256 of its bytes and of PIL's RGBA, their decode ms; an OBJ +
     MTL with an LZW RGBA TIFF with predictor 2, a .glb cube with a tiled
     Deflate TIFF in its binary chunk, a .gltf quad with a PackBits 4-bit
     palette TIFF data URI, an OBJ + MTL with a 16-bit associated-alpha
     TIFF under planar configuration 2 and an OBJ + MTL with a MinIsWhite
     grey TIFF at Orientation 6 imported (textures equal to the goldens),
     bake_assets_blas, and the scene rendered by render_views_blas at
     1024 worlds x 4 views of 64 x 64 with a shadow-casting sun: the
     raycast kernel launched once and no other, its planes equal to its
     plain version; B5's device, wrapper and plain ms and its bound on
     the run's data;
 32. examples/torch_train_ppo_pixels.py at its defaults (256 worlds, 16 x
     16 RGBD, horizon 16, two epochs): 5 updates on the dense tier
     (tlas_max_instances=8) and 2 on the BLAS tier; B1, B2, B3 and B5
     launched once an environment step each (16 an update and the first
     zero-action step), no other kernel; the parameters finite and
     moved; updates/s, env-steps/s with the render and the learner, and
     the device's busy share of a dense-tier update (torch.profiler, the
     device alone);
 33. checkpoints (madrona_tpu_torch.utils.checkpoint): the Escape Room
     state at 4096 worlds saved into a snapshot and restored in half the
     worlds (every tensor as expected, the step counter live), its npz
     round trip bit for bit; PPO on Cartpole (1024 worlds) saved after 2
     updates (the state's npz, the parameters and the action generator's
     state) and resumed in a fresh make_train for 2 more, bit-identical
     to 4 straight updates; no kernel launched by the learner.
     The JSON line's rows carry "launches_by_path": each kernel's
     launches on the paths of phases 27-29, 31, 31b, 31c, 31d, 31e and
     32,
     B6's and B7's from the record kernel's tier counts.
 34. tracing and debug checks (utils/tracing.py, utils/debug.py) on
     Escape Room at 4096 worlds: 5 steps under profile_trace, each
     node's device ms ("step.<node>" spans), B1-B3 launched under
     step.physics_step and B4 under step.er_post (the launch counters
     read around each node; the profiler's own links printed beside);
     the node annotation's cost a step (a node_scope timed alone, and
     steps in turns with and without it): under 1 %; 20 steps under
     debug.checked bit-identical to the plain steps; a NaN put into one
     body's velocity raises naming step.physics_step;
 35. the roofline: phase 16's (bytes, operations) of every row, counted
     by utils/roofline.py, equal to INLINED_COUNTS (what the script's
     own counts gave on the same seeded scenes) and their bounds;
     bench_roofline of Escape Room (4096 worlds) and Hide & Seek's
     pixels (1024 worlds) at phases 8 and 12's env-steps/s; the render
     floor's live rows (utils/roofline.render_live_rows, from the mesh
     and the view masks) give B5's bound on phase 8's planes exactly;
 36. the navmesh (utils/navmesh.py): a 64 x 64 quad grid (8192
     triangles) at 16,384 worlds: sample_point, locate, shortest_dists,
     next_hop walked until every world is at its goal; 8 worlds again on
     the CPU (triangles and every hop equal, points within 2e-6); ms a
     batched query;
 37. worlds sharded (parallel/mesh.py): Escape Room's 4096 worlds as 2 x
     2048 and 4 x 1024 shards stepped in turn, 20 steps: the joined
     exports (every step) and state equal the unsharded sim's bit for
     bit, B1-B4 launched once a step in each shard; then
     examples/torch_train_ppo_distributed.py at 1024 worlds for 25
     updates, one rank a card over NCCL (this process on one card,
     torchrun on more), the parameters bit-identical across ranks, no
     kernel launched; updates/s and the episode length;
 38. the viewer (viz/, examples/torch_viewer_demo.py) on Escape Room at
     4096 worlds: ticks through B1-B4 (once a tick each); a 320 x 240
     flycam frame of world 0 on the card against the CPU's from the same
     state (depth within 1e-4, rgb off by more than 0.02 at under 0.2 %
     of pixels); the top-down PNG decoded by assets/png.decode_png; the
     Recorder over 20 steps saved and loaded equal; PlaybackViewer's
     /meta, /frame.png and /topdown.png over 127.0.0.1.
 39. Executor.build_launch_graph: Hide & Seek with pixels at 1024 worlds,
     run(build_launch_graph(["step", "render"])) for 5 steps against
     sim.step() of a fresh sim from the same seed and actions: every
     export and the state equal bit for bit, B1, B2, B3 and B5 once a
     step and no other kernel; Escape Room at 4096 worlds:
     get_exported(slot) equal to run's export of every slot;
 40. scripts/torch_weak_scaling.py --env escape_room at 4096 worlds a
     rank, 30 steps, as one rank over NCCL: its JSON printed, the rate
     finite and positive, B1-B4 once a step; one card gives no
     efficiency;
 41. scripts/torch_step_profile.py --phases on Escape Room at 4096
     worlds: the step, each physics phase alone on the plain route
     (broadphase, narrowphase, integrate, the position and velocity
     solves) and B1-B3 alone, printed.

Any failure raises (non-zero exit). The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Needs CUDA and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

# the card's peaks, the per-kernel work counts and their bound, and the
# profiler's device share: one home for each, in the package
from madrona_tpu_torch.utils.roofline import (
    bound, broadphase_cost, contacts_cost, fused_cost, hh_record_cost,
    lidar_cost, lidar_same_work_cost, lidar_visible, nbytes, ray_counts,
    raycast_cost, raycast_every_row_cost, solver_cost,
)
from madrona_tpu_torch.utils.tracing import device_profile
from madrona_tpu_torch.utils.tree import tree_leaves

HERE = os.path.dirname(os.path.abspath(__file__))

DEV = "cuda"
W = 4096                  # the Escape Room world count of the repo's bench
STEPS = 20
SMALL_W = 8
SMALL_STEPS = 3
SMALL_TOL = 1e-3          # card vs CPU, float exports after 3 steps
LIDAR_TOL = 0.0           # kernel vs plain version: equal
LIDAR_DIVISIONS = 1 << 24  # operand sets of the lidar's division check
# contacts and solver kernels vs their plain versions: the JAX package's
# golden bounds (tests/golden_inputs.py:484-492)
CON_TOL = 1e-4            # normal, average point, largest penetration
PTS_TOL = 1e-3            # manifold points, compared unordered
POSE_TOL, VEL_TOL, OMEGA_TOL = 1e-3, 5e-2, 2e-1
HS_W = 1024               # Hide & Seek with pixels (render_size 64)
HS_STATE_W = 16384        # Hide & Seek state only: the repo's bench count
HS_RENDER = 64
RAY_TOL = 1e-5            # raycast kernel vs plain version, every plane
RAY_SYN_WV = 256          # views of the synthetic option-set planes
PIX_TOL, PIX_FRAC = 0.02, 0.002   # card vs CPU: rgb / depth per pixel
ROLLOUT_STEPS = 400       # bench.py's steps: two episodes of 200
TIMING_ITERS = 200
DEVICE_ITERS = 100        # calls a device-only timing enqueues behind a sleep
PLAIN_PHYSICS_ITERS = 3   # the plain contacts/solver take ~0.1 s a call
# the many-body tier and the ECS envs (phases 18-22)
PILE_W = 64               # bench.py's pile point: 256 bodies, 64 worlds
PILE_BIG_W = 1024
PILE_STEPS = 60
PILE_SAME_STEPS = 20      # steps a fresh sim is compared over, bit for bit
PILE_BIG_STEPS = 12
PILE_SMALL_BODIES = 48    # 53 rows: inside the broadphase kernel's 64
PILE_SWEPT_AT = (12, 24)  # steps at which swept and B1 are compared
# the design-point states carried to the CPU: after step 32 the overflow
# flag rises in worlds 4 and 20 (it does so in the JAX package too)
PILE_CHECK_AT = (1, 16, 32)
PILE_CHECK_WORLDS = (0, 1, 2, 3, 4, 5, 20, 30)
PILE_NUDGES = (1 + 1e-7, 1 - 1e-7)
PILE_MAX_WITNESSED = 2
CART_W = 16384            # bench.py's cartpole point
CART_STEPS = 500
CART_ORACLE_STEPS = 50    # tests/test_cartpole.py's horizon
# card vs CPU over those 50 steps: two ulps of cosf/sinf (CUDA's bound) a
# step; one ulp a step moves these 16,384 worlds' obs by up to 5.96e-6
# over the 50 steps (a CPU run with torch.cos/sin nudged by an ulp)
CART_OBS_TOL = 2e-5
PROJ_W = 4096
PROJ_STEPS = 40
PROJ_CAP = 8              # small enough that the spawns overflow it
PROJ_GROW_AT = 20         # the step after which maybe_grow runs, once
PROJ_POS_TOL = 1e-5
HAN_W = 16384             # Hanabi, 2 players, compact observations
HAN_STEPS = 200
HAN5_W = 4096             # Hanabi, 5 players, card knowledge
HAN5_STEPS = 100
OC_W = 4096               # Overcooked, each layout
OC_STEPS = 450            # through the automatic reset (episodes of 400)
OC_FRESH_STEPS = 450      # a fresh sim beside it through the reset
ENV_CHUNK = 50            # steps a rollout call; each chunk checked alone
ENV_CPU_W = 8             # the first worlds, run on the CPU beside the card
PROFILE_STEPS = 5         # steps under torch.profiler for launches a step
LEARN_W = 4096            # the learners' world count
REINFORCE_UPDATES = 5
REINFORCE_HORIZON = 64    # examples/train_torch_reinforce.py's default
PPO_UPDATES = 3
PPO_HORIZON = 64          # examples/train_ppo_overcooked.py's default
EV_W = 4096               # the events export: eight boxes onto a plane
EV_STEPS = 60
EV_MAX_EVENTS = 16
EV_CAPS = (16, 8, 0)      # hull-hull, hull-plane, sphere candidates
EV_PUSH = 5.0             # N pressing each pair of boxes together
EV_CHECK_AT = (20, 40)    # steps after which 8 worlds go to the CPU
EV_DEPTH_MARGIN = 1e-5    # a contact this near zero depth may flip
TGS_W = 4096              # Escape Room at solver="tgs"
TGS_STEPS = 60
TGS_CHECK_AT = (50,)
GS_W = 1024               # the box stack at solver="gauss_seidel"
GS_STEPS = 30
# 16 parted by 0.084 before math3d.sum_in_order; 29 by 0.028 in velocity
# before the physics path divided by device tensors and took math3d.norm
GS_CHECK_AT = (10, 16, 20, 29)
CHECK_WORLDS = (0, 1, 2, 3, 4, 5, 6, 7)
MAX_WITNESSED = 2         # checks of a phase that may need a witness
QUERY_RAYS = 30           # rays an agent for raycast_bodies
QUERY_CPU_W = 256         # worlds of the GJK check run again on the CPU
GJK_TOL = 1e-5            # card vs CPU, squared distance, relative



def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def timed(fn, iters=TIMING_ITERS, warmup=5):
    """Mean ms of fn() over iters launches (CUDA events, after warm-up).
    The events bracket the host's enqueueing too: where a call's host
    work (checks, allocations, the ctypes call) outlasts its kernel, this
    is the host's pace ("wrapper ms")."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@functools.lru_cache(maxsize=None)
def sleep_cycles_per_ms() -> float:
    """Clock cycles that torch.cuda._sleep spins in one ms on this card
    (measured once, over a 20 ms sleep)."""
    import torch

    cycles = 20_000_000
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def timed_device(fn, iters=DEVICE_ITERS, warmup=5):
    """Mean device-only ms of fn() over iters calls ("device ms"): a sleep
    kernel holds the stream while the host enqueues all the calls, so the
    card runs them back to back and the events time the card alone. The
    sleep lasts twice the calls' measured enqueue time plus 2 ms. Raises
    if the start event had completed when the host finished enqueueing
    (the card reached the calls first: a host-paced time)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2.0 * enqueue_ms + 2.0) * sleep_cycles_per_ms()))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    ahead = not start.query()
    torch.cuda.synchronize()
    if not ahead:
        raise AssertionError("timed_device: the card reached the timed "
                             "calls before the host had enqueued them all")
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters=TIMING_ITERS, warmup=5):
    """(wrapper ms, device ms) of fn(): timed, then timed_device with at
    most DEVICE_ITERS calls."""
    return (timed(fn, iters, warmup),
            timed_device(fn, min(iters, DEVICE_ITERS), warmup))


def resource_usage(libs):
    """Print each kernel's registers, stack frame, shared and local memory
    from cuobjdump --dump-resource-usage of its built library, a line per
    kernel (the spill bytes are nvcc's report, printed at the build).
    Returns {source: {kernel symbol: (registers, stack bytes)}}."""
    tool = "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        tool = "cuobjdump"
    usage = {}
    for src, lib in libs.items():
        try:
            out = subprocess.run([tool, "--dump-resource-usage", str(lib)],
                                 capture_output=True, text=True, timeout=120)
        except OSError as e:
            print(f"  resources {src}: {e}")
            usage[src] = {}
            continue
        fn, found = None, {}
        for line in out.stdout.splitlines():
            line = line.strip()
            if line.startswith("Function "):
                fn = line[len("Function "):].rstrip(":")
            elif line.startswith("REG:") and fn:
                print(f"  resources {src} {fn}: {line}")
                fields = dict(f.split(":", 1) for f in line.split()
                              if ":" in f)
                found[fn] = (int(fields["REG"]), int(fields["STACK"]))
        if not found:
            print(f"  resources {src}: cuobjdump rc {out.returncode}: "
                  f"{(out.stdout + out.stderr).strip()[-400:]}")
        usage[src] = found
    return usage


def contacts_split(name, c_in, om, card):
    """Device ms of the contacts kernel on the hull-hull candidates alone
    (no hull-plane slot) and on the hull-plane candidates alone: how its
    time divides between the two lane kinds."""
    from madrona_tpu_torch.ops import contacts_cuda

    hh, hp, poses, obj = c_in
    hh0, hp0 = hh[:, :0].contiguous(), hp[:, :0].contiguous()
    hh_ms = timed_device(lambda: contacts_cuda.contacts(hh, hp0, poses, obj,
                                                        om))
    hp_ms = timed_device(lambda: contacts_cuda.contacts(hh0, hp, poses, obj,
                                                        om))
    print(f"contacts at the {name} shape, device ms: hull-hull lanes alone "
          f"(P={hh.shape[1]}) {hh_ms:.4f}, hull-plane lanes alone "
          f"(P={hp.shape[1]}) {hp_ms:.4f} ({card})")


def random_scene(rs, om, n_obj_hi, n, crowded):
    """A random BodyState [W, n] on the card (the JAX package's
    broadphase test scene, at the main path's world count)."""
    import torch
    from madrona_tpu_torch.physics import xpbd

    def q_rand(shape):
        q = rs.randn(*shape, 4).astype(np.float32)
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    spread = 0.8 if crowded else 2.5
    pos = rs.uniform(-spread, spread, (W, n, 3)).astype(np.float32)
    pos[..., 2] = rs.uniform(0.0, 1.2 if crowded else 3.0, (W, n))
    pos[:, 0] = 0.0
    obj = rs.randint(1, n_obj_hi, (W, n)).astype(np.int32)
    obj[:, 0] = 0                           # row 0: the floor plane
    resp = np.full((W, n), xpbd.RESPONSE_DYNAMIC, np.int32)
    resp[:, :2] = xpbd.RESPONSE_STATIC      # plane + one static box
    active = np.ones((W, n), bool)
    active[:, -2:] = rs.rand(W, 2) < 0.5    # some dead rows
    rot = q_rand((W, n))
    rot[:, 0] = [1, 0, 0, 0]
    scale = rs.uniform(0.5, 1.8, (W, n, 3)).astype(np.float32)
    vel = (1.5 * rs.randn(W, n, 3)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(DEV)      # noqa: E731
    z3 = torch.zeros((W, n, 3), device=DEV)
    z4 = torch.zeros((W, n, 4), device=DEV)
    return xpbd.BodyState(
        pos=t(pos), rot=t(rot), scale=t(scale), vel=t(vel), omega=z3,
        obj_id=t(obj), response=t(resp), ext_force=z3, ext_torque=z3,
        prev_x=z3, prev_q=z4, presolve_x=z3, presolve_q=z4,
        presolve_v=z3, presolve_w=z3, active=t(active),
    )


def check_broadphase(sim):
    """Phase 2. Returns the max abs difference (0: all fields equal)."""
    import torch
    from madrona_tpu_torch.ops import broadphase_cuda as bpc
    from madrona_tpu_torch.physics import api as papi
    from madrona_tpu_torch.physics import bodies as pb
    from madrona_tpu_torch.physics import broadphase as bp
    from madrona_tpu_torch.physics import geo

    reg = pb.ObjectRegistry()
    reg.add_plane()
    reg.add_hull(geo.box_hull((0.5, 0.5, 0.5)), mass=1.0)
    reg.add_hull(geo.box_hull((0.4, 0.8, 0.3)), mass=2.5)
    reg.add_sphere(0.45, mass=0.8)
    om_rand = reg.build().to(DEV)
    env = sim.env
    om_er = env.om.to(DEV)
    body_er = papi.body_state(sim.executor.sm, sim.state)
    cases = [
        ("random", om_rand, random_scene(np.random.RandomState(0), om_rand,
                                         4, 21, False),
         bp.CandidateCaps(hull_hull=48, hull_plane=20, sphere_any=48), False),
        ("crowded", om_rand, random_scene(np.random.RandomState(1), om_rand,
                                          4, 21, True),
         bp.CandidateCaps(hull_hull=48, hull_plane=20, sphere_any=48), False),
        ("saturating", om_rand, random_scene(np.random.RandomState(3),
                                             om_rand, 4, 21, True),
         bp.CandidateCaps(hull_hull=2, hull_plane=1, sphere_any=1), True),
        ("bodies_64", om_rand, random_scene(np.random.RandomState(4),
                                            om_rand, 4, 64, False),
         bp.CandidateCaps(hull_hull=96, hull_plane=64, sphere_any=96),
         False),
        ("escape_room", om_er, body_er, env.caps, False),
    ]
    fields = ("hh", "hh_num", "hp", "hp_num", "sp", "sp_num", "sp_kind",
              "overflow")
    worst = 0
    for name, om, body, caps, must_overflow in cases:
        got = bpc.find_candidates_kernel(body, om, caps, env.cfg.dt)
        ref = bp.find_candidates(body, om, caps, env.cfg.dt)
        torch.cuda.synchronize()
        for f in fields:
            a, b = getattr(got, f), getattr(ref, f)
            if a.shape != b.shape:
                raise AssertionError(f"broadphase {name}: {f} shape differs")
            if a.numel():
                worst = max(worst, int((a.long() - b.long()).abs().max()))
            if not torch.equal(a, b):
                raise AssertionError(f"broadphase {name}: field {f} differs")
        n_ovf = int(got.overflow.sum())
        if must_overflow and n_ovf == 0:
            raise AssertionError(f"broadphase {name}: no world saturated")
        print(f"broadphase kernel == plain [{name}]: W={W} "
              f"hh={int(got.hh_num.sum())} hp={int(got.hp_num.sum())} "
              f"sp={int(got.sp_num.sum())} overflow_worlds={n_ovf}")
    return float(worst)


def load_script(name):
    """A module of the repo's scripts/ directory."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "scripts", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def lidar_inputs(sim):
    """The env's lidar arguments at the sim's current state."""
    return sim.env.lidar_inputs(sim.state)


def plain_lidar(args):
    from madrona_tpu_torch.ops.lidar_cuda import lidar_obb_plain

    return lidar_obb_plain(*args)


def random_lidar_args():
    """The lidar's arguments on a random scene at the Escape Room shape
    (W worlds, 20 boxes, 2 agents x 30 rays), two boxes hidden by the
    self-mask."""
    import torch

    rs = np.random.RandomState(11)
    n_inst, n_ag, n_rays = 20, 2, 30
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(DEV)  # noqa
    q = rs.randn(W, n_inst, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    ang = rs.uniform(0, 2 * np.pi, (W, n_ag, n_rays))
    mask = np.ones((n_ag, n_inst), bool)
    mask[0, 2] = mask[1, 5] = False
    return (
        t(rs.uniform(-8, 8, (W, n_inst, 3))), t(q),
        t(rs.uniform(0.2, 3.0, (W, n_inst, 3))),
        torch.from_numpy(mask).to(DEV), t(rs.uniform(-6, 6, (W, n_ag, 3))),
        t(np.stack([-np.sin(ang), np.cos(ang),
                    0.1 * rs.randn(W, n_ag, n_rays)], -1)),
        50.0,
    )


def check_lidar(sim):
    """Phase 3. Returns the max abs diff over both scenes."""
    import torch
    from madrona_tpu_torch.ops import lidar_cuda

    worst = 0.0
    for name, args in (("random", random_lidar_args()),
                       ("escape_room", lidar_inputs(sim))):
        got = lidar_cuda.lidar_obb(*args)
        ref = plain_lidar(args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        n_hit = int((got < args[-1]).sum())
        print(f"lidar kernel vs plain [{name}]: W={W} max_abs_diff={err!r} "
              f"hits={n_hit}/{got.numel()}")
        if not err <= LIDAR_TOL:
            raise AssertionError(f"lidar {name}: {err} > {LIDAR_TOL}")
        worst = max(worst, err)
    tiling = lidar_cuda.tiling(W, *args[0].shape[1:2], *args[5].shape[1:3])
    print("lidar tiling (occupancy API): " + ", ".join(
        f"{k} {v}" for k, v in tiling.items()))
    # the kernel's branch-free division and reciprocal against IEEE's,
    # bit for bit, over their stated ranges
    division = load_script("torch_lidar_division")
    x, y = division.operands(np.random.RandomState(12), LIDAR_DIVISIONS, DEV)
    off = division.mismatches(division.check(x, y))
    print(f"lidar divisions: {LIDAR_DIVISIONS} operand sets over the "
          f"kernel's range, in-range path against IEEE: guarded "
          f"reciprocals differing {off[0]}, accepted quotients differing "
          f"{off[1]}")
    if off != (0, 0):
        raise AssertionError("lidar: the in-range division differs")
    return worst


def crowded_scene():
    """(om, BodyState [W, 21], caps): rotated, scaled boxes crowded on a
    plane, no sphere objects, the Escape Room's caps 8/8/0."""
    from madrona_tpu_torch.physics import bodies as pb
    from madrona_tpu_torch.physics import broadphase as bp
    from madrona_tpu_torch.physics import geo

    reg = pb.ObjectRegistry()
    reg.add_plane()
    reg.add_hull(geo.box_hull((0.5, 0.5, 0.5)), mass=1.0)
    reg.add_hull(geo.box_hull((0.4, 0.8, 0.3)), mass=2.5)
    om = reg.build().to(DEV)
    body = random_scene(np.random.RandomState(21), om, 3, 21, True)
    return om, body, bp.CandidateCaps(hull_hull=8, hull_plane=8, sphere_any=0)


def with_grab_joints(sim):
    """The sim's state with a fixed grab joint (agent 0 holds cube 0) on
    in the even worlds and a hinge (agent 1, cube 1) in every fourth."""
    import torch
    from madrona_tpu_torch.models import escape_room as er
    from madrona_tpu_torch.physics import api as papi

    state = sim.state
    jb = {k: v.clone() for k, v in state.singletons[papi.JOINT_BUFFER].items()}
    f32 = lambda *v: torch.tensor(v, dtype=torch.float32,   # noqa: E731
                                  device=DEV)
    even, fourth = slice(0, W, 2), slice(1, W, 4)
    jb["e1"][even, 0] = er.ROW_AGENT0
    jb["e2"][even, 0] = er.ROW_CUBE0
    jb["jtype"][even, 0] = 0
    jb["r1"][even, 0] = f32(0.0, 0.6, 0.0)
    jb["r2"][even, 0] = f32(0.0, -0.6, 0.0)
    jb["attach_q1"][even, 0] = f32(1.0, 0.0, 0.0, 0.0)
    jb["attach_q2"][even, 0] = f32(1.0, 0.0, 0.0, 0.0)
    jb["active"][even, 0] = True
    jb["e1"][fourth, 1] = er.ROW_AGENT0 + 1
    jb["e2"][fourth, 1] = er.ROW_CUBE0 + 1
    jb["jtype"][fourth, 1] = 1
    jb["r1"][fourth, 1] = f32(0.0, 0.5, 0.1)
    jb["r2"][fourth, 1] = f32(0.0, -0.5, 0.0)
    jb["a1_local"][fourth, 1] = f32(0.0, 0.0, 1.0)
    jb["a2_local"][fourth, 1] = f32(0.0, 0.1, 1.0)
    jb["active"][fourth, 1] = True
    singles = dict(state.singletons)
    singles[papi.JOINT_BUFFER] = jb
    return dataclasses.replace(state, singletons=singles)


def contacts_inputs(body, om, caps, cfg):
    """(hh, hp, poses, obj) as the physics node hands them to the
    contacts kernel: candidates from the broadphase kernel, poses
    predicted by one integrate."""
    from madrona_tpu_torch.ops import broadphase_cuda, contacts_cuda
    from madrona_tpu_torch.physics import xpbd

    cands = broadphase_cuda.find_candidates_kernel(body, om, caps, cfg.dt)
    pred = xpbd.integrate(body, om, cfg.dt / cfg.substeps, cfg.gravity)
    poses, obj = contacts_cuda.pack_poses(pred, body.obj_id)
    return cands.hh, cands.hp, poses, obj


def sorted_points(pts, num):
    """[16, C, W] manifold rows -> live points sorted per lane (numpy)."""
    c, w = num.shape
    p = np.transpose(pts.reshape(4, 4, c, w), (2, 3, 0, 1)).reshape(-1, 4, 4)
    p = p.astype(np.float64)
    live = np.arange(4)[None] < num.reshape(-1, 1)
    p = np.where(live[..., None], p, 0.0)
    order = np.lexsort((p[..., 3], p[..., 2], p[..., 1], p[..., 0]), axis=-1)
    return np.take_along_axis(p, order[..., None], axis=1)


def compare_tables(what, name, got, ref):
    """Contact tables (ref, alt, con, pts, num) [.., C, W] of a kernel
    against its plain version's: rows, counts and ok flags equal; on ok
    lanes the reduced contact (normal, average point, largest
    penetration) within CON_TOL and the manifold points within PTS_TOL,
    unordered. Returns (con difference, points difference)."""
    import torch

    for f, a, b in zip(("ref", "alt", "con", "pts", "num"), got, ref):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{what} {name}: {f} shape/dtype differs")
    for i, f in ((0, "ref"), (1, "alt"), (4, "num")):
        if not torch.equal(got[i], ref[i]):
            bad = int((got[i] != ref[i]).sum())
            raise AssertionError(
                f"{what} {name}: {f} differs in {bad} of "
                f"{got[i].numel()} lanes")
    ok = ref[2][7] > 0.5
    if not torch.equal(got[2][7], ref[2][7]):
        raise AssertionError(f"{what} {name}: ok flags differ")
    con_err = float(torch.where(ok[None], (got[2] - ref[2]).abs(),
                                0.0).max())
    num_ok = torch.where(ok, ref[4], 0).cpu().numpy()
    pts_err = float(np.abs(
        sorted_points(got[3].cpu().numpy(), num_ok)
        - sorted_points(ref[3].cpu().numpy(), num_ok)).max())
    if not con_err <= CON_TOL:
        raise AssertionError(f"{what} {name}: con {con_err} > {CON_TOL}")
    if not pts_err <= PTS_TOL:
        raise AssertionError(f"{what} {name}: pts {pts_err} > {PTS_TOL}")
    return con_err, pts_err


def check_contacts(name, args, om, n_hh, want_face_and_edge,
                   edge_dirs=True):
    """Phase 4 on one scene, in one SAT tier (edge_dirs, else edge
    pairs). Returns (kernel outputs, largest float difference, the
    scene's lane counts for the operation count)."""
    import torch
    from madrona_tpu_torch.ops import contacts_cuda

    got = contacts_cuda.contacts(*args, om, edge_dirs)
    ref = contacts_cuda.contacts_plain(*args, om, edge_dirs)
    torch.cuda.synchronize()
    con_err, pts_err = compare_tables("contacts", name, got, ref)
    num = ref[4]
    ok = ref[2][7] > 0.5
    hh_num = num[:n_hh]
    counts = {
        "hh_candidates": int((args[0][..., 0] < args[2].shape[0]).sum()),
        "hp_candidates": int((args[1][..., 0] < args[2].shape[0]).sum()),
        "hh_live": int((hh_num > 0).sum()),
        "hh_4pt": int((hh_num == 4).sum()),
        "hh_1pt": int((hh_num == 1).sum()),
        "hp_live": int((num[n_hh:] > 0).sum()),
        "ok": int(ok.sum()),
    }
    print(f"contacts kernel vs plain [{name}]: W={num.shape[1]} "
          "ref/alt/num equal; "
          f"con max_abs_diff={con_err!r} pts max_abs_diff={pts_err!r}; "
          + " ".join(f"{k}={v}" for k, v in counts.items()))
    if want_face_and_edge and not (counts["hh_4pt"] > 0
                                   and counts["hh_1pt"] > 0):
        raise AssertionError(f"contacts {name}: no live hull-hull face "
                             "and edge contacts")
    return got, max(con_err, pts_err), counts


def check_solver(name, cfg, state, param, cargs, jargs):
    """Phase 5 on one scene. Returns the largest difference."""
    import torch
    from madrona_tpu_torch.ops import solver_cuda

    got = solver_cuda.substep_solver(cfg, state, param, *cargs, *jargs)
    ref = solver_cuda.substep_solver_plain(cfg, state, param, *cargs,
                                           *jargs)
    torch.cuda.synchronize()
    return compare_steps("solver", name, got, ref, state, param,
                         cfg.solver_dynamic_range)


def compare_steps(what, name, got, ref, state, param, dyn_range):
    """A step kernel's out [33, N, W] against its plain version's: every
    field within its tolerance, static rows (and rows outside the
    dynamic range) bit-equal to their inputs, something moved. Returns
    the largest absolute difference."""
    import torch

    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what} {name}: bad shape or not finite")
    fields = (("pos", 0, 3, POSE_TOL), ("rot", 3, 7, POSE_TOL),
              ("vel", 7, 10, VEL_TOL), ("omega", 10, 13, OMEGA_TOL),
              ("prev_x", 13, 16, POSE_TOL), ("prev_q", 16, 20, POSE_TOL),
              ("presolve_x", 20, 23, POSE_TOL),
              ("presolve_q", 23, 27, POSE_TOL),
              ("presolve_v", 27, 30, VEL_TOL),
              ("presolve_w", 30, 33, OMEGA_TOL))
    diffs = {f: float((got[lo:hi] - ref[lo:hi]).abs().max())
             for f, lo, hi, _ in fields}
    print(f"{what} kernel vs plain [{name}]: W={got.shape[2]} max_abs_diff "
          + " ".join(f"{k}={v!r}" for k, v in diffs.items()))
    # how heavy the tail is: worlds where some field is off by more than a
    # tenth of its tolerance (a contact branch taken the other way)
    rel = torch.stack([
        (got[lo:hi] - ref[lo:hi]).abs().amax(dim=(0, 1)) / tol
        for _, lo, hi, tol in fields]).amax(dim=0)
    print(f"{what} kernel vs plain [{name}]: {int((rel > 0.1).sum())} of "
          f"{got.shape[2]} worlds differ by more than a tenth of a tolerance")
    for f, _, _, tol in fields:
        if not diffs[f] <= tol:
            raise AssertionError(f"{what} {name}: {f} {diffs[f]} > {tol}")
    static = param[8] > 0.5                               # [N, W]
    if dyn_range:
        d0, d1 = dyn_range
        static = static.clone()
        static[:d0] = True
        static[d1:] = True
    same = (
        torch.equal(got[:13][:, static], state[:, static])
        and torch.equal(got[13:20][:, static], state[:7][:, static])
        and torch.equal(got[20:27][:, static], state[:7][:, static])
    )
    if not same:
        raise AssertionError(f"{what} {name}: a static row moved")
    moved = float((got[:3] - state[:3]).abs().max())
    print(f"{what} kernel [{name}]: {int(static.sum())} static rows "
          f"bit-equal to their inputs; largest move {moved:.3g}")
    if not moved > 1e-3:
        raise AssertionError(f"{what} {name}: nothing moved")
    return max(diffs.values())


def check_physics_kernels(probe):
    """Phases 4 to 7. Returns (contacts err, solver err, hull-hull record
    err, fused err, what the timing phase needs of the Escape Room
    scene)."""
    import torch
    from madrona_tpu_torch.models import escape_room as er
    from madrona_tpu_torch.ops import broadphase_cuda, solver_cuda
    from madrona_tpu_torch.physics import api as papi

    env = probe.env
    cfg = env.cfg
    om_er = env.om.to(DEV)
    state = with_grab_joints(probe)
    body = papi.body_state(probe.executor.sm, state)
    er_args = contacts_inputs(body, om_er, env.caps, cfg)
    er_c, er_err, er_counts = check_contacts("escape_room", er_args, om_er,
                                             env.caps.hull_hull, False)
    om_cr, body_cr, caps_cr = crowded_scene()
    cr_args = contacts_inputs(body_cr, om_cr, caps_cr, cfg)
    cr_c, cr_err, _ = check_contacts("crowded", cr_args, om_cr,
                                     caps_cr.hull_hull, True)
    for name, args, om_, n_hh, want in (
            ("escape_room", er_args, om_er, env.caps.hull_hull, False),
            ("crowded", cr_args, om_cr, caps_cr.hull_hull, True)):
        cr_err = max(cr_err, check_contacts(f"{name} edge_pairs", args, om_,
                                            n_hh, want, False)[1])

    st, pr = solver_cuda.pack_state(body, om_er)
    jargs = solver_cuda.pack_joints(papi.joints_view(state), er.N_BODIES)
    s_err = check_solver("escape_room + joints", cfg, st, pr, er_c, jargs)
    spec_cr = dataclasses.replace(cfg, solver_dynamic_range=None,
                                  solver_ref_dyn_lanes=0)
    st_cr, pr_cr = solver_cuda.pack_state(body_cr, om_cr)
    s_err = max(s_err, check_solver("crowded", spec_cr, st_cr, pr_cr, cr_c,
                                    ()))
    n_joints = int((jargs[2][21] > 0.5).sum())
    print(f"solver scenes: escape_room has {n_joints} live joints in "
          f"{W} worlds")

    # ---- 6: the hull-hull record kernel, both SAT tiers
    hh_err, hh_counts = check_hh_record("escape_room", er_args, om_er)
    cr_hh_err, cr_hh_counts = check_hh_record("crowded", cr_args, om_cr)
    if hh_counts["edge_dirs"]["hh_live"] != er_counts["hh_live"]:
        raise AssertionError("hh record and contacts disagree on the "
                             "Escape Room's live hull-hull lanes")

    # ---- 7: the fused-step kernel on the Escape Room state with joints
    # and on a scene with every lane kind live
    f_cfg = dataclasses.replace(cfg, **FUSED)
    cands = broadphase_cuda.find_candidates_kernel(body, om_er, env.caps,
                                                   cfg.dt)
    f_err, f_args, f_counts = check_fused("escape_room + joints", f_cfg,
                                          body, om_er, cands, jargs)
    om_sp, body_sp, caps_sp = sphere_scene()
    cands_sp = broadphase_cuda.find_candidates_kernel(body_sp, om_sp,
                                                      caps_sp, cfg.dt)
    spheres = {}
    for tier in ("edge_dirs", "edge_pairs"):
        sp_cfg = dataclasses.replace(f_cfg, sat_tier=tier)
        e, sp_args, sp_counts = check_fused(f"spheres {tier}", sp_cfg,
                                            body_sp, om_sp, cands_sp, (),
                                            True)
        f_err = max(f_err, e)
        spheres[tier] = dict(fused_cfg=sp_cfg, fused_args=sp_args,
                             fused_counts=sp_counts, jargs=())
    torch.cuda.synchronize()
    scene = dict(om=om_er, args=er_args, contacts=er_c, counts=er_counts,
                 state=st, param=pr, jargs=jargs, n_joints=n_joints,
                 hh_counts=hh_counts, fused_cfg=f_cfg, fused_args=f_args,
                 fused_counts=f_counts, crowded_args=cr_args,
                 crowded_om=om_cr, crowded_hh_counts=cr_hh_counts,
                 spheres=spheres)
    return (max(er_err, cr_err), s_err, max(hh_err, cr_hh_err), f_err,
            scene)


def physics_route(body, om, env, jargs):
    """The physics node's device work on one body state, as
    physics/api.py strings it together."""
    from madrona_tpu_torch.ops import contacts_cuda, solver_cuda

    cfg = env.cfg
    cargs = contacts_cuda.contacts(*contacts_inputs(body, om, env.caps, cfg),
                                   om)
    state, param = solver_cuda.pack_state(body, om)
    return solver_cuda.substep_solver(cfg, state, param, *cargs, *jargs)


def record_points(rec):
    """The record's points [P, 22, W] -> [16, P, W] rows of 4 x (xyz,
    depth), the contacts kernel's layout (for sorted_points)."""
    p, _, w = rec.shape
    return rec[:, 6:22].reshape(p, 4, 4, w).permute(2, 1, 0, 3).reshape(
        16, p, w)


def tile_paths(hh, n, tile, limit):
    """{path: tiles} of a tiled narrowphase kernel's launch over
    candidates hh [W, P, 2] (rows, sentinel n): a tile whose live
    hull-hull lanes number at most ``limit`` gives each a warp ("warp"),
    else each a thread ("thread"); "none" has no live lane."""
    import torch

    live = ((hh >= 0) & (hh < n)).all(-1).sum(1)              # [W]
    w = live.shape[0]
    per = torch.nn.functional.pad(live, (0, -w % tile)).view(-1, tile).sum(1)
    return {"warp": int(((per > 0) & (per <= limit)).sum()),
            "thread": int((per > limit).sum()), "none": int((per == 0).sum())}


def print_paths(kernel, name, hh, n, tiling):
    tile, limit = tiling[:2]
    paths = tile_paths(hh, n, tile, limit)
    print(f"{kernel} tiles [{name}]: {tile} worlds a tile, hull-hull lanes "
          f"a warp each up to {limit}: " + ", ".join(
              f"{k} {v}" for k, v in paths.items()))
    return paths


def check_hh_record(name, args, om):
    """Phase 6 on one scene, in both SAT tiers. Returns (largest float
    difference, lane counts per tier for the operation count)."""
    import torch
    from madrona_tpu_torch.ops import hh_narrowphase_cuda as hhc

    hh, _, poses, obj = args
    n = poses.shape[0]
    worst, counts = 0.0, {}
    counts["paths"] = print_paths("hh record", name, hh, n, hhc.tiling(
        poses.shape[2], hh.shape[1], om))
    for tier, dirs in (("edge_dirs", True), ("edge_pairs", False)):
        got = hhc.hh_record(hh, poses, obj, om, dirs)
        ref = hhc.hh_record_plain(hh, poses, obj, om, dirs)
        torch.cuda.synchronize()
        if got.shape != ref.shape:
            raise AssertionError(f"hh record {name}: shape differs")
        for i, f in ((0, "ref"), (1, "alt"), (2, "num")):
            if not torch.equal(got[:, i], ref[:, i]):
                bad = int((got[:, i] != ref[:, i]).sum())
                raise AssertionError(f"hh record {name} {tier}: {f} differs "
                                     f"in {bad} lanes")
        num = ref[:, 2].to(torch.int32)
        live = num > 0
        nrm_err = float(torch.where(live[:, None], (got[:, 3:6]
                                                    - ref[:, 3:6]).abs(),
                                    0.0).max())
        num_np = num.cpu().numpy()
        pts_err = float(np.abs(
            sorted_points(record_points(got).cpu().numpy(), num_np)
            - sorted_points(record_points(ref).cpu().numpy(), num_np)).max())
        c = {"hh_candidates": int((hh[..., 0] < n).sum()),
             "hh_live": int(live.sum()), "hh_4pt": int((num == 4).sum()),
             "hh_1pt": int((num == 1).sum())}
        counts[tier] = c
        print(f"hh record kernel vs plain [{name} {tier}]: W={num.shape[1]} "
              f"ref/alt/num equal; normal max_abs_diff={nrm_err!r} pts "
              f"max_abs_diff={pts_err!r}; "
              + " ".join(f"{k}={v}" for k, v in c.items()))
        if not nrm_err <= CON_TOL:
            raise AssertionError(f"hh record {name}: normal {nrm_err}")
        if not pts_err <= PTS_TOL:
            raise AssertionError(f"hh record {name}: pts {pts_err}")
        worst = max(worst, nrm_err, pts_err)
    return worst, counts


def fused_args(body, om, cands):
    """The fused-step kernel's arguments before the joints."""
    from madrona_tpu_torch.ops import fused_cuda

    return (*fused_cuda.pack_fused(body, om), cands.hh.contiguous(),
            cands.hp.contiguous(), cands.sp.contiguous(),
            cands.sp_kind.contiguous(), om)


def fused_lane_counts(cfg, args):
    """Live lanes of the fused step's narrowphase by kind, from the plain
    version's first half (integrate, then the tensor narrowphase): the
    scene check and the operation count of the bound."""
    import torch
    from madrona_tpu_torch.ops import solver_cuda
    from madrona_tpu_torch.physics import geo, xpbd
    from madrona_tpu_torch.physics import narrowphase as np_

    state, param, scale, obj, hh, hp, sp, sp_kind, om = args
    body, params = solver_cuda.unpack_state(state, param)
    pred = xpbd.integrate(body, None, cfg.dt / cfg.substeps, cfg.gravity,
                          params)
    ref, _, _, num, _ = np_.narrowphase_lanes(
        pred.pos, pred.rot, scale.permute(2, 1, 0), obj.t(), om, hh, hp, sp,
        sp_kind, sat_dirs=cfg.sat_tier == "edge_dirs")
    n = state.shape[1]
    ph, pp = hh.shape[1], hp.shape[1]
    hh_num, sp_num = num[:, :ph], num[:, ph + pp:]
    kind_live = lambda t: int(((sp_num > 0) & (sp_kind == t)).sum())  # noqa
    kind_cand = lambda t: int(((sp[..., 0] < n) & (sp_kind == t)).sum())  # noqa
    return {
        "hh_candidates": int((hh[..., 0] < n).sum()),
        "hh_live": int((hh_num > 0).sum()), "hh_1pt": int((hh_num == 1).sum()),
        "hp_candidates": int((hp[..., 0] < n).sum()),
        "hp_live": int((num[:, ph:ph + pp] > 0).sum()),
        "sp_hull": kind_cand(geo.TYPE_HULL),
        "sp_plane": kind_cand(geo.TYPE_PLANE),
        "sp_sphere": kind_cand(geo.TYPE_SPHERE),
        "sp_live_hull": kind_live(geo.TYPE_HULL),
        "sp_live_plane": kind_live(geo.TYPE_PLANE),
        "sp_live_sphere": kind_live(geo.TYPE_SPHERE),
        "ok": int((num > 0).sum()), "points": int(num.sum()),
        "movable": int((param[8] <= 0.5).sum()),
    }


def check_fused(name, cfg, body, om, cands, jargs, want_spheres=False):
    """Phase 7 (and 11) on one scene: the kernel's narrowphase lanes
    (its contact tables before the substeps) against the plain
    version's, then its step. Returns (largest difference, the kernel's
    arguments, the scene's lane counts)."""
    import torch
    from madrona_tpu_torch.ops import fused_cuda, solver_cuda

    args = fused_args(body, om, cands)
    got, lanes = fused_cuda.fused_step_lanes(cfg, *args, *jargs)
    ref_lanes = fused_cuda.fused_contacts_plain(cfg, *args)
    ref = fused_cuda.fused_step_plain(cfg, *args, *jargs)
    torch.cuda.synchronize()
    counts = fused_lane_counts(cfg, args)
    print(f"fused scene [{name}]: " + " ".join(
        f"{k}={v}" for k, v in counts.items()))
    counts["paths"] = print_paths("fused", name, args[4], args[0].shape[1],
                                  fused_cuda.tiling(
                                      args[0], *args[4:7], args[8],
                                      jargs[0].shape[0] if jargs else 0))
    if want_spheres and not (counts["hh_live"] and counts["hp_live"]
                             and counts["sp_live_hull"]
                             and counts["sp_live_plane"]
                             and counts["sp_live_sphere"]):
        raise AssertionError(f"fused {name}: not every lane kind is live")
    con_err, pts_err = compare_tables("fused lanes", name, lanes, ref_lanes)
    ok = ref_lanes[2][7] > 0.5
    nrm_err, avg_err, pen_err = (
        float(torch.where(ok[None], (lanes[2][lo:hi] - ref_lanes[2][lo:hi])
                          .abs(), 0.0).max())
        for lo, hi in ((0, 3), (3, 6), (6, 7)))
    print(f"fused lanes vs plain [{name}]: ref/alt/num/ok equal on "
          f"{ok.numel()} lanes; normal max_abs_diff={nrm_err!r} average "
          f"point {avg_err!r} penetration {pen_err!r} points {pts_err!r}")
    err = compare_steps("fused", name, got, ref, args[0], args[1], None)
    # where the step's difference arises: the plain substep solver on the
    # kernel's own lanes against the kernel's step
    spec = dataclasses.replace(cfg, solver_dynamic_range=None,
                               solver_ref_dyn_lanes=0)
    on_lanes = solver_cuda.substep_solver_plain(spec, args[0], args[1],
                                                *lanes, *jargs)
    print(f"fused kernel vs the plain substeps on its own lanes [{name}]: "
          f"max_abs_diff {float((got - on_lanes).abs().max())!r}, the "
          f"plain step vs the same {float((ref - on_lanes).abs().max())!r}")
    return max(err, con_err, pts_err), args, counts


def sphere_scene():
    """(om, BodyState [W, 21], caps): a plane, two box sizes and spheres,
    rotated and scaled, crowded (the JAX package's fused_case objects);
    caps 8/8/8."""
    from madrona_tpu_torch.physics import bodies as pb
    from madrona_tpu_torch.physics import broadphase as bp
    from madrona_tpu_torch.physics import geo

    reg = pb.ObjectRegistry()
    reg.add_plane()
    reg.add_hull(geo.box_hull((0.5, 0.5, 0.5)), mass=1.0)
    reg.add_hull(geo.box_hull((0.4, 0.8, 0.3)), mass=2.5)
    reg.add_sphere(0.45, mass=0.8)
    om = reg.build().to(DEV)
    body = random_scene(np.random.RandomState(23), om, 4, 21, True)
    return om, body, bp.CandidateCaps(hull_hull=8, hull_plane=8, sphere_any=8)


# the physics tiers of this slice, as PhysicsConfig changes of an env
FUSED = dict(megakernel_fused=True, megakernel=False, narrowphase="xla")
SUBLANE = dict(narrowphase="kernel_sublane")
LANE_MAJOR = dict(narrowphase="kernel")


def with_physics(env, **change):
    """``env`` with its PhysicsConfig changed, as the JAX package's tests
    change it."""
    env.cfg = dataclasses.replace(env.cfg, **change)
    return env


def check_no_fallback(sim, kernels, launch=None, label=None):
    """With the library of every kernel in ``kernels`` unloaded, missing
    on disk and no compiler to be found, a step of ``sim`` (on the card)
    over ``launch`` must raise: it may not go on with the plain
    versions."""
    import torch
    from madrona_tpu_torch.ops import cuda_build

    def no_nvcc():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    saved = (cuda_build._nvcc, cuda_build.library_path,
             [k._fn for k in kernels])
    w = sim.executor.num_worlds
    what = label or f"{sim.env.name} {launch or sim.env.default_launch}"
    try:
        cuda_build._nvcc = no_nvcc
        cuda_build.library_path = (
            lambda src: cuda_build.BUILD_DIR / f"missing-{src}.so")
        for k in kernels:
            k._fn = None
        try:
            sim.step({"action": torch.zeros((w,) + sim.env.action_shape,
                                            dtype=torch.int32, device=DEV),
                      "reset": torch.zeros((w,), dtype=torch.int32,
                                           device=DEV)}, launch=launch)
        except RuntimeError as e:
            print(f"no fallback [{what}]: without "
                  f"{', '.join(k.source for k in kernels)} the step raises "
                  f"({e})")
        else:
            raise AssertionError(f"{what} ran without its kernels")
    finally:
        cuda_build._nvcc, cuda_build.library_path = saved[:2]
        for k, fn in zip(kernels, saved[2]):
            k._fn = fn


def run_main_path(make_sim, make_env, acts, counters, w=None):
    """A main path: step a fresh sim of ``make_env()`` at ``w`` worlds
    through its default launch, with every counter of ``counters`` set to
    0 first; returns (sim, per-step exports, seconds of steps 2..STEPS,
    the counters' launches in this run)."""
    import torch

    w = W if w is None else w
    sim = make_sim(make_env(), num_worlds=w, seed=0, device=DEV)
    reset = torch.zeros((w,), dtype=torch.int32, device=DEV)
    for k in counters:
        k.launches = 0
    outs = []
    t0 = None
    for i in range(STEPS):
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out = sim.step({"action": acts[i], "reset": reset})
        outs.append(out)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return sim, outs, secs, [k.launches for k in counters]


def node_times(sim, acts, steps=5):
    """Host seconds per step of each taskgraph node, each node fenced by
    torch.cuda.synchronize() (eager PyTorch: a node's time is its host
    dispatch plus whatever device work it waits on)."""
    import torch

    nodes = [n for g in sim.env.default_launch
             for n in sim.executor.graphs[g].nodes]
    totals = {n.name: 0.0 for n in nodes}

    def fenced(name, fn):
        def run(sm, state, key):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(sm, state, key)
            torch.cuda.synchronize()
            totals[name] += time.perf_counter() - t0
            return out
        return run

    saved = [n.fn for n in nodes]
    try:
        for n in nodes:
            n.fn = fenced(n.name, n.fn)
        reset = torch.zeros((sim.executor.num_worlds,), dtype=torch.int32,
                            device=DEV)
        for i in range(steps):
            sim.step({"action": acts[i], "reset": reset})
    finally:
        for n, fn in zip(nodes, saved):
            n.fn = fn
    return {k: v / steps for k, v in totals.items()}


def arrange_hide_seek(sim):
    """The sim's Hide & Seek state arranged so that the physics kernels
    see what the env can give them: a box on a ramp's low end, an agent
    on a ramp's slope, an agent against a ramp's triangular side, a box
    against a wall (each with a little seeded jitter); box 0 locked (a
    static row inside the solver's dynamic range) in the even worlds;
    seeker 0 holding box 2 by a fixed joint in slot 2 of every fourth
    world, the other slots inactive with e1 = e2 = -1; random kicks."""
    import dataclasses

    import torch
    from madrona_tpu_torch.models import hide_seek as hs
    from madrona_tpu_torch.physics import api as papi
    from madrona_tpu_torch.physics import xpbd

    state = sim.state
    w = sim.executor.num_worlds
    rs = np.random.RandomState(31)
    dev_t = lambda a: torch.from_numpy(                      # noqa: E731
        np.asarray(a, np.float32)).to(sim.device)
    t = state.tables[hs.RIGID_BODY]
    c = dict(t.columns)
    pos, rot = c["Position"].clone(), c["Rotation"].clone()
    place = {
        hs.ROW_RAMP0: (0.0, 0.0, 0.0), hs.ROW_RAMP0 + 1: (6.0, 0.0, 0.0),
        hs.ROW_BOX0: (1.5, 0.2, 0.9), hs.ROW_BOX0 + 1: (-19.15, 3.0, 0.9),
        hs.ROW_BOX0 + 2: (-18.0, -16.6, 0.9),
        hs.ROW_AGENT0: (6.3, 0.0, 1.1), hs.ROW_AGENT0 + 1: (-0.5, 1.45, 0.8),
        hs.ROW_AGENT0 + 2: (-18.0, -18.0, 0.8),
        hs.ROW_AGENT0 + 3: (10.0, 10.0, 0.8),
    }
    for row, xyz in place.items():
        jit = rs.uniform(-0.05, 0.05, (w, 3)) * [1.0, 1.0, 0.0]
        pos[:, row] = dev_t(np.asarray(xyz) + jit)
    yaw = rs.uniform(-0.3, 0.3, (w, hs.N_MOVABLE))
    zero = np.zeros_like(yaw)
    rot[:, hs.ROW_BOX0:hs.ROW_BOX0 + hs.N_MOVABLE] = dev_t(np.stack(
        [np.cos(yaw / 2), zero, zero, np.sin(yaw / 2)], -1))
    rot[:, hs.ROW_AGENT0 + 2] = dev_t([1.0, 0.0, 0.0, 0.0])
    dyn = (np.arange(hs.N_BODIES) >= hs.ROW_BOX0)[None, :, None]
    kick = lambda sc: dev_t(                                 # noqa: E731
        sc * rs.randn(w, hs.N_BODIES, 3) * dyn)
    resp = c["ResponseType"].clone()
    resp[0::2, hs.ROW_BOX0] = xpbd.RESPONSE_STATIC
    c.update(Position=pos, Rotation=rot, ResponseType=resp,
             Velocity={"linear": kick(0.5), "angular": kick(0.3)},
             ExternalForce=kick(1.0))
    tables = dict(state.tables)
    tables[hs.RIGID_BODY] = dataclasses.replace(t, columns=c)
    singles = dict(state.singletons)
    jb = {k: v.clone() for k, v in singles[papi.JOINT_BUFFER].items()}
    jb["e1"][:] = -1
    jb["e2"][:] = -1
    jb["active"][:] = False
    fourth = slice(0, w, 4)
    jb["e1"][fourth, 2] = hs.ROW_AGENT0 + 2
    jb["e2"][fourth, 2] = hs.ROW_BOX0 + 2
    jb["jtype"][:] = 0
    jb["r1"][fourth, 2] = dev_t([0.0, 0.7, 0.1])
    jb["r2"][fourth, 2] = dev_t([0.0, -0.7, 0.0])
    jb["attach_q1"][..., 0] = 1.0
    jb["attach_q2"][..., 0] = 1.0
    jb["active"][fourth, 2] = True
    singles[papi.JOINT_BUFFER] = jb
    return dataclasses.replace(state, tables=tables, singletons=singles)


def check_hide_seek_physics(sim):
    """Phase 11: B1, B2, B3 and B8 against their plain versions on the
    arranged Hide & Seek state. Returns (largest differences of the
    four, what the timing phase needs)."""
    import torch
    from madrona_tpu_torch.models import hide_seek as hs
    from madrona_tpu_torch.ops import broadphase_cuda, solver_cuda
    from madrona_tpu_torch.physics import api as papi
    from madrona_tpu_torch.physics import broadphase as bp

    env, cfg = sim.env, sim.env.cfg
    om = env.om.to(DEV)
    state = arrange_hide_seek(sim)
    body = papi.body_state(sim.executor.sm, state)
    w = body.pos.shape[0]

    got = broadphase_cuda.find_candidates_kernel(body, om, env.caps, cfg.dt)
    ref = bp.find_candidates(body, om, env.caps, cfg.dt)
    torch.cuda.synchronize()
    for f in ("hh", "hh_num", "hp", "hp_num", "sp", "sp_num", "sp_kind",
              "overflow"):
        if not torch.equal(getattr(got, f), getattr(ref, f)):
            raise AssertionError(f"broadphase hide_seek: field {f} differs")
    n_locked = int((body.response[:, hs.ROW_BOX0] == 2).sum())
    print(f"broadphase kernel == plain [hide_seek]: W={w} "
          f"hh={int(got.hh_num.sum())} hp={int(got.hp_num.sum())} "
          f"overflow_worlds={int(got.overflow.sum())} "
          f"locked_boxes={n_locked}")
    if int(got.hh_num.sum()) < 3 * w or int(got.overflow.sum()):
        raise AssertionError("broadphase hide_seek: scene not as arranged")

    c_args = contacts_inputs(body, om, env.caps, cfg)
    c_out, co_err, counts = check_contacts("hide_seek", c_args, om,
                                           env.caps.hull_hull, False)
    co_err = max(co_err, check_contacts("hide_seek edge_pairs", c_args, om,
                                        env.caps.hull_hull, False, False)[1])
    if counts["hh_live"] < 2 * w:
        raise AssertionError("contacts hide_seek: too few live wedge lanes")
    st, pr = solver_cuda.pack_state(body, om)
    jargs = solver_cuda.pack_joints(papi.joints_view(state), hs.N_BODIES)
    so_err = check_solver("hide_seek + joint", cfg, st, pr, c_out, jargs)
    n_joints = int((jargs[2][21] > 0.5).sum())
    print(f"solver scenes: hide_seek has {n_joints} live joints in {w} "
          f"worlds, {4 * w - n_joints} inactive slots")
    f_cfg = dataclasses.replace(cfg, **FUSED)
    fu_err, f_args, f_counts = check_fused("hide_seek + joint", f_cfg, body,
                                           om, got, jargs)
    return (0.0, co_err, so_err, fu_err), dict(
        body=body, om=om, c_args=c_args, c_out=c_out, counts=counts,
        state=st, param=pr, jargs=jargs, n_joints=n_joints,
        fused_cfg=f_cfg, fused_args=f_args, fused_counts=f_counts)


def raycast_compare(name, planes, opts):
    """The raycast kernel against its plain version on one set of
    planes. Returns (largest difference over all planes, kernel out)."""
    import torch
    from madrona_tpu_torch.ops import raycast_cuda as rck

    got = rck.raytrace(*planes, **opts)
    ref = rck.raytrace_plain(*planes, **opts)
    torch.cuda.synchronize()
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"raycast {name}: bad shape or not finite")
    d = (got - ref).abs().amax(dim=(0, 2)).tolist()
    hits = float((ref[:, rck.O_T] < opts["t_max"]).float().mean())
    n_diff = int(((got - ref).abs() > RAY_TOL).any(dim=1).sum())
    print(f"raycast kernel vs plain [{name}]: WV={got.shape[0]} "
          f"T_pad={planes[0].shape[1]} R_pad={got.shape[2]} max_abs_diff "
          f"rgb={max(d[0:3])!r} depth={d[3]!r} occ={d[4]!r} "
          f"uv={max(d[5:7])!r}; hit share {hits:.3f}, occluded share "
          f"{float(ref[:, rck.O_OCC].mean()):.3f}, rays differing {n_diff}")
    if not max(d) <= RAY_TOL:
        raise AssertionError(f"raycast {name}: {max(d)} > {RAY_TOL}")
    return max(d), got


def synthetic_ray_planes(rs, wv, t_pad, r_pad, tex, device):
    """Random raycast inputs (setup, attrs, dl, atlas) on ``device`` with
    exact ties, disabled shadow rows and dead rows; the CPU tests make
    theirs with this function too. The last four rows are padding."""
    import torch
    from madrona_tpu_torch.ops import raycast_cuda as rck
    from madrona_tpu_torch.render import kernel as rkernel
    from madrona_tpu_torch.render.raycast import RenderConfig

    t = t_pad - 4
    setup = np.zeros((wv, t_pad, rck.PS), np.float32)
    setup[:, :t] = rs.randn(wv, t, rck.PS)
    setup[:, :t, 9] *= 20.0
    setup[:, :t, 22] = 6.0 * np.abs(setup[:, :t, 22])
    setup[:, :t, 23] = 2e-2 * setup[:, :t, 22]
    setup[:, 3:t:7, 22:24] = 0.0
    setup[:, 20:26] = setup[:, 8:14]
    setup[:, 30] = 0.0
    attrs = np.zeros((wv, rck.FA, t_pad), np.float32)
    attrs[:, :, :t] = rs.rand(wv, rck.FA, t)
    attrs[:, rck.A_TEX, :t] = rs.randint(-1, 2, (wv, t))
    attrs[:, rck.A_UV0X:rck.A_DU2Y + 1, :t] = rs.uniform(-2, 2, (wv, 6, t))
    attrs[:, 15] = 0.0
    side = int(round(r_pad ** 0.5))
    dl, _ = rkernel._local_dir_grid(RenderConfig(width=side, height=side))
    atlas = rs.rand(3 * tex, 2 * tex).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device)
                 for x in (setup, attrs, dl, atlas))


def check_raycast(sim):
    """Phase 8. Returns (largest difference, the real scene's planes and
    options for the timing phase)."""
    from madrona_tpu_torch.render import kernel as rkernel

    env = sim.env
    planes, opts, n_rays = rkernel.kernel_inputs(
        env.rcfg, *env.rsys.render_inputs(sim.state))
    if opts["shadows"] or opts["use_lights"] or opts["use_materials"]:
        raise AssertionError("the dense tier runs flat colours")
    if planes[0].shape[0] != HS_W * 4 or n_rays != HS_RENDER ** 2:
        raise AssertionError(f"raycast shapes {planes[0].shape}, {n_rays}")
    worst, _ = raycast_compare("hide_seek flat", planes, opts)
    rs = np.random.RandomState(41)
    tex = 8
    for i, (name, sh, li, ma) in enumerate((
            ("shadows", True, False, False),
            ("lights+shadows", True, True, False),
            ("materials+lights", False, True, True),
            ("materials+shadows", True, False, True))):
        syn = synthetic_ray_planes(rs, RAY_SYN_WV, planes[0].shape[1],
                                   planes[2].shape[1], tex, DEV)
        o = dict(t_max=50.0, shadows=sh, use_lights=li, use_materials=ma,
                 ambient=0.35, shadow_ambient=0.3, sky=(0.1, 0.2, 0.4),
                 tex_size=tex)
        worst = max(worst, raycast_compare(f"synthetic {name}", syn, o)[0])
    return worst, (planes, opts, n_rays)


def check_raycast_blas(sim):
    """Phase 13a: the raycast kernel on the BLAS tier's own planes.
    Returns (largest difference, (planes, options, live ray count))."""
    from madrona_tpu_torch.ops import raycast_cuda as rck
    from madrona_tpu_torch.render import kernel as rkernel

    env = sim.env
    planes, opts, n_rays = rkernel.kernel_inputs(
        env.rcfg, *env.rsys.render_inputs(sim.state))
    if not (opts["shadows"] and opts["use_lights"] and opts["use_materials"]):
        raise AssertionError(f"the BLAS tier runs every option: {opts}")
    if planes[0].shape[0] != HS_W * 4 or n_rays != HS_RENDER ** 2:
        raise AssertionError(f"raycast shapes {planes[0].shape}, {n_rays}")
    worst, out = raycast_compare("hide_seek blas", planes, opts)
    occ = float(out[:, rck.O_OCC, :n_rays].mean())
    textured = float((planes[1][:, rck.A_TEX] >= 0).float().mean())
    print(f"raycast blas scene: {planes[3].shape[1] // env.rsys.materials.tex_size}"
          f" atlas layer(s) of {env.rsys.materials.tex_size}^2, share of "
          f"textured rows {textured:.3f}, occluded share {occ:.3f}")
    if not (0.0 < occ < 1.0 and textured > 0.0):
        raise AssertionError("raycast blas: no shadow or no texture in view")
    return worst, (planes, opts, n_rays)


def check_pixels(out, what):
    """rgb within [0, 1], depth within (0, t_max], most rays hit."""
    rgb, depth = out["rgb"], out["depth"]
    hit = float((depth < 80.0).float().mean())
    print(f"{what}: rgb in [{float(rgb.min()):.3f}, {float(rgb.max()):.3f}], "
          f"depth in [{float(depth.min()):.3f}, {float(depth.max()):.3f}], "
          f"share of rays that hit {hit:.3f}")
    if not (float(rgb.min()) >= 0.0 and float(rgb.max()) <= 1.0
            and float(depth.min()) > 0.0 and float(depth.max()) <= 80.0
            and 0.5 < hit < 1.0):
        raise AssertionError(f"{what}: rgb or depth out of range")


def check_exports(outs, shapes, what):
    """Every float export of every step finite; the last step's shapes."""
    import torch

    for i, out in enumerate(outs):
        for name, v in out.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{what} step {i}: {name} not finite")
    for name, shape in shapes.items():
        if tuple(outs[-1][name].shape) != shape:
            raise AssertionError(
                f"{what}: {name} shape {tuple(outs[-1][name].shape)}")


def check_path(make_sim, make_env, w, counters, want, what, shapes, card):
    """Phases 12 and 14 for one path: the counted run (each counter's
    launches must equal its ``want``), its checks, a fresh sim's
    bit-identical rerun, ms by node. Returns (sim, per-step exports,
    env-steps/s, ms/step, launches)."""
    import torch

    acts = make_env().random_actions(np.random.RandomState(0), STEPS, w)
    acts = acts.to(DEV)
    sim, outs, secs, launches = run_main_path(make_sim, make_env, acts,
                                              counters, w)
    for k, n, must in zip(counters, launches, want):
        print(f"{what}: {k.symbol} launched {n} times in {STEPS} steps")
        if n != must:
            raise AssertionError(f"{what}: {k.symbol} {n} launches != {must}")
    check_exports(outs, shapes, what)
    sps = w * (STEPS - 1) / secs
    ms = secs * 1e3 / (STEPS - 1)
    print(f"{what}: {w} worlds x {STEPS} steps through "
          f"{sim.env.default_launch}, exports finite; {ms:.2f} ms/step, "
          f"{sps:.1f} env-steps/s ({card})")
    _, outs2, _, _ = run_main_path(make_sim, make_env, acts, [], w)
    for i, (a, b) in enumerate(zip(outs, outs2)):
        for name in a:
            if not torch.equal(a[name], b[name]):
                raise AssertionError(f"{what} step {i}: {name} differs "
                                     "across fresh sims")
    print(f"{what}: a fresh sim with the same seed is bit-identical")
    per_node = node_times(sim, acts)
    print(f"{what}, ms/step by node (synchronized): " + ", ".join(
        f"{k} {v * 1e3:.2f}" for k, v in per_node.items()) + f" ({card})")
    return sim, outs, sps, ms, launches


def check_card_vs_cpu(make_sim, make_env, what):
    """Phases 9 and 15: ``make_env()`` at 8 worlds on the card against the
    port's CPU path: int exports equal, float exports within SMALL_TOL."""
    import torch

    acts = make_env().random_actions(np.random.RandomState(5), SMALL_STEPS,
                                     SMALL_W)
    sims = {d: make_sim(make_env(), num_worlds=SMALL_W, seed=3, device=d)
            for d in ("cpu", DEV)}
    worst = 0.0
    for i in range(SMALL_STEPS):
        o = {d: s.step({"action": acts[i].to(d),
                        "reset": torch.zeros(SMALL_W, dtype=torch.int32,
                                             device=d)})
             for d, s in sims.items()}
        for name, g in o[DEV].items():
            c, g = o["cpu"][name], g.cpu()
            if g.is_floating_point():
                worst = max(worst, float((g - c).abs().max()))
            elif not torch.equal(g, c):
                raise AssertionError(f"{what} small run step {i}: {name} "
                                     "differs")
    if not worst <= SMALL_TOL:
        raise AssertionError(f"{what} card vs CPU: {worst} > {SMALL_TOL}")
    print(f"{what} card vs CPU path: {SMALL_W} worlds x {SMALL_STEPS} steps, "
          f"int exports equal, float max_abs_diff={worst!r}")


def check_rollout(make_sim, rollout, EscapeRoom, kernels, card):
    """Phase 17: rollout of Escape Room at W worlds for ROLLOUT_STEPS
    steps of bench.py's actions (RandomState(0)), through the episode
    resets. The first run counts the kernels' launches (each once a step)
    and every step's candidate occupancy at the shipped caps (no world
    may overflow: tests/test_escape_room.py's long-rollout assertion);
    done must be 1 at exactly the last step of each episode, for every
    world; every export and the final state finite. A second run from a
    fresh sim, timed (host clock, synchronized at both ends), must give
    the same exports bit for bit."""
    import torch
    from madrona_tpu_torch.models import escape_room as er
    from madrona_tpu_torch.physics import api as papi

    env = EscapeRoom()
    acts = env.random_actions(np.random.RandomState(0), ROLLOUT_STEPS, W)
    inputs = {"action": acts.to(DEV),
              "reset": torch.zeros((ROLLOUT_STEPS, W), dtype=torch.int32,
                                   device=DEV)}
    find = papi.find_candidates_kernel
    zero = lambda: torch.zeros((), dtype=torch.int32, device=DEV)  # noqa
    occ = {"hh": zero(), "hp": zero(), "sp": zero(), "overflow": zero()}

    def watched(body, om, caps, dt):
        c = find(body, om, caps, dt)
        occ["hh"] = torch.maximum(occ["hh"], c.hh_num.max())
        occ["hp"] = torch.maximum(occ["hp"], c.hp_num.max())
        occ["sp"] = torch.maximum(occ["sp"], c.sp_num.max())
        occ["overflow"] = occ["overflow"] + c.overflow.sum(dtype=torch.int32)
        return c

    sim = make_sim(env, num_worlds=W, seed=0, device=DEV)
    papi.find_candidates_kernel = watched
    try:
        for k in kernels:
            k.launches = 0
        outs = rollout(sim, inputs)
        launches = [k.launches for k in kernels]
    finally:
        papi.find_candidates_kernel = find
    for k, n in zip(kernels, launches):
        print(f"rollout: {k.symbol} launched {n} times in {ROLLOUT_STEPS} "
              "steps")
        if n != ROLLOUT_STEPS:
            raise AssertionError(f"rollout: {k.symbol} {n} launches != "
                                 f"{ROLLOUT_STEPS}")
    occ = {k: int(v) for k, v in occ.items()}
    print(f"rollout: largest candidate lists over {ROLLOUT_STEPS} steps x "
          f"{W} worlds: hh {occ['hh']}/{env.caps.hull_hull}, hp "
          f"{occ['hp']}/{env.caps.hull_plane}, sp {occ['sp']}/"
          f"{env.caps.sphere_any}; (world, step)s that overflowed "
          f"{occ['overflow']}")
    if occ["overflow"]:
        raise AssertionError("rollout: a candidate list overflowed its cap")
    done = outs["done"]
    want = torch.zeros_like(done)
    want[er.EPISODE_LEN - 1::er.EPISODE_LEN] = 1
    if tuple(done.shape) != (ROLLOUT_STEPS, W) or not torch.equal(done, want):
        ends = sorted({int(i) + 1 for i in torch.nonzero(done)[:, 0]})
        raise AssertionError(f"rollout: done at steps {ends}, not only at "
                             f"every {er.EPISODE_LEN}th")
    for name, v in outs.items():
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            raise AssertionError(f"rollout: export {name} not finite")
    for name, col in sim.state.tables[er.RIGID_BODY].columns.items():
        for leaf in (col.values() if isinstance(col, dict) else [col]):
            if leaf.is_floating_point() and not bool(
                    torch.isfinite(leaf).all()):
                raise AssertionError(f"rollout: final {name} not finite")
    print(f"rollout: done at steps {er.EPISODE_LEN}, {2 * er.EPISODE_LEN} "
          f"of {ROLLOUT_STEPS} for all {W} worlds and nowhere else; exports "
          "and final body state finite")

    again = make_sim(EscapeRoom(), num_worlds=W, seed=0, device=DEV)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs2 = rollout(again, inputs)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    for name in outs:
        if not torch.equal(outs[name], outs2[name]):
            raise AssertionError(f"rollout: {name} differs across fresh sims")
    print(f"rollout: {W} worlds x {ROLLOUT_STEPS} steps in {secs:.3f} s, "
          f"{W * ROLLOUT_STEPS / secs:.1f} env-steps/s; a fresh sim's "
          f"rollout bit-identical ({card})")


def step_ms(make_sim, make_env, acts):
    """ms per step of a fresh sim of ``make_env()`` at W worlds over
    steps 2..STEPS (host clock, synchronized at both ends)."""
    import torch

    sim = make_sim(make_env(), num_worlds=W, seed=0, device=DEV)
    reset = torch.zeros((W,), dtype=torch.int32, device=DEV)
    sim.step({"action": acts[0], "reset": reset})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(1, STEPS):
        sim.step({"action": acts[i], "reset": reset})
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / (STEPS - 1)


def check_hide_seek_small(make_sim, make_env, what="hide_seek"):
    """Phases 13 and 13c: ``make_env()`` (Hide & Seek with pixels) at 8
    worlds on the card against the port's CPU path."""
    import torch

    acts = make_env().random_actions(np.random.RandomState(5), SMALL_STEPS,
                                     SMALL_W)
    sims = {d: make_sim(make_env(), num_worlds=SMALL_W, seed=3, device=d)
            for d in ("cpu", DEV)}
    worst, worst_frac = 0.0, 0.0
    for i in range(SMALL_STEPS):
        o = {d: s.step({"action": acts[i].to(d),
                        "reset": torch.zeros(SMALL_W, dtype=torch.int32,
                                             device=d)})
             for d, s in sims.items()}
        for name, g in o[DEV].items():
            c, g = o["cpu"][name], g.cpu()
            if name in ("rgb", "depth"):
                bad = (g - c).abs() > PIX_TOL
                worst_frac = max(worst_frac, float(bad.float().mean()))
            elif g.is_floating_point():
                worst = max(worst, float((g - c).abs().max()))
            elif not torch.equal(g, c):
                raise AssertionError(f"{what} small step {i}: {name} "
                                     "differs")
    if not worst <= SMALL_TOL:
        raise AssertionError(f"{what} card vs CPU: {worst} > {SMALL_TOL}")
    if not worst_frac <= PIX_FRAC:
        raise AssertionError(f"{what} card vs CPU: pixel share "
                             f"{worst_frac} > {PIX_FRAC}")
    print(f"{what} card vs CPU path: {SMALL_W} worlds x {SMALL_STEPS} "
          f"steps, int exports equal, float max_abs_diff={worst!r}, share "
          f"of pixels off by more than {PIX_TOL}: {worst_frac!r}")
    return sims[DEV]


def world_slice(state, worlds, device):
    """The SimState of ``worlds`` (a list of world indices) copied to
    ``device``: every tensor with a leading worlds axis indexed there,
    through numpy as interop carries states between packages. A world's
    step reads only its own rows and keys, so the slice steps as those
    worlds of the whole batch do."""
    from madrona_tpu_torch.interop import state_from_numpy, state_to_numpy

    def pick(x):
        if isinstance(x, dict):
            return {k: pick(v) for k, v in x.items()}
        return x[worlds] if x.ndim else x

    return state_from_numpy(pick(state_to_numpy(state)), device)


def body_tree(state):
    """{name: [W, N, ...] tensor on the CPU} of the body state held to the
    golden bounds."""
    from madrona_tpu_torch.physics import api as papi

    c = state.tables[papi.RIGID_BODY].columns
    return {"Position": c["Position"].cpu(), "Rotation": c["Rotation"].cpu(),
            "linear": c["Velocity"]["linear"].cpu(),
            "angular": c["Velocity"]["angular"].cpu()}


GOLDEN = {"Position": POSE_TOL, "Rotation": POSE_TOL, "linear": VEL_TOL,
          "angular": OMEGA_TOL}


def outside_golden(got, ref):
    """{name: ([W, N] mask outside the bound, largest difference)}."""
    off = {}
    for k, tol in GOLDEN.items():
        d = (got[k] - ref[k]).abs().amax(-1)
        if float(d.max()) > tol:
            off[k] = (d > tol, float(d.max()))
    return off


def pile_run(make_sim, Pile, w, acts, counters=(), keep=0, save_at=()):
    """A fresh Pile() sim at ``w`` worlds stepped through ``acts`` [T, W]:
    (sim, the exports of the first ``keep`` steps, summary[:, 5] of every
    step [T, W], seconds of steps 2.., the counters' launches, {t: the
    state after t steps} for t in ``save_at``). Raises if an export of
    any step is not finite (checked once, after the run)."""
    import torch

    sim = make_sim(Pile(), num_worlds=w, seed=0, device=DEV)
    reset = torch.zeros((w,), dtype=torch.int32, device=DEV)
    for k in counters:
        k.launches = 0
    outs, flags, saved = [], [], {}
    finite = torch.ones((), dtype=torch.bool, device=DEV)
    t0 = None
    for i in range(acts.shape[0]):
        if i in save_at:
            saved[i] = sim.state
        if i == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out = sim.step({"action": acts[i], "reset": reset})
        flags.append(out["summary"][:, 5])
        finite &= torch.isfinite(out["summary"]).all() & torch.isfinite(
            out["reward"]).all()
        if i < keep:
            outs.append({k: v.clone() for k, v in out.items()})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if not bool(finite):
        raise AssertionError(f"pile {w} worlds: an export not finite")
    return (sim, outs, torch.stack(flags), secs,
            [k.launches for k in counters], saved)


def check_pile(make_sim, Pile, kernels, card):
    """Phase 18; returns ({worlds: ms a step}, the design-point run's
    actions and its states at PILE_CHECK_AT, for phase 20)."""
    import torch

    ms = {}
    w = PILE_W
    what = f"pile {w} worlds"
    acts = Pile.random_actions(np.random.RandomState(0), PILE_STEPS,
                               w).to(DEV)
    sim, outs, flags, secs, launches, saved = pile_run(
        make_sim, Pile, w, acts, kernels, keep=PILE_SAME_STEPS,
        save_at=PILE_CHECK_AT)
    if any(launches):
        raise AssertionError(f"{what}: kernels launched: " + ", ".join(
            f"{k.symbol} {n}" for k, n in zip(kernels, launches)))
    check_exports(outs, {"summary": (w, 6), "reward": (w,), "done": (w,)},
                  what)
    body = body_tree(sim.state)
    if not all(bool(torch.isfinite(v).all()) for v in body.values()):
        raise AssertionError(f"{what}: final body state not finite")
    if bool((flags[1:] < flags[:-1]).any()):
        raise AssertionError(f"{what}: summary[:, 5] fell within an episode")
    set_at = torch.where(flags.any(0), flags.int().argmax(0) + 1, 0).cpu()
    onsets = {int(wi): int(set_at[wi]) for wi in torch.nonzero(set_at)}
    ms[w] = secs * 1e3 / (PILE_STEPS - 1)
    summ = sim.state.singletons["Summary"]
    print(f"{what}: {PILE_STEPS} steps of bench.py's actions, no kernel "
          f"launched (counters {launches}), final mean height "
          f"{float(summ[:, 0].mean()):.3f}, rest fraction "
          f"{float(summ[:, 3].mean()):.3f}; summary[:, 5] set in "
          f"{len(onsets)} worlds, from step (world: step) {onsets}; "
          f"{ms[w]:.2f} ms/step, {w * (PILE_STEPS - 1) / secs:.1f} "
          f"env-steps/s ({card})")
    _, outs2, _, _, _, _ = pile_run(make_sim, Pile, w,
                                    acts[:PILE_SAME_STEPS],
                                    keep=PILE_SAME_STEPS)
    for i, (a, b) in enumerate(zip(outs, outs2)):
        for name in a:
            if not torch.equal(a[name], b[name]):
                raise AssertionError(f"{what} step {i}: {name} differs "
                                     "across fresh sims")
    print(f"{what}: exports finite and of the expected shapes; a fresh sim "
          f"bit-identical over {PILE_SAME_STEPS} steps")
    per_node = node_times(sim, acts)
    print(f"{what}, ms/step by node (synchronized): " + ", ".join(
        f"{k} {v * 1e3:.2f}" for k, v in per_node.items()) + f" ({card})")
    del outs, outs2, sim

    # the same point without shakes: the JAX package's settle condition
    zero = torch.zeros((PILE_STEPS, w), dtype=torch.int32, device=DEV)
    _, _, flags, _, launches, _ = pile_run(make_sim, Pile, w, zero, kernels)
    if any(launches) or float(flags.max()) != 0.0:
        steps = sorted({int(i) + 1 for i in torch.nonzero(flags)[:, 0]})
        raise AssertionError(f"{what} without shakes: summary[:, 5] set at "
                             f"steps {steps}, launches {launches}")
    print(f"{what} without shakes: {PILE_STEPS} steps, summary[:, 5] 0 at "
          "every step in every world, no kernel launched")

    w = PILE_BIG_W
    acts_big = Pile.random_actions(np.random.RandomState(0), PILE_BIG_STEPS,
                                   w).to(DEV)
    sim, outs, flags, secs, launches, _ = pile_run(
        make_sim, Pile, w, acts_big, kernels, keep=PILE_BIG_STEPS)
    if any(launches):
        raise AssertionError(f"pile {w} worlds: kernels launched {launches}")
    check_exports(outs, {"summary": (w, 6), "reward": (w,), "done": (w,)},
                  f"pile {w} worlds")
    ms[w] = secs * 1e3 / (PILE_BIG_STEPS - 1)
    print(f"pile {w} worlds: {PILE_BIG_STEPS} steps, exports finite, no "
          f"kernel launched, summary[:, 5] set in "
          f"{int(flags.any(0).sum())} worlds; {ms[w]:.2f} ms/step, "
          f"{w * (PILE_BIG_STEPS - 1) / secs:.1f} env-steps/s ({card})")
    return ms, acts, saved


def pair_sets(c, n):
    """[W, N+1, N+1] bool: the unordered candidate pairs of every list."""
    import torch

    w = c.hh.shape[0]
    adj = torch.zeros((w, n + 1, n + 1), dtype=torch.bool, device=c.hh.device)
    for buf, num in ((c.hh, c.hh_num), (c.hp, c.hp_num), (c.sp, c.sp_num)):
        live = (torch.arange(buf.shape[1], device=buf.device)[None]
                < num[:, None])
        a, b = buf[..., 0].long(), buf[..., 1].long()
        widx = torch.arange(w, device=buf.device)[:, None].expand_as(a)
        adj[widx[live], a[live], b[live]] = True
        adj[widx[live], b[live], a[live]] = True
    return adj


def check_swept_vs_b1(make_sim, Pile, broadphase_cuda):
    """Phase 19: the swept tier and B1 on real Pile(48) states."""
    import torch
    from madrona_tpu_torch.physics import api as papi
    from madrona_tpu_torch.physics import broadphase as bp

    env = Pile(num_bodies=PILE_SMALL_BODIES)
    n = env.n_total
    sim = make_sim(env, num_worlds=PILE_W, seed=2, device=DEV)
    om = env.om.to(DEV)
    acts = Pile.random_actions(np.random.RandomState(1), max(PILE_SWEPT_AT),
                               PILE_W).to(DEV)
    reset = torch.zeros((PILE_W,), dtype=torch.int32, device=DEV)
    for t in range(max(PILE_SWEPT_AT) + 1):
        if t in PILE_SWEPT_AT:
            body = papi.body_state(sim.executor.sm, sim.state)
            sw = bp.find_candidates_swept(body, om, env.caps, env.cfg.dt,
                                          window=env.cfg.broadphase_window)
            b1 = broadphase_cuda.find_candidates_kernel(body, om, env.caps,
                                                        env.cfg.dt)
            ok = ~(sw.overflow | b1.overflow)
            a, b = pair_sets(sw, n), pair_sets(b1, n)
            diff = (a != b).flatten(1).any(1) & ok
            if bool(diff.any()):
                raise AssertionError(
                    f"swept vs B1 at step {t}: pairs differ in worlds "
                    f"{torch.nonzero(diff).flatten().tolist()}")
            pairs = int(a[ok].sum()) // 2
            print(f"swept == B1 [pile {PILE_SMALL_BODIES} bodies, step {t}]: "
                  f"{int(ok.sum())} of {PILE_W} worlds without overflow, "
                  f"{pairs} candidate pairs, the same sets per world")
            if int(ok.sum()) == 0 or pairs == 0:
                raise AssertionError("swept vs B1: nothing to compare")
        if t < max(PILE_SWEPT_AT):
            sim.step({"action": acts[t], "reset": reset})


def check_pile_card_vs_cpu(make_sim, Pile, acts, saved):
    """Phase 20: PILE_CHECK_WORLDS of the design-point run's states at
    PILE_CHECK_AT, one step on the card and on the CPU."""
    import torch
    from madrona_tpu_torch.physics import api as papi

    worlds = list(PILE_CHECK_WORLDS)
    w = len(worlds)
    card_fn = make_sim(Pile(), num_worlds=w, seed=0, device=DEV).step_fn()
    cpu_fn = make_sim(Pile(), num_worlds=w, seed=0, device="cpu").step_fn()
    zeros = torch.zeros((w,), dtype=torch.int32)

    def nudged(state, f):
        t_rb = state.tables[papi.RIGID_BODY]
        cols = dict(t_rb.columns)
        cols["Position"] = cols["Position"] * f
        return dataclasses.replace(state, tables={
            **state.tables,
            papi.RIGID_BODY: dataclasses.replace(t_rb, columns=cols)})

    witnessed, worst, flags = [], {k: 0.0 for k in GOLDEN}, {}
    for t in PILE_CHECK_AT:
        inp = {"action": acts[t, worlds].cpu(), "reset": zeros}
        start = world_slice(saved[t], worlds, "cpu")
        c_next, c_out = card_fn(world_slice(saved[t], worlds, DEV),
                                {k: v.to(DEV) for k, v in inp.items()})
        p_next, p_out = cpu_fn(start, inp)
        if not torch.equal(c_out["done"].cpu(), p_out["done"]):
            raise AssertionError(f"pile card vs CPU step {t}: done")
        if not torch.equal(c_out["summary"][:, 4:].cpu(),
                           p_out["summary"][:, 4:]):
            raise AssertionError(f"pile card vs CPU step {t}: summary's "
                                 "episode step or overflow flag")
        flags[t + 1] = [wi for wi, f in zip(worlds, p_out["summary"][:, 5])
                        if f > 0]
        got, ref = body_tree(c_next), body_tree(p_next)
        for k in GOLDEN:
            worst[k] = max(worst[k], float((got[k] - ref[k]).abs().max()))
        off = outside_golden(got, ref)
        if not off:
            continue
        # a witness: the CPU itself, from the state with every position
        # scaled by 1 +- 1e-7, outside the same bound at the same place
        wit = {}
        for f in PILE_NUDGES:
            for k, (mask, _) in outside_golden(
                    body_tree(cpu_fn(nudged(start, f), inp)[0]), ref).items():
                wit[k] = wit[k] | mask if k in wit else mask
        for k, (mask, d) in off.items():
            if k not in wit or bool((mask & ~wit[k]).any()):
                raise AssertionError(f"pile card vs CPU step {t}: {k} off by "
                                     f"{d} with no witness")
        witnessed.append((t, {k: d for k, (_, d) in off.items()}))
    if len(witnessed) > PILE_MAX_WITNESSED:
        raise AssertionError(f"pile card vs CPU: witnessed {witnessed}")
    print(f"pile card vs CPU path: worlds {worlds} of the {PILE_W}-world run, "
          f"one step from the card's state after steps {PILE_CHECK_AT}: done "
          f"and summary[:, 4:] equal (overflow flag set after the step in "
          f"worlds {flags}), largest body differences {worst!r}; checks "
          f"with a witness {witnessed}")


def check_cartpole(make_sim, rollout, Cartpole, kernels, card):
    """Phase 21: Cartpole at bench.py's point; returns ms/step."""
    import torch
    from madrona_tpu_torch.models import cartpole as cp

    acts = Cartpole.random_actions(np.random.RandomState(0), CART_STEPS,
                                   CART_W)
    inputs = {"action": acts, "reset": torch.zeros((CART_STEPS, CART_W),
                                                   dtype=torch.int32)}
    card_in = {k: v.to(DEV) for k, v in inputs.items()}
    h = CART_ORACLE_STEPS
    sim = make_sim(Cartpole(), num_worlds=CART_W, seed=0, device=DEV)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = rollout(sim, card_in)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = [k.launches for k in kernels]
    if any(launches):
        raise AssertionError(f"cartpole: kernels launched {launches}")
    again = rollout(make_sim(Cartpole(), num_worlds=CART_W, seed=0,
                             device=DEV), {k: v[:h] for k, v in card_in.items()})
    for name in again:
        if not torch.equal(outs[name][:h], again[name]):
            raise AssertionError(f"cartpole: {name} differs across fresh sims")
    done = outs["done"].cpu()
    ms = secs * 1e3 / CART_STEPS
    print(f"cartpole: {CART_W} worlds x {CART_STEPS} steps through rollout, "
          f"no kernel launched, {int(done.sum())} episode ends, a fresh sim "
          f"bit-identical over {h} steps; {ms:.3f} ms/step, "
          f"{CART_W * CART_STEPS / secs:.1f} env-steps/s ({card})")

    cpu = rollout(make_sim(Cartpole(), num_worlds=CART_W, seed=0,
                           device="cpu"),
                  {k: v[:h] for k, v in inputs.items()})
    g_obs = outs["obs"][:h, :, 0].cpu()
    c_obs = cpu["obs"][:, :, 0]
    # a world is compared until its done schedule first differs
    flip = done[:h] != cpu["done"]
    first = torch.where(flip.any(0), flip.int().argmax(0), h)
    same_so_far = torch.arange(h)[:, None] < first[None, :]
    d = (g_obs - c_obs).abs().amax(-1)
    worst = float(torch.where(same_so_far, d, 0.0).max())
    if worst > CART_OBS_TOL:
        raise AssertionError(f"cartpole card vs CPU: obs off by {worst}")
    flips = []
    for wi in torch.nonzero(flip.any(0)).flatten().tolist():
        t = int(first[wi])
        margin = min((float(min(cp.X_LIMIT - o[0].abs(),
                                cp.THETA_LIMIT - o[2].abs(), key=abs))
                      for o in (g_obs[t, wi], c_obs[t, wi])), key=abs)
        flips.append((t + 1, wi, margin))
        if abs(margin) > CART_OBS_TOL:
            raise AssertionError(f"cartpole card vs CPU: done flips at step "
                                 f"{t + 1}, world {wi}, {margin} from a limit")
    told = ("equal" if not flips else "equal but for the flips (step, "
            f"world, distance to a limit) {flips}")
    print(f"cartpole card vs CPU path: {CART_W} worlds x {h} steps, done "
          f"schedule {told}, obs max_abs_diff={worst!r}")
    return ms


def check_projectiles(make_sim, Projectiles, kernels, card):
    """Phase 22: entity churn with one growth, card against CPU."""
    import torch

    sims = {d: make_sim(Projectiles(capacity=PROJ_CAP), num_worlds=PROJ_W,
                        seed=0, device=d, max_entities=64)
            for d in ("cpu", DEV)}
    for k in kernels:
        k.launches = 0
    grown, totals = {}, None
    for t in range(PROJ_STEPS):
        outs = {}
        for d, sim in sims.items():
            z = torch.zeros((PROJ_W,), dtype=torch.int32, device=d)
            outs[d] = sim.step({"action": z, "reset": z})
            if t == PROJ_GROW_AT:
                grown[d] = sim.executor.maybe_grow()
        g, c = sims[DEV].state, sims["cpu"].state
        tg, tc = g.tables["Projectile"], c.tables["Projectile"]
        ints = [("live", outs[DEV]["live"], outs["cpu"]["live"]),
                ("entity_id", tg.entity_id, tc.entity_id),
                ("entity_gen", tg.entity_gen, tc.entity_gen),
                ("num_rows", tg.num_rows, tc.num_rows),
                ("overflow", tg.overflow, tc.overflow)]
        ints += [(f"store.{f}", getattr(g.entities, f),
                  getattr(c.entities, f))
                 for f in ("gen", "arch", "row", "free_ids", "free_top")]
        ints += [(k, g.singletons[k], c.singletons[k])
                 for k in ("TotalSpawned", "TotalDestroyed", "LiveCount")]
        for name, a, b in ints:
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"projectiles card vs CPU step {t}: "
                                     f"{name} differs")
        live = (torch.arange(tc.entity_id.shape[1])[None]
                < tc.num_rows[:, None])
        d = (tg.columns["PPos"].cpu() - tc.columns["PPos"]).abs().amax(-1)
        if float(torch.where(live, d, 0.0).max()) > PROJ_POS_TOL:
            raise AssertionError(f"projectiles card vs CPU step {t}: "
                                 "positions off")
        totals = (int(c.singletons["TotalSpawned"].sum()),
                  int(c.singletons["TotalDestroyed"].sum()))
    if grown[DEV] != grown["cpu"] or not grown["cpu"]:
        raise AssertionError(f"projectiles: growth {grown}")
    launches = [k.launches for k in kernels]
    if any(launches):
        raise AssertionError(f"projectiles: kernels launched {launches}")
    print(f"projectiles card vs CPU path: {PROJ_W} worlds x {PROJ_STEPS} "
          f"steps, capacity {PROJ_CAP} grown to "
          f"{grown['cpu']['Projectile']} by maybe_grow after step "
          f"{PROJ_GROW_AT + 1}; {totals[0]} spawned, {totals[1]} destroyed; "
          "every integer output equal at every step, live positions within "
          f"{PROJ_POS_TOL}, no kernel launched ({card})")


def launches_per_step(sim, acts, steps=PROFILE_STEPS):
    """Device events (kernels, copies, fills) a step of ``sim.step``
    under torch.profiler, over ``steps`` steps of ``acts``; None where
    the profiler recorded no device time."""
    import torch

    reset = torch.zeros(acts.shape[1], dtype=torch.int32, device=DEV)
    it = iter(range(steps))
    return device_profile(
        lambda: sim.step({"action": acts[next(it)], "reset": reset}),
        steps)[0]


def check_discrete_env(make_sim, rollout, make_env, w, steps, kernels, card,
                       what, check_chunk, fresh_steps=None):
    """Phases 23-24: ``make_env()`` at ``w`` worlds for ``steps`` steps of
    its random_actions(RandomState(0)) through rollout, ENV_CHUNK steps a
    call; ``check_chunk(outs, first_step)`` returns {check: bool tensor}
    for each chunk. A fresh sim runs beside it for the first
    ``fresh_steps`` (default: all) and must be bit-identical, and the
    first ENV_CPU_W worlds on the CPU must be equal bit for bit.
    Returns (env-steps/s over the chunks after the first, launches a
    step or None)."""
    import torch

    acts = make_env().random_actions(np.random.RandomState(0), steps, w)
    zeros = torch.zeros((steps, w), dtype=torch.int32)
    card_in = {"action": acts.to(DEV), "reset": zeros.to(DEV)}
    cpu_in = {"action": acts[:, :ENV_CPU_W].contiguous(),
              "reset": zeros[:, :ENV_CPU_W].contiguous()}
    fresh_steps = steps if fresh_steps is None else fresh_steps
    sim, fresh = (make_sim(make_env(), num_worlds=w, seed=0, device=DEV)
                  for _ in range(2))
    cpu = make_sim(make_env(), num_worlds=ENV_CPU_W, seed=0, device="cpu")
    for k in kernels:
        k.launches = 0
    secs, timed = 0.0, 0
    for c0 in range(0, steps, ENV_CHUNK):
        part = slice(c0, min(c0 + ENV_CHUNK, steps))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = rollout(sim, {k: v[part] for k, v in card_in.items()})
        torch.cuda.synchronize()
        if c0:
            secs += time.perf_counter() - t0
            timed += part.stop - part.start
        checks = check_chunk(outs, c0)
        bad = [name for name, ok in checks.items() if not bool(ok)]
        if bad:
            raise AssertionError(f"{what}: steps {c0 + 1}-{part.stop}: "
                                 f"{bad} failed")
        again = (rollout(fresh, {k: v[part] for k, v in card_in.items()})
                 if c0 < fresh_steps else None)
        small = rollout(cpu, {k: v[part] for k, v in cpu_in.items()})
        for name, v in outs.items():
            if again is not None and not torch.equal(v, again[name]):
                raise AssertionError(f"{what}: {name} differs across fresh "
                                     f"sims at steps {c0 + 1}-{part.stop}")
            if not torch.equal(v[:, :ENV_CPU_W].cpu(), small[name]):
                raise AssertionError(f"{what}: {name} of the first "
                                     f"{ENV_CPU_W} worlds differs from the "
                                     f"CPU's at steps {c0 + 1}-{part.stop}")
        del outs, again
    launches = [k.launches for k in kernels]
    if any(launches):
        raise AssertionError(f"{what}: kernels launched {launches}")
    per_step = launches_per_step(sim, card_in["action"])
    rate = w * timed / secs
    print(f"{what}: {w} worlds x {steps} steps through rollout, checks "
          f"{sorted(checks)} held at every step, a fresh sim bit-identical "
          f"over {min(fresh_steps, steps)} steps, "
          f"the first {ENV_CPU_W} worlds equal to the CPU's bit for bit, no "
          f"kernel launched; {secs * 1e3 / timed:.3f} ms/step, "
          f"{rate:.1f} env-steps/s, "
          + (f"{per_step:.0f} launches/step" if per_step is not None
             else "launches/step not measured (no device time profiled)")
          + f" ({card})")
    return rate, per_step


def hanabi_checks(players):
    """check_chunk for Hanabi: tokens in range, a legal move, the score."""
    from madrona_tpu_torch.models import hanabi as H

    info0 = H.N_COLORS * (H.N_RANKS + 1)
    lives0 = info0 + H.MAX_INFO + 1

    def check(outs, first_step):
        obs = outs["obs"]
        return {
            "info token in [0, 8]":
                (obs[..., info0:lives0].sum(-1) == 1).all(),
            "life tokens in [0, 3]":
                (obs[..., lives0:lives0 + H.MAX_LIVES + 1].sum(-1) == 1
                 ).all(),
            "a legal move": (outs["legal_moves"].sum(-1) >= 1).all(),
            "score in [0, 25]": ((outs["score"] >= 0)
                                 & (outs["score"] <= 25)).all(),
            "cur_player in range": ((outs["cur_player"] >= 0)
                                    & (outs["cur_player"] < players)).all(),
        }
    return check


def overcooked_checks(outs, first_step):
    """check_chunk for Overcooked: the episode clock, the agents in the
    observation, the rewards."""
    import torch
    from madrona_tpu_torch.models import overcooked as OC

    t = torch.arange(first_step, first_step + outs["done"].shape[0],
                     device=outs["done"].device)[:, None]
    clock = t % OC.EPISODE_LEN + 1
    obs = outs["obs"]                               # [T, W, 2, H, W, 16]
    return {
        "steps_taken is the episode clock":
            (outs["steps_taken"] == clock).all(),
        "done only at the episode's end":
            (outs["done"] == (clock == OC.EPISODE_LEN).int()).all(),
        "one own and one other agent":
            ((obs[..., 0].sum((-1, -2)) == 1)
             & (obs[..., 5].sum((-1, -2)) == 1)).all(),
        "reward a multiple of 20": ((outs["reward"] >= 0)
                                    & (outs["reward"] % 20 == 0)).all(),
        "deliveries >= 0": (outs["deliveries"] >= 0).all(),
    }


def check_reinforce(make_sim, Cartpole, TrainInterface, reinforce, kernels,
                    card):
    """Phase 25: TrainInterface and the REINFORCE learner on the card."""
    import torch

    torch.manual_seed(0)
    sim = make_sim(Cartpole(), num_worlds=LEARN_W, seed=0, device=DEV)
    ti = TrainInterface(sim)
    policy = reinforce.make_policy(sim.device)
    before = [p.detach().clone() for p in policy.parameters()]
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ep_len, losses = reinforce.train(ti, policy, REINFORCE_UPDATES,
                                     REINFORCE_HORIZON, log_every=0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    outs = ti.step_outputs
    off = [k for k, v in outs.items()
           if v.device.type != torch.device(DEV).type]
    if off:
        raise AssertionError(f"train interface: exports off the card {off}")
    other = "cpu" if DEV != "cpu" else "meta"   # "meta" in CPU rehearsals
    try:
        ti.torch_step(action=torch.zeros(LEARN_W, dtype=torch.int32,
                                         device=other),
                      reset=torch.zeros(LEARN_W, dtype=torch.int32,
                                        device=DEV))
    except ValueError:
        pass
    else:
        raise AssertionError(f"train interface: an input on {other} was "
                             "accepted")
    losses = torch.stack(losses).cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f"reinforce: losses {losses.tolist()}")
    moved = max(float((a.detach() - b).abs().max())
                for a, b in zip(policy.parameters(), before))
    if not moved > 0:
        raise AssertionError("reinforce: the parameters did not move")
    launches = [k.launches for k in kernels]
    if any(launches):
        raise AssertionError(f"reinforce: kernels launched {launches}")
    print(f"train interface + REINFORCE on cartpole: {LEARN_W} worlds, "
          f"{REINFORCE_UPDATES} updates of {REINFORCE_HORIZON} steps, "
          f"exports {sorted(outs)} on {outs['obs'].device}, an input on "
          f"{other} refused, losses {[round(x, 4) for x in losses.tolist()]}, "
          f"parameters moved by up to {moved:.4g}, episode length "
          f"{ep_len:.1f}; {REINFORCE_UPDATES / secs:.3f} updates/s "
          f"({card})")


def check_ppo_overcooked(ppo, ppo_oc, kernels, card):
    """Phase 26: PPO on Overcooked on the card."""
    import torch

    cfg = dataclasses.replace(ppo.PPOConfig(), horizon=PPO_HORIZON,
                              ent_coef=0.02, lr=5e-4)
    sim, pi, v, obs_of = ppo_oc.make_train(LEARN_W, cfg, seed=0, device=DEV)
    gen = ppo.generator(7, sim.device)
    params = list(pi.parameters()) + list(v.parameters())
    before = [p.detach().clone() for p in params]
    step_fn = sim.step_fn()
    state = sim.state
    for k in kernels:
        k.launches = 0
    losses, secs = [], 0.0
    for u in range(PPO_UPDATES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, frames = ppo.update(step_fn, state, pi, v, gen, cfg, obs_of,
                                   keep=("deliveries",))
        torch.cuda.synchronize()
        if u:
            secs += time.perf_counter() - t0
        losses += frames["losses"]
    losses = torch.stack(losses).cpu()
    if not torch.isfinite(losses).all():
        raise AssertionError(f"ppo overcooked: losses {losses.tolist()}")
    if not all(torch.isfinite(p).all() for p in params):
        raise AssertionError("ppo overcooked: parameters not finite")
    moved = max(float((a.detach() - b).abs().max()) for a, b in zip(params, before))
    if not moved > 0:
        raise AssertionError("ppo overcooked: the parameters did not move")
    launches = [k.launches for k in kernels]
    if any(launches):
        raise AssertionError(f"ppo overcooked: kernels launched {launches}")
    print(f"PPO on overcooked: {LEARN_W} worlds, {PPO_UPDATES} updates of "
          f"horizon {PPO_HORIZON} on {frames['obs'].device}, losses finite "
          f"(last {float(losses[-1]):.4f}), parameters moved by up to "
          f"{moved:.4g}; {(PPO_UPDATES - 1) / secs:.3f} updates/s after the "
          f"first ({card})")


# ---------------------------------------------------------------------------
# Phases 27-30: the physics toolkit's paths


STACK_CAPS = (2, 4, 4)    # box-box; box-plane x2; sphere-plane, sphere-box x2


def stack_arrays(w, seed=0):
    """numpy rows of the box stack with a sphere (phase 29 and the
    Gauss-Seidel and TGS tests): a static plane, two boxes (z 0.6 and
    1.58), a sphere dropped from z 3.0 onto them off center, the stack
    moved as one per world; (pos, rot, vel) [w, 4, ...], and the joints:
    a fixed joint between the boxes in the odd worlds (slot 0), a hinge
    about y in the even worlds (slot 1), each holding the boxes face to
    face."""
    rs = np.random.RandomState(seed)
    pos = np.zeros((w, 4, 3), np.float32)
    pos[:, 1] = [0, 0, 0.6]
    pos[:, 2] = [0, 0, 1.58]
    pos[:, 3] = [0.1, 0, 3.0]
    pos[:, 1:, :2] += rs.uniform(-0.5, 0.5, (w, 1, 2)).astype(np.float32)
    pos[:, 3, :2] += rs.uniform(-0.2, 0.2, (w, 2)).astype(np.float32)
    rot = np.zeros((w, 4, 4), np.float32)
    rot[..., 0] = 1
    vel = np.zeros((w, 4, 3), np.float32)
    vel[:, 3] = rs.uniform(-0.3, 0.3, (w, 3)).astype(np.float32)
    odd = np.arange(w) % 2 == 1
    f32 = lambda *v: np.array(v, np.float32)   # noqa: E731
    joints = (
        ("fixed", dict(slot=0, e1=1, e2=2, attach_q1=f32(1, 0, 0, 0),
                       attach_q2=f32(1, 0, 0, 0), r1=f32(0, 0, 0.5),
                       r2=f32(0, 0, -0.5), separation=0.0, worlds=odd)),
        ("hinge", dict(slot=1, e1=1, e2=2, a1_local=f32(0, 1, 0),
                       a2_local=f32(0, 1, 0), r1=f32(0, 0, 0.5),
                       r2=f32(0, 0, -0.5), worlds=~odd)),
    )
    return pos, rot, vel, joints


def body_values(arr, pos, rot, vel, obj, resp):
    """The RigidBody component values of make_entities from numpy rows,
    ``arr`` making each array a tensor of the package."""
    z3 = np.zeros_like(pos)
    return {
        "Position": arr(pos), "Rotation": arr(rot),
        "Scale": arr(np.ones_like(pos)), "ObjectID": arr(obj),
        "ResponseType": arr(resp),
        "Velocity": {"linear": arr(vel), "angular": arr(z3)},
        "ExternalForce": arr(z3), "ExternalTorque": arr(z3),
        "SubstepPrev": {"x": arr(pos), "q": arr(rot)},
        "PreSolvePositional": {"x": arr(pos), "q": arr(rot)},
        "PreSolveVelocity": {"v": arr(z3), "omega": arr(z3)},
    }


def physics_executor(cfg, caps, w, device, n_bodies, objects, max_joints=0,
                     max_events=0):
    """(executor, ObjectManager) of a scene that is only the physics
    node: ``objects(registry, geo)`` registers the object types."""
    from madrona_tpu_torch.core.registry import ECSRegistry
    from madrona_tpu_torch.core.state import StateManager
    from madrona_tpu_torch.graph.builder import TaskGraphBuilder
    from madrona_tpu_torch.graph.executor import Executor
    from madrona_tpu_torch.physics import api as papi
    from madrona_tpu_torch.physics import bodies, geo

    sm = StateManager()
    reg = ECSRegistry(sm)
    papi.register_types(reg, max_bodies=n_bodies)
    if max_joints:
        papi.register_joint_types(reg, max_joints=max_joints)
    if max_events:
        papi.register_collision_events(reg, max_events=max_events)
        reg.export_singleton(papi.COLLISION_EVENTS, "events")
    om_r = bodies.ObjectRegistry()
    objects(om_r, geo)
    om = om_r.build()
    b = TaskGraphBuilder(sm, "step")
    papi.setup_physics_step_tasks(b, om, cfg, caps)
    return Executor(sm, {"step": b.build()}, num_worlds=w, seed=0,
                    device=device), om


def stack_scene(cfg, w, device, seed=0):
    """The box stack with a sphere in the port: (executor, ObjectManager,
    CandidateCaps) with the state of stack_arrays(w, seed)."""
    import torch
    from madrona_tpu_torch.physics import api as papi
    from madrona_tpu_torch.physics import bodies
    from madrona_tpu_torch.physics import joints as jt
    from madrona_tpu_torch.physics.broadphase import CandidateCaps

    def objects(reg, geo):
        reg.add_hull(geo.box_hull((0.5, 0.5, 0.5)), mass=1.0)      # 0
        reg.add_plane()                                            # 1
        reg.add_sphere(0.5, mass=1.0)                              # 2

    caps = CandidateCaps(*STACK_CAPS)
    ex, om = physics_executor(cfg, caps, w, device, 4, objects, max_joints=2)
    pos, rot, vel, joints = stack_arrays(w, seed)
    obj = np.tile([1, 0, 0, 2], (w, 1)).astype(np.int32)
    resp = np.tile([bodies.RESPONSE_STATIC] + [bodies.RESPONSE_DYNAMIC] * 3,
                   (w, 1)).astype(np.int32)
    arr = lambda a: torch.from_numpy(a).to(device)   # noqa: E731
    state, _ = ex.sm.make_entities(
        ex.state, papi.RIGID_BODY, body_values(arr, pos, rot, vel, obj, resp),
        torch.ones((w, 4), dtype=torch.bool, device=device))
    buf = papi.joints_view(state)
    for kind, kw in joints:
        make = jt.make_fixed_joint if kind == "fixed" else jt.make_hinge_joint
        buf = make(buf, **kw)
    ex.state = papi.write_joints(state, buf)
    return ex, om, caps


def events_objects(reg, geo):
    """Register the events scene's object types in either package's
    ObjectRegistry: a unit box that turns about z only, as the Escape
    Room's agents do (0), and the plane (1)."""
    reg.add_hull(geo.box_hull((0.5, 0.5, 0.5)), mass=1.0,
                 inertia_diag=np.array([np.inf, np.inf, 1.0 / 6.0],
                                       np.float32))
    reg.add_plane()


def events_arrays(w, seed=0):
    """numpy rows of the events scene (phase 27 and the CollisionEvents
    test): a static plane and four pairs of boxes side by side, dropped
    from z 0.6-1.2 onto the plane and pushed into each other by a
    constant external force of EV_PUSH along x (ExternalForce is the
    env's, kept across steps), so the pairs hold hull-hull contacts;
    jittered by up to 0.05, turned about z by up to 0.2 rad. Returns
    (pos, rot, vel, force, obj, resp) [w, 9, ...]."""
    from madrona_tpu_torch.physics import bodies

    rs = np.random.RandomState(seed)
    grid = np.array([[x + dx, y, 0.6 + 0.2 * k] for k, (x, y) in enumerate(
        (x, y) for y in (-1.5, 1.5) for x in (-1.6, 1.6))
        for dx in (-0.52, 0.52)], np.float32)
    pos = np.zeros((w, 9, 3), np.float32)
    pos[:, 1:] = grid + rs.uniform(-0.05, 0.05, (w, 8, 3))
    half = rs.uniform(-0.1, 0.1, (w, 8))
    rot = np.zeros((w, 9, 4), np.float32)
    rot[..., 0] = 1
    rot[:, 1:, 0] = np.cos(half)
    rot[:, 1:, 3] = np.sin(half)
    vel = np.zeros((w, 9, 3), np.float32)
    force = np.zeros((w, 9, 3), np.float32)
    force[:, 1::2, 0] = EV_PUSH
    force[:, 2::2, 0] = -EV_PUSH
    obj = np.tile([1] + [0] * 8, (w, 1)).astype(np.int32)
    resp = np.tile([bodies.RESPONSE_STATIC] + [bodies.RESPONSE_DYNAMIC] * 8,
                   (w, 1)).astype(np.int32)
    return pos, rot, vel, force, obj, resp


def events_scene(w, device, seed=0, max_events=EV_MAX_EVENTS):
    """Phase 27's scene (events_arrays) through the entity store. The
    boxes turn about z only: with contacts frozen for a step
    (narrowphase_once, which the export needs), a box that can tip is
    thrown up by a hull-hull contact, in the JAX package as in the port.
    Broadphase "pallas" (B1), narrowphase "kernel_sublane" (B6),
    megakernel (B3), CollisionEvents of ``max_events`` slots. Returns
    (executor, ObjectManager, config, entity handles [w, 9, 2])."""
    import torch
    from madrona_tpu_torch.physics import api as papi
    from madrona_tpu_torch.physics.broadphase import CandidateCaps
    from madrona_tpu_torch.physics.xpbd import PhysicsConfig

    cfg = PhysicsConfig(narrowphase_once=True, megakernel=True,
                        broadphase="pallas", narrowphase="kernel_sublane",
                        jacobi_iters=1)
    ex, om = physics_executor(cfg, CandidateCaps(*EV_CAPS), w, device, 9,
                              events_objects, max_events=max_events)
    pos, rot, vel, force, obj, resp = events_arrays(w, seed)
    arr = lambda a: torch.from_numpy(a).to(device)   # noqa: E731
    values = body_values(arr, pos, rot, vel, obj, resp)
    values["ExternalForce"] = arr(force)
    ex.state, ents = ex.sm.make_entities(
        ex.state, papi.RIGID_BODY, values,
        torch.ones((w, 9), dtype=torch.bool, device=device))
    return ex, om, cfg, ents


def nudged(state, f):
    """``state`` with every body position scaled by ``f``."""
    from madrona_tpu_torch.physics import api as papi

    t_rb = state.tables[papi.RIGID_BODY]
    cols = dict(t_rb.columns)
    cols["Position"] = cols["Position"] * f
    return dataclasses.replace(state, tables={
        **state.tables, papi.RIGID_BODY: dataclasses.replace(t_rb,
                                                             columns=cols)})


def body_vs_cpu(what, t, card_next, cpu_fn, start, inp, worst, witnessed):
    """The card's body state after one step against the CPU's from the
    same state ``start`` (phase 20's rule): within the golden bounds, or
    outside one only where the CPU itself, from the state with every
    position scaled by 1 +- 1e-7, is outside it at the same (world,
    body). Returns the CPU's next state."""
    p_next = cpu_fn(start, inp)[0]
    got, ref = body_tree(card_next), body_tree(p_next)
    for k in GOLDEN:
        worst[k] = max(worst[k], float((got[k] - ref[k]).abs().max()))
    off = outside_golden(got, ref)
    if off:
        wit = {}
        for f in PILE_NUDGES:
            for k, (mask, _) in outside_golden(
                    body_tree(cpu_fn(nudged(start, f), inp)[0]), ref).items():
                wit[k] = wit[k] | mask if k in wit else mask
        for k, (mask, d) in off.items():
            if k not in wit or bool((mask & ~wit[k]).any()):
                raise AssertionError(f"{what} card vs CPU step {t}: {k} off "
                                     f"by {d} with no witness")
        witnessed.append((t, {k: d for k, (_, d) in off.items()}))
    return p_next


def frozen_contacts(ex, om, cfg, state):
    """The contacts the physics node freezes for a step of ``state``
    (broadphase, predicted poses, the narrowphase of cfg's tier)."""
    from madrona_tpu_torch.ops.broadphase_cuda import find_candidates_kernel
    from madrona_tpu_torch.physics import api as papi
    from madrona_tpu_torch.physics import xpbd
    from madrona_tpu_torch.physics.broadphase import CandidateCaps

    body = papi.body_state(ex.sm, state)
    om_d = om.to(body.pos.device)
    cands = find_candidates_kernel(body, om_d, CandidateCaps(*EV_CAPS),
                                   cfg.dt)
    pred = xpbd.integrate(body, om_d, cfg.dt / cfg.substeps, cfg.gravity)
    return papi._narrowphase_mixed_kernel(pred, om_d, cands, True)


def want_of(kernels, per_kernel):
    """Each counter's expected launches: its value in ``per_kernel``,
    else 0."""
    return [per_kernel.get(k, 0) for k in kernels]


def expect_launches(what, kernels, launches, want):
    for k, n, must in zip(kernels, launches, want):
        if n != must:
            raise AssertionError(f"{what}: {k.symbol} launched {n} times, "
                                 f"expected {must}")
    print(f"{what}: launches " + ", ".join(
        f"{k.symbol} {n}" for k, n in zip(kernels, launches)))


def events_consistent(ev, table):
    """[] bool on the device: the singleton's invariants (num in [0, K],
    overflow only with num == K, live slots naming two distinct live rows
    with their entity handles, the rest -1)."""
    import torch

    k = ev["row_a"].shape[1]
    num = ev["num"]
    live = torch.arange(k, device=num.device) < num[:, None]
    n_rows = table.entity_id.shape[1]
    ok = ((num >= 0) & (num <= k)).all()
    ok &= ((ev["overflow"] == 0) | ((ev["overflow"] == 1) & (num == k))).all()
    for r, h in (("row_a", "a"), ("row_b", "b")):
        rows = ev[r]
        ok &= torch.where(live, (rows >= 0) & (rows < n_rows),
                          rows == -1).all()
        rc = rows.long().clamp(0, n_rows - 1)
        want = torch.stack([torch.gather(table.entity_gen, 1, rc),
                            torch.gather(table.entity_id, 1, rc)], -1)
        ok &= torch.where(live[..., None], ev[h] == want, ev[h] == -1).all()
    return ok & torch.where(live, ev["row_a"] != ev["row_b"], True).all()


def check_events(kernels, card):
    """Phase 27: the CollisionEvents export at EV_W worlds for EV_STEPS
    steps through B1, B6 and B3 (each once a step, no other kernel); the
    singleton's invariants at every step; ms a step, the export's share,
    launches and device busy share a step; 8 worlds carried to the CPU
    after EV_CHECK_AT steps, one step on both: every integer of the
    singleton equal, except in a world where some contact lane is live
    on one side only and its depth there is within EV_DEPTH_MARGIN of
    zero (a witness), and the body state within the golden bounds (phase
    20's rule); at most MAX_WITNESSED witnesses. Returns the launches."""
    import torch
    from madrona_tpu_torch.ops import broadphase_cuda, solver_cuda
    from madrona_tpu_torch.ops import hh_narrowphase_cuda as hhc
    from madrona_tpu_torch.physics import api as papi

    what = f"events {EV_W} worlds"
    ex, om, cfg, _ = events_scene(EV_W, DEV)
    step = ex.step_fn()
    for k in kernels:
        k.launches = 0
    state, saved = ex.state, {}
    ok = torch.ones((), dtype=torch.bool, device=DEV)
    fired = torch.zeros((EV_W,), dtype=torch.bool, device=DEV)
    clamped = torch.zeros((EV_W,), dtype=torch.bool, device=DEV)
    t0 = None
    for t in range(EV_STEPS):
        if t in EV_CHECK_AT:
            saved[t] = state
        if t == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state, out = step(state, {})
        ev = out["events"]
        ok &= events_consistent(ev, state.tables[papi.RIGID_BODY])
        ok &= torch.isfinite(state.tables[papi.RIGID_BODY].columns[
            "Position"]).all()
        fired |= ev["num"] > 0
        clamped |= ev["overflow"] > 0
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (EV_STEPS - 1)
    launches = [k.launches for k in kernels]
    expect_launches(what, kernels, launches, want_of(kernels, {
        broadphase_cuda.KERNEL: EV_STEPS, solver_cuda.KERNEL: EV_STEPS,
        hhc.KERNEL: EV_STEPS, hhc.TIERS[True]: EV_STEPS}))
    if not bool(ok):
        raise AssertionError(f"{what}: an event buffer broke its invariants "
                             "or a position is not finite")
    last = out["events"]
    frozen = frozen_contacts(ex, om, cfg, state)
    # the export makes no host sync: torch raises on one in this mode
    torch.cuda.set_sync_debug_mode("error")
    try:
        papi._write_collision_events(state, frozen)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ev_ms = timed(lambda: papi._write_collision_events(state, frozen), 50)
    per_step, busy_ms = device_profile(lambda: step(state, {}), 3)
    print(f"{what}: {EV_STEPS} steps, events in {int(fired.sum())} worlds, "
          f"{int((last['num'] > 0).sum())} at the last step (mean "
          f"{float(last['num'].float().mean()):.2f} a world), clamped to "
          f"{EV_MAX_EVENTS} in {int(clamped.sum())} worlds; {ms:.3f} ms/step, "
          f"the export {ev_ms:.4f} ms ({ev_ms / ms:.4f} of the step), "
          f"{per_step} device events and {busy_ms} device ms a step (busy "
          f"{busy_ms / ms if busy_ms else 0:.4f}) ({card})")
    if not bool(fired.all()):
        raise AssertionError(f"{what}: a world without events")

    # 8 worlds, one step on the card and on the CPU
    card_ex = events_scene(len(CHECK_WORLDS), DEV)[0]
    cpu_ex = events_scene(len(CHECK_WORLDS), "cpu")[0]
    card_fn, cpu_fn = card_ex.step_fn(), cpu_ex.step_fn()
    witnessed, body_wit = [], []
    worst = {k: 0.0 for k in GOLDEN}
    for t, st in saved.items():
        c_start = world_slice(st, list(CHECK_WORLDS), DEV)
        p_start = world_slice(st, list(CHECK_WORLDS), "cpu")
        c_next, c_out = card_fn(c_start, {})
        p_out = cpu_fn(p_start, {})[1]
        body_vs_cpu("events", t, c_next, cpu_fn, p_start, {}, worst,
                    body_wit)
        differ = torch.zeros(len(CHECK_WORLDS), dtype=torch.bool)
        for f, v in c_out["events"].items():
            d = v.cpu() != p_out["events"][f]
            differ |= d.reshape(d.shape[0], -1).any(1)
        if not bool(differ.any()):
            continue
        fc = frozen_contacts(card_ex, om, cfg, c_start)
        fp = frozen_contacts(cpu_ex, om, cfg, p_start)
        c_live, p_live = fc.num.cpu() > 0, fp.num > 0
        depth = torch.where(c_live, fc.points.cpu()[..., 3].amax(-1),
                            fp.points[..., 3].amax(-1))
        flip = c_live != p_live
        for wi in torch.nonzero(differ)[:, 0].tolist():
            lanes = torch.nonzero(flip[wi])[:, 0]
            if not len(lanes) or float(depth[wi, lanes].abs().max()) > \
                    EV_DEPTH_MARGIN:
                raise AssertionError(
                    f"events card vs CPU step {t}: world "
                    f"{CHECK_WORLDS[wi]} differs, flipped lanes "
                    f"{lanes.tolist()} depths {depth[wi, lanes].tolist()}")
            witnessed.append((t, CHECK_WORLDS[wi], depth[wi, lanes].tolist()))
    if len(witnessed) + len(body_wit) > MAX_WITNESSED:
        raise AssertionError(f"events card vs CPU: witnessed {witnessed} "
                             f"{body_wit}")
    print(f"events card vs CPU path: worlds {list(CHECK_WORLDS)}, one step "
          f"from the card's state after steps {EV_CHECK_AT}: every integer "
          f"of CollisionEvents equal (witnessed worlds {witnessed}), largest "
          f"body differences {worst!r}, body checks with a witness "
          f"{body_wit}")
    return launches, ms


def check_tgs(make_sim, EscapeRoom, kernels, card):
    """Phase 28: Escape Room at solver="tgs", narrowphase="kernel_sublane",
    TGS_W worlds, TGS_STEPS steps of random_actions(RandomState(0)): B1
    and B4 once a step, B6 at every substep, no other kernel; exports
    finite and the agents on the floor (0.4 < z < 1.2) at every step; ms,
    launches and device busy share a step; 8 worlds carried to the CPU
    after TGS_CHECK_AT steps, one step on both within the golden bounds
    (phase 20's rule). Returns the launches."""
    import torch
    from madrona_tpu_torch.ops import broadphase_cuda, lidar_cuda
    from madrona_tpu_torch.ops import hh_narrowphase_cuda as hhc
    from madrona_tpu_torch.models import escape_room as er
    from madrona_tpu_torch.physics import api as papi

    what = f"escape_room tgs {TGS_W} worlds"

    def make_env():
        return with_physics(EscapeRoom(), solver="tgs",
                            narrowphase="kernel_sublane")

    acts = EscapeRoom.random_actions(np.random.RandomState(0), TGS_STEPS,
                                     TGS_W).to(DEV)
    sim = make_sim(make_env(), num_worlds=TGS_W, seed=0, device=DEV)
    reset = torch.zeros((TGS_W,), dtype=torch.int32, device=DEV)
    for k in kernels:
        k.launches = 0
    ok = torch.ones((), dtype=torch.bool, device=DEV)
    z_lo = torch.full((), 1e9, device=DEV)
    z_hi = torch.full((), -1e9, device=DEV)
    saved, t0 = {}, None
    for t in range(TGS_STEPS):
        if t in TGS_CHECK_AT:
            saved[t] = sim.state
        if t == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        out = sim.step({"action": acts[t], "reset": reset})
        for v in out.values():
            if v.is_floating_point():
                ok &= torch.isfinite(v).all()
        z = sim.state.tables[papi.RIGID_BODY].columns["Position"][
            :, er.ROW_AGENT0:er.ROW_AGENT0 + er.N_AGENTS, 2]
        z_lo = torch.minimum(z_lo, z.min())
        z_hi = torch.maximum(z_hi, z.max())
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (TGS_STEPS - 1)
    launches = [k.launches for k in kernels]
    per_sub = sim.env.cfg.substeps
    expect_launches(what, kernels, launches, want_of(kernels, {
        broadphase_cuda.KERNEL: TGS_STEPS, lidar_cuda.KERNEL: TGS_STEPS,
        hhc.KERNEL: per_sub * TGS_STEPS,
        hhc.TIERS[True]: per_sub * TGS_STEPS}))
    if not bool(ok):
        raise AssertionError(f"{what}: an export not finite")
    if not (float(z_lo) > 0.4 and float(z_hi) < 1.2):
        raise AssertionError(f"{what}: agents left the floor: z in "
                             f"[{float(z_lo)}, {float(z_hi)}]")
    it = iter(range(3))
    per_step, busy_ms = device_profile(lambda: sim.step(
        {"action": acts[next(it)], "reset": reset}), 3)
    print(f"{what}: {TGS_STEPS} steps, exports finite, agents' z in "
          f"[{float(z_lo):.4f}, {float(z_hi):.4f}]; {ms:.3f} ms/step, "
          f"{TGS_W * 1e3 / ms:.1f} env-steps/s, {per_step} device events and {busy_ms} device ms "
          f"a step (busy {busy_ms / ms if busy_ms else 0:.4f}) ({card})")

    worlds = list(CHECK_WORLDS)
    w = len(worlds)
    card_fn = make_sim(make_env(), num_worlds=w, seed=0, device=DEV).step_fn()
    cpu_fn = make_sim(make_env(), num_worlds=w, seed=0,
                      device="cpu").step_fn()
    zeros = torch.zeros((w,), dtype=torch.int32)
    witnessed, worst = [], {k: 0.0 for k in GOLDEN}
    for t, st in saved.items():
        inp = {"action": acts[t, worlds].cpu(), "reset": zeros}
        c_next = card_fn(world_slice(st, worlds, DEV),
                         {k: v.to(DEV) for k, v in inp.items()})[0]
        body_vs_cpu("escape_room tgs", t, c_next, cpu_fn,
                    world_slice(st, worlds, "cpu"), inp, worst, witnessed)
    if len(witnessed) > MAX_WITNESSED:
        raise AssertionError(f"escape_room tgs card vs CPU: {witnessed}")
    print(f"escape_room tgs card vs CPU path: worlds {worlds}, one step from "
          f"the card's state after steps {TGS_CHECK_AT}: largest body "
          f"differences {worst!r}; checks with a witness {witnessed}")
    return launches, ms


def check_gauss_seidel(kernels, card):
    """Phase 29: the box stack with a sphere and joints (stack_scene) at
    solver="gauss_seidel", GS_W worlds, GS_STEPS steps: B1 once a step,
    no other kernel; positions finite; ms, launches and device busy share
    a step; 8 worlds carried to the CPU after GS_CHECK_AT steps, one step
    on both within the golden bounds (phase 20's rule). Returns the
    launches."""
    import torch
    from madrona_tpu_torch.ops import broadphase_cuda
    from madrona_tpu_torch.physics import api as papi
    from madrona_tpu_torch.physics.xpbd import PhysicsConfig

    what = f"gauss_seidel stack {GS_W} worlds"
    cfg = PhysicsConfig(solver="gauss_seidel", dt=1.0 / 60.0)
    ex, _, _ = stack_scene(cfg, GS_W, DEV)
    step = ex.step_fn()
    for k in kernels:
        k.launches = 0
    state, saved, t0 = ex.state, {}, None
    for t in range(GS_STEPS):
        if t in GS_CHECK_AT:
            saved[t] = state
        if t == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        state = step(state, {})[0]
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (GS_STEPS - 1)
    launches = [k.launches for k in kernels]
    expect_launches(what, kernels, launches, want_of(kernels, {
        broadphase_cuda.KERNEL: GS_STEPS}))
    pos = state.tables[papi.RIGID_BODY].columns["Position"]
    if not bool(torch.isfinite(pos).all()):
        raise AssertionError(f"{what}: a position is not finite")
    per_step, busy_ms = device_profile(lambda: step(state, {}), 1)
    print(f"{what}: {GS_STEPS} steps, positions finite, top box z mean "
          f"{float(pos[:, 2, 2].mean()):.4f}; {ms:.3f} ms/step, "
          f"{per_step} device events and {busy_ms} device ms a step (busy "
          f"{busy_ms / ms if busy_ms else 0:.4f}) ({card})")

    worlds = list(CHECK_WORLDS)
    card_fn = stack_scene(cfg, len(worlds), DEV)[0].step_fn()
    cpu_fn = stack_scene(cfg, len(worlds), "cpu")[0].step_fn()
    witnessed, worst = [], {k: 0.0 for k in GOLDEN}
    for t, st in saved.items():
        c_next = card_fn(world_slice(st, worlds, DEV), {})[0]
        at = {k: 0.0 for k in GOLDEN}
        body_vs_cpu("gauss_seidel", t, c_next, cpu_fn,
                    world_slice(st, worlds, "cpu"), {}, at, witnessed)
        print(f"gauss_seidel card vs CPU path, one step from the card's "
              f"state after step {t}: largest differences position "
              f"{at['Position']!r}, rotation {at['Rotation']!r}, velocity "
              f"{at['linear']!r}, omega {at['angular']!r}")
        worst = {k: max(v, at[k]) for k, v in worst.items()}
    if len(witnessed) > MAX_WITNESSED:
        raise AssertionError(f"gauss_seidel card vs CPU: {witnessed}")
    print(f"gauss_seidel card vs CPU path: worlds {worlds}, one step from "
          f"the card's state after steps {GS_CHECK_AT}: largest body "
          f"differences {worst!r}; checks with a witness {witnessed}")
    return launches, ms


def check_queries(sim, card):
    """Phase 30: on the main path's Escape Room state (W worlds),
    raycast_bodies with 2 agents x QUERY_RAYS horizontal rays each (its
    own row excluded) and hull_hull_distance2 for every pair of hull rows,
    on the card against the CPU: hit rows equal and t within 1e-5
    relative over all worlds; squared distances within GJK_TOL relative
    (floored at 1) on the first QUERY_CPU_W worlds."""
    import math

    import torch
    from madrona_tpu_torch.models import escape_room as er
    from madrona_tpu_torch.physics import api as papi
    from madrona_tpu_torch.physics import geo, gjk
    from madrona_tpu_torch.physics import narrowphase as np_
    from madrona_tpu_torch.physics import query
    from madrona_tpu_torch.utils import math3d as m3

    body = papi.body_state(sim.executor.sm, sim.state)
    w, n = body.obj_id.shape
    ang = torch.arange(QUERY_RAYS, device=DEV) * (2 * math.pi / QUERY_RAYS)
    local = torch.stack([torch.sin(ang), torch.cos(ang),
                         torch.zeros_like(ang)], -1)
    rows = torch.arange(er.ROW_AGENT0, er.ROW_AGENT0 + er.N_AGENTS,
                        device=DEV)
    a = er.N_AGENTS
    dirs = m3.quat_rotate(
        body.rot[:, rows, None, :].expand(w, a, QUERY_RAYS, 4),
        local.expand(w, a, QUERY_RAYS, 3)).reshape(w, -1, 3)
    origins = body.pos[:, rows, None, :].expand(w, a, QUERY_RAYS, 3).reshape(
        w, -1, 3)
    excl = rows[None, :, None].expand(w, a, QUERY_RAYS).reshape(w, -1).to(
        torch.int32)

    def rays(b, om_, o, d, x):
        return query.raycast_bodies(b, om_, o, d, 200.0, exclude_row=x)

    om_c, om_p = sim.env.om.to(DEV), sim.env.om
    body_p = dataclasses.replace(body, **{
        f.name: getattr(body, f.name).cpu() for f in dataclasses.fields(body)})
    t_c, r_c = rays(body, om_c, origins, dirs, excl)
    t_p, r_p = rays(body_p, om_p, origins.cpu(), dirs.cpu(), excl.cpu())
    if not torch.equal(r_c.cpu(), r_p):
        raise AssertionError("raycast_bodies card vs CPU: rows differ at "
                             f"{int((r_c.cpu() != r_p).sum())} rays")
    rel = ((t_c.cpu() - t_p).abs() / t_p.abs().clamp(min=1.0)).max()
    if float(rel) > 1e-5:
        raise AssertionError(f"raycast_bodies card vs CPU: t off by {rel}")
    ray_ms = timed(lambda: rays(body, om_c, origins, dirs, excl), 20)

    # every pair of hull rows, each a convex vertex cloud in world space
    hull_rows = torch.nonzero(om_p.prim_type[body_p.obj_id[0].long()]
                              == geo.TYPE_HULL)[:, 0].to(DEV)
    iu, ju = torch.triu_indices(len(hull_rows), len(hull_rows), 1,
                                device=DEV)
    iu, ju = hull_rows[iu], hull_rows[ju]

    def distances(b, om_, worlds):
        hw = np_.hull_to_world(
            om_, b.obj_id[:worlds].reshape(-1),
            b.pos[:worlds].reshape(-1, 3), b.rot[:worlds].reshape(-1, 4),
            b.scale[:worlds].reshape(-1, 3))
        v = hw.verts.reshape(worlds, n, -1, 3)
        m = hw.verts_mask.reshape(worlds, n, -1)
        i, j = iu.to(v.device), ju.to(v.device)
        return gjk.hull_hull_distance2(v[:, i], m[:, i], v[:, j], m[:, j])

    d_c = distances(body, om_c, w)
    d_p = distances(body_p, om_p, QUERY_CPU_W)
    rel_d = ((d_c[:QUERY_CPU_W].cpu() - d_p).abs()
             / d_p.abs().clamp(min=1.0)).max()
    if not (float(rel_d) <= GJK_TOL and bool(torch.isfinite(d_c).all())):
        raise AssertionError(f"hull_hull_distance2 card vs CPU: {rel_d}")
    gjk_ms = timed(lambda: distances(body, om_c, w), 3, 1)
    print(f"raycast_bodies: {w} worlds x {r_c.shape[1]} rays, "
          f"{float((r_c >= 0).float().mean()):.4f} hit, card == CPU rows, t "
          f"within {float(rel):.3g} relative; {ray_ms:.3f} ms a call. "
          f"hull_hull_distance2: {w} worlds x {len(iu)} pairs, "
          f"{float((d_c == 0).float().mean()):.4f} of them touching, card "
          f"vs CPU ({QUERY_CPU_W} worlds) within {float(rel_d):.3g} "
          f"relative; {gjk_ms:.2f} ms a call ({card})")


# ---------------------------------------------------------------------------
# Phases 31-33: the asset importers, the pixel learner, checkpoints

ASSET_W = 1024            # worlds of the imported scene's render
ASSET_VIEWS = 4
ASSET_RENDER = 64
ASSET_TEX = 64            # the atlas's texture size
ASSET_PLAIN_W = 4         # worlds of the plain BLAS tier's ray_chunk check
ASSET_CHUNK = 256         # the ray_chunk held against the default
WALK_RAYS = 1 << 16       # rays of the walkers' check
WALK_T_TOL = 1e-4         # the 4-wide walker's t against the binary one's
PIX_W = 256               # examples/train_ppo_pixels.py's defaults
PIX_RENDER = 16
PIX_UPDATES = (("dense", 5), ("blas", 2))
PIX_PROFILED = "dense"    # the tier whose update is profiled
CKPT_W = 4096             # the Escape Room state saved and restored
CKPT_STEPS = 3
CKPT_PPO_W = 1024         # the Cartpole PPO run resumed from disk
CKPT_PPO_UPDATES = 2      # updates before and after the save


ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
         (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))  # (y0, x0, dy, dx)


def png_bytes(img, filters=0, palette=None, trns=None, depth=8,
              interlace=False):
    """A PNG file of ``img`` written with zlib: [H, W, C] samples with C =
    1 (grey), 2 (grey, alpha), 3 (RGB) or 4 (RGBA), uint8 or, at
    ``depth=16``, uint16; or, with ``palette`` [P, 3] uint8, [H, W]
    palette indices. Grey and palette images may be written at ``depth``
    1, 2 or 4 (the samples must fit). ``trns``: the palette's alphas, or
    a grey or RGB image's colour key (one value, or three). Every row is
    filtered by ``filters`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth;
    one value, or one a row, which ``interlace`` (Adam7) cycles through
    the passes' rows)."""
    import struct
    import zlib

    dtype = np.uint16 if depth == 16 else np.uint8
    img = np.asarray(img, dtype)
    if palette is not None:
        ctype, raw = 3, img[..., None]
    else:
        raw = img if img.ndim == 3 else img[..., None]
        ctype = {1: 0, 2: 4, 3: 2, 4: 6}[raw.shape[2]]
    h, w, n = raw.shape
    bpp = max(n * depth // 8, 1)
    kinds = np.asarray(filters).reshape(-1)

    def scanlines(px):
        """The unfiltered rows [h', bytes] of [h', w', n] samples."""
        if depth == 16:
            px = px.astype(">u2").view(np.uint8).reshape(
                px.shape[0], px.shape[1], 2 * n)
        if depth < 8:
            bits = (px[..., 0][..., None] >> np.arange(
                depth - 1, -1, -1, dtype=np.uint8)) & 1
            rows = np.packbits(bits.reshape(px.shape[0], -1), axis=1)
        else:
            rows = px.reshape(px.shape[0], -1)
        return rows.astype(np.int64)

    out = bytearray()
    row_no = 0
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    for y0, x0, dy, dx in passes:
        sub = raw[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = scanlines(sub)
        prior = np.zeros(rows.shape[1], np.int64)
        for x in rows:
            a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
            c = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
            b = prior
            k = int(kinds[row_no % len(kinds)])
            row_no += 1
            if k == 0:
                f = x
            elif k == 1:
                f = x - a
            elif k == 2:
                f = x - b
            elif k == 3:
                f = x - (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                f = x - np.where((pa <= pb) & (pa <= pc), a,
                                 np.where(pb <= pc, b, c))
            out.append(k)
            out += (f & 0xFF).astype(np.uint8).tobytes()
            prior = x

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    data = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace)))
    if palette is not None:
        data += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        data += chunk(b"tRNS", np.asarray(trns, np.uint8).tobytes()
                      if palette is not None else
                      np.asarray(trns, ">u2").reshape(-1).tobytes())
    return (data + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


def _grid_mesh(n, span):
    """A bumpy n x n height field over [-span, span]^2: (positions
    [n*n, 3], triangles [2 (n-1)^2, 3], per-vertex UVs [n*n, 2])."""
    rs = np.random.RandomState(5)
    xs = np.linspace(-span, span, n)
    z = rs.uniform(0.0, 0.4, (n, n))
    pos = np.stack([np.repeat(xs, n), np.tile(xs, n), z.ravel()], -1)
    tris = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            tris += [(a, a + n, a + n + 1), (a, a + n + 1, a + 1)]
    uv = (pos[:, :2] + span) / (2 * span)
    return (pos.astype(np.float32), np.asarray(tris, np.int32),
            uv.astype(np.float32))


def _cube():
    """A unit cube: (positions [8, 3], triangles [12, 3], UVs [8, 2])."""
    pos = np.array([[x, y, z] for z in (-1, 1) for y in (-1, 1)
                    for x in (-1, 1)], np.float32)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    tris = [(q[0], q[1], q[2]) for q in quads] + [(q[0], q[2], q[3])
                                                  for q in quads]
    uv = np.stack([(pos[:, 0] + 1) / 2, (pos[:, 2] + 1) / 2], -1)
    return pos, np.asarray(tris, np.int32), uv.astype(np.float32)


def _checker(s, colours):
    yy, xx = np.mgrid[0:s, 0:s]
    pick = ((yy // 2 + xx // 2) % 2).astype(bool)
    return np.where(pick[..., None], np.asarray(colours[1], np.uint8),
                    np.asarray(colours[0], np.uint8))


def _gltf_doc(pos, tris, uv, name, image):
    """(glTF document, binary buffer) of one textured triangle mesh;
    ``image``: {"uri": ...} or {"bufferView": i} (which this appends)."""
    blob = pos.tobytes() + uv.tobytes() + tris.astype(np.uint16).tobytes()
    n, t = len(pos), tris.size
    views = [{"buffer": 0, "byteOffset": 0, "byteLength": 12 * n},
             {"buffer": 0, "byteOffset": 12 * n, "byteLength": 8 * n},
             {"buffer": 0, "byteOffset": 20 * n, "byteLength": 2 * t}]
    doc = {
        "asset": {"version": "2.0"},
        "bufferViews": views,
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": n,
             "type": "VEC3"},
            {"bufferView": 1, "componentType": 5126, "count": n,
             "type": "VEC2"},
            {"bufferView": 2, "componentType": 5123, "count": t,
             "type": "SCALAR"}],
        "meshes": [{"name": name, "primitives": [{
            "attributes": {"POSITION": 0, "TEXCOORD_0": 1}, "indices": 2,
            "material": 0}]}],
        "materials": [{"name": name + "_mat", "pbrMetallicRoughness": {
            "baseColorFactor": [1.0, 0.9, 0.8, 1.0], "metallicFactor": 0.1,
            "roughnessFactor": 0.7, "baseColorTexture": {"index": 0}}}],
        "textures": [{"source": 0}],
        "images": [image],
    }
    return doc, blob


def write_gltf_quad(path, name, image, mime):
    """A .gltf quad whose base-colour texture ``image`` (file bytes of
    type ``mime``) and buffer are data URIs. Returns ``path``."""
    import base64
    import json

    quad = np.array([[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1]],
                    np.float32)
    quad_uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    doc, blob = _gltf_doc(quad, np.array([[0, 1, 2], [0, 2, 3]], np.int32),
                          quad_uv, name, {
                              "uri": f"data:{mime};base64,"
                              + base64.b64encode(image).decode()})
    doc["buffers"] = [{"uri": "data:application/octet-stream;base64,"
                       + base64.b64encode(blob).decode(),
                       "byteLength": len(blob)}]
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def write_glb_cube(path, name, image, mime):
    """A .glb cube whose base-colour texture ``image`` (file bytes of type
    ``mime``) lies in its binary chunk. Returns ``path``."""
    import json
    import struct

    cpos, ctris, cuv = _cube()
    doc, blob = _gltf_doc(cpos, ctris, cuv, name, {
        "bufferView": 3, "mimeType": mime})
    pad = -len(blob) % 4
    doc["bufferViews"].append({"buffer": 0, "byteOffset": len(blob) + pad,
                               "byteLength": len(image)})
    blob = blob + b"\0" * pad + image
    blob += b"\0" * (-len(blob) % 4)
    doc["buffers"] = [{"byteLength": len(blob)}]
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    glb = (struct.pack("<II", len(js), 0x4E4F534A) + js
           + struct.pack("<II", len(blob), 0x004E4942) + blob)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + len(glb)) + glb)
    return path


def write_assets(d):
    """Phase 31's files in directory ``d``, by this script's own
    writers: an OBJ with an MTL and a 24 x 20 RGBA PNG texture whose
    alpha runs below 255 (Paeth-filtered rows); a .gltf quad with a
    data-URI RGB PNG; a .glb cube whose PNG lies in its binary chunk;
    a .usda cube under two Xforms. Returns their paths."""
    paths = {}
    pos, tris, _ = _grid_mesh(12, 4.0)
    tex = np.zeros((20, 24, 4), np.uint8)
    tex[..., :3] = _checker(24, ((200, 60, 40), (40, 160, 60)))[:20]
    tex[..., 3] = np.linspace(40, 255, 24).astype(np.uint8)[None, :]
    with open(os.path.join(d, "ground.png"), "wb") as f:
        f.write(png_bytes(tex, filters=4))
    with open(os.path.join(d, "ground.mtl"), "w") as f:
        f.write("newmtl ground\nKd 0.9 0.85 0.8\nNs 200\n"
                "map_Kd ground.png\n")
    with open(os.path.join(d, "ground.obj"), "w") as f:
        f.write("mtllib ground.mtl\nusemtl ground\n")
        f.writelines(f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in pos)
        # negative (relative) indices on every other face
        nv = len(pos)
        f.writelines(
            f"f {a + 1} {b + 1} {c + 1}\n" if k % 2 else
            f"f {a - nv} {b - nv} {c - nv}\n"
            for k, (a, b, c) in enumerate(tris))
    paths["obj"] = os.path.join(d, "ground.obj")

    paths["gltf"] = write_gltf_quad(
        os.path.join(d, "quad.gltf"), "quad",
        png_bytes(_checker(8, ((255, 0, 0), (0, 0, 255))), filters=1),
        "image/png")
    paths["glb"] = write_glb_cube(
        os.path.join(d, "cube.glb"), "cube",
        png_bytes(_checker(16, ((250, 220, 40), (30, 30, 30))),
                  filters=[0, 1, 2, 3, 4] * 3 + [2]), "image/png")

    cpos = _cube()[0]
    pts = ", ".join(f"({x:g}, {y:g}, {z:g})" for x, y, z in cpos)
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6),
             (0, 2, 6, 4), (1, 5, 7, 3)]
    fvi = ", ".join(str(i) for q in quads for i in q)
    paths["usda"] = os.path.join(d, "pillar.usda")
    with open(paths["usda"], "w") as f:
        f.write(f'''#usda 1.0
def Xform "root"
{{
    double3 xformOp:translate = (2, 1.5, 0)
    uniform token[] xformOpOrder = ["xformOp:translate"]

    def Xform "tall" (
        kind = "component"
    )
    {{
        float3 xformOp:scale = (0.4, 0.4, 1.2)
        float3 xformOp:rotateXYZ = (0, 0, 30)
        uniform token[] xformOpOrder = ["xformOp:rotateXYZ", "xformOp:scale"]

        def Mesh "pillar"
        {{
            int[] faceVertexCounts = [4, 4, 4, 4, 4, 4]
            int[] faceVertexIndices = [{fvi}]
            point3f[] points = [{pts}]
        }}
    }}
}}
''')
    return paths


IMAGE_GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "tests", "goldens", "torch_images.npz")


def image_asset_png():
    """The OBJ's map_Kd texture of phase 31b: a 28 x 20 RGBA PNG at 16
    bits, Adam7-interlaced, alpha below 255, written by png_bytes."""
    rs = np.random.RandomState(9)
    yy, xx = np.mgrid[0:20, 0:28]
    img = np.stack([xx * 2300, yy * 3100, (xx * yy * 97) % 65536,
                    65535 - xx * 1800], -1) + rs.randint(0, 256, (20, 28, 4))
    return png_bytes(np.clip(img, 0, 65535).astype(np.uint16), depth=16,
                     interlace=True, filters=[0, 1, 2, 3, 4])


def load_image_goldens():
    """{name: file bytes}, {name: PIL's RGBA [H, W, 4] uint8} and
    {name: (the SHA-256 of PIL's RGBA, its shape)} of
    tests/goldens/torch_images.npz (written by
    tests/test_torch_image_decode.py with PIL, which the card's machine
    lacks)."""
    files, rgba, sha = {}, {}, {}
    with np.load(IMAGE_GOLDENS) as z:
        for k in z.files:
            name, kind = k.rsplit(".", 1)
            if kind == "file":
                files[name] = z[k].tobytes()
            elif kind == "rgba":
                rgba[name] = z[k]
            elif kind == "sha256":
                sha[name] = (z[k].tobytes(), tuple(z[name + ".shape"]))
    return files, rgba, sha


def write_image_assets(d, files):
    """Phase 31b's files in directory ``d``: a .glb cube whose base-colour
    texture is a 4:2:0 JPEG in its binary chunk (``files["glb_420"]``), a
    .gltf quad with a progressive JPEG as a data URI
    (``files["gltf_prog"]``), and an OBJ + MTL whose map_Kd is
    image_asset_png(). Returns their paths."""
    paths = {
        "glb": write_glb_cube(os.path.join(d, "jcube.glb"), "jcube",
                              files["glb_420"], "image/jpeg"),
        "gltf": write_gltf_quad(os.path.join(d, "jquad.gltf"), "jquad",
                                files["gltf_prog"], "image/jpeg"),
    }
    pos, tris, _ = _grid_mesh(10, 4.0)
    with open(os.path.join(d, "deep.png"), "wb") as f:
        f.write(image_asset_png())
    with open(os.path.join(d, "deep.mtl"), "w") as f:
        f.write("newmtl deep\nKd 0.8 0.9 1.0\nNs 100\nmap_Kd deep.png\n")
    with open(os.path.join(d, "deep.obj"), "w") as f:
        f.write("mtllib deep.mtl\nusemtl deep\n")
        f.writelines(f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in pos)
        f.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in tris)
    paths["obj"] = os.path.join(d, "deep.obj")
    return paths


def _write_obj(path, pos, tris, mtl, texture, tex_bytes, kd):
    """An OBJ whose MTL names ``texture`` (written from ``tex_bytes``) as
    its map_Kd."""
    d = os.path.dirname(path)
    with open(os.path.join(d, texture), "wb") as f:
        f.write(tex_bytes)
    with open(os.path.join(d, mtl + ".mtl"), "w") as f:
        f.write(f"newmtl {mtl}\nKd {kd}\nNs 50\nmap_Kd {texture}\n")
    with open(path, "w") as f:
        f.write(f"mtllib {mtl}.mtl\nusemtl {mtl}\n")
        f.writelines(f"v {x:.6f} {y:.6f} {z:.6f}\n" for x, y, z in pos)
        f.writelines(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in tris)
    return path


FORMAT_SCENE = ("tga_obj", "gif_gltf", "webp_glb", "bmp_obj", "webp_obj")
FORMAT_TEXTURES = {"tga_obj": "fmt_tga_rle", "gif_gltf": "fmt_gif_trns",
                   "webp_glb": "fmt_webp_alpha", "bmp_obj": "fmt_bmp_rle8",
                   "webp_obj": "fmt_webp_lossless"}


def write_format_assets(d, files):
    """Phase 31c's files in directory ``d``, textured with the golden
    files ``files[FORMAT_TEXTURES[k]]``: a ground grid OBJ + MTL with an
    RLE TGA (bottom-left origin), a .gltf quad with a GIF data URI (a
    transparency index), a .glb cube with a lossy WebP with ALPH in its
    binary chunk, and cube OBJs with an RLE8 BMP and a lossless WebP.
    Returns {FORMAT_SCENE name: path}."""
    tex = {k: files[v] for k, v in FORMAT_TEXTURES.items()}
    pos, tris, _ = _grid_mesh(10, 4.0)
    cpos, ctris, _ = _cube()
    return {
        "tga_obj": _write_obj(os.path.join(d, "field.obj"), pos, tris,
                              "field", "field.tga", tex["tga_obj"],
                              "0.9 0.9 0.8"),
        "gif_gltf": write_gltf_quad(os.path.join(d, "sign.gltf"), "sign",
                                    tex["gif_gltf"], "image/gif"),
        "webp_glb": write_glb_cube(os.path.join(d, "crate.glb"), "crate",
                                   tex["webp_glb"], "image/webp"),
        "bmp_obj": _write_obj(os.path.join(d, "post.obj"), cpos * 0.5,
                              ctris, "post", "post.bmp", tex["bmp_obj"],
                              "1 1 1"),
        "webp_obj": _write_obj(os.path.join(d, "box.obj"), cpos * 0.4,
                               ctris, "box", "box.webp", tex["webp_obj"],
                               "0.8 0.9 1"),
    }


def dds_bytes(w, h, body, *, fourcc=b"", dxgi=None, pfflags=None,
              bitcount=0, masks=(0, 0, 0, 0), mips=0):
    """A DDS file of ``w`` x ``h``: the 124-byte header (pixel format
    ``fourcc``, or "DX10" and its 20-byte header where ``dxgi`` is given;
    ``pfflags`` default to FOURCC where there is one) before ``body``."""
    import struct

    if dxgi is not None:
        fourcc = b"DX10"
    if pfflags is None:
        pfflags = 0x4 if fourcc else 0
    code = struct.unpack("<I", fourcc)[0] if fourcc else 0
    head = (struct.pack("<7I", 124, 0x1007 | (0x20000 if mips else 0), h, w,
                        0, 0, mips) + bytes(44)
            + struct.pack("<4I", 32, pfflags, code, bitcount)
            + struct.pack("<4I", *masks)
            + struct.pack("<5I", 0x1000 | (0x400008 if mips else 0), 0, 0,
                          0, 0))
    if dxgi is not None:
        head += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return b"DDS " + head + body


# phase 31d's 1024^2 files: name -> (DXGI format, bytes a 4 x 4 block)
BIG_DDS = {"fmt2_big_bc7": (98, 16), "fmt2_big_bc1": (71, 8)}


def big_dds_files(side=1024):
    """{name: DDS bytes} of BIG_DDS: random blocks of
    np.random.default_rng(19) behind a DX10 header (too random to store:
    the goldens keep the SHA-256 of their bytes and of PIL's RGBA)."""
    rng = np.random.default_rng(19)
    return {name: dds_bytes(side, side, rng.integers(
        0, 256, (side // 4) ** 2 * block, dtype=np.uint8).tobytes(),
        dxgi=dxgi) for name, (dxgi, block) in BIG_DDS.items()}


def lzw_bytes(data, old=False):
    """TIFF LZW of ``data`` as libtiff's encoder writes it: a clear code,
    9- to 12-bit codes most significant bit first, each width growing one
    code early, a clear code where the table reaches 4094, the end code
    last. ``old``: the old-style codes libtiff still reads (least
    significant bit first, each width growing at 2^n)."""
    out = bytearray()
    late = 1 if old else 0
    # codes and their widths first, packed into bits below
    codes, widths = [256], [9]
    nbits, free, limit, table, w = 9, 258, 511 + late, {}, -1
    get = table.get
    for c in data:
        if w < 0:
            w = c
            continue
        k = (w << 8) | c
        nxt = get(k)
        if nxt is not None:
            w = nxt
            continue
        codes.append(w)
        widths.append(nbits)
        table[k] = free
        w = c
        free += 1
        if free == 4094:
            codes.append(256)
            widths.append(nbits)
            table.clear()
            nbits, free, limit = 9, 258, 511 + late
        elif free > limit:
            nbits += 1
            limit = (1 << nbits) - 1 + late
    if w >= 0:
        codes.append(w)
        widths.append(nbits)
        free += 1
        if free == 4094:
            codes.append(256)
            widths.append(nbits)
            nbits = 9
        elif free > limit:
            nbits += 1
    codes.append(257)
    widths.append(nbits)
    # each code's bits, in order of significance, then bytes
    c = np.asarray(codes, np.uint32)
    wd = np.asarray(widths, np.int64)
    k = np.arange(12)
    if old:
        bits = (c[:, None] >> k) & 1                       # LSB first
    else:
        bits = (c[:, None] >> (wd[:, None] - 1 - k).clip(0)) & 1
    stream = bits[k[None, :] < wd[:, None]].astype(np.uint8)
    out = np.packbits(stream, bitorder="little" if old else "big")
    return out.tobytes()


def packbits_bytes(data):
    """PackBits of ``data``: runs of 2 to 128 equal bytes, literals of up
    to 128 bytes between them."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i + 1
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 2:
            out += bytes((257 - (j - i), data[i]))
            i = j
            continue
        j = i + 1
        while j < n and j - i < 128 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out.append(j - i - 1)
        out += data[i:j]
        i = j
    return bytes(out)


# TIFF field types: struct code of one value
TIFF_TYPES = {1: "B", 2: "s", 3: "H", 4: "L", 6: "b", 7: "B", 8: "h",
              9: "l", 11: "f", 12: "d", 16: "Q"}


def tiff_rows(px, bits, end, fmt=1):
    """[r, n] uint8 rows of samples ``px`` [r, w, s] at ``bits`` bits
    (sample format ``fmt``: 1 unsigned, 2 signed, 3 float), in byte
    order ``end``; rows under 8 bits packed most significant first."""
    r, w, s = px.shape
    if bits < 8:
        v = px.reshape(r, w * s).astype(np.uint8)
        per = 8 // bits
        v = np.pad(v, ((0, 0), (0, -(w * s) % per))).reshape(r, -1, per)
        shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
        return (v << shifts).sum(-1, dtype=np.uint8)
    if bits == 12:
        v = px.reshape(r, w * s).astype(np.uint16)
        v = np.pad(v, ((0, 0), (0, (w * s) % 2))).reshape(r, -1, 2)
        b = np.stack([v[..., 0] >> 4, ((v[..., 0] & 15) << 4) | (v[..., 1] >> 8),
                      v[..., 1] & 255], -1).reshape(r, -1)
        return b[:, :(w * s * 12 + 7) // 8].astype(np.uint8)
    kind = {1: "u", 2: "i", 3: "f"}[fmt]
    dt = np.dtype(f"{end}{kind}{bits // 8}")
    return np.ascontiguousarray(px.astype(dt)).view(np.uint8).reshape(r, -1)


def _predict(px, bits, end, fmt, predictor, stride):
    """Rows of ``px`` [r, w, s] as bytes with ``predictor`` applied (2:
    each sample less the one ``stride`` before it, wrapping; 3: each
    float's bytes, most significant first, in planes, less the byte
    ``stride`` before)."""
    if predictor == 2:
        if bits not in (8, 16, 32):        # libtiff refuses it; write it
            return tiff_rows(px, bits, end, fmt)
        kind = "f" if fmt == 3 else "u"
        v = px.astype(f"{kind}{bits // 8}").view(f"u{bits // 8}").reshape(
            len(px), -1).copy()
        v[:, stride:] = v[:, stride:] - v[:, :-stride]
        return tiff_rows(v.reshape(px.shape), bits, end)
    if predictor == 3:
        r = len(px)
        b = np.ascontiguousarray(px.astype(f">f{bits // 8}")).view(
            np.uint8).reshape(r, -1, bits // 8)
        b = np.ascontiguousarray(b.transpose(0, 2, 1)).reshape(r, -1)
        b[:, stride:] = b[:, stride:] - b[:, :-stride]
        return b
    return tiff_rows(px, bits, end, fmt)


def tiff_bytes(px, *, end="<", big=False, **first):
    """A TIFF in byte order ``end`` ("<" or ">"), a BigTIFF where
    ``big``, of one image, whose keyword arguments are: samples ``px``
    [h, w, s] (ints, or floats with ``fmt`` 3); ``bits`` a sample (8),
    PhotometricInterpretation ``photo`` (2); strips of ``rows`` rows (all
    rows where None) or ``tile`` = (width, length) tiles padded with
    zeros; planar configuration ``planar`` (1); compression 1 (none), 5
    (LZW; ``old_lzw`` for the old-style codes), 8 or 32946 (Deflate) or
    32773 (PackBits) after ``predictor`` 1, 2 or 3; FillOrder ``fill``
    (2 reverses the bits of the stored bytes); SampleFormat ``fmt``,
    ExtraSamples ``extra``, ColorMap ``colormap``, Orientation
    ``orientation`` where given; ``tags`` {tag: (type, values)} added or
    replacing, ``drop`` tags left out, ``types`` {tag: type} for the
    written ones; the IFD before the data where ``ifd_first``; ``then``
    the keyword arguments (with ``px``) of a second image in a second
    IFD."""
    import struct
    import zlib

    out = bytearray(b"II" if end == "<" else b"MM")
    out += struct.pack(end + "HHHQ", 43, 8, 0, 0) if big else struct.pack(
        end + "HL", 42, 0)
    link = 8 if big else 4

    def add(px, bits=8, photo=2, compression=1, predictor=1, rows=None,
              tile=None, planar=1, fill=1, fmt=1, extra=None, colormap=None,
              orientation=None, old_lzw=False, tags=None, drop=(),
              types=None, then=None, ifd_first=False):
        nonlocal link
        px = np.asarray(px)
        h, w, s = px.shape
        planes = [px[..., p:p + 1] for p in range(s)] if planar == 2 else [px]
        chunks = []
        for plane in planes:
            if tile is None:
                step = rows or h
                parts = [plane[y:y + step] for y in range(0, h, step)]
            else:
                tw, tl = tile
                parts = []
                for y in range(0, h, tl):
                    for x in range(0, w, tw):
                        t = np.zeros((tl, tw, plane.shape[2]), plane.dtype)
                        part = plane[y:y + tl, x:x + tw]
                        t[:part.shape[0], :part.shape[1]] = part
                        parts.append(t)
            for part in parts:
                raw = _predict(part, bits, end, fmt, predictor,
                               part.shape[2]).tobytes()
                if compression == 5:
                    raw = lzw_bytes(raw, old_lzw)
                elif compression in (8, 32946):
                    raw = zlib.compress(raw)
                elif compression == 32773:
                    raw = packbits_bytes(raw)
                if fill == 2:
                    raw = bytes(int(f"{b:08b}"[::-1], 2) for b in raw)
                chunks.append(raw)
        off_type = 16 if big else 4
        entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * s),
                   259: (3, [compression]), 262: (3, [photo]),
                   277: (3, [s]), 284: (3, [planar])}
        if tile is None:
            entries[278] = (4, [rows or h])
            offs, counts = 273, 279
        else:
            entries[322], entries[323] = (4, [tile[0]]), (4, [tile[1]])
            offs, counts = 324, 325
        if predictor != 1:
            entries[317] = (3, [predictor])
        if fill != 1:
            entries[266] = (3, [fill])
        if fmt != 1:
            entries[339] = (3, [fmt] * s)
        if extra is not None:
            entries[338] = (3, list(extra))
        if colormap is not None:
            entries[320] = (3, list(colormap))
        if orientation is not None:
            entries[274] = (3, [orientation])
        entries.update(tags or {})
        for t, typ in (types or {}).items():
            if t in entries:
                entries[t] = (typ, entries[t][1])
        for t in drop:
            entries.pop(t, None)
        ifd_size = ((8 + 20 * (len(entries) + 2) + 8) if big
                    else (2 + 12 * (len(entries) + 2) + 4))
        ifd_at = None
        if ifd_first:
            ifd_at = len(out)
            out.extend(bytes(ifd_size))
        starts = []
        for raw in chunks:
            starts.append(len(out))
            out.extend(raw)
            if len(out) % 2:
                out.append(0)
        if offs not in drop:
            entries[offs] = (entries.get(offs, (off_type,))[0], starts)
        if counts not in drop:
            entries[counts] = (entries.get(counts, (off_type,))[0],
                               [len(c) for c in chunks])
        for t, typ in (types or {}).items():
            entries[t] = (typ, entries[t][1])
        fields = []
        room = 8 if big else 4
        for t in sorted(entries):
            typ, vals = entries[t]
            code = TIFF_TYPES[typ]
            if typ == 2:
                blob = vals if isinstance(vals, bytes) else bytes(vals)
                n = len(blob)
            elif typ in (1, 7) and isinstance(vals, bytes):
                blob, n = vals, len(vals)
            else:
                blob = struct.pack(end + f"{len(vals)}{code}", *vals)
                n = len(vals)
            if len(blob) > room:
                at = len(out)
                out.extend(blob)
                if len(out) % 2:
                    out.append(0)
                blob = struct.pack(end + ("Q" if big else "L"), at)
            fields.append((t, typ, n, blob.ljust(room, b"\0")))
        if ifd_at is None:
            ifd_at = len(out)
            out.extend(bytes(ifd_size))
        body = struct.pack(end + ("Q" if big else "H"), len(fields))
        for t, typ, n, blob in fields:
            body += struct.pack(end + ("HHQ" if big else "HHL"), t, typ,
                                n) + blob
        next_at = ifd_at + len(body)
        body += bytes(8 if big else 4)
        out[ifd_at:ifd_at + len(body)] = body
        struct.pack_into(end + ("Q" if big else "L"), out, link, ifd_at)
        link = next_at
        if then is not None:
            add(**then)

    add(px, **first)
    return bytes(out)


# phase 31e's 1024^2 files
BIG_TIFF = ("fmt3_big_lzw_rgba", "fmt3_big_deflate16")


@functools.lru_cache(maxsize=1)
def big_tiff_files(side=1024):
    """{name: TIFF bytes} of BIG_TIFF, built without PIL from
    np.random.default_rng(20): waves and noise as RGBA in LZW with the
    horizontal predictor in 16-row strips, and as 16-bit RGB in Deflate,
    256^2 tiles under planar configuration 2 (the goldens keep the
    SHA-256 of their bytes and of PIL's RGBA)."""
    rng = np.random.default_rng(20)
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float64)
    waves = np.stack([128 + 100 * np.sin(xx / 37 + yy / 53),
                      128 + 90 * np.cos(yy / 29 - xx / 61),
                      (xx * 3 + yy * 5) % 256, 255 - (xx + yy) / 8 % 256], -1)
    rgba = np.clip(waves + rng.integers(-2, 3, waves.shape), 0,
                   255).astype(np.uint8)
    rgb16 = (waves[..., :3] * 256
             + rng.integers(0, 256, (side, side, 3))).astype(np.uint16)
    return {BIG_TIFF[0]: tiff_bytes(rgba, extra=[2], compression=5,
                                    predictor=2, rows=16),
            BIG_TIFF[1]: tiff_bytes(rgb16, bits=16, compression=8,
                                    tile=(256, 256), planar=2)}


FORMAT3_SCENE = ("lzw_obj", "tiles_glb", "p4_gltf", "rgba16_obj",
                 "o6_obj")
FORMAT3_TEXTURES = {"lzw_obj": "fmt3_lzw_rgba",
                    "tiles_glb": "fmt3_deflate_tiles",
                    "p4_gltf": "fmt3_packbits_p4",
                    "rgba16_obj": "fmt3_rgba16_planar",
                    "o6_obj": "fmt3_miniswhite_o6"}


def write_format3_assets(d, files):
    """Phase 31e's files in directory ``d``, textured with the golden
    TIFFs ``files[FORMAT3_TEXTURES[k]]``: a ground grid OBJ + MTL with an
    RGBA LZW file with the horizontal predictor, a .glb cube with a tiled
    Deflate file in its binary chunk, a .gltf quad with a PackBits 4-bit
    palette file as a data URI, and cube OBJs with a 16-bit associated
    alpha file under planar configuration 2 and a MinIsWhite grey file at
    Orientation 6. Returns {FORMAT3_SCENE name: path}."""
    tex = {k: files[v] for k, v in FORMAT3_TEXTURES.items()}
    pos, tris, _ = _grid_mesh(10, 4.0)
    cpos, ctris, _ = _cube()
    return {
        "lzw_obj": _write_obj(os.path.join(d, "yard.obj"), pos, tris,
                              "yard", "yard.tif", tex["lzw_obj"],
                              "0.8 0.9 0.8"),
        "tiles_glb": write_glb_cube(os.path.join(d, "crate.glb"), "crate",
                                    tex["tiles_glb"], "image/tiff"),
        "p4_gltf": write_gltf_quad(os.path.join(d, "sign.gltf"), "sign",
                                   tex["p4_gltf"], "image/tiff"),
        "rgba16_obj": _write_obj(os.path.join(d, "post.obj"), cpos * 0.5,
                                 ctris, "post", "post.tiff",
                                 tex["rgba16_obj"], "1 1 1"),
        "o6_obj": _write_obj(os.path.join(d, "stone.obj"), cpos * 0.4,
                             ctris, "stone", "stone.tif", tex["o6_obj"],
                             "0.9 0.9 1"),
    }


FORMAT2_SCENE = ("bc1_obj", "bc7_glb", "qoi_gltf", "bc3_obj", "ppm_obj")
FORMAT2_TEXTURES = {"bc1_obj": "fmt2_dds_bc1_alpha",
                    "bc7_glb": "fmt2_dds_bc7_mips", "qoi_gltf": "fmt2_qoi",
                    "bc3_obj": "fmt2_dds_bc3_30x18",
                    "ppm_obj": "fmt2_ppm_1023"}


def write_format2_assets(d, files):
    """Phase 31d's files in directory ``d``, textured with the golden
    files ``files[FORMAT2_TEXTURES[k]]``: a ground grid OBJ + MTL with a
    BC1 DDS with punch-through alpha, a .glb cube with a BC7 DDS with a
    mip chain in its binary chunk, a .gltf quad with a QOI data URI, and
    cube OBJs with a 30 x 18 BC3 DDS and a binary P6 PPM at maxval 1023.
    Returns {FORMAT2_SCENE name: path}."""
    tex = {k: files[v] for k, v in FORMAT2_TEXTURES.items()}
    pos, tris, _ = _grid_mesh(10, 4.0)
    cpos, ctris, _ = _cube()
    return {
        "bc1_obj": _write_obj(os.path.join(d, "floor.obj"), pos, tris,
                              "floor", "floor.dds", tex["bc1_obj"],
                              "0.9 0.8 0.9"),
        "bc7_glb": write_glb_cube(os.path.join(d, "chest.glb"), "chest",
                                  tex["bc7_glb"], "image/vnd-ms.dds"),
        "qoi_gltf": write_gltf_quad(os.path.join(d, "banner.gltf"),
                                    "banner", tex["qoi_gltf"], "image/qoi"),
        "bc3_obj": _write_obj(os.path.join(d, "pillar.obj"), cpos * 0.5,
                              ctris, "pillar", "pillar.dds", tex["bc3_obj"],
                              "1 1 1"),
        "ppm_obj": _write_obj(os.path.join(d, "block.obj"), cpos * 0.4,
                              ctris, "block", "block.ppm", tex["ppm_obj"],
                              "0.8 1 0.9"),
    }


def merge_assets(parts):
    """One ImportedAssets of several: material and texture indices
    offset."""
    from madrona_tpu_torch.assets.importer import ImportedAssets

    meshes, mats, texs = [], [], []
    for a in parts:
        for m in a.meshes:
            meshes.append(dataclasses.replace(
                m, material=m.material + len(mats) if m.material >= 0
                else -1))
        for m in a.materials:
            mats.append(dataclasses.replace(
                m, texture=m.texture + len(texs) if m.texture >= 0 else -1))
        texs += a.textures
    return ImportedAssets(meshes, mats, texs)


def asset_scene(n_obj, w, views, device, seed=0):
    """Instances [W, I, ...] of the imported objects (the ground, the
    quad standing up, the cube, the pillar; each world shifted and
    turned a little) and cameras [W, V, ...] around them looking in."""
    import torch

    rs = np.random.RandomState(seed)
    base = np.array([[0, 0, 0], [-1.5, 1.0, 1.2], [0.5, -1.0, 1.0],
                     [0, 0, 0.4], [1.6, 0.9, 0.5]], np.float32)[:n_obj]
    pos = base[None] + rs.uniform(-0.3, 0.3, (w, n_obj, 3)).astype(
        np.float32) * np.array([1, 1, 0], np.float32)
    yaw = rs.uniform(-0.5, 0.5, (w, n_obj)).astype(np.float32)
    rot = np.zeros((w, n_obj, 4), np.float32)
    rot[..., 0] = np.cos(yaw / 2)
    rot[..., 3] = np.sin(yaw / 2)
    scale = np.ones((w, n_obj, 3), np.float32)
    obj = np.broadcast_to(np.arange(n_obj, dtype=np.int32), (w, n_obj))
    mask = np.ones((w, views, n_obj), bool)
    ang = (np.arange(views) / views * 2 * np.pi)[None, :] + rs.uniform(
        -0.2, 0.2, (w, 1))
    cam_pos = np.stack([5.5 * np.sin(ang), -5.5 * np.cos(ang),
                        np.full_like(ang, 2.2)], -1).astype(np.float32)
    # look toward the centre (+y turned by ang about z), pitched down
    q_yaw = np.stack([np.cos(ang / 2), 0 * ang, 0 * ang, np.sin(ang / 2)],
                     -1)
    pitch = -0.3
    q_pitch = np.array([np.cos(pitch / 2), np.sin(pitch / 2), 0, 0])
    cam_rot = np.stack([        # q_yaw * q_pitch
        q_yaw[..., 0] * q_pitch[0], q_yaw[..., 0] * q_pitch[1],
        q_yaw[..., 3] * q_pitch[1], q_yaw[..., 3] * q_pitch[0]],
        -1).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa
    return tuple(t(x) for x in (pos, rot, scale, obj, mask, cam_pos,
                                cam_rot))


def check_assets(kernels, card):
    """Phase 31. Returns (launches a counter, the render's planes,
    options and ray count for the timing line)."""
    import tempfile

    import torch
    from madrona_tpu_torch.assets.importer import (ImportedAssets,
                                                   import_assets)
    from madrona_tpu_torch.assets.usd import load_usd
    from madrona_tpu_torch.ops import raycast_cuda as rck
    from madrona_tpu_torch.render import blas as rblas
    from madrona_tpu_torch.render import kernel as rkernel
    from madrona_tpu_torch.render.lights import make_lights
    from madrona_tpu_torch.render.raycast import RenderConfig

    with tempfile.TemporaryDirectory() as d:
        paths = write_assets(d)
        parts = [import_assets(paths[k]) for k in ("obj", "gltf", "glb")]
        parts.append(ImportedAssets(load_usd(paths["usda"]), [], []))
    assets = merge_assets(parts)
    sizes = [a.data.shape[:2] for a in assets.textures]
    alpha = assets.textures[0].data[..., 3]
    if not (len(assets.meshes) == 4 and len(assets.textures) == 3
            and int(alpha.min()) < 255 and sizes[0] == (20, 24)
            and [m.material for m in assets.meshes] == [0, 1, 2, -1]):
        raise AssertionError(f"assets: imported {len(assets.meshes)} meshes,"
                             f" textures {sizes}")
    blas, mats, _ = rblas.bake_assets_blas(assets, tex_size=ASSET_TEX,
                                           device=DEV)
    tris = [len(m.indices) for m in assets.meshes]
    print(f"assets: {len(assets.meshes)} meshes of {tris} triangles "
          f"(OBJ + MTL, .gltf, .glb, .usda), textures {sizes} resampled to "
          f"{ASSET_TEX}^2 in the atlas, {len(assets.materials)} materials; "
          f"BLAS {tuple(blas.node_min.shape)} nodes, max leaf "
          f"{blas.max_leaf}")

    # B5 on the imported scene at full width
    cfg = RenderConfig(width=ASSET_RENDER, height=ASSET_RENDER, t_max=40.0,
                       shadows=True)
    scene = asset_scene(len(assets.meshes), ASSET_W, ASSET_VIEWS, DEV)
    lights = make_lights(ASSET_W, [{"direction": (0.3, -0.4, -1.0),
                                    "cast_shadow": True}], device=DEV)
    if not rkernel.kernel_eligible(cfg, blas, lights, 0, scene[0].shape[1]):
        raise AssertionError("assets: the scene is not the kernel's")
    for k in kernels:
        k.launches = 0
    rgb, dep = rblas.render_views_blas(cfg, blas, *scene, materials=mats,
                                       lights=lights)
    torch.cuda.synchronize()
    launches = [k.launches for k in kernels]
    want = want_of(kernels, {rck.KERNEL: 1})
    expect_launches("assets render_views_blas", kernels, launches, want)
    hit = float((dep < cfg.t_max).float().mean())
    if not (bool(torch.isfinite(rgb).all()) and 0.3 < hit < 1.0
            and tuple(rgb.shape) == (ASSET_W, ASSET_VIEWS, ASSET_RENDER,
                                     ASSET_RENDER, 3)):
        raise AssertionError(f"assets render: hit share {hit}, shape "
                             f"{tuple(rgb.shape)}")
    planes, opts, n_rays = rkernel.kernel_inputs(cfg, blas, *scene,
                                                 materials=mats,
                                                 lights=lights)
    worst, out = raycast_compare("imported assets", planes, opts)
    textured = float((planes[1][:, rck.A_TEX] >= 0).float().mean())
    print(f"assets render: {ASSET_W} worlds x {ASSET_VIEWS} views of "
          f"{ASSET_RENDER}^2 through the raycast kernel, hit share "
          f"{hit:.3f}, textured rows {textured:.3f}, occluded share "
          f"{float(out[:, rck.O_OCC, :n_rays].mean()):.3f}")

    # the walkers on the card: the same hits
    rs = np.random.RandomState(8)
    n_obj = len(assets.meshes)
    obj = torch.from_numpy(rs.randint(0, n_obj, WALK_RAYS).astype(
        np.int32)).to(DEV)
    # from above, toward points of the objects' unit box
    o = (rs.uniform(-4, 4, (WALK_RAYS, 3)) + [0, 0, 6]).astype(np.float32)
    dirs = (rs.uniform(-1, 1, (WALK_RAYS, 3)) - o).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    live = torch.from_numpy(rs.rand(WALK_RAYS) < 0.95).to(DEV)
    rays = (obj, torch.from_numpy(o).to(DEV), torch.from_numpy(dirs).to(DEV),
            live, 40.0)
    wide32 = rblas.widen_blas(blas)
    wide16 = rblas.widen_blas(blas, "bfloat16")
    hits = {
        "gather": rblas.trace_rays_blas(blas, *rays),
        "onehot": rblas.trace_rays_blas_onehot(blas, *rays),
        "wide f32": rblas.trace_rays_blas4(wide32, *rays),
        "wide bf16": rblas.trace_rays_blas4(wide16, *rays),
    }
    ref = hits["gather"]
    if not all(torch.equal(a, b) for a, b in zip(hits["onehot"], ref)):
        raise AssertionError("walkers: onehot != gather")
    hit_share = float((ref[1] >= 0).float().mean())
    for name in ("wide f32", "wide bf16"):
        t, tri = hits[name][:2]
        if not torch.equal(tri >= 0, ref[1] >= 0):
            raise AssertionError(f"walkers: {name} hits differ")
        h = ref[1] >= 0
        dt = float(((t - ref[0]).abs() / ref[0].abs().clamp(min=1.0))[h]
                   .max()) if bool(h.any()) else 0.0
        other = (tri != ref[1]) & h
        tie = ((t - ref[0]).abs() <= 1e-5 * ref[0].abs().clamp(min=1.0))
        if dt > WALK_T_TOL or not bool((tie | ~other).all()):
            raise AssertionError(f"walkers: {name} t off by {dt}")
        print(f"walkers [{name}] vs gather: hits equal ({hit_share:.3f} of "
              f"{WALK_RAYS} rays), t within {dt:.3g} relative, "
              f"{int(other.sum())} triangles differ at ties")
    print("walkers [onehot] vs gather: t, tri, u, v equal")

    # ray_chunk on the plain BLAS tier (the kernel tier off): the planes
    # of the default (1024-ray chunks) again
    few = tuple(x[:ASSET_PLAIN_W] for x in scene)
    lt = lights.map(lambda a: a[:ASSET_PLAIN_W])
    budget = rkernel.MAX_FLAT_TRIS
    rkernel.MAX_FLAT_TRIS = 0
    try:
        for k in kernels:
            k.launches = 0
        ref_p = rblas.render_views_blas(cfg, blas, *few, materials=mats,
                                        lights=lt)
        for walker, chunk in (("auto", ASSET_CHUNK), ("onehot", 0)):
            got_p = rblas.render_views_blas(
                dataclasses.replace(cfg, ray_chunk=chunk,
                                    blas_walker=walker), blas, *few,
                materials=mats, lights=lt)
            if not all(torch.equal(a, b) for a, b in zip(got_p, ref_p)):
                raise AssertionError(f"plain tier, walker {walker}, "
                                     f"ray_chunk {chunk}: planes differ")
        torch.cuda.synchronize()
        if any(k.launches for k in kernels):
            raise AssertionError("the plain BLAS tier launched a kernel")
    finally:
        rkernel.MAX_FLAT_TRIS = budget
    print(f"plain BLAS tier, {ASSET_PLAIN_W} worlds: ray_chunk "
          f"{ASSET_CHUNK} and the onehot walker give the default's planes "
          "bit for bit; no kernel launched")
    ms = timed_device(lambda: rck.raytrace(*planes, **opts), 20, 2)
    wrap_ms = timed(lambda: rck.raytrace(*planes, **opts), 20, 2)
    plain_ms = timed(lambda: rck.raytrace_plain(*planes, **opts), 1, 1)
    # its bounds: the render floor on the scene's live rows (the static
    # count, no hit-dependent work), and the run's own data
    from madrona_tpu_torch.utils.roofline import render_floor_s

    live_rows = ray_counts(planes, opts, n_rays, out)[0]
    floor_ms = render_floor_s(1, planes[0].shape[0], n_rays, live_rows) * 1e3
    b_ms, b_by = bound(*raycast_cost(planes, opts, n_rays, out))
    print(f"raycast on the imported scene: device {ms:.4f} ms, wrapper "
          f"{wrap_ms:.4f} ms, plain {plain_ms:.4f} ms; render "
          f"floor on its {live_rows} live rows {floor_ms:.5f} ms "
          f"(utils/roofline.render_floor_s), bound on this run's data "
          f"{b_ms:.5f} ms ({b_by}) ({card})")
    return launches, (planes, opts, n_rays), worst


def golden_group(name):
    """The phase whose goldens hold ``name``: "fmt3_" (31e), "fmt2_"
    (31d), "fmt_" (31c) or "" (31b)."""
    return next((p for p in ("fmt3_", "fmt2_", "fmt_")
                 if name.startswith(p)), "")


def check_golden_decodes(group, label, card, built=None):
    """The goldens of tests/goldens/torch_images.npz of golden_group
    ``group``, decoded on the host by the port's ``_decode_image`` and
    held to PIL's RGBA byte for byte (the 1024^2 files by its SHA-256);
    ``built``: {name: bytes} of the 1024^2 files this script builds, each
    held first to the SHA-256 of its bytes in the goldens. Each 1024^2
    file's decode ms, the best of 5. Returns (files, rgba)."""
    import hashlib

    from madrona_tpu_torch.assets.importer import _decode_image

    files, rgba, sha = load_image_goldens()
    rgba = {k: v for k, v in rgba.items() if golden_group(k) == group}
    sha = {k: v for k, v in sha.items() if golden_group(k) == group}
    if not rgba or not sha:
        raise AssertionError(f"{label}: no goldens in {IMAGE_GOLDENS}")
    if built:
        with np.load(IMAGE_GOLDENS) as z:
            for name, data in built.items():
                if (hashlib.sha256(data).digest()
                        != z[name + ".file_sha256"].tobytes()):
                    raise AssertionError(f"image {name}: the built file's "
                                         "SHA-256 != the golden's")
        files.update(built)
    t0 = time.perf_counter()
    for name, want in rgba.items():
        got = _decode_image(files[name], name).data
        if got.shape != want.shape or not np.array_equal(got, want):
            raise AssertionError(f"image {name}: decoded RGBA != PIL's")
    all_s = time.perf_counter() - t0
    timed_files = []
    for name, (digest, shape) in sha.items():
        got = _decode_image(files[name], name).data
        if (got.shape != shape
                or hashlib.sha256(got.tobytes()).digest() != digest):
            raise AssertionError(f"image {name}: decoded RGBA != PIL's")
        best = float("inf")
        for _ in range(5):
            t1 = time.perf_counter()
            _decode_image(files[name], name)
            best = min(best, time.perf_counter() - t1)
        timed_files.append(f"{name} ({len(files[name])} bytes, {shape[1]} x "
                           f"{shape[0]}) decodes in {best * 1e3:.2f} ms on "
                           "the host")
    print(f"{label}: {len(rgba)} golden files ({all_s:.3f} s) and "
          f"{len(sha)} 1024^2 files equal to PIL's RGBA; "
          + "; ".join(timed_files) + f" ({card})")
    return files, rgba


def render_imported(label, what, parts, kernels, card, seed, sun):
    """Imported assets ``parts`` (ImportedAssets, one object each) baked
    and rendered by render_views_blas at ASSET_W worlds x ASSET_VIEWS
    views of ASSET_RENDER^2 with a shadow-casting sun: the raycast
    kernel launched once and no other, its planes equal to its plain
    version; its device, wrapper and plain ms and its bound on the run's
    data. Returns (launches a counter, B5's largest difference)."""
    import torch
    from madrona_tpu_torch.ops import raycast_cuda as rck
    from madrona_tpu_torch.render import blas as rblas
    from madrona_tpu_torch.render import kernel as rkernel
    from madrona_tpu_torch.render.lights import make_lights
    from madrona_tpu_torch.render.raycast import RenderConfig

    assets = merge_assets(parts)
    blas, mats, _ = rblas.bake_assets_blas(assets, tex_size=ASSET_TEX,
                                           device=DEV)
    cfg = RenderConfig(width=ASSET_RENDER, height=ASSET_RENDER, t_max=40.0,
                       shadows=True)
    scene = asset_scene(len(assets.meshes), ASSET_W, ASSET_VIEWS, DEV,
                        seed=seed)
    lights = make_lights(ASSET_W, [{"direction": sun, "cast_shadow": True}],
                         device=DEV)
    if not rkernel.kernel_eligible(cfg, blas, lights, 0, scene[0].shape[1]):
        raise AssertionError(f"{label}: the scene is not the kernel's")
    for k in kernels:
        k.launches = 0
    rgb, dep = rblas.render_views_blas(cfg, blas, *scene, materials=mats,
                                       lights=lights)
    torch.cuda.synchronize()
    launches = [k.launches for k in kernels]
    expect_launches(f"{label} render_views_blas", kernels, launches,
                    want_of(kernels, {rck.KERNEL: 1}))
    hit = float((dep < cfg.t_max).float().mean())
    if not (bool(torch.isfinite(rgb).all()) and 0.3 < hit < 1.0
            and tuple(rgb.shape) == (ASSET_W, ASSET_VIEWS, ASSET_RENDER,
                                     ASSET_RENDER, 3)):
        raise AssertionError(f"{label} render: hit share {hit}, shape "
                             f"{tuple(rgb.shape)}")
    planes, opts, n_rays = rkernel.kernel_inputs(cfg, blas, *scene,
                                                 materials=mats,
                                                 lights=lights)
    worst, out = raycast_compare(f"{label} ({what})", planes, opts)
    textured = float((planes[1][:, rck.A_TEX] >= 0).float().mean())
    ms = timed_device(lambda: rck.raytrace(*planes, **opts), 20, 2)
    wrap_ms = timed(lambda: rck.raytrace(*planes, **opts), 20, 2)
    plain_ms = timed(lambda: rck.raytrace_plain(*planes, **opts), 1, 1)
    b_ms, b_by = bound(*raycast_cost(planes, opts, n_rays, out))
    sizes = [t.data.shape[:2] for t in assets.textures]
    print(f"{label}: {len(assets.meshes)} meshes ({what}), textures "
          f"{sizes} resampled to {ASSET_TEX}^2; {ASSET_W} worlds x "
          f"{ASSET_VIEWS} views of {ASSET_RENDER}^2 through the raycast "
          f"kernel, hit share {hit:.3f}, textured rows {textured:.3f}; "
          f"raycast device {ms:.4f} ms, wrapper {wrap_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound on this run's data {b_ms:.5f} ms "
          f"({b_by}) ({card})")
    return launches, worst


def check_image_assets(kernels, card):
    """Phase 31b. The JPEG and PNG goldens decoded on the host by the
    port's decoders, equal to PIL's bytes; the JPEG and 16-bit
    interlaced PNG textured files imported, baked and rendered through
    B5. Returns (launches a counter, B5's largest difference from its
    plain version)."""
    import tempfile

    from madrona_tpu_torch.assets.importer import import_assets

    files, rgba = check_golden_decodes("", "image decoders", card)
    with tempfile.TemporaryDirectory() as d:
        paths = write_image_assets(d, files)
        parts = [import_assets(paths[k]) for k in ("obj", "gltf", "glb")]
    want = [rgba["mtl_png16"], rgba["gltf_prog"], rgba["glb_420"]]
    for part, w in zip(parts, want):
        if not np.array_equal(part.textures[0].data, w):
            raise AssertionError("image assets: an imported texture != PIL's")
    return render_imported(
        "image assets", "OBJ + MTL with a 16-bit Adam7 PNG, .gltf with a "
        "progressive JPEG, .glb with a 4:2:0 JPEG", parts, kernels, card,
        1, (-0.2, 0.5, -1.0))


def check_format_assets(kernels, card):
    """Phase 31c. The BMP, TGA, GIF and WebP goldens decoded on the host
    by the port's decoders, equal to PIL's bytes; the scene textured with
    them imported, baked and rendered through B5. Returns (launches a
    counter, B5's largest difference from its plain version)."""
    import tempfile

    from madrona_tpu_torch.assets.importer import import_assets

    files, rgba = check_golden_decodes("fmt_", "image formats", card)
    with tempfile.TemporaryDirectory() as d:
        paths = write_format_assets(d, files)
        parts = [import_assets(paths[k]) for k in FORMAT_SCENE]
    for k, part in zip(FORMAT_SCENE, parts):
        if not np.array_equal(part.textures[0].data,
                              rgba[FORMAT_TEXTURES[k]]):
            raise AssertionError(f"image formats: the {k} texture != PIL's")
    return render_imported(
        "image formats", "OBJ + MTL with an RLE TGA, .gltf with a GIF, .glb "
        "with a lossy WebP with ALPH, OBJ + MTL with an RLE8 BMP and with a "
        "lossless WebP", parts, kernels, card, 2, (0.3, -0.4, -1.0))


def check_format2_assets(kernels, card):
    """Phase 31d. The DDS, PBM/PGM/PPM/PFM, QOI and ICO/CUR goldens and
    the two 1024^2 DDS files decoded on the host by the port's decoders,
    equal to PIL's bytes; the scene textured with them imported, baked
    and rendered through B5. Returns (launches a counter, B5's largest
    difference from its plain version)."""
    import tempfile

    from madrona_tpu_torch.assets.importer import import_assets

    files, rgba = check_golden_decodes("fmt2_", "image formats 2", card,
                                       big_dds_files())
    with tempfile.TemporaryDirectory() as d:
        paths = write_format2_assets(d, files)
        parts = [import_assets(paths[k]) for k in FORMAT2_SCENE]
    for k, part in zip(FORMAT2_SCENE, parts):
        if not np.array_equal(part.textures[0].data,
                              rgba[FORMAT2_TEXTURES[k]]):
            raise AssertionError(f"image formats 2: the {k} texture != "
                                 "PIL's")
    return render_imported(
        "image formats 2", "OBJ + MTL with a BC1 DDS with punch-through "
        "alpha, .glb with a BC7 DDS with mips, .gltf with a QOI, OBJ + MTL "
        "with a 30 x 18 BC3 DDS and with a P6 PPM at maxval 1023", parts,
        kernels, card, 3, (-0.4, 0.3, -1.0))


def check_format3_assets(kernels, card):
    """Phase 31e. The TIFF goldens and the two 1024^2 TIFFs built here
    decoded on the host by the port's decoder, equal to PIL's bytes; the
    scene textured with them imported, baked and rendered through B5.
    Returns (launches a counter, B5's largest difference from its plain
    version)."""
    import tempfile

    from madrona_tpu_torch.assets.importer import import_assets

    files, rgba = check_golden_decodes("fmt3_", "image formats 3", card,
                                       big_tiff_files())
    with tempfile.TemporaryDirectory() as d:
        paths = write_format3_assets(d, files)
        parts = [import_assets(paths[k]) for k in FORMAT3_SCENE]
    for k, part in zip(FORMAT3_SCENE, parts):
        if not np.array_equal(part.textures[0].data,
                              rgba[FORMAT3_TEXTURES[k]]):
            raise AssertionError(f"image formats 3: the {k} texture != "
                                 "PIL's")
    return render_imported(
        "image formats 3", "OBJ + MTL with an LZW RGBA TIFF with predictor "
        "2, .glb with a tiled Deflate TIFF, .gltf with a PackBits 4-bit "
        "palette TIFF, OBJ + MTL with a 16-bit associated-alpha planar TIFF "
        "and with a MinIsWhite TIFF at Orientation 6", parts, kernels, card,
        4, (0.2, 0.4, -1.0))


def check_ppo_pixels(ppo_px, kernels, b_kernels, card):
    """Phase 32: examples/torch_train_ppo_pixels.py at its defaults (256
    worlds, 16 x 16 RGBD, horizon 16, two epochs) on the card, on each
    tier. ``b_kernels``: the counters of B1, B2, B3 and B5, each of
    which must launch once an environment step (16 an update, and the
    first zero-action step), the others never. Returns {tier: launches}."""
    import torch

    out = {}
    for tier, updates in PIX_UPDATES:
        cfg = ppo_px.VPPOConfig()
        for k in kernels:
            k.launches = 0
        t_make = time.perf_counter()
        sim, step_fn, state, obs, net, obs_of = ppo_px.make_train(
            PIX_W, cfg, seed=0, render_size=PIX_RENDER, tier=tier,
            device=DEV)
        t_make = time.perf_counter() - t_make
        opt = ppo_px.adam_init(net)
        gen = ppo_px.generator(7, sim.device)
        before = [p.detach().clone() for p in net.parameters()]
        secs, rews = [], []
        for _ in range(updates):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, obs, frames = ppo_px.update(step_fn, state, obs, net, opt,
                                               gen, cfg, obs_of)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            rews.append(float(frames["rew"].mean()))
        launches = [k.launches for k in kernels]
        steps = cfg.horizon * updates + 1
        expect_launches(f"ppo pixels {tier}", kernels, launches,
                        want_of(kernels, {k: steps for k in b_kernels}))
        params = list(net.parameters())
        if not all(bool(torch.isfinite(p).all()) for p in params):
            raise AssertionError(f"ppo pixels {tier}: parameters not finite")
        moved = max(float((a.detach() - b).abs().max())
                    for a, b in zip(params, before))
        if not moved > 0:
            raise AssertionError(f"ppo pixels {tier}: nothing moved")
        steady = secs[1:] or secs
        upd_s = len(steady) / sum(steady)
        wall_ms = 1e3 / upd_s
        events = dev_ms = None
        t_prof = 0.0
        if tier == PIX_PROFILED:
            # the device time of one more update under the profiler (the
            # device alone: some 50,000 events take 13 s to collect),
            # over the wall time of an update without it
            t_prof = time.perf_counter()
            events, dev_ms = device_profile(
                lambda: ppo_px.update(step_fn, state, obs, net, opt, gen, cfg,
                                      obs_of), 1, host=False)
            t_prof = time.perf_counter() - t_prof
            if dev_ms is None:
                raise AssertionError(f"ppo pixels {tier}: the profiler "
                                     "recorded no device time")
        busy = "not measured" if dev_ms is None else f"{dev_ms / wall_ms:.4f}"
        print(f"ppo pixels [{tier}]: {PIX_W} worlds, {updates} updates of "
              f"horizon {cfg.horizon} x {cfg.epochs} epochs, mean step "
              f"rewards {[round(r, 4) for r in rews]}, parameters moved by "
              f"up to {moved:.4g}, finite; update s "
              f"{[round(x, 3) for x in secs]}"
              f"; {upd_s:.3f} updates/s and {upd_s * cfg.horizon * PIX_W:.1f}"
              f" env-steps/s with the render and the learner (after the "
              f"first); one profiled update: {events} device events, "
              f"{dev_ms} device ms, busy {busy} of {wall_ms:.1f} ms "
              f"(profiled in {t_prof:.1f} s; make_train {t_make:.1f} s) "
              f"({card})")
        out[f"ppo_pixels_{tier}"] = launches
        del sim, state, obs, net, opt
        torch.cuda.empty_cache()
    return out


def check_checkpoints(make_sim, EscapeRoom, ppo, ckpt, kernels, card):
    """Phase 33: masked save and restore of the Escape Room state at
    CKPT_W worlds (half the worlds), its npz round trip bit for bit, and
    a Cartpole PPO run saved after CKPT_PPO_UPDATES updates and resumed
    in a fresh make_train, bit-identical to the straight run."""
    import tempfile

    import torch

    acts = EscapeRoom.random_actions(np.random.RandomState(4),
                                     3 * CKPT_STEPS, CKPT_W).to(DEV)
    zero = torch.zeros((CKPT_W,), dtype=torch.int32, device=DEV)
    sim = make_sim(EscapeRoom(), num_worlds=CKPT_W, seed=3, device=DEV)
    fn = sim.step_fn()

    def run(s, t0):
        for t in range(t0, t0 + CKPT_STEPS):
            s, _ = fn(s, {"action": acts[t], "reset": zero})
        return s

    s0 = run(sim.state, 0)
    s1 = run(s0, CKPT_STEPS)
    half = torch.arange(CKPT_W, device=DEV) % 2 == 0
    buf = ckpt.save_worlds(ckpt.snapshot(s0), s1, half)
    s2 = run(s1, 2 * CKPT_STEPS)
    s3 = ckpt.restore_worlds(s2, buf, half)
    n_leaves = 0
    for (path, a), (_, b1), (_, b2) in zip(tree_leaves(s3),
                                           tree_leaves(s1),
                                           tree_leaves(s2)):
        n_leaves += 1
        if a.dim() == 0:
            ok = torch.equal(a, b2)
        else:
            ok = torch.equal(a[half], b1[half]) and torch.equal(a[~half],
                                                                b2[~half])
        if not ok:
            raise AssertionError(f"restore_worlds: {path} differs")
    s4 = run(s3, 0)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "state.npz")
        t0 = time.perf_counter()
        ckpt.save_npz(path, s4)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        back = ckpt.load_npz(path, s4)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    for (p, a), (_, b) in zip(tree_leaves(back), tree_leaves(s4)):
        if a.device != b.device or a.dtype != b.dtype or not torch.equal(a, b):
            raise AssertionError(f"npz round trip: {p} differs")
    print(f"checkpoint: escape_room {CKPT_W} worlds, save_worlds / "
          f"restore_worlds on half of them: {n_leaves} tensors as expected "
          f"(the step counter live); npz round trip bit for bit ({size} B, "
          f"save {save_s:.3f} s, load {load_s:.3f} s) ({card})")
    del sim, s0, s1, s2, s3, s4, buf, back

    # PPO on Cartpole: 2 updates, save, a fresh make_train, 2 more
    cfg = ppo.PPOConfig()

    def train(n, resume=None):
        sim_, pi, v = ppo.make_train(CKPT_PPO_W, cfg, seed=0, device=DEV)
        gen = ppo.generator(100, sim_.device)
        st = sim_.state
        if resume is not None:
            st = ckpt.load_npz(resume[0], st)
            ppo.load_learner(resume[1], (pi, v), gen)
        f = sim_.step_fn()
        for _ in range(n):
            st, _ = ppo.update(f, st, pi, v, gen, cfg, ppo.cart_obs)
        return st, (pi, v), gen

    for k in kernels:
        k.launches = 0
    st_a, nets_a, _ = train(2 * CKPT_PPO_UPDATES)
    st_b, nets_b, gen_b = train(CKPT_PPO_UPDATES)
    with tempfile.TemporaryDirectory() as d:
        paths = (os.path.join(d, "sim.npz"), os.path.join(d, "learner.npz"))
        ckpt.save_npz(paths[0], st_b)
        ppo.save_learner(paths[1], nets_b, gen_b)
        st_c, nets_c, _ = train(CKPT_PPO_UPDATES, resume=paths)
    bad = [i for i, (a, c) in enumerate(zip(
        [p for n in nets_a for p in n.parameters()],
        [p for n in nets_c for p in n.parameters()])) if not torch.equal(a, c)]
    bad += [p for (p, a), (_, c) in zip(tree_leaves(st_a),
                                        tree_leaves(st_c))
            if not torch.equal(a, c)]
    if bad:
        raise AssertionError(f"ppo resume: differs from the straight run at "
                             f"{bad}")
    launches = [k.launches for k in kernels]
    if any(launches):
        raise AssertionError(f"ppo resume: kernels launched {launches}")
    print(f"checkpoint: cartpole PPO at {CKPT_PPO_W} worlds, "
          f"{CKPT_PPO_UPDATES} updates, saved (sim npz, parameters and the "
          f"action generator's state), resumed in a fresh make_train for "
          f"{CKPT_PPO_UPDATES} more: bit-identical to "
          f"{2 * CKPT_PPO_UPDATES} straight updates ({card})")


# ---- phases 34-38: the shell (tracing and debug checks, the roofline,
# the navmesh, worlds sharded over processes, the viewer, recorder and
# playback)
TRACE_STEPS = 5           # Escape Room steps under profile_trace
CHECKED_STEPS = 20        # steps under utils.debug.checked
ANNOT_CALLS = 20000       # node_scope entries timed with no profiler on
NAV_W = 16384             # worlds of the navmesh queries
NAV_GRID = 64             # the quad grid's side: 8192 triangles
NAV_CPU_W = 8             # worlds carried to the CPU
NAV_TOL = 2e-6            # sampled points, card against the CPU
SHARD_COUNTS = (2, 4)     # Escape Room's 4096 worlds as 2 and 4 shards
PAR_STEPS = 20
DPPO_UPDATES = 25         # torch_train_ppo_distributed at its 1024 worlds
VIZ_TICKS = 5             # viewer ticks with the launches counted
VIZ_FRAME = (320, 240)
REC_STEPS = 20
REC_WORLDS = 8            # worlds of the recorded trajectory
FRAME_DEPTH_TOL = 1e-4    # the dense tracer's bounds, card against CPU
FRAME_RGB_TOL = 0.02      # (tests/test_torch_raycast_glue.py (b))
FRAME_RGB_SHARE = 0.002
# (bytes, operations) of each phase 16 row that this script's own counts
# gave on its seeded scenes before they moved to utils/roofline.py (the
# same scenes give the same counts, so each must repeat)
INLINED_COUNTS = {
    "broadphase": (8146944, 19869696),
    "contacts": (9202796, 48984900),
    "substep_solver": (27117464, 399900400),
    "lidar": (7307304, 370851840),
    "lidar same-work yardstick": (7307304, 589824000),
    "raycast": (647106560, 70128762880),
    "raycast every-row yardstick": (647106560, 85228257280),
    "raycast_blas": (647114752, 113951514256),
    "hh_narrowphase_sublane": (3155000, 246700),
    "hh_narrowphase": (3154616, 967940),
    "hh_narrowphase edge_dirs crowded": (4771728, 195533400),
    "hh_narrowphase edge_pairs crowded": (4771440, 682225160),
    "fused_step": (25433280, 455438900),
    "fused_step edge_dirs spheres": (25007296, 958979420),
    "fused_step edge_pairs spheres": (25007296, 958949520),
    "broadphase hide_seek": (22495232, 43352064),
    "contacts hide_seek": (38345280, 674644430),
    "substep_solver hide_seek": (85680296, 1619959800),
    "fused_step hide_seek": (72882752, 2315909430),
}
# the kernel symbol of each main-path kernel in the profiler's names
B_KERNELS = {"B1": "broadphase_kernel", "B2": "contacts_kernel",
             "B3": "solver_kernel", "B4": "lidar_kernel"}


def with_nan_velocity(state, world=1, row=20):
    """``state`` with a NaN in one body's (an agent's) linear velocity."""
    t = state.tables["RigidBody"]
    cols = dict(t.columns)
    vel = dict(cols["Velocity"])
    lin = vel["linear"].clone()
    lin[world, row, 0] = float("nan")
    vel["linear"] = lin
    cols["Velocity"] = vel
    tables = dict(state.tables)
    tables["RigidBody"] = dataclasses.replace(t, columns=cols)
    return dataclasses.replace(state, tables=tables)


def launches_by_node(sim, kernels, inputs):
    """{node: [launches of each counter]} of one step of ``sim`` from
    its state, each node's launches read around it."""
    graph = sim.executor.graphs["step"]
    saved = [n.fn for n in graph.nodes]
    found = {}

    def counted(name, fn):
        def run(sm, state, key):
            before = [k.launches for k in kernels]
            out = fn(sm, state, key)
            found[name] = [k.launches - b for k, b in zip(kernels, before)]
            return out
        return run

    try:
        for n in graph.nodes:
            n.fn = counted(f"{graph.name}.{n.name}", n.fn)
        sim.step_fn()(sim.state, inputs)
    finally:
        for n, fn in zip(graph.nodes, saved):
            n.fn = fn
    return found


def kernels_by_node_window(trace_path, nodes):
    """({node: device ms a profiled run}, {node: {kernel: launches}}) from
    a Chrome trace: a node's window on the card runs from the start of
    its GPU annotation range to the start of the next node's. The stream
    runs the kernels in launch order, so a kernel the profiler did not
    link to its host op still falls in the window of the node that
    launched it (unless it is that node's first kernel)."""
    import bisect

    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    ann = sorted((e["ts"], e["name"]) for e in events
                 if e.get("cat") == "gpu_user_annotation"
                 and e.get("name") in nodes)
    starts = [t for t, _ in ann]
    ms = {n: 0.0 for n in nodes}
    names = {n: {} for n in nodes}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        i = bisect.bisect_right(starts, e["ts"]) - 1
        if i >= 0:
            node = ann[i][1]
            ms[node] += e.get("dur", 0) / 1e3
            names[node][e["name"]] = names[node].get(e["name"], 0) + 1
    return ms, names


def check_tracing_debug(make_sim, EscapeRoom, kernels, acts, card):
    """Phase 34: Escape Room at W worlds under profile_trace (each node's
    device ms, the kernels under each node), the node annotation's cost a
    step, CHECKED_STEPS steps under utils.debug.checked bit-identical to
    the plain steps, and a NaN velocity reported by the physics node."""
    import contextlib
    import tempfile

    import torch
    from madrona_tpu_torch.utils import debug, tracing

    sim = make_sim(EscapeRoom(), num_worlds=W, seed=0, device=DEV)
    reset = torch.zeros((W,), dtype=torch.int32, device=DEV)
    fn = sim.step_fn()
    state = sim.state
    for i in range(2):
        state, _ = fn(state, {"action": acts[i], "reset": reset})
    sim.state = state
    inputs = {"action": acts[2], "reset": reset}
    graph = sim.executor.graphs["step"]
    nodes = [f"{graph.name}.{n.name}" for n in graph.nodes]

    # each node's device ms and the kernels under it
    with tempfile.TemporaryDirectory() as logdir:
        with tracing.profile_trace(logdir) as prof:
            s = state
            for _ in range(TRACE_STEPS):
                s, _ = fn(s, inputs)
            torch.cuda.synchronize()
        trace_mb = os.path.getsize(prof.trace_path) / 2 ** 20
        node_ms, by_window = kernels_by_node_window(prof.trace_path, nodes)
    spans = {e.key for e in prof.key_averages()}
    missing = [n for n in nodes if n not in spans]
    if missing:
        raise AssertionError(f"profile: no span named {missing}")
    print(f"profile of {TRACE_STEPS} steps at {W} worlds (Chrome trace "
          f"{trace_mb:.1f} MiB), device ms a step by node (kernels in the "
          "node's window): " + ", ".join(
              f"{n} {node_ms[n] / TRACE_STEPS:.4f}" for n in nodes)
          + f" ({card})")
    counted = launches_by_node(sim, kernels, inputs)
    for b, sym in B_KERNELS.items():
        ran = [n for n in nodes if counted[n][list(B_KERNELS).index(b)]]
        seen = [n for n in nodes if any(sym in k for k in by_window[n])]
        print(f"  {b} ({sym}): launched under {ran} (counters), in the "
              f"window of {seen or 'no node'} (the trace)")
        want = ["step.er_post"] if b == "B4" else ["step.physics_step"]
        if ran != want or counted[ran[0]][list(B_KERNELS).index(b)] != 1:
            raise AssertionError(f"{b}: launched under {ran}, not once "
                                 f"under {want}")

    # the annotation's cost: node_scope entered and left with no profiler
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ANNOT_CALLS):
        with tracing.node_scope("step.annotation_cost"):
            pass
    scope_us = (time.perf_counter() - t0) * 1e6 / ANNOT_CALLS

    def step_ms(annotate):
        saved = tracing.node_scope
        if not annotate:
            tracing.node_scope = lambda name: contextlib.nullcontext()
        try:
            s = state
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(STEPS):
                s, _ = fn(s, inputs)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3 / STEPS
        finally:
            tracing.node_scope = saved

    turns = [step_ms(a) for a in (True, False, False, True)]
    share = len(nodes) * scope_us / 1e3 / (sum(turns[1:3]) / 2)
    print(f"node annotation: {scope_us:.3f} us a node_scope, {len(nodes)} "
          f"a step: {100 * share:.4f} % of the step; steps in turns "
          f"(annotated, bare, bare, annotated) ms: "
          + ", ".join(f"{t:.3f}" for t in turns) + f" ({card})")
    if share >= 0.01:
        raise AssertionError(f"node annotation {100 * share:.3f} % >= 1 %")

    # checked steps: the plain steps' results bit for bit
    chk = debug.checked(fn)
    s_plain, s_chk = state, state
    t_plain = t_chk = 0.0
    for i in range(CHECKED_STEPS):
        inp = {"action": acts[i % STEPS], "reset": reset}
        t0 = time.perf_counter()
        s_plain, o_plain = fn(s_plain, inp)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s_chk, o_chk = chk(s_chk, inp)
        torch.cuda.synchronize()
        t_plain += t1 - t0
        t_chk += time.perf_counter() - t1
        for k in o_plain:
            if not torch.equal(o_plain[k], o_chk[k]):
                raise AssertionError(f"checked step {i}: {k} differs")
    for (path, a), (_, b) in zip(tree_leaves(s_plain),
                                 tree_leaves(s_chk)):
        if not torch.equal(a, b):
            raise AssertionError(f"checked steps: {path} differs")
    print(f"checked: {CHECKED_STEPS} steps bit-identical to the plain "
          f"steps; {t_chk * 1e3 / CHECKED_STEPS:.1f} ms a checked step, "
          f"{t_plain * 1e3 / CHECKED_STEPS:.1f} plain ({card})")
    try:
        chk(with_nan_velocity(state), inputs)
    except debug.CheckError as e:
        if "step.physics_step" not in str(e):
            raise AssertionError(f"checked named another place: {e}")
        print(f"checked: a NaN in one body's velocity raises: {e}")
    else:
        raise AssertionError("checked let a NaN velocity through")


def check_roofline(work, rates, HideSeek, card):
    """Phase 35: every phase 16 bound from utils/roofline.py, its counts
    equal to INLINED_COUNTS; bench_roofline of Escape Room and Hide &
    Seek's pixels at their measured env-steps/s; the render floor equal
    to B5's bound on phase 8's planes."""
    from madrona_tpu_torch.models.escape_room import EscapeRoom
    from madrona_tpu_torch.utils import roofline

    print(f"roofline: NVIDIA H100 SXM data sheet peaks "
          f"{roofline.PEAK_BYTES:.3g} B/s, {roofline.PEAK_F32:.3g} float32 "
          f"op/s (700 W); this card: {card}")
    if set(work) != set(INLINED_COUNTS):
        raise AssertionError(f"roofline rows {sorted(work)}")
    for name, (b, ops) in work.items():
        ms, by = bound(b, ops)
        print(f"  {name}: bound {ms:.5f} ms ({by}: {b} B, {ops} ops)")
        if (b, ops) != INLINED_COUNTS[name]:
            raise AssertionError(f"{name}: ({b}, {ops}) != the inlined "
                                 f"counts' {INLINED_COUNTS[name]}")
    hs = HideSeek(render_size=HS_RENDER)
    for what, env, w, rate in (
            ("escape_room", EscapeRoom(), W, rates["escape_room"]),
            (f"hide_seek_pixels{HS_RENDER}", hs, HS_W,
             rates["hide_seek_pixels"])):
        rl = roofline.bench_roofline(w, rate, env)
        if set(rl) != {"model", "sol_env_steps_per_sec", "pct_of_roofline"}:
            raise AssertionError(f"bench_roofline {what}: {rl}")
        print(f"bench_roofline {what} ({w} worlds, {rate:.1f} env-steps/s): "
              f"{rl} ({card})")
    # the render floor counts the live rows of phase 8's planes: at the
    # flat-colour scene (no shadow, no atlas) it is B5's bound
    floor_s = roofline.render_floor_s(HS_W, 4, HS_RENDER ** 2,
                                      roofline.render_live_rows(hs))
    if floor_s != work["raycast"][1] / roofline.PEAK_F32:
        raise AssertionError(f"render floor {floor_s * 1e3:.5f} ms is not "
                             f"B5's bound on phase 8's planes")
    print(f"render floor: {roofline.render_live_rows(hs)} live rows a "
          f"world, {floor_s * 1e3:.5f} ms a step of {HS_W} worlds, equal "
          f"to B5's bound on phase 8's planes")


def grid_navmesh(n, device):
    """An n x n grid of unit quads in the z = 0 plane."""
    from madrona_tpu_torch.utils.navmesh import build_navmesh

    verts = np.array([[x, y, 0.0] for y in range(n + 1)
                      for x in range(n + 1)], np.float32)
    idx = np.arange((n + 1) * (n + 1)).reshape(n + 1, n + 1)
    polys = np.stack([idx[:-1, :-1], idx[:-1, 1:], idx[1:, 1:],
                      idx[1:, :-1]], axis=-1).reshape(-1)
    return build_navmesh(verts, polys, [4] * (n * n), device=device)


def navmesh_walk(mesh, keys):
    """(points, start triangles, goal triangles, the walk [hops + 1,
    worlds]) of one start and one goal sampled a world, walked by
    next_hop until every world is at its goal."""
    import torch
    from madrona_tpu_torch.utils import rng as _rng

    pts, tri = mesh.sample_point(_rng.split_i(keys, 0))
    start = mesh.locate(pts)
    goal = mesh.locate(mesh.sample_point(_rng.split_i(keys, 1))[0])
    dists = mesh.shortest_dists(goal)
    walk = [start]
    for _ in range(mesh.num_tris):
        if torch.equal(walk[-1], goal):
            break
        walk.append(mesh.next_hop(walk[-1], goal, dists=dists))
    return pts, tri, start, goal, torch.stack(walk)


def check_navmesh(card):
    """Phase 36: a NAV_GRID x NAV_GRID quad-grid navmesh at NAV_W worlds
    on the card: sample_point, locate, next_hop walked to the goal; the
    first NAV_CPU_W worlds again on the CPU (triangles and hops equal,
    points within NAV_TOL); ms a query."""
    import torch
    from madrona_tpu_torch.utils import rng as _rng

    mesh = grid_navmesh(NAV_GRID, DEV)
    keys = _rng.split_i(_rng.key(7, device=DEV),
                        torch.arange(NAV_W, device=DEV))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pts, tri, start, goal, walk = navmesh_walk(mesh, keys)
    torch.cuda.synchronize()
    walk_s = time.perf_counter() - t0
    if not torch.equal(walk[-1], goal):
        raise AssertionError("navmesh: a walk did not reach its goal")
    if not bool((start == tri).float().mean() > 0.99):
        raise AssertionError("navmesh: locate misses the sampled triangles")
    cpu = navmesh_walk(grid_navmesh(NAV_GRID, "cpu"),
                       keys[:NAV_CPU_W].cpu())
    pt_err = float((cpu[0] - pts[:NAV_CPU_W].cpu()).abs().max())
    for what, a, b in (("triangles", cpu[1], tri), ("starts", cpu[2], start),
                       ("goals", cpu[3], goal)):
        if not torch.equal(a, b[:NAV_CPU_W].cpu()):
            raise AssertionError(f"navmesh: {what} differ from the CPU's")
    hops = walk[:, :NAV_CPU_W].cpu()
    if hops.shape[0] < cpu[4].shape[0] or not torch.equal(
            hops[:cpu[4].shape[0]], cpu[4]) or not bool(
            (hops[cpu[4].shape[0]:] == cpu[3]).all()):
        raise AssertionError("navmesh: hops differ from the CPU's")
    if not pt_err <= NAV_TOL:
        raise AssertionError(f"navmesh: points {pt_err} > {NAV_TOL}")

    def ms(fn, iters=5):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / iters

    dists = mesh.shortest_dists(goal)
    times = {
        "sample_point": ms(lambda: mesh.sample_point(keys)),
        "locate": ms(lambda: mesh.locate(pts)),
        "shortest_dists": ms(lambda: mesh.shortest_dists(goal), 1),
        "next_hop (dists given)": ms(lambda: mesh.next_hop(start, goal,
                                                           dists=dists)),
    }
    print(f"navmesh {NAV_GRID}x{NAV_GRID} grid ({mesh.num_tris} triangles), "
          f"{NAV_W} worlds: walks of up to {walk.shape[0] - 1} hops reach "
          f"their goals ({walk_s:.2f} s with the sampling, location and "
          f"distances); {NAV_CPU_W} worlds on the CPU: triangles and hops "
          f"equal, points within {pt_err!r}; ms a batched query: "
          + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
          + f" ({card})")


def check_sharded_steps(make_sim, EscapeRoom, kernels, acts, card):
    """Phase 37a: Escape Room at W worlds against the same worlds as 2 and
    4 shards stepped in turn in one process, PAR_STEPS steps: the joined
    exports (every step) and state (at the end) bit for bit; each main
    path kernel launched once a step in each shard."""
    import torch
    from madrona_tpu_torch.parallel import mesh as pmesh

    sim = make_sim(EscapeRoom(), num_worlds=W, seed=0, device=DEV)
    fn = sim.step_fn()
    reset = torch.zeros((W,), dtype=torch.int32, device=DEV)
    start = sim.state
    full, full_outs = start, []
    for t in range(PAR_STEPS):
        full, o = fn(full, {"action": acts[t], "reset": reset})
        full_outs.append(o)
    for n in SHARD_COUNTS:
        shards = [pmesh.shard_state(start, pmesh.Mesh(r, n, full.rng.device))
                  for r in range(n)]
        for k in kernels:
            k.launches = 0
        for t in range(PAR_STEPS):
            outs = []
            for r in range(n):
                inp = pmesh.shard_inputs({"action": acts[t], "reset": reset},
                                         W, pmesh.Mesh(r, n, full.rng.device))
                shards[r], o = fn(shards[r], inp)
                outs.append(o)
            joined = pmesh.join_shards(outs, W // n)
            for key, v in full_outs[t].items():
                if not torch.equal(joined[key], v):
                    raise AssertionError(f"{n} shards: export {key} of step "
                                         f"{t} differs")
        launches = [k.launches for k in kernels]
        if launches != [PAR_STEPS * n] * len(kernels):
            raise AssertionError(f"{n} shards: launches {launches}")
        leaves = tree_leaves(pmesh.join_shards(shards, W // n))
        ref = tree_leaves(full)
        if len(leaves) != len(ref) or not all(
                torch.equal(a, b) for (_, a), (_, b) in zip(leaves, ref)):
            raise AssertionError(f"{n} shards: the joined state differs")
        print(f"escape_room {W} worlds as {n} x {W // n} shards stepped in "
              f"turn, {PAR_STEPS} steps: exports and state bit-identical to "
              f"the unsharded sim; B1-B4 launched {launches} times "
              f"({PAR_STEPS} steps x {n} shards) ({card})")


def check_distributed_ppo(torch_train_ppo_distributed, kernels, card):
    """Phase 37b: torch_train_ppo_distributed at its 1024 worlds for
    DPPO_UPDATES updates, one rank a card over NCCL (in this process on
    one card, under torchrun on more), the parameters bit-identical
    across ranks (the example's all_gather check); no kernel launched."""
    import socket

    import torch
    import torch.distributed as dist

    n = torch.cuda.device_count()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    if n == 1:
        env = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1",
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            ep_len, pi = torch_train_ppo_distributed.main(
                ["--updates", str(DPPO_UPDATES)])
            backend = dist.get_backend()
            dist.destroy_process_group()
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        if backend != "nccl":
            raise AssertionError(f"backend {backend}, not nccl")
        if not ep_len > 25.0:
            raise AssertionError(f"distributed PPO: episode length {ep_len}")
    else:
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run",
             f"--nproc_per_node={n}", f"--master_port={port}",
             os.path.join(HERE, "examples", "torch_train_ppo_distributed.py"),
             "--updates", str(DPPO_UPDATES)],
            capture_output=True, text=True, timeout=900, cwd=HERE)
        print(out.stdout[-2000:])
        if out.returncode:
            raise AssertionError(f"torchrun rc {out.returncode}: "
                                 f"{out.stderr[-2000:]}")
        ep_len, backend = float("nan"), "nccl"
    secs = time.perf_counter() - t0
    if any(k.launches for k in kernels):
        raise AssertionError("distributed PPO launched a kernel")
    print(f"torch_train_ppo_distributed: {n} rank(s) over {backend}, 1024 "
          f"worlds, {DPPO_UPDATES} updates in {secs:.1f} s "
          f"({DPPO_UPDATES / secs:.2f} updates/s), episode length "
          f"{ep_len:.1f}, parameters bit-identical across ranks "
          f"(all_gather) ({card})")


def http_get(port, path):
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        c.request("GET", path)
        r = c.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        c.close()


def check_viz(torch_viewer_demo, kernels, card):
    """Phase 38: examples/torch_viewer_demo's WebViewer on Escape Room at
    W worlds on the card: tick through B1-B4; a VIZ_FRAME flycam frame of
    world 0 on the card against the CPU's from the same state (the dense
    tracer's bounds); the top-down PNG decoded; the Recorder over
    REC_STEPS steps saved and loaded; PlaybackViewer's /meta, /frame.png
    and /topdown.png over 127.0.0.1."""
    import json as json_
    import tempfile
    import threading

    import torch
    from madrona_tpu_torch.assets.png import decode_png
    from madrona_tpu_torch.viz import PlaybackViewer, Recorder
    from madrona_tpu_torch.viz.web_viewer import frame_renderer

    width, height = VIZ_FRAME
    v = torch_viewer_demo.make_viewer(W, DEV, width=width, height=height)
    for k in kernels:
        k.launches = 0
    for _ in range(VIZ_TICKS):
        v.tick()
    launches = [k.launches for k in kernels]
    if launches != [VIZ_TICKS] * len(kernels) or v.step_count != VIZ_TICKS:
        raise AssertionError(f"viewer ticks: launches {launches}, steps "
                             f"{v.step_count}")
    # a flycam pose that sees the first rooms' walls, doors and agents
    v.cam_pos, v.pitch = np.array([0.0, -4.0, 8.0]), -0.5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rgb, depth = v.frame()
    torch.cuda.synchronize()
    frame_ms = (time.perf_counter() - t0) * 1e3
    cols = v.sim.state.tables["RigidBody"].columns
    cpu_frame = frame_renderer(width, height, 90.0, v.mesh,
                               v.render_obj, None, "cpu")
    c_rgb, c_depth = cpu_frame(cols["Position"][0].cpu(),
                               cols["Rotation"][0].cpu(),
                               cols["Scale"][0].cpu(), v.cam_pos,
                               v.cam_quat())
    d_err = float((depth.cpu() - c_depth).abs().max())
    bad = float(((rgb.cpu() - c_rgb).abs() > FRAME_RGB_TOL).float().mean())
    hit = float((c_depth < 200.0).float().mean())
    if not (d_err <= FRAME_DEPTH_TOL and bad < FRAME_RGB_SHARE and hit > 0.05):
        raise AssertionError(f"flycam frame: depth {d_err}, rgb share {bad}, "
                             f"hit share {hit}")
    top = decode_png(v.topdown_png())
    if top.shape[:2] != (256, 256):
        raise AssertionError(f"top-down PNG {top.shape}")
    print(f"viewer: {VIZ_TICKS} ticks at {W} worlds launched B1-B4 "
          f"{launches} times; a {width}x{height} flycam frame in "
          f"{frame_ms:.1f} ms, against the CPU's: depth within {d_err!r}, "
          f"rgb off by > {FRAME_RGB_TOL} at {100 * bad:.3f} % of pixels, "
          f"{100 * hit:.1f} % of rays hit; top-down PNG {top.shape} ({card})")

    def body_column(name):
        return lambda s, o: s.tables["RigidBody"].columns[name][:REC_WORLDS]

    rec = Recorder(capture={c: body_column(c)
                            for c in ("Position", "Rotation", "Scale")})
    step, state = v.sim.step_fn(), v.sim.state
    inputs = v.inputs_fn()
    for _ in range(REC_STEPS):
        state, outs = step(state, inputs)
        rec.record(state, outs)
    traj = rec.stacked()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "episode.npz")
        rec.save(path)
        loaded = Recorder.load(path)
    if set(loaded) != set(traj) or not all(
            np.array_equal(loaded[k], traj[k]) for k in traj):
        raise AssertionError("recorder: the loaded trajectory differs")
    if loaded["Position"].shape != (REC_STEPS, REC_WORLDS, 21, 3):
        raise AssertionError(f"recorder: {loaded['Position'].shape}")
    pb = PlaybackViewer(loaded, mesh=v.mesh,
                        render_obj=v.render_obj, width=width,
                        height=height, device=DEV)
    srv = pb.make_server(port=0)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        st, ct, body = http_get(port, "/meta")
        meta = json_.loads(body)
        if st != 200 or meta["steps"] != REC_STEPS or not meta["has_cam"] \
                or meta["num_worlds"] != REC_WORLDS:
            raise AssertionError(f"playback /meta: {st} {meta}")
        for path, shape in (("/frame.png?t=10&w=3", (height, width)),
                            ("/topdown.png?t=19&w=0", (256, 256))):
            st, ct, body = http_get(port, path)
            if st != 200 or ct != "image/png" or \
                    decode_png(body).shape[:2] != shape:
                raise AssertionError(f"playback {path}: {st} {ct}")
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=10)
    print(f"recorder: {REC_STEPS} steps of {REC_WORLDS} worlds saved and "
          f"loaded equal; playback on 127.0.0.1 served /meta, /frame.png "
          f"({width}x{height}, traced on the card) and /topdown.png "
          f"({card})")


LG_STEPS = 5              # steps of the composed launch against sim.step
ER_EXPORT_STEPS = 3       # Escape Room steps whose exports get_exported reads
WS_STEPS = 30             # scripts/torch_weak_scaling.py's default steps
PHASE_REPS = 20           # calls a run of torch_step_profile's phase times


def check_launch_graph(make_sim, HideSeek, EscapeRoom, all_k, b_kernels,
                       acts, card):
    """Phase 39: Executor.build_launch_graph(["step", "render"]) of Hide &
    Seek with pixels (HS_W worlds) run LG_STEPS steps against sim.step()
    of a fresh sim from the same seed and actions: every export and the
    final state equal bit for bit, b_kernels (B1, B2, B3, B5) launched
    once a step and no other kernel; then Escape Room at W worlds:
    get_exported(slot) equal to run's export of every slot, at each of
    ER_EXPORT_STEPS steps."""
    import torch

    what = f"hide_seek pixels {HS_W} worlds"
    hs_acts = HideSeek.random_actions(np.random.RandomState(4), LG_STEPS,
                                      HS_W).to(DEV)
    reset = torch.zeros((HS_W,), dtype=torch.int32, device=DEV)
    composed = make_sim(HideSeek(render_size=HS_RENDER), num_worlds=HS_W,
                        seed=0, device=DEV)
    stepped = make_sim(HideSeek(render_size=HS_RENDER), num_worlds=HS_W,
                       seed=0, device=DEV)
    ex = composed.executor
    key = ex.build_launch_graph(["step", "render"])
    fn = ex.step_fn(key)
    if key != ("step", "render") or ex.step_fn(("step", "render")) is not fn:
        raise AssertionError(f"build_launch_graph: key {key}, the composed "
                             "step not kept")
    for k in all_k:
        k.launches = 0
    outs = [ex.run(key, {"action": hs_acts[t], "reset": reset})
            for t in range(LG_STEPS)]
    expect_launches(f"{what} build_launch_graph", all_k,
                    [k.launches for k in all_k],
                    want_of(all_k, {k: LG_STEPS for k in b_kernels}))
    for t in range(LG_STEPS):
        ref = stepped.step({"action": hs_acts[t], "reset": reset})
        if set(ref) != set(outs[t]):
            raise AssertionError(f"{what}: export slots differ")
        for name, v in ref.items():
            if not torch.equal(outs[t][name], v):
                raise AssertionError(f"{what} step {t}: the composed "
                                     f"launch's {name} differs from "
                                     "sim.step()'s")
    for (path, a), (_, b) in zip(tree_leaves(composed.state),
                                 tree_leaves(stepped.state)):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: {path} differs after "
                                 f"{LG_STEPS} steps")
    print(f"{what}: run(build_launch_graph(['step', 'render'])) equals "
          f"sim.step() bit for bit over {LG_STEPS} steps (every export "
          f"and the state), B1, B2, B3 and B5 once a step ({card})")
    del composed, stepped, outs

    sim = make_sim(EscapeRoom(), num_worlds=W, seed=0, device=DEV)
    zeros = torch.zeros((W,), dtype=torch.int32, device=DEV)
    for t in range(ER_EXPORT_STEPS):
        out = sim.step({"action": acts[t], "reset": zeros})
        for slot, v in out.items():
            if not torch.equal(sim.executor.get_exported(slot), v):
                raise AssertionError(f"escape_room step {t}: get_exported"
                                     f"({slot!r}) differs from run's")
    print(f"escape_room {W} worlds: get_exported equals run's export for "
          f"each of the {len(out)} slots at each of {ER_EXPORT_STEPS} steps "
          f"({', '.join(sorted(out))})")


def check_weak_scaling(kernels, card):
    """Phase 40: scripts/torch_weak_scaling.py --env escape_room at W
    worlds a rank, WS_STEPS steps, as one rank (a group of one process
    over NCCL on the card): its JSON printed, the rate finite and
    positive, the main path's kernels launched once a step (and once in
    the warm-up call). With one card there is no efficiency to read."""
    import math

    ws = load_script("torch_weak_scaling")
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    out = ws.main(["--env", "escape_room", "--worlds-per-device", str(W),
                   "--steps", str(WS_STEPS)]
                  + (["--cpu"] if DEV == "cpu" else []))
    secs = time.perf_counter() - t0
    expect_launches("torch_weak_scaling escape_room", kernels,
                    [k.launches for k in kernels],
                    [WS_STEPS + 1] * len(kernels))
    rate = out["steps_per_sec"]["1"]
    want = "gloo" if DEV == "cpu" else "nccl"
    if out["devices"] != [1] or out["backend"] != want or \
            not (math.isfinite(rate) and rate > 0) or out["efficiency"]:
        raise AssertionError(f"torch_weak_scaling: {out}")
    print(f"torch_weak_scaling: one rank over {out['backend']}, {W} worlds, "
          f"{WS_STEPS} steps: {rate:.1f} env-steps/s, {secs:.1f} s in all; "
          "efficiency: none (one card, no other count to compare with) "
          f"({card})")


def check_phases(make_sim, EscapeRoom, acts, card):
    """Phase 41: scripts/torch_step_profile.py --phases on Escape Room at
    W worlds (after 10 steps): the whole step, each physics phase alone
    on the plain route and B1-B3 alone, PHASE_REPS calls a run, printed;
    every time finite and positive."""
    import math

    import torch

    tsp = load_script("torch_step_profile")
    sim = make_sim(EscapeRoom(), num_worlds=W, seed=0, device=DEV)
    inputs = {"action": acts[0],
              "reset": torch.zeros((W,), dtype=torch.int32, device=DEV)}
    for _ in range(10):
        sim.step(inputs)
    rows = tsp.phase_times(sim, inputs, torch.cuda.synchronize, PHASE_REPS)
    tsp.print_phases("escape_room phases (torch_step_profile.py --phases)",
                     W, rows, card)
    if not all(math.isfinite(ms) and ms > 0 for _, ms in rows):
        raise AssertionError(f"phase times {rows}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.join(HERE, "examples"))
    from madrona_tpu_torch import make_sim, rollout
    from madrona_tpu_torch.interop import TrainInterface
    from madrona_tpu_torch.models.cartpole import Cartpole
    from madrona_tpu_torch.models.escape_room import EscapeRoom
    from madrona_tpu_torch.models.hanabi import Hanabi
    from madrona_tpu_torch.models.hide_seek import HideSeek
    from madrona_tpu_torch.models.overcooked import Overcooked
    from madrona_tpu_torch.models.pile import Pile
    from madrona_tpu_torch.models.projectiles import Projectiles
    import torch_train_ppo
    import torch_train_ppo_overcooked
    import torch_train_ppo_distributed
    import torch_train_ppo_pixels
    import torch_train_reinforce
    import torch_viewer_demo
    from madrona_tpu_torch.utils import checkpoint
    from madrona_tpu_torch.ops import (
        broadphase_cuda, contacts_cuda, cuda_build, fused_cuda,
        hh_narrowphase_cuda, lidar_cuda, raycast_cuda, solver_cuda,
    )

    t_start = time.perf_counter()

    def lap(label):
        """The seconds since the start at each phase, for the run's budget."""
        print(f"[phase {label} starts at {time.perf_counter() - t_start:.1f} s]")

    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)

    lap("1")
    # ---- 1. build
    t0 = time.perf_counter()
    libs = cuda_build.build(cuda_build.SOURCES)
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          + ", ".join(p.name for p in libs.values()))
    for src, log in cuda_build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {src}: {line.strip()}")
    usage = resource_usage(libs)

    lap("2-7")
    # ---- 2-7: kernels against their plain versions, on random scenes
    # and on a real Escape Room state (a probe sim, 3 steps in)
    acts = EscapeRoom.random_actions(np.random.RandomState(0), STEPS, W)
    acts = acts.to(DEV)
    probe = make_sim(EscapeRoom(), num_worlds=W, seed=1, device=DEV)
    for i in range(3):
        probe.step({"action": acts[i],
                    "reset": torch.zeros((W,), dtype=torch.int32,
                                         device=DEV)})
    bp_err = check_broadphase(probe)
    li_err = check_lidar(probe)
    co_err, so_err, hh_err, fu_err, scene = check_physics_kernels(probe)

    lap("8")
    # ---- 8: the main path, its kernel launches counted
    kernels = [broadphase_cuda.KERNEL, contacts_cuda.KERNEL,
               solver_cuda.KERNEL, lidar_cuda.KERNEL]
    sim, outs, secs, launches = run_main_path(make_sim, EscapeRoom, acts,
                                              kernels)
    for k, n in zip(kernels, launches):
        print(f"main path: {k.symbol} launched {n} times in {STEPS} steps")
        if n != STEPS:
            raise AssertionError(f"{k.symbol}: {n} launches != {STEPS}")
    for i, out in enumerate(outs):
        for name, v in out.items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise AssertionError(f"step {i}: export {name} not finite")
    final = outs[-1]
    if tuple(final["flat_obs"].shape) != (W, 2, 101):
        raise AssertionError(f"flat_obs shape {tuple(final['flat_obs'].shape)}")
    if not bool((final["steps_taken"] == STEPS).all()):
        raise AssertionError("steps_taken != steps")
    sps = W * (STEPS - 1) / secs
    print(f"main path: {W} worlds x {STEPS} steps, exports finite; "
          f"{secs * 1e3 / (STEPS - 1):.2f} ms/step, "
          f"{sps:.1f} env-steps/s ({card})")

    _, outs2, _, _ = run_main_path(make_sim, EscapeRoom, acts, [])
    for i, (a, b) in enumerate(zip(outs, outs2)):
        for name in a:
            if not torch.equal(a[name], b[name]):
                raise AssertionError(f"step {i}: {name} differs across "
                                     "fresh sims")
    print("main path: a fresh sim with the same seed is bit-identical")
    per_node = node_times(sim, acts)
    print("main path, ms/step by node (synchronized): " + ", ".join(
        f"{k} {v * 1e3:.2f}" for k, v in per_node.items()) + f" ({card})")
    del outs, outs2

    lap("9")
    # ---- 9: the card against the port's CPU path, small; no fallback
    check_card_vs_cpu(make_sim, EscapeRoom, "escape_room")
    check_no_fallback(
        make_sim(EscapeRoom(), num_worlds=SMALL_W, seed=0, device=DEV),
        kernels)

    lap("10")
    # ---- 10: the raycast kernel against its plain version, on a real
    # Hide & Seek state (a probe sim, 3 steps in) and on synthetic planes
    def pixels():
        return HideSeek(render_size=HS_RENDER)

    def state_only():
        return HideSeek(pixels=False)

    hs_acts = HideSeek.random_actions(np.random.RandomState(2), 3, HS_W)
    hs_probe = make_sim(pixels(), num_worlds=HS_W, seed=1, device=DEV)
    for i in range(3):
        hs_probe.step({"action": hs_acts[i].to(DEV),
                       "reset": torch.zeros((HS_W,), dtype=torch.int32,
                                            device=DEV)})
    ra_err, ray_scene = check_raycast(hs_probe)
    del hs_probe

    lap("11")
    # ---- 11: B1-B3 and B8 on an arranged Hide & Seek state
    hs_state_probe = make_sim(state_only(), num_worlds=HS_STATE_W, seed=1,
                              device=DEV)
    hs_state_probe.step({})
    hs_errs, hs_scene = check_hide_seek_physics(hs_state_probe)
    fu_err = max(fu_err, hs_errs[3])
    del hs_state_probe
    # both paths of the two tiled kernels ran: the record kernel's in
    # phase 6, the fused step's in phases 7 and 11
    for kernel, runs in (
        ("hh record", [scene["hh_counts"]["paths"],
                       scene["crowded_hh_counts"]["paths"]]),
        ("fused", [scene["fused_counts"]["paths"], hs_scene["fused_counts"][
            "paths"]] + [sp["fused_counts"]["paths"]
                         for sp in scene["spheres"].values()])):
        for path in ("warp", "thread"):
            if not sum(r[path] for r in runs):
                raise AssertionError(f"{kernel}: no tile took the {path} "
                                     "path")

    lap("12")
    # ---- 12: Hide & Seek's two launches, their kernel launches counted
    hs_kernels = [broadphase_cuda.KERNEL, contacts_cuda.KERNEL,
                  solver_cuda.KERNEL, raycast_cuda.KERNEL, lidar_cuda.KERNEL]
    _, hs_outs, hs_sps, _, hs_launches = check_path(
        make_sim, pixels, HS_W, hs_kernels, [STEPS] * 4 + [0],
        "hide_seek pixels", {
            "rgb": (HS_W, 4, HS_RENDER, HS_RENDER, 3),
            "depth": (HS_W, 4, HS_RENDER, HS_RENDER),
            "flat_obs": (HS_W, 4, 46), "visible": (HS_W, 2, 2)}, card)
    check_pixels(hs_outs[-1], "hide_seek pixels")
    del hs_outs
    hs_shapes = {"flat_obs": (HS_STATE_W, 4, 46),
                 "self_obs": (HS_STATE_W, 4, 10),
                 "visible": (HS_STATE_W, 2, 2)}
    check_path(make_sim, state_only, HS_STATE_W, hs_kernels,
               [STEPS] * 3 + [0, 0], "hide_seek state only", hs_shapes, card)

    lap("13")
    # ---- 13: Hide & Seek, the card against the CPU path; no fallback
    small_hs = check_hide_seek_small(make_sim,
                                     lambda: HideSeek(render_size=16))
    check_no_fallback(small_hs, [raycast_cuda.KERNEL], launch=("render",))
    check_no_fallback(small_hs, hs_kernels[:3], launch=("step",))
    del small_hs
    torch.cuda.empty_cache()

    lap("13a")
    # ---- 13a: the raycast kernel against its plain version on a real
    # state of the BLAS render tier (a probe sim, 3 steps in)
    def blas_pixels(**kw):
        return HideSeek(render_size=HS_RENDER, render_tier="blas", **kw)

    blas_probe = make_sim(blas_pixels(), num_worlds=HS_W, seed=1, device=DEV)
    for i in range(3):
        blas_probe.step({"action": hs_acts[i].to(DEV),
                         "reset": torch.zeros((HS_W,), dtype=torch.int32,
                                              device=DEV)})
    rb_err, blas_ray_scene = check_raycast_blas(blas_probe)
    del blas_probe

    lap("13b")
    # ---- 13b: the BLAS tier at full width, then with the per-view cull's
    # overlap export, their kernel launches counted
    blas_shapes = {"rgb": (HS_W, 4, HS_RENDER, HS_RENDER, 3),
                   "depth": (HS_W, 4, HS_RENDER, HS_RENDER),
                   "flat_obs": (HS_W, 4, 46), "visible": (HS_W, 2, 2)}
    _, b_outs, _, _, blas_launches = check_path(
        make_sim, blas_pixels, HS_W, hs_kernels, [STEPS] * 4 + [0],
        "hide_seek blas", blas_shapes, card)
    check_pixels(b_outs[-1], "hide_seek blas")
    del b_outs
    _, c_outs, _, _, _ = check_path(
        make_sim, lambda: blas_pixels(tlas_max_instances=8), HS_W,
        hs_kernels, [STEPS] * 4 + [0], "hide_seek blas tlas_max_instances=8",
        {**blas_shapes, "tlas_overlap": (HS_W, 4)}, card)
    ov = torch.stack([o["tlas_overlap"] for o in c_outs])
    print(f"hide_seek blas tlas_max_instances=8: tlas_overlap {ov.dtype}, "
          f"in [{int(ov.min())}, {int(ov.max())}], mean {float(ov.float().mean()):.3f}, "
          f"share of (world, view, step)s over K=8 "
          f"{float((ov > 8).float().mean()):.4f}")
    if ov.dtype != torch.int32 or int(ov.min()) < 0 or int(ov.max()) > 14:
        raise AssertionError("tlas_overlap out of range")
    check_pixels(c_outs[-1], "hide_seek blas tlas_max_instances=8")
    del c_outs, ov

    lap("13c")
    # ---- 13c: the BLAS tier, the card against the CPU path; no fallback
    small_blas = check_hide_seek_small(
        make_sim, lambda: HideSeek(render_size=16, render_tier="blas"),
        "hide_seek blas")
    check_no_fallback(small_blas, [raycast_cuda.KERNEL], launch=("render",),
                      label="hide_seek blas ('render',)")
    del small_blas
    torch.cuda.empty_cache()

    lap("14")
    # ---- 14: the physics tiers of this slice at full width: each path's
    # launches of all seven kernels counted, the record kernel's also by
    # SAT tier (B6 edge_dirs, B7 edge_pairs)
    hh_tiers = [hh_narrowphase_cuda.TIERS[True],
                hh_narrowphase_cuda.TIERS[False]]
    all_k = [broadphase_cuda.KERNEL, contacts_cuda.KERNEL,
             solver_cuda.KERNEL, lidar_cuda.KERNEL, raycast_cuda.KERNEL,
             hh_narrowphase_cuda.KERNEL, fused_cuda.KERNEL, *hh_tiers]
    er_shapes = {"flat_obs": (W, 2, 101)}
    path_launches = {}
    for what, make_env, w, want, shapes in (
        ("escape_room fused", lambda: with_physics(EscapeRoom(), **FUSED),
         W, (STEPS, 0, 0, STEPS, 0, 0, STEPS, 0, 0), er_shapes),
        ("hide_seek state only fused",
         lambda: with_physics(state_only(), **FUSED), HS_STATE_W,
         (STEPS, 0, 0, 0, 0, 0, STEPS, 0, 0), hs_shapes),
        ("escape_room kernel_sublane",
         lambda: with_physics(EscapeRoom(), **SUBLANE), W,
         (STEPS, 0, STEPS, STEPS, 0, STEPS, 0, STEPS, 0), er_shapes),
        ("escape_room kernel", lambda: with_physics(EscapeRoom(), **LANE_MAJOR),
         W, (STEPS, 0, STEPS, STEPS, 0, STEPS, 0, 0, STEPS), er_shapes),
    ):
        _, p_outs, _, _, path_launches[what] = check_path(
            make_sim, make_env, w, all_k, want, what, shapes, card)
        del p_outs
        torch.cuda.empty_cache()

    def split_er():
        return EscapeRoom()

    def fused_er():
        return with_physics(EscapeRoom(), **FUSED)

    turns = [("split", step_ms(make_sim, split_er, acts)),
             ("fused", step_ms(make_sim, fused_er, acts)),
             ("fused", step_ms(make_sim, fused_er, acts)),
             ("split", step_ms(make_sim, split_er, acts))]
    print(f"escape_room step, {W} worlds, in turns (ms/step): " + ", ".join(
        f"{k} {v:.2f}" for k, v in turns) + f" ({card})")

    lap("15")
    # ---- 15: the fused path, the card against the CPU path; no fallback
    # on the fused and the two hull-hull record paths
    check_card_vs_cpu(make_sim, fused_er, "escape_room fused")
    check_no_fallback(
        make_sim(fused_er(), num_worlds=SMALL_W, seed=0, device=DEV),
        [fused_cuda.KERNEL])
    for what, change in (("kernel_sublane", SUBLANE), ("kernel", LANE_MAJOR)):
        check_no_fallback(
            make_sim(with_physics(EscapeRoom(), **change),
                     num_worlds=SMALL_W, seed=0, device=DEV),
            [hh_narrowphase_cuda.KERNEL], label=f"escape_room {what}")
    torch.cuda.empty_cache()

    lap("16")
    # ---- 16: times at the main paths' shapes; each row's (bytes,
    # operations) kept in work for phase 35
    work = {}
    from madrona_tpu_torch.physics import api as papi
    from madrona_tpu_torch.physics import broadphase as bp

    env = sim.env
    om = env.om.to(DEV)
    body = papi.body_state(sim.executor.sm, sim.state)
    pack = broadphase_cuda.pack_bodies(body, om)
    cands = broadphase_cuda.broadphase(pack, env.caps, env.cfg.dt)
    bp_bytes, bp_ops = broadphase_cost(pack, cands)
    work["broadphase"] = (bp_bytes, bp_ops)
    bp_ms = kernel_ms(lambda: broadphase_cuda.broadphase(pack, env.caps,
                                                         env.cfg.dt))
    bp_route_ms = timed(lambda: broadphase_cuda.find_candidates_kernel(
        body, om, env.caps, env.cfg.dt))
    bp_plain_ms = timed(lambda: bp.find_candidates(body, om, env.caps,
                                                   env.cfg.dt), 50)

    largs = lidar_inputs(sim)
    depth = lidar_cuda.lidar_obb(*largs)
    li_ms = kernel_ms(lambda: lidar_cuda.lidar_obb(*largs))
    li_plain_ms = timed(lambda: plain_lidar(largs), 50)
    # the bound of what the function needs (the row's) and the same-work
    # yardstick of the source lidar.cu replaced
    n_agents, n_inst = largs[3].shape
    visible = lidar_visible(largs)
    li_bytes, li_ops = work["lidar"] = lidar_cost(largs, depth)
    _, same_ops = work["lidar same-work yardstick"] = lidar_same_work_cost(
        largs, depth)
    li_bound_ms, li_bound_by = bound(li_bytes, li_ops)
    same_ms, _ = bound(li_bytes, same_ops)
    print(f"lidar at the escape_room shape (W={W}, I={n_inst}, A="
          f"{n_agents}, R={largs[5].shape[2]}): bound of what the function "
          f"needs {li_bound_ms:.5f} ms ({li_bound_by}: {li_ops} ops, "
          f"{visible} visible (ray, box)), same-work yardstick of the "
          f"replaced source {same_ms:.5f} ms ({same_ops} ops) ({card})")
    print(f"broadphase route (pack + kernel): {bp_route_ms:.4f} ms")

    # contacts and solver on the probe's Escape Room scene (phases 4, 5)
    c_in, c_out, cnt = scene["args"], scene["contacts"], scene["counts"]
    om_s = scene["om"]
    co_bytes, co_ops = work["contacts"] = contacts_cost(c_in, om_s, c_out,
                                                          cnt)
    co_ms = kernel_ms(lambda: contacts_cuda.contacts(*c_in, om_s))
    contacts_split("escape_room", c_in, om_s, card)
    for tier, dirs in (("edge_dirs", True), ("edge_pairs", False)):
        cr_ms = timed_device(lambda: contacts_cuda.contacts(
            *scene["crowded_args"], scene["crowded_om"], dirs))
        print(f"contacts {tier} at the crowded scene (W={W}, caps 8/8/0): "
              f"device {cr_ms:.4f} ms ({card})")
    co_plain_ms = timed(lambda: contacts_cuda.contacts_plain(*c_in, om_s),
                        PLAIN_PHYSICS_ITERS)
    cfg = env.cfg
    s_in = (scene["state"], scene["param"], *c_out, *scene["jargs"])
    so_bytes, so_ops = work["substep_solver"] = solver_cost(
        cfg, scene["state"], scene["param"], c_out, scene["jargs"], cnt,
        scene["n_joints"], solver_cuda.substep_solver(cfg, *s_in))
    so_ms = kernel_ms(lambda: solver_cuda.substep_solver(cfg, *s_in))
    so_plain_ms = timed(
        lambda: solver_cuda.substep_solver_plain(cfg, *s_in),
        PLAIN_PHYSICS_ITERS)
    route_ms = timed(lambda: physics_route(body, om, env, scene["jargs"]),
                     50)
    print(f"physics route (B1 + integrate + packs + B2 + B3): "
          f"{route_ms:.4f} ms")

    # the hull-hull record (phase 6's Escape Room scene): B6 in the
    # edge_dirs tier, B7 in the edge_pairs tier; on the crowded box scene
    # their times and bounds only
    def hh_cost(args, om_, h_cnt, dirs, plain_iters):
        hh_in = (args[0], args[2], args[3])
        rec = hh_narrowphase_cuda.hh_record(*hh_in, om_, dirs)
        h_bytes, h_ops = hh_record_cost(*hh_in, om_, rec, h_cnt, dirs)
        h_ms = kernel_ms(lambda: hh_narrowphase_cuda.hh_record(*hh_in, om_,
                                                               dirs))
        h_plain_ms = (timed(lambda: hh_narrowphase_cuda.hh_record_plain(
            *hh_in, om_, dirs), plain_iters, 1) if plain_iters else None)
        return h_ms, h_plain_ms, h_bytes, h_ops

    hh_rows = {}
    for tier, dirs in (("edge_dirs", True), ("edge_pairs", False)):
        hh_rows[tier] = hh_cost(c_in, om_s, scene["hh_counts"][tier], dirs,
                                PLAIN_PHYSICS_ITERS)
        work[("hh_narrowphase_sublane" if dirs else "hh_narrowphase")] = \
            hh_rows[tier][2:]
        k_ms, _, b, ops = hh_cost(scene["crowded_args"], scene["crowded_om"],
                                  scene["crowded_hh_counts"][tier], dirs, 0)
        work[f"hh_narrowphase {tier} crowded"] = (b, ops)
        b_ms, b_by = bound(b, ops)
        print(f"hh_narrowphase {tier} at the crowded scene (W={W}, P=8): "
              f"wrapper {k_ms[0]:.4f} ms/launch, device {k_ms[1]:.4f} ms, "
              f"bound {b_ms:.5f} ms ({b_by}: {b} B, {ops} ops) ({card})")

    # the fused step: the Escape Room state with joints (phase 7) and the
    # arranged Hide & Seek state (phase 11)
    def fused_row(scene_):
        f_cfg, f_args, fc = (scene_["fused_cfg"], scene_["fused_args"],
                             scene_["fused_counts"])
        f_in = (*f_args[:8], f_args[8].hull_pack, f_args[8].hull_dirs_pack,
                *scene_["jargs"])
        out = fused_cuda.fused_step(f_cfg, *f_args, *scene_["jargs"])
        n_live_j = (int((scene_["jargs"][2][21] > 0.5).sum())
                    if scene_["jargs"] else 0)
        f_bytes, f_ops = fused_cost(f_cfg, f_in, out, fc, n_live_j)
        k_ms = kernel_ms(lambda: fused_cuda.fused_step(f_cfg, *f_args,
                                                       *scene_["jargs"]))
        pl_ms = timed(lambda: fused_cuda.fused_step_plain(
            f_cfg, *f_args, *scene_["jargs"]), PLAIN_PHYSICS_ITERS, 1)
        return k_ms, pl_ms, f_bytes, f_ops

    fu_ms, fu_plain_ms, fu_bytes, fu_ops = fused_row(scene)
    work["fused_step"] = (fu_bytes, fu_ops)
    hs_fu = fused_row(hs_scene)
    for tier, sp_scene in scene["spheres"].items():
        k_ms, pl_ms, b, ops = fused_row(sp_scene)
        work[f"fused_step {tier} spheres"] = (b, ops)
        b_ms, b_by = bound(b, ops)
        print(f"fused_step {tier} at the sphere scene (W={W}, N=21, caps "
              f"8/8/8): wrapper {k_ms[0]:.4f} ms/launch, device "
              f"{k_ms[1]:.4f} ms, plain {pl_ms:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by}: {b} B, {ops} ops) ({card})")

    # raycast at the pixel paths' shapes: phase 10's dense scene and
    # phase 13a's BLAS-tier scene
    ray_rows = {}
    for name, (r_planes, r_opts, n_rays) in (("raycast", ray_scene),
                                             ("raycast_blas", blas_ray_scene)):
        r_out = raycast_cuda.raytrace(*r_planes, **r_opts)
        r_bytes, r_ops = work[name] = raycast_cost(r_planes, r_opts, n_rays,
                                                     r_out)
        live_rows, shadow_pairs, hit_rays = ray_counts(r_planes, r_opts,
                                                       n_rays, r_out)
        wv, t_pad = r_planes[0].shape[:2]
        print(f"{name}: {live_rows} of {wv * t_pad} rows live, {hit_rays} "
              f"of {wv * n_rays} rays hit, {shadow_pairs} (hit ray, "
              f"shadow row) pairs, options {r_opts}")
        if name == "raycast":
            # every (view, padded ray, row): the yardstick of the kernel
            # before it skipped dead rows, the same work before and after
            _, all_ops = work["raycast every-row yardstick"] = \
                raycast_every_row_cost(r_planes, r_opts, r_out)
            all_ms, all_by = bound(r_bytes, all_ops)
            print(f"raycast: bound over every row (the same-work yardstick "
                  f"of the kernel that tested them all) {all_ms:.5f} ms "
                  f"({all_by}: {all_ops} ops) ({card})")
        del r_out
        ray_rows[name] = (
            kernel_ms(lambda: raycast_cuda.raytrace(*r_planes, **r_opts),
                      20, 2),
            timed(lambda: raycast_cuda.raytrace_plain(*r_planes, **r_opts),
                  2, 1),
            r_bytes, r_ops)

    # B1-B3 and B8 at Hide & Seek's shapes (phase 11's arranged scene,
    # 16,384 worlds), with bounds by the Escape Room rows' counts, beside
    # the rows of the Escape Room shapes
    hb, hom, hcfg = hs_scene["body"], hs_scene["om"], HideSeek(pixels=False)
    h_in = (hs_scene["state"], hs_scene["param"], *hs_scene["c_out"],
            *hs_scene["jargs"])
    h_pack = broadphase_cuda.pack_bodies(hb, hom)
    hs_cost = {
        "broadphase": broadphase_cost(
            h_pack, broadphase_cuda.broadphase(h_pack, hcfg.caps,
                                               hcfg.cfg.dt)),
        "contacts": contacts_cost(hs_scene["c_args"], hom, hs_scene["c_out"],
                                  hs_scene["counts"]),
        "substep_solver": solver_cost(
            hcfg.cfg, hs_scene["state"], hs_scene["param"],
            hs_scene["c_out"], hs_scene["jargs"], hs_scene["counts"],
            hs_scene["n_joints"],
            solver_cuda.substep_solver(hcfg.cfg, *h_in)),
        "fused_step": hs_fu[2:],
    }
    work.update({f"{k} hide_seek": v for k, v in hs_cost.items()})
    hs_ms = {
        "broadphase": (
            kernel_ms(lambda: broadphase_cuda.broadphase(h_pack, hcfg.caps,
                                                         hcfg.cfg.dt)),
            timed(lambda: bp.find_candidates(hb, hom, hcfg.caps,
                                             hcfg.cfg.dt), 20)),
        "contacts": (
            kernel_ms(lambda: contacts_cuda.contacts(*hs_scene["c_args"],
                                                     hom)),
            timed(lambda: contacts_cuda.contacts_plain(*hs_scene["c_args"],
                                                       hom),
                  PLAIN_PHYSICS_ITERS, 1)),
        "substep_solver": (
            kernel_ms(lambda: solver_cuda.substep_solver(hcfg.cfg, *h_in)),
            timed(lambda: solver_cuda.substep_solver_plain(hcfg.cfg, *h_in),
                  PLAIN_PHYSICS_ITERS, 1)),
        "fused_step": hs_fu[:2],
    }
    for (name, (k_ms, pl_ms)), err in zip(hs_ms.items(), hs_errs):
        b, ops = hs_cost[name]
        b_ms, b_by = bound(b, ops)
        print(f"{name} at the hide_seek shape (W={HS_STATE_W}, N=14, caps "
              f"7/9, J=4): wrapper {k_ms[0]:.4f} ms/launch, device "
              f"{k_ms[1]:.4f} ms, plain {pl_ms:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by}: {b} B, {ops} ops), max_abs_diff {err!r} ({card})")
    contacts_split("hide_seek", hs_scene["c_args"], hom, card)

    rows = []
    sub = path_launches["escape_room kernel_sublane"]
    lane = path_launches["escape_room kernel"]
    fused_l = path_launches["escape_room fused"]
    i_b6, i_b7, i_fu = (all_k.index(k) for k in (*hh_tiers,
                                                  fused_cuda.KERNEL))
    f_threads, f_blocks = fused_cuda.tiling(
        scene["fused_args"][0], *scene["fused_args"][4:7],
        scene["fused_args"][8])[2:]
    # the symbol of the kernel each wrapper launches, in cuobjdump's names
    symbols = {"hh_narrowphase.cu": "hh_record_kernel",
               "lidar.cu": "lidar_kernel",
               "fused_step.cu": f"fused_kernelILi{f_threads}ELi{f_blocks}E"}

    def resources(src):
        """(registers, stack bytes) of the kernel that src's wrapper
        launches."""
        file = os.path.basename(src)
        fns = usage.get(file, {})
        hits = [v for k, v in fns.items() if symbols.get(file, "") in k]
        return hits[0] if len(hits) == 1 else (None, None)

    for name, src, rep, n_launch, err, ms, plain_ms, b, ops in (
        ("broadphase", "madrona_tpu_torch/csrc/broadphase.cu",
         "madrona_tpu/ops/broadphase_pallas.py:160",
         launches[kernels.index(broadphase_cuda.KERNEL)],
         bp_err, bp_ms, bp_plain_ms, bp_bytes, bp_ops),
        ("contacts", "madrona_tpu_torch/csrc/contacts.cu",
         "madrona_tpu/ops/physics_megakernel.py:560",
         launches[kernels.index(contacts_cuda.KERNEL)],
         co_err, co_ms, co_plain_ms, co_bytes, co_ops),
        ("substep_solver", "madrona_tpu_torch/csrc/solver.cu",
         "madrona_tpu/ops/solver_pallas.py:709",
         launches[kernels.index(solver_cuda.KERNEL)],
         so_err, so_ms, so_plain_ms, so_bytes, so_ops),
        ("lidar", "madrona_tpu_torch/csrc/lidar.cu",
         "madrona_tpu/ops/lidar_pallas.py:53",
         launches[kernels.index(lidar_cuda.KERNEL)],
         li_err, li_ms, li_plain_ms, li_bytes, li_ops),
        ("raycast", "madrona_tpu_torch/csrc/raycast.cu",
         "madrona_tpu/ops/raycast_pallas.py:150",
         hs_launches[hs_kernels.index(raycast_cuda.KERNEL)],
         ra_err, *ray_rows["raycast"]),
        ("raycast_blas", "madrona_tpu_torch/csrc/raycast.cu",
         "madrona_tpu/ops/raycast_pallas.py:150",
         blas_launches[hs_kernels.index(raycast_cuda.KERNEL)],
         rb_err, *ray_rows["raycast_blas"]),
        ("hh_narrowphase_sublane", "madrona_tpu_torch/csrc/hh_narrowphase.cu",
         "madrona_tpu/ops/narrowphase_pallas.py:1227", sub[i_b6], hh_err,
         *hh_rows["edge_dirs"]),
        ("hh_narrowphase", "madrona_tpu_torch/csrc/hh_narrowphase.cu",
         "madrona_tpu/ops/narrowphase_pallas.py:403", lane[i_b7], hh_err,
         *hh_rows["edge_pairs"]),
        ("fused_step", "madrona_tpu_torch/csrc/fused_step.cu",
         "madrona_tpu/ops/physics_megakernel.py:287", fused_l[i_fu], fu_err,
         fu_ms, fu_plain_ms, fu_bytes, fu_ops),
    ):
        b_ms, b_by = bound(b, ops)
        regs, stack = resources(src)
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": n_launch, "max_abs_err": err,
            "ms": ms[0], "device_ms": ms[1], "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "registers": regs, "stack": stack,
        })
        if name == "lidar":
            rows[-1]["same_work_bound_ms"] = same_ms
        print(f"{name}: wrapper {ms[0]:.4f} ms/launch, device {ms[1]:.4f} "
              f"ms, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
              f"{b} B, {ops} ops), {regs} registers, {stack} B stack "
              f"({card})")
    lap("17")
    # ---- 17: rollout through two episodes, its kernel launches counted
    del largs, depth
    torch.cuda.empty_cache()
    check_rollout(make_sim, rollout, EscapeRoom, kernels, card)

    lap("18-22")
    # ---- 18-22: the many-body tier and the ECS envs; no kernel on these
    # paths, every counter must stay at 0
    torch.cuda.empty_cache()
    pile_ms, pile_acts, pile_saved = check_pile(make_sim, Pile, all_k, card)
    check_swept_vs_b1(make_sim, Pile, broadphase_cuda)
    check_pile_card_vs_cpu(make_sim, Pile, pile_acts, pile_saved)
    del pile_saved
    cart_ms = check_cartpole(make_sim, rollout, Cartpole, all_k, card)
    check_projectiles(make_sim, Projectiles, all_k, card)
    print("many-body tier and ECS envs, ms/step: " + ", ".join(
        f"pile {w} worlds {v:.2f}" for w, v in pile_ms.items())
        + f", cartpole {CART_W} worlds {cart_ms:.3f} ({card})")

    lap("23-26")
    # ---- 23-26: Hanabi, Overcooked and the learners; no kernel on these
    # paths, every counter must stay at 0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rates = {
        "hanabi 2p compact": check_discrete_env(
            make_sim, rollout, Hanabi, HAN_W, HAN_STEPS, all_k, card,
            "hanabi 2 players compact", hanabi_checks(2)),
        "hanabi 5p card_knowledge": check_discrete_env(
            make_sim, rollout, lambda: Hanabi(5, "card_knowledge"), HAN5_W,
            HAN5_STEPS, all_k, card, "hanabi 5 players card_knowledge",
            hanabi_checks(5)),
    }
    for layout in ("cramped_room", "asymmetric_advantages"):
        rates[f"overcooked {layout}"] = check_discrete_env(
            make_sim, rollout, functools.partial(Overcooked, layout), OC_W,
            OC_STEPS, all_k, card, f"overcooked {layout}",
            overcooked_checks, fresh_steps=OC_FRESH_STEPS)
    check_reinforce(make_sim, Cartpole, TrainInterface,
                    torch_train_reinforce, all_k, card)
    check_ppo_overcooked(torch_train_ppo, torch_train_ppo_overcooked, all_k,
                         card)
    print("hanabi, overcooked and the learners: "
          f"{time.perf_counter() - t0:.1f} s; env-steps/s, launches/step: "
          + ", ".join(f"{k} {r:.1f}, {n}" for k, (r, n) in rates.items())
          + f" ({card})")

    lap("27-30")
    # ---- 27-30: the physics toolkit's paths: the events export (B1, B6,
    # B3), TGS on Escape Room (B1, B6 at every substep, B4), the
    # Gauss-Seidel oracle (B1); the queries, no kernel
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    new_paths = {
        "events": check_events(all_k, card),
        "tgs": check_tgs(make_sim, EscapeRoom, all_k, card),
        "gauss_seidel": check_gauss_seidel(all_k, card),
    }
    check_queries(sim, card)
    print(f"physics toolkit phases: {time.perf_counter() - t0:.1f} s; ms a "
          "step: " + ", ".join(f"{k} {v[1]:.3f}" for k, v in new_paths.items())
          + f" ({card})")
    # each row's launches on the new paths, from its own counter: B6 and
    # B7 from the record kernel's tier counts; the two raycast rows share
    # the raycast kernel's count, which these paths hold at 0
    counter = {"broadphase": broadphase_cuda.KERNEL,
               "contacts": contacts_cuda.KERNEL,
               "substep_solver": solver_cuda.KERNEL,
               "lidar": lidar_cuda.KERNEL, "raycast": raycast_cuda.KERNEL,
               "raycast_blas": raycast_cuda.KERNEL,
               "hh_narrowphase_sublane": hh_tiers[0],
               "hh_narrowphase": hh_tiers[1],
               "fused_step": fused_cuda.KERNEL}

    lap("31")
    # ---- 31: the asset importers, bake_assets_blas and B5 on the
    # imported scene; the walkers and ray_chunk on the card
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    later = {}
    later["assets"], _, asset_err = check_assets(all_k, card)
    print(f"phase 31: {time.perf_counter() - t0:.1f} s ({card})")

    lap("31b")
    # ---- 31b: JPEG and 16-bit interlaced PNG textures decoded without
    # PIL, imported and rendered through B5
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    later["image_assets"], image_err = check_image_assets(all_k, card)
    asset_err = max(asset_err, image_err)
    print(f"phase 31b: {time.perf_counter() - t0:.1f} s ({card})")

    lap("31c")
    # ---- 31c: BMP, TGA, GIF and WebP textures decoded without PIL,
    # imported and rendered through B5
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    later["image_formats"], format_err = check_format_assets(all_k, card)
    asset_err = max(asset_err, format_err)
    print(f"phase 31c: {time.perf_counter() - t0:.1f} s ({card})")

    lap("31d")
    # ---- 31d: DDS, PBM/PGM/PPM/PFM, QOI and ICO/CUR textures decoded
    # without PIL, imported and rendered through B5
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    later["image_formats_2"], format2_err = check_format2_assets(all_k, card)
    asset_err = max(asset_err, format2_err)
    print(f"phase 31d: {time.perf_counter() - t0:.1f} s ({card})")

    lap("31e")
    # ---- 31e: TIFF textures decoded without PIL, imported and rendered
    # through B5
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    later["image_formats_3"], format3_err = check_format3_assets(all_k, card)
    asset_err = max(asset_err, format3_err)
    print(f"phase 31e: {time.perf_counter() - t0:.1f} s ({card})")

    lap("32")
    # ---- 32: the pixel learner at its defaults on both render tiers
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    later.update(check_ppo_pixels(
        torch_train_ppo_pixels, all_k,
        [broadphase_cuda.KERNEL, contacts_cuda.KERNEL, solver_cuda.KERNEL,
         raycast_cuda.KERNEL], card))
    print(f"phase 32: {time.perf_counter() - t0:.1f} s ({card})")

    lap("33")
    # ---- 33: per-world checkpoints, the npz round trip, a PPO resume
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check_checkpoints(make_sim, EscapeRoom, torch_train_ppo, checkpoint,
                      all_k, card)
    print(f"phase 33: {time.perf_counter() - t0:.1f} s ({card})")
    for row in rows:
        i = all_k.index(counter[row["name"]])
        row["launches_by_path"] = {
            path: counts[i] for path, (counts, _) in new_paths.items()}
        row["launches_by_path"].update(
            {path: counts[i] for path, counts in later.items()})
        if row["name"] == "raycast_blas":
            row["max_abs_err"] = max(row["max_abs_err"], asset_err)

    lap("34")
    # ---- 34: node tracing and the debug checks on Escape Room
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check_tracing_debug(make_sim, EscapeRoom, kernels, acts, card)
    print(f"phase 34: {time.perf_counter() - t0:.1f} s ({card})")

    lap("35")
    # ---- 35: every bound from utils/roofline.py; bench_roofline
    check_roofline(work, {"escape_room": sps, "hide_seek_pixels": hs_sps},
                   HideSeek, card)

    lap("36")
    # ---- 36: the navmesh's batched queries
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check_navmesh(card)
    print(f"phase 36: {time.perf_counter() - t0:.1f} s ({card})")

    lap("37")
    # ---- 37: worlds sharded (parallel/), distributed PPO over NCCL
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check_sharded_steps(make_sim, EscapeRoom, kernels, acts, card)
    check_distributed_ppo(torch_train_ppo_distributed, all_k, card)
    print(f"phase 37: {time.perf_counter() - t0:.1f} s ({card})")

    lap("38")
    # ---- 38: the viewer, the recorder and the playback viewer
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check_viz(torch_viewer_demo, kernels, card)
    print(f"phase 38: {time.perf_counter() - t0:.1f} s ({card})")

    lap("39")
    # ---- 39: the composed launch of Hide & Seek's two graphs against
    # sim.step(); Escape Room's exports through get_exported
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check_launch_graph(make_sim, HideSeek, EscapeRoom, all_k,
                       [broadphase_cuda.KERNEL, contacts_cuda.KERNEL,
                        solver_cuda.KERNEL, raycast_cuda.KERNEL], acts, card)
    print(f"phase 39: {time.perf_counter() - t0:.1f} s ({card})")

    lap("40")
    # ---- 40: the weak-scaling script as one rank over NCCL
    torch.cuda.empty_cache()
    check_weak_scaling(kernels, card)

    lap("41")
    # ---- 41: the step and each physics phase alone
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    check_phases(make_sim, EscapeRoom, acts, card)
    print(f"phase 41: {time.perf_counter() - t0:.1f} s ({card})")

    lap("end")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
