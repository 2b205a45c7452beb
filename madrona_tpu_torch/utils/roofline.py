"""The H100's roofline: the least time the card could take for the work.

Port of ``madrona_tpu/utils/roofline.py``, rebuilt for one NVIDIA H100
(the JAX module models a TPU's vector unit). Peaks, from NVIDIA's H100
SXM data sheet at its 700 W power limit: 3.35 TB/s of HBM and 67
TFLOP/s of float32 outside the tensor cores. A card set below 700 W
(``nvidia-smi --query-gpu=power.limit``) runs slower under load, so a
share of this roofline is stated beside the card's power limit.

Every kernel of the port has a cost function here that counts one
launch's work from its inputs' shapes and its live lanes: the bytes the
function must move (each input read once, each output written once)
and the float32 operations it must do on this call's data (a lane that
holds no candidate costs nothing). :func:`bound` turns them into the
least milliseconds: the larger of bytes / :data:`PEAK_BYTES` and
operations / :data:`PEAK_F32`. Where a kernel's row keeps a source's own
yardstick beside its bound (the lidar's "120 every (ray, box)" of the
source ``csrc/lidar.cu`` replaced, the raycast's every-row count), the
function says so in its name.

The operation counts per unit are hand counts of each kernel's
arithmetic (``csrc/*.cu``); the comments below give their parts.

:func:`sim_hbm_floor_s`, :func:`render_floor_s` and
:func:`bench_roofline` are the bench's models: env-steps/s at the HBM
floor of the persistent body state, and at the raycast kernel's
operations on the live rows of a world's views.
"""

from __future__ import annotations

from typing import Optional

import torch

# NVIDIA H100 SXM data sheet, at the 700 W power limit: HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12

# broadphase (csrc/broadphase.cu): ~111 per body (rotation matrix 33,
# center/extent 21, center row sums 18, extent row sums 24, velocity
# expansion 15) and ~12 per pair (6 compares, 6 ands/branches)
BP_OPS_PER_BODY = 111
BP_OPS_PER_PAIR = 12
# lidar (csrc/lidar.cu), what the function needs: the origin's box-local
# coordinates once a (world, agent, box), ~39 (rotation 30, subtraction
# 3, guards 3, divisions 3); ~78 a (ray, box) the self-mask shows (one
# rotation 30, reciprocals and divisions 15, slab 22, hit test and
# running min 11) and one test a hidden one. The same-work yardstick of
# the source csrc/lidar.cu replaced: ~120 every (ray, box) (two
# quaternion rotations 60, guards and divisions 27, slab 22, the hit test
# and running min 11).
LIDAR_OPS_PER_RAY_BOX = 120
LIDAR_OPS_PER_ORIGIN_BOX = 39
LIDAR_OPS_PER_VISIBLE_RAY_BOX = 78
# contacts (csrc/contacts.cu), per lane. A hull to world space ~825 (8
# vertices x 36, 6 planes x 85, center 27). A hull-hull candidate up to
# its separation test ~3,800: two hulls 1,650, face queries both ways 672
# (2 x 6 faces x 8 vertices x 7), edge query ~1,500 (9 direction pairs x
# ~125, the directions' transforms ~400). A face manifold ~3,300 (two
# polygons 288, side planes 68, 20 clip candidates ~860, projection 240,
# the reduction over 20 points ~1,800); an edge contact ~2,000 (two
# witness-edge sweeps of 12 edges x ~80, closest point ~60). A
# hull-plane candidate ~910 (hull 825, vertex distances 56, plane normal
# 30); its manifold ~610 (incident face 30, polygon 144, projection 48,
# reduction over 4 points ~350, tail 40).
HH_OPS_CANDIDATE = 3800
HH_OPS_FACE = 3300
HH_OPS_EDGE = 2000
HP_OPS_CANDIDATE = 910
HP_OPS_CONTACT = 610
# substep solver (csrc/solver.cu), per substep: integrate ~200 per
# movable body; a live contact's position pass ~700 per Jacobi
# iteration, its velocity pass ~350 plus ~450 per live manifold point; a
# live joint ~900.
SOLVER_OPS_BODY = 200
SOLVER_OPS_CONTACT_POS = 700
SOLVER_OPS_CONTACT_VEL = 350
SOLVER_OPS_POINT = 450
SOLVER_OPS_JOINT = 900
# hull-hull record (csrc/hh_narrowphase.cu): the contacts kernel's
# hull-hull lane, so HH_OPS_* in the edge_dirs tier. In the edge_pairs
# tier a candidate costs ~19,600 up to its separation test: two hulls
# 1,650, face queries 672, 24 edges to world space (2 points x 36, 2
# normals x 85: ~240 each, 5,800), 144 pairs x ~80 (Gauss-map test 38,
# cross and length 14, normalize 5, orientation 8, separation 8, the
# running best 7); its edge contact ~60 (no witness sweep).
HH_OPS_CANDIDATE_PAIRS = 19600
HH_OPS_EDGE_PAIRS = 60
# fused step (csrc/fused_step.cu): the predicted-pose integrate ~200 per
# body; the lanes as above; a sphere lane ~3,100 against a hull (hull
# 825, face distances 42, vertices 64, 12 edges x ~50, 6 faces x ~260,
# tail 40), ~40 against a plane, ~30 against a sphere; then the solver's
# counts over all rows.
SPHERE_OPS_HULL = 3100
SPHERE_OPS_PLANE = 40
SPHERE_OPS_SPHERE = 30
# raycast (csrc/raycast.cu). Per (ray, triangle) primary test ~30 (three
# 3-term dot products 15, abs, sign folds 2, division, t, six compares
# and their ands, the running minimum); the shadow test ~28 more where on
# (three dot products 15, three affine terms 6, add, five compares and
# ands). Per ray ~40 (16 attribute reads, shade 6, compose and sky select
# 9, eight plane writes), ~90 more with materials (uv 8, texel addresses
# ~40, 12 taps and their weights 36).
RAY_OPS_PAIR = 30
RAY_OPS_PAIR_SHADOW = 28
RAY_OPS_RAY = 40
RAY_OPS_RAY_MATERIALS = 90


def bound(nbytes_: float, ops: float):
    """(least ms the card could take, "bytes" or "operations"): the
    larger of the bytes over the memory rate and the operations over the
    float32 rate."""
    t_bytes, t_ops = nbytes_ / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def referenced_row_bytes(poses, obj, *cands) -> int:
    """Bytes of poses [N, F, W] and obj [N, W] that a narrowphase kernel
    must read: the rows that a live candidate of ``cands`` ([W, P, 2]
    rows, sentinel N) names, each (row, world) once."""
    n, f, w = poses.shape
    used = torch.zeros((n + 1, w), dtype=torch.bool, device=poses.device)
    worlds = torch.arange(w, device=poses.device)
    for c in cands:
        live = (c[..., 0] < n) & (c[..., 1] < n)                # [W, P]
        for side in (0, 1):
            rows = torch.where(live, c[..., side], n).long()
            used[rows, worlds[:, None].expand_as(rows)] = True
    return int(used[:n].sum()) * (f * poses.element_size()
                                  + obj.element_size())


def live_lane_bytes(ref, alt, con, pts, num) -> int:
    """Bytes of contact tables [.., C, W] that a solver must read: every
    lane's count, and the rows, reduced contact and points of the live
    lanes."""
    per_lane = (ref.element_size() + alt.element_size()
                + con.shape[0] * con.element_size()
                + pts.shape[0] * pts.element_size())
    return nbytes(num) + int((num > 0).sum()) * per_lane


# --------------------------------------------------------------- kernels

def broadphase_cost(pack, cands):
    """B1 (bytes, operations): the body pack [F, N, W] in, the candidate
    lists out; every body transformed, every pair tested."""
    _, n, w = pack.shape
    b = nbytes(pack, *[getattr(cands, f) for f in (
        "hh", "hh_num", "hp", "hp_num", "sp", "sp_num", "sp_kind",
        "overflow")])
    return b, w * (BP_OPS_PER_BODY * n + BP_OPS_PER_PAIR * n * (n - 1) // 2)


def lidar_visible(args) -> int:
    """(ray, box) pairs that the self-mask shows, over all worlds, of the
    lidar's arguments (inst_pos, inst_rot, inst_half, self_mask [A, I],
    origins, dirs [W, A, R, 3], t_max)."""
    w, rays = args[0].shape[0], args[5].shape[2]
    return int(args[3].sum()) * rays * w


def lidar_cost(args, depth):
    """B4 (bytes, operations) of what the function needs: its six tensor
    inputs and the depth out; the origin's box-local coordinates once a
    (world, agent, box), the full test of each visible (ray, box) and one
    test of each hidden one."""
    w = args[0].shape[0]
    n_agents, n_inst = args[3].shape
    visible = lidar_visible(args)
    ops = (LIDAR_OPS_PER_VISIBLE_RAY_BOX * visible
           + (depth.numel() * n_inst - visible)
           + LIDAR_OPS_PER_ORIGIN_BOX * w * n_agents * n_inst)
    return nbytes(*args[:6], depth), ops


def lidar_same_work_cost(args, depth):
    """B4's same-work yardstick of the source ``csrc/lidar.cu`` replaced:
    the same bytes, ~120 operations every (ray, box)."""
    n_inst = args[3].shape[1]
    return nbytes(*args[:6], depth), depth.numel() * n_inst * \
        LIDAR_OPS_PER_RAY_BOX


def contacts_cost(c_in, om, c_out, cnt):
    """B2 (bytes, operations) on inputs c_in (hh, hp, poses, obj) with
    outputs c_out and the lane counts ``cnt`` (hh_candidates, hh_live,
    hh_1pt, hp_candidates, hp_live): the pose rows a live candidate
    names, the hull tables, the tables out; the live lanes'
    arithmetic."""
    b = (nbytes(c_in[0], c_in[1], om.hull_pack, om.hull_dirs_pack, *c_out)
         + referenced_row_bytes(c_in[2], c_in[3], c_in[0], c_in[1]))
    ops = (HH_OPS_CANDIDATE * cnt["hh_candidates"]
           + HH_OPS_FACE * (cnt["hh_live"] - cnt["hh_1pt"])
           + HH_OPS_EDGE * cnt["hh_1pt"]
           + HP_OPS_CANDIDATE * cnt["hp_candidates"]
           + HP_OPS_CONTACT * cnt["hp_live"])
    return b, ops


def solver_cost(cfg, state, param, c_out, jargs, cnt, n_joints, s_out):
    """B3 (bytes, operations): state, params, joints and out once, the
    live contact lanes; per substep every row of the dynamic range, each
    ok contact (``cnt["ok"]``), live manifold point and live joint."""
    b = nbytes(state, param, *jargs, s_out) + live_lane_bytes(*c_out)
    live_points = int(torch.where(c_out[2][7] > 0.5, c_out[4], 0).sum())
    n, w = state.shape[1:]
    d0, d1 = cfg.solver_dynamic_range or (0, n)
    ops = cfg.substeps * (
        SOLVER_OPS_BODY * (d1 - d0) * w
        + (SOLVER_OPS_CONTACT_POS * cfg.jacobi_iters + SOLVER_OPS_CONTACT_VEL)
        * cnt["ok"]
        + SOLVER_OPS_POINT * live_points
        + SOLVER_OPS_JOINT * n_joints)
    return b, ops


def hh_record_cost(hh, poses, obj, om, rec, cnt, dirs: bool):
    """B6 (``dirs``, the edge_dirs tier) or B7 (edge_pairs) (bytes,
    operations): the candidates, hull tables and record, the pose rows a
    live candidate names; each candidate up to its separation test, each
    face manifold and each edge contact of the tier."""
    b = (nbytes(hh, om.hull_pack, rec)
         + (nbytes(om.hull_dirs_pack) if dirs else 0)
         + referenced_row_bytes(poses, obj, hh))
    face = cnt["hh_live"] - cnt["hh_1pt"]
    if dirs:
        ops = (HH_OPS_FACE * face + HH_OPS_CANDIDATE * cnt["hh_candidates"]
               + HH_OPS_EDGE * cnt["hh_1pt"])
    else:
        ops = (HH_OPS_FACE * face
               + HH_OPS_CANDIDATE_PAIRS * cnt["hh_candidates"]
               + HH_OPS_EDGE_PAIRS * cnt["hh_1pt"])
    return b, ops


def fused_cost(cfg, inputs, out, cnt, n_live_joints: int):
    """B8 (bytes, operations): every input and the output once; the
    predicted poses, the narrowphase's live lanes by kind (``cnt``:
    movable, hh_candidates, hh_live, hh_1pt, hp_candidates, hp_live,
    sp_hull, sp_plane, sp_sphere), then per substep the solver's counts
    (ok contacts, live points, live joints)."""
    ops = (
        SOLVER_OPS_BODY * cnt["movable"]
        + HH_OPS_CANDIDATE * cnt["hh_candidates"]
        + HH_OPS_FACE * (cnt["hh_live"] - cnt["hh_1pt"])
        + HH_OPS_EDGE * cnt["hh_1pt"]
        + HP_OPS_CANDIDATE * cnt["hp_candidates"]
        + HP_OPS_CONTACT * cnt["hp_live"]
        + SPHERE_OPS_HULL * cnt["sp_hull"]
        + SPHERE_OPS_PLANE * cnt["sp_plane"]
        + SPHERE_OPS_SPHERE * cnt["sp_sphere"]
        + cfg.substeps * (
            SOLVER_OPS_BODY * cnt["movable"]
            + (SOLVER_OPS_CONTACT_POS * cfg.jacobi_iters
               + SOLVER_OPS_CONTACT_VEL) * cnt["ok"]
            + SOLVER_OPS_POINT * cnt["points"]
            + SOLVER_OPS_JOINT * n_live_joints))
    return nbytes(*inputs, out), ops


def ray_counts(planes, opts, n_rays, out):
    """(live rows, (hit ray, shadow row) pairs, rays that hit) of a
    raycast run: a row whose columns 0..2 (A) are all zero has det 0 for
    every ray and cannot hit; a shadow row is on where column 22
    (|det_s|) is nonzero; a ray hit where its t is below t_max."""
    from ..ops import raycast_cuda as rck

    setup = planes[0]
    live = (setup[..., :3] != 0).any(dim=-1)                   # [WV, T]
    hits = (out[:, rck.O_T, :n_rays] < opts["t_max"]).sum(dim=1)  # [WV]
    shadow_pairs = 0
    if opts["shadows"]:
        shadow_rows = (live & (setup[..., 22] != 0)).sum(dim=1)
        shadow_pairs = int((hits * shadow_rows).sum())
    return int(live.sum()), shadow_pairs, int(hits.sum())


def raycast_cost(planes, opts, n_rays, out):
    """B5 (bytes, operations) on this run's data: the planes in and out
    once; the primary test of every real ray against the live rows only,
    the shadow test of every ray that hit against the live rows whose
    shadow row is on, per ray the shading, and with materials the atlas
    sample of every ray that hit."""
    live_rows, shadow_pairs, hit_rays = ray_counts(planes, opts, n_rays,
                                                   out)
    wv = planes[0].shape[0]
    ops = (n_rays * live_rows * RAY_OPS_PAIR
           + shadow_pairs * RAY_OPS_PAIR_SHADOW
           + wv * n_rays * RAY_OPS_RAY
           + (hit_rays * RAY_OPS_RAY_MATERIALS if opts["use_materials"]
              else 0))
    return nbytes(*planes, out), ops


def raycast_every_row_cost(planes, opts, out):
    """B5's same-work yardstick of the kernel before it skipped dead
    rows: every (view, padded ray, row) tested, the same bytes."""
    wv, t_pad = planes[0].shape[:2]
    per_ray = RAY_OPS_RAY + (RAY_OPS_RAY_MATERIALS if opts["use_materials"]
                             else 0)
    shadow = RAY_OPS_PAIR_SHADOW if opts["shadows"] else 0
    return nbytes(*planes, out), out.shape[2] * wv * (
        t_pad * (RAY_OPS_PAIR + shadow) + per_ray)


# ---------------------------------------------------------- bench models

def sim_hbm_floor_s(num_worlds: int, n_bodies: int,
                    state_floats: int = 13) -> float:
    """Seconds a step to read and write the persistent body state once
    at the HBM peak."""
    byts = 2 * num_worlds * n_bodies * state_floats * 4
    return byts / PEAK_BYTES


def render_live_rows(env) -> int:
    """Live rows of one world's views, summed: the rows
    :func:`ray_counts` counts live in the raycast kernel's setup planes.
    A view's rows are every instance's triangle rows (the tables the
    renderer gives the kernel: the BLAS tier's where it has one, else the
    dense mesh's); a row is live where the view's mask shows the instance
    and the triangle's A = e2 x e1 is nonzero (a padded row's is zero)."""
    from .math3d import cross

    rsys = env.rsys
    tables = rsys.blas if rsys.blas is not None else rsys.mesh
    a = cross(tables.tri_e2.cpu(), tables.tri_e1.cpu())       # [O, T, 3]
    per_obj = (a != 0).any(dim=-1).sum(dim=-1)                # [O]
    per_inst = per_obj[rsys.render_obj.long()]                # [N]
    return int((rsys.view_mask.long() * per_inst).sum())


def render_floor_s(num_worlds: int, n_views: int, rays_per_view: int,
                   live_rows: int) -> float:
    """Seconds a step of the raycast kernel's (B5's) operations at the
    float32 peak: the primary test of every ray against the ``live_rows``
    of a world's views (:func:`render_live_rows`), and every ray's
    shading. The shadow test and the atlas sample run only for rays that
    hit, which no static shape tells, so this floor leaves them out; on a
    run's own data :func:`raycast_cost` counts them."""
    ops = rays_per_view * (live_rows * RAY_OPS_PAIR + n_views * RAY_OPS_RAY)
    return num_worlds * ops / PEAK_F32


def bench_roofline(num_worlds: int, measured_rate,
                   env=None) -> Optional[dict]:
    """The roofline dict of a bench row, {"model",
    "sol_env_steps_per_sec", "pct_of_roofline"}, for ``measured_rate``
    env-steps/s of ``env``: "render_ops" (:func:`render_floor_s` at the
    renderer's width x height rays a view) for an env that renders its
    steps, else "sim_hbm_floor" (:func:`sim_hbm_floor_s`) for an env that states
    its body count (``n_total`` or ``num_bodies``); None where neither
    model applies."""
    if env is None:
        return None
    # an env renders a step where it has a renderer and, where it has
    # the switch (Hide & Seek's ``pixels``), the switch is on
    if (getattr(env, "rsys", None) is not None
            and getattr(env, "pixels", True)):
        sol_t = render_floor_s(
            num_worlds, len(env.rsys.camera_rows),
            env.rcfg.width * env.rcfg.height, render_live_rows(env))
        sol = num_worlds / sol_t
        return {"model": "render_ops",
                "sol_env_steps_per_sec": round(sol, 1),
                "pct_of_roofline": round(100.0 * measured_rate / sol, 1)}
    n_bodies = next((int(getattr(env, a)) for a in ("n_total", "num_bodies")
                     if hasattr(env, a)), None)
    if n_bodies is None:
        return None
    sol = num_worlds / sim_hbm_floor_s(num_worlds, n_bodies)
    return {"model": "sim_hbm_floor",
            "sol_env_steps_per_sec": round(sol, 1),
            "pct_of_roofline": round(100.0 * measured_rate / sol, 3)}
