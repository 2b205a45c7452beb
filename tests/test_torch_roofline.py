"""The H100 roofline (madrona_tpu_torch/utils/roofline.py) on the CPU.

Every count function on a fixed small scene against bytes and operations
computed by hand in this file (no tolerance: integers, and the float
bounds equal to the same formula); the peaks and ``sim_hbm_floor_s`` at
the data sheet's 3.35 TB/s and 67 TFLOP/s; ``bench_roofline``'s keys
(the JAX function's) for Escape Room and Hide & Seek's pixels, its
render floor on the live rows the raycast kernel's planes carry, and
None where no model applies; and chip_smoke.py holds no copy of a peak or
count: the names it uses are the package's.
"""

import types

import torch

from madrona_tpu.models.escape_room import EscapeRoom as JEscapeRoom
from madrona_tpu.utils import roofline as j_roofline
from madrona_tpu_torch.models.cartpole import Cartpole
from madrona_tpu_torch.models.escape_room import EscapeRoom
from madrona_tpu_torch.models.hide_seek import HideSeek
from madrona_tpu_torch.ops import raycast_cuda as rck
from madrona_tpu_torch.utils import roofline as rl
from madrona_tpu_torch.utils import tracing

torch.set_num_threads(1)

f32, i32 = torch.float32, torch.int32


def z(*shape, dtype=f32):
    return torch.zeros(shape, dtype=dtype)


def test_peaks_bound_and_floors():
    assert (rl.PEAK_BYTES, rl.PEAK_F32) == (3.35e12, 67e12)
    assert rl.bound(3.35e9, 1.0) == (1.0, "bytes")
    assert rl.bound(1.0, 67e9) == (1.0, "operations")
    assert rl.sim_hbm_floor_s(4096, 21) == 2 * 4096 * 21 * 13 * 4 / 3.35e12
    # 2 worlds of 4 views, 16 rays a view, 10 live rows over a world's views
    assert rl.render_floor_s(2, 4, 16, 10) == \
        2 * 16 * (10 * 30 + 4 * 40) / 67e12


def test_broadphase_and_lidar_counts():
    w, n = 3, 5
    pack = z(20, n, w)
    cands = types.SimpleNamespace(
        hh=z(w, 4, 2, dtype=i32), hh_num=z(w, dtype=i32),
        hp=z(w, 2, 2, dtype=i32), hp_num=z(w, dtype=i32),
        sp=z(w, 1, 2, dtype=i32), sp_num=z(w, dtype=i32),
        sp_kind=z(w, 1, dtype=i32), overflow=z(w, dtype=i32))
    b = 20 * n * w * 4 + (24 + 3 + 12 + 3 + 6 + 3 + 3 + 3) * 4
    assert rl.broadphase_cost(pack, cands) == (b, 3 * (111 * 5 + 12 * 10))
    # lidar: 2 worlds, 3 boxes, 2 agents of 4 rays; agent 0 sees boxes 0
    # and 1, agent 1 box 0: 12 visible (ray, box) a world
    mask = torch.tensor([[True, True, False], [True, False, False]])
    args = (z(2, 3, 3), z(2, 3, 4), z(2, 3, 3), mask, z(2, 2, 3),
            z(2, 2, 4, 3), 30.0)
    depth = z(2, 2, 4)
    assert rl.lidar_visible(args) == 24
    b = 72 + 96 + 72 + 6 + 48 + 192 + 64
    assert rl.lidar_cost(args, depth) == (
        b, 78 * 24 + (16 * 3 - 24) + 39 * 2 * 2 * 3)
    assert rl.lidar_same_work_cost(args, depth) == (b, 16 * 3 * 120)


def _narrow_scene():
    """Poses of 4 rows (7 floats) in 2 worlds; hull-hull candidates
    w0 (1, 2) and a sentinel, w1 (2, 3) and (1, 3); hull-plane w0 (0, 1),
    w1 a sentinel."""
    poses, obj = z(4, 7, 2), z(4, 2, dtype=i32)
    hh = torch.tensor([[[1, 2], [4, 4]], [[2, 3], [1, 3]]], dtype=i32)
    hp = torch.tensor([[[0, 1]], [[4, 4]]], dtype=i32)
    om = types.SimpleNamespace(hull_pack=z(10), hull_dirs_pack=z(6))
    cnt = dict(hh_candidates=3, hh_live=2, hh_1pt=1, hp_candidates=1,
               hp_live=1)
    return poses, obj, hh, hp, om, cnt


def test_contacts_and_hh_record_counts():
    poses, obj, hh, hp, om, cnt = _narrow_scene()
    row = 7 * 4 + 4
    # (row, world) pairs named: w0 {1, 2}, w1 {1, 2, 3}; with hp w0 {0}
    assert rl.referenced_row_bytes(poses, obj, hh) == 5 * row
    c_out = (z(5), z(3, dtype=i32))
    assert rl.contacts_cost((hh, hp, poses, obj), om, c_out, cnt) == (
        32 + 16 + 40 + 24 + 32 + 6 * row,
        3800 * 3 + 3300 * 1 + 2000 * 1 + 910 * 1 + 610 * 1)
    rec = z(4)
    assert rl.hh_record_cost(hh, poses, obj, om, rec, cnt, True) == (
        32 + 40 + 16 + 24 + 5 * row, 3300 + 3800 * 3 + 2000)
    assert rl.hh_record_cost(hh, poses, obj, om, rec, cnt, False) == (
        32 + 40 + 16 + 5 * row, 3300 + 19600 * 3 + 60)


def test_solver_and_fused_counts():
    cfg = types.SimpleNamespace(substeps=2, jacobi_iters=3,
                                solver_dynamic_range=(1, 4))
    state, param, s_out = z(33, 4, 2), z(5, 4, 2), z(33, 4, 2)
    num = torch.tensor([[2, 0], [0, 3], [0, 0]], dtype=i32)
    con = z(8, 3, 2)
    con[7, 0, 0] = 1.0                  # lane (0, 0) ok: 2 live points
    c_out = (z(3, 2, dtype=i32), z(3, 2, dtype=i32), con, z(4, 3, 2), num)
    jargs = (z(3),)
    b = 1056 + 160 + 12 + 1056 + (24 + 2 * (4 + 4 + 32 + 16))
    ops = 2 * (200 * 3 * 2 + (700 * 3 + 350) * 1 + 450 * 2 + 900 * 1)
    assert rl.solver_cost(cfg, state, param, c_out, jargs, {"ok": 1}, 1,
                          s_out) == (b, ops)
    fc = dict(movable=4, hh_candidates=2, hh_live=1, hh_1pt=0,
              hp_candidates=3, hp_live=2, sp_hull=1, sp_plane=1,
              sp_sphere=1, ok=3, points=5)
    ops = (200 * 4 + 3800 * 2 + 3300 + 910 * 3 + 610 * 2 + 3100 + 40 + 30
           + 2 * (200 * 4 + (700 * 3 + 350) * 3 + 450 * 5 + 900))
    assert rl.fused_cost(cfg, (z(10),), z(5), fc, 1) == (60, ops)


def test_raycast_counts():
    wv, t_pad, r_pad, n_rays = 2, 4, 8, 6
    setup = z(wv, t_pad, rck.PS)
    setup[0, 0, 0] = setup[0, 1, 2] = setup[1, 0, 1] = 1.0   # 3 live rows
    setup[0, 1, 22] = setup[1, 0, 22] = 1.0                  # shadow rows
    setup[1, 3, 22] = 1.0                       # a dead row's: not counted
    out = torch.full((wv, 8, r_pad), 20.0)
    out[0, rck.O_T, :3] = 1.0                   # view 0: 3 rays hit
    out[1, rck.O_T, 2] = 5.0                    # view 1: 1
    out[1, rck.O_T, 7] = 5.0                    # a padding ray: not counted
    planes = (setup, z(wv, rck.FA, t_pad), z(r_pad, 3), z(6, 4))
    opts = dict(t_max=10.0, shadows=True, use_materials=True)
    assert rl.ray_counts(planes, opts, n_rays, out) == (3, 3 + 1, 4)
    b = rl.nbytes(*planes, out)
    assert b == (2 * 4 * 24 + 2 * 16 * 4 + 8 * 3 + 24 + 2 * 8 * 8) * 4
    assert rl.raycast_cost(planes, opts, n_rays, out) == (
        b, 6 * 3 * 30 + 4 * 28 + 2 * 6 * 40 + 4 * 90)
    assert rl.raycast_every_row_cost(planes, opts, out) == (
        b, 8 * 2 * (4 * (30 + 28) + 40 + 90))


def test_bench_roofline_models():
    """The render floor's live rows are those the raycast kernel's planes
    carry at the env's first step, in the dense and the BLAS tier."""
    from madrona_tpu_torch import make_sim
    from madrona_tpu_torch.render import kernel as rkernel

    rate = 123456.0
    er = rl.bench_roofline(4096, rate, EscapeRoom())
    j_er = j_roofline.bench_roofline("escape_room_4096", 4096, rate,
                                     JEscapeRoom())
    assert set(er) == set(j_er) == {"model", "sol_env_steps_per_sec",
                                    "pct_of_roofline"}
    sol = 4096 / rl.sim_hbm_floor_s(4096, 21)
    assert er == {"model": "sim_hbm_floor",
                  "sol_env_steps_per_sec": round(sol, 1),
                  "pct_of_roofline": round(100.0 * rate / sol, 3)}
    for tier in ("dense", "blas"):
        hs = HideSeek(render_size=16, render_tier=tier)
        sim = make_sim(hs, num_worlds=2, seed=0, device="cpu")
        planes, opts, n_rays = rkernel.kernel_inputs(
            hs.rcfg, *hs.rsys.render_inputs(sim.state))
        no_hits = torch.full((planes[0].shape[0], 8, n_rays), 1e9)
        live = rl.ray_counts(planes, opts, n_rays, no_hits)[0]
        # 30 of 168 rows dead a view (padding, the camera's own body)
        assert live == 2 * rl.render_live_rows(hs) == 2 * 4 * 138, tier
        px = rl.bench_roofline(64, rate, hs)
        sol = 64 / rl.render_floor_s(64, 4, 256, rl.render_live_rows(hs))
        assert px == {"model": "render_ops",
                      "sol_env_steps_per_sec": round(sol, 1),
                      "pct_of_roofline": round(100.0 * rate / sol, 1)}
    # the floor counts what raycast_cost counts on a run with no hits
    ops = rl.raycast_cost(planes, dict(opts, shadows=False,
                                       use_materials=False), n_rays,
                          no_hits)[1]
    assert rl.render_floor_s(2, 4, n_rays, live // 2) == ops / 67e12
    # Hide & Seek state only: the body-state floor of its 14 rows
    assert rl.bench_roofline(64, rate, HideSeek(pixels=False))["model"] == \
        "sim_hbm_floor"
    assert rl.bench_roofline(64, rate, Cartpole()) is None
    assert rl.bench_roofline(64, rate) is None


def test_chip_smoke_takes_the_package_counts():
    import chip_smoke

    for name in ("bound", "broadphase_cost", "contacts_cost", "fused_cost",
                 "hh_record_cost", "lidar_cost", "lidar_same_work_cost",
                 "lidar_visible", "nbytes", "ray_counts", "raycast_cost",
                 "raycast_every_row_cost", "solver_cost"):
        assert getattr(chip_smoke, name) is getattr(rl, name), name
    assert chip_smoke.device_profile is tracing.device_profile
    copies = [n for n in vars(chip_smoke)
              if n.startswith("PEAK_") or "_OPS_" in n]
    assert not copies, copies
    assert not hasattr(chip_smoke, "ray_ops")   # the old inline count
