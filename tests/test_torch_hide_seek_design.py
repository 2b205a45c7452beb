"""Two of tests/test_hide_seek.py's cases on the port's Hide & Seek, on
the CPU (the port alone; the JAX package's own tests hold the same
bounds):
- the reference renderer's design point, 64 x 64 RGBD a view, with the
  per-view cull (tlas_max_instances=8), 2 worlds, seed 11: shapes,
  finite, two renders of the same step bit-identical, more than 40 % of
  the pixels hit geometry and every view more than 10 % (the JAX test's
  bounds, tests/test_hide_seek.py:336);
- the candidate caps (hull-hull 7, hull-plane 9, sphere 0) over a
  400-step rollout of random actions (RandomState(3)) at 16 worlds,
  seed 17, state only: at every step the true occupancy, measured with
  oversized caps (64, 64, 8) by the plain broadphase, fits the shipped
  caps (tests/test_hide_seek.py:365).
"""

import numpy as np
import torch

from madrona_tpu_torch import make_sim
from madrona_tpu_torch.models import hide_seek as hs
from madrona_tpu_torch.models.hide_seek import HideSeek
from madrona_tpu_torch.physics import api as papi
from madrona_tpu_torch.physics import broadphase as bp

torch.set_num_threads(1)


def test_pixels_64x64_design_point():
    w = 2
    sim = make_sim(HideSeek(render_size=64, tlas_max_instances=8),
                   num_worlds=w, seed=11, device="cpu")
    step = sim.step_fn()
    inputs = {"action": torch.zeros((w, hs.N_AGENTS, 5), dtype=torch.int32),
              "reset": torch.zeros((w,), dtype=torch.int32)}
    _, o1 = step(sim.state, inputs)
    _, o2 = step(sim.state, inputs)
    rgb, dep = o1["rgb"].numpy(), o1["depth"].numpy()
    assert rgb.shape == (w, hs.N_AGENTS, 64, 64, 3)
    assert dep.shape == (w, hs.N_AGENTS, 64, 64)
    assert np.isfinite(rgb).all() and np.isfinite(dep).all()
    assert torch.equal(o1["rgb"], o2["rgb"])
    assert torch.equal(o1["depth"], o2["depth"])
    assert o1["tlas_overlap"].shape == (w, hs.N_AGENTS)
    t_max = HideSeek(render_size=64).rcfg.t_max
    hit = dep < t_max - 1.0
    assert hit.mean() > 0.4
    assert hit.reshape(w * hs.N_AGENTS, -1).mean(axis=1).min() > 0.1


def test_candidate_caps_never_overflow_long_rollout():
    worlds, steps = 16, 400
    env = HideSeek(pixels=False)
    sim = make_sim(env, num_worlds=worlds, seed=17, device="cpu")
    step = sim.step_fn()
    shipped = env.caps
    big = bp.CandidateCaps(hull_hull=64, hull_plane=64, sphere_any=8)
    acts = env.random_actions(np.random.RandomState(3), steps, worlds)
    reset = torch.zeros((worlds,), dtype=torch.int32)
    state = sim.state
    seen = np.zeros(3, np.int64)
    for t in range(steps):
        body = papi.body_state(sim.executor.sm, state)
        c = bp.find_candidates(body, env.om, big, env.cfg.dt)
        occ = np.array([int(c.hh_num.max()), int(c.hp_num.max()),
                        int(c.sp_num.max())])
        assert not bool(c.overflow.any()), t
        assert occ[0] <= shipped.hull_hull, (t, occ)
        assert occ[1] <= shipped.hull_plane, (t, occ)
        assert occ[2] <= shipped.sphere_any, (t, occ)
        seen = np.maximum(seen, occ)
        state, _ = step(state, {"action": acts[t], "reset": reset})
    # the rollout reaches real contact demand
    assert seen[1] > 0 and seen[0] > 0
    print(f"max occupancy over {steps} steps x {worlds} worlds: "
          f"hh={seen[0]}/{shipped.hull_hull} hp={seen[1]}/"
          f"{shipped.hull_plane} sp={seen[2]}/{shipped.sphere_any}")
