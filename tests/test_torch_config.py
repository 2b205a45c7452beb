"""utils/config.py and the JAX package's tier names on the PyTorch port
(tests/test_config.py, tests/test_broadphase_pallas.py).

  * tests/test_config.py's override, identity and overlay cases on the
    port's copy (environment monkeypatched; the overlay on a
    monkeypatched table with a "cuda" row, as the port reads it); the
    port's own table holds only its _meta row, and the JAX package's is
    never read;
  * one Escape Room step with MADRONA_TPU_SUBSTEPS=2 set, the JAX
    package's env and the port's each reading it: from the carried JAX
    state after 3 steps, integer exports equal, the body state within the
    golden bounds (tests/golden_inputs.py:484-493);
  * the broadphase names "all_pairs", "pallas" and "kernel" resolve to
    the all-pairs tier, whose Candidates equal the JAX package's
    find_candidates and find_candidates_pallas (interpret mode) bit for
    bit, every field, on random scenes (one saturating the caps);
  * a name that neither package's node knows raises ValueError."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import madrona_tpu_torch
from madrona_tpu.models.base import make_sim as j_make_sim
from madrona_tpu.models.escape_room import EscapeRoom as JEscapeRoom
from madrona_tpu.physics import broadphase as jbp
from madrona_tpu_torch import make_sim
from madrona_tpu_torch.models.escape_room import EscapeRoom
from madrona_tpu_torch.ops.broadphase_cuda import find_candidates_kernel
from madrona_tpu_torch.physics import api as tapi
from madrona_tpu_torch.physics import broadphase as tbp
from madrona_tpu_torch.physics.xpbd import PhysicsConfig
from madrona_tpu_torch.utils import config as C

from torch_port import (
    assert_cands_equal, body_arrays, box_sphere_oms, carry_state, jax_body,
    jax_tree, torch_body,
)

torch.set_num_threads(1)

GOLDEN = {"Position": 1e-3, "Rotation": 1e-3, "linear": 5e-2,
          "angular": 2e-1}


def test_env_override_roundtrip(monkeypatch, caplog):
    monkeypatch.setenv("MADRONA_TPU_SUBSTEPS", "8")
    monkeypatch.setenv("MADRONA_TPU_GRAVITY", "0,0,-1.62")
    monkeypatch.setenv("MADRONA_TPU_SOLVER", "gauss_seidel")
    monkeypatch.setenv("MADRONA_TPU_NARROWPHASE_ONCE", "1")
    monkeypatch.setenv("MADRONA_TPU_NARROWPHASE", "pallas_sublane")
    cfg = C.env_override(PhysicsConfig())
    assert cfg.substeps == 8
    assert cfg.gravity == (0.0, 0.0, -1.62)
    assert cfg.solver == "gauss_seidel"
    assert cfg.narrowphase_once is True
    # the JAX package's tier name, read from the environment
    assert cfg.narrowphase == "kernel_sublane"
    assert cfg.dt == PhysicsConfig().dt        # untouched
    # every field set from the environment is logged with its variable
    assert "PhysicsConfig.substeps = 8 from MADRONA_TPU_SUBSTEPS" in \
        caplog.text
    assert sum("from MADRONA_TPU_" in r.getMessage()
               for r in caplog.records) == 5
    monkeypatch.setenv("MADRONA_TPU_SUBSTEPS", "eight")
    with pytest.raises(ValueError):
        C.env_override(PhysicsConfig())


def test_no_overrides_identity():
    cfg = PhysicsConfig()
    assert C.env_override(cfg) is cfg or C.env_override(cfg) == cfg


def test_tuned_table_overlay(monkeypatch):
    """apply_tuned: the table's knobs overlay the defaults, bench_* and
    unknown keys are skipped, the environment wins over the table."""
    monkeypatch.setattr(C, "_tuned_cache", {
        "fake_env": {
            "cuda": {"jacobi_iters": 3, "broadphase_window": 64,
                     "gravity": [0.0, 0.0, -1.0], "bench_worlds": 4096,
                     "not_a_field": 1},
            "tpu": {"jacobi_iters": 7},
        }
    })
    cfg = C.apply_tuned(PhysicsConfig(), "fake_env")
    assert cfg.jacobi_iters == 3 and cfg.broadphase_window == 64
    assert cfg.gravity == (0.0, 0.0, -1.0)
    assert C.apply_tuned(PhysicsConfig(), "no_such_env") == PhysicsConfig()
    monkeypatch.setenv("MADRONA_TPU_JACOBI_ITERS", "5")
    assert C.env_override(cfg).jacobi_iters == 5
    assert C.load_tuned("fake_env")["bench_worlds"] == 4096
    assert C.load_tuned("fake_env", "tpu") == {"jacobi_iters": 7}


def test_tuned_table_commit_is_valid_json():
    """The port's table: its _meta row only, read from the port's own
    package (never the JAX package's TPU table)."""
    path = os.path.join(os.path.dirname(madrona_tpu_torch.__file__),
                        "tuned_configs.json")
    with open(path) as f:
        table = json.load(f)
    assert list(table) == ["_meta"]
    assert os.path.samefile(C._TUNED_PATH, path)
    assert C.load_tuned("escape_room") == {}


def test_escape_room_step_with_substeps_env(monkeypatch):
    monkeypatch.setenv("MADRONA_TPU_SUBSTEPS", "2")
    j_env, t_env = JEscapeRoom(), EscapeRoom()
    assert j_env.cfg.substeps == t_env.cfg.substeps == 2
    w = 4
    j_sim = j_make_sim(j_env, num_worlds=w, seed=2, donate=False)
    j_step = j_sim.step_fn()
    acts = np.asarray(JEscapeRoom.random_actions(np.random.RandomState(3),
                                                 4, w))
    zeros = jnp.zeros((w,), jnp.int32)
    s = j_sim.state
    for t in range(3):
        s, _ = j_step(s, {"action": jnp.asarray(acts[t]), "reset": zeros})
    j_next, j_out = j_step(s, {"action": jnp.asarray(acts[3]),
                               "reset": zeros})
    t_step = make_sim(t_env, num_worlds=w, seed=2, device="cpu").step_fn()
    t_next, t_out = t_step(carry_state(s), {
        "action": torch.from_numpy(np.array(acts[3])),
        "reset": torch.zeros((w,), dtype=torch.int32)})
    for k, ref in j_out.items():
        ref = np.asarray(ref)
        if ref.dtype.kind in "iub":
            np.testing.assert_array_equal(t_out[k].numpy(), ref, err_msg=k)
    gc = t_next.tables[tapi.RIGID_BODY].columns
    rc = jax_tree(j_next.tables[tapi.RIGID_BODY].columns)
    for k, tol in GOLDEN.items():
        g, r = ((gc[k], rc[k]) if k in gc else
                (gc["Velocity"][k], rc["Velocity"][k]))
        assert float(np.abs(g.numpy() - r).max()) <= tol, k


@pytest.mark.parametrize("name", ["all_pairs", "pallas", "kernel"])
def test_broadphase_names_candidates_match_jax(name):
    cfg = PhysicsConfig(broadphase=name)
    assert cfg.broadphase == "kernel"
    j_om, t_om = box_sphere_oms()
    for seed, crowded, caps in ((0, False, (8, 6, 4)), (1, True, (8, 6, 4)),
                                (3, True, (2, 1, 1))):
        arrays = body_arrays(np.random.RandomState(seed), 8, 12, 4, crowded)
        j_caps = jbp.CandidateCaps(*caps)
        ref = jax.jit(lambda b: jbp.find_candidates(b, j_om, j_caps, 1 / 30)
                      )(jax_body(arrays))
        pallas = jbp.find_candidates_pallas(jax_body(arrays), j_om, j_caps,
                                            1 / 30, interpret=True)
        got = find_candidates_kernel(torch_body(arrays), t_om,
                                     tbp.CandidateCaps(*caps), 1 / 30)
        assert_cands_equal(got, ref)
        assert_cands_equal(got, pallas)
        if caps[0] == 2:
            assert got.overflow.any()


def test_unknown_names_raise():
    env = EscapeRoom()
    sim = make_sim(env, num_worlds=2, seed=0, device="cpu")
    for change in (dict(solver="gauss_seidl"), dict(narrowphase="mega"),
                   dict(broadphase="bvh"), dict(sat_tier="edge_triples")):
        cfg = dataclasses.replace(env.cfg, **change)
        with pytest.raises(ValueError, match=list(change)[0]):
            tapi.make_physics_node(sim.executor.sm, env.om, cfg, env.caps)
