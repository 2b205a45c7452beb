"""Hide & Seek's BLAS render tier and per-view cull on the port vs the
JAX package, on the CPU.

One state of the port's ``HideSeek(pixels=False)`` on the CPU (2 worlds,
seed 7, 6 steps of seeded random actions) is carried into the JAX
package through numpy (madrona_tpu_torch.interop.state_to_numpy,
tests/torch_port.py::jax_state), and both packages' render nodes run on
that one state at render_size 16: the JAX side through
``RenderingSystem._render_node`` called un-jitted (the Pallas raycast
kernel in interpret mode, with the material, light and shadow options
on), the port through its CPU path (the raycast kernel's plain version).
Tolerances: depth within 1e-3, rgb differing by more than 0.02 at under
0.2 % of pixels (tests/test_raycast_kernel.py:92-93); the overlap export
(tlas_overlap) equal, and so is the K that maybe_grow_tlas picks when
K = 8 overflows.

Then the port alone: tests/test_hide_seek.py's
test_blas_render_tier_matches_dense_geometry (the BLAS tier traces the
dense tier's geometry: 98 % of the hits within 2 % relative depth, the
median under 5e-3; deterministic; the checker floor shades), and the
BLAS tier's make_sim without a device means the card."""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu.models.hide_seek import HideSeek as JHideSeek
from madrona_tpu_torch import make_sim
from madrona_tpu_torch.models import hide_seek as hs
from madrona_tpu_torch.models.hide_seek import HideSeek
from madrona_tpu_torch.render import kernel as t_kernel

from torch_port import jax_state

torch.set_num_threads(1)

W = 2
SEED = 7
STEPS = 6
RENDER = 16
DEPTH_TOL = 1e-3
PIX_TOL, PIX_FRAC = 0.02, 0.002


@pytest.fixture(scope="module")
def states():
    """(the port's state, the same state as the JAX package's)."""
    sim = make_sim(HideSeek(pixels=False), num_worlds=W, seed=SEED,
                   device="cpu")
    acts = HideSeek.random_actions(np.random.RandomState(1), STEPS, W)
    for t in range(STEPS):
        sim.step({"action": acts[t],
                  "reset": torch.zeros((W,), dtype=torch.int32)})
    return sim.state, jax_state(sim.state)


def _with_overlap(state, zeros):
    """``state`` with a TlasOverlap singleton (the pixel env registers it
    when K > 0; the state-only sim that made the state does not)."""
    singles = dict(state.singletons)
    singles["TlasOverlap"] = zeros((W, hs.N_AGENTS))
    return dataclasses.replace(state, singletons=singles)


def _pixels(got, ref):
    t_rgb = got.singletons["RGBOut"].numpy()
    t_dep = got.singletons["DepthOut"].numpy()
    j_rgb = np.asarray(ref.singletons["RGBOut"])
    j_dep = np.asarray(ref.singletons["DepthOut"])
    assert t_rgb.shape == j_rgb.shape == (W, hs.N_AGENTS, RENDER, RENDER, 3)
    assert np.abs(t_dep - j_dep).max() < DEPTH_TOL
    assert (np.abs(t_rgb - j_rgb) > PIX_TOL).mean() < PIX_FRAC
    assert 0.3 < (j_dep < 80.0).mean() < 1.0
    return t_rgb, j_rgb


def _no_second_analysis(*a, **kw):
    raise AssertionError("the light table was analysed again")


def test_blas_render_node_matches_jax(states):
    t_state, j_state = states
    j_env = JHideSeek(render_size=RENDER, render_tier="blas")
    t_env = HideSeek(render_size=RENDER, render_tier="blas")
    ref = j_env.rsys._render_node(None, j_state, None)
    got = t_env.rsys._render_node(None, t_state, None)
    t_rgb, j_rgb = _pixels(got, ref)
    # materials, the sun and its shadow are on: the picture is not the
    # dense tier's flat one
    dense = HideSeek(render_size=RENDER).rsys._render_node(
        None, t_state, None).singletons["RGBOut"].numpy()
    assert (np.abs(dense - t_rgb).max(axis=-1) > PIX_TOL).mean() > 0.3


@pytest.mark.parametrize("tier", ["blas", "dense"])
def test_cull_render_node_and_grow_tlas(states, tier):
    k = 8
    t_state, j_state = states
    j_env = JHideSeek(render_size=RENDER, render_tier=tier,
                      tlas_max_instances=k)
    t_env = HideSeek(render_size=RENDER, render_tier=tier,
                     tlas_max_instances=k)
    ref = j_env.rsys._render_node(
        None, _with_overlap(j_state, lambda s: jnp.zeros(s, jnp.int32)), None)
    got = t_env.rsys._render_node(
        None, _with_overlap(t_state,
                            lambda s: torch.zeros(s, dtype=torch.int32)), None)
    _pixels(got, ref)
    r_ov = np.asarray(ref.singletons["TlasOverlap"])
    np.testing.assert_array_equal(got.singletons["TlasOverlap"].numpy(), r_ov)
    assert got.singletons["TlasOverlap"].dtype == torch.int32
    r_k = j_env.rsys.maybe_grow_tlas(
        types.SimpleNamespace(state=ref, _step_fns={}))
    g_k = t_env.rsys.maybe_grow_tlas(types.SimpleNamespace(state=got))
    assert g_k == r_k == t_env.rsys.tlas_max_instances
    # K = 8 overflows at this state: K grows to the overlap, a multiple of 4
    assert r_ov.max() > k and g_k >= r_ov.max() and g_k % 4 == 0
    # the next render at the new K: the same pixels (the kernel tier
    # traces the full set whatever K is)
    again = t_env.rsys._render_node(None, got, None)
    assert torch.equal(again.singletons["RGBOut"], got.singletons["RGBOut"])


def test_blas_render_tier_matches_dense_geometry(monkeypatch):
    """The port's version of tests/test_hide_seek.py:295: the BLAS tier
    traces the same registered meshes (float32 in the kernel tier, as the
    dense tier does there), so depth agrees; rgb differs (materials,
    shadows) and the checker floor shades. A second step reads the
    light table's flags back no more: the kernel tier's analysis of the
    table is kept on it."""
    sims = {t: make_sim(HideSeek(render_size=RENDER, render_tier=t),
                        num_worlds=2, seed=SEED, device="cpu")
            for t in ("dense", "blas")}
    inputs = {"action": torch.zeros((2, hs.N_AGENTS, 5), dtype=torch.int32),
              "reset": torch.zeros((2,), dtype=torch.int32)}
    out = {t: s.step_fn()(s.state, inputs)[1] for t, s in sims.items()}
    dd, db = out["dense"]["depth"].numpy(), out["blas"]["depth"].numpy()
    hit_both = (dd < 80.0) & (db < 80.0)
    assert hit_both.mean() > 0.5
    rel = np.abs(dd[hit_both] - db[hit_both]) / np.maximum(db[hit_both], 1.0)
    assert (rel < 2e-2).mean() > 0.98
    assert np.median(rel) < 5e-3
    monkeypatch.setattr(t_kernel, "_lights_info", _no_second_analysis)
    again = sims["blas"].step_fn()(sims["blas"].state, inputs)[1]
    assert torch.equal(again["rgb"], out["blas"]["rgb"])
    rgb = out["blas"]["rgb"].numpy()
    assert np.isfinite(rgb).all()
    assert rgb.reshape(2, hs.N_AGENTS, -1, 3).std(axis=2).mean() > 1e-3


def test_blas_tier_make_sim_defaults_to_the_card():
    env = HideSeek(render_size=RENDER, render_tier="blas")
    assert env.rcfg.shadows and env.rsys.blas is not None
    if torch.cuda.is_available():
        assert make_sim(env, num_worlds=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_sim(env, num_worlds=2)
