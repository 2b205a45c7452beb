"""The swept broadphase tier of the PyTorch port vs the JAX package.

madrona_tpu_torch.physics.broadphase.find_candidates_swept must equal
madrona_tpu.physics.broadphase.find_candidates_swept field by field:
hh, hp, sp, sp_kind, the three counts and overflow, in the same order
(the compaction order is part of the contract). Scenes are
tests/test_broadphase_swept.py's random bodies (boxes, spheres, static
plates; about 10 % dead rows) at N = 20, 64 and 261, with a world that
overflows its window, caps that saturate, exact ties of the x-extent
(the large-slot top-k) and worlds with every or half the rows dead.
first_index_geq is held against the JAX package's and np.searchsorted
at power-of-two lengths. Tolerance: none (exact)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu.physics import broadphase as jbp
from madrona_tpu_torch.physics import bodies as tbodies
from madrona_tpu_torch.physics import broadphase as tbp
from madrona_tpu_torch.physics import xpbd as txpbd

from test_broadphase_swept import _random_bodies
from torch_port import (
    assert_cands_equal, body_arrays, box_sphere_oms, jax_body as jbody,
    jax_tree,
)

torch.set_num_threads(1)

DT = 1.0 / 30.0


def _port_om():
    """The port's objects of _random_bodies' registry."""
    reg = tbodies.ObjectRegistry()
    reg.add_box([0.5, 0.5, 0.5], mass=1.0)
    reg.add_sphere(0.4, mass=1.0)
    reg.add_box([4.0, 4.0, 0.25], mass=0.0,
                response=tbodies.RESPONSE_STATIC)
    return reg.build()


# (w, n, span, window, caps (hh, hp, sp) or None for Pile's 2n/n+8/3n,
#  seed, variant)
CASES = {
    "n20_dense": (4, 20, 3.0, 32, None, 0, None),
    "n64_caps_saturate": (4, 64, 8.0, 16, (16, 8, 16), 1, None),
    "n64_window_overflow": (2, 64, 1.5, 4, (512, 256, 512), 1, None),
    "n64_extent_ties": (4, 64, 8.0, 32, None, 2, "still"),
    "n32_dead_rows": (2, 32, 2.0, 8, None, 2, "dead"),
    "n40_plane": (4, 40, None, 40, (400, 64, 400), 4, "plane"),
    "n261_pile_window": (2, 261, 16.0, 80, None, 3, None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_swept_equals_jax(case):
    w, n, span, window, caps, seed, variant = CASES[case]
    if variant == "plane":
        # a floor plane (hull-plane pairs; the widest body of all), boxes
        # and spheres: the scene of tests/test_torch_broadphase.py
        j_om, t_om = box_sphere_oms()
        arrays = body_arrays(np.random.RandomState(seed), w, n, 4)
        body = jbody(arrays)
    else:
        body, j_om = _random_bodies(w, n, seed=seed, span=span)
        t_om = _port_om()
    if variant == "still":
        # zero velocity: every box, sphere and plate of a kind has the same
        # x-extent, so the top-k of the large slots meets exact ties
        body = dataclasses.replace(body, vel=jnp.zeros_like(body.vel))
    if variant == "dead":
        act = np.asarray(body.active).copy()
        act[0] = False
        act[1, ::2] = False
        body = dataclasses.replace(body, active=jnp.asarray(act))
    caps = caps or (2 * n, n + 8, 3 * n)
    ref = jax.jit(lambda b: jbp.find_candidates_swept(
        b, j_om, jbp.CandidateCaps(*caps), DT, window=window))(body)
    t_body = txpbd.BodyState(**{
        k: torch.from_numpy(np.array(v)) for k, v in jax_tree(body).items()})
    got = tbp.find_candidates_swept(t_body, t_om,
                                    tbp.CandidateCaps(*caps), DT,
                                    window=window)
    assert_cands_equal(got, ref)
    ovf = np.asarray(ref.overflow)
    nums = np.asarray(ref.hh_num) + np.asarray(ref.sp_num)
    if case == "n64_window_overflow":
        assert ovf.all()
    elif case == "n64_caps_saturate":
        assert ovf.any()
    elif case == "n40_plane":
        assert not ovf.any() and (np.asarray(ref.hp_num) > 0).all()
    elif case == "n32_dead_rows":
        assert nums[0] == 0 and np.asarray(ref.hp_num)[0] == 0
    else:
        assert not ovf.any()
    if case != "n32_dead_rows":
        assert (nums > 0).all(), case


def test_first_index_geq_power_of_two_lengths():
    """ceil(log2(P+1)) steps: the hit at index 1 at power-of-two P
    (tests/test_broadphase_swept.py's regression), and random masks."""
    targets = np.arange(1, 5, dtype=np.int32)
    for p_len in (2, 4, 8, 16, 1024):
        rs = np.random.RandomState(p_len)
        mask = (rs.uniform(size=(4, p_len)) < 0.3).astype(np.int32)
        mask[0] = 0
        mask[0, 1] = 1
        pos_inc = np.cumsum(mask, axis=1).astype(np.int32)
        got = tbp.first_index_geq(torch.from_numpy(pos_inc),
                                  torch.from_numpy(targets)).numpy()
        ref = np.asarray(jbp.first_index_geq(jnp.asarray(pos_inc),
                                             jnp.asarray(targets)))
        np.testing.assert_array_equal(got, ref, err_msg=str(p_len))
        for wi in range(4):
            np.testing.assert_array_equal(got[wi], np.minimum(
                np.searchsorted(pos_inc[wi], targets, side="left"),
                p_len - 1))
        assert pos_inc[0][got[0][0]] == 1 and got[0][0] == 1
