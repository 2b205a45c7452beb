"""Broadphase of the PyTorch port vs the JAX package.

The port's plain find_candidates (the CPU path and the oracle of the
CUDA broadphase kernel) must equal, field by field, both the JAX
all-pairs tier and the Pallas broadphase kernel run in interpret mode,
on the scenes of tests/test_broadphase_pallas.py: random, crowded,
saturating and sphere-less. Tolerance: none (exact)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu.physics import bodies as jbodies
from madrona_tpu.physics import broadphase as jbp
from madrona_tpu.physics import geo as jgeo
from madrona_tpu.physics.xpbd import BodyState as JBody
from madrona_tpu_torch.ops.broadphase_cuda import find_candidates_kernel
from madrona_tpu_torch.physics import bodies as tbodies
from madrona_tpu_torch.physics import broadphase as tbp
from madrona_tpu_torch.physics import geo as tgeo

from torch_port import assert_cands_equal, body_arrays, torch_body

torch.set_num_threads(1)

W, N = 8, 12
DT = 1.0 / 30.0


def _registries(with_sphere):
    out = []
    for mod, geo in ((jbodies, jgeo), (tbodies, tgeo)):
        reg = mod.ObjectRegistry()
        reg.add_plane()
        reg.add_hull(geo.box_hull((0.5, 0.5, 0.5)), mass=1.0)
        reg.add_hull(geo.box_hull((0.4, 0.8, 0.3)), mass=2.5)
        if with_sphere:
            reg.add_sphere(0.45, mass=0.8)
        out.append(reg.build())
    return out


def _run(seed, crowded, caps_args, with_sphere=True, n_obj_hi=4):
    j_om, t_om = _registries(with_sphere)
    arrays = body_arrays(np.random.RandomState(seed), W, N, n_obj_hi,
                         crowded=crowded)
    j_body = JBody(**{k: jnp.asarray(v) for k, v in arrays.items()})
    t_body = torch_body(arrays)
    j_caps = jbp.CandidateCaps(*caps_args)
    t_caps = tbp.CandidateCaps(*caps_args)
    got = tbp.find_candidates(t_body, t_om, t_caps, DT)
    ref = jax.jit(lambda b: jbp.find_candidates(b, j_om, j_caps, DT))(j_body)
    pallas = jbp.find_candidates_pallas(j_body, j_om, j_caps, DT,
                                        interpret=True)
    return got, ref, pallas, t_body, t_om, t_caps


@pytest.mark.parametrize("crowded", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_matches_jax_and_pallas(seed, crowded):
    got, ref, pallas, *_ = _run(seed, crowded, (8, 6, 4))
    assert_cands_equal(got, ref)
    assert_cands_equal(got, pallas)


def test_saturation_reported_identically():
    got, ref, pallas, *_ = _run(3, True, (2, 1, 1))
    assert_cands_equal(got, ref)
    assert_cands_equal(got, pallas)
    assert bool(got.overflow.any())


def test_zero_sphere_cap():
    got, ref, pallas, *_ = _run(5, False, (8, 6, 0), with_sphere=False,
                                n_obj_hi=3)
    assert_cands_equal(got, ref)
    assert_cands_equal(got, pallas)
    assert tuple(got.sp.shape) == (W, 0, 2)


def test_kernel_route_on_cpu_is_the_plain_version():
    """On a CPU tensor the kernel wrapper runs the plain version."""
    got, _, _, t_body, t_om, t_caps = _run(1, True, (8, 6, 4))
    routed = find_candidates_kernel(t_body, t_om, t_caps, DT)
    for f in ("hh", "hh_num", "hp", "hp_num", "sp", "sp_num", "sp_kind",
              "overflow"):
        assert torch.equal(getattr(routed, f), getattr(got, f)), f


def test_object_packs_equal_jax():
    """The per-object tables the narrowphase and solver read are built
    byte for byte like the JAX package's."""
    j_om, t_om = _registries(True)
    for f in ("hull_pack", "hull_dirs_pack", "body_pack", "inv_mass",
              "prim_type"):
        np.testing.assert_array_equal(
            getattr(t_om, f).numpy(), np.asarray(getattr(j_om, f)),
            err_msg=f,
        )
    assert t_om.hull_dims == j_om.hull_dims
    assert t_om.n_edge_dirs == j_om.n_edge_dirs
