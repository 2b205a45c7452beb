"""The tiers that refuse the Gauss-Seidel oracle on the PyTorch port
(solver="gauss_seidel"; the oracle's comparisons with the JAX package
and tests/test_physics.py's joint scenes are in
tests/test_torch_gauss_seidel.py): the ValueError of each tier that
refuses a non-Jacobi solver, as the JAX package raises it."""

import dataclasses

import pytest
import torch

from madrona_tpu_torch.physics.xpbd import PhysicsConfig

from torch_port import stack_scene

torch.set_num_threads(1)


@pytest.mark.parametrize("change, match", [
    (dict(megakernel_fused=True, narrowphase_once=True), "megakernel_fused"),
    (dict(narrowphase="pallas_mega", narrowphase_once=True,
          megakernel=True), "pallas_mega"),
    (dict(megakernel=True, narrowphase_once=True), "megakernel requires"),
])
def test_non_jacobi_tiers_raise(change, match):
    """The tiers that refuse a non-Jacobi solver in the JAX package
    (api.py:733-738, :756-761, :821-825) refuse "gauss_seidel" here with
    ValueError, when the node is built."""
    cfg = dataclasses.replace(PhysicsConfig(solver="gauss_seidel"), **change)
    with pytest.raises(ValueError, match=match):
        stack_scene(True, cfg, 2)
