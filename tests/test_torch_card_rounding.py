"""The physics path rounds as the CPU does, so the card can repeat it.

On an H100, PyTorch divides by a Python number as a product with its
reciprocal, and ``linalg_vector_norm`` and short float sums add their
terms in another order than the CPU; each can put a body one rounding
off the CPU's and tip a contact (chip_smoke.py phase 29). The physics
path divides by device tensors, takes norms with ``math3d.norm`` and
sums short axes with ``math3d.sum_in_order``. On the CPU:

  * one step of each physics route (``kernel_mega``, ``megakernel_fused``,
    ``kernel_sublane``, ``kernel``, the swept ``"xla"`` tier, ``solver=
    "tgs"`` and ``solver="gauss_seidel"``, the kernels' plain versions
    standing in for them) under ``utils.debug.RoundingSites``: no
    division by a Python number, no ``linalg_vector_norm`` and no float
    sum of 3 or 4 terms on the physics path (``physics/``,
    ``utils/math3d.py`` and the kernels' plain versions in ``ops/``);
  * ``math3d.norm`` gives ``torch.linalg.vector_norm``'s bits on the
    CPU (the repair keeps the CPU's results bit for bit);
  * ``RoundingSites`` names each kind of site with its line.
No JAX sim: the port's own CPU path is the reference here.
"""

import dataclasses

import pytest
import torch

import chip_smoke
from madrona_tpu_torch import make_sim
from madrona_tpu_torch.models.escape_room import EscapeRoom
from madrona_tpu_torch.models.pile import Pile
from madrona_tpu_torch.physics.xpbd import PhysicsConfig
from madrona_tpu_torch.utils import math3d as m3
from madrona_tpu_torch.utils.debug import RoundingSites

torch.set_num_threads(1)

PHYSICS = ("physics/", "utils/math3d.py", "ops/")


def _er(**change):
    env = EscapeRoom()
    env.cfg = dataclasses.replace(env.cfg, **change)
    return make_sim(env, num_worlds=2, seed=0, device="cpu").executor


ROUTES = {
    "kernel_mega": _er,
    "megakernel_fused": lambda: _er(**chip_smoke.FUSED),
    "kernel_sublane": lambda: _er(narrowphase="kernel_sublane",
                                  megakernel=False),
    "kernel": lambda: _er(narrowphase="kernel", megakernel=False),
    "xla_swept": lambda: make_sim(Pile(num_bodies=8), num_worlds=2, seed=0,
                                  device="cpu").executor,
    "tgs": lambda: _er(solver="tgs", narrowphase="kernel_sublane",
                       megakernel=False),
    "gauss_seidel": lambda: chip_smoke.stack_scene(
        PhysicsConfig(solver="gauss_seidel", dt=1.0 / 60.0), 2, "cpu")[0],
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_physics_route_rounds_as_the_cpu(route):
    """One step (after one to put contacts in place): no division by a
    Python number, no vector_norm, no short sum on the physics path."""
    ex = ROUTES[route]()
    ex.run()
    with RoundingSites() as mode:
        ex.run()
    physics = [s for s in mode.sites if s.where.startswith(PHYSICS)]
    assert any(s.where.startswith("physics/") for s in physics), mode.sites
    bad = [s for s in physics if s.kind in ("div", "norm", "sum")]
    assert not bad, bad


def test_norm_has_the_cpu_vector_norm_bits():
    g = torch.Generator().manual_seed(0)
    for scale in (1e-3, 1.0, 1e3):
        v = torch.randn(200_000, 3, generator=g) * scale
        assert torch.equal(m3.norm(v),
                           torch.linalg.vector_norm(v, dim=-1)), scale
        # the joints' layouts: a slice made contiguous, a batch of pairs
        q = torch.randn(2, 5000, 4, generator=g)
        d = 2.0 * q[..., 1:4]
        assert torch.equal(m3.norm(d), torch.linalg.vector_norm(d, dim=-1))
    assert float(m3.norm(torch.zeros(1, 3))[0]) == 0.0


def test_rounding_sites_names_each_kind():
    x = torch.rand(4, 3) + 0.5

    def fn():
        return (x / 3.0, x / 2.0, x * 0.1, x * 4.0,
                torch.linalg.vector_norm(x, dim=-1), x.sum(dim=-1),
                x[:, :2].sum(dim=-1), x.sum(dim=0), m3.norm(x))

    with RoundingSites() as mode:
        fn()
    kinds = [(s.kind, s.detail) for s in mode.sites]
    assert kinds == [("div", "/ 3.0"), ("mul", "* 0.1"), ("norm", ""),
                     ("sum", "3 terms"), ("sum", "4 terms")], kinds
    assert all(s.where == "?" for s in mode.sites)
    with RoundingSites() as mode:
        m3.quat_normalize(torch.rand(5, 4))
    assert mode.sites == []
