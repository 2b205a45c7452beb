"""Contacts of the PyTorch port vs the JAX package's contacts kernel.

On the CPU ``ops.contacts_cuda.contacts`` runs its plain version (the
oracle of the CUDA kernel ``csrc/contacts.cu``). It is held against one
interpret-mode call of the Pallas kernel (``make_contacts_kernel`` with
the ``edge_dirs`` SAT, ``n_dirs = 3`` for boxes) on a crowded scene of
rotated, scaled boxes on a plane (W = 8, N = 12, caps 8/8/0), made from
a seed with numpy.

Tolerances (tests/golden_inputs.py:484-492, ``compare_goldens``): ref,
alt and num equal; normal, average point and largest penetration within
1e-4 on ok lanes; manifold points within 1e-3, compared without regard
to order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu.ops import physics_megakernel as fpk
from madrona_tpu.physics import bodies as jbodies
from madrona_tpu.physics import geo as jgeo
from madrona_tpu_torch.ops import contacts_cuda
from madrona_tpu_torch.physics import bodies as tbodies
from madrona_tpu_torch.physics import broadphase as tbp
from madrona_tpu_torch.physics import geo as tgeo

from torch_port import body_arrays, sorted_live_points, torch_body

torch.set_num_threads(1)

W, N = 8, 12
CAPS = (8, 8, 0)
TOL_CON = 1e-4
TOL_PTS = 1e-3


@pytest.fixture(scope="module")
def case():
    oms = []
    for mod, geo in ((jbodies, jgeo), (tbodies, tgeo)):
        reg = mod.ObjectRegistry()
        reg.add_plane()
        reg.add_hull(geo.box_hull((0.5, 0.5, 0.5)), mass=1.0)
        reg.add_hull(geo.box_hull((0.4, 0.8, 0.3)), mass=2.5)
        oms.append(reg.build())
    j_om, t_om = oms
    body = torch_body(body_arrays(np.random.RandomState(0), W, N, 3,
                                  crowded=True))
    cands = tbp.find_candidates(body, t_om, tbp.CandidateCaps(*CAPS), 0.04)
    poses, obj = contacts_cuda.pack_poses(body, body.obj_id)
    got = contacts_cuda.contacts(cands.hh, cands.hp, poses, obj, t_om)

    fn = fpk.make_contacts_kernel(
        j_om.hull_dims, N, j_om.hull_pack.shape[0], tile_w=W,
        interpret=True, n_dirs=j_om.n_edge_dirs,
    )
    rows = lambda p, side: jnp.asarray(                     # noqa: E731
        p[..., side].numpy().T.copy())
    ref = fn(
        rows(cands.hh, 0), rows(cands.hh, 1), rows(cands.hp, 0),
        rows(cands.hp, 1), jnp.asarray(poses.numpy()),
        jnp.asarray(obj.numpy().astype(np.float32)), j_om.hull_pack_planar,
    )
    names = ("ref", "alt", "con", "pts", "num")
    return ({k: v.numpy() for k, v in zip(names, got)},
            {k: np.asarray(v) for k, v in zip(names, ref)}, j_om)


def test_scene_has_face_and_edge_contacts(case):
    got, _, j_om = case
    assert j_om.n_edge_dirs == 3
    hh_num = got["num"][:CAPS[0]]
    assert (hh_num >= 3).sum() >= 5          # clipped face manifolds
    assert (hh_num == 1).sum() >= 5          # edge (or corner) contacts
    assert (got["num"][CAPS[0]:] > 0).sum() >= 10   # hull-plane lanes
    assert got["ref"].dtype == np.int32 and got["num"].dtype == np.int32


@pytest.mark.parametrize("field", ["ref", "alt", "num"])
def test_rows_and_counts_equal(case, field):
    got, ref, _ = case
    np.testing.assert_array_equal(got[field], ref[field].astype(np.int32))


@pytest.mark.parametrize("name, lo, hi", [
    ("normal", 0, 3), ("avg_point", 3, 6), ("max_pen", 6, 7), ("ok", 7, 8),
])
def test_reduced_contacts_match(case, name, lo, hi):
    got, ref, _ = case
    ok = ref["con"][7] > 0.5
    d = np.abs(got["con"][lo:hi].astype(np.float64) - ref["con"][lo:hi])
    assert np.where(ok[None], d, 0.0).max() <= TOL_CON
    if name == "ok":
        np.testing.assert_array_equal(got["con"][7], ref["con"][7])


def test_manifold_points_match_unordered(case):
    got, ref, _ = case
    c = got["ref"].shape[0]

    def per_lane(x):                 # [16, C, W] -> [C, W, point, xyz+depth]
        return np.transpose(x.reshape(4, 4, c, W), (2, 3, 0, 1))

    num = np.where(ref["con"][7] > 0.5, ref["num"], 0)
    d = np.abs(sorted_live_points(per_lane(got["pts"]), num)
               - sorted_live_points(per_lane(ref["pts"]), num))
    assert d.max() <= TOL_PTS


def test_launch_path_refuses_cpu_tensors(case):
    """The kernel's launch path takes CUDA tensors only: a CPU tensor
    reaches the plain version through ``contacts`` or raises here."""
    reg = tbodies.ObjectRegistry()
    reg.add_plane()
    reg.add_hull(tgeo.box_hull((0.5, 0.5, 0.5)), mass=1.0)
    z = torch.zeros((2, 1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        contacts_cuda._launch(z, z, torch.zeros((3, 10, 2)),
                              torch.zeros((3, 2), dtype=torch.int32),
                              reg.build())
    assert contacts_cuda.KERNEL.launches == 0
