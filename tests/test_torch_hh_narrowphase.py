"""The hull-hull record narrowphase (B6, B7) and the sphere lanes of the
PyTorch port vs the JAX package.

On the CPU ``ops.hh_narrowphase_cuda.hh_record`` runs its plain version
(the oracle of the CUDA kernel ``csrc/hh_narrowphase.cu``). Held
against:

  * the JAX package's ``_narrowphase_all`` (its XLA tier, jitted) in
    the ``edge_pairs`` SAT tier, every lane kind live: hull-hull,
    hull-plane, sphere-sphere, sphere-plane and sphere-hull, on a crowded
    scene of rotated, scaled boxes and spheres on a plane (W = 4, N = 12,
    caps 12/10/10), made from a seed with numpy;
  * the TPU hardware goldens ``np_*`` (tests/goldens/kernels_v1.npz,
    captured from the sublane kernel in the ``edge_pairs`` tier) on
    ``golden_inputs.golden_case()``, through ``compare_goldens``;
  * the JAX package's two Pallas kernels in interpret mode, un-jitted,
    through ``narrowphase_hh_pallas``: the sublane kernel in both SAT
    tiers and the lane-major kernel (edge pairs only).

Tolerances (tests/golden_inputs.py:484-550): ref, alt and num equal;
normals within TOL_NARROW = 1e-4 on live lanes; manifold points within
1e-3, compared without regard to order."""

import os

import jax
import numpy as np
import pytest
import torch

import golden_inputs
from madrona_tpu.physics import api as japi
from madrona_tpu_torch.ops import contacts_cuda, hh_narrowphase_cuda as hhc
from madrona_tpu_torch.physics import api as tapi
from madrona_tpu_torch.physics import broadphase as tbp
from madrona_tpu_torch.physics import geo as tgeo

from torch_port import (
    assert_lanes_match, body_arrays, box_sphere_oms, jax_body, jax_cands,
    jax_tree, torch_body,
)

torch.set_num_threads(1)

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")
W, N = 4, 12
CAPS = (12, 10, 10)


@pytest.fixture(scope="module")
def scene():
    j_om, t_om = box_sphere_oms()
    arrays = body_arrays(np.random.RandomState(5), W, N, 4, crowded=True)
    body = torch_body(arrays)
    cands = tbp.find_candidates(body, t_om, tbp.CandidateCaps(*CAPS), 0.04)
    return dict(j_om=j_om, t_om=t_om, body=body, j_body=jax_body(arrays),
                cands=cands, j_cands=jax_cands(cands))


def test_edge_pairs_and_sphere_lanes_match_jax(scene):
    s = scene
    ref = jax.jit(lambda b, c: japi._narrowphase_all(
        b, s["j_om"], c, sat_dirs=False))(s["j_body"], s["j_cands"])
    got = tapi._narrowphase_all(s["body"], s["t_om"], s["cands"],
                                sat_dirs=False)
    names = ("ref", "alt", "points", "num", "normal")
    live = assert_lanes_match([getattr(got, k) for k in names],
                              [getattr(ref, k) for k in names])
    ph, pp = CAPS[:2]
    kind = s["cands"].sp_kind.numpy()
    sp_live = live[:, ph + pp:]
    assert live[:, :ph].sum() >= 8 and live[:, ph:ph + pp].sum() >= 8
    for t in (tgeo.TYPE_PLANE, tgeo.TYPE_HULL, tgeo.TYPE_SPHERE):
        assert (sp_live & (kind == t)).sum() >= 1, t


def test_plain_record_matches_tpu_goldens():
    j_om, j_body, j_cands, _, _ = golden_inputs.golden_case()
    _, t_om = box_sphere_oms(with_sphere=False)
    body = torch_body(jax_tree(j_body))
    poses, obj = contacts_cuda.pack_poses(body, body.obj_id)
    hh = torch.from_numpy(np.array(j_cands.hh))
    rec = hhc.hh_record(hh, poses, obj, t_om, edge_dirs=False)
    assert rec.shape == (hh.shape[1], hhc.REC_F, golden_inputs.W)
    ref, alt, pts, num, nrm = (x.numpy() for x in hhc.lanes(rec))
    out = {"np_ref": ref, "np_alt": alt, "np_pts": pts, "np_num": num,
           "np_nrm": nrm}
    golden = np.load(os.path.join(GOLDENS, "kernels_v1.npz"))
    fails = golden_inputs.compare_goldens(out, {k: golden[k] for k in out})
    assert not fails, fails
    assert (num >= 3).sum() >= 10 and (num > 0).sum() >= 30


@pytest.mark.parametrize("sublane, sat_dirs", [
    (True, True), (True, False), (False, False),
], ids=["sublane-edge_dirs", "sublane-edge_pairs", "lane_major-edge_pairs"])
def test_record_matches_pallas_kernel(scene, sublane, sat_dirs):
    """B6 (sublane, both tiers) and B7 (lane-major, edge pairs)."""
    s = scene
    ref = japi.narrowphase_hh_pallas(
        s["j_body"], s["j_om"], s["j_cands"], interpret=True,
        sublane=sublane, pair_tile=8, sat_dirs=sat_dirs,
    )
    body = s["body"]
    poses, obj = contacts_cuda.pack_poses(body, body.obj_id)
    rec = hhc.hh_record(s["cands"].hh, poses, obj, s["t_om"], sat_dirs)
    live = assert_lanes_match(hhc.lanes(rec), ref)
    num = np.asarray(ref[3])
    assert live.sum() >= 8 and (num == 1).sum() >= 2 and (num >= 3).sum() >= 2
    # the record's lanes are the hull-hull segment of the lane assembly
    full = tapi._narrowphase_all(body, s["t_om"], s["cands"],
                                 sat_dirs=sat_dirs)
    for a, b in zip(hhc.lanes(rec), (full.ref, full.alt, full.points,
                                     full.num, full.normal)):
        assert torch.equal(a, b[:, :CAPS[0]])


def test_launch_path_refuses_cpu_tensors_and_large_hulls(scene):
    """The kernel's launch path takes CUDA tensors only, and a hull
    larger than the kernel's per-thread tables is refused, not cut."""
    body = scene["body"]
    poses, obj = contacts_cuda.pack_poses(body, body.obj_id)
    with pytest.raises(ValueError, match="CUDA tensor"):
        hhc._launch(scene["cands"].hh, poses, obj, scene["t_om"])
    from madrona_tpu_torch.physics import bodies as tbodies

    reg = tbodies.ObjectRegistry()
    reg.add_plane()
    ang = np.linspace(0, 2 * np.pi, 9)[:-1]
    prism = np.concatenate([
        np.stack([np.cos(ang), np.sin(ang), np.full(8, z)], -1)
        for z in (-0.5, 0.5)]).astype(np.float32)
    faces = ([list(range(8, 16)), list(range(7, -1, -1))]
             + [[i, (i + 1) % 8, 8 + (i + 1) % 8, 8 + i] for i in range(8)])
    reg.add_hull(tgeo.build_hull(prism, faces), mass=1.0)
    with pytest.raises(ValueError, match="hull dims"):
        contacts_cuda.check_tables(reg.build())
    assert hhc.KERNEL.launches == 0
