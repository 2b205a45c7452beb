"""The port's CUDA kernel sources, compiled for the CPU, vs their plain
versions.

There is no GPU and no nvcc where these tests run, so the four sources
under madrona_tpu_torch/csrc are compiled with g++ against a stand-in
for the CUDA runtime (tests/torch_kernel_shim.py: one std::thread per
CUDA thread, no FMA contraction) and launched through the wrappers'
own launch paths on CPU tensors. This holds each kernel's arithmetic,
indexing and barriers against its plain PyTorch version at a small
size; the same comparison at 4096 worlds on the card is chip_smoke.py's.

Tolerances: broadphase exact; lidar 1e-5; contacts ref/alt/num exact,
reduced contacts 1e-4, manifold points 1e-3 unordered; solver poses
1e-3, velocities 5e-2, angular velocities 2e-1
(tests/golden_inputs.py:484-492)."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from madrona_tpu_torch import make_sim
from madrona_tpu_torch.models import escape_room as er
from madrona_tpu_torch.models.escape_room import EscapeRoom
from madrona_tpu_torch.ops import (
    broadphase_cuda, contacts_cuda, lidar_cuda, solver_cuda,
)
from madrona_tpu_torch.physics import api as tapi
from madrona_tpu_torch.physics import bodies as tbodies
from madrona_tpu_torch.physics import broadphase as tbp
from madrona_tpu_torch.physics import geo as tgeo
from madrona_tpu_torch.physics import xpbd as txpbd

import torch_kernel_shim as shim
from torch_port import (
    SOLVER_FIELDS, body_arrays, sorted_live_points, torch_body,
    with_grab_joints,
)

torch.set_num_threads(1)

W = 8
MODULES = {"broadphase": broadphase_cuda, "contacts": contacts_cuda,
           "solver": solver_cuda, "lidar": lidar_cuda}


@pytest.fixture(scope="module")
def cpu_kernels(tmp_path_factory):
    libs = shim.build_cpu_kernels(tmp_path_factory.mktemp("cpu_kernels"))
    if libs is None:
        pytest.skip("no g++ to compile the kernel sources with")
    with contextlib.ExitStack() as stack:
        for name, module in MODULES.items():
            stack.enter_context(shim.on_cpu(module, libs[name]))
        yield


def _box_om(with_sphere):
    reg = tbodies.ObjectRegistry()
    reg.add_plane()
    reg.add_hull(tgeo.box_hull((0.5, 0.5, 0.5)), mass=1.0)
    reg.add_hull(tgeo.box_hull((0.4, 0.8, 0.3)), mass=2.5)
    if with_sphere:
        reg.add_sphere(0.45, mass=0.8)
    return reg.build()


@pytest.mark.parametrize("caps", [(48, 20, 48), (2, 1, 1)],
                         ids=["roomy", "saturating"])
def test_broadphase_source_equals_plain(cpu_kernels, caps):
    om = _box_om(True)
    body = torch_body(body_arrays(np.random.RandomState(1), W, 12, 4,
                                  crowded=True))
    caps = tbp.CandidateCaps(*caps)
    got = broadphase_cuda.broadphase(
        broadphase_cuda.pack_bodies(body, om), caps, 0.04)
    ref = tbp.find_candidates(body, om, caps, 0.04)
    for f in ("hh", "hh_num", "hp", "hp_num", "sp", "sp_num", "sp_kind",
              "overflow"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert int(got.hh_num.sum()) > 0 and int(got.sp_num.sum()) > 0


def test_lidar_source_matches_plain(cpu_kernels):
    sim = make_sim(EscapeRoom(), num_worlds=W, seed=4, device="cpu")
    args = sim.env.lidar_inputs(sim.state)
    args = tuple(a.contiguous() if torch.is_tensor(a) else a for a in args)
    got = lidar_cuda._launch(*args)
    ref = lidar_cuda.lidar_obb_plain(*args)
    assert float((got - ref).abs().max()) <= 1e-5
    assert bool((got < args[-1]).any())


@pytest.fixture(scope="module")
def crowded(cpu_kernels):
    """Contacts of a crowded box scene: the source's and the plain
    version's, and the inputs the solver case below reuses."""
    om = _box_om(False)
    arrays = body_arrays(np.random.RandomState(3), W, er.N_BODIES, 3,
                         crowded=True)
    arrays["omega"] = (0.5 * np.random.RandomState(4).randn(
        W, er.N_BODIES, 3)).astype(np.float32)
    body = torch_body(arrays)
    cands = tbp.find_candidates(body, om, tbp.CandidateCaps(8, 8, 0), 0.04)
    pred = txpbd.integrate(body, om, 0.01, (0.0, 0.0, -9.8))
    poses, obj = contacts_cuda.pack_poses(pred, body.obj_id)
    args = (cands.hh.contiguous(), cands.hp.contiguous(), poses, obj, om)
    return body, om, contacts_cuda._launch(*args), \
        contacts_cuda.contacts_plain(*args)


@pytest.mark.parametrize("field", [0, 1, 4], ids=["ref", "alt", "num"])
def test_contacts_source_rows_equal_plain(crowded, field):
    _, _, got, ref = crowded
    assert got[field].dtype == torch.int32
    assert torch.equal(got[field], ref[field])
    if field == 4:
        hh = ref[4][:8]
        assert int((hh >= 3).sum()) >= 5 and int((hh == 1).sum()) >= 5
        assert int((ref[4][8:] > 0).sum()) >= 10


def test_contacts_source_floats_match_plain(crowded):
    _, _, got, ref = crowded
    ok = ref[2][7] > 0.5
    assert torch.equal(got[2][7], ref[2][7])
    d = torch.where(ok[None], (got[2] - ref[2]).abs(), 0.0)
    assert float(d.max()) <= 1e-4
    c = ref[0].shape[0]

    def per_lane(x):
        return np.transpose(x.numpy().reshape(4, 4, c, W), (2, 3, 0, 1))

    num = torch.where(ok, ref[4], 0).numpy()
    dp = np.abs(sorted_live_points(per_lane(got[3]), num)
                - sorted_live_points(per_lane(ref[3]), num))
    assert dp.max() <= 1e-3


def _escape_room_solver_case():
    env = EscapeRoom()
    sim = make_sim(env, num_worlds=W, seed=2, device="cpu")
    acts = EscapeRoom.random_actions(np.random.RandomState(0), 6, W)
    for i in range(6):
        sim.step({"action": acts[i],
                  "reset": torch.zeros(W, dtype=torch.int32)})
    state = with_grab_joints(sim.state)
    cfg = env.cfg
    body = tapi.body_state(sim.executor.sm, state)
    cands = tbp.find_candidates(body, env.om, env.caps, cfg.dt)
    pred = txpbd.integrate(body, env.om, cfg.dt / cfg.substeps, cfg.gravity)
    poses, obj = contacts_cuda.pack_poses(pred, body.obj_id)
    cargs = contacts_cuda.contacts_plain(cands.hh, cands.hp, poses, obj,
                                         env.om)
    state_t, param_t = solver_cuda.pack_state(body, env.om)
    jargs = solver_cuda.pack_joints(tapi.joints_view(state), er.N_BODIES)
    return cfg, (state_t, param_t, *cargs, *jargs)


@pytest.fixture(scope="module")
def solver_cases(crowded):
    spec, args = _escape_room_solver_case()
    body, om, _, cargs = crowded
    spec_cr = dataclasses.replace(spec, solver_dynamic_range=None,
                                  solver_ref_dyn_lanes=0, jacobi_iters=2)
    args_cr = (*solver_cuda.pack_state(body, om), *cargs, None, None, None)
    out = {}
    for name, sp, a in (("escape_room", spec, args),
                        ("crowded", spec_cr, args_cr)):
        out[name] = (sp, a[0], solver_cuda._launch(sp, *a),
                     solver_cuda.substep_solver_plain(sp, *a))
    return out


@pytest.mark.parametrize("scene", ["escape_room", "crowded"])
def test_solver_source_matches_plain(solver_cases, scene):
    spec, state, got, ref = solver_cases[scene]
    assert bool(torch.isfinite(got).all())
    for name, lo, hi, tol in SOLVER_FIELDS:
        d = float((got[lo:hi] - ref[lo:hi]).abs().max())
        assert d <= tol, (scene, name, d)
    assert float((got[:3] - state[:3]).abs().max()) > 1e-3
    if spec.solver_dynamic_range:
        d0 = spec.solver_dynamic_range[0]
        assert torch.equal(got[:13, :d0], state[:, :d0])
        assert torch.equal(got[13:20, :d0], state[:7, :d0])
        assert torch.equal(got[20:27, :d0], state[:7, :d0])
        assert bool((got[27:, :d0] == 0).all())
