"""The port's CUDA kernel sources, compiled for the CPU, vs their plain
versions.

There is no GPU and no nvcc where these tests run, so the seven sources
under madrona_tpu_torch/csrc are compiled with g++ against a stand-in
for the CUDA runtime (tests/torch_kernel_shim.py: one std::thread per
CUDA thread, no FMA contraction) and launched through the wrappers'
own launch paths on CPU tensors. This holds each kernel's arithmetic,
indexing and barriers against its plain PyTorch version at a small
size; the same comparison at 4096 worlds on the card is chip_smoke.py's.
The broadphase, contacts and solver sources run once more at Hide &
Seek's shape (a ramp wedge among the hulls, caps 7/9, 4 joint slots, a
locked box as a static row inside the solver's dynamic range). The
hull-hull record source runs in both SAT tiers, the contacts source in
the edge_pairs tier too, and the fused-step source on a crowded scene
with sphere lanes (both tiers), on the Escape Room state with grab joints
and on the Hide & Seek state; its narrowphase lanes (the contact tables
before the substeps) are held against the plain version's like the
contacts source's.

Tolerances: broadphase exact; lidar 1e-5; raycast 0 (every plane equal
bit for bit, for the four option sets); contacts ref/alt/num exact,
reduced contacts 1e-4, manifold points 1e-3 unordered; hull-hull record
the same, and the fused step's lanes too; solver and fused step poses 1e-3, velocities 5e-2, angular
velocities 2e-1 (tests/golden_inputs.py:484-492)."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from madrona_tpu_torch import make_sim
from madrona_tpu_torch.models import escape_room as er
from madrona_tpu_torch.models.escape_room import EscapeRoom
from madrona_tpu_torch.ops import (
    broadphase_cuda, contacts_cuda, fused_cuda, hh_narrowphase_cuda,
    lidar_cuda, raycast_cuda, solver_cuda,
)
from madrona_tpu_torch.physics import api as tapi
from madrona_tpu_torch.physics import bodies as tbodies
from madrona_tpu_torch.physics import broadphase as tbp
from madrona_tpu_torch.physics import geo as tgeo
from madrona_tpu_torch.physics import xpbd as txpbd

import torch_kernel_shim as shim
from torch_port import (
    SOLVER_FIELDS, assert_lanes_match, body_arrays, hide_seek_kernel_inputs,
    hide_seek_scene, raycast_planes, sorted_live_points, torch_body,
    with_grab_joints,
)

torch.set_num_threads(1)

W = 8
MODULES = {"broadphase": broadphase_cuda, "contacts": contacts_cuda,
           "solver": solver_cuda, "lidar": lidar_cuda,
           "raycast": raycast_cuda, "hh_narrowphase": hh_narrowphase_cuda,
           "fused_step": fused_cuda}


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


# (worlds, bodies, caps, crowded). The source takes 8 worlds a block, a
# warp a world, 32 pairs a round: 7 and 13 worlds leave a ragged block;
# at 40 bodies a world's 780 pairs take 25 rounds and its lists run over
# many of them; 64 bodies is MAX_BODIES; caps of 1 saturate every list.
BROADPHASE_CASES = {
    "roomy": (W, 12, (48, 20, 48), True),
    "saturating": (W, 12, (2, 1, 1), True),
    "worlds_7": (7, 12, (48, 20, 48), True),
    "worlds_13": (13, 12, (48, 20, 48), True),
    "bodies_40": (W, 40, (780, 40, 780), True),
    "bodies_64": (W, 64, (300, 128, 300), False),
    "caps_1": (W, 12, (1, 1, 1), True),
}


@pytest.mark.parametrize("case", list(BROADPHASE_CASES))
def test_broadphase_source_equals_plain(cpu_kernels, case):
    worlds, n, caps, crowded = BROADPHASE_CASES[case]
    om = _box_om(True)
    body = torch_body(body_arrays(np.random.RandomState(1), worlds, n, 4,
                                  crowded=crowded))
    caps = tbp.CandidateCaps(*caps)
    got = broadphase_cuda.broadphase(
        broadphase_cuda.pack_bodies(body, om), caps, 0.04)
    ref = tbp.find_candidates(body, om, caps, 0.04)
    for f in ("hh", "hh_num", "hp", "hp_num", "sp", "sp_num", "sp_kind",
              "overflow"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert int(got.hh_num.sum()) > 0 and int(got.sp_num.sum()) > 0
    if case == "bodies_40":
        # lists longer than a round, none full
        assert int(ref.hh_num.max()) > 32 and int(ref.sp_num.max()) > 32
        assert not bool(ref.overflow.any())
    if case == "caps_1":
        assert bool(ref.overflow.all())


def test_lidar_source_matches_plain(cpu_kernels):
    sim = make_sim(EscapeRoom(), num_worlds=W, seed=4, device="cpu")
    args = sim.env.lidar_inputs(sim.state)
    args = tuple(a.contiguous() if torch.is_tensor(a) else a for a in args)
    got = lidar_cuda._launch(*args)
    ref = lidar_cuda.lidar_obb_plain(*args)
    assert float((got - ref).abs().max()) <= 1e-5
    assert bool((got < args[-1]).any())


RAYCAST_OPTIONS = {
    "flat": (False, False, False), "shadows": (True, False, False),
    "lights_shadows": (True, True, False),
    "materials_lights": (False, True, True),
    "materials_shadows": (True, False, True),
}


@pytest.mark.parametrize(
    "name,wide", [(n, w) for w in (False, True) for n in RAYCAST_OPTIONS],
    ids=[n + ("-two_tiles" if w else "") for w in (False, True)
         for n in RAYCAST_OPTIONS])
def test_raycast_source_equals_plain(cpu_kernels, name, wide):
    """200 rays: one ragged tile of 512 (128 threads x 4 rays). Wide:
    1100 rays (two full tiles and a ragged one; the 256 pixel directions
    repeated) over 300 triangle rows (two shared-memory chunks)."""
    shadows, use_lights, use_materials = RAYCAST_OPTIONS[name]
    seed = 10 + list(RAYCAST_OPTIONS).index(name)
    wv, rays = (2, 1100) if wide else (4, 200)
    planes = [torch.from_numpy(x) for x in raycast_planes(
        seed, 8, wv=wv, t_pad=300 if wide else 40)]
    planes[2] = planes[2].repeat(1, 5)[:, :rays].contiguous()
    opts = dict(t_max=50.0, shadows=shadows, use_lights=use_lights,
                use_materials=use_materials, ambient=0.35,
                shadow_ambient=0.3, sky=(0.1, 0.2, 0.4), tex_size=8,
                t_min=1e-3, eps_det=1e-9)
    got = raycast_cuda._launch(*planes, **opts)
    ref = raycast_cuda.raytrace_plain(*planes, **opts)
    assert got.shape == ref.shape == (wv, raycast_cuda.PO, rays)
    assert torch.equal(got, ref)
    hit = float((ref[:, raycast_cuda.O_T] < 50.0).float().mean())
    if wide:
        # 296 live rows cover every ray; the second chunk holds winners
        assert hit == 1.0
        first = planes[0].clone()
        first[:, 256:] = 0.0
        cut = raycast_cuda.raytrace_plain(first, *planes[1:], **opts)
        assert not torch.equal(cut[:, raycast_cuda.O_T],
                               ref[:, raycast_cuda.O_T])
    else:
        assert 0.3 < hit < 1
    if shadows:
        assert float(ref[:, raycast_cuda.O_OCC].mean()) > 0.02


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


def _mixed_tile_scene():
    """Contacts inputs at 20 worlds (the source's tiles of 16 worlds: a
    full one, whose 39 hull-hull lanes go a thread each, and a ragged one,
    whose 12 go a warp each): crowded boxes with hull-hull caps of 4,
    every slot live in most worlds; no hull-hull candidate in every third
    world, no hull-plane one in every fourth, and a dead slot 0 before
    live ones in world 1."""
    om = _box_om(False)
    w, n = 20, er.N_BODIES
    body = torch_body(body_arrays(np.random.RandomState(5), w, n, 3,
                                  crowded=True))
    cands = tbp.find_candidates(body, om, tbp.CandidateCaps(4, 8, 0), 0.04)
    hh, hp = cands.hh.clone(), cands.hp.clone()
    hh[0::3] = n
    hp[1::4] = n
    hh[1, 0] = n
    pred = txpbd.integrate(body, om, 0.01, (0.0, 0.0, -9.8))
    poses, obj = contacts_cuda.pack_poses(pred, body.obj_id)
    return hh, hp, poses, obj, om


def _stacked_scene():
    """Contacts inputs of axis-aligned stacks of equal unit cubes on a
    plane (5 worlds: 15 hull-hull lanes, which the source takes a warp
    each): three cubes stacked, two side by side, each pressed 0.01 into
    the next, a world's stacks shifted by a multiple of 0.25. Equal
    faces, depths and areas tie at every arg-best."""
    om = _box_om(False)
    w, n = 5, 6
    pos = np.zeros((w, n, 3), np.float32)
    for k in range(3):
        pos[:, 1 + k] = (0.0, 0.0, 0.5 + k * 0.99)
    pos[:, 4] = (3.0, 0.0, 0.49)
    pos[:, 5] = (3.99, 0.0, 0.49)
    pos[:, 1:, 0] += 0.25 * np.arange(w, dtype=np.float32)[:, None]
    rot = np.zeros((w, n, 4), np.float32)
    rot[..., 0] = 1.0
    obj = np.ones((w, n), np.int32)
    obj[:, 0] = 0
    resp = np.full((w, n), txpbd.RESPONSE_DYNAMIC, np.int32)
    resp[:, 0] = txpbd.RESPONSE_STATIC
    z3 = np.zeros((w, n, 3), np.float32)
    z4 = np.zeros((w, n, 4), np.float32)
    body = torch_body(dict(
        pos=pos, rot=rot, scale=np.ones((w, n, 3), np.float32), vel=z3,
        omega=z3, obj_id=obj, response=resp, ext_force=z3, ext_torque=z3,
        prev_x=z3, prev_q=z4, presolve_x=z3, presolve_q=z4, presolve_v=z3,
        presolve_w=z3, active=np.ones((w, n), bool)))
    cands = tbp.find_candidates(body, om, tbp.CandidateCaps(8, 8, 0), 0.04)
    poses, obj_t = contacts_cuda.pack_poses(body, body.obj_id)
    return cands.hh.contiguous(), cands.hp.contiguous(), poses, obj_t, om


# the crowded scene's integer tables (one case each), then two scenes of
# their own with every table compared, in both SAT tiers
CONTACT_ROW_CASES = [
    ("crowded", True, 0, "ref"), ("crowded", True, 1, "alt"),
    ("crowded", True, 4, "num"),
    ("mixed_tile", True, None, "mixed_tile-edge_dirs"),
    ("mixed_tile", False, None, "mixed_tile-edge_pairs"),
    ("stacked_ties", True, None, "stacked_ties-edge_dirs"),
    ("stacked_ties", False, None, "stacked_ties-edge_pairs"),
]


@pytest.mark.parametrize("scene,edge_dirs,field",
                         [c[:3] for c in CONTACT_ROW_CASES],
                         ids=[c[3] for c in CONTACT_ROW_CASES])
def test_contacts_source_rows_equal_plain(crowded, scene, edge_dirs, field):
    if scene == "crowded":
        _, _, got, ref = crowded
        assert got[field].dtype == torch.int32
        assert torch.equal(got[field], ref[field])
        if field == 4:
            hh = ref[4][:8]
            assert int((hh >= 3).sum()) >= 5 and int((hh == 1).sum()) >= 5
            assert int((ref[4][8:] > 0).sum()) >= 10
        return
    args = _mixed_tile_scene() if scene == "mixed_tile" else _stacked_scene()
    got = contacts_cuda._launch(*args, edge_dirs=edge_dirs)
    ref = contacts_cuda.contacts_plain(*args, edge_dirs=edge_dirs)
    _assert_tables_match(got, ref)
    hh, hp, poses = args[:3]
    n, ph = poses.shape[0], hh.shape[1]
    hh_num = ref[4][:ph]
    if scene == "mixed_tile":
        cand = hh[..., 0] < n                                 # [W, PH]
        assert int((~cand.any(1)).sum()) >= 6
        assert int(cand.all(1).sum()) >= 6
        assert int((hh_num > 0).sum()) >= 20
        assert int((ref[4][ph:] > 0).sum()) >= 20
    else:
        # every stacked pair a 4-point face contact, every bottom cube
        # on the plane
        assert int((hh_num == 4).sum()) == 3 * hh.shape[0]
        assert int((ref[4][ph:] == 4).sum()) == 3 * hh.shape[0]


def _assert_tables_match(got, ref):
    """Contact tables (ref, alt, con, pts, num) [.., C, W]: rows, counts
    and ok flags equal, the reduced contact (normal, average point,
    largest penetration) within 1e-4 and the manifold points within 1e-3
    unordered on ok lanes. Returns the ok lanes [C, W]."""
    for i in (0, 1, 4):
        assert torch.equal(got[i], ref[i]), i
    ok = ref[2][7] > 0.5
    assert torch.equal(got[2][7], ref[2][7])
    d = torch.where(ok[None], (got[2] - ref[2]).abs(), 0.0)
    assert float(d.max()) <= 1e-4
    c, w = ref[0].shape

    def per_lane(x):
        return np.transpose(x.numpy().reshape(4, 4, c, w), (2, 3, 0, 1))

    num = torch.where(ok, ref[4], 0).numpy()
    dp = np.abs(sorted_live_points(per_lane(got[3]), num)
                - sorted_live_points(per_lane(ref[3]), num))
    assert dp.max() <= 1e-3
    return ok


def test_contacts_source_floats_match_plain(crowded):
    _, _, got, ref = crowded
    _assert_tables_match(got, ref)


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
def solver_cases(crowded, hide_seek):
    """{scene: (step config, the solver's inputs)}."""
    spec, args = _escape_room_solver_case()
    body, om, _, cargs = crowded
    spec_cr = dataclasses.replace(spec, solver_dynamic_range=None,
                                  solver_ref_dyn_lanes=0, jacobi_iters=2)
    args_cr = (*solver_cuda.pack_state(body, om), *cargs, None, None, None)
    return {"escape_room": (spec, args), "crowded": (spec_cr, args_cr),
            "hide_seek": (hide_seek["env"].cfg, hide_seek["sargs"])}


def _first_worlds(args, w):
    """The first w worlds of worlds-minor kernel inputs."""
    return tuple(None if a is None else a[..., :w].contiguous()
                 for a in args)


# (scene, worlds): 0 = all W = 8 worlds, one full block; 7 = an odd count,
# so that one half-warp of the source's 16-lane worlds has no world
SOLVER_SCENES = [("escape_room", 0), ("crowded", 0), ("escape_room", 7),
                 ("crowded", 7), ("hide_seek", 7)]


@pytest.mark.parametrize(
    "scene,worlds", SOLVER_SCENES,
    ids=[s + ("-odd_worlds" if w else "") for s, w in SOLVER_SCENES])
def test_solver_source_matches_plain(solver_cases, scene, worlds):
    spec, args = solver_cases[scene]
    if worlds:
        args = _first_worlds(args, worlds)
    got = solver_cuda._launch(spec, *args)
    ref = solver_cuda.substep_solver_plain(spec, *args)
    state, param = args[0], args[1]
    assert got.shape == ref.shape == (33, *state.shape[1:])
    assert bool(torch.isfinite(got).all())
    for name, lo, hi, tol in SOLVER_FIELDS:
        d = float((got[lo:hi] - ref[lo:hi]).abs().max())
        assert d <= tol, (scene, name, d)
    assert float((got[:3] - state[:3]).abs().max()) > 1e-3
    # static rows and rows outside the dynamic range: bit-equal, no
    # presolve velocities
    static = param[8] > 0.5
    if spec.solver_dynamic_range:
        d0, d1 = spec.solver_dynamic_range
        static[:d0] = True
        static[d1:] = True
    assert torch.equal(got[:13][:, static], state[:, static])
    assert torch.equal(got[13:20][:, static], state[:7][:, static])
    assert torch.equal(got[20:27][:, static], state[:7][:, static])
    assert bool((got[27:][:, static] == 0).all())


@pytest.fixture(scope="module")
def hide_seek(cpu_kernels):
    """The three physics kernels' sources and their plain versions on
    one arranged Hide & Seek state (tests/torch_port.hide_seek_scene)."""
    env, sim, state = hide_seek_scene(W, 3)
    body, cands, cin, sargs = hide_seek_kernel_inputs(env, sim, state)
    bp_got = broadphase_cuda.broadphase(
        broadphase_cuda.pack_bodies(body, env.om), env.caps, env.cfg.dt)
    co_got = contacts_cuda._launch(*cin, env.om)
    so_got = solver_cuda._launch(env.cfg, *sargs)
    so_ref = solver_cuda.substep_solver_plain(env.cfg, *sargs)
    return dict(env=env, cands=cands, bp=bp_got, co=co_got, co_ref=sargs[2:7],
                so=so_got, so_ref=so_ref, state=sargs[0], sargs=sargs)


def test_hide_seek_broadphase_source_equals_plain(hide_seek):
    """A locked box is static at run time: the pair test's "not both
    static" reads the response column, not the object table."""
    got, ref = hide_seek["bp"], hide_seek["cands"]
    for f in ("hh", "hh_num", "hp", "hp_num", "sp", "sp_num", "sp_kind",
              "overflow"):
        assert torch.equal(getattr(got, f), getattr(ref, f)), f
    assert int(got.hh_num.min()) >= 4 and not bool(got.overflow.any())
    # the locked box (even worlds) is no hull-plane candidate
    assert int(got.hp_num[0]) == int(got.hp_num[1]) - 1


def test_hide_seek_contacts_source_matches_plain(hide_seek):
    got, ref = hide_seek["co"], hide_seek["co_ref"]
    _assert_tables_match(got, ref)
    assert int((ref[4][:7] > 0).sum()) >= 3 * W


def test_hide_seek_solver_source_matches_plain(hide_seek):
    got, ref, state = hide_seek["so"], hide_seek["so_ref"], hide_seek["state"]
    assert bool(torch.isfinite(got).all())
    for name, lo, hi, tol in SOLVER_FIELDS:
        d = float((got[lo:hi] - ref[lo:hi]).abs().max())
        assert d <= tol, (name, d)
    assert float((got[:3] - state[:3]).abs().max()) > 1e-3
    # rows below the dynamic range, and the locked box inside it
    assert torch.equal(got[:13, :5], state[:, :5])
    assert torch.equal(got[:13, 5, 0::2], state[:, 5, 0::2])


@pytest.fixture(scope="module")
def spheres(cpu_kernels):
    """A crowded scene of rotated, scaled boxes and spheres on a plane,
    with every candidate kind live (caps 12/10/10)."""
    om = _box_om(True)
    arrays = body_arrays(np.random.RandomState(3), W, 16, 4, crowded=True)
    arrays["omega"] = (0.5 * np.random.RandomState(4).randn(
        W, 16, 3)).astype(np.float32)
    body = torch_body(arrays)
    cands = tbp.find_candidates(body, om, tbp.CandidateCaps(12, 10, 10), 0.04)
    assert min(int(cands.hh_num.sum()), int(cands.hp_num.sum()),
               int(cands.sp_num.sum())) > 0
    return body, om, cands


@pytest.mark.parametrize("edge_dirs", [True, False],
                         ids=["edge_dirs", "edge_pairs"])
def test_hh_record_source_matches_plain(spheres, edge_dirs):
    body, om, cands = spheres
    poses, obj = contacts_cuda.pack_poses(body, body.obj_id)
    hh = cands.hh.contiguous()
    got = hh_narrowphase_cuda._launch(hh, poses, obj, om, edge_dirs)
    ref = hh_narrowphase_cuda.hh_record_plain(hh, poses, obj, om, edge_dirs)
    live = assert_lanes_match(hh_narrowphase_cuda.lanes(got),
                              hh_narrowphase_cuda.lanes(ref))
    num = ref[:, 2].numpy()
    assert live.sum() >= 40 and (num == 1).sum() >= 10 and (num >= 3).sum() \
        >= 10
    # the kernel leaves zeros where there is no contact
    dead = torch.from_numpy(~live).t()[:, None, :]
    assert bool((torch.where(dead, got[:, 3:], 0.0) == 0).all())


def test_contacts_source_edge_pairs_equals_plain(crowded):
    body, om, _, _ = crowded
    cands = tbp.find_candidates(body, om, tbp.CandidateCaps(8, 8, 0), 0.04)
    pred = txpbd.integrate(body, om, 0.01, (0.0, 0.0, -9.8))
    poses, obj = contacts_cuda.pack_poses(pred, body.obj_id)
    args = (cands.hh.contiguous(), cands.hp.contiguous(), poses, obj, om)
    got = contacts_cuda._launch(*args, edge_dirs=False)
    ref = contacts_cuda.contacts_plain(*args, edge_dirs=False)
    for i in (0, 1, 4):
        assert torch.equal(got[i], ref[i]), i
    ok = ref[2][7] > 0.5
    assert float(torch.where(ok[None], (got[2] - ref[2]).abs(), 0.0).max()) \
        <= 1e-4
    assert int((ref[4][:8] > 0).sum()) >= 10


def _fused_case(name, spheres):
    if name.startswith("spheres"):
        body, om, cands = spheres
        cfg = txpbd.PhysicsConfig(
            narrowphase_once=True, megakernel_fused=True,
            sat_tier="edge_dirs" if name.endswith("dirs") else "edge_pairs")
        return cfg, body, om, cands, ()
    if name == "escape_room":
        env = EscapeRoom()
        sim = make_sim(env, num_worlds=W, seed=2, device="cpu")
        acts = EscapeRoom.random_actions(np.random.RandomState(0), 6, W)
        for i in range(6):
            sim.step({"action": acts[i],
                      "reset": torch.zeros(W, dtype=torch.int32)})
        state, n = with_grab_joints(sim.state), er.N_BODIES
    else:
        env, sim, state = hide_seek_scene(W, 3)
        n = state.tables[tapi.RIGID_BODY].columns["Position"].shape[1]
    body = tapi.body_state(sim.executor.sm, state)
    cands = tbp.find_candidates(body, env.om, env.caps, env.cfg.dt)
    jargs = solver_cuda.pack_joints(tapi.joints_view(state), n)
    cfg = dataclasses.replace(env.cfg, megakernel_fused=True)
    return cfg, body, env.om, cands, jargs


@pytest.mark.parametrize("name", ["spheres_dirs", "spheres_pairs",
                                  "escape_room", "hide_seek"])
def test_fused_source_matches_plain(spheres, name):
    cfg, body, om, cands, jargs = _fused_case(name, spheres)
    args = (*fused_cuda.pack_fused(body, om), cands.hh.contiguous(),
            cands.hp.contiguous(), cands.sp.contiguous(),
            cands.sp_kind.contiguous(), om)
    got, lanes = fused_cuda._launch(cfg, *args, *jargs, lanes=True)
    ref = fused_cuda.fused_step_plain(cfg, *args, *jargs)
    # the narrowphase's lanes at the predicted poses, before the substeps
    ok = _assert_tables_match(
        lanes, fused_cuda.fused_contacts_plain(cfg, *args))
    assert int(ok.sum()) >= W
    assert bool(torch.isfinite(got).all())
    for field, lo, hi, tol in SOLVER_FIELDS:
        d = float((got[lo:hi] - ref[lo:hi]).abs().max())
        assert d <= tol, (name, field, d)
    state, param = args[0], args[1]
    static = param[8] > 0.5
    assert torch.equal(got[:13][:, static], state[:, static])
    assert float((got[:3] - state[:3]).abs().max()) > 1e-3
