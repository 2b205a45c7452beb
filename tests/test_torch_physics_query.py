"""Body queries, the hull builder and the math3d helpers of the PyTorch
port against the JAX package (tests/test_physics_query.py,
tests/test_physics.py:40).

The same inputs, made with numpy from a seed, go through both packages:
  * aabb_overlap_bodies: the masks equal bit for bit (random scenes of
    hulls, spheres and planes, dead rows included, and the JAX test's
    scene);
  * raycast_bodies: hit rows equal; t within 1e-5 relative (floored at
    1) on hulls, spheres and planes, with exclude_row and inactive rows;
  * convex_hull_from_points: the HullData equal bit for bit, field by
    field (random clouds and the cube with interior points);
  * narrowphase.hull_to_world: within 1e-6 of the JAX package's;
  * the math3d helpers: equal to 1e-6 (AABB helpers bit for bit)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu.physics import bodies as jbodies
from madrona_tpu.physics import geo as jgeo
from madrona_tpu.physics import narrowphase as jnp_
from madrona_tpu.physics import query as jquery
from madrona_tpu.utils import math3d as jm3
from madrona_tpu_torch.physics import bodies as tbodies
from madrona_tpu_torch.physics import geo as tgeo
from madrona_tpu_torch.physics import narrowphase as tnp_
from madrona_tpu_torch.physics import query as tquery
from madrona_tpu_torch.utils import math3d as tm3

from torch_port import jax_body, torch_body

torch.set_num_threads(1)

T_TOL = 1e-5


def _oms():
    """(JAX, port) ObjectManagers: a unit box, a unit sphere, a plane, a
    flat box."""
    oms = []
    for mod, geo in ((jbodies, jgeo), (tbodies, tgeo)):
        reg = mod.ObjectRegistry()
        reg.add_hull(geo.box_hull((1.0, 1.0, 1.0)), mass=1.0)
        reg.add_sphere(radius=1.0, mass=1.0)
        reg.add_plane()
        reg.add_hull(geo.box_hull((0.4, 0.8, 0.3)), mass=2.5)
        oms.append(reg.build())
    return oms


def _scene(rs, w=3, n=7, objs=(0, 1, 3), plane=True):
    """Random bodies (row 0 a plane when ``plane``), the last row dead in
    some worlds; uniform scale for spheres."""
    q = rs.randn(w, n, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    obj = rs.choice(objs, (w, n)).astype(np.int32)
    scale = rs.uniform(0.5, 1.6, (w, n, 3)).astype(np.float32)
    scale = np.where((obj == 1)[..., None], scale[..., :1], scale)
    pos = rs.uniform(-5, 5, (w, n, 3)).astype(np.float32)
    if plane:
        obj[:, 0] = 2
        pos[:, 0] = [0, 0, -3.0]
        q[:, 0] = [np.cos(0.1), np.sin(0.1), 0, 0]
    active = np.ones((w, n), bool)
    active[:, -1] = rs.rand(w) < 0.5
    z3 = np.zeros((w, n, 3), np.float32)
    return dict(
        pos=pos, rot=q, scale=scale, vel=z3, omega=z3, obj_id=obj,
        response=np.zeros((w, n), np.int32), ext_force=z3, ext_torque=z3,
        prev_x=pos, prev_q=q, presolve_x=pos, presolve_q=q, presolve_v=z3,
        presolve_w=z3, active=active,
    )


def _rays(rs, w, r):
    o = rs.uniform(-7, 7, (w, r, 3)).astype(np.float32)
    d = rs.normal(size=(w, r, 3)).astype(np.float32)
    d[:, ::3] *= 2.5                       # some dirs not unit
    return o, d


@pytest.mark.parametrize("seed", [0, 1])
def test_raycast_bodies_match_jax(seed):
    """Random hull/sphere/plane scenes; then with exclude_row (each ray
    ignores a random row, or none) and the active override."""
    j_om, t_om = _oms()
    rs = np.random.RandomState(seed)
    arrays = _scene(rs)
    w, n = arrays["obj_id"].shape
    o, d = _rays(rs, w, 96)
    excl = rs.randint(-1, n, (w, 96)).astype(np.int32)
    act = rs.rand(w, n) < 0.8
    hits = 0
    for kw in ({}, {"exclude_row": excl}, {"active": act}):
        jt, jr = jax.jit(lambda b, o_, d_, extra: jquery.raycast_bodies(
            b, j_om, o_, d_, 30.0, **extra))(
            jax_body(arrays), jnp.asarray(o), jnp.asarray(d),
            {k: jnp.asarray(v) for k, v in kw.items()})
        tt, tr = tquery.raycast_bodies(
            torch_body(arrays), t_om, torch.from_numpy(o),
            torch.from_numpy(d), 30.0,
            **{k: torch.from_numpy(v) for k, v in kw.items()})
        jt, jr = np.asarray(jt), np.asarray(jr)
        np.testing.assert_array_equal(tr.numpy(), jr)
        assert tr.dtype == torch.int32 and tt.dtype == torch.float32
        rel = np.abs(tt.numpy() - jt) / np.maximum(np.abs(jt), 1.0)
        assert rel.max() <= T_TOL, rel.max()
        hits += int((jr >= 0).sum())
    # every primitive type was hit
    ptype = arrays["obj_id"][np.arange(w)[:, None], np.maximum(jr, 0)]
    assert hits > 100 and set(ptype[jr >= 0].tolist()) >= {0, 1, 2}


def test_raycast_analytic_and_exclusions():
    """tests/test_physics_query.py's analytic cases on the port: the
    sphere's front and the floor; excluding or deactivating the near box
    exposes the far one."""
    _, om = _oms()

    def body(pos, obj, active=None):
        w, n = obj.shape
        rot = np.zeros((w, n, 4), np.float32)
        rot[..., 0] = 1
        z3 = np.zeros((w, n, 3), np.float32)
        return torch_body(dict(
            pos=pos, rot=rot, scale=np.ones((w, n, 3), np.float32), vel=z3,
            omega=z3, obj_id=obj, response=np.zeros((w, n), np.int32),
            ext_force=z3, ext_torque=z3, prev_x=pos, prev_q=rot,
            presolve_x=pos, presolve_q=rot, presolve_v=z3, presolve_w=z3,
            active=np.ones((w, n), bool) if active is None else active))

    pos = np.zeros((1, 2, 3), np.float32)
    pos[0, 1] = [0, 5, 1]
    b = body(pos, np.asarray([[2, 1]], np.int32))
    t, row = tquery.raycast_bodies(
        b, om, torch.tensor([[[0.0, 0, 1], [0, 0, 3]]]),
        torch.tensor([[[0.0, 1, 0], [0, 0, -1]]]), 50.0)
    np.testing.assert_allclose(t.numpy()[0], [4.0, 3.0], rtol=1e-5)
    assert row.tolist() == [[1, 0]]

    pos = np.zeros((1, 2, 3), np.float32)
    pos[0, 0] = [0, 3, 0]
    pos[0, 1] = [0, 6, 0]
    obj = np.zeros((1, 2), np.int32)
    o = torch.zeros((1, 1, 3))
    d = torch.tensor([[[0.0, 1, 0]]])
    t, row = tquery.raycast_bodies(body(pos, obj), om, o, d, 50.0)
    assert abs(float(t) - 2.0) < 1e-5 and int(row) == 0
    t, row = tquery.raycast_bodies(body(pos, obj), om, o, d, 50.0,
                                   exclude_row=torch.tensor([[0]],
                                                            dtype=torch.int32))
    assert abs(float(t) - 5.0) < 1e-5 and int(row) == 1
    t, row = tquery.raycast_bodies(
        body(pos, obj, np.zeros((1, 2), bool)), om, o, d, 50.0)
    assert float(t) == 50.0 and int(row) == -1


@pytest.mark.parametrize("seed", [0, 1])
def test_aabb_overlap_bodies_match_jax(seed):
    j_om, t_om = _oms()
    rs = np.random.RandomState(seed + 5)
    arrays = _scene(rs, w=4, n=9)
    lo = rs.uniform(-6, 4, (4, 12, 3)).astype(np.float32)
    hi = lo + rs.uniform(0.1, 4, (4, 12, 3)).astype(np.float32)
    jm = np.asarray(jax.jit(lambda b, lo_, hi_: jquery.aabb_overlap_bodies(
        b, j_om, lo_, hi_))(jax_body(arrays), jnp.asarray(lo),
                            jnp.asarray(hi)))
    tm = tquery.aabb_overlap_bodies(torch_body(arrays), t_om,
                                    torch.from_numpy(lo),
                                    torch.from_numpy(hi)).numpy()
    np.testing.assert_array_equal(tm, jm)
    assert jm.any() and not jm.all()
    # the JAX test's scene: boxes at y = 0 and 10, a sphere at y = 5
    pos = np.zeros((1, 3, 3), np.float32)
    pos[0, 1] = [0, 10, 0]
    pos[0, 2] = [0, 5, 0]
    rot = np.zeros((1, 3, 4), np.float32)
    rot[..., 0] = 1
    z3 = np.zeros((1, 3, 3), np.float32)
    scene = dict(pos=pos, rot=rot, scale=np.ones((1, 3, 3), np.float32),
                 vel=z3, omega=z3, obj_id=np.asarray([[0, 0, 1]], np.int32),
                 response=np.zeros((1, 3), np.int32), ext_force=z3,
                 ext_torque=z3, prev_x=pos, prev_q=rot, presolve_x=pos,
                 presolve_q=rot, presolve_v=z3, presolve_w=z3,
                 active=np.asarray([[False, True, True]]))
    q_lo = torch.tensor([[[-0.5, -2.0, -0.5], [-0.5, 4.2, -0.5]]])
    q_hi = torch.tensor([[[0.5, -0.9, 0.5], [0.5, 4.8, 0.5]]])
    m = tquery.aabb_overlap_bodies(torch_body(scene), t_om, q_lo, q_hi)
    assert m.tolist() == [[[False, False, False], [False, False, True]]]


def _hull_fields_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


def test_convex_hull_from_points_matches_jax():
    """The cube with interior points (tests/test_physics.py:40) and random
    clouds: the same HullData, bit for bit."""
    cube = np.array(
        [[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)]
        + [[0, 0, 0], [0.5, 0.2, -0.3]])
    h = tgeo.convex_hull_from_points(cube)
    assert h.verts_mask.sum() == 8 and h.faces_mask.sum() == 6
    _hull_fields_equal(h, jgeo.convex_hull_from_points(cube))
    # a hexagonal prism (coplanar triangles merged into its caps and
    # sides) and random clouds; past a table's capacity both raise
    ang = np.arange(6) * np.pi / 3
    ring = np.stack([np.cos(ang), np.sin(ang), np.zeros(6)], -1)
    clouds = [np.concatenate([ring, ring + [0, 0, 1.5]])]
    rs = np.random.RandomState(7)
    clouds += [rs.randn(n, 3) * rs.uniform(0.5, 2.0, 3)
               for n in (5, 6, 6, 7, 7, 8, 12)]
    built = 0
    for pts in clouds:
        try:
            ref = jgeo.convex_hull_from_points(pts)
        except ValueError as e:           # over a table capacity
            with pytest.raises(ValueError, match=str(e).split()[0]):
                tgeo.convex_hull_from_points(pts)
            continue
        _hull_fields_equal(tgeo.convex_hull_from_points(pts), ref)
        built += 1
    assert built >= 5


def test_hull_to_world_and_math3d_helpers_match_jax():
    j_om, t_om = _oms()
    rs = np.random.RandomState(2)
    pos = rs.randn(5, 3).astype(np.float32)
    q = rs.randn(5, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    s = rs.uniform(0.5, 1.5, (5, 3)).astype(np.float32)
    th = tnp_.hull_to_world(t_om, 3, torch.from_numpy(pos),
                            torch.from_numpy(q), torch.from_numpy(s))
    to_world = jax.jit(lambda p, r, sc: jnp_.hull_to_world(j_om, 3, p, r,
                                                            sc))
    for i in range(5):
        jh = to_world(jnp.asarray(pos[i]), jnp.asarray(q[i]),
                      jnp.asarray(s[i]))
        for f in ("verts", "planes_n", "planes_d", "edge_p1", "edge_p2",
                  "edge_n1", "edge_n2", "face_polys", "center"):
            np.testing.assert_allclose(getattr(th, f)[i].numpy(),
                                       np.asarray(getattr(jh, f)),
                                       rtol=0, atol=1e-6, err_msg=f)

    v = rs.randn(6, 3).astype(np.float32)
    v[0] = 0.0
    t = torch.from_numpy
    for name, args in (
        ("length2", (v,)), ("length", (v,)), ("safe_normalize", (v,)),
        ("quat_rotate_inv", (q, pos)), ("quat_from_angular", (v, 0.25)),
        ("quat_axis_angle", (v[1:], np.float32(0.7))),
    ):
        got = getattr(tm3, name)(*[t(a) if isinstance(a, np.ndarray)
                                   and a.ndim else a for a in args])
        ref = getattr(jm3, name)(*[jnp.asarray(a) for a in args])
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(tm3.vec(1, 2, 3).numpy(),
                                  np.asarray(jm3.vec(1, 2, 3)))
    np.testing.assert_array_equal(tm3.quat(1, 0, 0, 0).numpy(),
                                  np.asarray(jm3.quat(1, 0, 0, 0)))
    np.testing.assert_array_equal(tm3.quat_identity((2, 3)).numpy(),
                                  np.asarray(jm3.quat_identity((2, 3))))

    lo = rs.randn(4, 6, 3).astype(np.float32)
    hi = lo + rs.uniform(0, 2, (4, 6, 3)).astype(np.float32)
    lo2 = rs.randn(4, 6, 3).astype(np.float32)
    hi2 = lo2 + rs.uniform(0, 2, (4, 6, 3)).astype(np.float32)
    mask = rs.rand(4, 6) < 0.7
    a_t, b_t = (t(lo), t(hi)), (t(lo2), t(hi2))
    a_j, b_j = (jnp.asarray(lo), jnp.asarray(hi)), (jnp.asarray(lo2),
                                                    jnp.asarray(hi2))
    pairs = [
        (tm3.aabb_merge(a_t, b_t), jm3.aabb_merge(a_j, b_j)),
        (tm3.aabb_expand(a_t, 0.25), jm3.aabb_expand(a_j, 0.25)),
        (tm3.aabb_contains(a_t, b_t), jm3.aabb_contains(a_j, b_j)),
        (tm3.aabb_overlaps(a_t, b_t), jm3.aabb_overlaps(a_j, b_j)),
        (tm3.aabb_from_points(t(lo), t(mask)),
         jm3.aabb_from_points(jnp.asarray(lo), jnp.asarray(mask))),
        (tm3.aabb_invalid((2,)), jm3.aabb_invalid((2,))),
        (tm3.aabb_ray_hit(a_t, t(lo2), t(1.0 / hi2), 3.0),
         jm3.aabb_ray_hit(a_j, jnp.asarray(lo2), jnp.asarray(1.0 / hi2),
                          3.0)),
    ]
    for got, ref in pairs:
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
