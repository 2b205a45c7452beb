"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy and handed to both packages; JAX state is
carried into the port through madrona_tpu_torch.interop.
"""

import dataclasses

import numpy as np
import torch

from madrona_tpu_torch.interop import state_from_numpy
from madrona_tpu_torch.models import escape_room as t_er
from madrona_tpu_torch.physics import api as t_api
from madrona_tpu_torch.physics import xpbd as t_xpbd

# (name, first row, last row, tolerance) of the substep solver's 33 output
# fields: the JAX package's golden bounds (tests/golden_inputs.py:484-492)
SOLVER_FIELDS = (
    ("pos", 0, 3, 1e-3), ("rot", 3, 7, 1e-3),
    ("vel", 7, 10, 5e-2), ("omega", 10, 13, 2e-1),
    ("prev_x", 13, 16, 1e-3), ("prev_q", 16, 20, 1e-3),
    ("presolve_x", 20, 23, 1e-3), ("presolve_q", 23, 27, 1e-3),
    ("presolve_v", 27, 30, 5e-2), ("presolve_w", 30, 33, 2e-1),
)


def jax_tree(x):
    """A JAX pytree of dataclasses/dicts -> the same tree of numpy."""
    if dataclasses.is_dataclass(x):
        return {f.name: jax_tree(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: jax_tree(v) for k, v in x.items()}
    return np.asarray(x)


def carry_state(jax_state):
    """A JAX SimState as the port's SimState on the CPU."""
    return state_from_numpy(jax_tree(jax_state), "cpu")


def body_arrays(rs, w, n, n_obj_hi, crowded=False):
    """A random body scene as numpy arrays (the JAX package's broadphase
    test scene): row 0 a floor plane, row 1 a static box, the last two
    rows sometimes dead."""
    def q_rand(shape):
        q = rs.randn(*shape, 4).astype(np.float32)
        return q / np.linalg.norm(q, axis=-1, keepdims=True)

    spread = 0.8 if crowded else 2.5
    pos = rs.uniform(-spread, spread, (w, n, 3)).astype(np.float32)
    pos[..., 2] = rs.uniform(0.0, 1.2 if crowded else 3.0, (w, n))
    pos[:, 0] = 0.0
    obj = rs.randint(1, n_obj_hi, (w, n)).astype(np.int32)
    obj[:, 0] = 0
    resp = np.full((w, n), t_xpbd.RESPONSE_DYNAMIC, np.int32)
    resp[:, :2] = t_xpbd.RESPONSE_STATIC
    active = np.ones((w, n), bool)
    active[:, -2:] = rs.rand(w, 2) < 0.5
    rot = q_rand((w, n))
    rot[:, 0] = [1, 0, 0, 0]
    z3 = np.zeros((w, n, 3), np.float32)
    z4 = np.zeros((w, n, 4), np.float32)
    return dict(
        pos=pos, rot=rot,
        scale=rs.uniform(0.5, 1.8, (w, n, 3)).astype(np.float32),
        vel=(1.5 * rs.randn(w, n, 3)).astype(np.float32),
        omega=z3, obj_id=obj, response=resp, ext_force=z3, ext_torque=z3,
        prev_x=z3, prev_q=z4, presolve_x=z3, presolve_q=z4,
        presolve_v=z3, presolve_w=z3, active=active,
    )


def torch_body(arrays):
    """numpy field dict -> the port's BodyState (CPU)."""
    return t_xpbd.BodyState(**{
        k: torch.from_numpy(np.array(v, copy=True)) for k, v in arrays.items()
    })


def assert_cands_equal(got, ref):
    """Port Candidates == JAX Candidates, every field exactly."""
    for f in ("hh", "hh_num", "hp", "hp_num", "sp", "sp_num", "sp_kind",
              "overflow"):
        a = getattr(got, f).numpy()
        b = np.asarray(getattr(ref, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f)


def sorted_live_points(points, num):
    """Live manifold points [..., 4, 4] -> lexicographically sorted, dead
    slots zeroed (the 4-point reduction may emit one set in another
    order at argmax ties; tests/golden_inputs.py compares the same way)."""
    pts = np.asarray(points, np.float64).reshape(-1, 4, 4)
    live = np.arange(4)[None] < np.asarray(num).reshape(-1, 1)
    pts = np.where(live[..., None], pts, 0.0)
    order = np.lexsort(
        (pts[..., 3], pts[..., 2], pts[..., 1], pts[..., 0]), axis=-1
    )
    return np.take_along_axis(pts, order[..., None], axis=1)


def with_grab_joints(state):
    """An Escape Room SimState (CPU) with grab joints on: a fixed joint
    (agent 0 holds cube 0) in the even worlds, a hinge (agent 1, cube 1)
    in world 1."""
    jb = {k: v.clone()
          for k, v in state.singletons[t_api.JOINT_BUFFER].items()}
    f32 = lambda *v: torch.tensor(v, dtype=torch.float32)   # noqa: E731
    even = slice(0, jb["e1"].shape[0], 2)
    jb["e1"][even, 0] = t_er.ROW_AGENT0
    jb["e2"][even, 0] = t_er.ROW_CUBE0
    jb["jtype"][even, 0] = 0
    jb["r1"][even, 0] = f32(0.0, 0.6, 0.0)
    jb["r2"][even, 0] = f32(0.0, -0.6, 0.0)
    jb["attach_q1"][even, 0] = f32(1.0, 0.0, 0.0, 0.0)
    jb["attach_q2"][even, 0] = f32(1.0, 0.0, 0.0, 0.0)
    jb["active"][even, 0] = True
    jb["e1"][1, 1] = t_er.ROW_AGENT0 + 1
    jb["e2"][1, 1] = t_er.ROW_CUBE0 + 1
    jb["jtype"][1, 1] = 1
    jb["r1"][1, 1] = f32(0.0, 0.5, 0.1)
    jb["r2"][1, 1] = f32(0.0, -0.5, 0.0)
    jb["a1_local"][1, 1] = f32(0.0, 0.0, 1.0)
    jb["a2_local"][1, 1] = f32(0.0, 0.1, 1.0)
    jb["active"][1, 1] = True
    singles = dict(state.singletons)
    singles[t_api.JOINT_BUFFER] = jb
    return dataclasses.replace(state, singletons=singles)
