"""ECS core, math helpers and scatter primitives of the PyTorch port vs
the JAX package. Tolerance: none (exact), except the trigonometric
quaternion helpers (float32 rounding, 1e-6)."""

import jax.numpy as jnp
import numpy as np
import torch

from madrona_tpu.models.base import make_sim as j_make_sim
from madrona_tpu.models.escape_room import EscapeRoom as JEscapeRoom
from madrona_tpu.ops import scatter as jscatter
from madrona_tpu.utils import math3d as jm3
from madrona_tpu_torch import make_sim
from madrona_tpu_torch.interop import state_to_numpy
from madrona_tpu_torch.models.escape_room import EscapeRoom
from madrona_tpu_torch.ops import scatter as tscatter
from madrona_tpu_torch.utils import math3d as tm3

from torch_port import jax_tree

torch.set_num_threads(1)


def test_masked_scatter_matches_jax():
    rs = np.random.RandomState(0)
    w, n, k = 5, 7, 4
    arr = rs.randn(w, n, 3).astype(np.float32)
    widx = np.broadcast_to(np.arange(w)[:, None], (w, k)).copy()
    # distinct rows per world, so set has one answer
    idx = np.stack([rs.permutation(n)[:k] for _ in range(w)]).astype(np.int32)
    vals = rs.randn(w, k, 3).astype(np.float32)
    mask = rs.rand(w, k) < 0.6
    t = torch.from_numpy
    for jf, tf in ((jscatter.masked_set_2d, tscatter.masked_set_2d),
                   (jscatter.masked_add_2d, tscatter.masked_add_2d)):
        ref = jf(jnp.asarray(arr), jnp.asarray(widx), jnp.asarray(idx),
                 jnp.asarray(vals), jnp.asarray(mask))
        got = tf(t(arr), t(widx).long(), t(idx).long(), t(vals), t(mask))
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_initial_state_matches_jax():
    """Tables, singletons, entity store, per-world keys and the step
    counter of a fresh Escape Room sim equal the JAX package's, dtype
    for dtype (the Threefry words as uint32)."""
    j = jax_tree(j_make_sim(JEscapeRoom(), num_worlds=3, seed=9,
                            donate=False).state)
    t = state_to_numpy(make_sim(EscapeRoom(), num_worlds=3, seed=9,
                                device="cpu").state)

    def same(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for key in a:
                same(a[key], b[key], f"{path}/{key}")
        else:
            assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=path)

    same(t, j, "state")


def test_quaternion_and_aabb_helpers_match_jax():
    rs = np.random.RandomState(1)
    q = rs.randn(16, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rs.randn(16, 3).astype(np.float32)
    yaw = rs.uniform(-3, 3, 16).astype(np.float32)
    lo = -rs.rand(16, 3).astype(np.float32)
    hi = rs.rand(16, 3).astype(np.float32)
    s = rs.uniform(0.5, 2, (16, 3)).astype(np.float32)
    t, j = torch.from_numpy, jnp.asarray
    pairs = [
        (tm3.quat_rotate(t(q), t(v)), jm3.quat_rotate(j(q), j(v))),
        (tm3.quat_mul(t(q), t(q[::-1].copy())),
         jm3.quat_mul(j(q), j(q[::-1].copy()))),
        (tm3.quat_yaw_only(t(yaw)), jm3.quat_yaw_only(j(yaw))),
        (tm3.yaw_of_quat(tm3.quat_yaw_only(t(yaw))), j(yaw)),
        (torch.cat(tm3.aabb_transform((t(lo), t(hi)), t(v), t(q), t(s)), -1),
         jnp.concatenate(jm3.aabb_transform((j(lo), j(hi)), j(v), j(q),
                                            j(s)), -1)),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)
