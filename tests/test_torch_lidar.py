"""Lidar of the PyTorch port vs the JAX package.

The port's lidar wrapper on CPU tensors runs its plain version
(render/raycast.py::trace_rays_obb), the oracle of the CUDA lidar
kernel. It is held against the Pallas lidar kernel in interpret mode
and the JAX slab-test path, on the scene of tests/test_lidar_pallas.py.
Tolerance: rtol = atol = 1e-5 (float32 rounding of two compilations;
the JAX package holds its own kernel to the same bound)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from madrona_tpu.ops.lidar_pallas import lidar_obb as j_lidar_obb
from madrona_tpu.render.raycast import trace_rays_obb as j_trace
from madrona_tpu_torch.ops.lidar_cuda import lidar_obb
from madrona_tpu_torch.render.raycast import trace_rays_obb

torch.set_num_threads(1)

W, I, A, R = 4, 7, 2, 30
T_MAX = 50.0
TOL = 1e-5


def _scene(rs):
    pos = rs.uniform(-8, 8, (W, I, 3)).astype(np.float32)
    q = rs.randn(W, I, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    half = rs.uniform(0.2, 3.0, (W, I, 3)).astype(np.float32)
    a_pos = rs.uniform(-6, 6, (W, A, 3)).astype(np.float32)
    ang = rs.uniform(0, 2 * np.pi, (W, A, R)).astype(np.float32)
    dirs = np.stack(
        [-np.sin(ang), np.cos(ang), 0.1 * rs.randn(W, A, R)], axis=-1
    ).astype(np.float32)
    mask = np.ones((A, I), bool)
    mask[0, 2] = False
    mask[1, 5] = False
    return pos, q, half, mask, a_pos, dirs


def _port(pos, q, half, mask, a_pos, dirs):
    t = torch.from_numpy
    return lidar_obb(t(pos), t(q), t(half), t(mask), t(a_pos), t(dirs),
                     T_MAX).numpy()


def test_plain_matches_pallas_interpret():
    pos, q, half, mask, a_pos, dirs = _scene(np.random.RandomState(11))
    ref = j_lidar_obb(jnp.asarray(pos), jnp.asarray(q), jnp.asarray(half),
                      mask, jnp.asarray(a_pos), jnp.asarray(dirs), T_MAX,
                      interpret=True)
    got = _port(pos, q, half, mask, a_pos, dirs)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=TOL, atol=TOL)


def test_plain_matches_jax_slab_path():
    pos, q, half, mask, a_pos, dirs = _scene(np.random.RandomState(12))
    origins = np.broadcast_to(a_pos[:, :, None, :], (W, A, R, 3))
    maskj = jnp.asarray(mask)

    def per_world(ip, ir, ih, ow, dw):
        return jax.vmap(
            lambda m, o, d: j_trace(ip, ir, ih, m, o, d, T_MAX)
        )(maskj, ow, dw)

    ref = jax.jit(jax.vmap(per_world))(
        jnp.asarray(pos), jnp.asarray(q), jnp.asarray(half),
        jnp.asarray(origins), jnp.asarray(dirs),
    )
    got = _port(pos, q, half, mask, a_pos, dirs)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=TOL, atol=TOL)
    assert (got < T_MAX).any() and (got == T_MAX).any()


def test_single_trace_matches_jax():
    """trace_rays_obb itself, at the JAX function's own shapes."""
    pos, q, half, mask, a_pos, dirs = _scene(np.random.RandomState(13))
    origins = np.repeat(a_pos[0, :1], R, axis=0)
    got = trace_rays_obb(torch.from_numpy(pos[0]), torch.from_numpy(q[0]),
                         torch.from_numpy(half[0]), torch.from_numpy(mask[0]),
                         torch.from_numpy(origins),
                         torch.from_numpy(dirs[0, 0]), T_MAX)
    ref = j_trace(jnp.asarray(pos[0]), jnp.asarray(q[0]),
                  jnp.asarray(half[0]), jnp.asarray(mask[0]),
                  jnp.asarray(origins), jnp.asarray(dirs[0, 0]), T_MAX)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL,
                               atol=TOL)


def test_inside_box_exit_face():
    """A ray starting inside a box reports the exit face (slab max)."""
    got = lidar_obb(
        torch.zeros((1, 1, 3)), torch.tensor([[[1.0, 0, 0, 0]]]),
        torch.tensor([[[2.0, 3.0, 1.0]]]), torch.ones((1, 1), dtype=bool),
        torch.tensor([[[0.5, 0.0, 0.0]]]), torch.tensor([[[[1.0, 0, 0]]]]),
        T_MAX,
    )
    np.testing.assert_allclose(got.numpy()[0, 0, 0], 1.5, rtol=1e-6)
