"""Threefry RNG of the PyTorch port vs madrona_tpu.utils.rng.

Tolerance: none. Keys, bits and uniforms are bit-exact (the port holds
32-bit words in int64 tensors masked to 32 bits)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madrona_tpu.utils import rng as jrng
from madrona_tpu_torch.utils import rng as trng

torch.set_num_threads(1)

SEEDS = [0, 1, 7, 42, 0xDEADBEEF]
IDX = [0, 1, 2, 1000, 0xFFFFFFFF]


def _np(k):
    return np.asarray(k).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_bitexact(seed):
    np.testing.assert_array_equal(
        trng.key(seed).numpy(), _np(jrng.key(jnp.uint32(seed)))
    )


@pytest.mark.parametrize("idx", IDX)
def test_split_i_bitexact(idx):
    k = trng.key(7)
    got = trng.split_i(k, idx)
    ref = jrng.split_i(jrng.key(7), jnp.uint32(idx))
    np.testing.assert_array_equal(got.numpy(), _np(ref))
    assert int(trng.bits32(got)) == int(jrng.bits32(ref))


def test_random_batch_bitexact():
    rs = np.random.RandomState(0)
    keys = rs.randint(0, 2**32, (64, 2), dtype=np.uint64).astype(np.uint32)
    idx = rs.randint(0, 2**32, (64,), dtype=np.uint64).astype(np.uint32)
    upper = rs.randint(0, 2**32, (64,), dtype=np.uint64).astype(np.uint32)
    got = trng.split_i(torch.from_numpy(keys.astype(np.int64)),
                       torch.from_numpy(idx.astype(np.int64)),
                       torch.from_numpy(upper.astype(np.int64)))
    ref = jrng.split_i(jnp.asarray(keys), jnp.asarray(idx),
                       jnp.asarray(upper))
    np.testing.assert_array_equal(got.numpy(), _np(ref))
    u_got = trng.sample_uniform(got)
    u_ref = jrng.sample_uniform(ref)
    assert u_got.dtype == torch.float32
    np.testing.assert_array_equal(u_got.numpy(), np.asarray(u_ref))


def test_world_key_tree_bitexact():
    """The per-world base keys and a (step, node) split, as the state
    manager and the taskgraph derive them."""
    w = 16
    tk = trng.split_i(trng.key(torch.full((w,), 5, dtype=torch.int64)),
                      torch.arange(w))
    jk = jrng.split_i(jrng.key(jnp.full((w,), 5, jnp.uint32)),
                      jnp.arange(w, dtype=jnp.uint32))
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    t_node = trng.split_i(trng.split_i(tk, 3), 4)
    j_node = jrng.split_i(
        jrng.split_i(jk, jnp.full((w,), 3, jnp.uint32)),
        jnp.full((w,), 4, jnp.uint32),
    )
    np.testing.assert_array_equal(t_node.numpy(), _np(j_node))
    np.testing.assert_array_equal(
        trng.sample_uniform(t_node).numpy(),
        np.asarray(jrng.sample_uniform(j_node)),
    )


def test_bits_to_float01_exact_at_edges():
    bits = np.array([0, 1, 255, 256, 2**31, 2**32 - 1], np.uint32)
    got = trng.bits_to_float01(torch.from_numpy(bits.astype(np.int64)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jrng.bits_to_float01(jnp.asarray(bits)))
    )
