"""Threefry RNG of the PyTorch port vs madrona_tpu.utils.rng.

Tolerance: none. Keys, bits, uniforms and the samplers are bit-exact
(the port holds 32-bit words in int64 tensors masked to 32 bits). The
samplers (sample_2x_uniform, sample_bool, sample_i32 with its 4 Lemire
retries, sample_i32_biased without its offset) and the stateful RNG are
held against the JAX package and against a NumPy derivation here, on
tests/np_rng.py's keys, that multiplies in uint64 (no 16-bit limbs) and
counts bits with Python's bin(). The spans include ones that are not
powers of two and ones that force Lemire retries (2**31 + 1, 3 * 2**30),
an empty span and a reversed one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import np_rng
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


# (a, b) of the samplers' spans: small and odd, power of two, 2**31 + 1
# and 3 * 2**30 (rejection odds 1/2 and 1/4 a round: retries taken),
# near 2**32, empty, reversed
SPANS = [(0, 6), (-5, 7), (0, 1 << 20), (-(1 << 30) - 1, 1 << 30),
         (-(1 << 31), 1 << 30), (-(1 << 31), (1 << 31) - 2), (3, 3),
         (10, 3)]


def _np_i32(x):
    return (np.asarray(x, np.int64) & 0xFFFFFFFF).astype(np.uint32).view(
        np.int32)


def _np_span(a, b):
    return (np.asarray(b, np.int64) - np.asarray(a, np.int64)) & 0xFFFFFFFF


def np_sample_i32(k, a, b, retries=4):
    """Lemire's rejection in uint64 arithmetic (and the number of draws
    still rejected after each round)."""
    s = np.broadcast_to(_np_span(a, b).astype(np.uint64), k.shape[:-1])
    x = np_rng.bits32(k).astype(np.uint64)
    m = x * s
    lo, hi = m & np.uint64(0xFFFFFFFF), m >> np.uint64(32)
    safe = np.where(s == 0, 1, s).astype(np.uint64)
    t = np.where(s == 0, 0, (np.uint64(1 << 32) - s) % safe)
    rejected = []
    for _ in range(retries):
        reject = lo < t
        rejected.append(int(reject.sum()))
        k = np.where(reject[..., None],
                     np_rng.split_i(k, np.zeros(k.shape[:-1], np.uint32)), k)
        m = np_rng.bits32(k).astype(np.uint64) * s
        lo = np.where(reject, m & np.uint64(0xFFFFFFFF), lo)
        hi = np.where(reject, m >> np.uint64(32), hi)
    return _np_i32(hi.astype(np.int64) + np.asarray(a, np.int64)), rejected


def np_sample_i32_biased(k, a, b):
    m = np_rng.bits32(k).astype(np.uint64) * _np_span(a, b).astype(np.uint64)
    return _np_i32((m >> np.uint64(32)).astype(np.int64))


def np_sample_bool(k):
    bits = np_rng.bits32(k)
    return np.array([bin(int(v)).count("1") % 2 == 0 for v in bits.ravel()]
                    ).reshape(bits.shape)


def _keys(n, seed=3):
    rs = np.random.RandomState(seed)
    return rs.randint(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32)


def test_sample_2x_uniform_and_bool_bitexact():
    keys = _keys(4096)
    tk = torch.from_numpy(keys.astype(np.int64))
    u0, u1 = trng.sample_2x_uniform(tk)
    j0, j1 = jrng.sample_2x_uniform(jnp.asarray(keys))
    for got, ref, word in ((u0, j0, 0), (u1, j1, 1)):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(
            got.numpy(), np_rng.uniform(np.stack(
                [keys[:, word], np.zeros(len(keys), np.uint32)], -1)))
    b = trng.sample_bool(tk)
    assert b.dtype == torch.bool
    np.testing.assert_array_equal(b.numpy(),
                                  np.asarray(jrng.sample_bool(jnp.asarray(keys))))
    np.testing.assert_array_equal(b.numpy(), np_sample_bool(keys))
    assert 0.45 < b.numpy().mean() < 0.55


@pytest.mark.parametrize("a,b", SPANS)
def test_sample_i32_bitexact(a, b):
    keys = _keys(4096, seed=abs(a) % 97 + b % 89)
    tk = torch.from_numpy(keys.astype(np.int64))
    got = trng.sample_i32(tk, a, b)
    ref = np.asarray(jrng.sample_i32(jnp.asarray(keys), a, b))
    oracle, rejected = np_sample_i32(keys, a, b)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), oracle)
    span = (b - a) & 0xFFFFFFFF
    t = ((1 << 32) - span) % span if span else 0   # the rejection bound
    if t > 1 << 29:                 # odds of 1/8 or more a round
        assert rejected[0] > 100 and rejected[-1] > 0, rejected
    elif t == 0:                    # a power of two, or empty
        assert rejected == [0, 0, 0, 0]
    if 0 < b - a:
        assert ((got.numpy() >= a) & (got.numpy() < b)).all()
    biased = trng.sample_i32_biased(tk, a, b)
    assert biased.dtype == torch.int32
    np.testing.assert_array_equal(
        biased.numpy(),
        np.asarray(jrng.sample_i32_biased(jnp.asarray(keys), a, b)))
    np.testing.assert_array_equal(biased.numpy(),
                                  np_sample_i32_biased(keys, a, b))


def test_sample_i32_per_element_bounds_and_missing_offset():
    """Bounds that differ a key; sample_i32_biased keeps the reference's
    missing ``+ a``: its draws lie in [0, b - a), not [a, b)."""
    keys = _keys(2048, seed=5)
    rs = np.random.RandomState(1)
    a = rs.randint(-1000, 1000, len(keys)).astype(np.int32)
    b = (a + rs.randint(1, 5000, len(keys))).astype(np.int32)
    tk = torch.from_numpy(keys.astype(np.int64))
    got = trng.sample_i32(tk, torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jrng.sample_i32(jnp.asarray(keys),
                                                jnp.asarray(a),
                                                jnp.asarray(b))))
    np.testing.assert_array_equal(got.numpy(), np_sample_i32(keys, a, b)[0])
    assert ((got.numpy() >= a) & (got.numpy() < b)).all()
    biased = trng.sample_i32_biased(tk, 5, 11).numpy()
    np.testing.assert_array_equal(
        biased, np.asarray(jrng.sample_i32_biased(jnp.asarray(keys), 5, 11)))
    assert biased.min() == 0 and biased.max() == 5


@pytest.mark.parametrize("seed", [7, "batch"])
def test_rng_class_bitexact(seed):
    """The stateful RNG's sample sequence: the same draws and key
    schedule (split_i(base, count)) as the JAX package's RNG."""
    if seed == "batch":
        keys = _keys(64, seed=9)
        t, j = trng.RNG(torch.from_numpy(keys.astype(np.int64))), \
            jrng.RNG(jnp.asarray(keys))
        base = keys
    else:
        t, j = trng.RNG(seed), jrng.RNG(seed)
        base = np_rng.key(np.uint32(seed))
    calls = [("rand_key", ()), ("sample_uniform", ()), ("sample_bool", ()),
             ("sample_i32", (-(1 << 30) - 1, 1 << 30)),
             ("sample_i32_biased", (3, 17)), ("sample_uniform", ()),
             ("sample_i32", (0, 6))]
    for count, (name, args) in enumerate(calls):
        got = getattr(t, name)(*args).numpy()
        ref = np.asarray(getattr(j, name)(*args))
        if name == "rand_key":
            ref = ref.astype(np.int64)
        np.testing.assert_array_equal(got, ref, err_msg=name)
        k = np_rng.split_i(base, np.full(base.shape[:-1], count, np.uint32))
        oracle = {
            "rand_key": lambda: k.astype(np.int64),
            "sample_uniform": lambda: np_rng.uniform(k),
            "sample_bool": lambda: np_sample_bool(k),
            "sample_i32": lambda: np_sample_i32(k, *args)[0],
            "sample_i32_biased": lambda: np_sample_i32_biased(k, *args),
        }[name]()
        np.testing.assert_array_equal(got, oracle, err_msg=name)
