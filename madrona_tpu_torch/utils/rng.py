"""Counter-based RNG with Threefry2x32 key splitting.

Port of ``madrona_tpu/utils/rng.py``: bit-exact with it (and with the
reference's ``include/madrona/rand.inl``). Torch's ``uint32`` lacks
most arithmetic, so every 32-bit word is held in an ``int64`` tensor
masked to ``0xFFFFFFFF``: add, xor and rotate are emulated there. A key
is a ``[..., 2]`` int64 tensor whose words lie in ``[0, 2**32)``.

The samplers (``sample_2x_uniform``, ``sample_bool``, ``sample_i32``
with its 4 Lemire retries, ``sample_i32_biased``) and the stateful
``RNG`` give the JAX package's bits; products of two words go through
16-bit limbs, since ``x * s`` of two words overflows int64.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

# Rotation distances specified by the Threefry2x32 algorithm.
_ROTATIONS = (13, 15, 26, 6, 17, 29, 16, 24)
# Parity constant specified by the Threefry2x32 algorithm.
_PARITY = 0x1BD11BDA


def _u32(x, device=None):
    """Python int / array-like / tensor -> int64 tensor of 32-bit words."""
    if not torch.is_tensor(x):
        x = torch.as_tensor(x, dtype=torch.int64, device=device)
    return x.to(torch.int64) & MASK32


def key(seed, seed_upper=0, device=None):
    """RandKey [..., 2] from 32-bit seeds: ``split_i((seed, upper), 0)``."""
    seed = _u32(seed, device)
    upper = torch.broadcast_to(_u32(seed_upper, seed.device), seed.shape)
    raw = torch.stack([seed, upper], dim=-1)
    return split_i(raw, torch.zeros_like(seed))


def _rotl(v, d):
    return ((v << d) | (v >> (32 - d))) & MASK32


def split_i(k, idx, idx_upper=0):
    """Threefry2x32 (20 rounds): child key of ``k`` [..., 2] at ``idx``.

    ``idx``/``idx_upper`` broadcast against ``k[..., 0]``."""
    k = _u32(k)
    ks0 = k[..., 0]
    ks1 = k[..., 1]
    ks2 = _PARITY ^ ks0 ^ ks1
    idx = _u32(idx, k.device)
    shape = torch.broadcast_shapes(ks0.shape, idx.shape)
    ks0, ks1, ks2 = (torch.broadcast_to(t, shape) for t in (ks0, ks1, ks2))
    x0 = (torch.broadcast_to(idx, shape) + ks0) & MASK32
    x1 = (torch.broadcast_to(_u32(idx_upper, k.device), shape) + ks1) & MASK32

    def rounds(x0, x1, rots):
        for r in rots:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        return x0, x1

    x0, x1 = rounds(x0, x1, _ROTATIONS[:4])
    x0, x1 = (x0 + ks1) & MASK32, (x1 + ks2 + 1) & MASK32
    x0, x1 = rounds(x0, x1, _ROTATIONS[4:])
    x0, x1 = (x0 + ks2) & MASK32, (x1 + ks0 + 2) & MASK32
    x0, x1 = rounds(x0, x1, _ROTATIONS[:4])
    x0, x1 = (x0 + ks0) & MASK32, (x1 + ks1 + 3) & MASK32
    x0, x1 = rounds(x0, x1, _ROTATIONS[4:])
    x0, x1 = (x0 + ks1) & MASK32, (x1 + ks2 + 4) & MASK32
    x0, x1 = rounds(x0, x1, _ROTATIONS[:4])
    out0 = (x0 + ks2) & MASK32
    out1 = (x1 + ks0 + 5) & MASK32
    return torch.stack([out0, out1], dim=-1)


def bits32(k):
    """32 random bits from a key (a ^ b)."""
    k = _u32(k)
    return k[..., 0] ^ k[..., 1]


def bits_to_float01(rand_bits):
    """[0, 1) float32 from 32 bits: top 24 bits times 2^-24 (exact)."""
    return (_u32(rand_bits) >> 8).to(torch.float32) * (2.0 ** -24)


def sample_uniform(k):
    """Uniform float32 in [0, 1)."""
    return bits_to_float01(bits32(k))


def _to_i32(x):
    """int64 tensor -> int32 with the wrap of a 32-bit cast."""
    return (((x & MASK32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _span(a, b, device):
    """(b - a) as an unsigned 32-bit word: int32 subtraction, wrapped."""
    return (_u32(b, device) - _u32(a, device)) & MASK32


def sample_2x_uniform(k):
    """Two float32 uniforms in [0, 1) from one key: (float01(a),
    float01(b))."""
    k = _u32(k)
    return bits_to_float01(k[..., 0]), bits_to_float01(k[..., 1])


def sample_bool(k):
    """Boolean from the parity of the key's bit count (True if even).
    Torch has no population count: the bits are summed by halves."""
    x = bits32(k)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    num_set = ((x * 0x01010101) & MASK32) >> 24
    return (num_set & 1) == 0


def _u32_mulhi(x, y):
    """High 32 bits of a 32 x 32 multiply, through 16-bit limbs (as the
    JAX package computes it; every partial product fits 32 bits)."""
    x, y = _u32(x), _u32(y, x.device)
    xl, xh = x & 0xFFFF, x >> 16
    yl, yh = y & 0xFFFF, y >> 16
    lo = xl * yl
    t = xh * yl + (lo >> 16)
    t2 = xl * yh + (t & 0xFFFF)
    return (xh * yh + (t >> 16) + (t2 >> 16)) & MASK32


def _u32_mullo(x, y):
    """Low 32 bits of a 32 x 32 multiply, without an int64 overflow."""
    xl, xh = x & 0xFFFF, x >> 16
    yl, yh = y & 0xFFFF, y >> 16
    return (xl * yl + (((xh * yl + xl * yh) & 0xFFFF) << 16)) & MASK32


def sample_i32_biased(k, a, b):
    """Integer in [0, b - a) as int32: mulhi(bits, b - a), slightly biased.

    The offset ``a`` is NOT added: the reference's sampleI32Biased omits
    it (its sibling sampleI32 adds it), and the JAX package reproduces
    that. Use :func:`sample_i32` for a true [a, b) sample."""
    x = bits32(k)
    return _to_i32(_u32_mulhi(x, _span(a, b, x.device)))


_MAX_LEMIRE_RETRIES = 4


def sample_i32(k, a, b):
    """Unbiased int32 in [a, b): Lemire's rejection with a fixed depth of
    4 retries, each retry drawing from ``split_i(k, 0)`` of the rejected
    key."""
    k = _u32(k)
    s = _span(a, b, k.device)
    shape = torch.broadcast_shapes(k.shape[:-1], s.shape)
    k = torch.broadcast_to(k, shape + (2,))
    s = torch.broadcast_to(s, shape)
    x = bits32(k)
    l = _u32_mullo(x, s)
    h = _u32_mulhi(x, s)
    # (0 - s) % s in u32; XLA's remainder by zero is the dividend, 0
    t = torch.where(s == 0, 0, ((-s) & MASK32) % torch.clamp(s, min=1))
    for _ in range(_MAX_LEMIRE_RETRIES):
        reject = l < t
        k = torch.where(reject[..., None], split_i(k, torch.zeros_like(l)), k)
        x = bits32(k)
        l = torch.where(reject, _u32_mullo(x, s), l)
        h = torch.where(reject, _u32_mulhi(x, s), h)
    return _to_i32(h + _u32(a, k.device))


class RNG:
    """Stateful counter RNG: each sample derives ``split_i(base_key,
    count)`` and advances the count (the reference's ``RNG::advance``).
    ``k`` is a key [..., 2] or an int seed."""

    def __init__(self, k, device=None):
        if isinstance(k, int):
            k = key(k, device=device)
        self._k = _u32(k, device)
        self._count = 0

    def _advance(self):
        sample_k = split_i(self._k, torch.full(
            self._k.shape[:-1], self._count, dtype=torch.int64,
            device=self._k.device))
        self._count += 1
        return sample_k

    def rand_key(self):
        return self._advance()

    def sample_uniform(self):
        return sample_uniform(self._advance())

    def sample_bool(self):
        return sample_bool(self._advance())

    def sample_i32(self, a, b):
        return sample_i32(self._advance(), a, b)

    def sample_i32_biased(self, a, b):
        return sample_i32_biased(self._advance(), a, b)
