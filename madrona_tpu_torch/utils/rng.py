"""Counter-based RNG with Threefry2x32 key splitting.

Port of ``madrona_tpu/utils/rng.py``: bit-exact with it (and with the
reference's ``include/madrona/rand.inl``). Torch's ``uint32`` lacks
most arithmetic, so every 32-bit word is held in an ``int64`` tensor
masked to ``0xFFFFFFFF``: add, xor and rotate are emulated there. A key
is a ``[..., 2]`` int64 tensor whose words lie in ``[0, 2**32)``.
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
