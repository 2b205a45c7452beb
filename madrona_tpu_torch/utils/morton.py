"""Morton (Z-order) codes: spatial sort keys.

Port of ``madrona_tpu/utils/morton.py``: the vectorised 30-bit 3D encode
that the TLAS build (``render/tlas.py``) sorts instances by. The codes
are uint32 values; the port holds them in int64 tensors (torch's uint32
lacks shifts and masks), so they sort and compare as the unsigned codes
do.
"""

from __future__ import annotations

import torch


def _expand_bits10(v):
    """Spread the low 10 bits of v so there are 2 zero bits between each
    (the standard LBVH bit-twiddle)."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton3d(pos, lo, hi):
    """30-bit 3D Morton code of points normalised into [lo, hi].

    pos [..., 3] float32; lo/hi [3] scene bounds (sequences or tensors).
    Returns [...] int64 holding the uint32 codes."""
    lo = torch.as_tensor(lo, dtype=torch.float32, device=pos.device)
    hi = torch.as_tensor(hi, dtype=torch.float32, device=pos.device)
    n = torch.clamp((pos - lo) / torch.clamp(hi - lo, min=1e-12), 0.0, 1.0)
    q = torch.clamp(n * 1024.0, max=1023.0).to(torch.int64)
    x = _expand_bits10(q[..., 0])
    y = _expand_bits10(q[..., 1])
    z = _expand_bits10(q[..., 2])
    return (x << 2) | (y << 1) | z
