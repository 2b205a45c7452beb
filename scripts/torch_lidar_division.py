#!/usr/bin/env python3
"""The lidar kernel's in-range division against IEEE division, on the card.

    python3 scripts/torch_lidar_division.py [--n N]

Where a box and a ray lie in range (``csrc/lidar.cu``, ``box_in_range``),
the lidar kernel divides by nvcc's own Newton steps without their range
checks. This script runs the ``lidar_division_check`` entry of that
source on N operand sets over the kernel's range (default 2^24): each
gives x / y and its guarded reciprocal by both paths, and the guarded
reciprocals must be equal bit for bit, and the quotients too wherever
the guard accepts them. Prints the card's name and power limit first and
exits 1 on a difference. chip_smoke.py runs the same check through
:func:`operands`, :func:`check` and :func:`mismatches`;
tests/test_torch_kernels_cpu_build.py runs it on the source's g++ build.

Needs CUDA and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from madrona_tpu_torch.ops.cuda_build import (  # noqa: E402
    check_tensor, entry, stream_ptr,
)

ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]


def check(x, y, fn=None):
    """[N, 4] of the kernel's two division paths: (x / y and its guarded
    reciprocal by the in-range path, the same by IEEE division), for x, y
    float32 [N] tensors on the entry's device. ``fn``: the
    ``lidar_division_check`` entry (default: the card's build)."""
    n = x.numel()
    for name, t in (("x", x), ("y", y)):
        check_tensor(t, name, torch.float32, (n,))
    out = torch.empty((n, 4), dtype=torch.float32, device=x.device)
    if fn is None:
        fn = entry("lidar.cu", "lidar_division_check", ARGTYPES)
    err = fn(x.data_ptr(), y.data_ptr(), out.data_ptr(), n, stream_ptr())
    if err:
        raise RuntimeError(f"lidar_division_check: CUDA error {err}")
    return out


def operands(rs, n, device):
    """x, y of :func:`check` over the kernel's range, either sign: y
    log-uniform in [2^-8, 2^40]; x log-uniform in [2^-60, 2^37], zero in
    1 of 16, subnormal in 1 of 16, and in 1 of 8 within a factor of 2 of
    1e-12 * y (around the reciprocal's guard)."""
    def sign():
        return np.where(rs.rand(n) < 0.5, -1.0, 1.0)

    y = np.exp2(rs.uniform(-8, 40, n))
    x = sign() * np.exp2(rs.uniform(-60, 37, n))
    kind = rs.randint(0, 16, n)
    x[kind == 0] = 0.0 * sign()[kind == 0]
    x[kind == 1] = (sign() * np.exp2(rs.uniform(-149, -126, n)))[kind == 1]
    guard = kind >= 14
    x[guard] = (sign() * 1e-12 * y * np.exp2(rs.uniform(-1, 1, n)))[guard]
    return tuple(torch.from_numpy(np.ascontiguousarray(v, np.float32))
                 .to(device) for v in (x, y))


def mismatches(out):
    """(guarded reciprocals whose bits differ, accepted quotients whose
    bits differ) of :func:`check`'s output."""
    bits = out.view(torch.int32)
    accepted = out[:, 2].abs() > 1e-12
    return (int((bits[:, 1] != bits[:, 3]).sum()),
            int(((bits[:, 0] != bits[:, 2]) & accepted).sum()))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 24,
                    help="operand sets (default 2^24)")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_lidar_division: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as cs

    print(cs.card_line())
    x, y = operands(np.random.RandomState(12), opts.n, "cuda")
    off = mismatches(check(x, y))
    print(f"lidar divisions: {opts.n} operand sets, guarded reciprocals "
          f"differing {off[0]}, accepted quotients differing {off[1]}")
    return 0 if off == (0, 0) else 1


if __name__ == "__main__":
    sys.exit(main())
