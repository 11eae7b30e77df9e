"""Plain PyTorch version of the int8 matmul kernel (its oracle).

Port of ``repro/kernels/int8_matmul/ref.py``.  The reference computes in
int32 with XLA's wrapping adds; torch has no int32 matmul on CUDA, so the
product is taken in float64 (exact while |x @ w| < 2**53, far beyond any
int8 fan-in this model meets), and each int32 add is done in int64 and
wrapped back to int32 as XLA's add wraps.
"""

from __future__ import annotations

import torch


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """Two's-complement wrap of int64 values into the int32 range."""
    return ((v + 2 ** 31) & 0xFFFFFFFF) - 2 ** 31


def int8_matmul_ref(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    shift: int = 7, out_max: int = 127) -> torch.Tensor:
    """clip(((x @ w + bias) + 2**(shift-1)) >> shift, -out_max-1, out_max)
    as int8, for x (M, K) int8, w (K, N) int8, bias (N,) int32; no
    rounding term when ``shift`` is 0."""
    acc = torch.matmul(x.to(torch.float64), w.to(torch.float64))
    acc = _wrap32(acc.to(torch.int64) + bias.to(torch.int64))
    if shift > 0:
        acc = _wrap32(acc + (1 << (shift - 1))) >> shift
    return torch.clamp(acc, -out_max - 1, out_max).to(torch.int8)
