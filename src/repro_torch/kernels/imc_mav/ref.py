"""Plain PyTorch versions of the IMC kernels (the kernels' oracles).

Port of ``repro/kernels/imc_mav/ref.py``: ``imc_mav_ref`` is one ±1
product tile with the SA epilogue (K5); ``fused_conv_mav_ref`` the whole
layer through the model's count-exact primitives (conv counts -> mav_sa
-> shuffle -> OR-pool, K1).  The noise operand is explicit in both: the
kernels draw nothing.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import imc
from repro_torch.core.binary import channel_shuffle, or_maxpool


def imc_mav_ref(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                flip: torch.Tensor,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sign(((x @ w + bias) [+ noise]) * flip) for x (M, K), w (K, N) ±1
    (float32 or bfloat16), bias/flip (N,), noise (M, N) float32; the
    output has x's dtype.  The float32 product is exact for ±1 operands
    (TF32 or not: ±1 is exact in TF32, every partial sum a small
    integer)."""
    counts = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    pre = counts + bias
    if noise is not None:
        pre = pre + noise
    pre = pre * flip
    return torch.where(pre >= 0, 1.0, -1.0).to(x.dtype)


def fused_conv_mav_ref(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       flip: torch.Tensor, groups: int, stride: int = 1,
                       pool: int = 1,
                       chip_offset: Optional[torch.Tensor] = None,
                       sa_noise: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """x (B, T, C_in) ±1; w (K, C_in // groups, C_out) ±1; bias, flip,
    chip_offset (C_out,); sa_noise (B, T_out, C_out).  Returns
    (B, T_out // pool, C_out) ±1 in post-shuffle channel order."""
    counts = imc.binary_group_conv_counts(x, w, groups=groups, stride=stride)
    if chip_offset is not None:
        counts = counts + chip_offset
    h = imc.mav_sa(counts, bias, flip, sa_noise=sa_noise)
    h = channel_shuffle(h, groups)
    if pool > 1:
        h = or_maxpool(h, pool, axis=1)
    return h
