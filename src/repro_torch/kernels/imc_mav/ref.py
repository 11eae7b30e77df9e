"""Plain PyTorch version of the fused IMC layer (the kernel's oracle).

Port of ``repro/kernels/imc_mav/ref.py::fused_conv_mav_ref``: the whole
layer through the model's count-exact primitives (conv counts -> mav_sa
-> shuffle -> OR-pool).  The noise operand is explicit here; the port has
no in-kernel noise draw.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import imc
from repro_torch.core.binary import channel_shuffle, or_maxpool


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
