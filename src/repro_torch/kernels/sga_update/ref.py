"""Plain PyTorch version of the fused SGA update (the kernel's oracle).

Port of ``repro/kernels/sga_update/ref.py::sga_update_ref``: Algorithm 1's
small-gradient bank, the SGD step and the Q1.7 round/clip, elementwise.
``lr`` and ``g_th`` broadcast against the operands: scalars for the flat
update, (B, 1) columns for the row-batched one.  ``torch.round`` rounds
half to even like ``jnp.round``.
"""

from __future__ import annotations

import torch


def sga_update_ref(w: torch.Tensor, g: torch.Tensor, accum: torch.Tensor,
                   lr: torch.Tensor, g_th: torch.Tensor,
                   w_scale: float = 1.0 / 128, w_max: float = 127.0 / 128,
                   a_scale: float = 2.0 ** -15):
    """Returns (new_w, new_accum)."""
    small = torch.abs(g) < g_th
    banked = torch.round((accum + torch.where(small, g, 0.0)) / a_scale) \
        * a_scale
    fire = small & (torch.abs(banked) >= g_th)
    g_upd = torch.where(small, torch.where(fire, banked, 0.0), g)
    new_a = torch.where(fire, 0.0, banked)
    new_w = w - lr * g_upd
    new_w = torch.clamp(torch.round(new_w / w_scale) * w_scale,
                        -w_max - w_scale, w_max)
    return new_w, new_a
