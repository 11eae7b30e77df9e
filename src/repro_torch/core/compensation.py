"""Bias compensation for IMC non-ideal effects (paper §IV-B).

Port of ``repro/core/compensation.py``: run calibration inputs through the
macro in test mode, compare the pre-SA counts against the ideal ones, and
fold the per-channel mean discrepancy, rounded onto the word-line bias
parity grid, into the mapped in-memory BN bias.
"""

from __future__ import annotations

import torch

from repro_torch.core import imc, means


def estimate_channel_offsets(ideal_counts: torch.Tensor,
                             noisy_counts: torch.Tensor) -> torch.Tensor:
    """Mean per-channel discrepancy; channels on the last axis.  The mean
    is ``jnp.mean``'s as compiled, the sum times the float32 reciprocal of
    the count (``core.means``)."""
    diff = noisy_counts - ideal_counts
    return means.mean(diff.reshape(-1, diff.shape[-1]), 0)


def compensate_bias(bias_int: torch.Tensor, offset_estimate: torch.Tensor,
                    macro: imc.IMCMacroConfig = imc.DEFAULT_MACRO
                    ) -> torch.Tensor:
    """Fold -offset into the mapped bias, respecting parity + range."""
    comp = imc.map_bias(-offset_estimate, method="best", macro=macro)
    return torch.clamp(bias_int + comp, -macro.bias_range, macro.bias_range)
