"""Bias compensation for IMC non-ideal effects (paper §IV-B).

Port of ``repro/core/compensation.py``: run calibration inputs through the
macro in test mode, compare the pre-SA counts against the ideal ones, and
fold the per-channel mean discrepancy, rounded onto the word-line bias
parity grid, into the mapped in-memory BN bias.  ``calibrate_layerwise``
runs the estimate over a caller's per-layer count measurement.
"""

from __future__ import annotations

from typing import Callable, Dict

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


def calibrate_layerwise(
        layer_counts_fn: Callable[[bool], Dict[str, torch.Tensor]],
        calib_inputs_present: bool = True) -> Dict[str, torch.Tensor]:
    """Generic calibration: per-layer, per-channel offset estimates
    {layer: (C,)}.  ``layer_counts_fn`` returns {layer: pre-SA counts} of
    the calibration batch; it is called first with ``True`` (the chip's
    noisy measurement) and then with ``False`` (the ideal one), as the
    reference calls it, and each layer's estimate is taken with matched
    inputs (the chip's test mode drives each macro with known patterns
    rather than chaining noisy layers).  ``calib_inputs_present`` is
    accepted for the reference's signature and unused, as there."""
    noisy = layer_counts_fn(True)
    ideal = layer_counts_fn(False)
    return {name: estimate_channel_offsets(ideal[name], noisy[name])
            for name in ideal}
