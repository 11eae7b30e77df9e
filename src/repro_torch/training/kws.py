"""Customization drivers for the KWS model (paper §IV-B, §V-C).

Port of the hardware half of ``repro/training/kws.py``: the batched
hardware forward that fills the customization feature buffer
(``hw_features``) and the chip's test-mode bias compensation, both as one
driver (``calibrate_and_compensate``) and as the tick-resumable pieces the
serving sessions run (``calibration_ideal_counts`` +
``compensate_layer_bias``).  The float QAT training loop is not ported yet.

The test mode measures ideal counts + the chip's static offset + fresh SA
read noise.  Read noise needs the jax-compatible PRNG, still to port, so
every path here runs at ``sa_noise_std=0`` and asking for noise raises.
At zero noise the reference computes ``ideal + off + 0.0 * normal``, which
equals ``ideal + off`` bit for bit, so the noise-free compensation is the
reference's exactly.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import compensation, imc
from repro_torch.kernels import resolve_device
from repro_torch.models import kws

_NOISE_TODO = ("needs the jax-compatible PRNG still to port (ROADMAP.md, "
               "queue 1, item 1)")


def _check_device(hw, device) -> torch.device:
    dev = resolve_device(device)
    if kws.hw_device(hw) != dev:
        raise ValueError(f"parameters are on {kws.hw_device(hw)}, not on "
                         f"{dev}")
    return dev


def hw_features(hw, x, cfg: kws.KWSConfig = kws.PAPER_KWS,
                chip_offsets: Optional[Dict[str, torch.Tensor]] = None,
                sa_noise_std: float = 0.0, batch: int = 200,
                use_kernel: bool = False, device=None) -> torch.Tensor:
    """GAP features (N, D) of audio windows x (N, sample_len) through the
    hardware path, in chunks of ``batch``: the customization feature
    buffer (§V-C).  ``hw`` lives on ``device`` (``None`` means CUDA)."""
    if sa_noise_std > 0.0:
        raise NotImplementedError(
            f"hw_features(sa_noise_std > 0): SA noise {_NOISE_TODO}")
    dev = _check_device(hw, device)
    x = kws.as_tensor(x, dev)
    outs = [kws.hw_forward(hw, x[i:i + batch], cfg,
                           chip_offsets=chip_offsets, use_kernel=use_kernel,
                           device=dev)[1]
            for i in range(0, x.shape[0], batch)]
    return torch.cat(outs, dim=0)


def calibration_ideal_counts(hw, xcal, cfg: kws.KWSConfig = kws.PAPER_KWS,
                             device=None) -> Dict[str, torch.Tensor]:
    """The test-mode reference measurement: each IMC layer's ideal
    (noise-free, offset-free) pre-SA counts of the calibration windows,
    {conv_i: (N, t_conv, C_i)}.  One forward of the unfused path (the
    kernel never materializes counts)."""
    dev = _check_device(hw, device)
    hwp, _ = kws.as_hw_params(hw)
    _, _, log = kws.hw_forward(hwp, kws.as_tensor(xcal, dev), cfg,
                               chip_offsets=None, collect_counts=True,
                               device=dev)
    return log


def compensate_layer_bias(bias_int: torch.Tensor,
                          ideal_counts: torch.Tensor,
                          chip_offset: torch.Tensor,
                          sa_noise_std: float = 1.0,
                          macro: imc.IMCMacroConfig = imc.DEFAULT_MACRO,
                          return_est: bool = False):
    """One layer of test-mode compensation: measure ideal + the chip's
    static offset, estimate the per-channel discrepancy and fold it into
    the in-memory BN bias.  The reference also takes the layer's PRNG key
    for the read noise; ``sa_noise_std`` must be 0 here, so there is none.
    ``return_est=True`` also returns the raw per-channel estimate."""
    if sa_noise_std > 0.0:
        raise NotImplementedError(
            f"compensate_layer_bias(sa_noise_std={sa_noise_std}): the "
            f"calibration read noise {_NOISE_TODO}; pass sa_noise_std=0.0")
    measured = ideal_counts + chip_offset
    est = compensation.estimate_channel_offsets(ideal_counts, measured)
    new_bias = compensation.compensate_bias(bias_int, est, macro)
    if return_est:
        return new_bias, est
    return new_bias


def calibrate_and_compensate(hw, xcal,
                             chip_offsets: Dict[str, torch.Tensor],
                             cfg: kws.KWSConfig = kws.PAPER_KWS,
                             macro: imc.IMCMacroConfig = imc.DEFAULT_MACRO,
                             sa_noise_std: float = 1.0, device=None):
    """Paper §IV-B: estimate per-channel MAV offsets through the chip's
    test mode (layer-local, matched inputs) and fold the compensation into
    the in-memory BN biases.  Driver over ``calibration_ideal_counts`` +
    ``compensate_layer_bias``, the pieces the serving sessions run one
    layer per tick.  Returns the same kind of parameters as ``hw``
    (packed parameters are re-packed).  ``sa_noise_std`` must be 0."""
    if sa_noise_std > 0.0:
        raise NotImplementedError(
            f"calibrate_and_compensate(sa_noise_std={sa_noise_std}): the "
            f"calibration read noise {_NOISE_TODO}; pass sa_noise_std=0.0")
    dev = _check_device(hw, device)
    hwp, packed = kws.as_hw_params(hw)
    ideal_log = calibration_ideal_counts(hwp, xcal, cfg, device=dev)
    new_bias = dict(hwp.bias)
    for name in cfg.imc_layer_names():
        new_bias[name] = compensate_layer_bias(
            hwp.bias[name], ideal_log[name],
            kws.as_tensor(chip_offsets[name], dev), sa_noise_std, macro)
    out = hwp._replace(bias=new_bias)
    return kws.pack_hw_params(out, cfg) if packed is not None else out
