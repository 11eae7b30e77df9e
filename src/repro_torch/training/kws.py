"""Customization drivers for the KWS model (paper §IV-B, §V-C).

Port of the hardware half of ``repro/training/kws.py``: the batched
hardware forward that fills the customization feature buffer
(``hw_features``) and the chip's test-mode bias compensation, both as one
driver (``calibrate_and_compensate``) and as the tick-resumable pieces the
serving sessions run (``calibration_ideal_counts`` +
``compensate_layer_bias``).  The float QAT training loop is not ported yet.

The test mode measures ideal counts + the chip's static offset + fresh SA
read noise, drawn per layer from the calibration split chain
(``calibration_layer_keys``) with ``core.jaxrand``, so the compensated
biases are the reference's.  The feature forward draws fresh noise per
chunk (``sa_noise_std``/``seed``) or evaluates a stream's noise field
(``sa_noise_field``: the offline oracle of a session's captures).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import compensation, imc, jaxrand
from repro_torch.core.sa_noise import SANoiseField
from repro_torch.kernels import resolve_device
from repro_torch.models import kws


def _check_device(hw, device) -> torch.device:
    dev = resolve_device(device)
    if kws.hw_device(hw) != dev:
        raise ValueError(f"parameters are on {kws.hw_device(hw)}, not on "
                         f"{dev}")
    return dev


def hw_features(hw, x, cfg: kws.KWSConfig = kws.PAPER_KWS,
                chip_offsets: Optional[Dict[str, torch.Tensor]] = None,
                sa_noise_std: float = 0.0, seed: int = 0, batch: int = 200,
                use_kernel: bool = False,
                sa_noise_field: Optional[SANoiseField] = None,
                device=None) -> torch.Tensor:
    """GAP features (N, D) of audio windows x (N, sample_len) through the
    hardware path, in chunks of ``batch``: the customization feature
    buffer (§V-C).  SA noise is a fresh draw per chunk
    (``sa_noise_std``, keys split from ``PRNGKey(seed)``) or, with
    ``sa_noise_field``, each example's recorded (stream key, window)
    field, which reproduces a session's captured features bit for bit.
    ``hw`` lives on ``device`` (``None`` means CUDA)."""
    dev = _check_device(hw, device)
    x = kws.as_tensor(x, dev)
    if sa_noise_field is not None:
        if sa_noise_std > 0.0:
            raise ValueError("pass either sa_noise_std or sa_noise_field, "
                             "not both")
        if sa_noise_field.keys.shape[0] != x.shape[0]:
            raise ValueError(
                f"sa_noise_field has {sa_noise_field.keys.shape[0]} rows "
                f"for {x.shape[0]} examples")
        f = sa_noise_field
        return torch.cat([kws.hw_forward(
            hw, x[i:i + batch], cfg, chip_offsets=chip_offsets,
            sa_noise_field=f._replace(keys=f.keys[i:i + batch],
                                      hops=f.hops[i:i + batch]),
            use_kernel=use_kernel, device=dev)[1]
            for i in range(0, x.shape[0], batch)], dim=0)
    outs, key = [], jaxrand.PRNGKey(seed, device=dev)
    for i in range(0, x.shape[0], batch):
        key, sub = jaxrand.split(key)
        outs.append(kws.hw_forward(hw, x[i:i + batch], cfg,
                                   chip_offsets=chip_offsets,
                                   sa_noise_std=sa_noise_std, rng=sub,
                                   use_kernel=use_kernel, device=dev)[1])
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
                          key: Optional[torch.Tensor] = None,
                          sa_noise_std: float = 1.0,
                          macro: imc.IMCMacroConfig = imc.DEFAULT_MACRO,
                          return_est: bool = False):
    """One layer of test-mode compensation: measure ideal + the chip's
    static offset + fresh SA read noise (``sa_noise_std * normal(key,
    counts.shape)``; ``key`` is the layer's slot of
    ``calibration_layer_keys``, and may be None at zero noise), estimate
    the per-channel discrepancy and fold it into the in-memory BN bias.
    ``return_est=True`` also returns the raw per-channel estimate."""
    measured = ideal_counts + chip_offset
    if sa_noise_std > 0.0:
        if key is None:
            raise ValueError("compensate_layer_bias: read noise needs the "
                             "layer's key (calibration_layer_keys)")
        measured = measured + sa_noise_std * jaxrand.normal(
            key.to(ideal_counts.device), tuple(ideal_counts.shape))
    est = compensation.estimate_channel_offsets(ideal_counts, measured)
    new_bias = compensation.compensate_bias(bias_int, est, macro)
    if return_est:
        return new_bias, est
    return new_bias


def calibration_layer_keys(cfg: kws.KWSConfig = kws.PAPER_KWS,
                           seed: int = 0, device=None
                           ) -> Dict[str, torch.Tensor]:
    """The per-layer measurement keys of the calibration split chain,
    shared by ``calibrate_and_compensate`` and the tick-resumable
    sessions so both take identical read-noise samples (``device=None``
    means CUDA)."""
    key = jaxrand.PRNGKey(seed, device=device)
    out = {}
    for name in cfg.imc_layer_names():
        key, sub = jaxrand.split(key)
        out[name] = sub
    return out


def calibrate_and_compensate(hw, xcal,
                             chip_offsets: Dict[str, torch.Tensor],
                             cfg: kws.KWSConfig = kws.PAPER_KWS,
                             macro: imc.IMCMacroConfig = imc.DEFAULT_MACRO,
                             sa_noise_std: float = 1.0, seed: int = 0,
                             sa_noise_field: Optional[SANoiseField] = None,
                             device=None):
    """Paper §IV-B: estimate per-channel MAV offsets through the chip's
    test mode (layer-local, matched inputs: ideal counts + static offset
    + fresh read noise from ``calibration_layer_keys(cfg, seed)``) and fold
    the compensation into the in-memory BN biases.  It runs
    ``calibration_ideal_counts`` + ``compensate_layer_bias``, the pieces
    the serving sessions run one layer per tick.  ``sa_noise_field`` does
    not touch the measurement (the test mode digitizes pre-SA counts); it
    is only checked against ``xcal``, as the reference does, so an offline
    oracle can thread one field through calibration and features.
    Returns the same kind of parameters as ``hw`` (packed parameters are
    re-packed)."""
    if sa_noise_field is not None \
            and sa_noise_field.keys.shape[0] != len(xcal):
        raise ValueError(
            f"sa_noise_field has {sa_noise_field.keys.shape[0]} rows for "
            f"{len(xcal)} calibration utterances")
    dev = _check_device(hw, device)
    hwp, packed = kws.as_hw_params(hw)
    ideal_log = calibration_ideal_counts(hwp, xcal, cfg, device=dev)
    keys = calibration_layer_keys(cfg, seed, device=dev)
    new_bias = dict(hwp.bias)
    for name in cfg.imc_layer_names():
        new_bias[name] = compensate_layer_bias(
            hwp.bias[name], ideal_log[name],
            kws.as_tensor(chip_offsets[name], dev), keys[name],
            sa_noise_std, macro)
    out = hwp._replace(bias=new_bias)
    return kws.pack_hw_params(out, cfg) if packed is not None else out
