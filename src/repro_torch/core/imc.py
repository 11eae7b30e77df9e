"""Count-exact functional model of the SRAM IMC macro (paper §IV).

Port of ``repro/core/imc.py`` (less the TPU tile packing): in-memory BN
folding onto the word-line bias grid, the chip's static MAV offsets, the
MAV + sense-amplifier epilogue (with the SA read noise drawn here or
given), the grouped ±1 convolution counts (also the float path's
convolution, differentiated by autograd), and the macro allocation of a
layer (``map_layer_to_macros``).  Everything is expressed in the
array's integer count domain, so the model is exact; the noise comes from
``core.jaxrand``, so a key draws the reference's numbers.

The float-add order of ``mav_sa`` is the reference's: counts, then bias,
then offset, then noise, then × flip.  The fused kernel
(``repro_torch.kernels.imc_mav``) follows the same order, which is what
keeps it bit-identical to this model.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import jaxrand
from repro_torch.core.binary import binarize


@dataclasses.dataclass(frozen=True)
class IMCMacroConfig:
    rows: int = 64                 # word lines per bank
    cols: int = 64                 # bit lines per bank
    banks_per_macro: int = 8       # one bank computes one output channel
    bias_rows: int = 1             # word lines reserved for in-memory BN

    @property
    def bias_range(self) -> int:
        """|bias| <= cols (one word line of ±1 cells)."""
        return self.cols

    @property
    def bias_parity_even(self) -> bool:
        """The sum of an even number of ±1 cells is even."""
        return self.cols % 2 == 0


DEFAULT_MACRO = IMCMacroConfig()


@dataclasses.dataclass(frozen=True)
class IMCNoiseParams:
    """Noise magnitudes in array-count units (1 count = one ±1 product)."""

    mav_offset_std: float = 4.0    # static per-channel MAV mismatch
    sa_noise_std: float = 1.0      # per-evaluation SA comparator noise

    def none(self) -> "IMCNoiseParams":
        return IMCNoiseParams(0.0, 0.0)


def sample_chip_offsets(key: torch.Tensor, channels_per_layer: Dict[str, int],
                        noise: IMCNoiseParams) -> Dict[str, torch.Tensor]:
    """The static MAV offsets of one fabricated chip, one per output
    channel per IMC layer, on the key's device: a split chain over the
    sorted layer names, as the reference draws them."""
    offsets = {}
    for name, c in sorted(channels_per_layer.items()):
        key, sub = jaxrand.split(key)
        offsets[name] = noise.mav_offset_std * jaxrand.normal(sub, (c,))
    return offsets


def fold_bn_to_bias(gamma: torch.Tensor, beta: torch.Tensor,
                    mean: torch.Tensor, var: torch.Tensor,
                    act_offset: torch.Tensor, eps: float = 1e-5
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold BN and the learnable pre-binarization offset into one
    count-domain threshold: sign(gamma*(a-mean)/sigma + beta + offset)
    == sign((a + b) * flip) with b = (beta + offset) * sigma / gamma - mean
    and flip = sign(gamma).  Returns (b, flip)."""
    sigma = torch.sqrt(var + eps)
    g = torch.where(gamma == 0, torch.full_like(gamma, 1e-12), gamma)
    b = (beta + act_offset) * sigma / g - mean
    flip = torch.where(gamma >= 0, 1.0, -1.0).to(gamma.dtype)
    return b, flip


def map_bias(bias: torch.Tensor, method: str = "best",
             macro: IMCMacroConfig = DEFAULT_MACRO) -> torch.Tensor:
    """Quantize a real BN bias onto the in-memory grid: integers of fixed
    parity (even for a 64-wide array) clipped to [-cols, cols].  The four
    directed mappings are the paper's; ``best`` rounds to nearest."""
    step = 2 if macro.bias_parity_even else 1
    if method == "add":
        q = torch.ceil(bias / step) * step
    elif method == "sub":
        q = torch.floor(bias / step) * step
    elif method == "abs_add":
        q = torch.sign(bias) * torch.ceil(torch.abs(bias) / step) * step
    elif method == "abs_sub":
        q = torch.sign(bias) * torch.floor(torch.abs(bias) / step) * step
    elif method == "best":
        q = torch.round(bias / step) * step
    else:
        raise ValueError(f"unknown bias mapping method: {method}")
    return torch.clamp(q, -macro.bias_range, macro.bias_range)


BIAS_MAPPING_METHODS = ("add", "sub", "abs_add", "abs_sub", "best")


def mav_sa(counts: torch.Tensor, bias_int: torch.Tensor, flip: torch.Tensor,
           mav_offset: Optional[torch.Tensor] = None,
           sa_key: Optional[torch.Tensor] = None,
           sa_noise_std: float = 0.0,
           sa_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The macro's analog epilogue: sign((counts + bias [+ offset]
    [+ noise]) * flip), channels on the last axis.  The SA noise is drawn
    here from ``sa_key``/``sa_noise_std`` (one value per evaluation,
    ``std * normal(sa_key, counts.shape)``) or given as ``sa_noise``,
    broadcastable to ``counts``; both enter at the same point of the
    float chain."""
    pre = counts + bias_int
    if mav_offset is not None:
        pre = pre + mav_offset
    if sa_key is not None and sa_noise_std > 0.0:
        pre = pre + sa_noise_std * jaxrand.normal(sa_key, tuple(pre.shape))
    elif sa_noise is not None:
        pre = pre + sa_noise
    return binarize(pre * flip)


def binary_group_conv_counts(x: torch.Tensor, w: torch.Tensor, groups: int,
                             stride: int = 1) -> torch.Tensor:
    """Counts of a 1-D grouped valid convolution, in the JAX layouts.

    x: (B, T, C_in); w: (K, C_in // groups, C_out).  Returns
    (B, T_out, C_out).  Each tap's contraction over the group's input
    channels is one batched product; the taps are then summed in tap
    order.  For ±1 operands every partial sum is a small integer, so any
    order is exact.  The digital layer 0 (audio, one input channel) is
    not: its taps are multiplied elementwise (exact products, and no
    matmul, so no TF32 setting can round the audio) and summed in tap
    order, which reproduces the reference's float conv bit for bit."""
    b, t, c_in = x.shape
    k, cpg, c_out = w.shape
    if c_in != cpg * groups or c_out % groups:
        raise ValueError(f"x {tuple(x.shape)} / w {tuple(w.shape)} do not "
                         f"form a {groups}-group convolution")
    t_out = (t - k) // stride + 1
    cog = c_out // groups
    wg = w.reshape(k, cpg, groups, cog).permute(0, 2, 1, 3)  # (K, G, cpg, cog)
    acc = None
    for tap in range(k):
        xs = x[:, tap:tap + stride * (t_out - 1) + 1:stride]
        xs = xs.reshape(b, t_out, groups, cpg)
        if cpg == 1:
            term = xs * wg[tap, :, 0][None, None]            # exact products
        else:
            term = torch.einsum("btgc,gco->btgo", xs, wg[tap])
        acc = term if acc is None else acc + term
    return acc.reshape(b, t_out, c_out)


# ---------------------------------------------------------------------------
# Macro allocation / utilization accounting (paper Fig 8, §V-A)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerMapping:
    name: str
    weight_bits: int
    products_per_output: int      # fan-in of one SA decision
    out_channels: int
    macros: int
    banks: int
    utilization: float            # temporal utilization (pooling idles layers)


def map_layer_to_macros(name: str, c_out: int, c_in_per_group: int, k: int,
                        utilization: float,
                        macro: IMCMacroConfig = DEFAULT_MACRO
                        ) -> LayerMapping:
    """Allocate IMC banks for one binary conv layer: the layer's weight
    bits plus one bias word line per output channel, in banks of
    rows x cols bits, eight banks to a macro."""
    fan_in = c_in_per_group * k
    weight_bits = c_out * fan_in + c_out * macro.cols  # weights + bias lines
    banks = -(-weight_bits // (macro.rows * macro.cols))
    macros = -(-banks // macro.banks_per_macro)
    return LayerMapping(name=name, weight_bits=weight_bits,
                        products_per_output=fan_in, out_channels=c_out,
                        macros=macros, banks=banks, utilization=utilization)
