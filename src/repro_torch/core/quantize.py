"""Fixed-point formats of the accelerator's digital datapath (paper §VI-A3).

Port of the forward half of ``repro/core/quantize.py``: the formats and
their round-to-nearest-even quantizer.  ``torch.round`` rounds half to
even like ``jnp.round``, so the quantized values are bit-identical.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QFormat:
    """A signed fixed-point format: 1 sign bit, ``int_bits`` integer bits
    and ``frac_bits`` fractional bits; grid k / 2**frac_bits, k in
    [qmin, qmax]."""

    int_bits: int
    frac_bits: int

    @property
    def scale(self) -> float:
        """Value of one LSB."""
        return 2.0 ** (-self.frac_bits)

    @property
    def qmax(self) -> int:
        return 2 ** (self.int_bits + self.frac_bits) - 1

    @property
    def qmin(self) -> int:
        return -(2 ** (self.int_bits + self.frac_bits))

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """Round-to-nearest-even onto the grid, saturating. Returns real
        values."""
        q = torch.clamp(torch.round(x / self.scale), self.qmin, self.qmax)
        return q * self.scale


WEIGHT_Q = QFormat(int_bits=0, frac_bits=7)   # Q1.7 weights
ACT_Q = QFormat(int_bits=3, frac_bits=4)      # Q1.3.4 activations
