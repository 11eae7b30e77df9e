"""Fixed-point formats of the accelerator's digital datapath (paper §VI-A3).

Port of ``repro/core/quantize.py``: the formats, their
round-to-nearest-even quantizer and integer codes, the clipped
straight-through quantizer of quantization-aware training
(``quantize_ste``), the error scaling of Eq (1)-(2) and stochastic
rounding.  ``torch.round`` rounds half to even like ``jnp.round``, so the
quantized values are bit-identical.

    weight     : Q1.7    activation : Q1.3.4    gradient, error : Q1.7
    SGA accum  : 16-bit fixed point (Q1.15)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core import jaxrand


@dataclasses.dataclass(frozen=True)
class QFormat:
    """A signed fixed-point format: 1 sign bit, ``int_bits`` integer bits
    and ``frac_bits`` fractional bits; grid k / 2**frac_bits, k in
    [qmin, qmax]."""

    int_bits: int
    frac_bits: int
    name: str = ""

    @property
    def total_bits(self) -> int:
        return 1 + self.int_bits + self.frac_bits

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

    @property
    def max_value(self) -> float:
        return self.qmax * self.scale

    @property
    def min_value(self) -> float:
        return self.qmin * self.scale

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """Round-to-nearest-even onto the grid, saturating. Returns real
        values."""
        q = torch.clamp(torch.round(x / self.scale), self.qmin, self.qmax)
        return q * self.scale

    def quantize_ste(self, x: torch.Tensor) -> torch.Tensor:
        """Quantize with a clipped straight-through gradient: identity
        inside the representable range, zero outside.  The forward value
        is ``x + (quantize(x) - x)``, as the reference computes it."""
        grad_path = torch.where(torch.abs(x) <= self.max_value, x,
                                x.detach())
        return grad_path + (self.quantize(x) - grad_path).detach()

    def to_int(self, x: torch.Tensor,
               dtype: torch.dtype = torch.int32) -> torch.Tensor:
        """Real value -> integer code (saturating round-to-nearest-even)."""
        return torch.clamp(torch.round(x / self.scale), self.qmin,
                           self.qmax).to(dtype)


WEIGHT_Q = QFormat(int_bits=0, frac_bits=7, name="weight:Q1.7")
ACT_Q = QFormat(int_bits=3, frac_bits=4, name="act:Q1.3.4")
GRAD_Q = QFormat(int_bits=0, frac_bits=7, name="grad:Q1.7")
ERROR_Q = QFormat(int_bits=0, frac_bits=7, name="error:Q1.7")
ACCUM_Q = QFormat(int_bits=0, frac_bits=15, name="accum:Q1.15")


def quantize_ste(x: torch.Tensor, fmt: QFormat) -> torch.Tensor:
    return fmt.quantize_ste(x)


def error_scale_exponent(error: torch.Tensor, mode: str = "ceil",
                         max_exponent: Optional[int] = None
                         ) -> torch.Tensor:
    """Eq (2): s = ceil(log2(1 / max|error|)), or its floored variant
    (``mode="floor"``: one bit of headroom), clamped from above by
    ``max_exponent``.  Returns an int32 scalar on the error's device; a
    zero error tensor gives s = 0.

    The expression is the reference's (``1 / max`` as one IEEE division,
    then ``log2``), so it is exact wherever ``log2`` rounds to the exact
    integer at powers of two, as it does on the CPU for every ``k / 256``
    the quantized loop can produce (tests hold all 257)."""
    if mode not in ("ceil", "floor"):
        raise ValueError(f"mode={mode!r} must be 'ceil' or 'floor'")
    m = torch.max(torch.abs(error))
    safe = torch.clamp(m, min=torch.finfo(torch.float32).tiny)
    log = torch.log2(1.0 / safe)
    s = (torch.ceil(log) if mode == "ceil"
         else torch.floor(log)).to(torch.int32)
    if max_exponent is not None:
        s = torch.clamp(s, max=int(max_exponent))
    return torch.where(m > 0, s, torch.zeros_like(s))


def scale_error(error: torch.Tensor, fmt: QFormat = ERROR_Q,
                fixed_scale: Optional[float] = None, mode: str = "ceil",
                max_exponent: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq (1): error * 2**s quantized to ``fmt``; ``fixed_scale`` replaces
    2**s verbatim (the chip's 1.375).  Returns (scaled quantized error,
    the scale used, a float32 scalar on the error's device)."""
    if fixed_scale is not None:
        scale = torch.tensor(fixed_scale, dtype=torch.float32,
                             device=error.device)
    else:
        s = error_scale_exponent(error, mode=mode, max_exponent=max_exponent)
        scale = torch.exp2(s.to(torch.float32))
    return fmt.quantize(error * scale), scale


def stochastic_round(x: torch.Tensor, fmt: QFormat,
                     key: torch.Tensor) -> torch.Tensor:
    """Stochastic rounding onto ``fmt``'s grid: up with probability equal
    to the fractional part, the uniform draw ``jaxrand.uniform(key)`` as
    the reference draws it."""
    y = x / fmt.scale
    lo = torch.floor(y)
    up = jaxrand.uniform(key.to(x.device), tuple(x.shape)) < (y - lo)
    q = torch.clamp(lo + up.to(lo.dtype), fmt.qmin, fmt.qmax)
    return q * fmt.scale
