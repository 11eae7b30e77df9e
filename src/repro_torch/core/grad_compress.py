"""Distributed gradient compression with error feedback: the JAX
package's ``core/grad_compress.py`` on ``torch.distributed``.

The paper's two training tricks compose into a distributed-optimization
primitive:

  * error scaling (Eq 1-2) -> a per-tensor dynamic power-of-two scale
    before the int8 quantization of the gradient;
  * small gradient accumulation (Alg 1) -> the per-rank error-feedback
    residual: whatever the quantizer drops is banked locally and added to
    the next step's gradient.

The mean all-reduce moves int8 on the wire: an ``all_to_all_single`` of
int8 shards, an exact int32 sum of the shard each rank owns, a requantized
int8 sum and an ``all_gather_into_tensor`` of it, 2 bytes an element
against a float32 ring all-reduce's 8.  Every step follows the reference's
order, padding and dequantization chain, so a group of ranks returns the
reference's numbers bit for bit.

The scale is the reference's as XLA's CPU code computes it (read from
the LLVM IR XLA emits for ``_pow2_scale`` and checked against it on every
``s`` the scale can take): ``log2`` is XLA's ``log``
(``core.jaxrand.logf``) times the float32 ``1 / ln 2``, and ``exp2`` is
XLA's ``exp`` (Cephes ``expf``, each multiply-add contracted into an FMA)
of ``s`` times the float32 ``ln 2``.  That ``exp`` is not an exact power of
two for most ``s`` (its argument carries the float32 ``ln 2``'s
rounding), and ``torch.log2`` can fall on the other side of an integer
where ``127 / max_abs`` is a power of two or an ulp from one, so both are
built here from single float32 operations and FMAs.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import jaxrand
from repro_torch.launch import analysis

INT8_MAX = 127


def _f32(*vals) -> Tuple[float, ...]:
    """Constants as the float32 values the compiled code holds."""
    return tuple(float(np.float32(v)) for v in vals)


# XLA CPU's float32 exp (Cephes expf): the argument's clamp, ln 2 split in
# two, the polynomial's coefficients; and the float32 1 / ln 2 and ln 2
_EXP_LO, _EXP_HI = _f32(-87.8, 88.8)
_LN2_HI, _LN2_LO = _f32(0.693359375, -0.00021219444)
_EXP_P = _f32(0.00019875691, 0.0013981999, 0.008333452, 0.041665796,
              0.16666666, 0.5)
_LOG2E, _LN2 = _f32(1.442695, 0.6931472)
_TINY = float(np.finfo(np.float32).tiny)


def _xla_exp(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 ``exp``: clamp, n = floor(x / ln 2 + 1/2) in
    [-127, 127], the reduced argument in two steps, a degree-5 polynomial,
    times 2**n from its bits."""
    fma = jaxrand.fma
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = fma(-n, _LN2_LO, fma(-n, _LN2_HI, x))
    p = fma(r, _EXP_P[0], _EXP_P[1])
    for c in _EXP_P[2:]:
        p = fma(p, r, c)
    p = 1.0 + fma(p, r * r, r)
    two_n = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return p * two_n


def _pow2_scale(max_abs: torch.Tensor) -> torch.Tensor:
    """The reference's scale ``exp2(floor(log2(127 / max_abs)))`` (1 where
    ``max_abs`` is 0), as XLA's CPU code computes it."""
    safe = torch.clamp_min(max_abs, _TINY)
    # a tensor quotient: ``127 / safe`` would be ``reciprocal(safe) * 127``
    q = torch.full_like(safe, float(INT8_MAX)) / safe
    log_q = torch.where(torch.isinf(q), q, jaxrand.logf(q))
    s = torch.floor(log_q * _LOG2E)
    # XLA's CPU code reads a subnormal as zero
    return torch.where(max_abs >= _TINY, _xla_exp(s * _LN2),
                       torch.ones_like(max_abs))


def quantize_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x * scale), -INT8_MAX,
                       INT8_MAX).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) / scale


def _record(op: str, t: torch.Tensor) -> None:
    analysis.record(op, t.numel() * t.element_size())


def compressed_allreduce_mean(grad: torch.Tensor, residual: torch.Tensor,
                              group=None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback int8 mean all-reduce over ``group`` (the default
    group when ``None``).  ``grad`` and ``residual``: this rank's float32
    values, one shape.  Returns (the approximate mean, the new residual),
    the reference's numbers bit for bit."""
    n = dist.get_world_size(group)
    e = grad + residual                                   # error feedback
    # one scale for the whole group, so the int32 sum is exact
    max_abs = torch.max(torch.abs(e)).reshape(1)
    dist.all_reduce(max_abs, op=dist.ReduceOp.MAX, group=group)
    _record("all-reduce", max_abs)
    scale = _pow2_scale(max_abs[0])
    q = quantize_int8(e, scale)
    new_residual = e - dequantize_int8(q, scale)          # SGA-style banking

    flat = q.reshape(-1)
    pad = (-flat.numel()) % n
    flat = torch.nn.functional.pad(flat, (0, pad))
    # rank d receives shard d from every peer (int8 on the wire)
    gathered = torch.empty_like(flat)
    dist.all_to_all_single(gathered, flat, group=group)
    _record("all-to-all", gathered)
    local_sum = torch.sum(gathered.reshape(n, -1).to(torch.int32), dim=0,
                          dtype=torch.int32)
    sum_max = torch.max(torch.abs(local_sum)).reshape(1)
    dist.all_reduce(sum_max, op=dist.ReduceOp.MAX, group=group)
    _record("all-reduce", sum_max)
    sscale = _pow2_scale(sum_max[0].to(torch.float32))
    q_sum = quantize_int8(local_sum.to(torch.float32), sscale)
    full = torch.empty(n * q_sum.numel(), dtype=torch.int8,
                       device=q_sum.device)
    dist.all_gather_into_tensor(full, q_sum, group=group)
    _record("all-gather", full)
    if pad:
        full = full[:-pad]
    # q ~ e * scale, local_sum ~ sum(e) * scale, q_sum ~ local_sum * sscale,
    # so mean = q_sum / (sscale * scale * n); XLA folds the reference's two
    # divisions into one by that product
    mean = full.reshape(grad.shape).to(torch.float32) / (
        sscale * (scale * n))
    return mean, new_residual


def exact_allreduce_mean(grad: torch.Tensor, group=None) -> torch.Tensor:
    """float32 mean over ``group``: the sum, times the float32 ``1 / n``
    as XLA compiles ``pmean``."""
    n = dist.get_world_size(group)
    out = grad.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    _record("all-reduce", out)
    return out * float(np.float32(1.0) / np.float32(n))
