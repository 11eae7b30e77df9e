"""Means as the reference computes them: a sum times the float32 reciprocal.

Under ``jit``, XLA's CPU compile rewrites a division by a constant into a
multiplication by its float32 reciprocal: ``jnp.mean(a, axis=1)`` on
f32[B, 448] compiles to ``multiply(reduce_sum, 0.00223214296)``, and
``jnp.mean`` is itself jitted, so this holds when it is called eagerly
too.  A division ``x / n`` by a static ``n`` inside a jitted function
compiles the same way.  The IEEE quotient ``sum / n`` differs from
``sum * f32(1 / n)`` by an ulp at some sums, and a rounding step after
the mean (a quantizer at a half-LSB tie) turns that ulp into a different
value.  So every mean of the port that stands for a ``jnp.mean`` or a
jitted ``/ n`` is ``sum * r`` with ``r = f32(1) / f32(n)``, one float32
division done on the host.

A float32 tensor times a Python float that holds a float32 value is one
rounded float32 product on the CPU and on CUDA alike, so the helpers
below give the same bits on both devices.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

Dims = Union[int, Sequence[int]]


def reciprocal(n: int) -> float:
    """``f32(1) / f32(n)``, the constant XLA multiplies by for ``/ n``."""
    return float(np.float32(1.0) / np.float32(n))


def mean(x: torch.Tensor, dim: Dims) -> torch.Tensor:
    """``jnp.mean(x, axis=dim)`` as compiled: ``x.sum(dim) * f32(1 / n)``,
    n the number of elements reduced."""
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    n = 1
    for d in dims:
        n *= x.shape[d]
    return x.sum(dim=dims) * reciprocal(n)
