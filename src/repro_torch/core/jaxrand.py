"""``jax.random``'s threefry PRNG, bit for bit, in plain PyTorch.

The JAX package draws every random number of the hardware model (chip
offsets, SA read noise, the noise field, calibration read noise, RGP) from
``jax.random`` with threefry2x32 in its partitionable form
(``jax_threefry_partitionable=True``, jax 0.9.0).  This module computes the
same numbers, so one seed gives both packages the same noisy chip:

* a key is an int64 tensor (..., 2) holding the two uint32 words (torch's
  uint32 lacks most ops; every word is kept in [0, 2**32) and masked after
  each add, and the rotations shift non-negative int64 values, so every
  shift is logical).  A leading batch of keys stands for ``vmap``;
* ``PRNGKey(seed)`` is ``(0, seed mod 2**32)``; ``fold_in(key, d)`` hashes
  the counter pair ``(0, d)``; in the partitionable form ``split(key, n)[i]``
  is the hash of ``(0, i)`` too, and the bits of a draw of shape S are the
  XOR of the two hash words of the counters ``(0, j)``, j the flat index;
* ``uniform`` puts 23 random bits into the mantissa of a float in [1, 2)
  and scales, as ``jax.random._uniform`` does;
* ``randint`` (int32) takes 32 bits from each half of a split key and
  folds them into the span in uint32 arithmetic, as
  ``jax.random._randint`` does;
* ``normal`` is ``sqrt(2) * erf_inv(uniform(nextafter(-1, 0), 1))`` with
  the f32 ``erf_inv`` that XLA's CPU backend compiles: Giles' polynomial
  on ``w = -log1p(-x*x)``, XLA's own ``log1p`` (a Cephes rational for small
  arguments, Cephes ``logf`` for the rest), and a fused multiply-add in
  every Horner step, as LLVM contracts them.

The normal is built from correctly rounded IEEE operations only: float32
``+ - *`` and comparisons, and float64 products, sums, quotients and square
roots rounded to float32 (an FMA is the float64 ``a*b + c`` rounded to
float32; a float32 quotient or square root is the float64 one rounded).
Those are the same on every device, so the noise is bitwise the same on
the CPU and on the card.  (torch's own float32 ``sqrt`` on the CPU is not
correctly rounded, and its ``log1p``/``erfinv`` differ from XLA's.)  A
normal draw is a function of 23 random bits only, and the tests hold
this one against ``jax.random.normal`` on all 2**23 of them.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import resolve_device

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(shape)


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as a (2,) key on ``device`` (``None``
    means CUDA): the words (0, seed mod 2**32), for any Python int."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=resolve_device(device))


def key_from_numpy(key, device=None) -> torch.Tensor:
    """A JAX key (``np.asarray(jax.random.PRNGKey(s))``, (..., 2) uint32)
    as a key of this module on ``device`` (``None`` means CUDA)."""
    arr = np.asarray(key)
    if arr.shape[-1:] != (2,):
        raise ValueError(f"a key has 2 words in its last axis, got shape "
                         f"{arr.shape}")
    return torch.tensor(arr.astype(np.uint32).astype(np.int64),
                        device=resolve_device(device))


def key_to_numpy(key: torch.Tensor) -> np.ndarray:
    """A key (..., 2) as the JAX package's (..., 2) uint32 array."""
    return key.detach().cpu().numpy().astype(np.uint32)


# ---------------------------------------------------------------------------
# the threefry2x32 hash
# ---------------------------------------------------------------------------


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 20-round threefry2x32 block on broadcastable int64 words in
    [0, 2**32): key (k0, k1), counter (x0, x1).  Returns the two output
    words.  Same schedule as ``jax._src.prng._threefry2x32_lowering``."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _hash(key: torch.Tensor, counters: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hash the counter pairs (0, c) under the keys (..., 2); the batch
    shapes of ``key`` and ``counters`` broadcast.  Every counter here is
    below 2**32, so its high word is 0."""
    batch = torch.broadcast_shapes(key.shape[:-1], counters.shape)
    key = key.expand(batch + (2,))
    c = counters.expand(batch)
    return threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(c), c)


def _draw(key: torch.Tensor, shape: Shape
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hash words of a draw of ``shape`` under every key of ``key``
    (..., 2): counters (0, j), j the flat index; (..., *shape) each."""
    shape = _shape(shape)
    idx = torch.arange(math.prod(shape), dtype=torch.int64,
                       device=key.device).reshape(shape)
    return _hash(key.reshape(key.shape[:-1] + (1,) * len(shape) + (2,)),
                 idx)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: a new key from ``key`` (..., 2) and a 32-bit
    ``data`` (an int, or an integer tensor broadcastable to the key's batch
    shape; the batch shapes broadcast)."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & _M32
    return torch.stack(_hash(key, d), dim=-1)


def split(key: torch.Tensor, num: Shape = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` (partitionable): (..., *num, 2).
    Key ``i`` is ``fold_in(key, i)``."""
    return torch.stack(_draw(key, num), dim=-1)


def bits_at(key: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """The 32-bit draw at flat index ``counters`` of a draw under ``key``
    (..., 2), element by element (the batch shapes broadcast):
    ``random_bits(key, S).reshape(-1)[c]`` for any S with more than c
    elements.  Lets one hash serve draws of different shapes."""
    y0, y1 = _hash(key, counters)
    return y0 ^ y1


def random_bits(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32 bits): int64 values in
    [0, 2**32), shape (..., *shape) for keys (..., 2)."""
    y0, y1 = _draw(key, shape)
    return y0 ^ y1


# ---------------------------------------------------------------------------
# floats
# ---------------------------------------------------------------------------


def _mantissa_floats(bits: torch.Tensor) -> torch.Tensor:
    """The top 23 bits as the mantissa of a float in [1, 2), minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` as an FMA gives it: the float64 product of
    float32 operands is exact, and the float64 sum is rounded to float32.
    (That second rounding could in principle differ from a single one; on
    the normal's whole domain it never does, which the tests check.)"""
    a64 = a.double()
    b64 = b.double() if isinstance(b, torch.Tensor) else b
    c64 = c.double() if isinstance(c, torch.Tensor) else c
    return (a64 * b64 + c64).float()


def uniform(key: torch.Tensor, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform`` in float32: (..., *shape) for keys (..., 2)."""
    lo, hi = np.float32(minval), np.float32(maxval)
    floats = _mantissa_floats(random_bits(key, shape))
    u = fma(floats, float(hi - lo), float(lo))
    return torch.clamp_min(u, float(lo))


def _f32(*values: float) -> Tuple[float, ...]:
    """Constants as the float32 values the compiled code holds."""
    return tuple(float(np.float32(v)) for v in values)


# XLA's f32 erf_inv (Giles), coefficients for w < 5 and w >= 5
_ERFINV_LT5 = _f32(2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                   -4.39150654e-06, 0.00021858087, -0.00125372503,
                   -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = _f32(-0.000200214257, 0.000100950558, 0.00134934322,
                   -0.00367342844, 0.00573950773, -0.0076224613,
                   0.00943887047, 1.00167406, 2.83297682)
# XLA's log1p for |x| < sqrt(2) - 1 (Cephes): numerator / denominator
_LOG1P_NUM = _f32(4.527e-05, 0.49854103, 6.5787325, 29.911919, 60.94967,
                  57.112965, 20.039553)
_LOG1P_DEN = _f32(15.062909, 83.04757, 221.7624, 309.09872, 216.42789,
                  60.11866)
_LOG1P_SMALL, = _f32(0.41421357)
# XLA CPU's logf (Cephes): polynomial, ln 2 split in two, sqrt(1/2)
_LOGF_P = _f32(0.070376836, -0.1151461, 0.116769984, -0.12420141,
               0.14249323, -0.16668057, 0.20000714, -0.24999994, 0.3333333)
_LN2_LO, _LN2_HI, _SQRT_HALF = _f32(-0.00021219444, 0.693359375,
                                    0.70710677)
_SQRT2_F32 = float(np.float32(math.sqrt(2.0)))
_LO_NORMAL = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full_like(like, v)


def logf(z: torch.Tensor) -> torch.Tensor:
    """XLA CPU's float32 log (Cephes logf) for positive normal z: the
    mantissa in [sqrt(1/2), sqrt(2)), a polynomial with an FMA in each
    Horner step, and the exponent times ln 2 split in two."""
    zb = z.view(torch.int32).to(torch.int64)
    mant = ((zb & 0x7FFFFF) | 0x3F000000).to(torch.int32).view(
        torch.float32)                                   # in [0.5, 1)
    e = ((zb >> 23) - 127).to(torch.float32) + 1.0
    small = mant < _SQRT_HALF
    zero = torch.zeros_like(mant)
    t = (mant - 1.0) + torch.where(small, mant, zero)
    e = e - torch.where(small, torch.ones_like(e), zero)
    t2 = t * t
    t3 = t2 * t
    p = _LOGF_P
    y = fma(t, p[0], p[1])
    y1 = fma(t, p[3], p[4])
    y2 = fma(t, p[6], p[7])
    y = fma(y, t, p[2])
    y1 = fma(y1, t, p[5])
    y2 = fma(y2, t, p[8])
    y = fma(y, t3, y1)
    y = fma(y, t3, y2)
    y = fma(y, t3, e * _LN2_LO)
    r = (t - t2 * 0.5) + y
    return fma(e, _LN2_HI, r)


def logf_host(z: np.ndarray) -> np.ndarray:
    """``logf`` on a numpy float32 array, the same operations in the same
    order (host code: a few numpy calls instead of dozens of launches)."""
    f32 = np.float32

    def fma_(a, b, c):
        return (np.asarray(a, np.float64) * b + c).astype(f32)

    zb = np.asarray(z, f32).view(np.int32).astype(np.int64)
    mant = ((zb & 0x7FFFFF) | 0x3F000000).astype(np.int32).view(f32)
    e = ((zb >> 23) - 127).astype(f32) + f32(1.0)
    small = mant < f32(_SQRT_HALF)
    t = (mant - f32(1.0)) + np.where(small, mant, f32(0.0))
    e = e - np.where(small, f32(1.0), f32(0.0))
    t2 = t * t
    t3 = t2 * t
    p = _LOGF_P
    y = fma_(t, p[0], p[1])
    y1 = fma_(t, p[3], p[4])
    y2 = fma_(t, p[6], p[7])
    y = fma_(y, t, p[2])
    y1 = fma_(y1, t, p[5])
    y2 = fma_(y2, t, p[8])
    y = fma_(y, t3, y1)
    y = fma_(y, t3, y2)
    y = fma_(y, t3, e * f32(_LN2_LO))
    r = (t - t2 * f32(0.5)) + y
    return fma_(e, _LN2_HI, r)


def _log1p_neg(y: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p for y in (-1, 0]."""
    yy = y * y
    den = y + _LOG1P_DEN[0]
    for c in _LOG1P_DEN[1:]:
        den = fma(den, y, c)
    num = fma(_const(_LOG1P_NUM[0], y), y, _LOG1P_NUM[1])
    for c in _LOG1P_NUM[2:]:
        num = fma(num, y, c)
    q = (num.double() / den.double()).float()
    small = y + (yy * -0.5 + (y * yy) * q)
    return torch.where(y.abs() < _LOG1P_SMALL, small, logf(y + 1.0))


def _erfinv_times_sqrt2(u: torch.Tensor) -> torch.Tensor:
    """``sqrt(2) * erf_inv(u)`` for u in (-1, 1), as XLA computes it."""
    w = -_log1p_neg(u * -u)
    lt = w < 5.0
    ww = torch.where(lt, w - 2.5,
                     torch.sqrt(w.double()).float() - 3.0)
    p = torch.where(lt, _const(_ERFINV_LT5[0], w), _const(_ERFINV_GE5[0], w))
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = fma(p, ww, torch.where(lt, _const(a, w), _const(b, w)))
    return (u * p) * _SQRT2_F32


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """Standard normals (float32) from 32-bit draws, as
    ``jax.random.normal`` maps them (only the top 23 bits count)."""
    u = torch.clamp_min(_mantissa_floats(bits) * 2.0 + _LO_NORMAL,
                        _LO_NORMAL)
    return _erfinv_times_sqrt2(u)


def normal(key: torch.Tensor, shape: Shape = ()) -> torch.Tensor:
    """``jax.random.normal`` in float32: (..., *shape) for keys (..., 2)."""
    return normal_from_bits(random_bits(key, shape))


# ---------------------------------------------------------------------------
# integers
# ---------------------------------------------------------------------------


def randint(key: torch.Tensor, shape: Shape, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint`` for int32: (..., *shape) values in
    [minval, maxval) for keys (..., 2), as int64 tensors holding int32s.
    As ``jax.random._randint`` does: split the key in two, draw 32 random
    bits from each, force the span to 1 when ``maxval <= minval``, form
    the multiplier as ``(2**16 % span)**2 % span`` with the square in
    uint32 (so it wraps to 0 for spans past 2**16) and return
    ``((hi % span) * mult + lo % span) % span + minval``, every step in
    uint32 (or int32, for the last add) wraparound.  ``minval`` and
    ``maxval`` are int32 Python ints."""
    lo_i32, hi_i32 = -2 ** 31, 2 ** 31 - 1
    if not (lo_i32 <= minval <= hi_i32 and lo_i32 <= maxval <= hi_i32):
        raise ValueError(f"randint: bounds {minval}, {maxval} are not int32")
    span = 1 if maxval <= minval else (maxval - minval) & _M32
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _M32) % span     # wraps for span > 2**16
    keys = split(key, 2)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    offset = ((((higher % span) * mult) & _M32) + lower % span) & _M32
    offset = offset % span
    out = (offset + (minval & _M32)) & _M32
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out)
