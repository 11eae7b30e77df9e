"""The int8 FC datapath (K4's plain version) and ``quantized_fc`` against
the JAX package's interpret-mode Pallas kernel, on the CPU.

Shapes of the reference's tiles and ragged ones, shifts 0, 4 and 7,
operands at the int8 rails (-128, 127) and biases that overflow int32 in
the rounding add; ``quantized_fc`` at the FC head's shape (8, 576) x
(576, 10).  Tolerance: none, every output is compared bitwise.  The
reference kernel takes tile-padded operands, so the JAX side pads with
zeros (as its ``quantized_fc`` does) and crops.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quantize import ACT_Q as JACT_Q
from repro.kernels.int8_matmul import ops as jops
from repro.kernels.int8_matmul.int8_matmul import int8_matmul as jint8
from repro_torch.kernels.int8_matmul import ops
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref


def _jax_int8(x, w, b, shift, out_max=127):
    m, k = x.shape
    n = w.shape[1]
    mp, kp, np_ = -(-m // 256) * 256, -(-k // 128) * 128, -(-n // 128) * 128
    xp = np.zeros((mp, kp), np.int8)
    xp[:m, :k] = x
    wp = np.zeros((kp, np_), np.int8)
    wp[:k, :n] = w
    bp = np.zeros((np_,), np.int32)
    bp[:n] = b
    out = jint8(jnp.asarray(xp), jnp.asarray(wp), jnp.asarray(bp),
                shift=shift, out_max=out_max)
    return np.asarray(out)[:m, :n]


def _port(x, w, b, shift, out_max=127):
    out = ops.int8_matmul(torch.tensor(x), torch.tensor(w), torch.tensor(b),
                          shift=shift, out_max=out_max)
    assert out.dtype == torch.int8
    return out.numpy()


@pytest.mark.parametrize("shift", [0, 4, 7])
@pytest.mark.parametrize("m,k,n", [(256, 128, 128), (256, 576, 128),
                                   (512, 128, 256), (37, 50, 11),
                                   (8, 576, 10)])
def test_int8_matmul_matches_jax(m, k, n, shift):
    rng = np.random.default_rng(m + k + n + shift)
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    b = rng.integers(-2 ** 16, 2 ** 16, (n,)).astype(np.int32)
    np.testing.assert_array_equal(_port(x, w, b, shift),
                                  _jax_int8(x, w, b, shift))


@pytest.mark.parametrize("shift", [0, 4, 7])
def test_int8_matmul_rails_and_wrapping(shift):
    """Operands at -128 and 127 (the largest products), a saturating
    ``out_max`` below 127, and int32 biases near the range's ends, so the
    bias and rounding adds wrap as XLA's int32 adds do."""
    rng = np.random.default_rng(shift)
    m, k, n = 40, 64, 24
    x = rng.choice(np.array([-128, 127], np.int8), (m, k))
    w = rng.choice(np.array([-128, 127], np.int8), (k, n))
    b = np.concatenate([
        np.full(8, 2 ** 31 - 1 - 50, np.int64),
        np.full(8, -2 ** 31, np.int64),
        rng.integers(-2 ** 20, 2 ** 20, 8)]).astype(np.int32)
    for out_max in (127, 63):
        np.testing.assert_array_equal(_port(x, w, b, shift, out_max),
                                      _jax_int8(x, w, b, shift, out_max))


def test_plain_version_wraps_like_int32():
    x = torch.full((1, 1), 127, dtype=torch.int8)
    w = torch.full((1, 1), 127, dtype=torch.int8)
    b = torch.tensor([2 ** 31 - 1], dtype=torch.int32)
    # 16129 + (2**31 - 1) wraps negative, then saturates to -128
    assert int8_matmul_ref(x, w, b, shift=0).item() == -128


def test_quantized_fc_matches_jax():
    rng = np.random.default_rng(576)
    feats = (rng.integers(0, 17, (8, 576)) / 16.0).astype(np.float32)
    w = (rng.normal(size=(576, 10)) * 0.05).astype(np.float32)
    b = (rng.normal(size=10) * 0.1).astype(np.float32)
    want = jops.quantized_fc(jnp.asarray(feats), jnp.asarray(w),
                             jnp.asarray(b))
    got = ops.quantized_fc(torch.tensor(feats), torch.tensor(w),
                           torch.tensor(b))
    assert got.dtype == torch.float32 and got.shape == (8, 10)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))
    assert np.all(np.abs(got.numpy()) <= JACT_Q.max_value)
