"""The per-group IMC path (K5's plain version) against the JAX package's
interpret-mode Pallas kernel, on the CPU.

``mav_matmul`` at the shapes of ``tests/test_kernels.py`` in float32 and
bfloat16, with and without a noise operand, and on {-1, 0, +1} operands
(K5's int8 contract); ``conv_mav`` with 2 and 4
groups, stride 1 and 2, clean and with ``sa_key`` noise at std 1.0 and
4.0 (the per-group ``split`` chain).  Tolerance: none, the ±1 outputs are
compared bitwise.  Inputs are made with numpy from a seed; noise keys are
JAX keys carried across with ``jaxrand.key_from_numpy``.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.imc_mav import ops as jops
from repro_torch.core import jaxrand
from repro_torch.kernels.imc_mav import ops

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pm1(rng, shape):
    return np.where(rng.random(shape) < 0.5, 1.0, -1.0).astype(np.float32)


def _inputs(seed, m, k, n):
    rng = np.random.default_rng(seed)
    x, w = _pm1(rng, (m, k)), _pm1(rng, (k, n))
    bias = (np.round(rng.normal(size=n) * 10) * 2).astype(np.float32)
    flip = _pm1(rng, (n,))
    noise = (4.0 * rng.normal(size=(m, n))).astype(np.float32)
    return x, w, bias, flip, noise


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noise"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(64, 72, 24), (300, 72, 96),
                                   (257, 48, 130), (512, 128, 576)])
def test_mav_matmul_matches_jax(m, k, n, dtype, noisy):
    jdt, tdt = DTYPES[dtype]
    x, w, bias, flip, noise = _inputs(m * 7 + k + n, m, k, n)
    nz = noise if noisy else None
    want = jops.mav_matmul(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                           jnp.asarray(bias), jnp.asarray(flip),
                           None if nz is None else jnp.asarray(nz))
    got = ops.mav_matmul(torch.tensor(x).to(tdt), torch.tensor(w).to(tdt),
                         torch.tensor(bias), torch.tensor(flip),
                         None if nz is None else torch.tensor(nz))
    assert got.dtype == tdt and got.shape == (m, n)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    if noisy:   # the noise flips some decisions
        clean = ops.mav_matmul(torch.tensor(x), torch.tensor(w),
                               torch.tensor(bias), torch.tensor(flip))
        assert (clean != got.float()).float().mean() > 0.01


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mav_matmul_matches_jax_on_ternary(dtype):
    """x and w in {-1, 0, +1}: the contract K5's int8 products rest on.
    The plain version counts a zero as a zero product, as JAX does."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(72)
    m, k, n = 96, 72, 36
    x = rng.integers(-1, 2, (m, k)).astype(np.float32)
    w = rng.integers(-1, 2, (k, n)).astype(np.float32)
    _, _, bias, flip, noise = _inputs(73, m, k, n)
    want = jops.mav_matmul(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                           jnp.asarray(bias), jnp.asarray(flip),
                           jnp.asarray(noise))
    got = ops.mav_matmul(torch.tensor(x).to(tdt), torch.tensor(w).to(tdt),
                         torch.tensor(bias), torch.tensor(flip),
                         torch.tensor(noise))
    assert (x == 0).mean() > 0.2 and (w == 0).mean() > 0.2
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("std", [0.0, 1.0, 4.0])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("groups", [2, 4])
def test_conv_mav_matches_jax(groups, stride, std):
    rng = np.random.default_rng(groups * 10 + stride)
    b, t, cpg, cog = 2, 40, 24, 24
    x = _pm1(rng, (b, t, groups * cpg))
    w = _pm1(rng, (3, cpg, groups * cog))
    bias = (np.round(rng.normal(size=groups * cog) * 6) * 2).astype(
        np.float32)
    flip = _pm1(rng, (groups * cog,))
    jkey = jax.random.PRNGKey(31 + groups)
    want = jops.conv_mav(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias),
                         jnp.asarray(flip), groups=groups, stride=stride,
                         sa_key=jkey, sa_noise_std=std)
    got = ops.conv_mav(torch.tensor(x), torch.tensor(w), torch.tensor(bias),
                       torch.tensor(flip), groups=groups, stride=stride,
                       sa_key=jaxrand.key_from_numpy(np.asarray(jkey),
                                                     "cpu"),
                       sa_noise_std=std)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ops.COUNTS_MAV.launches == 0      # the CPU runs no kernel


def test_im2col_layout():
    x = torch.arange(2 * 7 * 3, dtype=torch.float32).reshape(2, 7, 3)
    got = ops._im2col(x, 3, 2)
    want = jops._im2col(jnp.asarray(x.numpy()), 3, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
