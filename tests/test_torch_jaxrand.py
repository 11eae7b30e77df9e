"""``repro_torch.core.jaxrand`` against ``jax.random`` (jax 0.9.0,
threefry2x32, partitionable), on the CPU.

Tolerances: none.  Keys, ``fold_in``, ``split``, bits, ``uniform`` and
``normal`` are compared bitwise.  ``normal`` is a function of the top 23
of its 32 random bits, so besides 2**20 draws from seeded keys the test
walks its whole domain, all 2**23 mantissas, against the same ``erf_inv``
chain compiled by XLA: the measured mismatch rate is 0.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import jaxrand as jr

SEEDS = [0, 1, 2 ** 31 - 1, -1, -12345, 2 ** 32 + 7]


def _np(t):
    return t.numpy()


def _jkey(k):
    return np.asarray(k, np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    np.testing.assert_array_equal(jr.key_to_numpy(jr.PRNGKey(seed, "cpu")),
                                  _jkey(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("data", [0, 1, 7, 2 ** 31, 2 ** 32 - 1])
@pytest.mark.parametrize("seed", [0, 42])
def test_fold_in(seed, data):
    got = jr.fold_in(jr.PRNGKey(seed, "cpu"), data)
    want = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    np.testing.assert_array_equal(jr.key_to_numpy(got), _jkey(want))


def test_fold_in_batched_keys_and_data():
    """A batch of keys against a batch of data is ``vmap(fold_in)``."""
    jkeys = jax.random.split(jax.random.PRNGKey(3), 5)
    data = np.array([0, 9, 2 ** 32 - 1, 123456, 77], np.uint32)
    want = jax.vmap(jax.random.fold_in)(jkeys, jnp.asarray(data))
    got = jr.fold_in(jr.key_from_numpy(np.asarray(jkeys), "cpu"),
                     torch.tensor(data.astype(np.int64)))
    np.testing.assert_array_equal(jr.key_to_numpy(got), _jkey(want))


@pytest.mark.parametrize("num", [2, 3, 8, (2, 3)])
def test_split(num):
    got = jr.split(jr.PRNGKey(11, "cpu"), num)
    want = jax.random.split(jax.random.PRNGKey(11), num)
    np.testing.assert_array_equal(jr.key_to_numpy(got), _jkey(want))


def test_split_chains():
    """``key, sub = split(key)`` repeated, as the JAX package's per-layer
    chains draw."""
    k, jk = jr.PRNGKey(5, "cpu"), jax.random.PRNGKey(5)
    for _ in range(6):
        k, sub = jr.split(k)
        jk, jsub = jax.random.split(jk)
        np.testing.assert_array_equal(jr.key_to_numpy(sub), _jkey(jsub))
    k3 = jr.split(k, 3)
    np.testing.assert_array_equal(jr.key_to_numpy(k3),
                                  _jkey(jax.random.split(jk, 3)))


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5), (2, 3, 4)])
def test_bits_and_uniform(shape):
    k, jk = jr.PRNGKey(2024, "cpu"), jax.random.PRNGKey(2024)
    np.testing.assert_array_equal(
        _np(jr.random_bits(k, shape)).astype(np.uint32),
        np.asarray(jax.random.bits(jk, shape)))
    np.testing.assert_array_equal(
        _np(jr.uniform(k, shape)).view(np.uint32),
        np.asarray(jax.random.uniform(jk, shape)).view(np.uint32))
    np.testing.assert_array_equal(
        _np(jr.uniform(k, shape, -3.0, 0.5)).view(np.uint32),
        np.asarray(jax.random.uniform(jk, shape, minval=-3.0,
                                      maxval=0.5)).view(np.uint32))


@pytest.mark.parametrize("shape", [(), (5,), (3, 7)])
def test_normal_small_shapes(shape):
    got = _np(jr.normal(jr.PRNGKey(9, "cpu"), shape))
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(9), shape))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_normal_on_2_20_draws_is_bitwise():
    """2**20 draws from four keys (batched keys, as ``vmap`` draws)."""
    jkeys = jax.random.split(jax.random.PRNGKey(77), 4)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.normal(k, (1 << 18,)))(jkeys))
    got = _np(jr.normal(jr.key_from_numpy(np.asarray(jkeys), "cpu"),
                        1 << 18))
    mismatch = np.mean(got.view(np.uint32) != want.view(np.uint32))
    assert mismatch == 0.0, f"mismatch rate {mismatch}"


def test_normal_over_its_whole_domain_is_bitwise():
    """Every 23-bit mantissa, through ``jax.lax.erf_inv`` compiled by XLA
    (the same fused chain ``jax.random.normal`` runs)."""
    lo = np.nextafter(np.float32(-1), np.float32(0))

    @jax.jit
    def ref(m):
        f = jax.lax.bitcast_convert_type(m | jnp.uint32(0x3F800000),
                                         jnp.float32) - 1.0
        u = jnp.maximum(lo, f * (np.float32(1) - lo) + lo)
        return np.float32(np.sqrt(2)) * jax.lax.erf_inv(u)

    bad = 0
    for c in range(8):
        m = np.arange(c << 20, (c + 1) << 20, dtype=np.uint32)
        want = np.asarray(ref(m)).view(np.uint32)
        got = _np(jr.normal_from_bits(torch.tensor(
            m.astype(np.int64) << 9))).view(np.uint32)
        bad += int(np.sum(got != want))
    assert bad == 0, f"{bad} of 2**23 mantissas differ"
