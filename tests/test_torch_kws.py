"""The port's KWS hardware path (repro_torch.models.kws) against the JAX
package's, bit for bit.

Parameters are made by the JAX package (or perturbed with numpy from fixed
seeds) and carried across as numpy leaves through ``hw_params_from_numpy``
/ ``params_from_numpy``.  Audio is on the 8-bit k/127 grid, made with
numpy.  The port runs on the CPU; the JAX side runs its Pallas kernel in
interpret mode.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import kws as jkws
from repro_torch.core import jaxrand
from repro_torch.models import kws

L = 640
JCFG = jkws.KWSConfig(sample_len=L)
CFG = kws.KWSConfig(sample_len=L)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def nets():
    """(JAX folded HWParams, the port's packed params carried across)."""
    params = jkws.init_params(jax.random.PRNGKey(5), JCFG)
    hw_j = jkws.fold_params(params, jkws.init_state(JCFG), JCFG)
    hw_t = kws.hw_params_from_numpy(_np_tree(hw_j), CFG, device="cpu")
    return hw_j, hw_t


def _audio(seed, b=2):
    rng = np.random.default_rng(seed)
    return (np.round(rng.uniform(-1, 1, (b, L)) * 127) / 127).astype(
        np.float32)


def _chip(seed):
    rng = np.random.default_rng(seed)
    return {f"conv{i}": (4.0 * rng.normal(size=JCFG.channels[i])).astype(
        np.float32) for i in range(1, JCFG.num_conv_layers)}


def _noise(seed, b=2):
    """Explicit per-layer pre-sign noise at each layer's conv length."""
    rng = np.random.default_rng(seed)
    out, t = {}, L
    for i in range(JCFG.num_conv_layers):
        t = (t - JCFG.kernels[i]) // JCFG.strides[i] + 1
        if i > 0:
            out[f"conv{i}"] = rng.normal(
                size=(b, t, JCFG.channels[i])).astype(np.float32)
        t //= JCFG.pools[i]
    return out


def _jdict(d):
    return None if d is None else {k: jnp.asarray(v) for k, v in d.items()}


def _tdict(d):
    return None if d is None else {k: torch.as_tensor(v)
                                   for k, v in d.items()}


@pytest.mark.parametrize("case", ["clean", "chip", "noise"])
@pytest.mark.parametrize("use_kernel", [True, False], ids=["fused", "plain"])
def test_hw_forward_matches_jax(nets, case, use_kernel):
    hw_j, hw_t = nets
    x = _audio(1)
    chip = _chip(2) if case in ("chip", "noise") else None
    noise = _noise(3) if case == "noise" else None
    lj, fj = jkws.hw_forward(hw_j, jnp.asarray(x), JCFG,
                             chip_offsets=_jdict(chip), sa_noise=_jdict(noise),
                             use_kernel=True)
    lt, ft = kws.hw_forward(hw_t, x, CFG, chip_offsets=_tdict(chip),
                            sa_noise=_tdict(noise), use_kernel=use_kernel,
                            device="cpu")
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert np.isfinite(lt.numpy()).all() and lt.shape == (2, 10)


@pytest.mark.parametrize("case", ["clean", "chip"])
def test_hw_forward_collect_counts_matches_jax(nets, case):
    """The chip's count-digitizing test mode: every layer's pre-SA counts
    (layer 0's float sums included) equal the reference's."""
    hw_j, hw_t = nets
    x = _audio(4)
    chip = _chip(5) if case == "chip" else None
    lj, _, cj = jkws.hw_forward(hw_j, jnp.asarray(x), JCFG,
                                chip_offsets=_jdict(chip),
                                collect_counts=True, use_kernel=True)
    lt, _, ct = kws.hw_forward(hw_t, x, CFG, chip_offsets=_tdict(chip),
                               collect_counts=True, use_kernel=True,
                               device="cpu")
    assert sorted(ct) == sorted(cj)
    for name in cj:
        np.testing.assert_array_equal(ct[name].numpy(), np.asarray(cj[name]),
                                      err_msg=name)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


def _perturbed_params(seed):
    """Reference params with trained-like spread: numpy-perturbed sinc band
    edges, signed gammas, offsets and betas (so flips and the bias grid's
    rounding and clipping all occur)."""
    rng = np.random.default_rng(seed)
    params = _np_tree(jkws.init_params(jax.random.PRNGKey(seed), JCFG))
    state = _np_tree(jkws.init_state(JCFG))
    p0 = params["conv0"]
    p0["low_hz"] = (p0["low_hz"] * rng.uniform(0.7, 1.3, p0["low_hz"].shape)
                    ).astype(np.float32)
    p0["band_hz"] = (p0["band_hz"] * rng.uniform(0.5, 2.0,
                                                 p0["band_hz"].shape)
                     ).astype(np.float32)
    for i in range(JCFG.num_conv_layers):
        p = params[f"conv{i}"]
        c = p["gamma"].shape[0]
        p["gamma"] = rng.normal(0.5, 1.0, c).astype(np.float32)
        p["beta"] = rng.normal(0.0, 1.5, c).astype(np.float32)
        p["offset"] = rng.normal(0.0, 0.5, c).astype(np.float32)
    params["fc"]["b"] = rng.normal(0.0, 0.3, 10).astype(np.float32)
    return params, state


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fold_params_matches_jax(seed):
    params, state = _perturbed_params(seed)
    hw_j = _np_tree(jkws.fold_params(
        jax.tree_util.tree_map(jnp.asarray, params),
        jkws.KWSState(mean={k: jnp.asarray(v) for k, v in state.mean.items()},
                      var={k: jnp.asarray(v) for k, v in state.var.items()}),
        JCFG))
    hw_t = kws.fold_params(*kws.params_from_numpy(params, state,
                                                  device="cpu"), CFG)
    for name in hw_j.w_bin:
        np.testing.assert_array_equal(hw_t.bias[name].numpy(),
                                      hw_j.bias[name], err_msg=name)
        np.testing.assert_array_equal(hw_t.flip[name].numpy(),
                                      hw_j.flip[name], err_msg=name)
        if name != "conv0":
            np.testing.assert_array_equal(hw_t.w_bin[name].numpy(),
                                          hw_j.w_bin[name], err_msg=name)
    np.testing.assert_array_equal(hw_t.fc_w.numpy(), hw_j.fc_w)
    np.testing.assert_array_equal(hw_t.fc_b.numpy(), hw_j.fc_b)
    # conv0's taps are signs of sin/cos expressions, whose last-ulp values
    # may differ between the libraries: count the taps that flip
    differing = int((hw_t.w_bin["conv0"].numpy() != hw_j.w_bin["conv0"]).sum())
    assert differing == 0, f"{differing} conv0 taps differ from the reference"


@pytest.mark.parametrize("case", ["clean", "chip"])
def test_silence_columns_match_jax(nets, case):
    hw_j, hw_t = nets
    chip = _chip(6) if case == "chip" else None
    sj = jkws.silence_columns(hw_j, JCFG, chip_offsets=_jdict(chip))
    st = kws.silence_columns(hw_t, CFG, chip_offsets=_tdict(chip))
    assert sorted(st) == sorted(sj)
    for name in sj:
        np.testing.assert_array_equal(st[name].numpy(), np.asarray(sj[name]),
                                      err_msg=name)


def test_port_init_params_serve_finite_logits():
    """The port's own init (from a jaxrand key) folds into a net whose
    fused and plain hardware paths agree and give finite logits."""
    params = kws.init_params(jaxrand.PRNGKey(3, device="cpu"), CFG,
                             device="cpu")
    hw = kws.fold_params(params, kws.init_state(CFG, device="cpu"), CFG,
                         pack=True)
    x = _audio(7, b=3)
    lk, fk = kws.hw_forward(hw, x, CFG, use_kernel=True, device="cpu")
    lp, fp = kws.hw_forward(hw, x, CFG, use_kernel=False, device="cpu")
    assert torch.equal(lk, lp) and torch.equal(fk, fp)
    assert lk.shape == (3, 10) and torch.isfinite(lk).all()
    for name in CFG.imc_layer_names():
        b = hw.hw.bias[name]
        assert torch.all(b % 2 == 0) and torch.all(b.abs() <= 64)
