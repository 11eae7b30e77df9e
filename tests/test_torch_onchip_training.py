"""The port's on-chip learning and bias compensation
(repro_torch.core.onchip_training, core.quantize, core.compensation)
against the JAX package, on the CPU, bit for bit.

Inputs are made with numpy from a seed and handed to both packages.  Every
quantity of the quantized head loop lies on a fixed-point grid, so the two
libraries must agree exactly: the LUT, the LUT softmax, the error-scaling
exponent on every value ``max|error|`` can take (k / 256), one SGA step,
one epoch's gradients and update, and whole fine-tuning runs, RGP noise
included (the port draws JAX's numbers).  The
compensation's float offset estimate is a sum over rows whose order the
libraries may choose differently, so the estimate is held to 1e-5 and the
compensated integer biases bitwise.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compensation as jcomp
from repro.core import onchip_training as jot
from repro.core import quantize as jq
from repro.training import kws as jtr
from repro_torch.core import compensation, jaxrand, onchip_training as ot
from repro_torch.core import quantize
from repro_torch.training import kws as tr

D, C, N = 576, 10, 12
CONFIGS = {
    "dynamic-ceil": dict(),
    "dynamic-floor": dict(error_scale_mode="floor"),
    "floor-max3": dict(error_scale_mode="floor",
                       error_scale_max_exponent=3),
    "fixed-1.375": dict(fixed_error_scale=1.375),
    "no-scaling": dict(error_scaling=False),
    "no-sga": dict(sga=False, fixed_error_scale=1.375),
}


def _pair(**kw):
    return jot.OnChipTrainConfig(**kw), ot.OnChipTrainConfig(**kw)


def _head_inputs(seed, n=N):
    """Features like the GAP of ±1 activations, labels, a Q1.7 head."""
    rng = np.random.default_rng(seed)
    feats = rng.uniform(-1.0, 1.0, (n, D)).astype(np.float32)
    labels = rng.integers(0, C, n).astype(np.int32)
    w0 = (rng.normal(size=(D, C)) / np.sqrt(D)).astype(np.float32)
    b0 = (rng.normal(size=C) * 0.05).astype(np.float32)
    return feats, labels, w0, b0


def _eq(port, ref):
    np.testing.assert_array_equal(port.detach().numpy(), np.asarray(ref))


def test_exp_lut_matches_reference():
    _eq(ot._EXP_LUT, jot._EXP_LUT)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lut_softmax_matches(seed):
    rng = np.random.default_rng(seed)
    logits = np.asarray(jq.ACT_Q.quantize(jnp.asarray(
        rng.normal(size=(64, C)).astype(np.float32) * (2 + 4 * seed))))
    _eq(ot.lut_softmax(torch.tensor(logits)), jot.lut_softmax(
        jnp.asarray(logits)))


@pytest.mark.parametrize("max_exponent", [None, 3])
@pytest.mark.parametrize("mode", ["ceil", "floor"])
def test_error_scale_exponent_on_every_grid_value(mode, max_exponent):
    """In the quantized loop the error is probs - onehot with probs on the
    1/256 grid, so max|error| is one of the 257 values k / 256."""
    rng = np.random.default_rng(7)
    for k in range(257):
        err = (rng.integers(0, k + 1, (4, C)) / 256.0).astype(np.float32)
        err *= np.where(rng.random((4, C)) < 0.5, -1.0, 1.0).astype(
            np.float32)
        err[1, 3] = -k / 256.0
        got = quantize.error_scale_exponent(torch.tensor(err), mode,
                                            max_exponent)
        want = jq.error_scale_exponent(jnp.asarray(err), mode, max_exponent)
        assert got.dtype == torch.int32
        assert int(got) == int(want), (k, mode, max_exponent)


@pytest.mark.parametrize("lr", [1 / 16, 1 / 128, 0.05])
def test_sga_step_matches(lr):
    rng = np.random.default_rng(3)
    g = np.asarray(jq.GRAD_Q.quantize(jnp.asarray(
        rng.normal(size=(D, C)).astype(np.float32) * 0.05)))
    a = np.asarray(jq.ACCUM_Q.quantize(jnp.asarray(
        rng.uniform(-0.05, 0.05, (D, C)).astype(np.float32))))
    th_j = jot.sga_threshold(lr)
    th_t = ot.sga_threshold(torch.tensor(lr, dtype=torch.float32))
    _eq(th_t, th_j)
    for got, want in zip(ot.sga_step(torch.tensor(g), torch.tensor(a), th_t),
                         jot.sga_step(jnp.asarray(g), jnp.asarray(a), th_j)):
        _eq(got, want)


@pytest.mark.parametrize("epoch", [0, 13, 35])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_epoch_grads_and_apply_update_match(name, epoch):
    jcfg, tcfg = _pair(**CONFIGS[name])
    feats, labels, w0, b0 = _head_inputs(epoch)
    js, jf, jo = jot.finetune_init(jnp.asarray(feats), jnp.asarray(labels),
                                   jnp.asarray(w0), jnp.asarray(b0), jcfg)
    ts, tf, to = ot.finetune_init(feats, labels, w0, b0, tcfg,
                                  device="cpu")
    # a banked state, so the SGA release path is exercised
    rng = np.random.default_rng(epoch + 100)
    acc = np.asarray(jq.ACCUM_Q.quantize(jnp.asarray(
        rng.uniform(-0.2, 0.2, (D, C)).astype(np.float32))))
    js = js._replace(accum_w=jnp.asarray(acc))
    ts = ts._replace(accum_w=torch.tensor(acc))
    jg = jot.epoch_grads(js, jnp.int32(epoch), jf, jo, jcfg)
    tg = ot.epoch_grads(ts, epoch, tf, to, tcfg)
    for got, want in zip(tg[:3], jg[:3]):
        _eq(got, want)
    jn = jot.apply_update(js, *jg, jcfg)
    tn = ot.apply_update(ts, *tg, tcfg)
    for got, want in zip(tn[:4], jn[:4]):
        _eq(got, want)


@pytest.mark.parametrize("kw", [dict(epochs=23),
                                dict(epochs=200, fixed_error_scale=1.375)],
                         ids=["dynamic-23", "fixed-1.375-200"])
def test_quantized_head_finetune_matches(kw):
    jcfg, tcfg = _pair(**kw)
    feats, labels, w0, b0 = _head_inputs(11)
    jw, jb = jot.quantized_head_finetune(
        jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(w0),
        jnp.asarray(b0), jcfg)
    tw, tb = ot.quantized_head_finetune(feats, labels, w0, b0, tcfg,
                                        device="cpu")
    _eq(tw, jw)
    _eq(tb, jb)
    # the run moved the head, and accuracy agrees
    assert not np.array_equal(tw.numpy(), np.asarray(jq.WEIGHT_Q.quantize(
        jnp.asarray(w0))))
    assert float(ot.head_accuracy(torch.tensor(feats),
                                  torch.tensor(labels), tw, tb, tcfg)) == \
        float(jot.head_accuracy(jnp.asarray(feats), jnp.asarray(labels),
                                jw, jb, jcfg))


def test_finetune_epochs_chunked_equals_one_run():
    cfg = ot.OnChipTrainConfig(epochs=30)
    feats, labels, w0, b0 = _head_inputs(12)
    st, fq, oh = ot.finetune_init(feats, labels, w0, b0, cfg, device="cpu")
    one = ot.finetune_epochs(st, fq, oh, cfg, 0, 30)
    chunked = st
    for start, n in ((0, 7), (7, 7), (14, 10), (24, 6)):
        chunked = ot.finetune_epochs(chunked, fq, oh, cfg, start, n)
    for a, b in zip(one[:4], chunked[:4]):
        assert torch.equal(a, b)
    w, b = ot.quantized_head_finetune(feats, labels, w0, b0, cfg,
                                      device="cpu")
    assert torch.equal(w, one.w) and torch.equal(b, one.b)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_channel_offsets_and_compensated_bias_match(seed):
    """Counts (N, T, C) as the test mode digitizes them, a chip offset of
    std 4, a mapped bias: the estimate within 1e-5 (float sum order), the
    compensated integer biases bitwise."""
    rng = np.random.default_rng(seed)
    n, t, c = 5, 150, 96
    ideal = (rng.integers(-36, 37, (n, t, c)) * 2).astype(np.float32)
    off = (4.0 * rng.normal(size=c)).astype(np.float32)
    bias = (rng.integers(-20, 21, c) * 2).astype(np.float32)
    measured_j = jnp.asarray(ideal) + jnp.asarray(off)
    est_j = jcomp.estimate_channel_offsets(jnp.asarray(ideal), measured_j)
    ideal_t = torch.tensor(ideal)
    est_t = compensation.estimate_channel_offsets(
        ideal_t, ideal_t + torch.tensor(off))
    np.testing.assert_allclose(est_t.numpy(), np.asarray(est_j), rtol=0,
                               atol=1e-5)
    _eq(compensation.compensate_bias(torch.tensor(bias), est_t),
        jcomp.compensate_bias(jnp.asarray(bias), est_j))
    # the layer step the sessions run, at zero read noise
    _eq(tr.compensate_layer_bias(torch.tensor(bias), ideal_t,
                                 torch.tensor(off), sa_noise_std=0.0),
        jcomp.compensate_bias(jnp.asarray(bias), est_j))


def test_noise_and_rgp_raise_naming_the_prng():
    """The draws that raised until the PRNG was ported now equal the
    reference's: an ``rgp=True`` fine-tune and a compensation step with
    read noise."""
    feats, labels, w0, b0 = _head_inputs(0, n=4)
    w, b = ot.quantized_head_finetune(
        feats, labels, w0, b0, ot.OnChipTrainConfig(epochs=6, rgp=True,
                                                    seed=2), device="cpu")
    wj, bj = jot.quantized_head_finetune(
        jnp.asarray(feats), jnp.asarray(labels), jnp.asarray(w0),
        jnp.asarray(b0), jot.OnChipTrainConfig(epochs=6, rgp=True, seed=2))
    _eq(w, wj)
    _eq(b, bj)
    rng = np.random.default_rng(1)
    ideal = rng.integers(-20, 20, (2, 3, 4)).astype(np.float32)
    off = (4.0 * rng.normal(size=4)).astype(np.float32)
    jkey = jax.random.PRNGKey(6)
    got = tr.compensate_layer_bias(
        torch.zeros(4), torch.tensor(ideal), torch.tensor(off),
        jaxrand.key_from_numpy(np.asarray(jkey), "cpu"), sa_noise_std=1.0)
    want = jtr.compensate_layer_bias(jnp.zeros(4), jnp.asarray(ideal),
                                     jnp.asarray(off), jkey, 1.0)
    _eq(got, want)
