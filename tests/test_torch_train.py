"""The port's QAT training loop (``repro_torch.training.kws.train_base``)
and ``evaluate`` against the JAX package's, on the CPU, on
``make_gscd_like`` traffic at a tiny config: 600-sample windows and three
conv layers (the sinc layer and two IMC layers, one of them grouped),
narrow, because compiling the reference's training step dominates the
file's time and grows with the layers.

The batches (numpy ``default_rng``), the noise keys (``jaxrand``) and the
initial net (``init_params`` from the same key) are the reference's, and
the fixed normalization's running statistics are pinned, so the state is
bitwise, and so are the losses' first digits.  The parameters are not.
Gradients differ by float32 sum order (``tests/test_torch_learning.py``:
on the soft phase at initialization the reference's own float32 gradient
lies up to ~4e-3 of its scale from the float64 one), and Adam divides each
element's step by its own gradient's scale: an element whose gradient is
rounding noise steps by about the learning rate either way, in both
packages alike.  So the parameters are held by share: 95% of the elements
within 1e-4 of their value plus 1e-5, and every element within two
learning rates a step.  The hard phases are held one step at a time from
identical parameters, because one ulp can flip a sign there and the nets
part.  Runs: six soft steps (alpha 2), clean and as the noise-aware
recovery fine-tune (chip offsets of std 4, SA noise 1.0); one hard
surrogate-gradient step (alpha -5) of the recovery fine-tune from the
reference's soft-trained net.  ``evaluate`` of one net is the
reference's exactly (bitwise logits).
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import audio as jaudio
from repro.models import kws as jkws
from repro.training import kws as jtr
from repro_torch.data import audio
from repro_torch.models import kws
from repro_torch.training import kws as tr

SMALL = dict(sample_len=600, channels=(8, 16, 32), kernels=(15, 3, 3),
             strides=(4, 1, 1), pools=(1, 2, 2), channels_per_group=8)
JCFG = jkws.KWSConfig(**SMALL)
CFG = kws.KWSConfig(**SMALL)


@pytest.fixture(scope="module")
def data():
    (xtr, ytr), (xte, yte) = audio.make_gscd_like(
        seed=3, train_per_class=2, test_per_class=2, length=600)
    return xtr[:12], ytr[:12], xte, yte


SOFT = dict(epochs=2, batch_size=4, alpha_schedule=((1.0, 2.0),), seed=3,
            log_every=1)


def _jax_train(xtr, ytr, tcfg, offs, std, params=None):
    """The reference's train_base, and its per-step losses (printed every
    step to 4 decimals)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = jtr.train_base(
            xtr, ytr, JCFG, tcfg, params=params,
            chip_offsets=(None if offs is None
                          else {k: jnp.asarray(v) for k, v in offs.items()}),
            sa_noise_std=std, verbose=True)
    return out, [float(v) for v in re.findall(r"loss ([0-9.]+)",
                                               buf.getvalue())]


@pytest.fixture(scope="module")
def soft_runs(data):
    """The reference's six soft steps, clean and as the recovery
    fine-tune: {name: ((params, state), losses)}."""
    return {"clean": _jax_train(data[0], data[1], jtr.TrainConfig(**SOFT),
                                None, 0.0),
            "recovery": _jax_train(data[0], data[1],
                                   jtr.TrainConfig(**SOFT), _offsets(),
                                   1.0)}


def _offsets():
    rng = np.random.default_rng(11)
    return {f"conv{i}": (rng.normal(size=CFG.channels[i]) * 4).astype(
        np.float32) for i in range(1, CFG.num_conv_layers)}


def test_port_data_is_the_references(data):
    (jx, jy), (jxe, jye) = jaudio.make_gscd_like(
        seed=3, train_per_class=2, test_per_class=2, length=600)
    np.testing.assert_array_equal(data[0], jx[:12])
    np.testing.assert_array_equal(data[1], jy[:12])
    np.testing.assert_array_equal(data[2], jxe)


def test_alpha_schedule_and_batches():
    for epochs in (1, 2, 5, 30):
        t = tr.TrainConfig(epochs=epochs)
        j = jtr.TrainConfig(epochs=epochs)
        assert [tr._alpha_at(t, e) for e in range(epochs)] == \
            [jtr._alpha_at(j, e) for e in range(epochs)]
    x, y = np.arange(26.0)[:, None], np.arange(26)
    got = list(tr._batches(x, y, 4, np.random.default_rng(5)))
    want = list(jtr._batches(x, y, 4, np.random.default_rng(5)))
    assert len(got) == len(want) == 6
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def _check_params(tp, jp, share):
    """All but ``share`` of the elements within 1e-4 of their value plus
    1e-5; every element within Adam's reach of two learning rates a
    step."""
    off = total = 0
    for n in jp:
        for k in jp[n]:
            want, got = np.asarray(jp[n][k]), tp[n][k].numpy()
            d = np.abs(got - want)
            off += int(np.sum(d > 1e-4 * np.abs(want) + 1e-5))
            total += want.size
            assert d.max() <= 2 * 0.01 * 6, f"{n}.{k}"
    assert off <= share * total, (off, total)


def _check_state(ts, js):
    for name in js.mean:
        np.testing.assert_array_equal(ts.mean[name].numpy(),
                                      np.asarray(js.mean[name]))
        np.testing.assert_array_equal(ts.var[name].numpy(),
                                      np.asarray(js.var[name]))


@pytest.mark.parametrize("name", ["clean", "recovery"])
def test_train_base_soft_phase_matches_reference(data, soft_runs, name):
    """Six steps of the soft phase (two epochs of three batches): the
    losses step by step within rtol 1e-3 (max seen 4e-4), the state
    bitwise, 95% of the parameters within 1e-4 + 1e-5 (seen at the
    paper's widths, ``sample_len=600``: all but 3.9% clean, all but 0.05%
    as the recovery fine-tune; at this config: all of them)."""
    (jp, js), jloss = soft_runs[name]
    offs = _offsets() if name == "recovery" else None
    hist = []
    tp, ts = tr.train_base(data[0], data[1], CFG, tr.TrainConfig(**SOFT),
                           chip_offsets=offs,
                           sa_noise_std=0.0 if offs is None else 1.0,
                           verbose=False, history=hist, device="cpu")
    assert [h["alpha"] for h in hist] == [2.0] * 6
    np.testing.assert_allclose([float(h["loss"]) for h in hist], jloss,
                               rtol=1e-3)
    _check_state(ts, js)
    _check_params(tp, jp, 0.05)


def test_train_base_hard_step_matches_reference(data, soft_runs):
    """One step of the hard surrogate-gradient phase of the recovery
    fine-tune from identical parameters (the reference's after the soft
    steps), at a constant learning rate of 0.01: the loss within rtol
    1e-3, the state bitwise, 95% of the parameters within 1e-4 + 1e-5
    (seen: all but 1%)."""
    xtr, ytr = data[0], data[1]
    offs = _offsets()
    (jp0, js0), _ = soft_runs["recovery"]
    hard = dict(epochs=1, batch_size=12, alpha_schedule=((1.0, -5.0),),
                seed=4, lr=0.01, lr_min=0.01, log_every=1)
    (jp, js), jloss = _jax_train(xtr, ytr, jtr.TrainConfig(**hard), offs,
                                 1.0, params=jp0)
    tp0, ts0 = kws.params_from_numpy(
        {n: {k: np.asarray(v) for k, v in d.items()}
         for n, d in jp0.items()}, js0, device="cpu")
    hist = []
    tp, ts = tr.train_base(xtr, ytr, CFG, tr.TrainConfig(**hard),
                           params=tp0, state=ts0, chip_offsets=offs,
                           sa_noise_std=1.0, verbose=False, history=hist,
                           device="cpu")
    np.testing.assert_allclose([float(h["loss"]) for h in hist], jloss,
                               rtol=1e-3)
    _check_state(ts, js)
    _check_params(tp, jp, 0.05)


def test_evaluate_matches_reference(data, monkeypatch):
    params = jkws.init_params(jax.random.PRNGKey(4), JCFG)
    state = jkws.init_state(JCFG)
    xte, yte = data[2], data[3]
    want = jtr.evaluate(params, state, xte, yte, JCFG, batch=8)
    tp, ts = kws.params_from_numpy(
        {n: {k: np.asarray(v) for k, v in d.items()}
         for n, d in params.items()}, state, device="cpu")
    assert tr.evaluate(tp, ts, xte, yte, CFG, batch=8, device="cpu") == want
    # the device rule: None means CUDA, which this machine lacks
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.evaluate(tp, ts, xte, yte, CFG, batch=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.train_base(data[0], data[1], CFG, tr.TrainConfig(epochs=1),
                      verbose=False)
