"""The hardware half of the learning path on the port against the JAX
package, on the CPU: ``evaluate_hw`` / ``hw_features`` over
``_hw_batched`` in every noise mode (a ragged last chunk included),
``calibrate_layerwise``, the chip report's power, operations, TOPS/W and
breakdown, the area figures and bias-mapping methods, and the paper's
pipeline as ``tests/test_system.py`` runs it
(fold -> noisy evaluation -> compensation -> evaluation -> features ->
quantized head fine-tune -> head accuracy), step by step.

Tolerances: none but one.  Logits, features, accuracies, compensated
biases, heads and report numbers are compared bitwise (``==``).
``calibrate_layerwise``'s float estimate on noisy counts is held to 1e-5
(its mean sums in the port's order, the reference's in XLA's; on integer
discrepancies it is bitwise, and the biases it rounds into are equal).
Small config: ``sample_len=640``; the net is the port's
``init_params(PRNGKey(5))``, untrained, carried to JAX as numpy leaves
(``test_torch_noise.jax_hw``); no training runs in this file.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compensation as jcomp
from repro.core import energy as jenergy
from repro.core import imc as jimc
from repro.core import onchip_training as jot
from repro.data import audio as jaudio
from repro.models import kws as jkws
from repro.training import kws as jtr
from repro_torch.core import compensation, energy, imc, jaxrand, sa_noise
from repro_torch.core import onchip_training as ot
from repro_torch.data import audio
from repro_torch.models import kws
from repro_torch.training import kws as tr
from test_torch_noise import CHANS, jax_hw

L = 640
CFG = kws.KWSConfig(sample_len=L)
JCFG = jkws.KWSConfig(sample_len=L)


def _bits(a, b, what=""):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, f"{what}: {a.shape} != {b.shape}"
    np.testing.assert_array_equal(a.view(np.uint32) if a.dtype == np.float32
                                  else a,
                                  b.view(np.uint32) if b.dtype == np.float32
                                  else b, err_msg=what)


@pytest.fixture(scope="module")
def nets():
    params = kws.init_params(jaxrand.PRNGKey(5, device="cpu"), CFG,
                             device="cpu")
    hw_t = kws.fold_params(params, kws.init_state(CFG, device="cpu"), CFG,
                           pack=True)
    noise = dict(mav_offset_std=8.0, sa_noise_std=1.0)
    chip_j = jimc.sample_chip_offsets(jax.random.PRNGKey(11), CHANS,
                                      jimc.IMCNoiseParams(**noise))
    chip_t = imc.sample_chip_offsets(jaxrand.PRNGKey(11, "cpu"), CHANS,
                                     imc.IMCNoiseParams(**noise))
    for name in chip_j:
        _bits(chip_t[name], chip_j[name], name)
    return jax_hw(hw_t), hw_t, chip_j, chip_t


@pytest.fixture(scope="module")
def windows():
    rng = np.random.default_rng(3)
    x = (np.round(rng.uniform(-1, 1, (7, L)) * 127) / 127).astype(
        np.float32)
    return x, rng.integers(0, CFG.num_classes, 7)


def test_signatures_keep_the_reference_defaults():
    for name in ("evaluate_hw", "hw_features"):
        got = inspect.signature(getattr(tr, name)).parameters
        want = inspect.signature(getattr(jtr, name)).parameters
        assert list(got)[:len(want)] == list(want)
        for p in want:
            if p != "cfg":
                assert got[p].default == want[p].default, (name, p)
        assert got["cfg"].default == kws.PAPER_KWS
        assert got["device"].default is None     # None means CUDA
    assert got["use_kernel"].default is False and got["batch"].default == 200


def test_hw_batched_clean_matches_jax(nets, windows):
    """Logits of ``_hw_batched`` on both routes (the fused layer's plain
    version and the unfused chain), 7 windows in chunks of 3 (a ragged
    last chunk of 1), equal the reference's ``_hw_batched`` bit for bit,
    and ``evaluate_hw``'s accuracy is the reference's over them (numpy on
    the host, as the reference takes it)."""
    hw_j, hw_t, _, _ = nets
    x, y = windows
    kw = dict(chip_offsets=None, sa_noise_std=0.0, seed=0, batch=3,
              sa_noise_field=None)
    want = jtr._hw_batched(hw_j, x, JCFG, 0, use_kernel=False, **kw)
    for use_kernel in (False, True):
        got = tr._hw_batched(hw_t, x, CFG, 0, use_kernel=use_kernel,
                             device="cpu", **kw)
        _bits(got, want, f"logits, kernel {use_kernel}")
    acc = tr.evaluate_hw(hw_t, x, y, CFG, batch=3, use_kernel=True,
                         device="cpu")
    assert acc == float(np.mean(np.argmax(want, -1) == np.asarray(y)))
    assert type(acc) is float


@pytest.mark.parametrize("mode", ["fresh", "field"])
def test_hw_batched_noise_rides_its_chunks(nets, windows, mode):
    """The noise of each chunk is the reference's: fresh draws take the
    keys of ``jax.random.split``'s chain from ``PRNGKey(seed)``, one per
    chunk (computed by JAX here), a field's rows ride their slice.  Held
    against ``hw_forward`` per chunk (its rng and field forms are held
    bitwise to the JAX package in ``test_torch_noise.py``) on both
    routes; 3 windows in chunks of 2 leave a ragged chunk of 1, whose
    fresh draw has its own shape.  (The noise draw is the costly part of
    these forwards on the CPU, so the windows are few.)"""
    _, hw_t, _, chip_t = nets
    x, batch = windows[0][:3], 2
    chunks = [slice(i, i + batch) for i in range(0, len(x), batch)]
    if mode == "fresh":
        kw = dict(chip_offsets=chip_t, sa_noise_std=1.0, seed=4)
        key, subs = jax.random.PRNGKey(4), []
        for _ in chunks:
            key, sub = jax.random.split(key)
            subs.append(jaxrand.key_from_numpy(np.asarray(sub), "cpu"))
        per_chunk = [dict(chip_offsets=chip_t, sa_noise_std=1.0, rng=k)
                     for k in subs]
    else:
        field = sa_noise.SANoiseField(
            jaxrand.key_from_numpy(np.asarray(jax.random.split(
                jax.random.PRNGKey(13), len(x))), "cpu"),
            torch.tensor([0, 9, 5]), 1.0, 64)
        kw = dict(chip_offsets=chip_t, sa_noise_field=field)
        per_chunk = [dict(chip_offsets=chip_t, sa_noise_field=field._replace(
            keys=field.keys[c], hops=field.hops[c])) for c in chunks]
    want = torch.cat([kws.hw_forward(hw_t, x[c], CFG, device="cpu",
                                     **k)[0]
                      for c, k in zip(chunks, per_chunk)])
    for use_kernel in (False, True):
        got = tr._hw_batched(hw_t, x, CFG, 0, batch=batch,
                             use_kernel=use_kernel, device="cpu",
                             **{"chip_offsets": None, "sa_noise_std": 0.0,
                                "seed": 0, "sa_noise_field": None, **kw})
        _bits(got, want.numpy(), f"{mode} logits, kernel {use_kernel}")


def test_hw_batched_rejects_what_the_reference_rejects(nets, windows):
    _, hw_t, _, _ = nets
    x, y = windows
    field = sa_noise.SANoiseField(jaxrand.split(jaxrand.PRNGKey(1, "cpu"),
                                                len(x)),
                                  torch.zeros(len(x), dtype=torch.int64),
                                  1.0, 64)
    with pytest.raises(ValueError, match="either sa_noise_std or"):
        tr.evaluate_hw(hw_t, x, y, CFG, sa_noise_std=1.0,
                       sa_noise_field=field, device="cpu")
    with pytest.raises(ValueError, match="rows"):
        tr.hw_features(hw_t, x[:3], CFG, sa_noise_field=field, device="cpu")
    with pytest.raises(ValueError, match="not on"):
        tr.evaluate_hw(hw_t, x, y, CFG, device="meta")


@pytest.mark.parametrize("noisy", [False, True])
def test_calibrate_layerwise_matches_jax(nets, noisy):
    """``calibrate_layerwise`` calls ``layer_counts_fn(True)`` (the
    chip), then ``(False)`` (ideal), as the reference does; the estimates
    on integer discrepancies are bitwise, on noisy ones within 1e-5, and
    the biases they round into are equal."""
    hw_j, hw_t, chip_j, chip_t = nets
    x = np.random.default_rng(5).uniform(-1, 1, (2, L)).astype(np.float32)
    ideal_t = tr.calibration_ideal_counts(hw_t, x, CFG, device="cpu")
    ideal_j = jtr.calibration_ideal_counts(hw_j, x, JCFG)
    ideal_t = {n: ideal_t[n] for n in CHANS}     # the IMC layers
    ideal_j = {n: ideal_j[n] for n in CHANS}
    calls = []

    def make(ideal, offs, normal):
        def fn(chip):
            calls.append(chip)
            if not chip:
                return ideal
            return {n: ideal[n] + offs[n] + (normal(n, ideal[n].shape)
                                             if noisy else 0.0)
                    for n in ideal}
        return fn

    keys = tr.calibration_layer_keys(CFG, 7, device="cpu")
    noise = {n: jaxrand.normal(keys[n], tuple(ideal_t[n].shape))
             for n in CHANS}                     # the read noise, shared
    if not noisy:                                # integer discrepancies
        chip_t = {n: torch.round(v) for n, v in chip_t.items()}
        chip_j = {n: jnp.round(v) for n, v in chip_j.items()}
    est_t = compensation.calibrate_layerwise(make(
        ideal_t, chip_t, lambda n, s: noise[n]))
    est_j = jcomp.calibrate_layerwise(make(
        ideal_j, chip_j, lambda n, s: jnp.asarray(noise[n].numpy())))
    assert calls == [True, False, True, False]
    assert sorted(est_t) == sorted(est_j) == list(CHANS)
    for name in est_j:
        if noisy:
            np.testing.assert_allclose(est_t[name].numpy(),
                                       np.asarray(est_j[name]), rtol=0,
                                       atol=1e-5)
        else:
            _bits(est_t[name], est_j[name], name)
        _bits(compensation.compensate_bias(hw_t.hw.bias[name], est_t[name]),
              jcomp.compensate_bias(hw_j.bias[name], est_j[name]), name)


@pytest.mark.parametrize("sample_len", [L, 16000])
def test_chip_report_matches_jax(sample_len):
    """``power_w``, ``total_ops``, ``tops_per_w`` and ``breakdown`` of the
    report built from the model's layer stats: the reference's floats, bit
    for bit (the full-width row is the paper's 14 uJ/decision)."""
    got = energy.kws_chip_report(kws.layer_stats(
        kws.KWSConfig(sample_len=sample_len)))
    want = jenergy.kws_chip_report(jkws.layer_stats(
        jkws.KWSConfig(sample_len=sample_len)))
    assert got.power_w == want.power_w
    assert got.total_ops == want.total_ops
    assert got.tops_per_w == want.tops_per_w
    assert got.breakdown() == want.breakdown()
    assert got.energy_j_per_decision == want.energy_j_per_decision
    assert abs(sum(got.breakdown().values()) - 1.0) < 1e-12
    streamed = energy.kws_streaming_report(kws.layer_stats(CFG))
    assert streamed.power_w == jenergy.kws_streaming_report(
        jkws.layer_stats(JCFG)).power_w


def test_area_figures_and_bias_methods_match_jax():
    """The paper's area figures (``energy.AREA_MM2``, ``AREA_FRAC``,
    ``TRAIN_AREA_FRAC``) and ``imc.BIAS_MAPPING_METHODS`` are the
    reference's values, and ``map_bias`` takes every listed method as the
    reference's does, bit for bit."""
    assert energy.AREA_MM2 == jenergy.AREA_MM2
    assert energy.AREA_FRAC == jenergy.AREA_FRAC
    assert energy.TRAIN_AREA_FRAC == jenergy.TRAIN_AREA_FRAC
    assert imc.BIAS_MAPPING_METHODS == jimc.BIAS_MAPPING_METHODS
    bias = np.linspace(-70.0, 70.0, 57, dtype=np.float32)
    for method in imc.BIAS_MAPPING_METHODS:
        np.testing.assert_array_equal(
            imc.map_bias(torch.tensor(bias), method).numpy(),
            np.asarray(jimc.map_bias(jnp.asarray(bias), method)))


def test_system_pipeline_matches_jax(nets):
    """``tests/test_system.py``'s sequence, on the same data, through both
    packages: the clean, noisy and compensated accuracies, the
    compensated biases, the personal-set accuracy, the hardware features,
    the fine-tuned head and its accuracies are equal, bit for bit.  The
    JAX side evaluates as the reference's ``evaluate_hw`` /
    ``hw_features`` do (one chunk: the forward under ``jit`` with the key
    split once from ``PRNGKey(0)``, the accuracy in numpy), through one
    jitted clean and one jitted noisy forward that take the parameters
    as arguments, so that its compiles are shared; every clean set has 30
    windows, the noisy evaluations and the calibration take 6 (the noise
    draw is the costly part of a forward on the CPU)."""
    hw_j, hw_t, chip_j, chip_t = nets
    (xtr, ytr), (xte, yte) = audio.make_gscd_like(
        train_per_class=3, test_per_class=3, length=L)
    (jxtr, _), (jxte, _) = jaudio.make_gscd_like(
        train_per_class=3, test_per_class=3, length=L)
    _bits(xtr, jxtr, "train windows")
    _bits(xte, jxte, "test windows")
    hw_t = hw_t.hw                               # test_system's plain fold
    clean_j = jax.jit(lambda hw, x: jkws.hw_forward(hw, x, JCFG))
    noisy_j = jax.jit(lambda hw, x, offs, k: jkws.hw_forward(
        hw, x, JCFG, chip_offsets=offs, sa_noise_std=1.0, rng=k)[0])
    key = jax.random.split(jax.random.PRNGKey(0))[1]

    def acc_j(logits, y):                        # evaluate_hw's accuracy
        return float(np.mean(np.argmax(np.asarray(logits), -1)
                             == np.asarray(y)))

    assert tr.evaluate_hw(hw_t, xte, yte, CFG, device="cpu") == acc_j(
        clean_j(hw_j, xte)[0], yte)
    xn, yn = xte[::5], yte[::5]                 # 6 windows
    assert tr.evaluate_hw(hw_t, xn, yn, CFG, chip_offsets=chip_t,
                          sa_noise_std=1.0, device="cpu") == acc_j(
        noisy_j(hw_j, xn, chip_j, key), yn)
    hw_ct = tr.calibrate_and_compensate(hw_t, xtr[:6], chip_t, CFG,
                                        device="cpu")
    hw_cj = jtr.calibrate_and_compensate(hw_j, xtr[:6], chip_j, JCFG)
    for name in CHANS:
        _bits(hw_ct.bias[name], hw_cj.bias[name], f"compensated {name}")
    assert tr.evaluate_hw(hw_ct, xn, yn, CFG, chip_offsets=chip_t,
                          sa_noise_std=1.0, device="cpu") == acc_j(
        noisy_j(hw_cj, xn, chip_j, key), yn)

    (xp_tr, yp_tr), (xp_te, yp_te) = audio.make_personal(
        train_per_class=1, test_per_class=1, length=L, accent_shift=0.18)
    lj_te, fj_te = clean_j(hw_j, xp_te)
    assert tr.evaluate_hw(hw_t, xp_te, yp_te, CFG, device="cpu") == acc_j(
        lj_te, yp_te)
    ft_tr = (tr.hw_features(hw_t, xp_tr, CFG, device="cpu"),
             clean_j(hw_j, xp_tr)[1])
    ft_te = (tr.hw_features(hw_t, xp_te, CFG, device="cpu"), fj_te)
    _bits(*ft_tr, "personal train features")
    _bits(*ft_te, "personal test features")
    ocfg_t = ot.OnChipTrainConfig(epochs=30, error_scaling=True, sga=True)
    ocfg_j = jot.OnChipTrainConfig(epochs=30, error_scaling=True, sga=True)
    w_t, b_t = ot.quantized_head_finetune(ft_tr[0], yp_tr, hw_t.fc_w,
                                          hw_t.fc_b, ocfg_t, device="cpu")
    w_j, b_j = jot.quantized_head_finetune(ft_tr[1], yp_tr,
                                           np.asarray(hw_j.fc_w),
                                           np.asarray(hw_j.fc_b), ocfg_j)
    _bits(w_t, w_j, "head w")
    _bits(b_t, b_j, "head b")
    for feats, labels in ((ft_te, yp_te), (ft_tr, yp_tr)):
        got = ot.head_accuracy(feats[0], torch.as_tensor(labels), w_t, b_t,
                               ocfg_t)
        want = jot.head_accuracy(feats[1], jnp.asarray(labels), w_j, b_j,
                                 ocfg_j)
        _bits(got, want, "head accuracy")
    codes = w_t.numpy() * 128
    np.testing.assert_array_equal(codes, np.round(codes))
