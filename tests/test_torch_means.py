"""The port's means against the JAX package, on the CPU, bit for bit, at
the smallest inputs where an IEEE quotient and the reference's mean round
apart (``tests/_mean_cases.py``), and the VAD's level.

XLA compiles ``jnp.mean`` and a jitted ``x / n`` into the sum times the
float32 reciprocal of n; the port computes its means the same way
(``repro_torch.core.means``).  Held here: the GAP at T = 448 through the
three places the port takes it (``models.kws.gap_fc``,
``serving.stream._ring_logits`` with and without per-stream heads, and a
customization session's feature capture); the head's batch-mean gradients
at N = 7 on the per-epoch route (``epoch_grads`` then the SGA update) and
the fused route (``head_train_rows``' plain version), against the
reference's jitted loop; the compensation's mean on integer
discrepancies; and ``VADState.level_db`` over 4096 random hops at hops
1024, 192 and 320 against the reference's jitted ``vad_step`` (the port
sums in XLA's order and uses XLA's float32 log and FMAs).
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compensation as jcomp
from repro.core import onchip_training as jot
from repro.models import kws as jkws
from repro.serving import stream as jsv
from repro.serving import vad as jvad
from repro_torch.core import compensation, means
from repro_torch.core import onchip_training as ot
from repro_torch.core.quantize import ACT_Q
from repro_torch.kernels.sga_update import ops as sga_ops
from repro_torch.models import kws
from repro_torch.serving import stream as sv
from repro_torch.serving import vad
from repro_torch.serving.customize import capture_features

from _mean_cases import (GAP_FEAT0, HEAD_GW10, gap_head, gap_tie_ring,
                         head_tie_case)


def _eq(port, ref):
    np.testing.assert_array_equal(port.detach().numpy(), np.asarray(ref))


def _final_length(cfg):
    t = cfg.sample_len
    for i in range(cfg.num_conv_layers):
        t = ((t - cfg.kernels[i]) // cfg.strides[i] + 1) // cfg.pools[i]
    return t


def test_paper_net_reaches_the_tie_length():
    """The T = 448 ring is the paper net's at windows of 28835-28898
    samples, and at no window just outside them."""
    for n, t in ((28835, 448), (28898, 448), (28834, 447), (28899, 449)):
        assert _final_length(kws.KWSConfig(sample_len=n)) == t


def test_reciprocal_is_the_float32_quotient():
    for n in (1, 6, 7, 448, 1024, 192, 320):
        assert means.reciprocal(n) == float(np.float32(1) / np.float32(n))
    x = torch.tensor(gap_tie_ring()[:, :, :4])
    _eq(means.mean(x, 1), x.sum(dim=1) * means.reciprocal(448))
    _eq(means.mean(x, (0, 1)), x.sum(dim=(0, 1)) * means.reciprocal(448))


def test_gap_tie_at_every_gap_site():
    ring = gap_tie_ring(batch=2)
    w, b = gap_head()
    # the input is a tie: the IEEE quotient rounds the other way
    assert float(ACT_Q.quantize(torch.tensor(ring[0, :, 0]).sum() / 448)) \
        == 0.375
    jhw = jkws.HWParams(w_bin={}, bias={}, flip={}, fc_w=jnp.asarray(w),
                        fc_b=jnp.asarray(b))
    hw = kws.HWParams(w_bin={}, bias={}, flip={}, fc_w=torch.tensor(w),
                      fc_b=torch.tensor(b))
    logits, feats = kws.gap_fc(hw, torch.tensor(ring))
    assert float(feats[0, 0]) == GAP_FEAT0 and float(feats[1, 0]) == GAP_FEAT0
    jlogits, jfeats = jsv._gap_fc(jhw, jnp.asarray(ring))
    _eq(feats, jfeats)
    _eq(logits, jlogits)
    _eq(sv._ring_logits(hw, torch.tensor(ring), None, None),
        jsv._ring_logits(jhw, jnp.asarray(ring), None, None))
    rng = np.random.default_rng(3)
    hw_b = (np.round(rng.normal(size=(2, 576, 10)) * 5) / 128).astype(
        np.float32)
    hb_b = (np.round(rng.normal(size=(2, 10)) * 5) / 128).astype(np.float32)
    _eq(sv._ring_logits(hw, torch.tensor(ring), torch.tensor(hw_b),
                        torch.tensor(hb_b)),
        jsv._ring_logits(jhw, jnp.asarray(ring), jnp.asarray(hw_b),
                         jnp.asarray(hb_b)))
    cap = capture_features(torch.tensor(ring[0]))
    assert float(cap[0]) == GAP_FEAT0
    # the reference's capture (serving/customize.py): the same expression
    _eq(cap, jkws.ACT_Q.quantize(jnp.mean(jnp.asarray(ring[0]), axis=0)))


def _tie_heads(epochs):
    """The N = 7 head after ``epochs`` epochs: the reference's jitted loop
    and the port's per-epoch and fused routes (CPU)."""
    feats, labels, w, b = head_tie_case()
    jcfg, tcfg = jot.OnChipTrainConfig(), ot.OnChipTrainConfig()
    js, jf, jo = jot.finetune_init(jnp.asarray(feats), jnp.asarray(labels),
                                   jnp.asarray(w), jnp.asarray(b), jcfg)
    want = jax.jit(lambda s: jot.finetune_epochs(s, jf, jo, jcfg, 0,
                                                 epochs))(js)
    ts, tf, to = ot.finetune_init(feats, labels, w, b, tcfg, device="cpu")
    per_epoch = ts
    for e in range(epochs):
        gw, gb, lr, _ = ot.epoch_grads(per_epoch, e, tf, to, tcfg)
        th = ot.sga_threshold(lr)
        flat = lambda t: t.reshape(1, -1)
        nw, naw = sga_ops.sga_update_batch(
            flat(torch.cat([per_epoch.w.reshape(-1), per_epoch.b])),
            flat(torch.cat([gw.reshape(-1), gb])),
            flat(torch.cat([per_epoch.accum_w.reshape(-1),
                            per_epoch.accum_b])),
            lr.reshape(1), th.reshape(1))
        d = per_epoch.w.numel()
        per_epoch = per_epoch._replace(
            w=nw[0, :d].reshape(per_epoch.w.shape), b=nw[0, d:],
            accum_w=naw[0, :d].reshape(per_epoch.w.shape),
            accum_b=naw[0, d:])
    fw, fb = ts.w.clone(), ts.b.clone()
    faw, fab = ts.accum_w.clone(), ts.accum_b.clone()
    sga_ops.head_train_batch([fw], [fb], [faw], [fab], [tf], [to], [0],
                             [epochs], ot.train_lut(tf.device),
                             ot.head_train_spec(tcfg))
    return want, per_epoch, (fw, fb, faw, fab)


def test_head_tie_gradient_is_the_reciprocal_product():
    feats, labels, w, b = head_tie_case()
    jcfg, tcfg = jot.OnChipTrainConfig(), ot.OnChipTrainConfig()
    js, jf, jo = jot.finetune_init(jnp.asarray(feats), jnp.asarray(labels),
                                   jnp.asarray(w), jnp.asarray(b), jcfg)
    jg = jax.jit(lambda s, e: jot.epoch_grads(s, e, jf, jo, jcfg))(
        js, jnp.int32(0))
    ts, tf, to = ot.finetune_init(feats, labels, w, b, tcfg, device="cpu")
    tg = ot.epoch_grads(ts, 0, tf, to, tcfg)
    assert float(tg[0][1, 0]) == HEAD_GW10
    for got, want in zip(tg[:3], jg[:3]):
        _eq(got, want)


@pytest.mark.parametrize("epochs", [1, 30])
def test_head_tie_on_both_routes_equals_the_reference(epochs):
    want, per_epoch, fused = _tie_heads(epochs)
    if epochs == 1:
        # gw[1, 0] is below the SGA threshold (1/16): it is banked
        assert float(per_epoch.accum_w[1, 0]) == HEAD_GW10
        assert float(fused[2][1, 0]) == HEAD_GW10
    for got in (per_epoch[:4], fused):
        for g, w_ in zip(got, want[:4]):
            _eq(g, w_)


def test_channel_offsets_on_integer_discrepancies():
    """Integer discrepancies sum exactly in any order, so the estimate is
    the reference's bit for bit: the sum times the float32 reciprocal of
    the row count (7 and 448 rows, which have no exact reciprocal)."""
    rng = np.random.default_rng(7)
    for rows in (7, 448):
        ideal = rng.integers(-40, 40, (rows, 24)).astype(np.float32)
        noisy = ideal + rng.integers(-9, 10, (rows, 24)).astype(np.float32)
        est_t = compensation.estimate_channel_offsets(torch.tensor(ideal),
                                                      torch.tensor(noisy))
        est_j = jcomp.estimate_channel_offsets(jnp.asarray(ideal),
                                               jnp.asarray(noisy))
        _eq(est_t, est_j)
        bias = (rng.integers(-32, 33, 24) * 2).astype(np.float32)
        _eq(compensation.compensate_bias(torch.tensor(bias), est_t),
            jcomp.compensate_bias(jnp.asarray(bias), est_j))


@pytest.mark.parametrize("hop", [1024, 192, 320])
def test_vad_level_is_the_references(hop):
    """``level_db`` and the speech flags over 4096 random hops (std 0.1,
    scaled per row by up to 1e-6 so quiet rows reach the epsilon), four
    steps with a random active mask, against the jitted ``vad_step``."""
    vcfg = jvad.VADConfig()
    step = jax.jit(lambda s, a, m: jvad.vad_step(vcfg, s, a, m))
    rng = np.random.default_rng(0)
    js, ts = jvad.vad_init(4096), vad.vad_init(4096)
    for _ in range(4):
        audio = (rng.normal(0, 0.1, (4096, hop))
                 * rng.uniform(1e-6, 1.0, (4096, 1))).astype(np.float32)
        act = rng.random(4096) < 0.8
        js, jflags = step(js, jnp.asarray(audio), jnp.asarray(act))
        ts, tflags = vad.vad_step(vad.VADConfig(), ts, torch.tensor(audio),
                                  torch.tensor(act))
        _eq(ts.level_db, js.level_db)
        _eq(tflags, jflags)
        _eq(ts.hang, js.hang)


def test_frame_energy_is_the_compiled_steps():
    """The first level of a stream is the hop's energy in dB, as the
    reference's compiled step computes it."""
    vcfg = jvad.VADConfig()
    audio = np.random.default_rng(1).normal(0, 0.05, (64, 320)).astype(
        np.float32)
    js, _ = jax.jit(lambda s, a: jvad.vad_step(vcfg, s, a))(
        jvad.vad_init(64), jnp.asarray(audio))
    _eq(vad.frame_energy_db(torch.tensor(audio)), js.level_db)
