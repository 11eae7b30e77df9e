"""The port's customization path against the JAX package's offline loop,
on the CPU: the offline pieces themselves, a session without
compensation, two concurrent sessions sharing one fused head-training
launch per tick, ``install_custom`` against a server on the refolded net, and the
calibration read noise (held bitwise: the port draws JAX's numbers).

Bitwise throughout: compensated biases, features and fine-tuned heads.
The compensation's float offset estimate is summed over rows in an order
each library chooses, so it is held to 1e-5 (the largest difference seen
is printed) and the integer biases it rounds into bitwise.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import imc as jimc
from repro.core.onchip_training import OnChipTrainConfig as JTrainConfig
from repro.core.onchip_training import quantized_head_finetune as j_finetune
from repro.models import kws as jkws
from repro.training import kws as jtr
from repro_torch.core.onchip_training import (OnChipTrainConfig,
                                              quantized_head_finetune)
from repro_torch.kernels.sga_update import ops as sga_ops
from repro_torch.models import kws
from repro_torch.serving import CustomizeConfig, StreamServer, VADConfig
from repro_torch.serving import customize as cz
from repro_torch.training import kws as tr

L, HOP = 640, 64
JCFG = jkws.KWSConfig(sample_len=L)
CFG = kws.KWSConfig(sample_len=L)
EPOCHS = 23


@pytest.fixture(scope="module")
def nets():
    params = jkws.init_params(jax.random.PRNGKey(5), JCFG)
    hw_j = jkws.fold_params(params, jkws.init_state(JCFG), JCFG, pack=True)
    hw_t = kws.hw_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, hw_j.hw), CFG, device="cpu")
    chans = {f"conv{i}": JCFG.channels[i]
             for i in range(1, JCFG.num_conv_layers)}
    chip = jax.tree_util.tree_map(np.asarray, jimc.sample_chip_offsets(
        jax.random.PRNGKey(9), chans, jimc.IMCNoiseParams(mav_offset_std=4.0)))
    return hw_j, hw_t, chip


def _utterances(n, seed):
    rng = np.random.default_rng(seed)
    utts = [rng.uniform(-1, 1, L).astype(np.float32) for _ in range(n)]
    labels = [int(rng.integers(0, CFG.num_classes)) for _ in range(n)]
    return utts, labels


def _jax_offline(hw_j, chip, recorded, labels, compensate=True,
                 epochs=EPOCHS):
    offs = {k: jnp.asarray(v) for k, v in chip.items()}
    hw_c = (jtr.calibrate_and_compensate(hw_j, recorded, offs, JCFG,
                                         sa_noise_std=0.0)
            if compensate else hw_j)
    hw_cp, _ = jkws.as_hw_params(hw_c)
    feats = jtr.hw_features(hw_c, recorded, JCFG, chip_offsets=offs)
    w, b = j_finetune(jnp.asarray(feats), jnp.asarray(labels), hw_cp.fc_w,
                      hw_cp.fc_b, JTrainConfig(epochs=epochs))
    return ({k: np.asarray(v) for k, v in hw_cp.bias.items()},
            np.asarray(w), np.asarray(b))


def _assert_result(res, bias, w, b):
    for name in CFG.imc_layer_names():
        np.testing.assert_array_equal(res.bias[name], bias[name],
                                      err_msg=name)
    np.testing.assert_array_equal(res.fc_w, w)
    np.testing.assert_array_equal(res.fc_b, b)


def _drive(srv, sessions, live, max_steps=300):
    pos = L
    srv.submit("live", live[:L])
    for _ in range(max_steps):
        if pos < len(live):
            srv.submit("live", live[pos:pos + HOP])
            pos += HOP
        srv.step()
        if all(s.phase == "swapped" for s in sessions):
            return
    raise AssertionError([s.phase for s in sessions])


def test_offline_pieces_match_jax(nets):
    """calibrate_and_compensate, hw_features and quantized_head_finetune
    of the port against the JAX package's."""
    hw_j, hw_t, chip = nets
    utts, labels = _utterances(5, 3)
    x = np.stack(utts)
    offs = {k: jnp.asarray(v) for k, v in chip.items()}
    hw_cj = jkws.as_hw_params(jtr.calibrate_and_compensate(
        hw_j, x, offs, JCFG, sa_noise_std=0.0))[0]
    hw_ct = tr.calibrate_and_compensate(hw_t, x, chip, CFG,
                                        sa_noise_std=0.0, device="cpu")
    assert isinstance(hw_ct, kws.PackedHWParams)
    ideal_t = tr.calibration_ideal_counts(hw_t, x, CFG, device="cpu")
    ideal_j = jtr.calibration_ideal_counts(hw_j, x, JCFG)
    worst = 0.0
    for name in CFG.imc_layer_names():
        np.testing.assert_array_equal(ideal_t[name].numpy(),
                                      np.asarray(ideal_j[name]))
        np.testing.assert_array_equal(hw_ct.hw.bias[name].numpy(),
                                      np.asarray(hw_cj.bias[name]))
        _, est_t = tr.compensate_layer_bias(
            hw_t.hw.bias[name], ideal_t[name], torch.tensor(chip[name]),
            sa_noise_std=0.0, return_est=True)
        _, est_j = jtr.compensate_layer_bias(
            hw_j.hw.bias[name], ideal_j[name], offs[name],
            jax.random.PRNGKey(0), 0.0, return_est=True)
        diff = np.abs(est_t.numpy() - np.asarray(est_j))
        np.testing.assert_allclose(est_t.numpy(), np.asarray(est_j), rtol=0,
                                   atol=1e-5)
        worst = max(worst, float(diff.max()))
    print(f"largest offset-estimate difference: {worst:.3g}")
    ft = tr.hw_features(hw_ct, x, CFG, chip_offsets=chip, device="cpu",
                        batch=2)
    fj = jtr.hw_features(jkws.pack_hw_params(hw_cj, JCFG), x, JCFG,
                         chip_offsets=offs)
    np.testing.assert_array_equal(ft.numpy(), fj)
    # the kernel route of the forward gives the same features
    fk = tr.hw_features(hw_ct, x, CFG, chip_offsets=chip, device="cpu",
                        use_kernel=True)
    assert torch.equal(fk, ft)
    w, b = quantized_head_finetune(ft, labels, hw_ct.hw.fc_w, hw_ct.hw.fc_b,
                                   OnChipTrainConfig(epochs=EPOCHS),
                                   device="cpu")
    wj, bj = j_finetune(jnp.asarray(fj), jnp.asarray(labels), hw_cj.fc_w,
                        hw_cj.fc_b, JTrainConfig(epochs=EPOCHS))
    np.testing.assert_array_equal(w.numpy(), np.asarray(wj))
    np.testing.assert_array_equal(b.numpy(), np.asarray(bj))


def test_session_without_compensation_matches_jax(nets):
    hw_j, hw_t, chip = nets
    utts, labels = _utterances(3, 4)
    srv = StreamServer(hw_t, CFG, hop=HOP, slots=3, chip_offsets=chip,
                       vad=VADConfig(), device="cpu")
    sess = srv.customize("user", CustomizeConfig(
        train=OnChipTrainConfig(epochs=EPOCHS), epochs_per_tick=5,
        compensate=False, calib_sa_noise_std=0.0))
    for lab, u in zip(labels, utts):
        sess.enroll(lab, u)
    sess.finish_enrollment()
    live = np.random.default_rng(5).uniform(-1, 1, L + 30 * HOP).astype(
        np.float32)
    _drive(srv, [sess], live)
    assert srv.stats()["learn_hops"] == 0       # no re-extraction
    _assert_result(sess.result, *_jax_offline(
        hw_j, chip, np.stack(sess.windows), labels, compensate=False))
    assert sess.feature_noise_field() is None
    assert [o["hop"] for o in sess.feature_origins] == [
        (L + j * L - L) // HOP for j in range(3)]


def test_two_sessions_share_one_optimizer_launch_per_round(nets,
                                                           monkeypatch):
    """Two concurrent sessions at different epochs_per_tick sit at
    different points of the LR schedule; every tick in which either
    trains runs both budgets (or the one left) in ONE fused head-training
    call, each row from its own epoch, and each session still lands on
    its own offline loop (dynamic error scaling: ``fixed_error_scale``
    is None)."""
    hw_j, hw_t, chip = nets
    calls, per_epoch = [], []
    fused, batch = sga_ops.head_train_batch, sga_ops.sga_update_batch

    def counted(w, b, aw, ab, feats, onehot, start, epochs, lut, spec):
        calls.append((tuple(start), tuple(epochs)))
        return fused(w, b, aw, ab, feats, onehot, start, epochs, lut, spec)

    def counted_rows(*args, **kw):
        per_epoch.append(1)
        return batch(*args, **kw)

    monkeypatch.setattr(sga_ops, "head_train_batch", counted)
    monkeypatch.setattr(sga_ops, "sga_update_batch", counted_rows)
    srv = StreamServer(hw_t, CFG, hop=HOP, slots=9, chip_offsets=chip,
                       vad=VADConfig(), device="cpu")
    data = [_utterances(3, 10), _utterances(3, 11)]
    sessions = []
    for k, (per_tick, (utts, labels)) in enumerate(zip((5, 3), data)):
        sess = srv.customize(f"user{k}", CustomizeConfig(
            train=OnChipTrainConfig(epochs=EPOCHS), epochs_per_tick=per_tick,
            calib_sa_noise_std=0.0))
        for lab, u in zip(labels, utts):
            sess.enroll(lab, u)
        sess.finish_enrollment()
        sessions.append(sess)
    live = np.random.default_rng(6).uniform(-1, 1, L + 60 * HOP).astype(
        np.float32)
    _drive(srv, sessions, live)
    for sess, (_, labels) in zip(sessions, data):
        _assert_result(sess.result, *_jax_offline(
            hw_j, chip, np.stack(sess.windows), labels))
    # one call per tick; both rows while both train, at differing epochs
    assert per_epoch == []
    assert len(calls) < 2 * EPOCHS
    assert sum(sum(e) for _, e in calls) == 2 * EPOCHS
    two = [c for c in calls if len(c[0]) == 2]
    assert two and any(s[0] != s[1] for s, _ in two)
    assert all(e <= 5 for _, es in calls for e in es)
    st = srv.stats()["customization"]
    assert st["epochs_total"] == 2 * EPOCHS and st["swaps"] == 2


@pytest.mark.parametrize("batch_init", [True, False],
                         ids=["batch_init", "sequential_init"])
def test_install_custom_serves_like_the_refolded_net(nets, batch_init):
    """A profile installed into a live server serves the same events as a
    dedicated server on the refolded net (base head and biases replaced),
    through gated hops and wake replays on both streams, and the other
    stream on the same server is untouched."""
    _, hw_t, chip = nets
    utts, labels = _utterances(3, 12)
    srv = StreamServer(hw_t, CFG, hop=HOP, slots=3, chip_offsets=chip,
                       vad=VADConfig(), device="cpu")
    sess = srv.customize("user", CustomizeConfig(
        train=OnChipTrainConfig(epochs=EPOCHS), epochs_per_tick=8,
        calib_sa_noise_std=0.0))
    for lab, u in zip(labels, utts):
        sess.enroll(lab, u)
    sess.finish_enrollment()
    live = np.random.default_rng(7).uniform(-1, 1, L + 40 * HOP).astype(
        np.float32)
    _drive(srv, [sess], live)
    result = sess.result

    rng = np.random.default_rng(8)
    audio = [rng.uniform(-1, 1, L + 10 * HOP).astype(np.float32)
             for _ in range(2)]
    for x in audio:
        x[L + 2 * HOP:L + 7 * HOP] *= 1e-4      # silence: gated hops
    mixed = StreamServer(hw_t, CFG, hop=HOP, slots=2, chip_offsets=chip,
                         vad=VADConfig(), batch_init=batch_init,
                         device="cpu")
    mixed.install_custom("me", result)
    for sid, x in zip(("me", "other"), audio):
        mixed.submit(sid, x)
        mixed.finish(sid)
    ev_mixed = mixed.drain()
    per = mixed.stats()["per_stream"]
    assert per["me"]["gated_hops"] > 0 and per["other"]["gated_hops"] > 0
    assert mixed.stats()["batched_calls"]["replay"] > 0

    refolded = StreamServer(cz.refold(result, hw_t, CFG), CFG, hop=HOP,
                            slots=1, chip_offsets=chip, vad=VADConfig(),
                            device="cpu")
    base = StreamServer(hw_t, CFG, hop=HOP, slots=1, chip_offsets=chip,
                        vad=VADConfig(), device="cpu")
    for srv_, sid, x in ((refolded, "me", audio[0]),
                         (base, "other", audio[1])):
        srv_.submit(sid, x)
        srv_.finish(sid)
    ev_ref = refolded.drain() + base.drain()
    key = lambda e: (e["stream"], e["hop"])
    assert sorted(ev_mixed, key=key) == sorted(ev_ref, key=key)
    assert torch.equal(sess.refolded().hw.fc_w,
                       torch.tensor(result.fc_w))


def test_calibration_noise_raises_naming_the_prng(nets):
    """The draws that raised until the PRNG was ported now equal the
    reference's: a session's calibration with read noise 1.0 (the default)
    against ``calibrate_and_compensate`` and JAX's, and a noisy feature
    forward."""
    hw_j, hw_t, chip = nets
    srv = StreamServer(hw_t, CFG, hop=HOP, slots=2, chip_offsets=chip,
                       device="cpu")
    sess = srv.customize("user", CustomizeConfig(     # calib noise 1.0
        train=OnChipTrainConfig(epochs=2), calib_seed=3))
    utts, labels = _utterances(2, 13)
    for lab, u in zip(labels, utts):
        sess.enroll(lab, u)
    sess.finish_enrollment()
    srv.submit("user", np.zeros(HOP, np.float32))
    for _ in range(40):
        srv.step()
        if sess.phase not in ("enrolling", "calibrating"):
            break
    assert sess.phase == "extracting"
    x = np.stack(sess.windows)
    offs = {k: jnp.asarray(v) for k, v in chip.items()}
    want = jkws.as_hw_params(jtr.calibrate_and_compensate(
        hw_j, x, offs, JCFG, sa_noise_std=1.0, seed=3))[0].bias
    got = tr.calibrate_and_compensate(hw_t, x, chip, CFG, seed=3,
                                      device="cpu").hw.bias
    for name in CFG.imc_layer_names():
        np.testing.assert_array_equal(sess._new_bias[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)
    ft = tr.hw_features(hw_t, x, CFG, chip_offsets=chip, sa_noise_std=0.5,
                        seed=4, batch=1, device="cpu")
    fj = jtr.hw_features(hw_j, x, JCFG, chip_offsets=offs, sa_noise_std=0.5,
                         seed=4, batch=1)
    np.testing.assert_array_equal(ft.numpy(), fj)


def test_entry_points_default_to_cuda(nets, monkeypatch):
    """``device=None`` means CUDA: without a card the offline entry
    points raise instead of running on the CPU."""
    _, hw_t, chip = nets
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((1, L), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.hw_features(hw_t, x, CFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tr.calibrate_and_compensate(hw_t, x, chip, CFG, sa_noise_std=0.0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        quantized_head_finetune(np.zeros((1, 576), np.float32), [0],
                                hw_t.hw.fc_w, hw_t.hw.fc_b,
                                OnChipTrainConfig(epochs=1))
