"""Customization on a noisy chip: a session on the port's StreamServer
with SA noise 1.0 (every stream's per-column noise field), chip offsets,
VAD on, the test mode's read noise 1.0 and an RGP fine-tune, against the
JAX package's offline loop on the CPU:

    calibrate_and_compensate(sa_noise_std=1.0, seed=calib_seed)
    -> hw_features(sa_noise_field=session.feature_noise_field())
    -> finetune_init / finetune_epochs (rgp=True), chunked per tick.

Tolerances: compensated biases, the fine-tuned head and the per-tick
training-accuracy history are compared bitwise.  Small config:
``sample_len=640``, ``hop=64``; the folded net is the port's, carried to
the JAX package as numpy leaves (``test_torch_noise.jax_hw``).
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import imc as jimc
from repro.core import onchip_training as jot
from repro.core import sa_noise as jsa
from repro.models import kws as jkws
from repro.training import kws as jtr
from repro_torch.core import imc, jaxrand
from repro_torch.core.onchip_training import OnChipTrainConfig
from repro_torch.models import kws
from repro_torch.serving import CustomizeConfig, StreamServer, VADConfig
from repro_torch.training import kws as tr
from test_torch_noise import CHANS, jax_hw

L, HOP = 640, 64
JCFG = jkws.KWSConfig(sample_len=L)
CFG = kws.KWSConfig(sample_len=L)
STD = 1.0
EPOCHS, PER_TICK, N_UTTS, CALIB_SEED = 12, 5, 3, 4


@pytest.fixture(scope="module")
def session():
    params = kws.init_params(jaxrand.PRNGKey(5, device="cpu"), CFG,
                             device="cpu")
    hw_t = kws.fold_params(params, kws.init_state(CFG, device="cpu"), CFG,
                           pack=True)
    chip_t = imc.sample_chip_offsets(jaxrand.PRNGKey(0, "cpu"), CHANS,
                                     imc.IMCNoiseParams(mav_offset_std=4.0))
    srv = StreamServer(hw_t, CFG, hop=HOP, slots=4, chip_offsets=chip_t,
                       sa_noise_std=STD, seed=11, vad=VADConfig(),
                       device="cpu")
    tcfg = OnChipTrainConfig(epochs=EPOCHS, rgp=True, seed=6)
    sess = srv.customize("user", CustomizeConfig(
        train=tcfg, epochs_per_tick=PER_TICK, calib_sa_noise_std=1.0,
        calib_seed=CALIB_SEED))
    rng = np.random.default_rng(21)
    live = rng.uniform(-1, 1, L + 40 * HOP).astype(np.float32)
    srv.submit("live", live[:L])
    for _ in range(N_UTTS):
        sess.enroll(int(rng.integers(0, CFG.num_classes)),
                    rng.uniform(-1, 1, L).astype(np.float32))
    sess.finish_enrollment()
    pos = L
    for _ in range(300):
        if pos < len(live):
            srv.submit("live", live[pos:pos + HOP])
            pos += HOP
        srv.step()
        if sess.phase == "swapped":
            break
    assert sess.phase == "swapped"
    return dict(srv=srv, sess=sess, hw_t=hw_t, chip_t=chip_t, tcfg=tcfg)


def test_noisy_session_matches_jax_offline_loop(session):
    sess, hw_t = session["sess"], session["hw_t"]
    hw_j = jax_hw(hw_t)
    chip_j = jimc.sample_chip_offsets(jax.random.PRNGKey(0), CHANS,
                                      jimc.IMCNoiseParams(mav_offset_std=4.0))
    x = np.stack(sess.windows)
    field = sess.feature_noise_field()
    jfield = jsa.SANoiseField(
        keys=jnp.asarray(jaxrand.key_to_numpy(field.keys)),
        hops=jnp.asarray(field.hops.numpy()), std=STD, hop=HOP)
    hw_c = jkws.as_hw_params(jtr.calibrate_and_compensate(
        hw_j, x, chip_j, JCFG, sa_noise_std=1.0, seed=CALIB_SEED))[0]
    feats = jtr.hw_features(hw_c, x, JCFG, chip_offsets=chip_j,
                            sa_noise_field=jfield)
    jcfg = jot.OnChipTrainConfig(**{
        f: getattr(session["tcfg"], f) for f in ("epochs", "rgp", "seed",
                                                 "lr_init", "lr_min",
                                                 "lr_halve_every",
                                                 "fixed_error_scale")})
    state, fq, onehot = jot.finetune_init(
        jnp.asarray(feats), jnp.asarray(sess.labels), hw_c.fc_w, hw_c.fc_b,
        jcfg, num_classes=CFG.num_classes)
    history = []
    for e0 in range(0, EPOCHS, PER_TICK):
        n = min(PER_TICK, EPOCHS - e0)
        state = jot.finetune_epochs(state, fq, onehot, jcfg, e0, n)
        acc = jot.head_accuracy(fq, jnp.asarray(sess.labels), state.w,
                                state.b, jcfg)
        history.append({"epoch": e0 + n, "train_accuracy": float(acc)})
    res = sess.result
    for name in CFG.imc_layer_names():
        np.testing.assert_array_equal(res.bias[name],
                                      np.asarray(hw_c.bias[name]),
                                      err_msg=name)
    np.testing.assert_array_equal(res.fc_w, np.asarray(state.w))
    np.testing.assert_array_equal(res.fc_b, np.asarray(state.b))
    assert res.history == history
    # the compensation moved biases, and the captures really were noisy
    assert any((res.bias[n] != hw_t.hw.bias[n].numpy()).any()
               for n in CFG.imc_layer_names())
    clean = jtr.hw_features(hw_c, x, JCFG, chip_offsets=chip_j)
    assert not np.array_equal(clean, feats)


def test_noisy_session_equals_port_offline_loop(session):
    """The same contract inside the port: the field the session reports
    reproduces its captured features through the port's offline loop."""
    sess, hw_t, chip_t = session["sess"], session["hw_t"], session["chip_t"]
    x = np.stack(sess.windows)
    hw_c = tr.calibrate_and_compensate(hw_t, x, chip_t, CFG,
                                       seed=CALIB_SEED, device="cpu")
    feats = tr.hw_features(hw_c, x, CFG, chip_offsets=chip_t, device="cpu",
                           sa_noise_field=sess.feature_noise_field())
    assert torch.equal(torch.stack(sess.features), feats)
    # each feature was re-extracted by its own replay stream, at window 1
    assert [o["hop"] for o in sess.feature_origins] == [1] * N_UTTS
    assert len({tuple(o["key"]) for o in sess.feature_origins}) == N_UTTS
