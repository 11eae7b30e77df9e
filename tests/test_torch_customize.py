"""The port's customization sessions (repro_torch.serving.customize) against
the JAX package, on the CPU: one session on a live StreamServer, with bias
compensation on.

* The session's compensated biases and fine-tuned head equal the JAX
  package's offline loop on the same recorded utterances, bit for bit:
  ``calibrate_and_compensate(sa_noise_std=0.0)`` -> ``hw_features`` ->
  ``quantized_head_finetune``.
* The served events (the live stream throughout, the customized stream
  after its hot swap, through gated hops on its own silence fill and a
  wake replay with its riders) equal those of the JAX StreamServer running
  the same session on the same traffic; ``score`` may differ by at most
  1e-6, as in ``tests/test_torch_server.py``.  The serving counters are
  equal.

The folded net and chip offsets are made by the JAX package and carried
across as numpy leaves; audio is made with numpy.  The JAX session is run
once per module.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import imc as jimc
from repro.core.onchip_training import OnChipTrainConfig as JTrainConfig
from repro.core.onchip_training import quantized_head_finetune as j_finetune
from repro.models import kws as jkws
from repro.serving import CustomizeConfig as JCustomizeConfig
from repro.serving import StreamServer as JStreamServer
from repro.serving import VADConfig as JVADConfig
from repro.training import kws as jtr
from repro_torch.core.onchip_training import OnChipTrainConfig
from repro_torch.models import kws
from repro_torch.serving import CustomizeConfig, StreamServer, VADConfig

L, HOP = 640, 64
JCFG = jkws.KWSConfig(sample_len=L)
CFG = kws.KWSConfig(sample_len=L)
SCORE_ATOL = 1e-6
EPOCHS, PER_TICK = 23, 7
N_UTTS = 4


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


def _traffic(seed=1):
    rng = np.random.default_rng(seed)
    live = rng.uniform(-1, 1, L + 50 * HOP).astype(np.float32)
    utts = [rng.uniform(-1, 1, L).astype(np.float32) for _ in range(N_UTTS)]
    labels = [int(rng.integers(0, CFG.num_classes)) for _ in range(N_UTTS)]
    after = rng.uniform(-1, 1, 16 * HOP).astype(np.float32)
    after[3 * HOP:9 * HOP] *= 1e-4      # gated hops and a wake replay
    return live, utts, labels, after


def _run(srv, sess, live, utts, labels, after, max_steps=200):
    """Enroll, step (feeding the live stream one hop per tick) until the
    session has swapped, then serve audio on the customized stream."""
    srv.submit("live", live[:L])
    for lab, u in zip(labels, utts):
        sess.enroll(lab, u)
    sess.finish_enrollment()
    events, pos = [], L
    for _ in range(max_steps):
        if pos < len(live):
            srv.submit("live", live[pos:pos + HOP])
            pos += HOP
        events.extend(srv.step())
        if sess.phase == "swapped":
            break
    assert sess.phase == "swapped", sess.phase
    srv.submit("live", live[pos:])
    srv.submit("user", after)
    srv.finish("live")
    srv.finish("user")
    events.extend(srv.drain())
    return events


def _jax_offline(hw_j, chip, recorded, labels, compensate=True):
    """The JAX package's offline loop on the recorded utterances."""
    offs = {k: jnp.asarray(v) for k, v in chip.items()}
    hw_c = (jtr.calibrate_and_compensate(hw_j, recorded, offs, JCFG,
                                         sa_noise_std=0.0)
            if compensate else hw_j)
    hw_cp, _ = jkws.as_hw_params(hw_c)
    feats = jtr.hw_features(hw_c, recorded, JCFG, chip_offsets=offs)
    w, b = j_finetune(jnp.asarray(feats), jnp.asarray(labels), hw_cp.fc_w,
                      hw_cp.fc_b, JTrainConfig(epochs=EPOCHS))
    bias = {k: np.asarray(v) for k, v in hw_cp.bias.items()}
    return bias, np.asarray(w), np.asarray(b)


@pytest.fixture(scope="module")
def jax_session(nets):
    hw_j, _, chip = nets
    live, utts, labels, after = _traffic()
    srv = JStreamServer(hw_j, JCFG, hop=HOP, slots=4, use_kernel=True,
                        chip_offsets={k: jnp.asarray(v)
                                      for k, v in chip.items()},
                        vad=JVADConfig(), compiled=None)
    sess = srv.customize("user", JCustomizeConfig(
        train=JTrainConfig(epochs=EPOCHS), epochs_per_tick=PER_TICK,
        layers_per_tick=2, calib_sa_noise_std=0.0))
    events = _run(srv, sess, live, utts, labels, after)
    recorded = np.stack(sess.windows)
    offline = _jax_offline(hw_j, chip, recorded, labels)
    return dict(events=events, stats=srv.stats(), result=sess.result,
                recorded=recorded, offline=offline, labels=labels)


def _port_session(nets, **ccfg):
    _, hw_t, chip = nets
    live, utts, labels, after = _traffic()
    srv = StreamServer(hw_t, CFG, hop=HOP, slots=4, chip_offsets=chip,
                       vad=VADConfig(), device="cpu")
    sess = srv.customize("user", CustomizeConfig(
        train=OnChipTrainConfig(epochs=EPOCHS), epochs_per_tick=PER_TICK,
        layers_per_tick=2, calib_sa_noise_std=0.0, **ccfg))
    events = _run(srv, sess, live, utts, labels, after)
    return srv, sess, events


def _strip(events):
    return [{k: e[k] for k in ("stream", "hop", "keyword", "trigger")}
            for e in events]


@pytest.mark.parametrize("use_kernel", [True, False],
                         ids=["sga_kernel_route", "apply_update_route"])
def test_session_matches_jax_offline_loop(nets, jax_session, use_kernel):
    srv, sess, _ = _port_session(nets, use_kernel=use_kernel)
    res = sess.result
    np.testing.assert_array_equal(np.stack(sess.windows),
                                  jax_session["recorded"])
    bias, w, b = jax_session["offline"]
    for name in CFG.imc_layer_names():
        np.testing.assert_array_equal(res.bias[name], bias[name],
                                      err_msg=name)
    np.testing.assert_array_equal(res.fc_w, w)
    np.testing.assert_array_equal(res.fc_b, b)
    # the JAX session itself lands on its offline loop too
    jres = jax_session["result"]
    np.testing.assert_array_equal(jres.fc_w, w)
    assert res.history == jres.history
    # compensation moved biases, so the run exercised it
    hw_j = nets[0]
    assert any(not np.array_equal(res.bias[n], np.asarray(hw_j.hw.bias[n]))
               for n in CFG.imc_layer_names())
    assert res.energy == jres.energy
    st = srv.stats()
    assert st["customization"]["sessions"][0]["phase"] == "swapped"
    assert st["learn_hops"] == jax_session["stats"]["learn_hops"] > 0


def test_served_events_match_jax_server(nets, jax_session):
    srv, _, events = _port_session(nets)
    ref = jax_session["events"]
    assert _strip(events) == _strip(ref)
    scores = np.array([[a["score"], b["score"]]
                       for a, b in zip(events, ref)])
    np.testing.assert_allclose(scores[:, 0], scores[:, 1], rtol=0,
                               atol=SCORE_ATOL)
    st, st_ref = srv.stats(), jax_session["stats"]
    # the customized stream decided, gated and woke after its swap
    assert any(e["stream"] == "user" for e in events[-8:])
    assert st["per_stream"]["user"]["gated_hops"] > 0
    assert st["batched_calls"]["replay"] > 0
    for key in ("steps", "decisions", "speech_hops", "gated_hops",
                "learn_hops", "batched_calls"):
        assert st[key] == st_ref[key], key
    assert st["per_stream"].keys() == st_ref["per_stream"].keys()
    assert st["customization"]["epochs_total"] == \
        st_ref["customization"]["epochs_total"]
