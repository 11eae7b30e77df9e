"""The port's StreamServer (repro_torch.serving.scheduler) against the JAX
package's interpreted StreamServer (``compiled=None``, fused kernel on)
over the same multi-stream duty-cycled traffic, chip offsets and VAD on.

Decision events must be identical on stream, hop, keyword and trigger;
``score`` may differ by at most 1e-6 absolute, because softmax and the
smoothing sum round differently in the last ulps between the two
libraries.  The serving counters (ticks, decisions, hops by kind, batched
calls by cause) must be equal.  The folded net and chip offsets are made
by the JAX package and carried across as numpy leaves; audio is made with
numpy.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import imc as jimc
from repro.models import kws as jkws
from repro.serving import DecisionConfig as JDecisionConfig
from repro.serving import StreamServer as JStreamServer
from repro.serving import VADConfig as JVADConfig
from repro_torch.models import kws
from repro_torch.serving.decision import DecisionConfig
from repro_torch.serving.scheduler import StreamServer
from repro_torch.serving.vad import VADConfig

L, HOP = 640, 64
JCFG = jkws.KWSConfig(sample_len=L)
CFG = kws.KWSConfig(sample_len=L)
SCORE_ATOL = 1e-6
# thresholds inside the score range of this untrained net (0.20-0.33 on
# this traffic), so triggers, hysteresis and the refractory all act
DECISION = dict(smooth=2, threshold_on=0.27, threshold_off=0.25,
                refractory=2)


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


def _duty(n, seed, duty=0.45, period=3 * HOP):
    """Speech/silence duty-cycled audio (as tests/test_compiled.py makes
    it): uniform noise with seeded runs of near-silence, so VAD gating and
    wake replays both occur."""
    r = np.random.default_rng(seed)
    x = r.uniform(-1.0, 1.0, n).astype(np.float32)
    t = 0
    while t < n:
        if r.random() > duty:
            x[t:t + period] *= 1e-4
        t += period
    return x


def _serve(srv, auds):
    for i, x in enumerate(auds):
        srv.submit(f"s{i}", x)
        srv.finish(f"s{i}")
    return srv.drain()


def _counters(stats):
    keys = ("steps", "decisions", "speech_hops", "gated_hops",
            "batched_calls")
    return {k: stats[k] for k in keys}


@pytest.mark.parametrize("batch_init", [True, False],
                         ids=["batch_init", "sequential_init"])
def test_server_matches_jax(nets, batch_init):
    """Four duty-cycled streams on three slots (the fourth waits in the
    admission queue until a stream retires)."""
    hw_j, hw_t, chip = nets
    auds = [_duty(L + (18 + 3 * i) * HOP, 100 + i) for i in range(4)]
    ref = JStreamServer(hw_j, JCFG, hop=HOP, slots=3, use_kernel=True,
                        chip_offsets={k: jnp.asarray(v)
                                      for k, v in chip.items()},
                        vad=JVADConfig(), batch_init=batch_init,
                        decision=JDecisionConfig(**DECISION), compiled=None)
    port = StreamServer(hw_t, CFG, hop=HOP, slots=3, use_kernel=True,
                        chip_offsets=chip, vad=VADConfig(),
                        batch_init=batch_init,
                        decision=DecisionConfig(**DECISION), device="cpu")
    ev_ref = _serve(ref, auds)
    ev_port = _serve(port, auds)

    strip = lambda evs: [{k: e[k] for k in ("stream", "hop", "keyword",
                                             "trigger")} for e in evs]
    assert strip(ev_port) == strip(ev_ref)
    scores = np.array([[a["score"], b["score"]]
                       for a, b in zip(ev_port, ev_ref)])
    np.testing.assert_allclose(scores[:, 0], scores[:, 1], rtol=0,
                               atol=SCORE_ATOL)

    st_ref, st_port = ref.stats(), port.stats()
    assert _counters(st_port) == _counters(st_ref)
    calls = st_port["batched_calls"]
    # the traffic exercises every path: admissions, hops, gating, replays
    assert st_port["gated_hops"] > 0 and calls["replay"] > 0
    assert sum(e["trigger"] for e in ev_port) > 0
    assert calls["init"] == (1 if batch_init else 3) + 1
    assert st_port["decisions"] == len(ev_port)
    for sid, per in st_port["per_stream"].items():
        ref_per = st_ref["per_stream"][sid]
        assert (per["hops"], per["gated_hops"], per["triggers"]) == (
            ref_per["hops"], ref_per["gated_hops"], ref_per["triggers"])
    assert st_port["gated_energy"]["duty_cycle"] == pytest.approx(
        st_ref["gated_energy"]["duty_cycle"])


def test_server_vad_forced_speech_equals_ungated(nets):
    """With the VAD forced to "speech" nothing gates, and the served events
    equal an ungated server's exactly (same library, same device)."""
    _, hw_t, chip = nets
    auds = [_duty(L + 10 * HOP, 200 + i) for i in range(2)]
    runs = []
    for vad in (VADConfig(force="speech"), None):
        srv = StreamServer(hw_t, CFG, hop=HOP, slots=2, chip_offsets=chip,
                           vad=vad, device="cpu")
        runs.append((_serve(srv, auds), srv.stats()))
    assert runs[0][0] == runs[1][0]
    assert runs[0][1]["gated_hops"] == 0
    assert runs[0][1]["batched_calls"] == runs[1][1]["batched_calls"]


def test_server_evict_frees_slot(nets):
    _, hw_t, _ = nets
    srv = StreamServer(hw_t, CFG, hop=HOP, slots=1, device="cpu")
    assert srv.submit("a", _duty(L + 4 * HOP, 1)) == "slot"
    assert srv.submit("b", _duty(L + 2 * HOP, 2)) == "queued"
    srv.step()
    srv.evict("a")
    assert srv.active_streams() == ["b"]
    events = srv.drain()
    assert [e["hop"] for e in events if e["stream"] == "b"] == [0, 1, 2]
    with pytest.raises(ValueError, match="already finished"):
        srv.submit("a", np.zeros(HOP, np.float32))
