"""The port's serving telemetry (``StreamServer(obs=)``) on the CPU: the
served cases of ``tests/test_obs.py`` (all but the v2 snapshots and the
sharded auditor) on the port.  Telemetry fully on (recorder, auditor in
raise mode, trace) serves exactly what telemetry off serves (events,
every state leaf, health and session results) with VAD gating, SA
noise, chip offsets, faults, canaries and an enrollment session, and
every call of the fused layer in a tick is counted in an auditor region
or outside one (the canary expectation's).

The port's recorder events and per-tick audit calls are held equal to
the JAX server's where a JAX server already runs: on gated noisy traffic
in ``test_torch_noise_server.py``, and through the stuck-column and
drift-heal scenarios (``health`` and ``heal`` records) in
``test_torch_health.py``.  The unit cases of ``repro_torch.obs`` are in
``test_torch_obs.py``.  Stated differences (``ROADMAP.md`` queue 3):
``traced_launches`` counts the fused layer's calls; the port's trace
names its process ``repro_torch.serving``.  Small config:
``sample_len=640``, ``hop=64``.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json

import numpy as np
import pytest
import torch

from repro_torch.core import faults as flt
from repro_torch.core import imc, jaxrand
from repro_torch.core.onchip_training import OnChipTrainConfig
from repro_torch.kernels.imc_mav import ops
from repro_torch.models import kws
from repro_torch.obs import ObsConfig
from repro_torch.serving import (CustomizeConfig, HealthConfig, StreamServer,
                                 VADConfig)
from test_torch_noise import CHANS

L, HOP = 640, 64
CFG = kws.KWSConfig(sample_len=L)
_VAD = dict(threshold_on_db=-40.0, threshold_off_db=-50.0, wake_margin=1,
            hang=0)
_OBS_ON = ObsConfig(recorder=64, audit="raise", trace=True)


@pytest.fixture(scope="module")
def folded():
    params = kws.init_params(jaxrand.PRNGKey(5, device="cpu"), CFG,
                             device="cpu")
    return kws.fold_params(params, kws.init_state(CFG, device="cpu"), CFG,
                           pack=True)


def _chip(std=4.0):
    return imc.sample_chip_offsets(jaxrand.PRNGKey(9, "cpu"), CHANS,
                                   imc.IMCNoiseParams(mav_offset_std=std))


def _gated_wav(rng, n_hops=12, quiet=(4, 9)):
    """Speech with a silent stretch: init, hops, gated fills and a wake
    replay in one drain."""
    wav = rng.uniform(-1, 1, L + n_hops * HOP).astype(np.float32)
    wav[L + quiet[0] * HOP:L + quiet[1] * HOP] *= 1e-4
    return wav


def _run(folded, obs, wavs, **kw):
    srv = StreamServer(folded, CFG, hop=HOP, slots=len(wavs), device="cpu",
                       vad=VADConfig(**_VAD), seed=3, obs=obs, **kw)
    for k, v in wavs.items():
        srv.submit(k, v)
        srv.finish(k)
    return srv, srv.drain()


def _same_state(a, b):
    for x, y in zip([a.audio_carry, *a.carries, a.ring, a.hop, a.key],
                    [b.audio_carry, *b.carries, b.ring, b.hop, b.key]):
        assert torch.equal(x, y)


def test_server_reads_obs_from_env(folded, monkeypatch):
    """``obs=None`` means ``ObsConfig.from_env()``; an explicit config
    wins over the environment."""
    monkeypatch.setenv("REPRO_OBS_RECORDER", "8")
    monkeypatch.setenv("REPRO_OBS_AUDIT", "flag")
    monkeypatch.delenv("REPRO_OBS_TRACE", raising=False)
    srv = StreamServer(folded, CFG, hop=HOP, device="cpu")
    assert srv.obs == ObsConfig(recorder=8, audit="flag")
    assert srv.recorder.capacity == 8 and srv.auditor.mode == "flag"
    assert srv.trace is None
    srv = StreamServer(folded, CFG, hop=HOP, device="cpu", obs=ObsConfig())
    assert srv.recorder is None and srv.auditor is None
    assert "recorder" not in srv.stats()["obs"]



# ---------------------------------------------------------------------------
# Serving: bit-identity, audit-clean traffic, the registry, the trace
# ---------------------------------------------------------------------------


def test_telemetry_bitexact_gated_noise_offsets(folded):
    """Telemetry fully on changes no decision and no state leaf on the
    gated SA-noise + chip-offset configuration."""
    rng = np.random.default_rng(7)
    wavs = {f"s{i}": _gated_wav(rng) for i in range(2)}
    kw = dict(sa_noise_std=0.9, chip_offsets=_chip())
    srv_off, ev_off = _run(folded, ObsConfig(), wavs, **kw)
    srv, ev_on = _run(folded, _OBS_ON, wavs, **kw)
    assert ev_on == ev_off and len(ev_off) > 0
    _same_state(srv._state, srv_off._state)
    s = srv.auditor.stats()
    assert s["violations"] == 0
    assert s["max_hop_calls_per_tick"] <= 1
    assert s["calls"]["gate"] > 0                # silence actually gated
    assert s["calls"]["replay"] > 0              # the wake replay audited
    assert len(srv.recorder.events("tick")) > 0
    assert len(srv.trace) > 0
    assert srv_off.recorder is None and srv_off.auditor is None
    assert srv_off.trace is None


def test_telemetry_bitexact_with_faults_and_canaries(folded):
    """The same with the fault model loaded and canary windows riding
    the ticks; the auditor stays clean in raise mode, and the canary
    expectation's calls land outside every region."""
    rng = np.random.default_rng(8)
    wavs = {"s0": _gated_wav(rng, n_hops=14)}
    kw = dict(chip_offsets=_chip(), faults=flt.FaultConfig(seed=5),
              health=HealthConfig(interval=4))
    srv_off, ev_off = _run(folded, ObsConfig(), wavs, **kw)
    calls0 = ops.CALLS.calls
    srv_on, ev_on = _run(folded, _OBS_ON, wavs, **kw)
    calls = ops.CALLS.calls - calls0
    assert ev_on == ev_off
    _same_state(srv_on._state, srv_off._state)
    assert srv_on.health.canaries >= 1           # canaries actually ran
    assert srv_on.health.stats() == srv_off.health.stats()
    s = srv_on.auditor.stats()
    assert s["violations"] == 0
    assert s["outside_regions"] == 10            # two B = 1 forwards
    # every fused call of the run lies in a tick, in a region or outside
    assert sum(h["k1_calls"] for h in srv_on.auditor.history()) == calls
    assert s["traced_launches"] + s["outside_regions"] == calls
    assert s["traced_launches"] == 5 * sum(
        s["calls"][c] for c in ("init", "hop", "replay"))
    assert calls == 5 * srv_on.stats()["imc_passes"]


def test_audit_clean_mixed_learning_traffic(folded):
    """An enrollment session's learning hops share ticks with live
    inference: auditor in raise mode, no violation, at most one batched
    hop a tick; the session's result equals the one telemetry off gives,
    and the recorder holds its enrolling -> ready -> swapped events."""
    results = []
    for obs in (_OBS_ON, ObsConfig()):
        rng = np.random.default_rng(9)
        srv = StreamServer(folded, CFG, hop=HOP, slots=3, device="cpu",
                           vad=VADConfig(**_VAD), seed=3, obs=obs)
        sess = srv.customize("u0", CustomizeConfig(
            train=OnChipTrainConfig(epochs=8, fixed_error_scale=1.375),
            epochs_per_tick=4, layers_per_tick=5))
        for c in range(2):
            sess.enroll(c, rng.uniform(-1, 1, L).astype(np.float32))
        sess.finish_enrollment()
        srv.submit("live", _gated_wav(rng))
        srv.finish("live")
        events = srv.drain()
        steps = 0
        while not sess.done and steps < 500:
            events += srv.step()
            steps += 1
        assert sess.done and len(events) > 0
        results.append((srv, sess, events))
    (srv, sess, ev_on), (_, sess_off, ev_off) = results
    assert ev_on == ev_off
    for name in sess.result.bias:
        np.testing.assert_array_equal(sess.result.bias[name],
                                      sess_off.result.bias[name])
    np.testing.assert_array_equal(sess.result.fc_w, sess_off.result.fc_w)
    np.testing.assert_array_equal(sess.result.fc_b, sess_off.result.fc_b)
    s = srv.auditor.stats()
    assert s["violations"] == 0
    assert s["max_hop_calls_per_tick"] <= 1
    assert srv.stats()["learn_hops"] > 0
    assert srv.metrics.value("customize.sessions") == 1
    assert srv.metrics.value("customize.epochs") == sess.result.epochs
    sessions = srv.recorder.events("session")
    assert [e["phase"] for e in sessions] == ["enrolling", "ready",
                                              "swapped"]
    assert all(e["stream"] == "u0" and e["sid"] == 0 for e in sessions)
    assert sessions[1]["epochs"] == sess.result.epochs


def test_server_counters_live_in_registry(folded):
    """The scheduler's stats() counters are views over the one
    registry."""
    rng = np.random.default_rng(10)
    srv, events = _run(folded, _OBS_ON, {"s0": _gated_wav(rng)})
    reg = srv.metrics
    st = srv.stats()
    assert reg.value("serving.steps") == srv._steps
    assert reg.value("serving.decisions") == len(events)
    assert reg.value("serving.batched_calls", cause="hop") == srv._hop_calls
    assert (reg.value("serving.batched_calls", cause="gate")
            == st["batched_calls"]["gate"])
    assert reg.value("serving.hops", kind="speech") == st["speech_hops"]
    assert reg.value("serving.hops", kind="gated") == st["gated_hops"]
    assert reg.value("serving.tick_uj")["count"] > 0
    assert st["obs"]["recorder"]["events"] == len(srv.recorder)
    assert st["obs"]["audit"]["violations"] == 0
    assert st["obs"]["metrics"] == len(reg.snapshot()["cells"])


def test_trace_export_and_prometheus_render(folded, tmp_path):
    rng = np.random.default_rng(12)
    srv, _ = _run(folded, _OBS_ON, {"s0": _gated_wav(rng)})
    doc = srv.trace.to_chrome()
    assert doc["displayTimeUnit"] == "ms"
    evs = doc["traceEvents"]
    assert evs[0] == {"name": "process_name", "ph": "M", "pid": 0,
                      "args": {"name": "repro_torch.serving"}}
    names = {e["name"] for e in evs[1:]}
    assert {"init", "tick", "hop", "gate", "replay", "decide",
            "riders"} <= names
    for e in evs[1:]:
        assert e["ph"] == "X"
        assert e["ts"] >= 0 and e["dur"] >= 0
        assert "tick" in e["args"]
    ticks = [e for e in evs[1:] if e["name"] == "tick"]
    assert all("uj" in e["args"] for e in ticks)
    path = tmp_path / "trace.json"
    assert srv.trace.dump(path) == len(srv.trace)
    assert json.loads(path.read_text())["traceEvents"][0]["ph"] == "M"
    text = srv.metrics.prometheus_text()
    assert 'serving_batched_calls{cause="hop"}' in text
    assert "serving_tick_uj_count" in text
