"""The port's self-healing server against the JAX package's interpreted
StreamServer (``compiled=None``, plain route), tick by tick on the CPU:
faults riding the bias-delta riders on a noisy chip, the canary health
monitor's stuck-column and drift-heal scenarios (the reference's own,
``tests/test_reliability.py``), and canaries pausing without traffic.
Then, on the port alone: one fused-layer call per IMC layer in a tick
whose batch carries live hops and a canary hop.

Both servers take the same calls; events must be equal (``degraded``
included; ``score`` within 1e-6 absolute, as in the other server tests),
and so must the state leaves, the health stats and history, the masked
channels, the heal deltas and the fault stats, bitwise.  In the stuck and
drift scenarios both run their flight recorder and launch auditor (raise
mode): the recorder events (``health`` transitions, ``heal`` phases,
admissions, evictions, ticks) and the per-tick batched calls are equal,
and the port counts the canary expectation's fused calls outside every
auditor region.  Small config:
``sample_len=640``, ``hop=64``; the net is the port's, carried to JAX as
numpy leaves (``test_torch_noise.jax_hw``).
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import faults as jflt
from repro.core import imc as jimc
from repro.models import kws as jkws
from repro.serving import HealthConfig as JHealthConfig
from repro.serving import StreamServer as JStreamServer
from repro_torch.core import imc, jaxrand
from repro_torch.kernels.imc_mav import ops
from repro_torch.models import kws
from repro_torch.obs import ObsConfig
from repro_torch.serving import (CustomizationResult, FaultConfig,
                                 HealthConfig, StreamServer)
from test_torch_noise import CHANS, jax_hw

L, HOP = 640, 64
JCFG = jkws.KWSConfig(sample_len=L)
CFG = kws.KWSConfig(sample_len=L)
SCORE_ATOL = 1e-6


@pytest.fixture(scope="module")
def nets():
    params = kws.init_params(jaxrand.PRNGKey(5, device="cpu"), CFG,
                             device="cpu")
    hw_t = kws.fold_params(params, kws.init_state(CFG, device="cpu"), CFG,
                           pack=True)
    noise = jimc.IMCNoiseParams(mav_offset_std=4.0)
    chip_j = jimc.sample_chip_offsets(jax.random.PRNGKey(9), CHANS, noise)
    chip_t = imc.sample_chip_offsets(jaxrand.PRNGKey(9, "cpu"), CHANS,
                                     imc.IMCNoiseParams(mav_offset_std=4.0))
    return jax_hw(hw_t), hw_t, chip_j, chip_t


def _pair(nets, chip=False, faults=None, health=None, obs=None, **kw):
    """A JAX server and the port's, built alike (``faults``, ``health``
    and ``obs`` as dicts of their configs' fields)."""
    hw_j, hw_t, chip_j, chip_t = nets
    ref = JStreamServer(
        hw_j, JCFG, hop=HOP, use_kernel=False, compiled=None,
        chip_offsets=chip_j if chip else None,
        faults=None if faults is None else jflt.FaultConfig(**faults),
        health=None if health is None else JHealthConfig(**health),
        obs=jobs.ObsConfig(**(obs or {})), **kw)
    port = StreamServer(
        hw_t, CFG, hop=HOP, device="cpu",
        chip_offsets=chip_t if chip else None,
        faults=None if faults is None else FaultConfig(**faults),
        health=None if health is None else HealthConfig(**health),
        obs=ObsConfig(**(obs or {})), **kw)
    return ref, port


def _same_events(ev_port, ev_ref):
    strip = lambda es: [{k: v for k, v in e.items() if k != "score"}
                        for e in es]
    assert strip(ev_port) == strip(ev_ref)
    np.testing.assert_allclose([e["score"] for e in ev_port],
                               [e["score"] for e in ev_ref], rtol=0,
                               atol=SCORE_ATOL)


def _same_state(port, ref):
    st, sj = port._state, ref._state
    for a, b in zip([st.audio_carry, *st.carries, st.ring, st.hop],
                    [sj.audio_carry, *sj.carries, sj.ring, sj.hop]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(st.key.numpy(),
                                  np.asarray(sj.key).astype(np.int64))


def _same_health(port, ref):
    assert port.health.stats() == ref.health.stats()
    assert port.faults.stats() == ref.faults.stats()
    hp, hj = port._heal_delta, ref._heal_delta
    assert (hp is None) == (hj is None)
    if hj is not None:
        assert sorted(hp) == sorted(hj)
        for name in hj:
            np.testing.assert_array_equal(hp[name], np.asarray(hj[name]))
    for name, d in ref.health._ref_delta.items():
        np.testing.assert_array_equal(port.health._ref_delta[name], d)
    assert port.health._frozen_layers == ref.health._frozen_layers


def test_faulted_noisy_server_matches_jax(nets):
    """SA noise 1.5, chip offsets, stuck columns, trim-bit flips and a
    drift walk: events and state leaves equal JAX's at every tick, and so
    do the fault stats."""
    rng = np.random.default_rng(2)
    auds = [rng.uniform(-1, 1, L + 7 * HOP).astype(np.float32)
            for _ in range(2)]
    servers = _pair(nets, chip=True, slots=3, sa_noise_std=1.5, seed=11,
                    faults=dict(drift_std=0.2, seed=3))
    events = []
    for srv in servers:
        srv.faults.inject_stuck("conv2", [0, 5])
        srv.faults.inject_bit_flips(n=3)
        evs = []
        for i, x in enumerate(auds):
            srv.submit(f"s{i}", x)
            srv.finish(f"s{i}")
        for _ in range(9):
            evs.append(srv.step())
        events.append(evs)
    ref, port = servers
    for ev_ref, ev_port in zip(*events):
        _same_events(ev_port, ev_ref)
    assert sum(map(len, events[1])) == 16
    _same_state(port, ref)
    assert port.faults.stats() == ref.faults.stats()
    assert port.faults.stats()["drift_rms"]


def test_faults_ride_the_riders(nets):
    """A faulted server serves bit for bit as a clean one whose installed
    profile carries the same integer deltas (stuck rails and flips), with
    and without SA noise; and equals JAX's faulted server."""
    hw_j, hw_t, _, _ = nets
    rng = np.random.default_rng(2)
    wav = rng.uniform(-1, 1, L + 5 * HOP).astype(np.float32)
    hwp = hw_t.hw
    for std in (0.0, 1.5):
        ref, srv_f = _pair(nets, slots=3, sa_noise_std=std, seed=11,
                           faults=dict(seed=3))
        for s in (ref, srv_f):
            s.faults.inject_stuck("conv2", [0, 5])
            s.faults.inject_bit_flips(n=2)
        deltas = srv_f.faults.deltas()
        bias = {n: hwp.bias[n].numpy() + deltas[n]
                for n in CFG.imc_layer_names()}
        result = CustomizationResult(
            bias=bias, fc_w=hwp.fc_w.numpy(), fc_b=hwp.fc_b.numpy(),
            epochs=1, n_utterances=2, history=[], energy={})
        clean = StreamServer(hw_t, CFG, hop=HOP, slots=3, device="cpu",
                             sa_noise_std=std, seed=11)
        clean.install_custom("a", result)
        for s in (ref, srv_f, clean):
            s.submit("a", wav)
        ev_ref, ev_f, ev_clean = ref.drain(), srv_f.drain(), clean.drain()
        assert len(ev_f) == 6 and ev_f == ev_clean
        for a, b in zip(srv_f._state, clean._state):
            for x, y in zip(a if isinstance(a, tuple) else (a,),
                            b if isinstance(b, tuple) else (b,)):
                assert torch.equal(x, y)
        _same_events(ev_f, ev_ref)
        _same_state(srv_f, ref)


def _scenario(servers, inject, before, after):
    """The reference's scenario: one stream fed a hop a tick, ``before``
    clean ticks, the injection, ``after`` more; events equal at every
    tick (``degraded`` included)."""
    states = []
    for srv in servers:
        rng = np.random.default_rng(0)
        srv.submit("a", rng.standard_normal(L).astype(np.float32))
        evs, trace = [], []
        for t in range(before + after):
            if t == before:
                inject(srv)
            srv.submit("a", rng.standard_normal(HOP).astype(np.float32))
            evs.append(srv.step())
            trace.append(srv.health.state)
        states.append((evs, trace))
    (ev_ref, tr_ref), (ev_port, tr_port) = states
    assert tr_port == tr_ref
    for a, b in zip(ev_port, ev_ref):
        _same_events(a, b)
    assert any(e["degraded"] for evs in ev_port for e in evs)
    _same_state(servers[1], servers[0])
    _same_health(servers[1], servers[0])
    ref, port = servers
    assert port.recorder.events() == ref.recorder.events()
    phases = [e["phase"] for e in port.recorder.events("heal")]
    assert phases[0] == "ideal" and "layers" in phases and "apply" in phases
    assert port.auditor.violations == ref.auditor.violations == []
    assert ([(h["tick"], h["calls"]) for h in port.auditor.history()]
            == [(h["tick"], h["calls"]) for h in ref.auditor.history()])
    # two B = 1 forwards per expectation, outside every region
    assert port.auditor.stats()["outside_regions"] % 10 == 0
    assert port.auditor.stats()["outside_regions"] >= 10
    return port.health.stats(), tr_port


def test_stuck_columns_detected_localized_and_masked(nets):
    """Stuck columns in conv3: detected within two canary intervals,
    quarantined, healed as far as the clip allows, masked at their own
    layer, and back to healthy; the port walks JAX's path tick by tick."""
    servers = _pair(nets, slots=3, faults=dict(seed=3),
                    health=dict(interval=4, layers_per_tick=2),
                    obs=dict(recorder=512, audit="raise"))
    h, trace = _scenario(
        servers, lambda s: s.faults.inject_stuck("conv3", [2, 7]), 12, 22)
    assert trace[-1] == "healthy" and h["masked_channels"] == {
        "conv3": [2, 7]}
    assert [e["state"] for e in h["history"]][1:4] == [
        "degraded", "quarantined", "recovering"]
    assert h["detected_tick"] - 12 <= 2 * 4 + 2 and h["recoveries"] >= 1


def test_drift_heals_back_to_healthy(nets):
    """A uniform drift of 40 counts on conv2 over chip offsets: detected,
    recompensated through the heal rider, healthy again with no masked
    channel; the port's heal delta is JAX's."""
    def drift(s):
        s.faults._drift["conv2"][:] = 40.0
        s.faults._dirty = True

    servers = _pair(nets, chip=True, slots=3, faults=dict(seed=3),
                    health=dict(interval=4),
                    obs=dict(recorder=512, audit="raise"))
    h, trace = _scenario(servers, drift, 12, 18)
    assert trace[-1] == "healthy" and h["recoveries"] == 1
    assert h["masked_channels"] == {}
    assert all(v == 0.0 for v in h["divergence"].values())
    assert h["recovery_energy_uj"] > 0
    assert "conv2" in servers[1]._heal_delta


def test_canaries_pause_without_live_traffic(nets):
    """No live stream, no canary; traffic brings canaries back; after an
    eviction ``drain()`` ends, on both packages alike."""
    servers = _pair(nets, slots=3, health=dict(interval=1))
    counts = []
    for srv in servers:
        for _ in range(4):
            srv.step()
        quiet = srv.health.canaries
        rng = np.random.default_rng(0)
        srv.submit("a", rng.standard_normal(L + 4 * HOP).astype(np.float32))
        evs = [srv.step() for _ in range(5)]
        srv.evict("a")
        evs.append(srv.drain())
        counts.append((quiet, srv.health.canaries, srv.stats()["steps"],
                       srv.active_streams(), evs))
    (q_ref, n_ref, s_ref, a_ref, ev_ref), (q, n, s, a, ev) = counts
    assert q == q_ref == 0 and n == n_ref >= 1
    assert s == s_ref and a == a_ref == []
    for x, y in zip(ev, ev_ref):
        _same_events(x, y)


def test_one_fused_call_per_layer_with_a_canary_in_the_batch(monkeypatch,
                                                             nets):
    """On a faulted chip, the tick whose batch carries live hops and the
    canary's hop calls the fused layer once per IMC layer; over the whole
    run the calls are 5 x ``imc_passes`` (the canary's expected state
    included)."""
    _, hw_t, _, _ = nets
    real = ops.fused_conv_mav

    def counting(*args, **kw):
        ops.COUNTS.launches += 1
        return real(*args, **kw)

    monkeypatch.setattr(ops, "fused_conv_mav", counting)
    ops.COUNTS.reset()
    srv = StreamServer(hw_t, CFG, hop=HOP, slots=4, device="cpu",
                       faults=FaultConfig(drift_std=0.2, seed=3),
                       health=HealthConfig(interval=6))
    srv.faults.inject_bit_flips(n=2)
    rng = np.random.default_rng(0)
    for i in range(2):
        srv.submit(f"s{i}", rng.uniform(-1, 1, L + 16 * HOP)
                   .astype(np.float32))
    canary = lambda: [r for r in srv._streams.values() if r.internal]
    for _ in range(10):
        srv.step()
        if canary():
            break
    assert canary(), "a canary should have been submitted"
    srv.step()                      # its init rides an admission wave
    rec = canary()[0]
    assert rec.initialized and srv.health._pending is not None
    before = ops.COUNTS.launches
    srv.step()                      # live hops + the canary's hop
    assert ops.COUNTS.launches - before == CFG.num_conv_layers - 1
    assert srv.health._pending is None and rec.stream_id not in srv._streams
    assert ops.COUNTS.launches == 5 * srv.stats()["imc_passes"]
