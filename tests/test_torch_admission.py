"""The port's front door against the JAX package's interpreted
StreamServer (``compiled=None``), on the CPU: admission control with
rejection, latency-SLO shedding and slot autoscaling (a customized slot
riding a resize too), the dynamic hop, and ``submit(uid=)``.

Both servers take the same calls on the same audio; the placements
``submit`` returns, the slot count and hop multiplier after every tick,
the serving counters and the decision events must be equal (``score``
within 1e-6 absolute: softmax and the smoothing sum round differently in
the last ulps between the libraries, as in ``test_torch_server.py``).
Small config: ``sample_len=640``, ``hop=64``; the net is the port's,
carried to JAX as numpy leaves (``test_torch_noise.jax_hw``); the JAX side
runs its plain (``use_kernel=False``) route.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import numpy as np
import pytest
import torch

from repro.core import imc as jimc
from repro.models import kws as jkws
from repro.serving import AdmissionConfig as JAdmissionConfig
from repro.serving import DynamicHopConfig as JDynamicHopConfig
from repro.serving import StreamServer as JStreamServer
from repro.serving import VADConfig as JVADConfig
from repro.serving import customize as jcz
from repro_torch.core import imc, jaxrand
from repro_torch.models import kws
from repro_torch.serving import (AdmissionConfig, CustomizationResult,
                                 DynamicHopConfig, StreamServer, VADConfig)
from test_torch_noise import CHANS, jax_hw

L, HOP = 640, 64
JCFG = jkws.KWSConfig(sample_len=L)
CFG = kws.KWSConfig(sample_len=L)
SCORE_ATOL = 1e-6
COUNTERS = ("steps", "decisions", "speech_hops", "gated_hops",
            "batched_calls", "slots", "slot_range", "queue_depth",
            "rejected_streams", "shed", "base_hop", "hop", "hop_multiplier",
            "hop_retargets")


@pytest.fixture(scope="module")
def nets():
    params = kws.init_params(jaxrand.PRNGKey(5, device="cpu"), CFG,
                             device="cpu")
    hw_t = kws.fold_params(params, kws.init_state(CFG, device="cpu"), CFG,
                           pack=True)
    chip_j = jimc.sample_chip_offsets(jax.random.PRNGKey(0), CHANS,
                                      jimc.IMCNoiseParams(mav_offset_std=4.0))
    chip_t = imc.sample_chip_offsets(jaxrand.PRNGKey(0, "cpu"), CHANS,
                                     imc.IMCNoiseParams(mav_offset_std=4.0))
    return jax_hw(hw_t), hw_t, chip_j, chip_t


def _pair(nets, chip=True, **kw):
    """A JAX server and the port's, built alike; ``kw`` holds port-side
    configs whose JAX twin has the same fields."""
    hw_j, hw_t, chip_j, chip_t = nets
    twins = {AdmissionConfig: JAdmissionConfig,
             DynamicHopConfig: JDynamicHopConfig, VADConfig: JVADConfig}
    kw_j = {k: (twins[type(v)](**vars(v)) if type(v) in twins else v)
            for k, v in kw.items()}
    ref = JStreamServer(hw_j, JCFG, hop=HOP, use_kernel=False,
                        chip_offsets=chip_j if chip else None,
                        compiled=None, **kw_j)
    port = StreamServer(hw_t, CFG, hop=HOP, use_kernel=True,
                        chip_offsets=chip_t if chip else None,
                        device="cpu", **kw)
    return ref, port


def _same_events(ev_port, ev_ref):
    strip = lambda es: [{k: e[k] for k in ("stream", "hop", "keyword",
                                            "trigger")} for e in es]
    assert strip(ev_port) == strip(ev_ref)
    np.testing.assert_allclose([e["score"] for e in ev_port],
                               [e["score"] for e in ev_ref], rtol=0,
                               atol=SCORE_ATOL)


def _same_stats(port, ref):
    st, st_ref = port.stats(), ref.stats()
    for k in COUNTERS:
        assert st[k] == st_ref[k], (k, st[k], st_ref[k])
    assert {s: (p["hops"], p["gated_hops"], p["triggers"], p["sheds"])
            for s, p in st["per_stream"].items()} == {
        s: (p["hops"], p["gated_hops"], p["triggers"], p["sheds"])
        for s, p in st_ref["per_stream"].items()}
    return st


def test_backpressure_reject_shed_autoscale(nets):
    """The reference's backpressure scenario: a one-slot pool with a
    one-stream queue rejects the third stream, grows under queue pressure,
    sheds the flooded stream past its SLO, keeps deciding, and shrinks
    back once idle."""
    servers = _pair(nets, slots=1, admission=AdmissionConfig(
        max_queue=1, max_lag_s=0.06, min_slots=1, max_slots=2,
        scale_up_after=1, scale_down_after=2))
    rng = np.random.default_rng(6)
    mk = lambda n: rng.uniform(-1, 1, n).astype(np.float32)
    audio = [mk(L) for _ in range(3)] + [mk(4000) for _ in range(4)]
    places = [[srv.submit(k, a) for k, a in zip("abc", audio[:3])]
              for srv in servers]
    assert places[0] == places[1] == ["slot", "queued", "rejected"]
    events = [[], []]
    trace = [[], []]
    for j, srv in enumerate(servers):
        events[j] += srv.step()
        trace[j].append(srv.slots)
        for a in audio[3:]:
            srv.submit("a", a)
            events[j] += srv.step()
            trace[j].append(srv.slots)
        srv.finish("a")
        srv.finish("b")
        events[j] += srv.drain()
        for _ in range(3):
            events[j] += srv.step()
            trace[j].append(srv.slots)
    assert trace[0] == trace[1]
    _same_events(events[1], events[0])
    st = _same_stats(servers[1], servers[0])
    assert st["shed"]["events"] >= 1 and st["per_stream"]["a"]["sheds"] >= 1
    assert st["rejected_streams"] == 1 and "c" not in st["per_stream"]
    assert 2 in trace[1] and servers[1].slots == 1
    assert servers[1]._streams["a"].shed_samples == \
        servers[0]._streams["a"].shed_samples > 0
    assert not servers[1].active_streams()


def _results(hw_t):
    """A customization result of each package: the base fold with an
    integer bias bump on conv2 and conv4 and a moved head."""
    hwp = hw_t.hw
    bias = {n: hwp.bias[n].numpy().copy() for n in CFG.imc_layer_names()}
    bias["conv2"] += 2.0
    bias["conv4"][::3] -= 2.0
    fc_w = hwp.fc_w.numpy().copy()
    fc_w[:, 3] += 2 / 128
    fc_b = hwp.fc_b.numpy() + 1 / 128
    kw = dict(bias=bias, fc_w=fc_w, fc_b=fc_b, epochs=1, n_utterances=2,
              history=[], energy={})
    return jcz.CustomizationResult(**kw), CustomizationResult(**kw)


@pytest.mark.parametrize("vad", [False, True], ids=["no_vad", "vad"])
def test_customized_slot_rides_a_resize(nets, vad):
    """A customized stream admitted into a grown slot keeps its riders
    while the pool grows to three slots and shrinks to two under it; the
    events equal JAX's (bias delta, head and, with VAD, silence fill)."""
    res_j, res_t = _results(nets[1])
    kw = dict(slots=1, admission=AdmissionConfig(
        max_queue=4, min_slots=1, max_slots=3, scale_up_after=1,
        scale_down_after=2))
    if vad:
        kw["vad"] = VADConfig()
    servers = _pair(nets, **kw)
    rng = np.random.default_rng(21)
    long_a = rng.uniform(-1, 1, L + 16 * HOP).astype(np.float32)
    long_u = rng.uniform(-1, 1, L + 16 * HOP).astype(np.float32)
    long_u[L + 4 * HOP:L + 10 * HOP] *= 1e-4          # a silent run
    short_b = rng.uniform(-1, 1, L + 3 * HOP).astype(np.float32)
    events, slots = [[], []], [[], []]
    for j, (srv, res) in enumerate(zip(servers, (res_j, res_t))):
        srv.submit("a", long_a)
        srv.install_custom("u", res)
        srv.submit("u", long_u)
        srv.submit("b", short_b)
        for sid in "aub":
            srv.finish(sid)
        for _ in range(40):
            events[j] += srv.step()
            slots[j].append((srv.slots, srv._streams["u"].slot))
    assert slots[0] == slots[1]
    # u (customized) sits in grown slot 1 while the pool shrinks 3 -> 2,
    # then the pool drains back to one slot
    grown = slots[1].index((3, 1))
    assert (2, 1) in slots[1][grown:] and slots[1][-1] == (1, None)
    _same_events(events[1], events[0])
    _same_stats(servers[1], servers[0])
    port = servers[1]
    assert port._slot_head_w.shape[0] == port._slot_delta["conv1"].shape[0] \
        == 1
    assert {e["stream"] for e in events[1]} == {"a", "u", "b"}


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
def test_dynamic_hop_matches_jax(nets, noisy):
    """The reference's calm-then-loud stream: the multiplier widens to 4
    on the calm run and snaps back to 1 on the wake, tick for tick as in
    JAX, with equal events; the noisy case (SA noise 1.0, duty-aware
    ``calm_silence``) restarts each rebuilt stream's field at window 0."""
    hop_cfg = DynamicHopConfig(max_multiplier=4, widen_after=3,
                               calm_score=0.35,
                               calm_silence=2 if noisy else None)
    servers = _pair(nets, slots=2, sa_noise_std=1.0 if noisy else 0.0,
                    seed=4, dynamic_hop=hop_cfg,
                    vad=VADConfig(threshold_on_db=-40.0,
                                  threshold_off_db=-50.0, wake_margin=1,
                                  hang=0))
    rng = np.random.default_rng(7)
    wav = (1e-4 * rng.standard_normal(L + 40 * HOP)).astype(np.float32)
    wav[:L] = rng.uniform(-1, 1, L)
    wav[L + 30 * HOP:] = rng.uniform(-1, 1, 10 * HOP)
    other = rng.uniform(-1, 1, L + 40 * HOP).astype(np.float32)
    other[L:L + 28 * HOP] *= 1e-4
    events, mults = [[], []], [[], []]
    for j, srv in enumerate(servers):
        srv.submit("d", wav)
        srv.submit("e", other)
        srv.finish("d")
        srv.finish("e")
        while srv.active_streams():
            events[j] += srv.step()
            mults[j].append(srv.hop_multiplier)
    assert mults[0] == mults[1]
    assert max(mults[1]) == 4 and 1 in mults[1][mults[1].index(4):]
    _same_events(events[1], events[0])
    st = _same_stats(servers[1], servers[0])
    assert st["hop_retargets"] >= 2
    port = servers[1]
    assert port.hop == HOP * port.hop_multiplier
    assert not port._feasible_mult(L // HOP) and port._feasible_mult(2)
    # every retarget re-init ran one IMC forward beyond the batched calls
    calls = st["batched_calls"]
    assert st["imc_passes"] > calls["init"] + calls["hop"] + calls["replay"]


def test_dynamic_hop_refuses_customization(nets):
    _, port = _pair(nets, chip=False, slots=1,
                    dynamic_hop=DynamicHopConfig())
    with pytest.raises(ValueError, match="fixed hop"):
        port.customize("u")


def test_slot_bounds_are_checked(nets):
    hw_t = nets[1]
    with pytest.raises(ValueError, match="min_slots"):
        StreamServer(hw_t, CFG, hop=HOP, slots=4, device="cpu",
                     admission=AdmissionConfig(min_slots=2, max_slots=3))
    srv = StreamServer(hw_t, CFG, hop=HOP, slots=2, device="cpu",
                       admission=AdmissionConfig(max_queue=0))
    assert srv.stats()["slot_range"] == [2, 2]
    z = np.zeros(L, np.float32)
    assert [srv.submit(s, z) for s in "xyz"] == ["slot", "slot", "rejected"]
    assert srv.stats()["rejected_streams"] == 1


def test_submit_uid_pins_the_noise_field(nets):
    """A stream submitted with ``uid=5`` draws the noise field of uid 5:
    its events equal JAX's for the same calls and equal the port's own
    events for a stream that reached uid 5 by submission order; the next
    unpinned stream takes uid 6."""
    auds = [np.random.default_rng(30 + i).uniform(
        -1, 1, L + 6 * HOP).astype(np.float32) for i in range(2)]
    servers = _pair(nets, slots=2, sa_noise_std=1.0, seed=11)
    events = []
    for srv in servers:
        srv.submit("x", auds[0], uid=5)
        srv.submit("y", auds[1])
        for sid in "xy":
            srv.finish(sid)
        events.append(srv.drain())
    _same_events(events[1], events[0])
    port = servers[1]
    assert (port._streams["x"].uid, port._streams["y"].uid) == (5, 6)
    by_order = StreamServer(nets[1], CFG, hop=HOP, slots=1, sa_noise_std=1.0,
                            seed=11, chip_offsets=nets[3], device="cpu")
    for k in range(5):
        by_order.submit(f"f{k}", np.zeros(0, np.float32))
        by_order.evict(f"f{k}")
    by_order.submit("x", auds[0])
    by_order.finish("x")
    assert [e for e in events[1] if e["stream"] == "x"] == by_order.drain()
