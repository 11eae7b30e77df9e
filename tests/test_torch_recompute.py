"""The port's recompute path (``streaming=False``) and the energy of a
tick against the JAX package, on the CPU.

* ``window_init`` / ``window_step`` / ``window_multi_step`` /
  ``gated_window_step`` equal JAX's on the same windows, clean and on a
  noisy chip (SA noise 1.0 and chip offsets), with and without the
  per-stream bias-delta and head riders; and they equal the port's own
  streaming path hop by hop.
* A ``StreamServer(streaming=False)`` equals JAX's interpreted recompute
  server (``compiled=None``) on duty-cycled traffic with VAD gating and
  wake replays, and equals the port's streaming server when no hop is
  gated (VAD forced to speech: a gated hop slides zeros into the
  recompute window but the silence fill into the streaming carries, so
  the two agree only on computed hops, in the reference too).
* ``StreamServer._tick_uj`` and ``energy.streaming_energy_summary`` give
  JAX's numbers.

Tolerances: none for logits, states and counters (bitwise); decision
``score`` within 1e-6 absolute, as in ``test_torch_server.py`` (softmax and
the smoothing sum round differently in the last ulps between the
libraries).  Small config: ``sample_len=640``, ``hop=64``; the net is the
port's, carried to JAX as numpy leaves (``test_torch_noise.jax_hw``); the
JAX side runs its plain (``use_kernel=False``) route.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import energy as jenergy
from repro.core import imc as jimc
from repro.models import kws as jkws
from repro.serving import DecisionConfig as JDecisionConfig
from repro.serving import StreamServer as JStreamServer
from repro.serving import VADConfig as JVADConfig
from repro.serving import stream as jsv
from repro_torch.core import energy, imc, jaxrand
from repro_torch.models import kws
from repro_torch.serving import stream as sv
from repro_torch.serving.decision import DecisionConfig
from repro_torch.serving.scheduler import StreamServer
from repro_torch.serving.vad import VADConfig
from test_torch_noise import CHANS, jax_hw

L, HOP = 640, 64
JCFG = jkws.KWSConfig(sample_len=L)
CFG = kws.KWSConfig(sample_len=L)
STD = 1.0
SCORE_ATOL = 1e-6
DECISION = dict(smooth=2, threshold_on=0.27, threshold_off=0.25,
                refractory=2)


@pytest.fixture(scope="module")
def nets():
    params = kws.init_params(jaxrand.PRNGKey(5, device="cpu"), CFG,
                             device="cpu")
    hw_t = kws.fold_params(params, kws.init_state(CFG, device="cpu"), CFG,
                           pack=True)
    noise = jimc.IMCNoiseParams(mav_offset_std=4.0)
    chip_j = jimc.sample_chip_offsets(jax.random.PRNGKey(0), CHANS, noise)
    chip_t = imc.sample_chip_offsets(jaxrand.PRNGKey(0, "cpu"), CHANS,
                                     imc.IMCNoiseParams(mav_offset_std=4.0))
    return jax_hw(hw_t), hw_t, chip_j, chip_t


def _duty(n, seed, duty=0.45, period=3 * HOP):
    r = np.random.default_rng(seed)
    x = r.uniform(-1.0, 1.0, n).astype(np.float32)
    t = 0
    while t < n:
        if r.random() > duty:
            x[t:t + period] *= 1e-4
        t += period
    return x


def _riders(hw_t, b, seed):
    """Integer bias deltas and a Q1.7 head per row (row 0 the base)."""
    rng = np.random.default_rng(seed)
    delta = {n: rng.integers(-3, 4, (b, CFG.channels[i])).astype(np.float32)
             for i, n in enumerate(CFG.imc_layer_names(), start=1)}
    for d in delta.values():
        d[0] = 0.0
    fw = hw_t.hw.fc_w.numpy()
    hw_rows = np.stack([fw] * b)
    hw_rows[1:] += rng.integers(-2, 3, hw_rows[1:].shape) / 128.0
    hb_rows = np.stack([hw_t.hw.fc_b.numpy()] * b)
    hb_rows[1:] += rng.integers(-2, 3, hb_rows[1:].shape) / 128.0
    return delta, hw_rows.astype(np.float32), hb_rows.astype(np.float32)


def _eq(t, j, what):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=what)


@pytest.mark.parametrize("riders", [False, True], ids=["base", "riders"])
@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
def test_window_path_matches_jax_and_streaming(nets, noisy, riders):
    hw_j, hw_t, chip_j, chip_t = nets
    b, n_hops = 3, 4
    std = STD if noisy else 0.0
    geom_t = sv.make_stream_geometry(CFG, HOP)
    geom_j = jsv.make_stream_geometry(JCFG, HOP)
    audio = np.random.default_rng(11).uniform(
        -1, 1, (b, L + n_hops * HOP)).astype(np.float32)
    keys_j = jnp.stack([jax.random.fold_in(jax.random.PRNGKey(3), u)
                        for u in range(b)])
    keys_t = jaxrand.key_from_numpy(np.asarray(keys_j), "cpu")
    kw_t = dict(chip_offsets=chip_t if noisy else None, sa_noise_std=std,
                use_kernel=True)
    kw_j = dict(chip_offsets=chip_j if noisy else None, sa_noise_std=std,
                use_kernel=False)
    if riders:
        d, hw_rows, hb_rows = _riders(hw_t, b, 4)
        kw_t.update(bias_delta={k: torch.tensor(v) for k, v in d.items()},
                    head_w=torch.tensor(hw_rows),
                    head_b=torch.tensor(hb_rows))
        kw_j.update(bias_delta={k: jnp.asarray(v) for k, v in d.items()},
                    head_w=jnp.asarray(hw_rows), head_b=jnp.asarray(hb_rows))

    j_init = jax.jit(lambda w, k: jsv.window_init(hw_j, w, k, JCFG, geom_j,
                                                  **kw_j))
    j_step = jax.jit(lambda st, a: jsv.window_step(hw_j, st, a, JCFG, geom_j,
                                                   **kw_j))
    lt, wst = sv.window_init(hw_t, torch.tensor(audio[:, :L]), CFG, geom_t,
                             keys=keys_t, **kw_t)
    lj, wsj = j_init(jnp.asarray(audio[:, :L]), keys_j)
    ls, sst = sv.stream_init(hw_t, torch.tensor(audio[:, :L]), CFG, geom_t,
                             keys=keys_t, **kw_t)
    _eq(lt, lj, "init logits vs JAX")
    assert torch.equal(lt, ls), "recompute init differs from streaming"
    start = wst
    for t in range(1, n_hops + 1):
        chunk = audio[:, L + (t - 1) * HOP:L + t * HOP]
        lt, wst = sv.window_step(hw_t, wst, torch.tensor(chunk), CFG, geom_t,
                                 **kw_t)
        lj, wsj = j_step(wsj, jnp.asarray(chunk))
        ls, sst = sv.stream_step(hw_t, sst, torch.tensor(chunk), CFG,
                                 geom_t, **kw_t)
        _eq(lt, lj, f"hop {t} logits vs JAX")
        assert torch.equal(lt, ls), f"hop {t}: recompute differs from " \
                                    f"streaming"
        for a, j in zip(wst, wsj):
            _eq(a, j, f"hop {t} window state")
    lm, wsm = sv.window_multi_step(hw_t, start, torch.tensor(
        audio[:, L:]), CFG, geom_t, n_hops, **kw_t)
    assert lm.shape == (b, n_hops, CFG.num_classes)
    assert torch.equal(lm[:, -1], lt)
    for a, c in zip(wsm, wst):
        assert torch.equal(a, c)
    gated_t = sv.gated_window_step(wst, geom_t)
    gated_j = jsv.gated_window_step(wsj, geom_j)
    for a, j in zip(gated_t, gated_j):
        _eq(a, j, "gated window state")


def _serve(srv, auds):
    for i, x in enumerate(auds):
        srv.submit(f"s{i}", x)
        srv.finish(f"s{i}")
    return srv.drain()


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
def test_recompute_server_matches_jax(nets, noisy):
    """Three duty-cycled streams on two slots, VAD on (gating and wake
    replays): the recompute server's events and counters equal JAX's
    recompute server."""
    hw_j, hw_t, chip_j, chip_t = nets
    std = STD if noisy else 0.0
    auds = [_duty(L + (14 + 3 * i) * HOP, 400 + i) for i in range(3)]
    ref = JStreamServer(hw_j, JCFG, hop=HOP, slots=2, use_kernel=False,
                        streaming=False, chip_offsets=chip_j,
                        sa_noise_std=std, seed=3, vad=JVADConfig(),
                        decision=JDecisionConfig(**DECISION), compiled=None)
    port = StreamServer(hw_t, CFG, hop=HOP, slots=2, use_kernel=True,
                        streaming=False, chip_offsets=chip_t,
                        sa_noise_std=std, seed=3, vad=VADConfig(),
                        decision=DecisionConfig(**DECISION), device="cpu")
    ev_ref, ev_port = _serve(ref, auds), _serve(port, auds)
    strip = lambda es: [{k: e[k] for k in ("stream", "hop", "keyword",
                                            "trigger")} for e in es]
    assert strip(ev_port) == strip(ev_ref)
    np.testing.assert_allclose([e["score"] for e in ev_port],
                               [e["score"] for e in ev_ref], rtol=0,
                               atol=SCORE_ATOL)
    st_ref, st = ref.stats(), port.stats()
    for k in ("mode", "steps", "decisions", "speech_hops", "gated_hops",
              "batched_calls", "hop", "base_hop", "hop_multiplier",
              "slot_range", "rejected_streams", "shed"):
        assert st[k] == st_ref[k], k
    calls = st["batched_calls"]
    assert st["mode"] == "recompute" and port._fills is None
    assert st["gated_hops"] > 0 and calls["replay"] > 0 and calls["gate"]
    # a recompute replay of n >= 2 hops runs n IMC forwards
    assert st["imc_passes"] > calls["init"] + calls["hop"] + calls["replay"]


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noisy"])
def test_recompute_server_equals_streaming(nets, noisy):
    """With every hop computed (VAD forced to speech), the recompute and
    the streaming server give the same events bit for bit, and the
    recompute server runs one IMC forward per batched call as the
    streaming one does."""
    _, hw_t, _, chip_t = nets
    std = STD if noisy else 0.0
    auds = [_duty(L + (10 + 3 * i) * HOP, 500 + i) for i in range(3)]
    runs = {}
    for streaming in (False, True):
        srv = StreamServer(hw_t, CFG, hop=HOP, slots=2, use_kernel=True,
                           streaming=streaming, chip_offsets=chip_t,
                           sa_noise_std=std, seed=3,
                           vad=VADConfig(force="speech"),
                           decision=DecisionConfig(**DECISION), device="cpu")
        runs[streaming] = (_serve(srv, auds), srv.stats())
    assert runs[False][0] == runs[True][0]
    assert any(e["trigger"] for e in runs[False][0])
    st, st_s = runs[False][1], runs[True][1]
    for k in ("steps", "decisions", "speech_hops", "batched_calls",
              "imc_passes"):
        assert st[k] == st_s[k], k
    assert st["gated_hops"] == 0 and st["imc_passes"] == (
        st["batched_calls"]["init"] + st["batched_calls"]["hop"])


def test_recompute_server_refuses_customization(nets):
    _, hw_t, _, _ = nets
    srv = StreamServer(hw_t, CFG, hop=HOP, slots=2, streaming=False,
                       device="cpu")
    with pytest.raises(ValueError, match="streaming=True"):
        srv.customize("u")


def test_tick_energy_matches_jax(nets):
    """``_tick_uj`` at hop multipliers 1 and 2 and
    ``streaming_energy_summary`` equal the JAX package's numbers."""
    hw_j, hw_t, _, _ = nets
    ref = JStreamServer(hw_j, JCFG, hop=HOP, slots=2, use_kernel=False,
                        vad=JVADConfig(), compiled=None)
    port = StreamServer(hw_t, CFG, hop=HOP, slots=2, vad=VADConfig(),
                        device="cpu")
    for mult in (1, 2):
        ref._mult = port._mult = mult
        for computed, gated in ((0, 0), (3, 0), (0, 2), (5, 7)):
            assert port._tick_uj(computed, gated) == ref._tick_uj(
                computed, gated), (mult, computed, gated)
        got = energy.streaming_energy_summary(
            kws.layer_stats(CFG), sv.streaming_layer_stats(CFG, port.geom))
        want = jenergy.streaming_energy_summary(
            jkws.layer_stats(JCFG), jsv.streaming_layer_stats(JCFG,
                                                              ref.geom))
        assert got == want
        assert got["energy_ratio"] < 1.0
