"""A noisy StreamServer on the port against the JAX package's interpreted
one (``compiled=None``, fused kernel on), on the CPU: SA noise 1.0, chip
offsets from ``sample_chip_offsets(PRNGKey(0))``, VAD on, with constant
and with retention silence fills.

Both servers run with the flight recorder and the launch auditor (raise
mode) on: their recorder events (admissions, evictions, ticks with
their composition and modelled uJ) must be equal, every field, and so
must the auditor's per-tick batched calls, with no violation.

Tolerances: events equal on stream, hop, keyword and trigger, ``score``
within 1e-6 absolute (softmax and the smoothing sum round differently in
the last ulps between the libraries, as in ``test_torch_server.py``);
serving counters and the retention fills equal.  Small config:
``sample_len=640``, ``hop=64``; the folded net is the port's, carried to
the JAX package as numpy leaves (``test_torch_noise.jax_hw``).
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import imc as jimc
from repro.models import kws as jkws
from repro.serving import DecisionConfig as JDecisionConfig
from repro.serving import StreamServer as JStreamServer
from repro.serving import VADConfig as JVADConfig
from repro_torch.core import imc, jaxrand
from repro_torch.models import kws
from repro_torch.obs import ObsConfig
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
    chip_j = jimc.sample_chip_offsets(jax.random.PRNGKey(0), CHANS,
                                      jimc.IMCNoiseParams(mav_offset_std=4.0))
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


@pytest.mark.parametrize("fill", ["constant", "retention"])
def test_noisy_server_matches_jax(nets, fill):
    """SA noise 1.0, chip offsets, VAD on: events (``score`` within 1e-6),
    serving counters, recorder events and the auditor's per-tick calls
    equal JAX's interpreted server."""
    hw_j, hw_t, chip_j, chip_t = nets
    auds = [_duty(L + (14 + 3 * i) * HOP, 300 + i) for i in range(3)]
    ref = JStreamServer(hw_j, JCFG, hop=HOP, slots=2, use_kernel=True,
                        chip_offsets=chip_j, sa_noise_std=STD, seed=7,
                        vad=JVADConfig(), silence_fill=fill,
                        decision=JDecisionConfig(**DECISION), compiled=None,
                        obs=jobs.ObsConfig(recorder=256, audit="raise"))
    port = StreamServer(hw_t, CFG, hop=HOP, slots=2, use_kernel=True,
                        chip_offsets=chip_t, sa_noise_std=STD, seed=7,
                        vad=VADConfig(), silence_fill=fill,
                        decision=DecisionConfig(**DECISION), device="cpu",
                        obs=ObsConfig(recorder=256, audit="raise"))
    evs = []
    for srv in (ref, port):
        for i, x in enumerate(auds):
            srv.submit(f"s{i}", x)
            srv.finish(f"s{i}")
        evs.append(srv.drain())
    ev_ref, ev_port = evs
    strip = lambda es: [{k: e[k] for k in ("stream", "hop", "keyword",
                                            "trigger")} for e in es]
    assert strip(ev_port) == strip(ev_ref)
    np.testing.assert_allclose([e["score"] for e in ev_port],
                               [e["score"] for e in ev_ref], rtol=0,
                               atol=SCORE_ATOL)
    st_ref, st_port = ref.stats(), port.stats()
    for k in ("steps", "decisions", "speech_hops", "gated_hops",
              "batched_calls"):
        assert st_port[k] == st_ref[k], k
    assert st_port["gated_hops"] > 0 and st_port["batched_calls"]["replay"]
    assert port.recorder.events() == ref.recorder.events()
    assert port.recorder.events("evict") and port.recorder.events("tick")
    assert port.auditor.violations == ref.auditor.violations == []
    assert ([(h["tick"], h["calls"]) for h in port.auditor.history()]
            == [(h["tick"], h["calls"]) for h in ref.auditor.history()])
    if fill == "retention":
        for a, b in zip(port._fills, ref._fills):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
