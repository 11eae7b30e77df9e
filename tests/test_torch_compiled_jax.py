"""The port's compiled server against the JAX package's interpreted one.

JAX's compiled tick fails its own tests (``tests/test_compiled.py``'s soak
and golden trace), so the port's compiled blocks are held against JAX's
interpreted ``StreamServer`` (``compiled=None``, plain route) in two of
the reference's cases: ``noise_and_chip`` (SA noise, chip offsets, VAD
gating with wake replays) and ``fault_drift`` (a drifting fault model
whose chip delta changes inside the blocks).

Held: the events (``score`` within 1e-6, the stated difference of the
softmax and smoothing sums), every stream-state leaf bit for bit (the
noise-field keys as the JAX package's uint32 words), the decision state
(posteriors within 1e-6, the rest exact), the VAD state bit for bit, the
serving counters and the recorder's events.  Small config:
``sample_len=640``, ``hop=64``; the port's net carried to JAX as numpy
(``test_torch_noise.jax_hw``).
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import numpy as np
import pytest

from repro import obs as jobs
from repro.core import faults as jflt
from repro.core import imc as jimc
from repro.models import kws as jkws
from repro.serving import StreamServer as JStreamServer
from repro.serving import VADConfig as JVADConfig
from repro_torch.core import faults as flt
from repro_torch.core import imc, jaxrand
from repro_torch.models import kws
from repro_torch.obs import ObsConfig
from repro_torch.serving import CompiledTickConfig, StreamServer, VADConfig
from test_torch_compiled import _duty
from test_torch_noise import CHANS, jax_hw

L, HOP = 640, 64
CFG = kws.KWSConfig(sample_len=L)
JCFG = jkws.KWSConfig(sample_len=L)
SCORE_ATOL = 1e-6
TICKS = 24

pytestmark = [pytest.mark.streaming, pytest.mark.compiled]


@pytest.fixture(scope="module")
def nets():
    params = kws.init_params(jaxrand.PRNGKey(5, device="cpu"), CFG,
                             device="cpu")
    hw_t = kws.fold_params(params, kws.init_state(CFG, device="cpu"), CFG,
                           pack=True)
    return jax_hw(hw_t), hw_t


def _chips():
    noise = dict(mav_offset_std=4.0)
    return (jimc.sample_chip_offsets(jax.random.PRNGKey(9), CHANS,
                                     jimc.IMCNoiseParams(**noise)),
            imc.sample_chip_offsets(jaxrand.PRNGKey(9, "cpu"), CHANS,
                                    imc.IMCNoiseParams(**noise)))


def _kwargs(case):
    """(JAX server kwargs, port server kwargs) of a case."""
    if case == "noise_and_chip":
        chip_j, chip_t = _chips()
        return (dict(vad=JVADConfig(), sa_noise_std=0.15,
                     chip_offsets=chip_j),
                dict(vad=VADConfig(), sa_noise_std=0.15,
                     chip_offsets=chip_t))
    return (dict(vad=JVADConfig(), faults=jflt.FaultConfig(drift_std=0.5)),
            dict(vad=VADConfig(), faults=flt.FaultConfig(drift_std=0.5)))


@pytest.mark.parametrize("case", ["noise_and_chip", "fault_drift"])
def test_compiled_port_matches_jax_interpreted(nets, case):
    hw_j, hw_t = nets
    kw_j, kw_t = _kwargs(case)
    ref = JStreamServer(hw_j, JCFG, hop=HOP, slots=3, use_kernel=False,
                        compiled=None,
                        obs=jobs.ObsConfig(recorder=512), **kw_j)
    port = StreamServer(hw_t, CFG, hop=HOP, slots=3, device="cpu",
                        compiled=CompiledTickConfig(block=8),
                        obs=ObsConfig(recorder=512), **kw_t)
    auds = [_duty(L + 22 * HOP, 100 + i) for i in range(3)]
    for srv in (ref, port):
        for i, x in enumerate(auds):
            srv.submit(f"s{i}", x)
    ev_ref = []
    while ref._steps < TICKS:
        ev_ref += ref.step()
    ev_port = []
    while port._steps < TICKS:
        ev_port += port.step_block(TICKS - port._steps)
    assert port._compiled_ticks > TICKS // 2

    strip = lambda es: [{k: e[k] for k in ("stream", "hop", "keyword",
                                            "trigger")} for e in es]
    assert strip(ev_port) == strip(ev_ref) and ev_port
    np.testing.assert_allclose([e["score"] for e in ev_port],
                               [e["score"] for e in ev_ref], rtol=0,
                               atol=SCORE_ATOL)
    st_p, st_j = port._state, ref._state
    for a, b in zip((st_p.audio_carry, *st_p.carries, st_p.ring, st_p.hop),
                    (st_j.audio_carry, *st_j.carries, st_j.ring, st_j.hop)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(jaxrand.key_to_numpy(st_p.key),
                                  np.asarray(st_j.key))
    for f in port._dstate._fields:
        a, b = getattr(port._dstate, f).numpy(), np.asarray(
            getattr(ref._dstate, f))
        if f == "posteriors":
            np.testing.assert_allclose(a, b, rtol=0, atol=SCORE_ATOL)
        else:
            np.testing.assert_array_equal(a, b)
    for a, b in zip(port._vstate, ref._vstate):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    sp, sj = port.stats(), ref.stats()
    for k in ("steps", "decisions", "speech_hops", "gated_hops",
              "batched_calls", "duty_cycle"):
        assert sp[k] == sj[k], k
    assert sp["batched_calls"]["replay"] > 0 and sp["gated_hops"] > 0
    assert port.recorder.events() == ref.recorder.events()
    if case == "fault_drift":
        assert port.faults.stats() == ref.faults.stats()
