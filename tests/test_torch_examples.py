"""The port's examples (``repro_torch.examples``) at their smoke sizes on
the CPU (``REPRO_EXAMPLES_SMOKE=1``, ``--device cpu``), in process, with
their landmark lines asserted as ``tests/test_examples.py`` asserts the
reference's.

``stream_kws`` is held to the JAX package's ``StreamServer`` on its plain
route (``use_kernel=False``), fed the example's own streams
(``stream_kws.make_streams``) and its own net: the port's ``init_params``
from ``jaxrand.PRNGKey(0)`` draws the reference's net bit for bit (held
here leaf for leaf), folded by the port and carried into JAX.  Every event
(stream, hop, keyword, trigger) must be equal and every score within 1e-6,
and the example's TRIGGER lines and decision count must be the ones the
reference's events print.  ``customize_onchip`` asserts inside itself
that its enrollment session lands on the offline loop's head bit for bit.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import kws as jkws
from repro.serving import DecisionConfig as JDecisionConfig
from repro.serving import StreamServer as JStreamServer
from repro.serving import VADConfig as JVADConfig
from repro_torch.core import jaxrand
from repro_torch.examples import customize_onchip, quickstart, stream_kws
from repro_torch.models import kws


def _run(example, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_EXAMPLES_SMOKE", "1")
    example.main(["--device", "cpu"])
    return capsys.readouterr().out


def test_quickstart_example(monkeypatch, capsys):
    out = _run(quickstart, monkeypatch, capsys)
    for landmark in ("== 1) train", "hw accuracy:", "noisy   :",
                     "compensated:", "before:", "after :"):
        assert landmark in out, landmark


def test_customize_onchip_example(monkeypatch, capsys):
    out = _run(customize_onchip, monkeypatch, capsys)
    assert "before customization" in out
    assert "+ SGA" in out
    # the serving-session demo ran and matched the offline loop bit-exactly
    assert "bit-identical to the offline loop" in out


def _jax_hw(hw_t):
    """The port's folded net as the JAX package's ``HWParams``."""
    hw = hw_t.hw
    leaves = {f: {k: jnp.asarray(v.numpy()) for k, v in getattr(hw,
                                                                f).items()}
              for f in ("w_bin", "bias", "flip")}
    return jkws.HWParams(**leaves, fc_w=jnp.asarray(hw.fc_w.numpy()),
                         fc_b=jnp.asarray(hw.fc_b.numpy()))


@pytest.fixture(scope="module")
def reference_run():
    """The reference's serving of the smoke-size streams on the port's
    net: (JAX events, JAX stats, the port's folded net)."""
    window, hop, n, tail = stream_kws.sizes(True)
    cfg = kws.KWSConfig(sample_len=window)
    jcfg = jkws.KWSConfig(sample_len=window)
    # the example's net is the reference's draw, leaf for leaf
    mine = kws.init_params(jaxrand.PRNGKey(0, device="cpu"), cfg,
                           device="cpu")
    theirs = jkws.init_params(jax.random.PRNGKey(0), jcfg)
    for layer, leaves in theirs.items():
        for name, v in leaves.items():
            assert np.array_equal(mine[layer][name].numpy(), np.asarray(v)), \
                (layer, name)
    hw = stream_kws.folded_net(cfg, "cpu")
    d, v = stream_kws.DECISION, stream_kws.VAD
    srv = JStreamServer(
        _jax_hw(hw), jcfg, hop=hop, slots=4, use_kernel=False,
        decision=JDecisionConfig(smooth=d.smooth,
                                 threshold_on=d.threshold_on,
                                 threshold_off=d.threshold_off,
                                 refractory=d.refractory),
        vad=JVADConfig(threshold_on_db=v.threshold_on_db,
                       threshold_off_db=v.threshold_off_db,
                       wake_margin=v.wake_margin, hang=v.hang))
    for sid, (wav, _, _) in stream_kws.make_streams(window, hop, n,
                                                     tail).items():
        for off in range(0, len(wav), stream_kws.CHUNK):
            srv.submit(sid, wav[off:off + stream_kws.CHUNK])
        srv.finish(sid)
    return srv.drain(), srv.stats(), hw


def test_stream_kws_example_against_the_reference(monkeypatch, capsys,
                                                  reference_run):
    events, stats, hw = reference_run
    out = _run(stream_kws, monkeypatch, capsys)
    assert "serving 1 streams" in out
    assert "VAD duty cycle" in out
    assert f"== {stats['decisions']} decisions," in out
    assert f"({stats['speech_hops']} speech / {stats['gated_hops']} gated " \
        "hops)" in out
    got = [ln for ln in out.splitlines() if "TRIGGER" in ln]
    want = [stream_kws.trigger_line(ev) for ev in events if ev["trigger"]]
    assert got == want
    # every event of the example's server, not only the triggers
    window, hop, n, tail = stream_kws.sizes(True)
    cfg = kws.KWSConfig(sample_len=window)
    _, mine = stream_kws.serve(hw, cfg, hop, stream_kws.make_streams(
        window, hop, n, tail), "cpu")
    assert len(mine) == len(events) == stats["decisions"]
    for a, b in zip(mine, events):
        assert (a["stream"], a["hop"], a["keyword"], a["trigger"]) == \
            (b["stream"], b["hop"], b["keyword"], b["trigger"])
        assert abs(a["score"] - b["score"]) <= 1e-6
