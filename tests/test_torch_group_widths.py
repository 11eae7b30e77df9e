"""Group widths off the paper net's, on the port against the JAX package,
on the CPU, bit for bit.

The paper's IMC macro takes 24 input channels per group (cpg).  Smaller
and wider macros are the trade-off of the paper's macro-size discussion,
and the reference computes them: its fused layer pads groups to its TPU
tiles.  Here the port's fused layer (the plain version the Hopper kernel
is held to on a card) at cpg 6, 18, 40 and 48 and cog 9, 18 and 24, on
both entries, against the JAX package's Pallas kernel in interpret mode
and its count-exact oracle; the fold-time int8 rows at those widths; and
a whole ``StreamServer`` (chip offsets, VAD, gating and wake replays) at
``KWSConfig(channels_per_group=6)`` — (groups, cog) per IMC layer (4, 24)
(16, 12) (32, 9) (48, 8) (64, 9) — and at the cpg-48 net
``KWSConfig(channels=(48, 96, 192, 288, 384, 576), channels_per_group=48)``
— (1, 96) (2, 96) (4, 72) (6, 64) (8, 72) — against the interpreted JAX
``StreamServer``: events (``score`` within 1e-6, as in
tests/test_torch_server.py), serving counters and every state leaf.
Small config: ``sample_len=640``, ``hop=64``; the net is folded by the
port and carried to the JAX package as numpy leaves.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax.numpy as jnp
import numpy as np
import pytest

from repro.models import kws as jkws
from repro.serving import StreamServer as JStreamServer
from repro.serving import VADConfig as JVADConfig
from repro_torch.core import jaxrand
from repro_torch.models import kws
from repro_torch.serving.scheduler import StreamServer
from repro_torch.serving.vad import VADConfig
from test_torch_imc_fused import (_jax_fused, _jax_oracle, _layer_inputs,
                                  _port)
from test_torch_noise import jax_hw

# (c_in, c_out, groups) of layers whose groups the paper's cpg-24 layout
# does not cover: cpg 6 with cog 9 (as conv3 and conv5 of
# KWSConfig(channels_per_group=6)), cpg 18, cog 18, and cpg 40 and 48
# (two int8 k-steps a tap, as conv1 of the cpg-48 net) with cog 48, 9, 18
GROUP_WIDTHS = [
    pytest.param(24, 36, 4, id="cpg6-cog9"),
    pytest.param(36, 48, 2, id="cpg18"),
    pytest.param(96, 72, 4, id="cog18"),
    pytest.param(80, 96, 2, id="cpg40"),
    pytest.param(96, 18, 2, id="cpg48-cog9"),
    pytest.param(96, 36, 2, id="cpg48-cog18"),
]


@pytest.mark.parametrize("case", ["clean", "noise"])
@pytest.mark.parametrize("c_in,c_out,groups", GROUP_WIDTHS)
def test_fused_conv_mav_matches_jax_at_group_widths(c_in, c_out, groups,
                                                    case):
    """Any group width the reference computes: the fused layer equals the
    JAX package's (which pads groups to its TPU tiles) and its oracle."""
    args = _layer_inputs(c_out + c_in, 2, 25, c_in, c_out, groups, 1, case)
    x, w, bias, flip, off, noise = args
    got = _port(x, w, bias, flip, groups, 1, 2, off, noise).numpy()
    np.testing.assert_array_equal(
        got, _jax_fused(x, w, bias, flip, groups, 1, 2, off, noise))
    np.testing.assert_array_equal(
        got, _jax_oracle(x, w, bias, flip, groups, 1, 2, off, noise))


@pytest.mark.parametrize("c_in,c_out,groups", GROUP_WIDTHS)
def test_fused_conv_mav_step_matches_jax_at_group_widths(c_in, c_out,
                                                         groups):
    """The streaming entry on an odd tail at the same widths, noise on."""
    x, w, bias, flip, off, noise = _layer_inputs(c_in + 3, 3, 9, c_in, c_out,
                                                 groups, 1, "noise")
    got = _port(x, w, bias, flip, groups, 1, 2, off, noise, step=True)
    np.testing.assert_array_equal(
        got.numpy(), _jax_fused(x, w, bias, flip, groups, 1, 2, off, noise,
                                step=True))


L, HOP = 640, 64
NETS = {
    "cpg6": dict(channels_per_group=6),
    "cpg48": dict(channels=(48, 96, 192, 288, 384, 576),
                  channels_per_group=48),
}


@pytest.fixture(scope="module", params=list(NETS))
def net(request):
    kw = NETS[request.param]
    cfg = kws.KWSConfig(sample_len=L, **kw)
    params = kws.init_params(jaxrand.PRNGKey(5, device="cpu"), cfg,
                             device="cpu")
    hw_t = kws.fold_params(params, kws.init_state(cfg, device="cpu"), cfg,
                           pack=True)
    rng = np.random.default_rng(17)
    chip = {name: (4.0 * rng.normal(size=cfg.channels[i])).astype(
        np.float32) for i, name in enumerate(cfg.imc_layer_names(), start=1)}
    return dict(name=request.param, cfg=cfg,
                jcfg=jkws.KWSConfig(sample_len=L, **kw), hw_t=hw_t,
                hw_j=jax_hw(hw_t), chip=chip)


def _duty(n, seed, duty=0.45, period=3 * HOP):
    r = np.random.default_rng(seed)
    x = r.uniform(-1.0, 1.0, n).astype(np.float32)
    t = 0
    while t < n:
        if r.random() > duty:
            x[t:t + period] *= 1e-4
        t += period
    return x


def test_fold_packs_every_layer_in_whole_k_steps(net):
    cfg, hw_t = net["cfg"], net["hw_t"]
    for i, name in enumerate(cfg.imc_layer_names(), start=1):
        g = cfg.groups(i)
        cpg = cfg.channels[i - 1] // g
        assert tuple(hw_t.packed[name].shape) == (
            g, 3, cfg.channels[i] // g, -(-cpg // 32) * 32)
    assert cfg.channels_per_group in (6, 48)


def test_server_matches_jax_at_group_width(net):
    """Three duty-cycled streams on two slots: events, counters and the
    state leaves equal the interpreted JAX server's."""
    cfg, jcfg, chip = net["cfg"], net["jcfg"], net["chip"]
    auds = [_duty(L + (9 + 3 * i) * HOP, 500 + i) for i in range(3)]
    ref = JStreamServer(net["hw_j"], jcfg, hop=HOP, slots=2,
                        use_kernel=True,
                        chip_offsets={k: jnp.asarray(v)
                                      for k, v in chip.items()},
                        vad=JVADConfig(), compiled=None)
    port = StreamServer(net["hw_t"], cfg, hop=HOP, slots=2, use_kernel=True,
                        chip_offsets=chip, vad=VADConfig(), device="cpu")
    evs = []
    for srv in (ref, port):
        for i, x in enumerate(auds):
            srv.submit(f"s{i}", x)
            srv.finish(f"s{i}")
        evs.append(srv.drain())
    ev_ref, ev_port = evs
    strip = lambda es: [{k: e[k] for k in ("stream", "hop", "keyword",
                                            "trigger")} for e in es]
    assert ev_port and strip(ev_port) == strip(ev_ref)
    np.testing.assert_allclose([e["score"] for e in ev_port],
                               [e["score"] for e in ev_ref], rtol=0,
                               atol=1e-6)
    st_ref, st_port = ref.stats(), port.stats()
    for k in ("steps", "decisions", "speech_hops", "gated_hops",
              "batched_calls"):
        assert st_port[k] == st_ref[k], k
    assert st_port["gated_hops"] > 0 and st_port["batched_calls"]["replay"]
    js, ts = ref._state, port._state
    for a, b in zip([ts.audio_carry, *ts.carries, ts.ring, ts.hop],
                    [js.audio_carry, *js.carries, js.ring, js.hop]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))

