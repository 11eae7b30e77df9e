"""The noisy chip on the port against the JAX package, on the CPU: chip
offsets, the SA-noise field, the fresh-draw and field forms of the
hardware forward, and the noisy stream against its offline windows
(the noisy server is in ``test_torch_noise_server.py``).

Tolerances: none.  Noise values, ±1 activations, features and logits are
compared bitwise (the port's ``jaxrand`` draws JAX's numbers exactly).
Small config: ``sample_len=640``, ``hop=64``.  The folded net is made by
the port from a ``jaxrand`` key and carried to the JAX package
as numpy leaves (``jax_hw``), which keeps the JAX side's compile time out
of the file's budget.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import imc as jimc
from repro.core import sa_noise as jsa
from repro.models import kws as jkws
from repro.serving import stream as jsv
from repro_torch.core import imc, jaxrand, sa_noise
from repro_torch.models import kws
from repro_torch.serving import stream as sv

L, HOP = 640, 64
JCFG = jkws.KWSConfig(sample_len=L)
CFG = kws.KWSConfig(sample_len=L)
STD = 1.0
CHANS = {f"conv{i}": JCFG.channels[i] for i in range(1, JCFG.num_conv_layers)}


def _eq(t, j, what=""):
    a, b = np.asarray(t.detach().cpu().numpy()), np.asarray(j)
    assert a.shape == b.shape, f"{what}: {a.shape} != {b.shape}"
    np.testing.assert_array_equal(a.view(np.uint32) if a.dtype == np.float32
                                  else a,
                                  b.view(np.uint32) if b.dtype == np.float32
                                  else b, err_msg=what)


def _tkey(jkey):
    return jaxrand.key_from_numpy(np.asarray(jkey), "cpu")


def jax_hw(hw_t):
    """The port's folded net as the JAX package's ``HWParams``."""
    hw = hw_t.hw
    leaves = {f: {k: jnp.asarray(v.numpy()) for k, v in getattr(hw, f).items()}
              for f in ("w_bin", "bias", "flip")}
    return jkws.HWParams(**leaves, fc_w=jnp.asarray(hw.fc_w.numpy()),
                         fc_b=jnp.asarray(hw.fc_b.numpy()))


@pytest.fixture(scope="module")
def nets():
    params = kws.init_params(jaxrand.PRNGKey(5, device="cpu"), CFG,
                             device="cpu")
    hw_t = kws.fold_params(params, kws.init_state(CFG, device="cpu"), CFG,
                           pack=True)
    hw_j = jax_hw(hw_t)
    chip_j = jimc.sample_chip_offsets(jax.random.PRNGKey(0), CHANS,
                                      jimc.IMCNoiseParams(mav_offset_std=4.0))
    chip_t = imc.sample_chip_offsets(jaxrand.PRNGKey(0, "cpu"), CHANS,
                                     imc.IMCNoiseParams(mav_offset_std=4.0))
    return hw_j, hw_t, chip_j, chip_t


def _audio(seed, b, n):
    rng = np.random.default_rng(seed)
    return (np.round(rng.uniform(-1, 1, (b, n)) * 127) / 127).astype(
        np.float32)


def test_chip_offsets_match_jax(nets):
    _, _, chip_j, chip_t = nets
    assert sorted(chip_t) == sorted(chip_j)
    for name in chip_j:
        _eq(chip_t[name], chip_j[name], name)


def test_noise_field_matches_jax():
    jkeys = jax.random.split(jax.random.PRNGKey(3), 3)
    hops = np.array([0, 5, 17], np.int32)
    want = jax.jit(lambda k, h: jsa.field_window_noise(jsa.SANoiseField(
        keys=k, hops=h, std=STD, hop=HOP), JCFG))(jkeys, jnp.asarray(hops))
    got = sa_noise.field_window_noise(sa_noise.SANoiseField(
        keys=_tkey(jkeys), hops=torch.tensor(hops), std=STD, hop=HOP), CFG)
    assert sorted(got) == sorted(want)
    for name in want:
        _eq(got[name], want[name], name)


@pytest.mark.parametrize("n_hops", [1, 3])
def test_hop_noise_fields_match_jax_and_per_layer_draws(n_hops):
    geom_j = jsv.make_stream_geometry(JCFG, HOP)
    geom = sv.make_stream_geometry(CFG, HOP)
    jkeys = jax.random.split(jax.random.PRNGKey(8), 2)
    hops = np.array([1, 6], np.int32)
    want = jax.jit(lambda k, h: jsv.hop_sa_noise_fields(
        k, h, JCFG, geom_j, STD, n_hops=n_hops))(jkeys, jnp.asarray(hops))
    keys = _tkey(jkeys)
    got = sv.hop_sa_noise_fields(keys, torch.tensor(hops), CFG, geom, STD,
                                 n_hops=n_hops)
    for name in want:
        _eq(got[name], want[name], name)
    if n_hops == 1:   # the hoist equals the per-layer draws
        for i in range(1, CFG.num_conv_layers):
            _eq(sv._hop_sa_noise(keys, torch.tensor(hops), i, CFG, geom,
                                 STD), np.asarray(got[f"conv{i}"]),
                f"conv{i}")


def test_hw_forward_rng_form_matches_jax(nets):
    """Fresh per-layer draws down the ``rng`` split chain: features and
    logits of the port's fused and unfused paths, and every layer's ±1
    activations (``hw_conv_layer(sa_key=...)``), against the reference's
    unfused path (which its own tests hold equal to its fused one)."""
    hw_j, hw_t, chip_j, chip_t = nets
    x = _audio(1, 3, L)
    lj, fj = jax.jit(lambda a: jkws.hw_forward(
        hw_j, a, JCFG, chip_offsets=chip_j, sa_noise_std=STD,
        rng=jax.random.PRNGKey(21)))(jnp.asarray(x))
    for use_kernel in (False, True):
        lt, ft = kws.hw_forward(hw_t, x, CFG, chip_offsets=chip_t,
                                sa_noise_std=STD,
                                rng=jaxrand.PRNGKey(21, "cpu"),
                                use_kernel=use_kernel, device="cpu")
        _eq(lt, lj, f"logits (use_kernel={use_kernel})")
        _eq(ft, fj, f"features (use_kernel={use_kernel})")
    @jax.jit
    def layers_j(h):
        out, rj = [], jax.random.PRNGKey(4)
        for i in range(JCFG.num_conv_layers):
            kj = None
            if i > 0:
                rj, kj = jax.random.split(rj)
            h = jkws.hw_conv_layer(hw_j, i, h, JCFG,
                                   chip_offset=chip_j.get(f"conv{i}"),
                                   sa_key=kj, sa_noise_std=STD if i else 0.0)
            out.append(h)
        return out

    ht, rt = torch.tensor(x)[..., None], jaxrand.PRNGKey(4, "cpu")
    for i, hj in enumerate(layers_j(jnp.asarray(x)[..., None])):
        kt = None
        if i > 0:
            rt, kt = jaxrand.split(rt)
        ht = kws.hw_conv_layer(hw_t.hw, i, ht, CFG,
                               chip_offset=chip_t.get(f"conv{i}"),
                               sa_key=kt, sa_noise_std=STD if i else 0.0,
                               use_kernel=i > 0)
        _eq(ht, hj, f"conv{i} activations")


def test_hw_forward_field_form_matches_jax(nets):
    hw_j, hw_t, chip_j, chip_t = nets
    x = _audio(2, 3, L)
    jkeys = jax.random.split(jax.random.PRNGKey(13), 3)
    hops = np.array([0, 2, 9], np.int32)
    lj, fj = jax.jit(lambda a, k, h: jkws.hw_forward(
        hw_j, a, JCFG, chip_offsets=chip_j,
        sa_noise_field=jsa.SANoiseField(k, h, STD, HOP)))(
            jnp.asarray(x), jkeys, jnp.asarray(hops))
    lt, ft = kws.hw_forward(
        hw_t, x, CFG, chip_offsets=chip_t, use_kernel=True, device="cpu",
        sa_noise_field=sa_noise.SANoiseField(_tkey(jkeys),
                                             torch.tensor(hops), STD, HOP))
    _eq(lt, lj, "logits")
    _eq(ft, fj, "features")
    with pytest.raises(ValueError, match="only one of"):
        kws.hw_forward(hw_t, x, CFG, sa_noise_std=STD, device="cpu",
                       sa_noise_field=sa_noise.SANoiseField(
                           _tkey(jkeys), torch.tensor(hops), STD, HOP))


def test_noisy_stream_equals_offline_windows(nets):
    """Hop by hop (and a 3-hop multi-step), the noisy stream's logits
    equal ``hw_forward(sa_noise_field=...)`` on each full window; the
    state's keys ride along unchanged."""
    _, hw_t, _, chip_t = nets
    b, n_hops = 2, 6
    audio = torch.tensor(_audio(3, b, L + n_hops * HOP))
    keys = jaxrand.split(jaxrand.PRNGKey(30, "cpu"), b)
    eng = sv.StreamEngine(hw_t, CFG, HOP, chip_offsets=chip_t,
                          sa_noise_std=STD, device="cpu")
    logits, state = eng.init(audio[:, :L], keys)
    per_hop = [logits]
    for h in range(3):
        lg, state = eng.step(state, audio[:, L + h * HOP:L + (h + 1) * HOP])
        per_hop.append(lg)
    lg3, state = eng.multi_step(state, audio[:, L + 3 * HOP:], 3)
    per_hop.extend(lg3.unbind(1))
    assert torch.equal(state.key, keys)
    for t, lg in enumerate(per_hop):
        field = sa_noise.SANoiseField(keys, torch.full((b,), t), STD, HOP)
        want, _ = kws.hw_forward(hw_t, audio[:, t * HOP:t * HOP + L], CFG,
                                 chip_offsets=chip_t, sa_noise_field=field,
                                 use_kernel=True, device="cpu")
        assert torch.equal(lg, want), f"window {t}"
    window = sv.window_sa_noise(keys[1], CFG, eng.geom, 4, STD)
    field = sa_noise.field_window_noise(sa_noise.SANoiseField(
        keys[1:], torch.tensor([4]), STD, HOP), CFG)
    for name in window:
        assert torch.equal(window[name], field[name])
