"""The port's fused IMC layer (repro_torch.kernels.imc_mav) against the JAX
package's, bit for bit.

Inputs are made with numpy from fixed seeds and handed to both packages.
On the CPU the port's wrapper runs its plain PyTorch version; the JAX side
runs the Pallas ``imc_fused`` kernel in interpret mode and its
count-exact oracle.  Cases: the five paper IMC layer shapes, no offset /
chip offset / chip offset plus an explicit pre-sign noise operand, the
streaming ``_step`` entry, and a stride-2 layer whose conv length leaves
a pool remainder (group widths off the paper's are in
tests/test_torch_group_widths.py).  The kernel's input contract is pinned here too: the plain
version on activations in {-1, 0, +1} (and with whole streams of zeros,
as free slots carry them) equals the JAX oracle, and a served run sends
the fused layer nothing else.  The fold-time int8 weights and the
wrapper's checks are tested as far as a CPU reaches.
tests/test_torch_cuda.py holds the Hopper kernel itself against the plain
version on a card.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import imc as jimc
from repro.core.binary import channel_shuffle as jshuffle
from repro.core.binary import or_maxpool as jpool
from repro.kernels.imc_mav import ops as jops
from repro.kernels.imc_mav.ref import fused_conv_mav_ref as jref
from repro_torch.core import jaxrand
from repro_torch.kernels.imc_mav import ops, ref
from repro_torch.models import kws
from repro_torch.serving.scheduler import StreamServer
from repro_torch.serving.vad import VADConfig

# (c_in, c_out, groups, stride, pool) of the paper's IMC layers conv1..conv5
PAPER_IMC_LAYERS = [
    pytest.param(24, 96, 1, 1, 2, id="L2-24to96-g1-pool2"),
    pytest.param(96, 192, 4, 1, 2, id="L3-96to192-g4-pool2"),
    pytest.param(192, 288, 8, 1, 1, id="L4-192to288-g8-nopool"),
    pytest.param(288, 384, 12, 1, 2, id="L5-288to384-g12-pool2"),
    pytest.param(384, 576, 16, 1, 2, id="L6-384to576-g16-pool2"),
]
CASES = ("clean", "chip", "noise")


def _pm1(rng, shape):
    return np.where(rng.random(shape) < 0.5, 1.0, -1.0).astype(np.float32)


def _layer_inputs(seed, b, t, c_in, c_out, groups, stride, case,
                  kind="pm1"):
    """x, w, bias, flip, chip offset, noise as numpy (offset/noise None
    where the case has none).  x is ±1 (``pm1``), in {-1, 0, +1}
    (``ternary``) or ±1 with stream 0 all zero (``zero_stream``)."""
    rng = np.random.default_rng(seed)
    x = _pm1(rng, (b, t, c_in))
    if kind == "ternary":
        x = rng.integers(-1, 2, (b, t, c_in)).astype(np.float32)
    elif kind == "zero_stream":
        x[0] = 0.0
    w = _pm1(rng, (3, c_in // groups, c_out))
    bias = (np.round(rng.normal(size=c_out) * 8) * 2).astype(np.float32)
    flip = _pm1(rng, (c_out,))
    off = noise = None
    if case in ("chip", "noise"):
        off = (4.0 * rng.normal(size=c_out)).astype(np.float32)
    if case == "noise":
        t_out = (t - 3) // stride + 1
        noise = (1.5 * rng.normal(size=(b, t_out, c_out))).astype(np.float32)
    return x, w, bias, flip, off, noise


def _jax_oracle(x, w, bias, flip, groups, stride, pool, off, noise):
    """The reference's count-exact chain: conv counts -> (+offset) ->
    mav_sa (bias, explicit noise, flip, sign) -> shuffle -> OR-pool."""
    if noise is None:
        return np.asarray(jref(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(bias), jnp.asarray(flip),
                               groups=groups, stride=stride, pool=pool,
                               chip_offset=None if off is None
                               else jnp.asarray(off)))
    counts = jimc.binary_group_conv_counts(jnp.asarray(x), jnp.asarray(w),
                                           groups=groups, stride=stride)
    counts = counts + jnp.asarray(off)
    h = jimc.mav_sa(counts, jnp.asarray(bias), jnp.asarray(flip),
                    sa_noise=jnp.asarray(noise))
    h = jshuffle(h, groups)
    return np.asarray(jpool(h, pool, axis=1) if pool > 1 else h)


def _jax_fused(x, w, bias, flip, groups, stride, pool, off, noise,
               step=False):
    fn = jops.fused_conv_mav_step if step else jops.fused_conv_mav
    return np.asarray(fn(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(bias), jnp.asarray(flip),
        groups=groups, stride=stride, pool=pool,
        chip_offset=None if off is None else jnp.asarray(off),
        sa_noise=None if noise is None else jnp.asarray(noise)))


def _port(x, w, bias, flip, groups, stride, pool, off, noise, step=False,
          device="cpu"):
    t = lambda a: None if a is None else torch.as_tensor(a, device=device)
    fn = ops.fused_conv_mav_step if step else ops.fused_conv_mav
    return fn(t(x), t(w), t(bias), t(flip), groups=groups, stride=stride,
              pool=pool, chip_offset=t(off), sa_noise=t(noise))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("c_in,c_out,groups,stride,pool", PAPER_IMC_LAYERS)
def test_fused_conv_mav_matches_jax_paper_layers(c_in, c_out, groups, stride,
                                                 pool, case):
    args = _layer_inputs(c_out + groups, 2, 25, c_in, c_out, groups, stride,
                         case)
    x, w, bias, flip, off, noise = args
    got = _port(x, w, bias, flip, groups, stride, pool, off, noise).numpy()
    np.testing.assert_array_equal(
        got, _jax_fused(x, w, bias, flip, groups, stride, pool, off, noise))
    np.testing.assert_array_equal(
        got, _jax_oracle(x, w, bias, flip, groups, stride, pool, off, noise))
    assert got.shape == (2, 23 // pool, c_out)


@pytest.mark.parametrize("case", CASES)
def test_fused_conv_mav_step_matches_jax(case):
    """The streaming entry on a tail slice (conv5's shape, odd tail)."""
    x, w, bias, flip, off, noise = _layer_inputs(11, 3, 9, 384, 576, 16, 1,
                                                 case)
    got = _port(x, w, bias, flip, 16, 1, 2, off, noise, step=True).numpy()
    np.testing.assert_array_equal(
        got, _jax_fused(x, w, bias, flip, 16, 1, 2, off, noise, step=True))


@pytest.mark.parametrize("case", CASES)
def test_fused_conv_mav_stride_and_odd_t(case):
    """Stride 2 and a conv length that leaves a pool remainder."""
    x, w, bias, flip, off, noise = _layer_inputs(7, 3, 29, 48, 96, 2, 2,
                                                 case)
    got = _port(x, w, bias, flip, 2, 2, 2, off, noise).numpy()
    np.testing.assert_array_equal(
        got, _jax_fused(x, w, bias, flip, 2, 2, 2, off, noise))
    np.testing.assert_array_equal(
        got, _jax_oracle(x, w, bias, flip, 2, 2, 2, off, noise))


def test_pack_weights_group_major():
    """Packed weights hold group g's (K*cpg, cog) block contiguously."""
    w = torch.arange(3 * 24 * 96, dtype=torch.float32).reshape(3, 24, 96)
    wp = ops.pack_weights(w, 4)
    assert wp.shape == (4, 72, 24) and wp.is_contiguous()
    for g in range(4):
        assert torch.equal(wp[g], w.reshape(72, 96)[:, g * 24:(g + 1) * 24])


def test_wrapper_rejects_devices_without_a_kernel():
    """Only CPU tensors take the plain version; any other device must
    launch a kernel or raise (here: the meta device, which has none)."""
    x, w, bias, flip, _, _ = _layer_inputs(3, 1, 9, 24, 96, 1, 1, "clean")
    with pytest.raises(ValueError, match="no kernel"):
        _port(x, w, bias, flip, 1, 1, 2, None, None, device="meta")


def test_too_short_input_raises():
    x, w, bias, flip, _, _ = _layer_inputs(3, 1, 3, 24, 96, 1, 1, "clean")
    with pytest.raises(ValueError, match="no complete pool window"):
        _port(x, w, bias, flip, 1, 1, 2, None, None)
    with pytest.raises(ValueError, match="not enough for one pool"):
        _port(x, w, bias, flip, 1, 1, 2, None, None, step=True)


def test_hw_forward_one_fused_call_per_imc_layer(monkeypatch):
    """``hw_forward(use_kernel=True)`` reaches the fused layer exactly once
    per IMC layer; on the CPU that is the plain version and the kernel's
    launch count stays 0."""
    cfg = kws.KWSConfig(sample_len=640)
    params = kws.init_params(jaxrand.PRNGKey(5, device="cpu"), cfg,
                             device="cpu")
    hw = kws.fold_params(params, kws.init_state(cfg, device="cpu"), cfg,
                         pack=True)
    calls = []

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return ref.fused_conv_mav_ref(*args, **kwargs)

    monkeypatch.setattr(ops, "fused_conv_mav_ref", counting)
    ops.COUNTS.reset()
    x = np.random.default_rng(1).uniform(-1, 1, (2, cfg.sample_len))
    kws.hw_forward(hw, x, cfg, use_kernel=True, device="cpu")
    assert len(calls) == cfg.num_conv_layers - 1 == 5
    assert all(shape[0] == 2 for shape in calls)    # whole batch per call
    assert ops.COUNTS.launches == 0


@pytest.mark.parametrize("kind", ["ternary", "zero_stream"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("c_in,c_out,groups,stride,pool", PAPER_IMC_LAYERS + [
    pytest.param(48, 96, 2, 2, 2, id="stride2-odd")])
def test_plain_version_on_ternary_matches_jax(c_in, c_out, groups, stride,
                                              pool, case, kind):
    """The kernel's input contract is x in {-1, 0, +1}: on such inputs the
    port's plain version (the kernel's oracle on the card) equals the JAX
    count-exact oracle, a zero counting as a zero product."""
    args = _layer_inputs(c_out + groups + 1, 3, 27, c_in, c_out, groups,
                         stride, case, kind)
    x, w, bias, flip, off, noise = args
    assert (x == 0).any()
    got = _port(x, w, bias, flip, groups, stride, pool, off, noise).numpy()
    np.testing.assert_array_equal(
        got, _jax_oracle(x, w, bias, flip, groups, stride, pool, off, noise))


def test_served_activations_are_ternary_and_hold_zeros(monkeypatch):
    """A StreamServer with free slots sends the fused layer only values in
    {-1, 0, +1}, and zeros do occur: the zeroed carries of slots never
    admitted ride every batched hop (the contract the kernel is exact on).
    """
    cfg = kws.KWSConfig(sample_len=640)
    params = kws.init_params(jaxrand.PRNGKey(3, device="cpu"), cfg,
                             device="cpu")
    hw = kws.fold_params(params, kws.init_state(cfg, device="cpu"), cfg,
                         pack=True)
    seen = []
    plain = ops.fused_conv_mav

    def recording(x, *args, **kwargs):
        seen.append(torch.unique(x))
        return plain(x, *args, **kwargs)

    monkeypatch.setattr(ops, "fused_conv_mav", recording)
    srv = StreamServer(hw, cfg, hop=64, slots=4, vad=VADConfig(),
                       device="cpu")
    rng = np.random.default_rng(4)
    for s in range(2):
        srv.submit(f"s{s}", rng.uniform(-1, 1, 640 + 6 * 64)
                   .astype(np.float32))
        srv.finish(f"s{s}")
    srv.drain()
    values = torch.unique(torch.cat(seen))
    assert len(seen) >= 5
    assert set(values.tolist()) <= {-1.0, 0.0, 1.0}
    assert sum(bool((v == 0).any()) for v in seen) > 0


def test_pack_weights_s8_rows():
    """The fold-time int8 B rows: row (g, j, n) holds w[j, :, g*cog + n]
    in its first cpg bytes and zeros after, in whole 32-byte k-steps: one
    for cpg 24, two for cpg 40 (s = 2), one for cpg 6."""
    rng = np.random.default_rng(8)
    for (cpg, c_out, groups), slot in (((24, 96, 4), 32), ((40, 36, 2), 64),
                                       ((6, 36, 4), 32)):
        w = torch.tensor(_pm1(rng, (3, cpg, c_out)))
        q = ops.pack_weights_s8(w, groups)
        cog = c_out // groups
        assert q.shape == (groups, 3, cog, slot) and q.dtype == torch.int8
        assert q.is_contiguous() and ops.slot_bytes(cpg) == slot
        for g in range(groups):
            assert torch.equal(q[g, :, :, :cpg].float(),
                               w[:, :, g * cog:(g + 1) * cog].permute(0, 2, 1))
        assert not q[..., cpg:].any()
    with pytest.raises(ValueError, match="do not split"):
        ops.pack_weights_s8(torch.ones(3, 40, 81), 2)


def test_hw_params_pack_int8_rows():
    cfg = kws.KWSConfig(sample_len=640)
    params = kws.init_params(jaxrand.PRNGKey(5, device="cpu"), cfg,
                             device="cpu")
    hw = kws.fold_params(params, kws.init_state(cfg, device="cpu"), cfg,
                         pack=True)
    for i, name in enumerate(cfg.imc_layer_names(), start=1):
        assert torch.equal(hw.packed[name], ops.pack_weights_s8(
            hw.hw.w_bin[name], cfg.groups(i)))


@pytest.mark.parametrize("form", ["fp32-group-major", "fp32-rows",
                                  "int8-other-groups"])
def test_kernel_wrapper_takes_only_int8_rows(form):
    """The kernel's weights are the fold-time int8 B rows and nothing
    else: the group-major fp32 form, float rows and rows packed for
    another group count are refused before any launch."""
    x, w, bias, flip, _, _ = _layer_inputs(3, 1, 12, 96, 192, 4, 1, "clean")
    x, w, bias, flip = (torch.as_tensor(a) for a in (x, w, bias, flip))
    wrong = {"fp32-group-major": ops.pack_weights(w, 4),
             "fp32-rows": ops.pack_weights_s8(w, 4).float(),
             "int8-other-groups": ops.pack_weights_s8(w, 2)}[form]
    with pytest.raises(ValueError, match="does not match"):
        ops.imc_fused(x, wrong, bias, flip, None, None, k=3, groups=4,
                      stride=1, pool=1)
