"""The port's gated-linear-attention core (``models.layers``), Mamba2
(``models.mamba2``) and the zamba2 hybrid (the ``mamba`` and
``zamba_group`` segments of ``models.lm``) against the JAX package's, on
the CPU, on inputs made from a seed with numpy.

The port computes what XLA's CPU code computes where that is cheap to
follow: ``jnp.cumsum`` in XLA's order (``layers.cumsum``: blocks of 16
summed in order, then the blocks' totals; torch's CPU ``cumsum``
accumulates in float64 and parts from it in two elements of three),
``jnp.linspace`` with XLA's FMA and ``jnp.log`` as ``jaxrand.logf`` (so
``A_log``, a parameter, is bitwise), the causal convolution's taps rounded
to bfloat16 at every step, and the gate's product kept in float32 where
the norm reads it (excess precision, read from the compiled HLO).  Where
it does not follow, a tolerance states the cause:

* ``STATE_SHARE``: float32 states (the GLA's final state, ``gla_step``'s)
  within this share of their largest magnitude.  torch's ``exp`` differs
  from XLA's in the last bit in about one value of eleven, ``log1p`` in
  one of four, so the decays and ``softplus`` do; and the chunk's products
  sum in another order than XLA's.  Measured at most 1.1e-7.
* bfloat16 outputs (the GLA's, ``mamba2_apply``'s, ``mamba2_step``'s):
  ``tests/test_torch_lm.py``'s layer rule, each element within one
  bfloat16 ulp of the tensor's largest magnitude and at most 1% of them
  off the reference's bits (measured: a quarter ulp, 8e-4 of the
  elements).
* ``LOOP_SHARE``: the port's T-step ``gla_step`` loop against its own
  chunked form, float32 both: the same sums in other orders (measured
  6.4e-7).
* Whole models: ``tests/_recurrent_lm.py`` (measured: the logits bit for
  bit, the decode caches within 1.3e-4 ulps).
* The train step, ``LOSS_RTOL`` 5e-4 and ``GRAD_SHARE`` 6e-2, not 2e-4
  and 3e-2 (``launch/crosscheck.py::TRAIN_FAMILY``, the card's too).
  Measured against the reference: the loss 2e-7 of itself, the gradients
  3.91e-2 of a leaf's largest (``A_log`` of the zamba group; every other
  leaf within 2.4e-2); the card against the CPU 1.51e-4 and 3.11e-2.
  The recurrence carries a bfloat16 flip to every later position: the
  reference's own loss moves by up to 1.97e-4 of itself when one element
  of one embedding row moves by one bfloat16 ulp (6 trials), and its own
  jitted and op-by-op gradients differ by 0.151 of a leaf's largest.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _recurrent_lm as rl
from repro.models import layers as JL
from repro.models import mamba2 as JM2
from repro_torch.core import jaxrand
from repro_torch.launch import crosscheck, serve
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.models import mamba2 as M2
from test_torch_lm import _f32, assert_layer_close

ARCH = "zamba2-1.2b"
STATE_SHARE = 1e-6
LOOP_SHARE = 4e-6
# 5e-4 and 6e-2, shared with the card-against-CPU step
LOSS_RTOL, GRAD_SHARE = crosscheck.TRAIN_FAMILY["hybrid"]


def _within_share(got, want, share):
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape
    gap, top = np.abs(g - w).max(), np.abs(w).max()
    assert gap <= share * top, (gap, top)


def _gla_inputs(seed, t, h=4, d=16, real=None):
    """q, k, v (B, T, H, D) normals, log_a in (-0.4, 0], b in [0, 2); the
    positions from ``real`` on zero (the callers' padding)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((2, t, h, d)).astype(np.float32)
               for _ in range(3))
    log_a = (-0.2 * np.abs(rng.standard_normal((2, t, h)))).astype(
        np.float32)
    b = np.abs(rng.standard_normal((2, t, h))).astype(np.float32)
    if real is not None:
        for a in (q, k, v, log_a, b):
            a[:, real:] = 0
    s0 = rng.standard_normal((2, h, d, d)).astype(np.float32)
    return (q, k, v, log_a, b), s0


def _both(arrays):
    """The GLA's inputs in both packages: q, k, v bfloat16, gates float32."""
    jx = [jnp.asarray(a, jnp.bfloat16) for a in arrays[:3]] + \
        [jnp.asarray(a) for a in arrays[3:]]
    tx = [torch.tensor(a).bfloat16() for a in arrays[:3]] + \
        [torch.tensor(a) for a in arrays[3:]]
    return jx, tx


_JGLA = jax.jit(JL.gated_linear_attention, static_argnums=(5, 7))


# ---------------------------------------------------------------------------
# the GLA core
# ---------------------------------------------------------------------------


def test_cumsum_in_xla_order():
    rng = np.random.default_rng(0)
    for shape, axis in (((3, 2, 128, 4), 2), ((5, 40), 1), ((2, 300), 1)):
        x = (-0.3 * rng.standard_normal(shape)).astype(np.float32)
        want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=axis))(x))
        np.testing.assert_array_equal(
            L.cumsum(torch.tensor(x), axis).numpy(), want)


@pytest.mark.parametrize("t,real,state", [
    (128, None, False), (128, None, True), (256, 200, True)],
    ids=["one-chunk", "initial-state", "padded-two-chunks"])
def test_gated_linear_attention_against_the_reference(t, real, state):
    """One chunk, one chunk from a given state, and a 200-step input
    zero-padded to two chunks (the inter-chunk state carried), with the
    final state returned."""
    arrays, s0 = _gla_inputs(t, t, real=real)
    jx, tx = _both(arrays)
    init = s0 if state else None
    jy, js = _JGLA(*jx, 128, None if init is None else jnp.asarray(init),
                   True)
    ty, ts = L.gated_linear_attention(
        *tx, chunk=128, return_state=True,
        initial_state=None if init is None else torch.tensor(init))
    assert ty.dtype == torch.bfloat16 and ts.dtype == torch.float32
    assert_layer_close(ty, jy)
    _within_share(ts, js, STATE_SHARE)
    # without return_state: y alone, the same
    assert torch.equal(L.gated_linear_attention(
        *tx, chunk=128, initial_state=None if init is None
        else torch.tensor(init)), ty)


def test_gla_step_against_the_reference_and_the_chunked_form():
    """``gla_step`` against the reference's, step by step from a random
    state; and 128 steps of it from zero against the chunked form."""
    arrays, s0 = _gla_inputs(7, 128)
    jx, tx = _both(arrays)
    jstep = jax.jit(JL.gla_step)
    js, ts = jnp.asarray(s0), torch.tensor(s0)
    for i in range(3):
        jy, js = jstep(*(a[:, i] for a in jx), js)
        ty, ts = L.gla_step(*(a[:, i] for a in tx), ts)
        assert_layer_close(ty, jy)
        _within_share(ts, js, STATE_SHARE)
    q, k, v, log_a, b = (torch.tensor(a) for a in arrays)
    state = torch.zeros((2, 4, 16, 16))
    ys = []
    for i in range(128):
        y, state = L.gla_step(q[:, i], k[:, i], v[:, i], log_a[:, i],
                              b[:, i], state)
        ys.append(y)
    y_chunk, s_chunk = L.gated_linear_attention(q, k, v, log_a, b,
                                                return_state=True)
    _within_share(torch.stack(ys, 1), y_chunk, LOOP_SHARE)
    _within_share(state, s_chunk, LOOP_SHARE)


def test_clamp_before_exp_keeps_gradients_finite():
    """A decay of -30 a step makes the future positions' ``rel`` reach
    30 * 127, whose ``exp`` overflows: masked to -1e30 before the ``exp``,
    the backward stays finite, where masking after it gives inf * 0 =
    NaN."""
    arrays, _ = _gla_inputs(3, 128)
    q, k, v, _, b = (torch.tensor(a, requires_grad=True) for a in arrays)
    log_a = torch.full((2, 128, 4), -30.0, requires_grad=True)
    L.gated_linear_attention(q, k, v, log_a, b).sum().backward()
    for t in (q, k, v, log_a, b):
        assert t.grad is not None and bool(torch.isfinite(t.grad).all())
    cum = L.cumsum(log_a.detach()[0, :, 0], 0)
    rel = (cum[:, None] - cum[None, :]).requires_grad_()
    past = torch.ones((128, 128), dtype=torch.bool).tril()
    torch.where(past, torch.exp(rel), 0.0).sum().backward()
    assert bool(torch.isnan(rel.grad).any())


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------


def _layer(seed=3):
    cfg = serve.get_config(ARCH).reduced()
    jcfg = JM2.Mamba2Config(**{f: getattr(cfg.mamba, f) for f in (
        "d_model", "d_state", "d_conv", "expand", "head_dim")})
    jp = jax.tree_util.tree_map(np.asarray, JM2.mamba2_init(
        jax.random.PRNGKey(seed), jcfg))
    # a nonzero step bias and conv bias, so that they count
    rng = np.random.default_rng(seed)
    jp["dt_bias"] = (0.5 * rng.standard_normal(jp["dt_bias"].shape)).astype(
        np.float32)
    jp["conv_b"] = (0.1 * rng.standard_normal(jp["conv_b"].shape)).astype(
        np.float32)
    tp = LM.params_from_numpy(jp, cfg, device="cpu")
    return cfg.mamba, jcfg, jp, tp


def test_a_log_is_the_reference_at_every_width():
    for h in (8, 64, 100):
        want = np.asarray(jnp.log(jnp.linspace(1.0, 16.0, h)))
        np.testing.assert_array_equal(M2.a_log(h).numpy(), want)


def test_mamba2_init_is_the_reference_draw():
    cfg = serve.get_config(ARCH).reduced().mamba
    jcfg = JM2.Mamba2Config(**{f: getattr(cfg, f) for f in (
        "d_model", "d_state", "d_conv", "expand", "head_dim")})
    want = JM2.mamba2_init(jax.random.PRNGKey(5), jcfg)
    got = M2.mamba2_init(jaxrand.PRNGKey(5, device="cpu"), cfg, "cpu",
                         torch.float32)
    assert sorted(got) == sorted(want)
    for k in want:
        for g, w in zip(LM.leaves(got[k]), jax.tree_util.tree_leaves(
                want[k])):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), k)


def test_mamba2_apply_against_the_reference():
    """40 steps (one padded chunk) and 136 (two)."""
    cfg, jcfg, jp, tp = _layer()
    run = jax.jit(lambda p, x: JM2.mamba2_apply(p, jcfg, x))
    for t in (40, 136):
        x = np.random.default_rng(t).standard_normal(
            (2, t, cfg.d_model)).astype(np.float32)
        out = M2.mamba2_apply(tp, cfg, torch.tensor(x).bfloat16())
        assert out.dtype == torch.bfloat16
        assert_layer_close(out, run(jp, jnp.asarray(x, jnp.bfloat16)))


def test_mamba2_step_against_the_reference():
    """Five steps from the zero cache: the output, the conv window and
    the float32 SSM state."""
    cfg, jcfg, jp, tp = _layer(4)
    jstep = jax.jit(lambda p, x, c: JM2.mamba2_step(p, jcfg, x, c))
    jc = JM2.mamba2_init_cache(jcfg, 2, jnp.bfloat16)
    tc = M2.mamba2_init_cache(cfg, 2, torch.bfloat16)
    x = np.random.default_rng(9).standard_normal((2, 5, cfg.d_model)
                                                 ).astype(np.float32)
    for i in range(5):
        xi = x[:, i:i + 1]
        jo, jc = jstep(jp, jnp.asarray(xi, jnp.bfloat16), jc)
        to, tc = M2.mamba2_step(tp, cfg, torch.tensor(xi).bfloat16(), tc)
        assert_layer_close(to, jo)
        np.testing.assert_array_equal(_f32(tc["conv"]), _f32(jc["conv"]))
        _within_share(tc["ssm"], jc["ssm"], STATE_SHARE)


# ---------------------------------------------------------------------------
# the zamba2 hybrid, whole
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    return rl.reference(ARCH)


def test_init_lm_is_the_reference_draw():
    rl.check_draw(ARCH)
    cfg = serve.get_config(ARCH).reduced()
    p = LM.init_lm(jaxrand.PRNGKey(0, device="cpu"), cfg, device="cpu")
    group, rest = p["segments"]
    # one shared attention block for the group, its Mamba2 layers stacked
    assert group["shared_attn"]["attn"]["wq"]["w"].dim() == 2
    assert group["mamba"]["mamba"]["in_proj"]["w"].shape[0] == 4
    assert rest["mamba"]["A_log"].dtype == torch.float32


def test_init_cache_equals_the_reference(model):
    rl.check_init_cache(model)


def test_forward_against_the_reference(model):
    rl.check_forward(model)


def test_decode_steps_against_the_reference(model):
    rl.check_decode(model)


def test_prefill_against_the_reference(model):
    rl.check_prefill(model)


def test_teacher_forced_decode_equals_the_full_forward(model):
    rl.check_decode_against_forward(model)


def test_server_tokens_equal_the_reference():
    rl.check_server(ARCH)


def test_train_step_against_the_reference():
    rl.check_train_step(ARCH, loss_rtol=LOSS_RTOL, grad_share=GRAD_SHARE)


def test_full_width_is_the_published_config(monkeypatch):
    """``Server("zamba2-1.2b", reduced=False)``'s parameters, built on the
    meta device (nothing allocated): the reference's shapes, 1.170 B
    parameters; without a card the server raises unless given the CPU."""
    cfg = serve.get_config(ARCH)
    p = LM.init_lm(jaxrand.PRNGKey(0, device="cpu"), cfg, device="meta")
    want = jax.eval_shape(lambda: rl.JLM.init_lm(jax.random.PRNGKey(0),
                                                 rl.jget(ARCH)))
    assert [tuple(a.shape) for a in LM.leaves(p)] == [
        tuple(a.shape) for a in jax.tree_util.tree_leaves(want)]
    assert sum(a.numel() for a in LM.leaves(p)) == 1_170_473_856
    assert LM.seg_plan(cfg) == [("zamba_group", 35), ("mamba", 3)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.Server(ARCH)
