"""The port's xLSTM blocks (``models.xlstm``: mLSTM on the GLA core, sLSTM
as a time loop) and the ``mlstm`` / ``slstm`` segments of ``models.lm``
against the JAX package's, on the CPU, on inputs made from a seed with
numpy, the reduced xlstm-125m (d 128, 4 heads, plan [mlstm 3, slstm 1]).

The port rounds where XLA's CPU code rounds (the causal convolution's
taps at every step, ``kk * hd ** -0.5`` by the bfloat16-rounded scale,
the sLSTM hidden state rounded to bfloat16 before its norm).  Where it
does not follow, a tolerance states the cause:

* bfloat16 outputs (``mlstm_apply``, ``mlstm_step``, ``slstm_apply``,
  ``slstm_step``): ``tests/test_torch_lm.py``'s layer rule, one bfloat16
  ulp of the tensor's largest magnitude, at most 1% of the elements off
  the reference's bits.  The gates go through ``exp`` and ``softplus``,
  whose float32 results differ from XLA's in the last bit now and then
  (``tests/test_torch_mamba2.py``), and sLSTM's ``tanh`` differs from
  XLA's in the last bit or two in more than half the values.  Measured:
  half an ulp on 0.59% of ``mlstm_apply``'s elements at 136 steps, the
  rest bit for bit.
* ``CELL_SHARE``: the float32 states (sLSTM's h, c, n, m; mLSTM's
  matrix memory) within this share of each one's largest magnitude:
  those ``tanh``, ``exp`` and ``softplus`` ulps and the contractions' sum
  order (measured at most 2.4e-7).
* Whole models: ``tests/_recurrent_lm.py`` (measured: the logits within
  one ulp of the largest, the decode caches within one).
* The train step, ``LOSS_RTOL`` 5e-4 and ``GRAD_SHARE`` 6e-2, not 2e-4
  and 3e-2 (``launch/crosscheck.py::TRAIN_FAMILY``, the card's too).
  Measured against the reference: the loss 2.74e-4 of itself, the
  gradients 3.04e-2 of a leaf's largest (sLSTM's ``ffn_up``); the card
  against the CPU 5.6e-5 and 4.04e-2.  At B = 2, S = 32 the first mLSTM
  layer's products flip a bfloat16 rounding in three elements (torch
  sums them in another order than XLA), and the mLSTM recurrence carries
  each flip to every later position; the reference's own loss moves by
  up to 1.2e-4 of itself when one element of one embedding row moves by
  one bfloat16 ulp (6 trials), and its jitted and op-by-op gradients
  differ by 2.05e-2 of a leaf's largest.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _recurrent_lm as rl
from repro.models import xlstm as JX
from repro_torch.core import jaxrand
from repro_torch.launch import crosscheck, serve
from repro_torch.models import lm as LM
from repro_torch.models import xlstm as X
from test_torch_lm import _f32, assert_layer_close

ARCH = "xlstm-125m"
CELL_SHARE = 1e-6
# 5e-4 and 6e-2, shared with the card-against-CPU step
LOSS_RTOL, GRAD_SHARE = crosscheck.TRAIN_FAMILY["xlstm"]


def _cfgs():
    cfg = serve.get_config(ARCH).reduced().xlstm
    return cfg, JX.XLSTMConfig(d_model=cfg.d_model, n_heads=cfg.n_heads,
                               expand=cfg.expand, d_conv=cfg.d_conv,
                               ffn_factor=cfg.ffn_factor)


def _block(kind, seed=3):
    """One block drawn by the reference (float32 numpy leaves), its conv
    bias redrawn nonzero, and the same carried into the port as served."""
    cfg, jcfg = _cfgs()
    init = JX.mlstm_init if kind == "mlstm" else JX.slstm_init
    jp = jax.tree_util.tree_map(np.array, init(jax.random.PRNGKey(seed),
                                               jcfg))
    if kind == "mlstm":
        jp["conv_b"] = (0.1 * np.random.default_rng(seed).standard_normal(
            jp["conv_b"].shape)).astype(np.float32)
    return cfg, jcfg, jp, LM.params_from_numpy(
        jp, serve.get_config(ARCH).reduced(), device="cpu")


def _x(seed, t, d=128):
    x = np.random.default_rng(seed).standard_normal((2, t, d)).astype(
        np.float32)
    return jnp.asarray(x, jnp.bfloat16), torch.tensor(x).bfloat16()


def _within_share(got, want, share):
    g, w = _f32(got), _f32(want)
    gap, top = np.abs(g - w).max(), np.abs(w).max()
    assert gap <= share * top, (gap, top)


def test_block_inits_are_the_reference_draws():
    cfg, jcfg = _cfgs()
    for port, ref in ((X.mlstm_init, JX.mlstm_init),
                      (X.slstm_init, JX.slstm_init)):
        want = ref(jax.random.PRNGKey(5), jcfg)
        got = port(jaxrand.PRNGKey(5, device="cpu"), cfg, "cpu",
                   torch.float32)
        assert sorted(got) == sorted(want)
        for k in want:
            for g, w in zip(LM.leaves(got[k]),
                            jax.tree_util.tree_leaves(want[k])):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), k)


def test_mlstm_apply_against_the_reference():
    """40 steps (one padded chunk) and 136 (two)."""
    cfg, jcfg, jp, tp = _block("mlstm")
    run = jax.jit(lambda p, x: JX.mlstm_apply(p, jcfg, x))
    for t in (40, 136):
        jx, tx = _x(t, t)
        out = X.mlstm_apply(tp, cfg, tx)
        assert out.dtype == torch.bfloat16
        assert_layer_close(out, run(jp, jx))


def test_mlstm_step_against_the_reference():
    cfg, jcfg, jp, tp = _block("mlstm", 4)
    jstep = jax.jit(lambda p, x, c: JX.mlstm_step(p, jcfg, x, c))
    jc = JX.mlstm_init_cache(jcfg, 2, jnp.bfloat16)
    tc = X.mlstm_init_cache(cfg, 2, torch.bfloat16)
    jx, tx = _x(9, 5)
    for i in range(5):
        jo, jc = jstep(jp, jx[:, i:i + 1], jc)
        to, tc = X.mlstm_step(tp, cfg, tx[:, i:i + 1], tc)
        assert_layer_close(to, jo)
        np.testing.assert_array_equal(_f32(tc["conv"]), _f32(jc["conv"]))
        _within_share(tc["state"], jc["state"], CELL_SHARE)


def test_slstm_cell_against_the_reference():
    """From a random state (h, c, n, m) and a random bfloat16 input
    contribution, three steps of the float32 cell."""
    cfg, jcfg, jp, tp = _block("slstm")
    rng = np.random.default_rng(11)
    d = cfg.d_model
    state = [rng.standard_normal((2, d)).astype(np.float32)
             for _ in range(4)]
    state[2] = np.abs(state[2]) + 1.0                      # n >= 1
    jcell = jax.jit(lambda p, wx, s: JX.slstm_cell(p, jcfg, wx, s))
    js, ts = tuple(jnp.asarray(a) for a in state), tuple(
        torch.tensor(a) for a in state)
    for i in range(3):
        wx = (2 * rng.standard_normal((2, 4 * d))).astype(np.float32)
        js = jcell(jp, jnp.asarray(wx, jnp.bfloat16), js)
        ts = X.slstm_cell(tp, cfg, torch.tensor(wx).bfloat16(), ts)
        for a, b in zip(ts, js):
            assert a.dtype == torch.float32
            _within_share(a, b, CELL_SHARE)


def test_slstm_apply_against_the_reference():
    cfg, jcfg, jp, tp = _block("slstm")
    jx, tx = _x(12, 24)
    out = X.slstm_apply(tp, cfg, tx)
    assert out.dtype == torch.bfloat16
    assert_layer_close(out, jax.jit(lambda p, x: JX.slstm_apply(
        p, jcfg, x))(jp, jx))


def test_slstm_step_against_the_reference():
    """Five steps from the fresh cache (the stabiliser at -1e9)."""
    cfg, jcfg, jp, tp = _block("slstm", 4)
    jstep = jax.jit(lambda p, x, c: JX.slstm_step(p, jcfg, x, c))
    jc, tc = JX.slstm_init_cache(jcfg, 2), X.slstm_init_cache(cfg, 2)
    assert float(tc["m"][0, 0]) == float(jc["m"][0, 0]) == -1e9
    jx, tx = _x(13, 5)
    for i in range(5):
        jo, jc = jstep(jp, jx[:, i:i + 1], jc)
        to, tc = X.slstm_step(tp, cfg, tx[:, i:i + 1], tc)
        assert_layer_close(to, jo)
        for k in "hcnm":
            assert tc[k].dtype == torch.float32
            _within_share(tc[k], jc[k], CELL_SHARE)


# ---------------------------------------------------------------------------
# the xLSTM LM, whole
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    return rl.reference(ARCH)


def test_init_lm_is_the_reference_draw():
    rl.check_draw(ARCH)
    cfg = serve.get_config(ARCH).reduced()
    p = LM.init_lm(jaxrand.PRNGKey(0, device="cpu"), cfg, device="cpu")
    mlstm, slstm = p["segments"]
    # the mLSTM layers stacked, the one sLSTM layer not
    assert mlstm["wq"]["w"].shape[0] == 3
    assert slstm["w_gates"]["w"].dim() == 2
    assert slstm["r_gates"].dtype == torch.float32


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
    """``Server("xlstm-125m", reduced=False)``'s parameters, built on the
    meta device: the reference's shapes, 0.194 B parameters (untied, the
    vocabulary padded to 50432); without a card the server raises unless
    given the CPU."""
    cfg = serve.get_config(ARCH)
    p = LM.init_lm(jaxrand.PRNGKey(0, device="cpu"), cfg, device="meta")
    want = jax.eval_shape(lambda: rl.JLM.init_lm(jax.random.PRNGKey(0),
                                                 rl.jget(ARCH)))
    assert [tuple(a.shape) for a in LM.leaves(p)] == [
        tuple(a.shape) for a in jax.tree_util.tree_leaves(want)]
    assert sum(a.numel() for a in LM.leaves(p)) == 194_490_624
    assert LM.seg_plan(cfg) == [("mlstm", 5), ("slstm", 1), ("mlstm", 5),
                                ("slstm", 1)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.Server(ARCH)
