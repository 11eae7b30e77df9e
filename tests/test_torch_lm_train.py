"""The port's LM parameters and training step against the JAX package's,
on the CPU, on the reduced dense and VLM configs (2 layers, d 128).

- ``lm.init_lm(PRNGKey(0))`` draws the reference's parameters bit for
  bit, float32 leaves exactly, bfloat16 leaves as the reference's cast;
  the reduced ``Server(seed=0)`` serves the reference's greedy tokens with
  nothing carried in (starcoder2-15b may fork only where the reference's
  own top-2 margin is within ``LOGIT_ULPS``, as in
  ``tests/test_torch_lm_serve.py``).
- ``lm.lm_loss`` against the reference's on random bfloat16 logits over a
  padded vocabulary: within ``LOSS_ULPS`` float32 ulps (XLA's ``exp`` and
  ``log`` are not torch's; measured 0), and its gradient within one
  bfloat16 ulp of the largest.
- One ``steps.make_train_step`` step and ``loss_and_grads`` against the
  reference's jitted step and ``jax.grad`` on qwen2.5-14b (gated, QKV
  bias) and starcoder2-15b (GeLU, biases), within the tolerances of
  ``tests/_lm_train_cases.py`` (the other three archs are in
  ``tests/test_torch_lm_ckpt.py``); remat on and off; the spec helpers.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lm_train_cases as cases
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jget
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import lm as JLM
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.core import jaxrand
from repro_torch.launch import serve, steps
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.optim.optimizers import tree_leaves

ARCHS = ("qwen2.5-14b", "starcoder2-15b", "internlm2-20b",
         "mistral-large-123b", "internvl2-2b")
LOSS_ULPS = 4
LOGIT_ULPS = 2


def _cpu_key(seed=0):
    return jaxrand.PRNGKey(seed, device="cpu")


# ---------------------------------------------------------------------------
# the parameter draw (ROADMAP.md queue 3, fault 1)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_is_the_reference_draw(arch):
    cfg, jcfg = get_config(arch).reduced(), jget(arch).reduced()
    want = jax.tree_util.tree_leaves(JLM.init_lm(jax.random.PRNGKey(0),
                                                 jcfg))
    f32 = LM.init_lm(_cpu_key(), cfg, device="cpu", dtype=torch.float32)
    bf16 = LM.init_lm(_cpu_key(), cfg, device="cpu")
    assert len(tree_leaves(f32)) == len(want) == len(tree_leaves(bf16))
    for w, a, b in zip(want, tree_leaves(f32), tree_leaves(bf16)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
        if b.dtype == torch.bfloat16:
            cast = np.asarray(w.astype(jnp.bfloat16).astype(jnp.float32))
            np.testing.assert_array_equal(b.float().numpy(), cast)
        else:                             # the norm scales stay float32
            np.testing.assert_array_equal(b.numpy(), np.asarray(w))


def test_init_draws_in_chunks_of_counters(monkeypatch):
    """A leaf drawn in chunks (``layers.DRAW_CHUNK``, 2**26 on the card)
    is the same draw: each element's counter is its flat index.  Chunks of
    1000 elements split every leaf here, mid-row."""
    cfg = get_config("internvl2-2b").reduced()
    whole = LM.init_lm(_cpu_key(3), cfg, device="cpu", dtype=torch.float32)
    monkeypatch.setattr(L, "DRAW_CHUNK", 1000)
    chunked = LM.init_lm(_cpu_key(3), cfg, device="cpu",
                         dtype=torch.float32)
    for a, b in zip(tree_leaves(whole), tree_leaves(chunked)):
        assert torch.equal(a, b)
    meta = LM.init_lm(_cpu_key(3), cfg, device="meta")
    assert [(a.shape, a.dtype) for a in tree_leaves(meta)] == [
        (a.shape, a.dtype) for a in tree_leaves(
            LM.init_lm(_cpu_key(3), cfg, device="cpu"))]


@pytest.mark.parametrize("arch", ("qwen2.5-14b", "starcoder2-15b",
                                  "internvl2-2b"))
def test_server_seed_serves_the_reference_tokens(arch):
    """``Server(arch, seed=0)`` on ``main()``'s traffic, with no
    parameters carried in: the reference's greedy tokens (measured: equal
    on qwen2.5-14b and internvl2-2b; starcoder2-15b forks at request 1,
    token 3, where the reference's own top-2 margin is within
    ``LOGIT_ULPS``)."""
    jsrv = jserve.Server(arch, reduced=True, seed=0)
    logits = []
    decode = jsrv.decode

    def recording(params, caches, batch):
        out, caches = decode(params, caches, batch)
        logits.append(np.asarray(out[0, -1].astype(jnp.float32)))
        return out, caches
    jsrv.decode = recording
    srv = serve.Server(arch, reduced=True, seed=0, device="cpu")
    for a, w in zip(tree_leaves(srv.params),
                    jax.tree_util.tree_leaves(jsrv.params)):
        if a.dtype == torch.bfloat16:
            w = w.astype(jnp.bfloat16).astype(jnp.float32)
        np.testing.assert_array_equal(a.float().numpy(), np.asarray(w))
    prompts = serve.prompts_for(srv.cfg, 4)
    want = jsrv.submit_and_run(prompts, max_new=8)
    got = srv.submit_and_run(prompts, max_new=8)
    if arch != "starcoder2-15b":
        assert got == want
        return
    step = 0
    for r, (g, w, prompt) in enumerate(zip(got, want, prompts)):
        step += len(prompt) - 1
        for j, (a, b) in enumerate(zip(g, w)):
            if a != b:
                row = logits[step + j][:srv.cfg.vocab_size]
                top2 = np.sort(row)[-2:]
                ulp = 2.0 ** (np.floor(np.log2(np.abs(row).max())) - 7)
                assert top2[1] - top2[0] <= LOGIT_ULPS * ulp, (r, j, top2)
                break
        step += len(w)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("offset", [0, 3])
def test_lm_loss_against_the_reference(offset):
    """Random bfloat16 logits over a padded vocabulary (200 of 256 real),
    with and without a label offset: the loss within ``LOSS_ULPS`` float32
    ulps and its gradient within one bfloat16 ulp of the largest."""
    rng = np.random.default_rng(offset)
    logits = (3 * rng.standard_normal((2, 11, 256))).astype(np.float32)
    labels = rng.integers(0, 200, (2, 11 - offset))
    jl = jnp.asarray(logits, jnp.bfloat16)

    def jloss(x):
        return JLM.lm_loss(x, jnp.asarray(labels, jnp.int32), 200,
                           label_offset=offset)
    want, jgrad = jax.jit(jax.value_and_grad(jloss))(jl)
    x = torch.tensor(logits).bfloat16().requires_grad_()
    got = LM.lm_loss(x, torch.tensor(labels), 200, label_offset=offset)
    grad, = torch.autograd.grad(got, x)
    ulp = np.spacing(np.float32(want))
    assert abs(float(got.detach()) - float(want)) <= LOSS_ULPS * ulp
    jg = np.asarray(jgrad.astype(jnp.float32))
    top = np.abs(jg).max()
    assert np.abs(grad.float().numpy() - jg).max() <= 2.0 ** (
        np.floor(np.log2(top)) - 7)
    if offset:                          # the prefix positions get nothing
        assert not grad[:, :offset].any()
    assert not grad[..., 200:].any()    # nor the padded vocabulary


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ("qwen2.5-14b", "starcoder2-15b"))
def test_train_step_against_the_reference(arch):
    c = cases.case(arch)
    ref = cases.ref_step(c)
    cfg = c["cfg"]
    opt = steps.make_optimizer(cfg)
    got = steps.make_train_step(cfg, opt)(c["params"],
                                          opt.init(c["params"]), c["batch"])
    _, grads = steps.loss_and_grads(cfg, c["params"], c["batch"])
    # the reference's own finiteness and range check (test_lm_archs)
    loss = float(got[2]["loss"])
    assert 0.5 * np.log(cfg.vocab_size) < loss < 2.5 * np.log(
        cfg.vocab_size)
    assert all(g.dtype == torch.float32 for g in tree_leaves(grads))
    cases.check_step(c, ref, got, grads)


@pytest.mark.parametrize("arch", ("qwen2.5-14b", "internvl2-2b"))
def test_remat_changes_memory_not_numbers(arch, monkeypatch):
    """``cfg.remat`` with ``train`` runs each layer under
    ``torch.utils.checkpoint``: the backward runs every layer's forward
    again, and the gradients are bit for bit those without remat."""
    cfg = get_config(arch).reduced()
    params = LM.init_lm(_cpu_key(), cfg, device="cpu", dtype=torch.float32)
    batch = cases.batch(cfg)
    calls = []
    block = LM._block

    def counting(*args):
        calls.append(1)
        return block(*args)
    monkeypatch.setattr(LM, "_block", counting)
    grads, counts = [], []
    for remat in (True, False):
        calls.clear()
        (total, _), g = steps.loss_and_grads(
            dataclasses.replace(cfg, remat=remat), params, batch)
        grads.append(tree_leaves(g))
        counts.append(len(calls))
    assert counts == [2 * cfg.n_layers, cfg.n_layers]
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_train_step_raises_for_the_families_still_to_port():
    """No family is left to port: the zamba2 and xLSTM families (items 7d,
    7e) and the encoder-decoder (7f) take a step, its loss finite and
    every new parameter finite and some moved
    (``tests/test_torch_mamba2.py``, ``test_torch_xlstm.py`` and
    ``test_torch_encdec.py`` hold the step to the reference's)."""
    for arch in ("zamba2-1.2b", "xlstm-125m", "seamless-m4t-medium"):
        cfg = get_config(arch).reduced()
        params = steps.init_params_for(cfg, _cpu_key(), device="cpu",
                                       dtype=torch.float32)
        opt = steps.make_optimizer(cfg)
        new, _, metrics = steps.make_train_step(cfg, opt)(
            params, opt.init(params), cases.batch(cfg))
        assert np.isfinite(float(metrics["loss"]))
        assert all(bool(torch.isfinite(a).all()) for a in tree_leaves(new))
        assert not all(torch.equal(a, b) for a, b in zip(
            tree_leaves(new), tree_leaves(params)))


# ---------------------------------------------------------------------------
# the spec helpers
# ---------------------------------------------------------------------------


def _sd(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_helpers_against_the_reference(arch):
    """``input_specs`` and ``cache_specs`` at every ``SHAPES`` cell,
    ``abstract_params`` (float32) and ``abstract_opt_state`` at full
    width: meta tensors of the reference's shapes and dtypes."""
    cfg, jcfg = get_config(arch), jget(arch)
    assert SHAPES == JSHAPES
    for shape in SHAPES:
        got = steps.input_specs(cfg, shape)
        want = jsteps.input_specs(jcfg, shape)
        assert {k: _sd(v) for k, v in got.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
        assert all(v.device.type == "meta" for v in got.values())
        got_c = tree_leaves(steps.cache_specs(cfg, shape))
        want_c = jax.tree_util.tree_leaves(jsteps.cache_specs(jcfg, shape))
        assert [_sd(v) for v in got_c] == [
            (tuple(v.shape), str(v.dtype)) for v in want_c]
    got_p = tree_leaves(steps.abstract_params(cfg))
    want_p = jax.tree_util.tree_leaves(jsteps.abstract_params(jcfg))
    assert [_sd(v) for v in got_p] == [
        (tuple(v.shape), str(v.dtype)) for v in want_p]
    assert all(v.device.type == "meta" for v in got_p)
    got_o = steps.abstract_opt_state(cfg)
    want_o = jsteps.abstract_opt_state(jcfg)
    assert got_o.step == 0 and want_o.step.shape == ()
    for g, w in ((got_o.mu, want_o.mu), (got_o.nu, want_o.nu)):
        assert [_sd(v) for v in tree_leaves(g)] == [
            (tuple(v.shape), str(v.dtype))
            for v in jax.tree_util.tree_leaves(w)]
