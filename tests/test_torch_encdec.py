"""The port's encoder-decoder family (``repro_torch.models.encdec``, the
``encdec`` branches of ``launch/steps.py`` and ``launch/train.py``)
against the JAX package's ``repro.models.encdec``, on the CPU, on the
reduced seamless-m4t-medium (2 + 2 layers, d 128, 4 heads, vocab 512,
``frontend_len`` 8).

The reference's parameters are drawn once, eagerly (its jitted draw
folds each leaf's scale into the normal's own constant and parts from
the eager draw by an ulp), and carried into the port
(``encdec.params_from_numpy``); inputs are made from a seed with numpy.
The port rounds where XLA's CPU code rounds (``tests/test_torch_lm.py``:
the GeLU chain, the attention logits, the residual sum kept in float32
where the next norm reads it; the RoPE frequencies as ``pow(theta, -x)``
and the rotation's fused multiply-adds, ``layers.rope_tables`` /
``_rotate``).  Fed the reference's exact inputs, every op of both stacks
is then bitwise the reference's but two (``tests/_encdec_sweep.py
--ops 32``: the 96 seeded inputs of the sweep below, 8 decode steps
each): the bfloat16 products over 128 or 512 terms, whose float32 sums
run in XLA's CPU order (Eigen's blocking) in the reference and in
torch's in the port, which lands 1 bfloat16 ulp apart on 2.0e-5 to
2.8e-4 of a product's outputs; and RMSNorm, whose ``lax.rsqrt`` XLA
computes as the host's estimate instruction plus one Newton step (other
bits on AVX2 and AVX-512 hosts), 9 of 2 359 296 outputs.  Neither can
be followed portably, and the card computes both otherwise again.  Each such flip moves every later position: the
encoder is bidirectional and every decoder position reads every frame
through cross-attention.  The tolerances, each with its cause and its
measured value:

* ``LAYER_ULPS``, ``LAYER_SHARE``: one decoder layer (self-attention,
  cross-attention, MLP), the dense family's layer tolerance: each element
  within one bfloat16 ulp of the largest magnitude, at most 1% of them
  off the reference's bits.  Measured 0 at 5 and 12 tokens.
* ``ENCDEC_ULPS``: whole models on the module's inputs (encode, forward,
  decode, prefill and their caches and memory), the dense family's 2
  bfloat16 ulps of the reference tensor's largest magnitude.  Measured:
  ``encode`` 0 over 8 frames and 1.0 over 1024 (27% of the elements off),
  the forward 0.5, the decode steps' logits 0.5 and cache 1.0, the
  prefill 0.
* The sweep (``tests/_encdec_sweep.py``: frames ``default_rng(seed)``'s
  draws 0-2 of (2, 8, 128) normals, seeds 0-31, the module's tokens)
  holds three limits derived from the measured worsts over its 96
  inputs, and the worst inputs of each are tests here:

  - ``DECODER_ULPS`` 3: 8 teacher-forced decode steps fed the reference's
    own memory (logits and cache): the decoder's own flips.  Worst 2.0,
    on 3 of 96 inputs (``DECODER_WORST``), and one ulp for a host whose
    product order or ``rsqrt`` flips other elements.
  - ``MEMORY_ULPS`` 3: the port's ``encode`` against the reference's.  It
    parted on 29 of 96 inputs, worst 2.0 (seed 12, draw 2; up to 45% of
    its elements off), and the same one ulp.
  - ``SWEEP_ULPS`` 3.5: 8 decode steps of the whole model, each package
    on its own memory: the decoder's worst, 2.0, plus the most that the
    memory's flips raised an input's gap over its gap on the reference's
    memory, 1.5.  Worst 2.25 (seed 16, draw 0; 2.0 on 18 more inputs;
    ``ENCDEC_WORST``).

  (``ROADMAP.md``'s 2.25 from ``default_rng(0)``'s third draw did not
  reproduce: that input measures 0.66; seed 16's first draw gives 2.25.)
  No limit here sees the port's former RoPE forms (363-511 of 4.2 M
  rotated outputs off XLA's at positions 0-255): planted back, they give
  every one of the 96 inputs the same three gaps (positions 0-7 barely
  move a rotation).
  ``tests/test_torch_lm.py::test_rope_bits_against_the_reference`` holds
  RoPE's bits, and fails on those forms.
* ``OWN_ULPS``: the port's teacher-forced decode against its own forward
  and its own prefill, 2 ulps; measured 0 (the reference's are bit for
  bit too).

The train step is held to ``tests/_lm_train_cases.py``'s tolerances
(loss rtol 2e-4, gradients within 3e-2 of each leaf's largest, 99% of
the parameters bit-equal after Adam's first step), on seeded frames
(that module says why); measured loss rtol 7.7e-6, gradients 1.19e-2,
99.43% bit-equal.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lm_train_cases as cases
from repro.configs.base import get_config as jget
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import encdec as JED
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.core import jaxrand
from repro_torch.launch import crosscheck, serve, steps, train
from repro_torch.models import encdec as ED
from repro_torch.models import lm as LM
from repro_torch.optim.optimizers import tree_leaves

ARCH = "seamless-m4t-medium"
LAYER_ULPS, LAYER_SHARE = 1, 0.01
ENCDEC_ULPS = 2
DECODER_ULPS = 3
MEMORY_ULPS = 3
SWEEP_ULPS = 2.0 + 1.5
OWN_ULPS = 2
B, S = 2, 8
# (seed, draw) of the sweep's inputs that reached the largest gaps: the
# whole model's (2.25, 2.0, 2.0 ulps; seed 12's memory 2.0) and the
# decoder's on the reference's memory (2.0 each)
ENCDEC_WORST = [(16, 0), (29, 2), (27, 0), (12, 2)]
DECODER_WORST = [(16, 1), (15, 1), (14, 0)]


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def within_ulps(got, want, ulps, share=1.0) -> float:
    """Every element within ``ulps`` bfloat16 ulps of ``want``'s largest
    magnitude, at most ``share`` of them off its bits; returns the gap in
    ulps."""
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
    gap = float(np.abs(g - w).max() / ulp)
    assert gap <= ulps, gap
    assert np.mean(g != w) <= share, np.mean(g != w)
    return gap


def _frames(n, s_enc, d, seed, draw=0):
    """Draw ``draw`` of (n, s_enc, d) float32 normals from
    ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    for _ in range(draw + 1):
        f = rng.standard_normal((n, s_enc, d)).astype(np.float32)
    return f


@pytest.fixture(scope="module")
def model():
    """The reduced config in both packages, the reference's eager
    ``init_encdec(PRNGKey(0))`` as numpy (4 s alone, once per module),
    the port's float32 and bfloat16 draws, the carried parameters and
    seeded inputs."""
    cfg, jcfg = get_config(ARCH).reduced(), jget(ARCH).reduced()
    tree = jax.tree_util.tree_map(
        np.asarray, JED.init_encdec(jax.random.PRNGKey(0), jcfg))
    key = jaxrand.PRNGKey(0, device="cpu")
    frames = _frames(B, cfg.frontend_len, cfg.d_model, 1)
    return dict(
        cfg=cfg, jcfg=jcfg, tree=tree,
        jp=jax.tree_util.tree_map(jnp.asarray, tree),
        f32=ED.init_encdec(key, cfg, device="cpu", dtype=torch.float32),
        bf16=ED.init_encdec(key, cfg, device="cpu"),
        params=ED.params_from_numpy(tree, cfg, device="cpu"),
        frames=frames, jframes=jnp.asarray(frames, jnp.bfloat16),
        tokens=np.random.default_rng(2).integers(
            2, cfg.vocab_size, (B, S)).astype(np.int32))


def _jit_encode(jcfg):
    return jax.jit(lambda p, f: JED.encode(p, jcfg, f, train=False))


# ---------------------------------------------------------------------------
# the parameter draw
# ---------------------------------------------------------------------------


def test_init_encdec_is_the_reference_draw(model):
    """Float32 leaves bitwise the reference's, bfloat16 leaves its cast,
    the norm scales float32; the meta device gives the shapes only."""
    want = jax.tree_util.tree_leaves(model["tree"])
    f32, bf16 = tree_leaves(model["f32"]), tree_leaves(model["bf16"])
    assert len(want) == len(f32) == len(bf16) == 25
    for w, a, b in zip(want, f32, bf16):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), w)
        if b.dtype == torch.bfloat16:
            cast = np.asarray(jnp.asarray(w).astype(jnp.bfloat16)
                              .astype(jnp.float32))
            np.testing.assert_array_equal(b.float().numpy(), cast)
        else:                             # the norm scales stay float32
            np.testing.assert_array_equal(b.numpy(), w)
    meta = ED.init_encdec(jaxrand.PRNGKey(0, device="cpu"), model["cfg"],
                          device="meta")
    assert [(a.shape, a.dtype, a.device.type) for a in tree_leaves(meta)] \
        == [(a.shape, a.dtype, "meta") for a in bf16]
    carried = tree_leaves(model["params"])
    assert all(torch.equal(a, b) for a, b in zip(carried, bf16))


# ---------------------------------------------------------------------------
# encoder, one decoder layer, whole models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s_enc", [8, 1024])
def test_encode_against_the_reference(model, s_enc):
    """The bidirectional encoder on its own (no causal mask: a port that
    masked it would part from the reference in every position but the
    last), at ``frontend_len`` 8 and over 1024 frames (RoPE past position
    1000)."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    if s_enc != cfg.frontend_len:
        cfg = dataclasses.replace(cfg, frontend_len=s_enc)
        jcfg = dataclasses.replace(jcfg, frontend_len=s_enc)
    frames = _frames(B, s_enc, cfg.d_model, 3)
    want = _jit_encode(jcfg)(model["jp"], jnp.asarray(frames, jnp.bfloat16))
    got = ED.encode(model["params"], cfg, torch.tensor(frames), train=False)
    assert got.dtype == torch.bfloat16 and got.shape == (B, s_enc,
                                                         cfg.d_model)
    within_ulps(got, want, ENCDEC_ULPS)


@pytest.mark.parametrize("s_dec", [5, 12])
def test_decoder_layer_cross_attends_against_the_reference(model, s_dec):
    """One decoder layer at S_dec != S_enc (5 and 12 tokens against 8
    frames of memory): self-attention, then cross-attention through
    ``layers.attention(kv_override=memory)`` (no RoPE, no mask), then the
    MLP."""
    cfg, jcfg = model["cfg"], model["jcfg"]
    rng = np.random.default_rng(4 + s_dec)
    h = rng.standard_normal((B, s_dec, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, cfg.frontend_len, cfg.d_model)).astype(
        np.float32)
    jlp = jax.tree_util.tree_map(lambda a: a[0], model["jp"]["decoder"])
    want = jax.jit(lambda lp, x, m: JED._dec_layer(
        lp, jcfg, x, m, JED.NO_SHARDING)[0])(
        jlp, jnp.asarray(h, jnp.bfloat16), jnp.asarray(mem, jnp.bfloat16))
    got, cache = ED._dec_layer(LM.layer(model["params"]["decoder"], 0), cfg,
                               torch.tensor(h).bfloat16(),
                               torch.tensor(mem).bfloat16())
    assert cache is None and got.shape == (B, s_dec, cfg.d_model)
    within_ulps(got, want, LAYER_ULPS, LAYER_SHARE)


@pytest.fixture(scope="module")
def ref(model):
    """The reference's forward, 8 teacher-forced decode steps and a
    5-token prefill on the module's inputs, each jitted once; the jitted
    ``encode`` and decode step (``decode_on``) serve the other inputs of
    these shapes without a new compile."""
    jcfg, jp = model["jcfg"], model["jp"]
    jframes, tokens = model["jframes"], model["tokens"]
    out = {"forward": jax.jit(lambda p, f, t: JED.forward_encdec(
        p, jcfg, f, t, train=False))(jp, jframes, tokens)}
    out["encode"] = _jit_encode(jcfg)
    memory = out["encode"](jp, jframes)
    dstep = jax.jit(jsteps.make_decode_step(jcfg))

    def decode_on(memory):
        cache, steps_out = JED.init_dec_cache(jcfg, B, S), []
        for t in range(S):
            logits, cache = dstep(jp, cache, {"tokens": tokens[:, t:t + 1],
                                              "memory": memory,
                                              "index": jnp.int32(t)})
            steps_out.append((logits, cache))
        return steps_out

    out["decode_on"] = decode_on
    out["decode"] = decode_on(memory)
    out["prefill"] = jax.jit(jsteps.make_prefill_step(jcfg))(
        jp, {"frames": jframes, "tokens": tokens[:, :5]})
    return out


def test_forward_against_the_reference(model, ref):
    cfg = model["cfg"]
    logits = ED.forward_encdec(model["params"], cfg,
                               torch.tensor(model["frames"]),
                               model["tokens"], train=False)
    assert logits.shape == (B, S, cfg.vocab_padded)
    assert logits.dtype == torch.bfloat16
    within_ulps(logits, ref["forward"], ENCDEC_ULPS)


def test_decode_steps_against_the_reference(model, ref):
    """8 teacher-forced ``make_decode_step`` steps against the port's own
    ``encode`` memory: logits and cache against the reference's steps,
    and the steps against the port's own forward."""
    cfg, params, tokens = model["cfg"], model["params"], model["tokens"]
    memory = ED.encode(params, cfg, torch.tensor(model["frames"]),
                       train=False)
    decode = steps.make_decode_step(cfg)
    cache = ED.init_dec_cache(cfg, B, S, device="cpu")
    outs = []
    for t, (jlogits, jcache) in enumerate(ref["decode"]):
        before = {k: v.clone() for k, v in cache.items()}
        logits, new = decode(params, cache, {"tokens": tokens[:, t:t + 1],
                                             "memory": memory, "index": t})
        assert all(torch.equal(cache[k], before[k]) for k in cache)
        cache = new
        within_ulps(logits, jlogits, ENCDEC_ULPS)
        for k in ("k", "v"):
            within_ulps(cache[k], jcache[k], ENCDEC_ULPS)
        outs.append(logits[:, 0])
    full = ED.forward_encdec(params, cfg, torch.tensor(model["frames"]),
                             tokens, train=False)
    within_ulps(torch.stack(outs, 1), full, OWN_ULPS)


def _port_decode(model, memory):
    """The port's 8 teacher-forced ``make_decode_step`` steps on the
    module's tokens against ``memory``: [(logits, cache)]."""
    cfg, params, tokens = model["cfg"], model["params"], model["tokens"]
    decode = steps.make_decode_step(cfg)
    cache, out = ED.init_dec_cache(cfg, B, S, device="cpu"), []
    for t in range(S):
        logits, cache = decode(params, cache, {"tokens": tokens[:, t:t + 1],
                                               "memory": memory, "index": t})
        out.append((logits, cache))
    return out


def _held(got, want, ulps):
    """Every step's logits and final cache within ``ulps``; the largest
    logits gap."""
    gap = max(within_ulps(g[0], w[0], ulps) for g, w in zip(got, want))
    for k in ("k", "v"):
        within_ulps(got[-1][1][k], want[-1][1][k], ulps)
    return gap


@pytest.mark.parametrize("seed,draw", [(1, 0)] + DECODER_WORST)
def test_decoder_on_the_reference_memory(model, ref, seed, draw):
    """The decoder alone: 8 decode steps fed the reference's own memory,
    so that only the decoder's own flips part the two (``DECODER_ULPS``),
    on the module's frames and on the sweep's worst inputs for it."""
    frames = jnp.asarray(_frames(B, model["cfg"].frontend_len,
                                 model["cfg"].d_model, seed, draw),
                         jnp.bfloat16)
    memory = ref["encode"](model["jp"], frames)
    want = ref["decode"] if (seed, draw) == (1, 0) else \
        ref["decode_on"](memory)
    got = _port_decode(model, torch.tensor(_f32(memory)).bfloat16())
    _held(got, want, DECODER_ULPS)


@pytest.mark.parametrize("seed,draw", ENCDEC_WORST)
def test_whole_model_on_the_sweep_worst_inputs(model, ref, seed, draw):
    """The whole model on the sweep's worst inputs: the port's ``encode``
    against the reference's, then 8 decode steps each on its own package's
    memory (``MEMORY_ULPS``, ``SWEEP_ULPS``)."""
    cfg = model["cfg"]
    frames = _frames(B, cfg.frontend_len, cfg.d_model, seed, draw)
    jmemory = ref["encode"](model["jp"], jnp.asarray(frames, jnp.bfloat16))
    memory = ED.encode(model["params"], cfg, torch.tensor(frames),
                       train=False)
    within_ulps(memory, jmemory, MEMORY_ULPS)
    _held(_port_decode(model, memory), ref["decode_on"](jmemory),
          SWEEP_ULPS)


def test_prefill_against_the_reference(model, ref):
    """A 5-token prompt against 8 frames: the last logits, the K/V (5
    positions, K with RoPE) and the memory against the reference's; the
    K/V equal the decode cache's first 5 positions and the last logits
    the decode step on the prompt's last token (the port's own)."""
    cfg, params, tokens = model["cfg"], model["params"], model["tokens"]
    prefill = steps.make_prefill_step(cfg)
    frames = torch.tensor(model["frames"])
    last, kv, memory = prefill(params, {"frames": frames,
                                        "tokens": tokens[:, :5]})
    jlast, jkv, jmemory = ref["prefill"]
    assert last.shape == (B, 1, cfg.vocab_padded)
    assert kv["k"].shape == (cfg.n_layers, B, 5, cfg.n_kv_heads,
                             cfg.head_dim)
    for got, want in ((last, jlast), (memory, jmemory), (kv["k"], jkv["k"]),
                      (kv["v"], jkv["v"])):
        within_ulps(got, want, ENCDEC_ULPS)
    decode = steps.make_decode_step(cfg)
    cache = ED.init_dec_cache(cfg, B, 16, device="cpu")
    for t in range(5):
        logits, cache = decode(params, cache, {"tokens": tokens[:, t:t + 1],
                                               "memory": memory, "index": t})
    within_ulps(logits, last, OWN_ULPS)
    for k in ("k", "v"):
        within_ulps(cache[k][:, :, :5], kv[k], OWN_ULPS)
    assert not cache["k"][:, :, 5:].any()


def test_generate_gates_on_the_cpu(model):
    """``crosscheck.encdec_generate``, the card runs' greedy loop, on the
    CPU: ``main()``'s prompts each with its own seeded frames; the
    prefill's last logits equal the decode step on the prompt's last
    token and its K/V the decode cache's first S positions (the gates of
    ``chip_smoke.py`` 16 (f)); each request 8 tokens in the vocabulary."""
    cfg = model["cfg"]
    prompts = serve.prompts_for(cfg, 3)
    frames = crosscheck.encdec_frames(cfg, 3, 2)
    outs, records = crosscheck.encdec_generate(model["params"], cfg,
                                               prompts, frames, 8)
    for prompt, out, rec in zip(prompts, outs, records):
        assert len(out) == 8 and all(0 <= t < cfg.vocab_size for t in out)
        assert len(rec["steps"]) == len(prompt) - 1 + 8
        s = len(prompt)
        assert torch.equal(rec["steps"][s - 1], rec["prefill"][0, -1])
        assert all(torch.equal(rec["cache"][k], rec["kv"][k])
                   for k in ("k", "v"))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def test_train_step_against_the_reference(model):
    """One ``make_train_step`` step and ``loss_and_grads`` against the
    reference's jitted step and ``jax.grad``, remat on (the reference's
    ``forward_encdec`` trains under ``jax.checkpoint``)."""
    c = cases.case(ARCH, jparams=model["jp"])
    ref_out = cases.ref_step(c)
    opt = steps.make_optimizer(c["cfg"])
    got = steps.make_train_step(c["cfg"], opt)(
        c["params"], opt.init(c["params"]), c["batch"])
    (total, loss), grads = steps.loss_and_grads(c["cfg"], c["params"],
                                                c["batch"])
    assert torch.equal(total, loss)
    cases.check_step(c, ref_out, got, grads)


def test_train_loop_takes_steps_and_resumes(tmp_path):
    """Two CPU steps of ``train_loop`` (the encdec batch: ones frames), and
    the reference's fault-tolerance test (``crosscheck``: 12 steps
    straight against a failure at step 9 resumed from step 8)."""
    params, metrics = train.train_loop(ARCH, 2, batch=2, seq=16,
                                       log_every=10 ** 9, device="cpu")
    assert np.isfinite(metrics["loss"])
    assert set(params) == {"embed", "encoder", "decoder", "ln_enc", "ln_f",
                           "unembed"}
    out = crosscheck.resume_against_straight(ARCH, "cpu", str(tmp_path),
                                             batch=2, seq=16)
    assert out["bitwise"], out


# ---------------------------------------------------------------------------
# specs and the server
# ---------------------------------------------------------------------------


def _sd(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


def test_specs_at_full_width_against_the_reference():
    """``input_specs`` and ``cache_specs`` at every ``SHAPES`` cell and
    ``abstract_params`` / ``abstract_opt_state`` at full width (877 M
    parameters in 25 leaves): meta tensors of the reference's
    ``eval_shape`` shapes and dtypes."""
    cfg, jcfg = get_config(ARCH), jget(ARCH)
    for shape in SHAPES:
        got = steps.input_specs(cfg, shape)
        want = jsteps.input_specs(jcfg, shape)
        assert {k: _sd(v) for k, v in got.items()} == {
            k: (tuple(v.shape), str(v.dtype)) for k, v in want.items()}
        assert list(got) == list(want)
        got_c = tree_leaves(steps.cache_specs(cfg, shape))
        want_c = jax.tree_util.tree_leaves(jsteps.cache_specs(jcfg, shape))
        assert [_sd(v) for v in got_c] == [
            (tuple(v.shape), str(v.dtype)) for v in want_c]
    got_p = tree_leaves(steps.abstract_params(cfg))
    want_p = jax.tree_util.tree_leaves(jsteps.abstract_params(jcfg))
    assert [_sd(v) for v in got_p] == [
        (tuple(v.shape), str(v.dtype)) for v in want_p]
    assert all(v.device.type == "meta" for v in got_p)
    assert sum(v.numel() for v in got_p) == 877_197_312
    got_o = steps.abstract_opt_state(cfg)
    assert [_sd(v) for v in tree_leaves(got_o.mu)] == [_sd(v) for v in got_p]


def test_server_raises_for_encdec_as_the_reference():
    """The reference's ``Server`` serves decoder LMs only; the port's
    raises the same way, before it draws anything (encdec is served
    through ``make_prefill_step`` / ``make_decode_step``)."""
    with pytest.raises(NotImplementedError, match="decoder LMs"):
        jserve.Server(ARCH)
    with pytest.raises(NotImplementedError, match="decoder LMs"):
        serve.Server(ARCH, device="cpu")
