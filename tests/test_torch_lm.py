"""The port's LM stack (``repro_torch.configs``, ``models.layers``,
``models.lm``) against the JAX package's, on the CPU.

Configs: every architecture and its ``reduced()`` form equal the
reference's field for field, and so does ``seg_plan`` for every family.

Layers and models run on the JAX package's own parameters
(``init_lm(PRNGKey(1))``, its QKV biases redrawn nonzero so that they
count), carried into the port by ``lm.params_from_numpy``, on inputs made
from a seed with numpy.  The port computes what XLA's CPU code computes:
each bfloat16 step rounded where XLA rounds it (the SiLU and tanh-GeLU
chains, the attention logits scaled by the bfloat16 scale in float32, the
mid-block residual kept in float32 where the second norm reads it).  So
the dense products, the MLPs and the activations are held bit for bit.
Where the port cannot follow XLA, the comparison states a tolerance:

* ``NORM_F32_RTOL``: the norms on float32 inputs.  XLA's CPU code sums the
  squares in another order and takes ``rsqrt`` as a hardware estimate
  refined by a Newton step, an ulp or two off the correctly rounded value
  in about one result in seven; torch's differs.  So 4 float32 ulps.
* ``FREQ_RTOL``, ``ROPE_F32_ATOL``: RoPE on float32 inputs.  XLA's jitted
  ``pow``, ``sin`` and ``cos`` are not torch's: ``rope_freqs`` differed in
  5 of 16 values at head_dim 32, by an ulp (so 2 float32 ulps), and at
  position p an ulp of a frequency moves the angle by p ulps (measured
  4e-5 at p = 800), so 1e-4 absolute at positions below 1000.  Since the
  port takes XLA's forms (``layers.rope_freqs``, ``rope_tables``,
  ``_rotate``), the frequencies are bit for bit.
* ``ROPE_BITS_OFF``: RoPE's bfloat16 outputs at positions 0-255 whose bits
  part from the reference's, of 4 194 304.  XLA's ``cos`` / ``sin`` are
  the C library's ``cosf`` / ``sinf``, not correctly rounded on about 1.4%
  of angles; the port's are.  Measured 3 (theta 1e4) and 6 (1e6); the
  port's former forms (the quotient of the rounded power, torch's float32
  ``cos`` / ``sin``, a rotation of two roundings) parted on 363 and 511.
  So at most 32.
* ``LAYER_ULPS``, ``LAYER_SHARE``: the norms, RoPE and attention on
  bfloat16.  The float32 ulps above flip a bfloat16 rounding in a few
  elements of a thousand (measured: 1 to 4 of 2048); a flip is one ulp of
  its element, and through attention's sums a fraction of one of the
  output's.  So each element within one bfloat16 ulp of the tensor's
  largest magnitude, and at most 1% of them off the reference's bits.
* ``LOGIT_ULPS``: whole models (logits, caches).  Such flips travel
  through the layers and can reach most logits; measured, the largest gap
  is one bfloat16 ulp of the largest value (the reduced qwen2.5-14b is bit
  for bit on these inputs).  So each element within 2 ulps of the
  reference tensor's largest magnitude.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.launch.steps import make_decode_step as jmake_decode_step
from repro.models import layers as JL
from repro.models import lm as JLM
from repro_torch.configs import base
from repro_torch.core import jaxrand
from repro_torch.launch import steps
from repro_torch.models import layers as L
from repro_torch.models import lm as LM

NORM_F32_RTOL = 4 * 2.0 ** -23
FREQ_RTOL = 2.0 ** -22
ROPE_F32_ATOL = 1e-4
ROPE_BITS_OFF = 32
LAYER_ULPS, LAYER_SHARE = 1, 0.01
LOGIT_ULPS = 2
ARCHS = ("qwen2.5-14b", "starcoder2-15b", "internvl2-2b")
B, S = 2, 8


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_bitwise(got, want):
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape
    assert np.array_equal(g, w), \
        f"{np.sum(g != w)} of {g.size} differ, max {np.abs(g - w).max()}"


def assert_within_ulps(got, want, ulps=LOGIT_ULPS, share=1.0):
    """Every element within ``ulps`` bfloat16 ulps of the reference
    tensor's largest magnitude, and at most ``share`` of them off its
    bits."""
    g, w = _f32(got), _f32(want)
    assert g.shape == w.shape
    ulp = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
    assert np.abs(g - w).max() <= ulps * ulp, \
        (np.abs(g - w).max(), ulps * ulp)
    assert np.mean(g != w) <= share, np.mean(g != w)


def assert_layer_close(got, want):
    assert_within_ulps(got, want, LAYER_ULPS, LAYER_SHARE)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def _fields(cfg) -> dict:
    """A config's fields, nested configs as (class name, fields)."""
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = ((type(v).__name__, _fields(v))
                       if dataclasses.is_dataclass(v) else v)
    return out


@pytest.mark.parametrize("arch", jbase.ARCH_IDS + ("kws-paper",))
def test_config_equals_the_reference(arch):
    cfg, jcfg = base.get_config(arch), jbase.get_config(arch)
    assert type(cfg).__name__ == type(jcfg).__name__
    assert _fields(cfg) == _fields(jcfg)
    if arch == "kws-paper":
        return
    assert _fields(cfg.reduced()) == _fields(jcfg.reduced())
    assert cfg.vocab_padded == jcfg.vocab_padded
    assert _fields(cfg.attn_cfg()) == _fields(jcfg.attn_cfg())
    if cfg.family == "encdec":          # not a decoder LM in either package
        for plan in (LM.seg_plan, JLM.seg_plan):
            with pytest.raises(ValueError, match="encdec"):
                plan(cfg)
        return
    assert LM.seg_plan(cfg) == JLM.seg_plan(jcfg)
    assert LM.seg_plan(cfg.reduced()) == JLM.seg_plan(jcfg.reduced())


def test_registry_and_shapes_equal_the_reference():
    assert base.ARCH_IDS == jbase.ARCH_IDS
    assert base.SHAPES == jbase.SHAPES
    for v in (1, 255, 256, 92553, 152064):
        assert base.pad_vocab(v) == jbase.pad_vocab(v)


@pytest.mark.parametrize("arch,item", [
    ("zamba2-1.2b", "7d"), ("xlstm-125m", "7e")])
def test_families_not_ported_yet_raise(arch, item):
    """Named when these families raised; since ``ROADMAP.md`` queue 1,
    items 7d and 7e were ported, ``init_lm`` and ``init_cache`` of the
    reduced zamba2 and xLSTM build the reference's tree structure
    (``tests/test_torch_mamba2.py`` and ``test_torch_xlstm.py`` hold their
    numbers)."""
    cfg, jcfg = base.get_config(arch).reduced(), \
        jbase.get_config(arch).reduced()
    p = LM.init_lm(jaxrand.PRNGKey(0, device="cpu"), cfg, device="meta")
    want = jax.eval_shape(lambda: JLM.init_lm(jax.random.PRNGKey(0), jcfg))
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(want)[0]]
    assert [tuple(a.shape) for a in LM.leaves(p)] == [
        tuple(a.shape) for a in jax.tree_util.tree_leaves(want)], paths
    caches = LM.init_cache(cfg, 1, 4, device="cpu")
    jcaches = JLM.init_cache(jcfg, 1, 4)
    assert [(tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for a in LM.leaves(caches)] == [
        (tuple(a.shape), str(a.dtype))
        for a in jax.tree_util.tree_leaves(jcaches)]


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "qwen2-moe-a2.7b"])
def test_moe_families_now_build(arch):
    """The MoE family, ported: ``init_lm`` and ``init_cache`` of the
    reduced configs run (``tests/test_torch_moe.py`` holds them to the
    reference), one KV cache per layer as for the dense family."""
    cfg = base.get_config(arch).reduced()
    p = LM.init_lm(jaxrand.PRNGKey(0, device="cpu"), cfg, device="cpu")
    assert "moe" in p["segments"][0]
    (cache,) = LM.init_cache(cfg, 1, 4, device="cpu")
    assert cache["k"].shape == (cfg.n_layers, 1, 4, cfg.n_kv_heads,
                                cfg.head_dim)


def test_encdec_steps_raise_until_ported():
    """The encoder-decoder family, ported: ``make_prefill_step`` and
    ``make_decode_step`` of the reduced seamless-m4t-medium build and take
    their steps (``tests/test_torch_encdec.py`` holds them to the
    reference): the prefill's last logits, its prompt-long K/V and the
    encoder's memory, then a decode step against that memory writing its
    cache at the index."""
    cfg = base.get_config("seamless-m4t-medium").reduced()
    params = steps.init_params_for(cfg, jaxrand.PRNGKey(0, device="cpu"),
                                   device="cpu")
    tokens = torch.tensor(np.random.default_rng(0).integers(
        2, cfg.vocab_size, (1, 3)))
    frames = torch.ones((1, cfg.frontend_len, cfg.d_model))
    last, kv, memory = steps.make_prefill_step(cfg)(
        params, {"frames": frames, "tokens": tokens})
    assert last.shape == (1, 1, cfg.vocab_padded)
    assert kv["k"].shape == (cfg.n_layers, 1, 3, cfg.n_kv_heads,
                             cfg.head_dim)
    assert memory.shape == (1, cfg.frontend_len, cfg.d_model)
    cache = {k: torch.zeros((cfg.n_layers, 1, 8, cfg.n_kv_heads,
                             cfg.head_dim), dtype=torch.bfloat16)
             for k in ("k", "v")}
    logits, new = steps.make_decode_step(cfg)(
        params, cache, {"tokens": tokens[:, :1], "memory": memory,
                        "index": 2})
    assert logits.shape == (1, 1, cfg.vocab_padded)
    assert bool(torch.isfinite(logits.float()).all())
    assert new["k"][:, :, 2].any() and not new["k"][:, :, 3:].any()
    assert not cache["k"].any()


def test_init_lm_draws_at_the_reference_scales():
    cfg = base.get_config("qwen2.5-14b").reduced()
    p = LM.init_lm(jaxrand.PRNGKey(3, device="cpu"), cfg, device="cpu")
    seg = p["segments"][0]
    d, ff = cfg.d_model, cfg.d_ff
    for leaf, want in ((p["embed"], 0.02), (p["unembed"], d ** -0.5),
                       (seg["attn"]["wq"]["w"], d ** -0.5),
                       (seg["attn"]["wo"]["w"],
                        (cfg.n_heads * cfg.head_dim) ** -0.5),
                       (seg["mlp"]["w_down"]["w"], ff ** -0.5)):
        assert leaf.dtype == torch.bfloat16
        assert abs(float(leaf.float().std()) / want - 1) < 0.05
    assert seg["attn"]["wq"]["w"].shape == (cfg.n_layers, d,
                                            cfg.n_heads * cfg.head_dim)
    assert seg["attn"]["wq"]["b"].dtype == torch.bfloat16
    assert not seg["attn"]["wq"]["b"].any()
    assert seg["ln1"]["scale"].dtype == torch.float32
    assert torch.equal(seg["ln1"]["scale"], torch.ones(cfg.n_layers, d))
    # the layers are drawn one by one, not repeated
    assert not torch.equal(seg["attn"]["wq"]["w"][0],
                           seg["attn"]["wq"]["w"][1])
    again = LM.init_lm(jaxrand.PRNGKey(3, device="cpu"), cfg,
                       device="cpu")
    assert torch.equal(again["segments"][0]["mlp"]["w_up"]["w"],
                       seg["mlp"]["w_up"]["w"])


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def _bf16(x):
    return jnp.asarray(x, jnp.bfloat16), torch.tensor(x).bfloat16()


def test_norms_against_the_reference():
    rng = np.random.default_rng(0)
    x = (3 * rng.standard_normal((2, 8, 128))).astype(np.float32)
    sc = (1 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    bi = (0.1 * rng.standard_normal(128)).astype(np.float32)
    jrms = jax.jit(JL.rmsnorm)
    jln = jax.jit(JL.layernorm)
    pr = {"scale": sc}
    pl = {"scale": sc, "bias": bi}
    tp = lambda p: {k: torch.tensor(v) for k, v in p.items()}
    # bfloat16 inputs, as the model feeds them
    xb, xt = _bf16(x)
    assert_layer_close(L.rmsnorm(tp(pr), xt), jrms(pr, xb))
    assert_layer_close(L.layernorm(tp(pl), xt), jln(pl, xb))
    # float32 inputs: the rsqrt estimate and the sum order (module doc)
    np.testing.assert_allclose(L.rmsnorm(tp(pr), torch.tensor(x)).numpy(),
                               np.asarray(jrms(pr, x)), rtol=NORM_F32_RTOL,
                               atol=0)
    np.testing.assert_allclose(
        L.layernorm(tp(pl), torch.tensor(x)).numpy(),
        np.asarray(jln(pl, x)), rtol=NORM_F32_RTOL, atol=1e-6)


@pytest.mark.parametrize("theta", [1e6, 1e5])
def test_rope_against_the_reference(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 4, 32)).astype(np.float32)
    jrope = jax.jit(JL.apply_rope, static_argnums=2)
    for pos in (np.arange(8)[None] + 3, np.arange(100, 900, 100)[None]):
        xb, xt = _bf16(x)
        assert_layer_close(L.apply_rope(xt, torch.tensor(pos), theta),
                       jrope(xb, jnp.asarray(pos), theta))
        np.testing.assert_allclose(
            L.apply_rope(torch.tensor(x), torch.tensor(pos), theta).numpy(),
            np.asarray(jrope(jnp.asarray(x), jnp.asarray(pos), theta)),
            rtol=0, atol=ROPE_F32_ATOL)
    np.testing.assert_allclose(
        L.rope_freqs(32, theta).numpy(),
        np.asarray(jax.jit(JL.rope_freqs, static_argnums=(0, 1))(32, theta)),
        rtol=FREQ_RTOL)


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_rope_bits_against_the_reference(theta):
    """The frequencies bit for bit at head_dim 32, 64 and 128, and the
    rotation of 4.2 M bfloat16 inputs at positions 0-255 with at most
    ``ROPE_BITS_OFF`` outputs off the reference's bits."""
    freqs = jax.jit(JL.rope_freqs, static_argnums=(0, 1))
    for hd in (32, 64, 128):
        np.testing.assert_array_equal(L.rope_freqs(hd, theta).numpy(),
                                      np.asarray(freqs(hd, theta)))
    x = np.random.default_rng(3).standard_normal(
        (128, 256, 4, 32)).astype(np.float32)
    xb, xt = _bf16(x)
    want = jax.jit(lambda x: JL.apply_rope(x, jnp.arange(256)[None, :],
                                           theta))(xb)
    got = L.apply_rope(xt, torch.arange(256), theta)
    off = int((got.float().numpy()
               != np.asarray(want.astype(jnp.float32))).sum())
    assert off <= ROPE_BITS_OFF, f"{off} of {x.size} outputs off"


def _attn_params(cfg: JL.AttnConfig, seed: int):
    p = jax.tree_util.tree_map(
        np.asarray, JL.attn_init(jax.random.PRNGKey(seed), cfg))
    rng = np.random.default_rng(seed)
    for name in ("wq", "wk", "wv"):
        if "b" in p[name]:
            p[name]["b"] = (0.1 * rng.standard_normal(
                p[name]["b"].shape)).astype(np.float32)
    return p


@pytest.mark.parametrize("n_kv,bias,qk_norm", [
    (4, True, False), (2, True, False), (1, False, True)],
    ids=["mha-bias", "gqa-bias", "mqa-qknorm"])
def test_attention_against_the_reference(n_kv, bias, qk_norm):
    """Full causal attention, the cached decode write at an index with its
    mask, and the cross-attention branch (``kv_override``)."""
    kw = dict(d_model=128, n_heads=4, n_kv_heads=n_kv, head_dim=32,
              qkv_bias=bias, qk_norm=qk_norm, rope_theta=1e6)
    jcfg, cfg = JL.AttnConfig(**kw), L.AttnConfig(**kw)
    p = _attn_params(jcfg, n_kv)
    if qk_norm:      # float32 norm scales, away from ones
        rng = np.random.default_rng(9)
        for k in ("q_norm", "k_norm"):
            p[k]["scale"] = (1 + 0.1 * rng.standard_normal(32)).astype(
                np.float32)
    tp = jax.tree_util.tree_map(lambda a: torch.tensor(np.asarray(a)), p)
    tp = {k: ({kk: (vv if kk == "scale" else vv.bfloat16())
               for kk, vv in v.items()}) for k, v in tp.items()}
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 128)).astype(np.float32)
    mem = rng.standard_normal((2, 5, 128)).astype(np.float32)
    xb, xt = _bf16(x)
    mb, mt = _bf16(mem)

    full = jax.jit(lambda p, x: JL.attention(p, jcfg, x)[0])
    assert_layer_close(L.attention(tp, cfg, xt)[0], full(p, xb))

    cross = jax.jit(lambda p, x, m: JL.attention(p, jcfg, x,
                                                 kv_override=m)[0])
    assert_layer_close(L.attention(tp, cfg, xt, kv_override=mt)[0],
                   cross(p, xb, mb))

    cache0 = rng.standard_normal((2, 12, n_kv, 32)).astype(np.float32)
    jcache = {"k": jnp.asarray(cache0, jnp.bfloat16),
              "v": jnp.asarray(-cache0, jnp.bfloat16)}
    tcache = {"k": torch.tensor(cache0).bfloat16(),
              "v": torch.tensor(-cache0).bfloat16()}
    cached = jax.jit(lambda p, x, c, i: JL.attention(p, jcfg, x, cache=c,
                                                     cache_index=i))
    for s, index in ((1, 5), (3, 2), (2, 11)):     # the last one clamps
        jo, jc = cached(p, xb[:, :s], jcache, jnp.int32(index))
        given = {k: v.clone() for k, v in tcache.items()}
        to, tc = L.attention(tp, cfg, xt[:, :s], cache=given,
                             cache_index=index)
        assert_layer_close(to, jo)
        assert_layer_close(tc["k"], jc["k"])
        assert_bitwise(tc["v"], jc["v"])
        # the new kv is written into the given buffers, which come back
        assert tc["k"] is given["k"] and tc["v"] is given["v"]


@pytest.mark.parametrize("gated", [True, False], ids=["swiglu", "gelu"])
def test_mlp_against_the_reference(gated):
    p = jax.tree_util.tree_map(np.asarray, JL.mlp_init(
        jax.random.PRNGKey(3), 128, 256, gated))
    tp = jax.tree_util.tree_map(lambda a: torch.tensor(a).bfloat16(), p)
    x = np.random.default_rng(3).standard_normal((2, 8, 128)).astype(
        np.float32)
    xb, xt = _bf16(x)
    jm = jax.jit(lambda p, x: JL.mlp(p, x, gated=gated))
    assert_bitwise(L.mlp(tp, xt, gated), jm(p, xb))


def test_activations_equal_xla_on_every_input():
    """SiLU and the tanh GeLU on bfloat16, each step rounded as XLA's CPU
    code rounds it, over a million inputs: bit for bit."""
    x = (2 * np.random.default_rng(4).standard_normal(1 << 20)).astype(
        np.float32)
    xb, xt = _bf16(x)
    assert_bitwise(L.silu(xt), jax.jit(jax.nn.silu)(xb))
    assert_bitwise(L.gelu_tanh(xt), jax.jit(jax.nn.gelu)(xb))


# ---------------------------------------------------------------------------
# whole models: forward, caches, decode, prefill
# ---------------------------------------------------------------------------


def _jax_params(jcfg, seed=1):
    """The reference's ``init_lm`` parameters as numpy, the QKV biases
    (zeros at init) redrawn so that the bias path counts."""
    tree = jax.tree_util.tree_map(np.asarray,
                                  JLM.init_lm(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)

    def redraw(path, a):
        if jax.tree_util.keystr(path).endswith("['b']"):
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(redraw, tree)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """One reduced config: its parameters in both packages, inputs, and
    the reference's forward, 8 teacher-forced decode steps and prefill
    (one jitted function each)."""
    arch = request.param
    jcfg, cfg = jbase.get_config(arch).reduced(), \
        base.get_config(arch).reduced()
    tree = _jax_params(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tokens = np.random.default_rng(1).integers(
        2, cfg.vocab_size, (B, S)).astype(np.int32)
    prefix = None
    if cfg.family == "vlm":
        prefix = np.random.default_rng(2).standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    jprefix = None if prefix is None else jnp.asarray(prefix, jnp.bfloat16)
    ref = {}
    ref["forward"] = jax.jit(lambda p, t, f: JLM.forward_lm(
        p, jcfg, t, prefix_embeds=f, train=False)[0])(jp, tokens, jprefix)
    dstep = jax.jit(jmake_decode_step(jcfg))
    cache = JLM.init_cache(jcfg, B, S)
    ref["cache0"] = cache
    ref["decode"] = []
    for t in range(S):
        logits, cache = dstep(jp, cache, {"tokens": tokens[:, t:t + 1],
                                          "index": jnp.int32(t)})
        ref["decode"].append((logits, cache))
    ref["prefill"] = jax.jit(lambda p, t, f: JLM.prefill(
        p, jcfg, t, prefix_embeds=f))(jp, tokens, jprefix)
    params = LM.params_from_numpy(tree, cfg, device="cpu")
    return dict(arch=arch, cfg=cfg, params=params, tokens=tokens,
                prefix=None if prefix is None else torch.tensor(prefix),
                ref=ref)


def test_params_carry_with_the_reference_casts(model):
    p = model["params"]
    seg = p["segments"][0]
    assert p["embed"].dtype == torch.bfloat16
    assert seg["mlp"]["w_up"]["w"].dtype == torch.bfloat16
    assert seg["ln2"]["scale"].dtype == torch.float32
    assert p["ln_f"]["scale"].dtype == torch.float32
    assert LM.param_bytes(p) == sum(
        a.numel() * a.element_size() for a in LM.leaves(p))


def test_forward_against_the_reference(model):
    cfg = model["cfg"]
    logits, aux = LM.forward_lm(model["params"], cfg, model["tokens"],
                                prefix_embeds=model["prefix"], train=False)
    p_len = 0 if model["prefix"] is None else cfg.frontend_len
    assert logits.shape == (B, S + p_len, cfg.vocab_padded)
    assert logits.dtype == torch.bfloat16
    assert float(aux) == 0.0
    assert_within_ulps(logits, model["ref"]["forward"])


def test_init_cache_equals_the_reference(model):
    cfg = model["cfg"]
    caches = LM.init_cache(cfg, B, S, device="cpu")
    ref = model["ref"]["cache0"]
    assert len(caches) == len(ref)
    for c, r in zip(caches, ref):
        for k in ("k", "v"):
            assert c[k].dtype == torch.bfloat16
            assert_bitwise(c[k], r[k])


def test_decode_steps_against_the_reference(model):
    """8 teacher-forced decode steps: each step's logits and both caches."""
    cfg, params, tokens = model["cfg"], model["params"], model["tokens"]
    decode = steps.make_decode_step(cfg)
    caches = LM.init_cache(cfg, B, S, device="cpu")
    for t, (jlogits, jcaches) in enumerate(model["ref"]["decode"]):
        before = [{k: c[k].clone() for k in c} for c in caches]
        given = caches
        logits, caches = decode(params, caches,
                                {"tokens": tokens[:, t:t + 1], "index": t})
        # as the reference's step, it leaves the given caches as they were
        for g, b in zip(given, before):
            assert all(torch.equal(g[k], b[k]) for k in b)
        assert logits.shape == (B, 1, cfg.vocab_padded)
        assert_within_ulps(logits, jlogits)
        for c, r in zip(caches, jcaches):
            assert_within_ulps(c["k"], r["k"])
            assert_within_ulps(c["v"], r["v"])


def test_prefill_against_the_reference(model):
    """Last-position logits and the caches: K with RoPE, V without, S
    positions long (the prefix counted)."""
    cfg = model["cfg"]
    prefill = steps.make_prefill_step(cfg)
    batch = {"tokens": model["tokens"]}
    if model["prefix"] is not None:
        batch["frames"] = model["prefix"]
    logits, caches = prefill(model["params"], batch)
    jlogits, jcaches = model["ref"]["prefill"]
    assert logits.shape == (B, 1, cfg.vocab_padded)
    assert_within_ulps(logits, jlogits)
    for c, r in zip(caches, jcaches):
        for k in ("k", "v"):
            assert c[k].shape == r[k].shape
            assert_within_ulps(c[k], r[k])


def test_teacher_forced_decode_equals_the_full_forward(model):
    """The port's own oracle, as ``tests/test_lm_archs.py`` holds the
    reference: the decode path token by token gives the full forward's
    logits (there within atol 0.15, rtol 0.05; the port is held to the
    same ``LOGIT_ULPS`` as against the reference, since both of its
    paths round alike).  The decode path takes no prefix, so the VLM runs
    on its tokens alone here."""
    cfg, params, tokens = model["cfg"], model["params"], model["tokens"]
    full, _ = LM.forward_lm(params, cfg, tokens, train=False)
    caches = LM.init_cache(cfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        logits, caches = LM.decode_step(params, cfg, tokens[:, t:t + 1],
                                        caches, t)
        outs.append(logits[:, 0])
    assert_within_ulps(torch.stack(outs, dim=1), full)


def test_entry_points_accumulate_bfloat16_products_in_float32(
        model, monkeypatch):
    """``forward_lm``, ``decode_step`` and ``prefill`` hold cuBLAS to
    float32 accumulation of the bfloat16 products while they run, whoever
    calls them, and give the caller's setting back."""
    cfg, params, tokens = model["cfg"], model["params"], model["tokens"]
    matmul = torch.backends.cuda.matmul
    seen = []
    dense = L.dense

    def watched(p, x):
        seen.append(matmul.allow_bf16_reduced_precision_reduction)
        return dense(p, x)
    monkeypatch.setattr(L, "dense", watched)
    keep = matmul.allow_bf16_reduced_precision_reduction
    try:
        matmul.allow_bf16_reduced_precision_reduction = True
        LM.forward_lm(params, cfg, tokens[:, :2], train=False)
        LM.prefill(params, cfg, tokens[:, :2])
        LM.decode_step(params, cfg, tokens[:, :1],
                       LM.init_cache(cfg, B, 2, device="cpu"), 0)
        assert matmul.allow_bf16_reduced_precision_reduction is True
    finally:
        matmul.allow_bf16_reduced_precision_reduction = keep
    assert seen and not any(seen)
