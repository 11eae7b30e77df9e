"""The port's mixture-of-experts family (``models.moe``, the ``attn_moe``
segment of ``models.lm``, their training and ``examples.train_lm``)
against the JAX package's, on the CPU, on the reduced qwen3-moe-30b-a3b
(QK-norm, 4 experts top-2) and qwen2-moe-a2.7b (QKV bias, shared experts
behind their sigmoid gate).

- ``moe_init`` and ``init_lm`` draw the reference's parameters bit for
  bit, float32 leaves exactly, bfloat16 leaves as the reference's cast;
  the shared experts' ``w_gate`` and ``w_up`` come from one key in both.
- ``moe_apply``: the routing (experts in rank order, the kept choices,
  their positions) equal to the reference's, on random inputs, on a
  forced tie (equal router columns: the lower expert index first) and on
  a forced capacity drop (every token's first choice one expert).  The
  port rounds where XLA's CPU code rounds (``models/moe.py``), but XLA's
  batched dot sums a 128-long contraction as two sequential halves of 64
  added at the end, torch's bfloat16 ``bmm`` in one sequential pass: the
  float32 sums part in their last bits and now and then flip a bfloat16
  rounding of an expert activation (measured 1 of 3072), which the down
  product spreads over its row.  So the output within ``LAYER_ULPS`` (one
  bfloat16 ulp of its largest magnitude) with at most ``LAYER_SHARE`` of
  the elements off the reference's bits (measured 10 of 2048).
  ``AUX_ULPS``: the load-balancing loss within 2 float32 ulps: the
  router's ``exp`` and sums are not XLA's bit for bit, which moves a mean
  probability by an ulp (measured 0 and 1 ulp).
- ``AUX_MODEL_RTOL``: a whole model's aux loss within 1e-3 of itself.
  An activation one bfloat16 ulp off the reference's (the tolerance
  below) moves its token's router logits by about an ulp, 2**-8 of
  themselves, so its probabilities by as much, and the mean over the
  B * S = 16 tokens by a sixteenth of that: 2.4e-4 a flip (measured
  1.5e-4).
- Whole models on the reference's ``PRNGKey(1)`` parameters (QKV biases
  redrawn nonzero): ``forward_lm``, 8 teacher-forced decode steps and
  ``prefill`` within ``tests/test_torch_lm.py``'s ``LOGIT_ULPS``
  (measured at most 1.25 ulps), and the reference's own decode parting
  from its prefill where the longer sequence drops choices.
- One ``make_train_step`` step and ``loss_and_grads`` of qwen2-moe-a2.7b
  within the tolerances of ``tests/_lm_train_cases.py`` (qwen3-moe-30b-a3b
  in ``tests/test_torch_lm_ckpt.py``); ``examples.train_lm`` 12
  steps straight against a run failing at step 9 and resumed from its
  step-8 checkpoint, bit for bit.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lm_train_cases as cases
from repro.configs.base import get_config as jget
from repro.launch import steps as jsteps
from repro.launch.steps import make_decode_step as jmake_decode_step
from repro.models import lm as JLM
from repro.models import moe as JMOE
from repro_torch.configs.base import get_config
from repro_torch.core import jaxrand
from repro_torch.examples import train_lm
from repro_torch.launch import crosscheck, steps
from repro_torch.models import lm as LM
from repro_torch.models import moe as MOE
from repro_torch.optim.optimizers import tree_leaves
from test_torch_lm import (LOGIT_ULPS, _jax_params, assert_layer_close,
                           assert_within_ulps)

ARCHS = ("qwen3-moe-30b-a3b", "qwen2-moe-a2.7b")
AUX_ULPS = 2
AUX_MODEL_RTOL = 1e-3
B, S = 2, 8


def _cfgs(arch):
    return get_config(arch).reduced(), jget(arch).reduced()


# ---------------------------------------------------------------------------
# the draw
# ---------------------------------------------------------------------------


def _check_draw(port_f32, port_bf16, want):
    assert len(tree_leaves(port_f32)) == len(want) == len(
        tree_leaves(port_bf16))
    for w, a, b in zip(want, tree_leaves(port_f32), tree_leaves(port_bf16)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(w))
        if b.dtype == torch.bfloat16:
            cast = np.asarray(w.astype(jnp.bfloat16).astype(jnp.float32))
            np.testing.assert_array_equal(b.float().numpy(), cast)
        else:                             # the norm scales stay float32
            np.testing.assert_array_equal(b.numpy(), np.asarray(w))


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_init_is_the_reference_draw(arch):
    cfg, jcfg = _cfgs(arch)
    want = JMOE.moe_init(jax.random.PRNGKey(3), jcfg.moe)
    key = lambda: jaxrand.PRNGKey(3, device="cpu")
    got = MOE.moe_init(key(), cfg.moe, "cpu", torch.float32)
    _check_draw(got, MOE.moe_init(key(), cfg.moe, "cpu"),
                jax.tree_util.tree_leaves(want))
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    assert got["w_gate"].shape == (e, d, f)
    assert got["w_down"].shape == (e, f, d)
    if cfg.moe.num_shared_experts:
        # the reference draws both from ks[4]: equal, kept so
        assert torch.equal(got["shared"]["w_gate"]["w"],
                           got["shared"]["w_up"]["w"])
        assert got["shared_gate"]["w"].shape == (d, 1)
    else:
        assert "shared" not in got


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_is_the_reference_draw(arch):
    cfg, jcfg = _cfgs(arch)
    want = jax.tree_util.tree_leaves(JLM.init_lm(jax.random.PRNGKey(0),
                                                 jcfg))
    key = lambda: jaxrand.PRNGKey(0, device="cpu")
    f32 = LM.init_lm(key(), cfg, device="cpu", dtype=torch.float32)
    _check_draw(f32, LM.init_lm(key(), cfg, device="cpu"), want)
    seg = f32["segments"][0]
    assert "mlp" not in seg
    assert seg["moe"]["w_up"].shape[:2] == (cfg.n_layers,
                                            cfg.moe.num_experts)
    # the layers are drawn one by one, not repeated
    assert not torch.equal(seg["moe"]["w_up"][0], seg["moe"]["w_up"][1])
    meta = LM.init_lm(key(), cfg, device="meta")
    assert [a.shape for a in tree_leaves(meta)] == [a.shape for a in
                                                    tree_leaves(f32)]


# ---------------------------------------------------------------------------
# one MoE layer: routing, capacity, the output, the aux loss
# ---------------------------------------------------------------------------


def _ref_routing(p, mcfg, x):
    """The reference's routing lines (``models/moe.py``, ``moe_apply``):
    experts in rank order, the kept choices and their positions."""
    b, s, _ = x.shape
    e, k = mcfg.num_experts, mcfg.top_k
    probs = jax.nn.softmax(JMOE.dense(p["router"], x).astype(jnp.float32),
                           axis=-1)
    _, expert_idx = jax.lax.top_k(probs, k)
    cap = int(mcfg.capacity_factor * s * k / e) + 1
    fe = expert_idx.reshape(b, s * k)
    onehot = jax.nn.one_hot(fe, e, dtype=jnp.int32)
    pos = jnp.sum((jnp.cumsum(onehot, axis=1) - 1) * onehot, axis=-1)
    return expert_idx, pos < cap, pos


_JITTED = {}


def _reference(arch):
    """The reference's ``moe_apply`` and routing, jitted once per arch."""
    if arch not in _JITTED:
        mcfg = _cfgs(arch)[1].moe
        _JITTED[arch] = (jax.jit(lambda p, x: JMOE.moe_apply(p, mcfg, x)),
                         jax.jit(lambda p, x: _ref_routing(p, mcfg, x)))
    return _JITTED[arch]


def _layer(arch, seed=3):
    """A reduced arch's MoE layer drawn in the reference (float32 numpy
    leaves) and carried into the port (bfloat16, as served)."""
    cfg, jcfg = _cfgs(arch)
    jp = jax.tree_util.tree_map(np.array, JMOE.moe_init(
        jax.random.PRNGKey(seed), jcfg.moe))
    return cfg.moe, jp


def _port(jp):
    return jax.tree_util.tree_map(lambda a: torch.tensor(a).bfloat16(), jp)


def _run(arch, jp, x):
    """The layer on ``x`` (float32 numpy, (B, S, D)) in both packages:
    the port's (out, aux, routing) and the reference's."""
    mcfg = _cfgs(arch)[0].moe
    jrun, jroute = _reference(arch)
    xb = jnp.asarray(x, jnp.bfloat16)
    jout, jaux = jrun(jp, xb)
    with MOE.record_routes() as routes:
        out, aux = MOE.moe_apply(_port(jp), mcfg, torch.tensor(x).bfloat16())
    (route,) = routes
    return (out, aux, route), (jout, jaux, jroute(jp, xb))


def _check_layer(got, want):
    (out, aux, route), (jout, jaux, (jidx, jkeep, jpos)) = got, want
    np.testing.assert_array_equal(route["expert_idx"].numpy(),
                                  np.asarray(jidx))
    np.testing.assert_array_equal(route["keep"].numpy(), np.asarray(jkeep))
    assert out.dtype == torch.bfloat16
    assert_layer_close(out, jout)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=0,
                               atol=AUX_ULPS * np.spacing(np.float32(jaux)))
    return route


def _x(seed, positive=False):
    x = np.random.default_rng(seed).standard_normal((B, S, 128))
    return (np.abs(x) if positive else x).astype(np.float32)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_against_the_reference(arch):
    mcfg, jp = _layer(arch)
    for seed in (0, 1):
        got, want = _run(arch, jp, _x(seed))
        _check_layer(got, want)
    # the positions: token-major, rank-minor running counts per row
    idx = got[2]["expert_idx"].reshape(B, S * mcfg.top_k)
    for b in range(B):
        seen = {}
        for j, e in enumerate(idx[b].tolist()):
            assert int(want[2][2][b, j]) == seen.get(e, 0)
            seen[e] = seen.get(e, 0) + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_aux_loss_against_the_reference(arch):
    """``e * sum(me * ce) * router_aux_weight``, float32, on three inputs;
    and ``aux=False`` returns zero with the same output."""
    mcfg, jp = _layer(arch, seed=5)
    for seed in (2, 3, 4):
        (out, aux, _), (_, jaux, _) = _run(arch, jp, _x(seed))
        assert aux.dtype == torch.float32
        assert abs(float(aux) - float(jaux)) <= AUX_ULPS * np.spacing(
            np.float32(jaux))
    no_aux, zero = MOE.moe_apply(_port(jp), mcfg,
                                 torch.tensor(_x(4)).bfloat16(), aux=False)
    assert float(zero) == 0.0 and torch.equal(no_aux, out)


@pytest.mark.parametrize("arch", ARCHS)
def test_forced_tie_routes_to_the_lower_index(arch):
    """Router columns 1 and 3 equal (so their probabilities tie on every
    token), then all four equal: the lower index ranks first, as
    ``jax.lax.top_k`` ranks it."""
    mcfg, jp = _layer(arch)
    router = jp["router"]["w"]
    router[:, 3] = router[:, 1]
    got, want = _run(arch, jp, _x(6))
    route = _check_layer(got, want)
    idx = route["expert_idx"].reshape(-1, mcfg.top_k).tolist()
    both = [r for r in idx if 1 in r and 3 in r]
    assert both and all(r.index(1) < r.index(3) for r in both)
    router[:] = router[:, :1]
    got, want = _run(arch, jp, _x(7))
    route = _check_layer(got, want)
    assert (route["expert_idx"] == torch.arange(mcfg.top_k)).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_forced_capacity_drop(arch):
    """Positive inputs and a router column of 1s: every token's first
    choice is expert 2, so past ``capacity`` slots of a row its choices
    drop, on both sides alike.  The other logits trail by about 100, so
    their probabilities underflow: flushed to zero, they tie, and the
    second choice is expert 0 everywhere."""
    mcfg, jp = _layer(arch)
    jp["router"]["w"][:, 2] = 1.0
    got, want = _run(arch, jp, _x(8, positive=True))
    route = _check_layer(got, want)
    cap = MOE.capacity(mcfg, S)
    assert cap < S
    assert (route["expert_idx"] == torch.tensor([2, 0])).all()
    keep = route["keep"].reshape(B, S, mcfg.top_k)
    assert keep[:, :cap, 0].all() and not keep[:, cap:, 0].any()


def test_route_forks_and_record_routes():
    """``crosscheck.route_forks``: a swap at a tie is a fork, a swap past
    ``ROUTE_ULPS`` raises; ``record_routes`` keeps one entry per
    ``moe_apply`` call, an inner recording apart from the outer one."""
    logits = torch.tensor([[[1.0, 0.5, 0.5, -1.0]]])
    want = [{"logits": logits, "expert_idx": torch.tensor([[[0, 1]]])}]
    tie = [{"logits": logits, "expert_idx": torch.tensor([[[0, 2]]])}]
    far = [{"logits": logits, "expert_idx": torch.tensor([[[1, 0]]])}]
    assert crosscheck.route_forks(want, want) == []
    (fork,) = crosscheck.route_forks(tie, want)
    assert fork["rank"] == 1 and fork["gap_ulps"] == 0.0
    with pytest.raises(AssertionError, match="logit gap"):
        crosscheck.route_forks(far, want)
    mcfg, jp = _layer(ARCHS[0])
    p, x = _port(jp), torch.tensor(_x(9)).bfloat16()
    with MOE.record_routes() as outer:
        MOE.moe_apply(p, mcfg, x)
        (_, _), inner = crosscheck.routed(lambda: MOE.moe_apply(p, mcfg, x))
    assert len(outer) == 1 and len(inner) == 1
    assert crosscheck.route_forks(inner, outer) == []
    assert outer[0]["expert_idx"].shape == (B, S, mcfg.top_k)
    assert outer[0]["keep"].shape == (B, S * mcfg.top_k)


# ---------------------------------------------------------------------------
# whole models: forward, decode, prefill
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """One reduced MoE config: the reference's parameters in both
    packages, tokens, and the reference's forward, 8 teacher-forced
    decode steps and prefill."""
    arch = request.param
    cfg, jcfg = _cfgs(arch)
    tree = _jax_params(jcfg)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tokens = np.random.default_rng(1).integers(
        2, cfg.vocab_size, (B, S)).astype(np.int32)
    ref = {"forward": jax.jit(lambda p, t: JLM.forward_lm(
        p, jcfg, t, train=False))(jp, tokens)}
    dstep = jax.jit(jmake_decode_step(jcfg))
    cache = JLM.init_cache(jcfg, B, S)
    ref["decode"] = []
    for t in range(S):
        logits, cache = dstep(jp, cache, {"tokens": tokens[:, t:t + 1],
                                          "index": jnp.int32(t)})
        ref["decode"].append((logits, cache))
    ref["prefill"] = jax.jit(lambda p, t: JLM.prefill(p, jcfg, t))(
        jp, tokens)
    return dict(arch=arch, cfg=cfg, tokens=tokens, ref=ref,
                params=LM.params_from_numpy(tree, cfg, device="cpu"))


def test_forward_against_the_reference(model):
    cfg = model["cfg"]
    logits, aux = LM.forward_lm(model["params"], cfg, model["tokens"],
                                train=False)
    jlogits, jaux = model["ref"]["forward"]
    assert logits.shape == (B, S, cfg.vocab_padded)
    assert_within_ulps(logits, jlogits)
    # two layers' aux losses summed in layer order
    assert 0.0 < float(aux)
    assert abs(float(aux) - float(jaux)) <= AUX_MODEL_RTOL * float(jaux)


def test_decode_steps_against_the_reference(model):
    cfg, params, tokens = model["cfg"], model["params"], model["tokens"]
    decode = steps.make_decode_step(cfg)
    caches = LM.init_cache(cfg, B, S, device="cpu")
    for t, (jlogits, jcaches) in enumerate(model["ref"]["decode"]):
        logits, caches = decode(params, caches,
                                {"tokens": tokens[:, t:t + 1], "index": t})
        assert_within_ulps(logits, jlogits)
        for c, r in zip(caches, jcaches):
            assert_within_ulps(c["k"], r["k"])
            assert_within_ulps(c["v"], r["v"])


def test_prefill_against_the_reference(model):
    cfg = model["cfg"]
    logits, caches = steps.make_prefill_step(cfg)(
        model["params"], {"tokens": model["tokens"]})
    jlogits, jcaches = model["ref"]["prefill"]
    assert logits.shape == (B, 1, cfg.vocab_padded)
    assert_within_ulps(logits, jlogits)
    for c, r in zip(caches, jcaches):
        for k in ("k", "v"):
            assert c[k].shape == r[k].shape
            assert_within_ulps(c[k], r[k])


def test_reference_decode_parts_from_its_prefill_where_choices_drop(model):
    """Capacity depends on the sequence routed: the prefill of S = 8
    drops choices (counted on the port's routing, the reference's), a
    decode step of S = 1 drops none, so the reference's teacher-forced
    decode is not its prefill; the port's two part the same way."""
    cfg, params, tokens = model["cfg"], model["params"], model["tokens"]
    with MOE.record_routes() as routes:
        last, _ = LM.prefill(params, cfg, tokens)
    dropped = sum(int((~r["keep"]).sum()) for r in routes)
    assert dropped > 0
    jdecode_last = model["ref"]["decode"][-1][0]
    jprefill_last = model["ref"]["prefill"][0]
    gap = crosscheck.ulps_apart(torch.tensor(np.asarray(
        jdecode_last.astype(jnp.float32))), torch.tensor(np.asarray(
            jprefill_last.astype(jnp.float32))))
    assert gap > 10 * LOGIT_ULPS
    caches = LM.init_cache(cfg, B, S, device="cpu")
    with MOE.record_routes() as routes:
        for t in range(S):
            logits, caches = LM.decode_step(params, cfg, tokens[:, t:t + 1],
                                            caches, t)
    assert all(bool(r["keep"].all()) for r in routes)
    assert crosscheck.ulps_apart(logits, last) > 10 * LOGIT_ULPS


# ---------------------------------------------------------------------------
# training, the spec helpers and the example
# ---------------------------------------------------------------------------


def test_train_step_against_the_reference():
    """qwen2-moe-a2.7b: the shared experts and their gate, QKV biases
    (qwen3-moe-30b-a3b's step is in ``tests/test_torch_lm_ckpt.py``,
    whose worker has the room)."""
    c = cases.case("qwen2-moe-a2.7b")
    ref = cases.ref_step(c)
    cfg = c["cfg"]
    opt = steps.make_optimizer(cfg)
    got = steps.make_train_step(cfg, opt)(c["params"],
                                          opt.init(c["params"]), c["batch"])
    _, grads = steps.loss_and_grads(cfg, c["params"], c["batch"])
    # the total carries the aux loss of both layers
    assert float(got[2]["total"]) > float(got[2]["loss"])
    cases.check_step(c, ref, got, grads)


def _sd(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_helpers_against_the_reference(arch):
    """``abstract_params`` and ``abstract_opt_state`` at full width: meta
    tensors of the reference's shapes (float32)."""
    cfg, jcfg = get_config(arch), jget(arch)
    got = tree_leaves(steps.abstract_params(cfg))
    want = jax.tree_util.tree_leaves(jsteps.abstract_params(jcfg))
    assert [_sd(v) for v in got] == [(tuple(v.shape), str(v.dtype))
                                     for v in want]
    assert all(v.device.type == "meta" for v in got)
    mu = tree_leaves(steps.abstract_opt_state(cfg).mu)
    assert [_sd(v) for v in mu] == [_sd(v) for v in got]


def test_train_lm_example_fails_and_resumes(tmp_path, capsys):
    """``examples.train_lm`` (qwen3-moe-30b-a3b, batch 8, seq 64) for 12
    steps straight, against a run that fails at step 9 and resumes from
    its step-8 checkpoint: the same final metrics and parameters, bit for
    bit."""
    kw = ["--steps", "12", "--ckpt-every", "4", "--device", "cpu"]
    straight_p, straight = train_lm.main(
        kw + ["--ckpt-dir", str(tmp_path / "a")])
    with pytest.raises(RuntimeError, match="simulated node failure"):
        train_lm.main(kw + ["--ckpt-dir", str(tmp_path / "b"),
                            "--fail-at", "9"])
    resumed_p, resumed = train_lm.main(
        kw + ["--ckpt-dir", str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert "resumed from step 8" in out
    assert "[train_lm] qwen3-moe-30b-a3b final" in out
    assert resumed == straight
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(resumed_p),
                                                 tree_leaves(straight_p)))
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    assert 0.5 * np.log(cfg.vocab_size) < straight["loss"] < 2.5 * np.log(
        cfg.vocab_size)
