"""Shared whole-model cases of the recurrent LM families
(``test_torch_mamba2.py``: zamba2-1.2b; ``test_torch_xlstm.py``:
xlstm-125m), on the reduced configs, the port against the JAX package on
the CPU.

- ``init_lm(PRNGKey(0))``: every leaf the reference's draw bit for bit
  (float32 leaves exactly, bfloat16 leaves as the reference's cast), with
  the reference's tree structure.
- ``forward_lm``, 8 teacher-forced decode steps (logits and every cache
  leaf) and ``prefill``'s last logits on the reference's ``PRNGKey(1)``
  parameters, within ``tests/test_torch_lm.py``'s whole-model rule
  (``LOGIT_ULPS``: 2 bfloat16 ulps of the reference tensor's largest
  magnitude).  ``prefill``'s caches are the reference's fresh state,
  equal leaf for leaf, dtypes and shapes too.
- ``Server`` on ``main()``'s traffic with no parameters carried in: the
  reference's greedy tokens, or a fork only where the reference's own
  top-2 margin is within ``LOGIT_ULPS``.
- One ``make_train_step`` step and ``loss_and_grads`` against the
  reference's jitted step and ``jax.grad``, within the tolerances of
  ``tests/_lm_train_cases.py`` or those the caller states.

One module-scoped set of reference runs per arch (``reference``): the
jitted forward, decode step and prefill compile once each.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import _lm_train_cases as cases
from repro.configs.base import get_config as jget
from repro.launch import serve as jserve
from repro.launch.steps import make_decode_step as jmake_decode_step
from repro.models import lm as JLM
from repro_torch.configs.base import get_config
from repro_torch.core import jaxrand
from repro_torch.launch import serve, steps
from repro_torch.models import lm as LM
from repro_torch.optim.optimizers import tree_leaves
from test_torch_lm import LOGIT_ULPS, _f32, assert_within_ulps

B, S = 2, 8


def check_draw(arch: str) -> None:
    """``init_lm(PRNGKey(0))`` against the reference's, every leaf."""
    cfg, jcfg = get_config(arch).reduced(), jget(arch).reduced()
    ref = JLM.init_lm(jax.random.PRNGKey(0), jcfg)
    want = jax.tree_util.tree_leaves(ref)
    key = lambda: jaxrand.PRNGKey(0, device="cpu")     # noqa: E731
    f32 = LM.init_lm(key(), cfg, device="cpu", dtype=torch.float32)
    bf16 = LM.init_lm(key(), cfg, device="cpu")
    assert len(tree_leaves(f32)) == len(want) == len(tree_leaves(bf16))
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(ref)[0]]
    for path, w, a, b in zip(paths, want, tree_leaves(f32),
                             tree_leaves(bf16)):
        assert a.dtype == torch.float32 and a.shape == w.shape, path
        np.testing.assert_array_equal(a.numpy(), np.asarray(w), path)
        if b.dtype == torch.bfloat16:
            cast = np.asarray(w.astype(jnp.bfloat16).astype(jnp.float32))
            np.testing.assert_array_equal(b.float().numpy(), cast, path)
        else:                       # the leaves used in float32 stay so
            assert path.endswith(tuple(f"['{k}']" for k in
                                       LM.FLOAT32_LEAVES)), path
            np.testing.assert_array_equal(b.numpy(), np.asarray(w), path)


def reference(arch: str) -> dict:
    """The reduced ``arch`` in both packages on the reference's
    ``PRNGKey(1)`` parameters, tokens from ``default_rng(1)``, and the
    reference's forward, 8 teacher-forced decode steps and prefill."""
    cfg, jcfg = get_config(arch).reduced(), jget(arch).reduced()
    tree = jax.tree_util.tree_map(np.asarray,
                                  JLM.init_lm(jax.random.PRNGKey(1), jcfg))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tokens = np.random.default_rng(1).integers(
        2, cfg.vocab_size, (B, S)).astype(np.int32)
    ref = {"forward": jax.jit(lambda p, t: JLM.forward_lm(
        p, jcfg, t, train=False)[0])(jp, tokens)}
    dstep = jax.jit(jmake_decode_step(jcfg))
    cache = JLM.init_cache(jcfg, B, S)
    ref["cache0"] = cache
    ref["decode"] = []
    for t in range(S):
        logits, cache = dstep(jp, cache, {"tokens": tokens[:, t:t + 1],
                                          "index": jnp.int32(t)})
        ref["decode"].append((logits, cache))
    ref["prefill"] = jax.jit(lambda p, t: JLM.prefill(p, jcfg, t))(
        jp, tokens)
    return dict(arch=arch, cfg=cfg, tokens=tokens, ref=ref,
                params=LM.params_from_numpy(tree, cfg, device="cpu"))


def _same_tree(got, want) -> None:
    """Leaf for leaf equal: shapes, dtypes and values."""
    g, w = LM.leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).replace("torch.", "") == str(b.dtype)
        np.testing.assert_array_equal(_f32(a), _f32(b))


def check_init_cache(m: dict) -> None:
    _same_tree(LM.init_cache(m["cfg"], B, S, device="cpu"),
               m["ref"]["cache0"])


def check_forward(m: dict) -> None:
    cfg = m["cfg"]
    logits, aux = LM.forward_lm(m["params"], cfg, m["tokens"], train=False)
    assert logits.shape == (B, S, cfg.vocab_padded)
    assert logits.dtype == torch.bfloat16 and float(aux) == 0.0
    assert_within_ulps(logits, m["ref"]["forward"])


def check_decode(m: dict) -> None:
    """8 teacher-forced steps: each step's logits and every cache leaf
    within ``LOGIT_ULPS`` of the reference tensor's largest magnitude
    (the conv windows, K/V and recurrent states alike), and the given
    caches left as they were."""
    cfg, params, tokens = m["cfg"], m["params"], m["tokens"]
    decode = steps.make_decode_step(cfg)
    caches = LM.init_cache(cfg, B, S, device="cpu")
    for t, (jlogits, jcaches) in enumerate(m["ref"]["decode"]):
        before = [a.clone() for a in LM.leaves(caches)]
        given = caches
        logits, caches = decode(params, caches,
                                {"tokens": tokens[:, t:t + 1], "index": t})
        assert all(torch.equal(a, b) for a, b in zip(LM.leaves(given),
                                                     before))
        assert logits.shape == (B, 1, cfg.vocab_padded)
        assert_within_ulps(logits, jlogits)
        g, w = LM.leaves(caches), jax.tree_util.tree_leaves(jcaches)
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert tuple(a.shape) == tuple(b.shape)
            assert_within_ulps(a, b)


def check_prefill(m: dict) -> None:
    """Last-position logits within ``LOGIT_ULPS``; the caches the
    reference's fresh state, leaf for leaf (its float32 conv windows
    too)."""
    cfg = m["cfg"]
    logits, caches = steps.make_prefill_step(cfg)(
        m["params"], {"tokens": m["tokens"]})
    jlogits, jcaches = m["ref"]["prefill"]
    assert logits.shape == (B, 1, cfg.vocab_padded)
    assert_within_ulps(logits, jlogits)
    _same_tree(caches, jcaches)


def check_decode_against_forward(m: dict) -> None:
    """The port's own oracle: its teacher-forced decode gives its full
    forward's logits, within the same ``LOGIT_ULPS``."""
    cfg, params, tokens = m["cfg"], m["params"], m["tokens"]
    full, _ = LM.forward_lm(params, cfg, tokens, train=False)
    caches = LM.init_cache(cfg, B, S, device="cpu")
    outs = []
    for t in range(S):
        logits, caches = LM.decode_step(params, cfg, tokens[:, t:t + 1],
                                        caches, t)
        outs.append(logits[:, 0])
    assert_within_ulps(torch.stack(outs, dim=1), full)


def check_server(arch: str) -> list:
    """``Server(arch, seed=0)`` against the reference's on ``main()``'s
    traffic, nothing carried in; returns the forks, each with the
    reference's top-2 margin in ulps."""
    jsrv = jserve.Server(arch, reduced=True, seed=0)
    rows = []
    decode = jsrv.decode

    def recording(params, caches, batch):
        out, caches = decode(params, caches, batch)
        rows.append(np.asarray(out[0, -1].astype(jnp.float32)))
        return out, caches
    jsrv.decode = recording
    srv = serve.Server(arch, reduced=True, seed=0, device="cpu")
    prompts = serve.prompts_for(srv.cfg, 4)
    want = jsrv.submit_and_run(prompts, max_new=8)
    got = srv.submit_and_run(prompts, max_new=8)
    assert [len(o) for o in got] == [8] * 4
    forks, step = [], 0
    for r, (g, w, prompt) in enumerate(zip(got, want, prompts)):
        step += len(prompt) - 1
        for j, (a, b) in enumerate(zip(g, w)):
            if a != b:
                row = rows[step + j][:srv.cfg.vocab_size]
                top2 = np.sort(row)[-2:]
                ulp = 2.0 ** (np.floor(np.log2(np.abs(row).max())) - 7)
                margin = float(top2[1] - top2[0]) / ulp
                assert margin <= LOGIT_ULPS, (r, j, a, b, margin)
                forks.append((r, j, margin))
                break
        step += len(w)
    return forks


def check_train_step(arch: str, **tolerances) -> dict:
    """One ``make_train_step`` step and ``loss_and_grads``' gradients
    against the reference's (``_lm_train_cases.check_step``)."""
    c = cases.case(arch)
    ref = cases.ref_step(c)
    cfg = c["cfg"]
    opt = steps.make_optimizer(cfg)
    got = steps.make_train_step(cfg, opt)(c["params"],
                                          opt.init(c["params"]), c["batch"])
    _, grads = steps.loss_and_grads(cfg, c["params"], c["batch"])
    loss = float(got[2]["loss"])
    assert 0.5 * np.log(cfg.vocab_size) < loss < 2.5 * np.log(
        cfg.vocab_size)
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in tree_leaves(grads))
    return cases.check_step(c, ref, got, grads, **tolerances)
