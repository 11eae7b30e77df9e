"""Shared cases of the LM training tests (``test_torch_lm_train.py``,
``test_torch_lm_ckpt.py``): one train step of a reduced dense or VLM
config in the port and in the JAX package, from the same ``PRNGKey(0)``
parameters (the port draws them itself, bit for bit the reference's) and
the same batch (``tests/test_lm_archs.py``'s: B = 2, S = 32, the labels
the tokens, the VLM's frames ones), and the tolerances that hold the two
together, each with its cause.  The encoder-decoder's frames are seeded
normals, not test_lm_archs's ones: with every frame the same, the
encoder's attention is uniform whatever its logits, so the gradients of
its ``wq`` and ``wk`` are zero in exact arithmetic and both packages
return rounding noise there (measured on the ones: 55% of those
gradients' signs differ, 92.6% of the parameters bit-equal after the
step).

- ``LOSS_RTOL``: the loss and the total.  The logits differ from the
  reference's by one bfloat16 ulp in ~14% of the elements on the reduced
  qwen2.5-14b (XLA's CPU ``rsqrt`` estimate and sum order in the norms, its
  jitted RoPE ``sin`` / ``cos``; ``tests/test_torch_lm.py``), which moves
  the mean cross-entropy by up to 6.7e-5 of itself (measured: qwen2.5-14b,
  internlm2-20b and mistral-large-123b, whose reduced configs are the same
  net; 3e-6 starcoder2-15b, 1e-5 internvl2-2b).
- ``GRAD_SHARE``: each gradient leaf within this share of its largest
  magnitude.  Those logit flips travel back through the backward's
  bfloat16 cotangents, which XLA and autograd round at other places (the
  attention scale, the residual sums).  Measured at most 2.47e-2
  (qwen2.5-14b's ``wv`` bias), 1.0e-2 elsewhere; the reference's own
  jitted and op-by-op gradients of the same loss differ by up to 3.19e-2
  on the same inputs.
- The new parameters: Adam's first step is ``lr * m / (sqrt(v) + eps)``
  with m and sqrt(v) both |g|-sized, so about ``-lr * sign(g)``; a
  gradient whose sign differs moves its parameter by ``2 lr`` the other
  way.  So every element within ``2 lr`` plus two float32 spacings of
  itself (each side's rounding), and at least ``PARAMS_EQUAL`` of them
  bit-equal (measured 99.46-99.67%).
- ``mu`` (``0.1 g``) within ``GRAD_SHARE`` of its largest magnitude,
  ``nu`` (``0.001 g**2``) within ``2 * GRAD_SHARE`` (a relative error
  doubles in a square).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as jget
from repro.launch import steps as jsteps
from repro.models import encdec as JED
from repro.models import lm as JLM
from repro_torch.configs.base import get_config
from repro_torch.core import jaxrand
from repro_torch.launch import steps
from repro_torch.optim.optimizers import tree_leaves

B, S = 2, 32
LOSS_RTOL = 2e-4
GRAD_SHARE = 3e-2
PARAMS_EQUAL = 0.99


def batch(cfg) -> dict:
    """test_lm_archs's batch for ``cfg``, the port's form."""
    tokens = torch.tensor(np.random.default_rng(0).integers(
        2, cfg.vocab_size, (B, S)))
    out = {"tokens": tokens, "labels": tokens}
    if cfg.family == "vlm":
        out["frames"] = torch.ones((B, cfg.frontend_len, cfg.d_model),
                                   dtype=torch.bfloat16)
    if cfg.family == "encdec":
        out["frames"] = torch.tensor(np.random.default_rng(1).standard_normal(
            (B, cfg.frontend_len, cfg.d_model))).bfloat16()
    return out


def case(arch: str, jparams=None) -> dict:
    """The reduced config of ``arch`` in both packages, the reference's
    ``PRNGKey(0)`` parameters (``jparams`` when the caller drew them
    already) and the port's own draw of them (float32), and
    test_lm_archs's batch in both forms."""
    cfg, jcfg = get_config(arch).reduced(), jget(arch).reduced()
    if jparams is None:
        jparams = jsteps.init_params_for(jcfg, jax.random.PRNGKey(0))
    port = batch(cfg)
    jbatch = {k: jnp.asarray(v.float().numpy() if k == "frames"
                             else v.numpy(),
                             jnp.bfloat16 if k == "frames" else jnp.int32)
              for k, v in port.items()}
    return dict(arch=arch, cfg=cfg, jcfg=jcfg,
                jparams=jparams,
                params=steps.init_params_for(
                    cfg, jaxrand.PRNGKey(0, device="cpu"), device="cpu",
                    dtype=torch.float32),
                jbatch=jbatch, batch=port)


def _ref_loss(jcfg, params, batch):
    """The reference train step's ``loss_fn`` (``launch/steps.py:85``),
    its total."""
    if jcfg.family == "encdec":
        logits = JED.forward_encdec(params, jcfg, batch["frames"],
                                    batch["tokens"])
        return JLM.lm_loss(logits, batch["labels"], jcfg.vocab_size)
    prefix = batch.get("frames") if jcfg.family == "vlm" else None
    logits, aux = JLM.forward_lm(params, jcfg, batch["tokens"],
                                 prefix_embeds=prefix)
    offset = prefix.shape[1] if prefix is not None else 0
    return JLM.lm_loss(logits, batch["labels"], jcfg.vocab_size,
                       label_offset=offset) + aux


def ref_step(c: dict):
    """The reference's jitted train step from its fresh optimizer state,
    and ``jax.grad`` of its loss, in one compile: ((params, opt_state,
    metrics), grads) as numpy trees."""
    jcfg = c["jcfg"]
    opt = jsteps.make_optimizer(jcfg)
    step = jsteps.make_train_step(jcfg, optimizer=opt)

    def both(p, b):
        return step(p, opt.init(p), b), jax.grad(
            lambda q: _ref_loss(jcfg, q, b))(p)
    out = jax.jit(both)(c["jparams"], c["jbatch"])
    return jax.tree_util.tree_map(np.asarray, out)


def _leaves(tree):
    """The leaves of a port's or a reference's (numpy) tree, in the
    order both flatten them, as numpy arrays."""
    return [t.detach().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t) for t in tree_leaves(tree)]


def within_share(got, want, share: float, what: str) -> float:
    """Every leaf of ``got`` within ``share`` of the largest magnitude of
    its ``want`` leaf; returns the largest share seen."""
    worst = 0.0
    g_l, w_l = _leaves(got), _leaves(want)
    assert len(g_l) == len(w_l), what
    for i, (g, w) in enumerate(zip(g_l, w_l)):
        w = np.asarray(w, np.float32)
        gap = float(np.abs(np.asarray(g, np.float32) - w).max())
        top = float(np.abs(w).max())
        assert gap <= share * top, (what, i, gap, top)
        worst = max(worst, gap / top if top else 0.0)
    return worst


def check_step(c: dict, ref, got, grads=None, loss_rtol=LOSS_RTOL,
               grad_share=GRAD_SHARE) -> dict:
    """The port's step ``got`` = (params, opt_state, metrics) against the
    reference's ``ref`` (``ref_step``); ``grads``, when given, the port's
    ``loss_and_grads`` gradients against ``jax.grad``'s.  ``loss_rtol``
    and ``grad_share`` default to the tolerances above; a family whose
    own numbers need others states them where it passes them."""
    (jp2, jo2, jm), jg = ref
    p2, o2, m = got
    for k in ("loss", "total"):
        assert abs(float(m[k]) - float(jm[k])) <= loss_rtol * abs(
            float(jm[k])), (c["arch"], k, float(m[k]), float(jm[k]))
    lr = float(steps.make_optimizer(c["cfg"]).schedule(1))
    equal = total = 0
    for g, w in zip(_leaves(p2), _leaves(jp2)):
        w = np.asarray(w)
        allowed = 2 * lr + 2 * np.spacing(np.abs(w))
        assert (np.abs(g - w) <= allowed).all(), c["arch"]
        equal += int((g == w).sum())
        total += w.size
    assert equal >= PARAMS_EQUAL * total, (c["arch"], equal / total)
    assert o2.step == int(jo2.step) == 1
    out = {"params_equal": equal / total,
           "mu": within_share(o2.mu, jo2.mu, grad_share, "mu"),
           "nu": within_share(o2.nu, jo2.nu, 2 * grad_share, "nu")}
    if grads is not None:
        out["grads"] = within_share(grads, jg, grad_share, "grads")
    return out
