"""Train / prefill / decode step builders of the LM stack and the shape
specs of every (architecture x shape) cell: the JAX package's
``launch/steps.py``.  Used by the trainer (``launch/train.py``) and the
server (``launch/serve.py``).  The ``encdec`` family (seamless-m4t-medium)
takes its own branch of each builder: ``models/encdec.py``'s forward,
prefill (which also returns the encoder's memory) and decode step (which
takes the memory in its batch).

The reference's ``ShapeDtypeStruct`` stand-ins are tensors on the meta
device here: shapes and dtypes, nothing allocated.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import SHAPES, ArchConfig
from repro_torch.core import jaxrand
from repro_torch.kernels import resolve_device
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.models import lm as LM
from repro_torch.optim import adam, cosine_schedule
from repro_torch.optim.optimizers import tree_leaves, tree_unflatten

COMPUTE = torch.bfloat16


# ---------------------------------------------------------------------------
# Input specs (meta-device stand-ins: no allocation)
# ---------------------------------------------------------------------------


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape_name: str) -> Dict[str, Any]:
    """Model inputs for one shape cell, as meta tensors."""
    sh = SHAPES[shape_name]
    b, s, kind = sh["global_batch"], sh["seq_len"], sh["kind"]
    frames = (b, cfg.frontend_len, cfg.d_model)
    if cfg.family == "encdec":
        if kind == "train":
            return {"frames": _spec(frames, COMPUTE),
                    "tokens": _spec((b, s), torch.int32),
                    "labels": _spec((b, s), torch.int32)}
        if kind == "prefill":
            return {"frames": _spec(frames, COMPUTE),
                    "tokens": _spec((b, s), torch.int32)}
        # decode: one token against a full self-attn cache + encoder memory
        return {"tokens": _spec((b, 1), torch.int32),
                "memory": _spec(frames, COMPUTE),
                "index": _spec((), torch.int32)}
    if kind == "train":
        spec = {"tokens": _spec((b, s), torch.int32),
                "labels": _spec((b, s), torch.int32)}
        if cfg.family == "vlm":
            spec = {"frames": _spec(frames, COMPUTE), **spec}
        return spec
    if kind == "prefill":
        spec = {"tokens": _spec((b, s), torch.int32)}
        if cfg.family == "vlm":
            spec["frames"] = _spec(frames, COMPUTE)
        return spec
    # decode
    return {"tokens": _spec((b, 1), torch.int32),
            "index": _spec((), torch.int32)}


def cache_specs(cfg: ArchConfig, shape_name: str):
    """Meta tensors of the decode cache for this cell."""
    sh = SHAPES[shape_name]
    if cfg.family == "encdec":
        return ED.init_dec_cache(cfg, sh["global_batch"], sh["seq_len"],
                                 device="meta")
    return LM.init_cache(cfg, sh["global_batch"], sh["seq_len"],
                         device="meta")


# ---------------------------------------------------------------------------
# Step builders
# ---------------------------------------------------------------------------


def make_optimizer(cfg: ArchConfig, lr: float = 3e-4, steps: int = 10_000):
    return adam(cosine_schedule(lr, steps, warmup_steps=200))


def loss_and_grads(cfg: ArchConfig, params, batch):
    """``jax.value_and_grad(loss_fn, has_aux=True)(params)`` of the
    reference's train step: ((total, loss), grads), ``total`` the loss plus
    the aux loss, the loss skipping the VLM family's prefix positions.
    ``batch`` holds "tokens" and "labels" (B, S) and, for the VLM and
    encdec families, "frames" (B, P, D): the VLM's prefix, the encoder's
    input (``encdec.forward_encdec``; no aux loss, so the total is the
    loss).  The parameters are float32 leaves, cast to bfloat16 at each
    use, so autograd's gradients are float32, as the reference's are; the
    forward and the backward both run inside
    ``layers.float32_accumulation``."""
    flat = [a.detach().requires_grad_() for a in tree_leaves(params)]
    with L.float32_accumulation(), torch.enable_grad():
        p = tree_unflatten(params, flat)
        if cfg.family == "encdec":
            logits = ED.forward_encdec(p, cfg, batch["frames"],
                                       batch["tokens"])
            loss = LM.lm_loss(logits, batch["labels"], cfg.vocab_size)
            total = loss
        else:
            prefix = batch.get("frames") if cfg.family == "vlm" else None
            logits, aux = LM.forward_lm(p, cfg, batch["tokens"],
                                        prefix_embeds=prefix)
            loss = LM.lm_loss(logits, batch["labels"], cfg.vocab_size,
                              label_offset=0 if prefix is None
                              else prefix.shape[1])
            total = loss + aux
        del logits
        grads = torch.autograd.grad(total, flat)
    return ((total.detach(), loss.detach()),
            tree_unflatten(params, list(grads)))


def make_train_step(cfg: ArchConfig, optimizer=None, *, policy=None):
    """``train_step(params, opt_state, batch)`` -> (params, opt_state,
    {"loss", "total"}): ``loss_and_grads``, then the optimizer's update
    (``make_optimizer``'s Adam by default).  With ``policy`` (a
    ``MeshPolicy`` over a live mesh) the step is ``sharded``'s: parameters
    and moments as ``DTensor``s, the batch split over the batch axes."""
    optimizer = optimizer or make_optimizer(cfg)
    if policy is not None:
        from repro_torch.launch import sharded
        return sharded.make_train_step(cfg, policy, optimizer)

    def train_step(params, opt_state, batch):
        (total, loss), grads = loss_and_grads(cfg, params, batch)
        new_params, new_opt = optimizer.update(grads, opt_state, params)
        return new_params, new_opt, {"loss": loss, "total": total}
    return train_step


def make_prefill_step(cfg: ArchConfig, *, policy=None):
    """``prefill_step(params, batch)`` -> (last logits, caches); ``batch``
    holds "tokens" (B, S) and, for the VLM family, "frames" (B, P, D).
    For the encdec family ``batch`` holds "frames" (B, S_enc, D) and
    "tokens", and the step returns (last logits, the decoder's K/V of the
    prompt's S positions, the encoder's memory).  With ``policy`` (a
    ``MeshPolicy`` over a live mesh) the step is ``sharded``'s: the caches
    come back as ``DTensor``s at ``cache_specs``."""
    if policy is not None:
        from repro_torch.launch import sharded
        return sharded.make_prefill_step(cfg, policy)
    if cfg.family == "encdec":
        def prefill_step(params, batch):
            return ED.prefill_encdec(params, cfg, batch["frames"],
                                     batch["tokens"])
        return prefill_step

    def prefill_step(params, batch):
        prefix = batch.get("frames") if cfg.family == "vlm" else None
        return LM.prefill(params, cfg, batch["tokens"],
                          prefix_embeds=prefix)
    return prefill_step


def make_decode_step(cfg: ArchConfig, *, policy=None):
    """``decode_fn(params, caches, batch)`` -> (logits (B, 1, Vpad),
    new caches); ``batch`` holds "tokens" (B, 1) and "index", and for the
    encdec family the encoder's "memory" (B, S_enc, D).  With ``policy``
    (a ``MeshPolicy`` over a live mesh) the step is ``sharded``'s: caches
    as ``DTensor``s."""
    if policy is not None:
        from repro_torch.launch import sharded
        return sharded.make_decode_step(cfg, policy)
    if cfg.family == "encdec":
        def decode_fn(params, caches, batch):
            return ED.decode_step_encdec(params, cfg, batch["tokens"],
                                         batch["memory"], caches,
                                         batch["index"])
        return decode_fn

    def decode_fn(params, caches, batch):
        return LM.decode_step(params, cfg, batch["tokens"], caches,
                              batch["index"])
    return decode_fn


def init_params_for(cfg: ArchConfig, key=None, device=None,
                    dtype=COMPUTE):
    """``cfg``'s parameters drawn from the ``jaxrand`` key ``key``
    (``PRNGKey(0)`` on the CPU when none is given, as the reference's
    default) on ``device`` (``None`` means CUDA), stored as ``dtype``:
    bfloat16 to serve, float32 to train (``lm.init_lm``,
    ``encdec.init_encdec``)."""
    dev = resolve_device(device)
    key = key if key is not None else jaxrand.PRNGKey(0, device="cpu")
    if cfg.family == "encdec":
        return ED.init_encdec(key, cfg, device=dev, dtype=dtype)
    return LM.init_lm(key, cfg, device=dev, dtype=dtype)


def abstract_params(cfg: ArchConfig):
    """The parameters' shapes and dtypes as meta tensors: float32 leaves,
    as the reference's ``eval_shape`` of its init gives them."""
    return init_params_for(cfg, device="meta", dtype=torch.float32)


def abstract_opt_state(cfg: ArchConfig, optimizer=None):
    optimizer = optimizer or make_optimizer(cfg)
    return optimizer.init(abstract_params(cfg))
