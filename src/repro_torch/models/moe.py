"""Mixture-of-experts FFN of the LM stack (qwen3-moe / qwen2-moe style):
the JAX package's ``models/moe.py`` on one device.

GShard-style capacity-based top-k routing with a dense dispatch into a
(B, E, C, D) expert buffer, each batch row a routing group, every
expert's products run over its C slots, and a combine back to the
tokens.  qwen2-moe adds *shared* experts (an always-on SwiGLU branch)
behind a sigmoid gate.  The reference's ``ShardingPolicy`` constraints
are not carried over: on one card they are the identity.  A sharded
train step runs ``moe_apply`` on its rank's rows and takes the router's
statistics to the global batch's through ``batch_statistics``.

The numbers are the reference's as XLA's CPU code computes them (read
from the compiled HLO of ``moe_apply``, alone and inside the LM's layer
scan):

* the router logits are the bfloat16 product (``dense`` casts ``w`` to
  ``x``'s dtype), cast to float32; the softmax is ``exp(l - max) / sum``
  in float32, and XLA's CPU code flushes a subnormal result to zero (so
  does the TPU): where a logit trails the largest by more than about 87,
  its ``exp`` or its quotient underflows to 0, not to a subnormal that
  would still rank it (``_flush``);
* ``jax.lax.top_k`` is a stable descending sort: on equal probabilities
  the lower expert index first.  Equal probabilities are common (the
  logits have bfloat16 resolution), and ``torch.topk``'s order on ties is
  unspecified, so the port takes the first k of a stable descending sort
  on the CPU and on the card alike;
* the dispatch buffer holds each kept choice's token exactly (one choice
  per (b, e, pos)); the expert products are bfloat16 with float32
  accumulation, SiLU is XLA's per-step bfloat16 chain (``layers.silu``);
* the combine is a scatter-add whose combiner rounds to bfloat16 after
  each add, the updates taken in (b, token, rank) order: each token's
  output is ``((0 + w0) + w1) + ...`` in bfloat16, rank by rank.  The port
  writes it as k sequential bfloat16 adds (no atomics on the card);
* the shared gate is ``1 / (1 + exp(-g))`` in float32 on the bfloat16
  gate product, rounded to bfloat16 before it scales the shared output.

The router's float32 ``exp`` and sums are not XLA's bit for bit, so a
gate value may differ from the reference's by a float32 ulp, which moves
a bfloat16 output now and then (``tests/test_torch_moe.py`` states the
tolerance).  The routing itself does not move: probabilities that tie
are equal logits, and logits that differ do so by at least a bfloat16
ulp, far beyond a float32 ulp of the softmax.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import jaxrand, means
from repro_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff_expert: int
    num_experts: int
    top_k: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0                # total shared intermediate size
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001


def moe_init(key: torch.Tensor, cfg: MoEConfig, device=None,
             dtype=L.COMPUTE_DTYPE) -> Dict:
    """The reference's ``moe_init(key, cfg)``: ``split(key, 6)``; the
    router from ``ks[0]``; the stacked experts (E, D, F) / (E, F, D) from
    ``ks[1..3]`` times ``d**-0.5`` (gate, up) and ``f**-0.5`` (down); the
    shared experts' ``w_gate`` and ``w_up`` both from ``ks[4]`` (so they
    are equal, as in the reference), their ``w_down`` and the shared gate
    both from ``ks[5]``.  Leaves stored as ``dtype``, drawn in
    ``layers.DRAW_CHUNK`` chunks."""
    ks = jaxrand.split(key, 6)
    e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff_expert
    s = d ** -0.5
    p = {
        "router": L.dense_init(ks[0], d, e, device=device, dtype=dtype),
        "w_gate": L.draw_normal(ks[1], (e, d, f), s, device, dtype),
        "w_up": L.draw_normal(ks[2], (e, d, f), s, device, dtype),
        "w_down": L.draw_normal(ks[3], (e, f, d), f ** -0.5, device, dtype),
    }
    if cfg.num_shared_experts > 0:
        fs = cfg.d_ff_shared or cfg.num_shared_experts * f
        p["shared"] = {
            "w_gate": L.dense_init(ks[4], d, fs, device=device, dtype=dtype),
            "w_up": L.dense_init(ks[4], d, fs, device=device, dtype=dtype),
            "w_down": L.dense_init(ks[5], fs, d, device=device, dtype=dtype),
        }
        p["shared_gate"] = L.dense_init(ks[5], d, 1, device=device,
                                        dtype=dtype)
    return p


# the list ``record_routes`` fills, None outside it.  Process-wide, not
# per thread: on the card autograd runs a rematerialized layer's forward
# again in its own device thread, and that forward is recorded too, as on
# the CPU, where it runs in the caller's thread.
_ROUTES: Optional[List[Dict[str, torch.Tensor]]] = None


@contextlib.contextmanager
def record_routes():
    """Collects the routing of every ``moe_apply`` call made inside, in
    call order: a list of {"logits" (B, S, E) float32, "expert_idx"
    (B, S, k), "keep" (B, S * k)}, detached.  ``launch.crosscheck`` reads
    it to tell the card's routing from the CPU's."""
    global _ROUTES
    outer, _ROUTES = _ROUTES, []
    try:
        yield _ROUTES
    finally:
        _ROUTES = outer


# The load-balancing loss reads two means over the batch: the router's
# probabilities and the share of first choices per expert.  The
# reference's sharded step computes them over the global batch; a sharded
# step of the port (``launch/sharded.py``) runs ``moe_apply`` on its
# rank's rows and sets this to a function that takes the rows' means
# (``me``, ``ce``) to the global batch's.
_BATCH_STATS: Optional[Callable] = None


@contextlib.contextmanager
def batch_statistics(fn: Callable):
    """Inside, ``moe_apply``'s aux loss reads ``fn(me, ce)`` -> (me, ce)
    in place of its rows' own means."""
    global _BATCH_STATS
    outer, _BATCH_STATS = _BATCH_STATS, fn
    try:
        yield
    finally:
        _BATCH_STATS = outer


_TINY = float(np.finfo(np.float32).tiny)


def _flush(t: torch.Tensor) -> torch.Tensor:
    """Subnormal float32 values (here all >= 0) to zero, as XLA's CPU
    code flushes them."""
    return t.masked_fill(t < _TINY, 0.0)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest in descending
    order, equal values lower index first (a stable sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg: MoEConfig, s: int) -> int:
    """Slots per expert and routing group for a sequence of ``s``."""
    return int(cfg.capacity_factor * s * cfg.top_k / cfg.num_experts) + 1


def moe_apply(p: Dict, cfg: MoEConfig, x: torch.Tensor, aux: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss).  Each batch row is a routing
    group: a choice's position in its expert is the running count over
    the row's S * k choices in token-major, rank-minor order, and choices
    at ``pos >= capacity(cfg, S)`` are dropped.  ``aux=False`` skips the
    load-balancing loss (the decode step throws it away) and returns a
    zero."""
    b, s, d = x.shape
    cd, dev = x.dtype, x.device
    e, k = cfg.num_experts, cfg.top_k

    logits = L.dense(p["router"], x).float()                     # (B,S,E)
    ex = _flush(torch.exp(logits - torch.amax(logits, dim=-1,
                                              keepdim=True)))
    probs = _flush(ex / torch.sum(ex, dim=-1, keepdim=True))
    gate_vals, expert_idx = top_k(probs, k)                       # (B,S,k)
    gate_vals = gate_vals / torch.clamp(
        torch.sum(gate_vals, dim=-1, keepdim=True), min=1e-9)

    # load-balancing aux loss (Switch style); XLA folds the reference's
    # ``e * sum * weight`` into one float32 constant ``e * weight``
    if aux:
        me = means.mean(probs, (0, 1))
        first = torch.nn.functional.one_hot(expert_idx[..., 0], e).float()
        ce = means.mean(first, (0, 1))
        if _BATCH_STATS is not None:
            me, ce = _BATCH_STATS(me, ce)
        aux_loss = torch.sum(me * ce) * float(
            np.float32(e) * np.float32(cfg.router_aux_weight))
    else:
        aux_loss = torch.zeros((), dtype=torch.float32, device=dev)

    # ---- per-group position in expert ----
    cap = capacity(cfg, s)
    fe = expert_idx.reshape(b, s * k)                             # (B, Sk)
    fg = gate_vals.reshape(b, s * k).to(cd)
    onehot = torch.nn.functional.one_hot(fe, e)                   # (B,Sk,E)
    pos = torch.gather(torch.cumsum(onehot, dim=1), 2,
                       fe[..., None])[..., 0] - 1                 # (B, Sk)
    keep = pos < cap
    if _ROUTES is not None:
        _ROUTES.append({"logits": logits.detach(),
                        "expert_idx": expert_idx.detach(),
                        "keep": keep.detach()})
    tok = torch.arange(s, device=dev).repeat_interleave(k)[None, :]
    tok = tok.expand(b, s * k)
    bidx = torch.arange(b, device=dev)[:, None].expand(b, s * k)

    # ---- dispatch: (B, E, C, D) ----
    # a kept choice's (b, e, pos) is its own; the dropped ones all go to
    # one spare slot past the capacity, which nothing reads (no duplicate
    # index among the kept, so the write needs no atomics)
    slot = torch.where(keep, pos, torch.full_like(pos, cap))
    buf = torch.zeros((b, e, cap + 1, d), dtype=cd, device=dev)
    buf = buf.index_put((bidx, fe, slot), x[bidx, tok])
    xe = buf[:, :, :cap].permute(1, 0, 2, 3).reshape(e, b * cap, d)

    # ---- expert computation: (E, B*C, D) x (E, D, F) ----
    h_gate = torch.bmm(xe, p["w_gate"].to(cd))
    h_up = torch.bmm(xe, p["w_up"].to(cd))
    h = L.silu(h_gate) * h_up
    out_buf = torch.bmm(h, p["w_down"].to(cd)).reshape(e, b, cap, d)

    # ---- combine ----
    gathered = out_buf[fe, bidx, torch.clamp(pos, max=cap - 1)]  # (B,Sk,D)
    weighted = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=cd, device=dev))
    weighted = (weighted * fg[..., None]).reshape(b, s, k, d)
    # the reference's scatter-add into zeros rounds after each add, rank
    # by rank: ((0 + w0) + w1) + ...
    out = weighted[:, :, 0] + 0.0
    for r in range(1, k):
        out = out + weighted[:, :, r]

    # ---- shared experts (qwen2-moe) ----
    if "shared" in p:
        sh = p["shared"]
        hs = L.silu(L.dense(sh["w_gate"], x)) * L.dense(sh["w_up"], x)
        shared_out = L.dense(sh["w_down"], hs)
        g = L.dense(p["shared_gate"], x).float()
        sg = 1.0 / (torch.exp(-g) + 1.0)
        out = out + shared_out * sg.to(cd)

    return out, aux_loss
