"""The decoder LM of the LM stack: its dense and VLM families.

As in the JAX package's ``models/lm.py``, a model is a static plan of
homogeneous layer segments (``seg_plan``), each segment's parameters
stacked on a leading layer axis; one code path serves the full-sequence
forward (``forward_lm``), the prefill that writes the KV cache
(``prefill``) and the one-token decode against it (``decode_step``).  The
reference scans over the stack; the port loops over it in Python, one
layer's slice at a time.

Every segment kind of the decoder families is ported: ``attn_mlp`` (the
``dense`` and ``vlm`` families), ``attn_moe`` (the ``moe`` family,
``models/moe.py``), ``mamba`` and ``zamba_group`` (the ``hybrid`` family,
zamba2-1.2b: Mamba2 layers, ``models/mamba2.py``, with one shared
attention block applied before each group of ``attn_every`` of them, its
KV cache one per use) and ``mlstm`` and ``slstm`` (the ``xlstm`` family,
``models/xlstm.py``).  The recurrent kinds keep O(1) state per layer in
the decode cache; as in the reference, ``prefill`` runs their full
forward and hands back fresh (zero) recurrent state and zero K/V for the
shared attention block, not the prompt's state.

A MoE layer's capacity depends on the sequence it routes, so for the
``moe`` family the teacher-forced decode (S = 1 per step, nothing
dropped) is not the full forward or ``prefill`` where a longer sequence
drops choices, in the reference as in the port.

The embedding, the unembedding and every dense weight and bias are
stored as the caller's ``dtype``: float32, the reference's own leaves,
for training (``launch/steps.py::make_train_step`` takes float32
gradients of them), or bfloat16, the reference's cast at each use stored
once, for serving.  The norm scales stay float32, where the reference uses
them so.  ``init_lm`` draws them on the device from a ``core.jaxrand`` key
down the reference's ``split`` tree (the reference's parameters bit for
bit); ``params_from_numpy`` carries the JAX package's.  ``forward_lm``,
``decode_step`` and ``prefill`` run their bfloat16 products with float32
accumulation on the card (``layers.float32_accumulation``), whoever calls
them; ``lm_loss`` is the reference's masked-vocabulary cross-entropy.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import jaxrand, means
from repro_torch.kernels import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE
from repro_torch.models import xlstm as XL

COMPUTE = torch.bfloat16


# ---------------------------------------------------------------------------
# Segments: a static plan of homogeneous layer groups
# ---------------------------------------------------------------------------


def seg_plan(cfg: ArchConfig):
    """Returns a list of (kind, count) with kind in
    {'attn_mlp','attn_moe','mlstm','slstm','zamba_group','mamba'}."""
    if cfg.family in ("dense", "vlm"):
        return [("attn_mlp", cfg.n_layers)]
    if cfg.family == "moe":
        return [("attn_moe", cfg.n_layers)]
    if cfg.family == "xlstm":
        plan, run = [], 0
        for i in range(cfg.n_layers):
            if i in cfg.slstm_positions:
                if run:
                    plan.append(("mlstm", run))
                    run = 0
                plan.append(("slstm", 1))
            else:
                run += 1
        if run:
            plan.append(("mlstm", run))
        return plan
    if cfg.family == "hybrid":
        k = cfg.attn_every
        groups, rem = divmod(cfg.n_layers, k)
        plan = [("zamba_group", groups * k)]      # groups x (attn + k mamba)
        if rem:
            plan.append(("mamba", rem))
        return plan
    raise ValueError(cfg.family)


# ---------------------------------------------------------------------------
# Per-layer init/apply
# ---------------------------------------------------------------------------


def _attn_block_init(key: torch.Tensor, cfg: ArchConfig, with_moe: bool,
                     device=None, dtype=COMPUTE) -> Dict:
    k1, k2 = jaxrand.split(key)
    p = {"ln1": L.rmsnorm_init(cfg.d_model, device),
         "attn": L.attn_init(k1, cfg.attn_cfg(), device, dtype),
         "ln2": L.rmsnorm_init(cfg.d_model, device)}
    if with_moe:
        p["moe"] = MOE.moe_init(k2, cfg.moe, device, dtype)
    else:
        p["mlp"] = L.mlp_init(k2, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                              device=device, dtype=dtype)
    return p


def _attn_block_apply(p, cfg: ArchConfig, h, cache=None, cache_index=None,
                      rope=None, aux: bool = True):
    """Returns (h, new_cache, aux_loss); the dense block's aux loss is
    0.0, and so is the MoE block's with ``aux=False``.  ``cache`` is
    written in place (``L.attention``)."""
    a, new_cache = L.attention(p["attn"], cfg.attn_cfg(),
                               L.rmsnorm(p["ln1"], h), rope=rope,
                               cache=cache, cache_index=cache_index)
    # the reference's ``h + a`` is a bfloat16 sum, but XLA keeps it in
    # float32 where the second norm reads it (excess precision) and rounds
    # it only for the residual add after the MLP or the MoE; the port does
    # the same
    mid = h.float() + a.float()
    xn = L.rmsnorm(p["ln2"], mid).to(h.dtype)
    if "moe" in p:
        m, aux_loss = MOE.moe_apply(p["moe"], cfg.moe, xn, aux=aux)
    else:
        m, aux_loss = L.mlp(p["mlp"], xn, cfg.gated_mlp), 0.0
    return mid.to(h.dtype) + m, new_cache, aux_loss


def tree_map(fn, tree):
    """``fn`` over every tensor of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree, dict keys in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def layer(seg: Dict, i: int) -> Dict:
    """Layer ``i``'s parameters of a stacked segment (views, no copy)."""
    return tree_map(lambda a: a[i], seg)


def _one_init(key: torch.Tensor, cfg: ArchConfig, kind: str, device,
              dtype) -> Dict:
    """One layer of ``kind``, drawn from ``key`` (the reference's
    ``one(k, kind)``)."""
    if kind in ("attn_mlp", "attn_moe"):
        return _attn_block_init(key, cfg, kind == "attn_moe", device, dtype)
    if kind == "mlstm":
        return XL.mlstm_init(key, cfg.xlstm, device, dtype)
    if kind == "slstm":
        return XL.slstm_init(key, cfg.xlstm, device, dtype)
    if kind == "mamba":
        return {"ln": L.rmsnorm_init(cfg.d_model, device),
                "mamba": M2.mamba2_init(key, cfg.mamba, device, dtype)}
    raise ValueError(kind)


def stacked_init(key: torch.Tensor, count: int, one) -> Dict:
    """``count`` layers stacked on a leading axis: layer ``i`` drawn by
    ``one(split(key, count)[i])`` (the reference's ``vmap`` over split
    keys) and written into its slice of the stack."""
    keys = jaxrand.split(key, count)
    first = one(keys[0])
    stacked = tree_map(lambda a: torch.empty(
        (count, *a.shape), dtype=a.dtype, device=a.device), first)
    for i in range(count):
        drawn = first if i == 0 else one(keys[i])
        for dst, src in zip(leaves(layer(stacked, i)), leaves(drawn)):
            dst.copy_(src)
    return stacked


def _stacked_init(key: torch.Tensor, cfg: ArchConfig, kind: str,
                  count: int, device, dtype) -> Dict:
    """``count`` layers of ``kind`` stacked (``stacked_init``)."""
    return stacked_init(key, count, lambda k: _one_init(k, cfg, kind,
                                                        device, dtype))


def _seg_init(key: torch.Tensor, cfg: ArchConfig, kind: str, count: int,
              device=None, dtype=COMPUTE) -> Dict:
    """Params for one segment, down the reference's key tree: stacked
    layers; for ``zamba_group`` ``split(key)`` into the shared attention
    block (``k1``) and the ``count`` stacked Mamba2 layers (``k2``); the
    ``slstm`` segment's one layer not stacked."""
    if kind == "zamba_group":
        k1, k2 = jaxrand.split(key)
        return {"shared_attn": _attn_block_init(k1, cfg, False, device,
                                                dtype),
                "mamba": _stacked_init(k2, cfg, "mamba", count, device,
                                       dtype)}
    if kind == "slstm":
        return _one_init(key, cfg, kind, device, dtype)
    return _stacked_init(key, cfg, kind, count, device, dtype)


# ---------------------------------------------------------------------------
# Model init, and the reference's parameters carried over
# ---------------------------------------------------------------------------


def init_lm(key: torch.Tensor, cfg: ArchConfig, device=None,
            dtype=COMPUTE) -> Dict:
    """The reference's ``init_lm(key, cfg)`` on ``device`` (``None`` means
    CUDA): ``split(key, len(plan) + 3)``, the embedding (x 0.02) from
    ``keys[0]``, the unembedding (x d^-0.5) from ``keys[1]``, the segments
    from ``keys[2:]``; each leaf a float32 normal times its float32 scale,
    stored as ``dtype`` (float32 to train, bfloat16 to serve); norm scales
    ones in float32, biases zeros.  The keys are split where ``key`` lies
    (a CPU key keeps the few hundred small hashes off the card); on the
    meta device nothing is drawn: shapes only."""
    dev = resolve_device(device)
    plan = seg_plan(cfg)
    keys = jaxrand.split(key, len(plan) + 3)
    params: Dict[str, Any] = {
        "embed": L.draw_normal(keys[0], (cfg.vocab_padded, cfg.d_model),
                               0.02, dev, dtype),
        "ln_f": L.rmsnorm_init(cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = L.draw_normal(
            keys[1], (cfg.d_model, cfg.vocab_padded),
            cfg.d_model ** -0.5, dev, dtype)
    params["segments"] = [_seg_init(keys[i + 2], cfg, kind, count, dev,
                                    dtype)
                          for i, (kind, count) in enumerate(plan)]
    return params


# leaves the reference uses in float32: norm scales (and layer-norm
# biases), Mamba2's decay and step bias, sLSTM's recurrent matrices; every
# other leaf it casts to bfloat16 at each use
FLOAT32_LEAVES = ("scale", "bias", "A_log", "dt_bias", "r_gates")


def _carry(path: Tuple[str, ...], a, dev, dtype) -> torch.Tensor:
    if path[-1] in FLOAT32_LEAVES:
        dtype = torch.float32
    return torch.tensor(np.asarray(a, dtype=np.float32),
                        device=dev).to(dtype)


def params_from_numpy(tree, cfg: ArchConfig, device=None,
                      dtype=COMPUTE) -> Dict:
    """The JAX package's LM parameters (``init_lm``'s pytree, its leaves as
    numpy arrays) as the port's, on ``device`` (``None`` means CUDA):
    ``dtype`` where the reference casts at use, float32 where it uses a
    leaf so (``FLOAT32_LEAVES``)."""
    seg_plan(cfg)
    return carry_tree(tree, device, dtype)


def carry_tree(tree, device=None, dtype=COMPUTE) -> Dict:
    """A pytree of numpy leaves (dicts and lists) as tensors on
    ``device`` (``None`` means CUDA): ``dtype``, but float32 for the
    leaves named in ``FLOAT32_LEAVES``."""
    dev = resolve_device(device)

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, path) for v in node]
        return _carry(path, node, dev, dtype)
    return walk(tree, ())


def param_bytes(params) -> int:
    """Bytes the parameters hold on their device."""
    return sum(a.numel() * a.element_size() for a in leaves(params))


def _device_of(params) -> torch.device:
    return params["embed"].device


def _tokens(tokens, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(tokens) if not isinstance(
        tokens, torch.Tensor) else tokens, device=dev).long()


def _embed(params, tokens) -> torch.Tensor:
    return params["embed"].to(COMPUTE)[tokens]


def _unembed(params, cfg: ArchConfig, h) -> torch.Tensor:
    unembed = (params["embed"].T if cfg.tie_embeddings
               else params["unembed"]).to(COMPUTE)
    return h @ unembed


# ---------------------------------------------------------------------------
# Segment forward (full sequence)
# ---------------------------------------------------------------------------


def _layers(seg: Dict, count: int) -> List[Dict]:
    """Each layer's parameters of a stacked segment, from one ``unbind``
    per leaf: its backward stacks the layers' gradients once, where a
    slice per layer would add a stack-sized gradient per layer."""
    if isinstance(seg, dict):
        subs = {k: _layers(v, count) for k, v in seg.items()}
        return [{k: subs[k][i] for k in seg} for i in range(count)]
    return list(seg.unbind(0))


def _block(lp, cfg: ArchConfig, h, rope):
    """One layer of the full-sequence forward: (h, aux_loss)."""
    h, _, aux = _attn_block_apply(lp, cfg, h, rope=rope)
    return h, aux


def _mamba_layer(lp, cfg: ArchConfig, h):
    """One pre-norm residual Mamba2 layer of the full-sequence forward."""
    return h + M2.mamba2_apply(lp["mamba"], cfg.mamba,
                               L.rmsnorm(lp["ln"], h))


def remat_runner(cfg: ArchConfig, train: bool):
    """``run(fn, *args)``: ``fn(*args)`` under ``torch.utils.checkpoint``
    where the reference would remat the layer (``cfg.remat`` and
    ``train``, autograd recording), else ``fn(*args)``."""
    if cfg.remat and train and torch.is_grad_enabled():
        return lambda fn, *args: checkpoint(fn, *args, use_reentrant=False)
    return lambda fn, *args: fn(*args)


def _seg_forward(seg_params, cfg: ArchConfig, kind: str, count: int, h,
                 train: bool = False, rope=None):
    """Full-seq forward of one segment. Returns (h, aux).  With
    ``cfg.remat`` and ``train`` (and autograd recording), each layer the
    reference scans under ``_maybe_remat`` runs under
    ``torch.utils.checkpoint``: its activations are recomputed in the
    backward, the numbers are the same.  In a ``zamba_group`` segment
    those are the inner Mamba2 layers, not the shared attention block; the
    ``slstm`` segment runs without."""
    run = remat_runner(cfg, train)
    # the layers' aux losses summed in layer order from 0, the reference's
    # scan carry (only the attn_moe block adds one)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if kind in ("attn_mlp", "attn_moe"):
        for lp in _layers(seg_params, count):
            h, a = run(_block, lp, cfg, h, rope)
            if kind == "attn_moe":
                aux = aux + a
    elif kind == "mlstm":
        for lp in _layers(seg_params, count):
            h = run(XL.mlstm_apply, lp, cfg.xlstm, h)
    elif kind == "slstm":
        h = XL.slstm_apply(seg_params, cfg.xlstm, h)
    elif kind == "mamba":
        for lp in _layers(seg_params, count):
            h = run(_mamba_layer, lp, cfg, h)
    elif kind == "zamba_group":
        k = cfg.attn_every
        inner = _layers(seg_params["mamba"], count)
        for g in range(count // k):
            h, _, _ = _attn_block_apply(seg_params["shared_attn"], cfg, h,
                                        rope=rope)
            for lp in inner[g * k:(g + 1) * k]:
                h = run(_mamba_layer, lp, cfg, h)
    else:
        raise ValueError(kind)
    return h, aux


# ---------------------------------------------------------------------------
# Full forward (train / scoring) and the loss
# ---------------------------------------------------------------------------


@L.float32_accumulation()
def forward_lm(params, cfg: ArchConfig, tokens,
               prefix_embeds: Optional[torch.Tensor] = None,
               train: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S) int.  prefix_embeds: (B, P, D) modality stub.
    Returns (logits (B, S_total, Vpad) bf16, aux_loss).  ``train`` selects
    rematerialization (``_seg_forward``); autograd takes the backward
    (``launch/steps.py::make_train_step`` holds the float32 accumulation
    around it too)."""
    plan = seg_plan(cfg)
    dev = _device_of(params)
    h = _embed(params, _tokens(tokens, dev))
    if prefix_embeds is not None:
        h = torch.cat([torch.as_tensor(prefix_embeds, device=dev).to(COMPUTE),
                       h], dim=1)
    rope = L.rope_tables(torch.arange(h.shape[1], device=dev), cfg.head_dim,
                         cfg.rope_theta)
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    for (kind, count), seg in zip(plan, params["segments"]):
        h, aux = _seg_forward(seg, cfg, kind, count, h, train, rope)
        aux_total = aux_total + aux
    h = L.rmsnorm(params["ln_f"], h)
    return _unembed(params, cfg, h), aux_total


def lm_loss(logits: torch.Tensor, labels, vocab_size: int,
            label_offset: int = 0) -> torch.Tensor:
    """Causal-LM cross-entropy, float32, the reference's ``lm_loss``: the
    padded vocabulary tail masked out of the logsumexp, ``label_offset``
    leading (prefix) positions dropped; the mean as XLA compiles
    ``jnp.mean`` (``core.means``)."""
    if label_offset:
        logits = logits[:, label_offset:]
    lf = logits.float()
    iota = torch.arange(lf.shape[-1], device=lf.device)
    masked = torch.where(iota < vocab_size, lf, float("-inf"))
    m = torch.amax(masked, dim=-1)
    lse = m + torch.log(torch.sum(torch.exp(masked - m[..., None]), dim=-1))
    labels = _tokens(labels, lf.device)
    correct = torch.sum(torch.where(iota == labels[..., None], lf, 0.0),
                        dim=-1)
    return means.mean(lse - correct, (0, 1))


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------


def _stacked(c: Dict, count: int) -> Dict:
    """A layer's cache repeated on a leading layer axis."""
    return tree_map(lambda a: a.expand(count, *a.shape).clone(), c)


def _seg_cache(cfg: ArchConfig, kind: str, count: int, batch: int,
               length: int, conv_dtype, kv_dtype, dev):
    """A fresh cache of one segment: K/V of ``length`` positions (for
    ``zamba_group`` one per use of the shared block) in ``kv_dtype``, the
    recurrent layers' zero state (sLSTM's stabiliser at -1e9), their conv
    windows in ``conv_dtype`` and their matrix states in float32."""
    if kind in ("attn_mlp", "attn_moe", "zamba_group"):
        n = count // cfg.attn_every if kind == "zamba_group" else count
        shape = (n, batch, length, cfg.n_kv_heads, cfg.head_dim)
        kv = {"k": torch.zeros(shape, dtype=kv_dtype, device=dev),
              "v": torch.zeros(shape, dtype=kv_dtype, device=dev)}
        if kind != "zamba_group":
            return kv
        return {"attn": kv, "mamba": _stacked(M2.mamba2_init_cache(
            cfg.mamba, batch, conv_dtype, dev), count)}
    if kind == "mlstm":
        return _stacked(XL.mlstm_init_cache(cfg.xlstm, batch, conv_dtype,
                                            dev), count)
    if kind == "slstm":
        return XL.slstm_init_cache(cfg.xlstm, batch, dev)
    if kind == "mamba":
        return _stacked(M2.mamba2_init_cache(cfg.mamba, batch, conv_dtype,
                                             dev), count)
    raise ValueError(kind)


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=COMPUTE,
               device=None) -> list:
    """Cache list mirroring the segment plan, on ``device`` (``None``
    means CUDA): per attention segment {"k", "v"} of (count, batch,
    max_len, n_kv_heads, head_dim) zeros; per recurrent segment its
    layers' zero state (``_seg_cache``), conv windows in ``dtype``."""
    dev = resolve_device(device)
    return [_seg_cache(cfg, kind, count, batch, max_len, dtype, dtype, dev)
            for kind, count in seg_plan(cfg)]


# ---------------------------------------------------------------------------
# Decode step and prefill
# ---------------------------------------------------------------------------


def _recurrent_step(cfg: ArchConfig, kind: str, lp, h, cache):
    """One decode step of an ``mlstm`` or ``mamba`` layer: (h, cache)."""
    if kind == "mlstm":
        return XL.mlstm_step(lp, cfg.xlstm, h, cache)
    out, nc = M2.mamba2_step(lp["mamba"], cfg.mamba, L.rmsnorm(lp["ln"], h),
                             cache)
    return h + out, nc


def _stack(caches: List[Dict]) -> Dict:
    """Layers' caches stacked on a leading layer axis."""
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


@L.float32_accumulation()
def decode_step(params, cfg: ArchConfig, tokens, caches: list, index
                ) -> Tuple[torch.Tensor, list]:
    """tokens: (B, 1); index: the position to write in the cache (an int
    or a 0-dim tensor).  Returns (logits (B, 1, Vpad), new_caches); the
    given caches are not written (each stacked K/V cache is copied once,
    and the layers write their slices of the copy; the recurrent layers'
    new states are stacked anew).  A ``zamba_group`` segment runs the
    shared attention block against its group's own K/V cache, then the
    group's Mamba2 layers."""
    plan = seg_plan(cfg)
    dev = _device_of(params)
    index = int(index)
    h = _embed(params, _tokens(tokens, dev))
    rope = L.rope_tables(torch.arange(h.shape[1], device=dev)[None, :]
                         + index, cfg.head_dim, cfg.rope_theta)
    new_caches = []
    for (kind, count), seg, cache in zip(plan, params["segments"], caches):
        if kind in ("attn_mlp", "attn_moe"):
            nk, nv = cache["k"].clone(), cache["v"].clone()
            for i in range(count):
                h, _, _ = _attn_block_apply(
                    layer(seg, i), cfg, h, cache={"k": nk[i], "v": nv[i]},
                    cache_index=index, rope=rope, aux=False)
            new_caches.append({"k": nk, "v": nv})
        elif kind == "slstm":
            h, nc = XL.slstm_step(seg, cfg.xlstm, h, cache)
            new_caches.append(nc)
        elif kind in ("mlstm", "mamba"):
            ncs = []
            for i in range(count):
                h, nc = _recurrent_step(cfg, kind, layer(seg, i), h,
                                        layer(cache, i))
                ncs.append(nc)
            new_caches.append(_stack(ncs))
        else:                                   # zamba_group
            k = cfg.attn_every
            nk = cache["attn"]["k"].clone()
            nv = cache["attn"]["v"].clone()
            ncs = []
            for g in range(count // k):
                h, _, _ = _attn_block_apply(
                    seg["shared_attn"], cfg, h,
                    cache={"k": nk[g], "v": nv[g]}, cache_index=index,
                    rope=rope, aux=False)
                for i in range(g * k, (g + 1) * k):
                    h, nc = _recurrent_step(cfg, "mamba",
                                            layer(seg["mamba"], i), h,
                                            layer(cache["mamba"], i))
                    ncs.append(nc)
            new_caches.append({"attn": {"k": nk, "v": nv},
                               "mamba": _stack(ncs)})
    h = L.rmsnorm(params["ln_f"], h)
    return _unembed(params, cfg, h), new_caches


@L.float32_accumulation()
def prefill(params, cfg: ArchConfig, tokens,
            prefix_embeds: Optional[torch.Tensor] = None):
    """Full-sequence prefill: returns (last-position logits, caches filled
    for positions [0, S)).  The K/V of the whole sequence are recomputed
    per layer into the cache (K with RoPE applied, V without); each cache
    is S positions long, S counting the prefix.  A recurrent segment's
    cache comes back fresh, as the reference's does (``_seg_cache``):
    only the logits are the prompt's."""
    plan = seg_plan(cfg)
    dev = _device_of(params)
    tokens = _tokens(tokens, dev)
    b, s = tokens.shape
    h = _embed(params, tokens)
    if prefix_embeds is not None:
        h = torch.cat([torch.as_tensor(prefix_embeds, device=dev).to(COMPUTE),
                       h], dim=1)
        s = h.shape[1]
    acfg = cfg.attn_cfg()
    positions = torch.arange(s, device=dev)[None, :]
    caches = []
    for (kind, count), seg in zip(plan, params["segments"]):
        if kind not in ("attn_mlp", "attn_moe"):
            # the reference runs the full forward and hands back a fresh
            # state (float32 conv windows, zero K/V for the shared block)
            h, _ = _seg_forward(seg, cfg, kind, count, h)
            caches.append(_seg_cache(cfg, kind, count, b, s, torch.float32,
                                     COMPUTE, dev))
            continue
        ks, vs = [], []
        for i in range(count):
            lp = layer(seg, i)
            xn = L.rmsnorm(lp["ln1"], h)
            k = L.dense(lp["attn"]["wk"], xn).reshape(
                b, s, acfg.n_kv_heads, acfg.head_dim)
            v = L.dense(lp["attn"]["wv"], xn).reshape(
                b, s, acfg.n_kv_heads, acfg.head_dim)
            if acfg.qk_norm:
                k = L.rmsnorm(lp["attn"]["k_norm"], k)
            ks.append(L.apply_rope(k, positions, acfg.rope_theta))
            vs.append(v)
            h, _, _ = _attn_block_apply(lp, cfg, h, aux=False)
        caches.append({"k": torch.stack(ks), "v": torch.stack(vs)})
    h = L.rmsnorm(params["ln_f"], h[:, -1:])
    return _unembed(params, cfg, h), caches
