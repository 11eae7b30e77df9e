"""The encoder-decoder backbone of seamless-m4t-medium ([audio]): the JAX
package's ``models/encdec.py``.

As in the reference, the speech frontend is a stub: the caller hands in
precomputed frame embeddings (B, S_enc, D).  The backbone is a
bidirectional encoder stack (self-attention with RoPE, no causal mask, and
the GeLU MLP, each behind its RMSNorm) and a causal decoder stack whose
layers run self-attention with the KV cache, then cross-attention to the
encoder's memory (``layers.attention(kv_override=memory)``: no RoPE, no
mask), then the MLP.  Each stack's parameters are stacked on a leading
layer axis; the reference scans over them, the port loops in Python.

``init_encdec`` draws the reference's parameters bit for bit from a
``core.jaxrand`` key down its ``split`` tree, each leaf stored as the
caller's ``dtype`` (float32 to train, bfloat16 to serve) and the norm
scales float32, as ``lm.init_lm`` does; ``params_from_numpy`` carries the
JAX package's.  ``forward_encdec`` is the teacher-forced forward (under
``torch.utils.checkpoint`` per layer when training with ``cfg.remat``),
``prefill_encdec`` encodes and fills the decoder's self-attention K/V for
a prompt, ``decode_step_encdec`` takes one token against a fixed memory.
The decode step recomputes each layer's cross-attention K/V from the
memory, as the reference does.  All three run their bfloat16 products
with float32 accumulation (``layers.float32_accumulation``).

Where XLA keeps a bfloat16 residual sum in float32 (excess precision) the
port does too: the sum after self-attention is read by the cross-attention
norm in float32 and rounded for the next residual add, and the sum after
cross-attention likewise for the MLP's norm (``_residual``), as
``lm._attn_block_apply`` does for the decoder LMs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import jaxrand
from repro_torch.kernels import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import lm as LM

COMPUTE = torch.bfloat16


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _enc_layer_init(key: torch.Tensor, cfg: ArchConfig, device=None,
                    dtype=COMPUTE) -> Dict:
    k1, k2 = jaxrand.split(key)
    return {"ln1": L.rmsnorm_init(cfg.d_model, device),
            "attn": L.attn_init(k1, cfg.attn_cfg(), device, dtype),
            "ln2": L.rmsnorm_init(cfg.d_model, device),
            "mlp": L.mlp_init(k2, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                              device=device, dtype=dtype)}


def _dec_layer_init(key: torch.Tensor, cfg: ArchConfig, device=None,
                    dtype=COMPUTE) -> Dict:
    k1, k2, k3 = jaxrand.split(key, 3)
    return {"ln1": L.rmsnorm_init(cfg.d_model, device),
            "self_attn": L.attn_init(k1, cfg.attn_cfg(), device, dtype),
            "ln_x": L.rmsnorm_init(cfg.d_model, device),
            "cross_attn": L.attn_init(k2, cfg.attn_cfg(), device, dtype),
            "ln2": L.rmsnorm_init(cfg.d_model, device),
            "mlp": L.mlp_init(k3, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                              device=device, dtype=dtype)}


def init_encdec(key: torch.Tensor, cfg: ArchConfig, device=None,
                dtype=COMPUTE) -> Dict:
    """The reference's ``init_encdec(key, cfg)`` on ``device`` (``None``
    means CUDA): ``split(key, 4)``, the embedding (x 0.02) from the first
    key, the encoder layers from ``split`` of the second, the decoder
    layers from ``split`` of the third, the unembedding (x d^-0.5) from
    the fourth; stored as ``dtype``, norm scales float32.  On the meta
    device nothing is drawn: shapes only (``lm.init_lm``)."""
    dev = resolve_device(device)
    k1, k2, k3, k4 = jaxrand.split(key, 4)
    return {
        "embed": L.draw_normal(k1, (cfg.vocab_padded, cfg.d_model), 0.02,
                               dev, dtype),
        "encoder": LM.stacked_init(k2, cfg.n_encoder_layers, lambda k:
                                   _enc_layer_init(k, cfg, dev, dtype)),
        "decoder": LM.stacked_init(k3, cfg.n_layers, lambda k:
                                   _dec_layer_init(k, cfg, dev, dtype)),
        "ln_enc": L.rmsnorm_init(cfg.d_model, dev),
        "ln_f": L.rmsnorm_init(cfg.d_model, dev),
        "unembed": L.draw_normal(k4, (cfg.d_model, cfg.vocab_padded),
                                 cfg.d_model ** -0.5, dev, dtype),
    }


def params_from_numpy(tree, cfg: ArchConfig, device=None,
                      dtype=COMPUTE) -> Dict:
    """The JAX package's ``init_encdec`` pytree (numpy leaves) as the
    port's parameters on ``device`` (``None`` means CUDA): ``dtype``
    where the reference casts at use, the norm scales float32."""
    if cfg.family != "encdec":
        raise ValueError(cfg.family)
    return LM.carry_tree(tree, device, dtype)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def _frames(frames, dev) -> torch.Tensor:
    return torch.as_tensor(frames, device=dev).to(COMPUTE)


def _residual(h: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """``h + a`` kept in float32, as XLA keeps the bfloat16 sum where the
    next norm reads it; the caller rounds it to ``h``'s dtype for the
    residual stream."""
    return h.float() + a.float()


def _enc_layer(lp, acfg: L.AttnConfig, gated: bool, h, rope):
    a, _ = L.attention(lp["attn"], acfg, L.rmsnorm(lp["ln1"], h), rope=rope)
    mid = _residual(h, a)
    xn = L.rmsnorm(lp["ln2"], mid).to(h.dtype)
    return mid.to(h.dtype) + L.mlp(lp["mlp"], xn, gated)


def _dec_layer(lp, cfg: ArchConfig, h, memory, rope=None, self_cache=None,
               cache_index=None):
    """Self-attention (with the cache when given), cross-attention to
    ``memory``, the MLP, each behind its RMSNorm.  Returns (h, cache)."""
    acfg = cfg.attn_cfg()
    a, new_cache = L.attention(lp["self_attn"], acfg,
                               L.rmsnorm(lp["ln1"], h), rope=rope,
                               cache=self_cache, cache_index=cache_index)
    mid = _residual(h, a)
    x, _ = L.attention(lp["cross_attn"], acfg,
                       L.rmsnorm(lp["ln_x"], mid).to(h.dtype),
                       kv_override=memory)
    mid = _residual(mid.to(h.dtype), x)
    xn = L.rmsnorm(lp["ln2"], mid).to(h.dtype)
    return mid.to(h.dtype) + L.mlp(lp["mlp"], xn, cfg.gated_mlp), new_cache


# ---------------------------------------------------------------------------
# Encoder, teacher-forced forward
# ---------------------------------------------------------------------------


@L.float32_accumulation()
def encode(params, cfg: ArchConfig, frames, train: bool = True
           ) -> torch.Tensor:
    """frames: (B, S_enc, D) stub embeddings -> the encoder's memory
    (B, S_enc, D) bfloat16.  Bidirectional: RoPE on positions 0..S_enc-1,
    no mask."""
    dev = params["embed"].device
    acfg = dataclasses.replace(cfg.attn_cfg(), causal=False)
    h = _frames(frames, dev)
    rope = L.rope_tables(torch.arange(h.shape[1], device=dev),
                         cfg.head_dim, cfg.rope_theta)
    run = LM.remat_runner(cfg, train)
    for lp in LM._layers(params["encoder"], cfg.n_encoder_layers):
        h = run(_enc_layer, lp, acfg, cfg.gated_mlp, h, rope)
    return L.rmsnorm(params["ln_enc"], h)


@L.float32_accumulation()
def forward_encdec(params, cfg: ArchConfig, frames, tokens,
                   train: bool = True) -> torch.Tensor:
    """Teacher-forced forward: frames (B, S_enc, D), tokens (B, S_dec).
    Returns logits (B, S_dec, Vpad) bfloat16.  ``train`` selects remat
    (``lm.remat_runner``); autograd takes the backward."""
    dev = params["embed"].device
    memory = encode(params, cfg, frames, train)
    tokens = LM._tokens(tokens, dev)
    h = params["embed"].to(COMPUTE)[tokens]
    rope = L.rope_tables(torch.arange(h.shape[1], device=dev),
                         cfg.head_dim, cfg.rope_theta)
    run = LM.remat_runner(cfg, train)
    for lp in LM._layers(params["decoder"], cfg.n_layers):
        h, _ = run(_dec_layer, lp, cfg, h, memory, rope)
    h = L.rmsnorm(params["ln_f"], h)
    return h @ params["unembed"].to(COMPUTE)


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


def init_dec_cache(cfg: ArchConfig, batch: int, max_len: int,
                   dtype=COMPUTE, device=None) -> Dict:
    """The decoder's self-attention cache on ``device`` (``None`` means
    CUDA; ``"meta"`` for shapes only): {"k", "v"} of (n_layers, batch,
    max_len, n_kv_heads, head_dim) zeros."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


@L.float32_accumulation()
def decode_step_encdec(params, cfg: ArchConfig, tokens, memory, cache,
                       index) -> Tuple[torch.Tensor, Dict]:
    """One decoder step against a fixed encoder ``memory`` (B, S_enc, D):
    tokens (B, 1), ``index`` the position to write (an int or a 0-dim
    tensor).  Returns (logits (B, 1, Vpad), new cache); the given cache is
    not written (it is copied once, and each layer writes its slice of the
    copy)."""
    dev = params["embed"].device
    index = int(index)
    tokens = LM._tokens(tokens, dev)
    memory = _frames(memory, dev)
    h = params["embed"].to(COMPUTE)[tokens]
    rope = L.rope_tables(torch.arange(h.shape[1], device=dev)[None, :]
                         + index, cfg.head_dim, cfg.rope_theta)
    nk, nv = cache["k"].clone(), cache["v"].clone()
    for i in range(cfg.n_layers):
        h, _ = _dec_layer(LM.layer(params["decoder"], i), cfg, h, memory,
                          rope=rope, self_cache={"k": nk[i], "v": nv[i]},
                          cache_index=index)
    h = L.rmsnorm(params["ln_f"], h)
    return h @ params["unembed"].to(COMPUTE), {"k": nk, "v": nv}


@L.float32_accumulation()
def prefill_encdec(params, cfg: ArchConfig, frames, tokens):
    """Encode ``frames`` and run the decoder over the prompt ``tokens``
    (B, S).  Returns (the last position's logits (B, 1, Vpad), the
    self-attention K/V {"k", "v"} of (n_layers, B, S, n_kv_heads,
    head_dim), K with RoPE applied, and the memory).  The K/V are S
    positions long: a decode step continues in a cache of its own
    length (``init_dec_cache``)."""
    dev = params["embed"].device
    tokens = LM._tokens(tokens, dev)
    b, s = tokens.shape
    memory = encode(params, cfg, frames, train=False)
    h = params["embed"].to(COMPUTE)[tokens]
    acfg = cfg.attn_cfg()
    positions = torch.arange(s, device=dev)
    rope = L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    ks, vs = [], []
    for lp in LM._layers(params["decoder"], cfg.n_layers):
        xn = L.rmsnorm(lp["ln1"], h)
        k = L.dense(lp["self_attn"]["wk"], xn).reshape(
            b, s, acfg.n_kv_heads, acfg.head_dim)
        v = L.dense(lp["self_attn"]["wv"], xn).reshape(
            b, s, acfg.n_kv_heads, acfg.head_dim)
        ks.append(L.apply_rope(k, positions, acfg.rope_theta))
        vs.append(v)
        h, _ = _dec_layer(lp, cfg, h, memory, rope=rope)
    h = L.rmsnorm(params["ln_f"], h[:, -1:])
    return (h @ params["unembed"].to(COMPUTE),
            {"k": torch.stack(ks), "v": torch.stack(vs)}, memory)
