"""Mamba2 (SSD) block, chunkwise-parallel, built on the shared GLA core.

The SSD recurrence (Mamba2, Dao & Gu 2024) is
    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t ,  y_t = C_t . h_t + D x_t
with a *scalar* per-head decay: the gated-linear-attention recurrence of
``models/layers.py`` with q = C, k = B, v = x, log_a = dt * A and b = dt,
as in the JAX package's ``models/mamba2.py``.

Decode keeps (conv_state, ssm_state) per layer: O(1) per token.

Leaves: ``in_proj`` and ``out_proj`` are dense weights, stored as the
caller's ``dtype`` like every dense weight of the LM stack, and so are
``conv_w``, ``conv_b`` and ``D``, which the reference casts to the
activations' bfloat16 at each use; ``A_log``, ``dt_bias`` and the norm
scale are used in float32 and stay float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import jaxrand
from repro_torch.models.layers import (COMPUTE_DTYPE, dense, dense_init,
                                       draw_normal, gated_linear_attention,
                                       gla_step, rmsnorm, rmsnorm_init, silu,
                                       softplus)


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def a_log(h: int, device=None) -> torch.Tensor:
    """``jnp.log(jnp.linspace(1.0, 16.0, h))`` as XLA's CPU code computes
    it, float32: ``i * r`` with r the float32 ``1 / (h - 1)``, one minus
    it, then an FMA of i by ``16 r``; the last point 16 exactly; the log
    XLA's (``jaxrand.logf``)."""
    i = torch.arange(h - 1, dtype=torch.float32, device=device)
    r = torch.tensor(1.0, dtype=torch.float32) / (h - 1)
    step = i * r
    points = jaxrand.fma(i, float(r * 16.0), 1.0 - step)
    points = torch.cat([points, torch.full((1,), 16.0, device=device)])
    return jaxrand.logf(points)


def mamba2_init(key: torch.Tensor, cfg: Mamba2Config, device=None,
                dtype=COMPUTE_DTYPE) -> Dict:
    """The reference's draw: ``split(key, 5)``, of which ``ks[0..2]``
    draw ``in_proj``, ``conv_w`` (x 0.2) and ``out_proj``."""
    ks = jaxrand.split(key, 5)
    di, dm = cfg.d_inner, cfg.d_model
    h = cfg.n_heads
    dc = di + 2 * cfg.d_state
    # in_proj packs [z, x, B, C, dt]
    d_in_proj = 2 * di + 2 * cfg.d_state + h
    meta = device is not None and torch.device(device).type == "meta"
    return {
        "in_proj": dense_init(ks[0], dm, d_in_proj, device=device,
                              dtype=dtype),
        "conv_w": draw_normal(ks[1], (cfg.d_conv, dc), 0.2, device, dtype),
        "conv_b": torch.zeros((dc,), dtype=dtype, device=device),
        "A_log": (torch.empty((h,), device=device) if meta
                  else a_log(h, device)),              # per-head decay
        "D": torch.ones((h,), dtype=dtype, device=device),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=device),
        "norm": rmsnorm_init(di, device),
        "out_proj": dense_init(ks[2], di, dm, device=device, dtype=dtype),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  x: (B,T,C); w: (K,C).  With state (B,K-1,C)
    supports streaming; returns (y, new_state).  The taps are summed in
    x's dtype, each product and add rounded to it, as XLA rounds the
    reference's Python ``sum``."""
    k = w.shape[0]
    wc = w.to(x.dtype)
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    t = x.shape[1]
    y = xp[:, 0:t, :] * wc[0]
    for i in range(1, k):
        y = y + xp[:, i:i + t, :] * wc[i]
    new_state = xp[:, -(k - 1):, :] if k > 1 else None
    return silu(y + b.to(x.dtype)), new_state


def _split_proj(zxbcdt: torch.Tensor, cfg: Mamba2Config):
    di, ds = cfg.d_inner, cfg.d_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * ds]
    dt = zxbcdt[..., di + di + 2 * ds:]
    return z, xbc, dt


def _skip_and_out(p: Dict, cfg: Mamba2Config, y: torch.Tensor,
                  xin: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``y + D x``, gated by ``silu(z)``, normed and projected out; D is
    cast to the activations' dtype first, as in the reference.  XLA keeps
    the gate's product in float32 where the norm reads it (excess
    precision), and so does the port."""
    d = torch.repeat_interleave(p["D"], cfg.head_dim).to(xin.dtype)
    y = y + xin * d
    gated = rmsnorm(p["norm"], y.float() * silu(z).float()).to(y.dtype)
    return dense(p["out_proj"], gated)


def mamba2_apply(p: Dict, cfg: Mamba2Config, x: torch.Tensor,
                 chunk: int = 128) -> torch.Tensor:
    """Training / prefill forward. x: (B, T, D)."""
    b, t, _ = x.shape
    h, hd, ds = cfg.n_heads, cfg.head_dim, cfg.d_state
    zxbcdt = dense(p["in_proj"], x)
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    xbc, _ = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xin = xbc[..., :cfg.d_inner]
    bm = xbc[..., cfg.d_inner:cfg.d_inner + ds]                 # (B,T,N)
    cm = xbc[..., cfg.d_inner + ds:]
    dt = softplus(dt.float() + p["dt_bias"])                    # (B,T,H)
    a = -torch.exp(p["A_log"].float())                          # (H,) < 0
    log_a = dt * a                                              # (B,T,H)

    # GLA mapping: q = C, k = B (shared across heads: broadcast), v = x
    q = cm[:, :, None, :].expand(b, t, h, ds)
    k = bm[:, :, None, :].expand(b, t, h, ds)
    v = xin.reshape(b, t, h, hd)
    pad = (-t) % chunk
    if pad:
        def zeros(a_):
            return torch.nn.functional.pad(
                a_, (0, 0) * (a_.dim() - 2) + (0, pad))
        q, k, v = zeros(q), zeros(k), zeros(v)
        log_a, dt = zeros(log_a), zeros(dt)
    y = gated_linear_attention(q, k, v, log_a, dt, chunk=chunk)
    y = y[:, :t].reshape(b, t, cfg.d_inner)
    return _skip_and_out(p, cfg, y, xin, z)


def mamba2_init_cache(cfg: Mamba2Config, batch: int, dtype=torch.float32,
                      device=None) -> Dict:
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1,
                             cfg.d_inner + 2 * cfg.d_state), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, cfg.n_heads, cfg.d_state, cfg.head_dim),
                           dtype=torch.float32, device=device),
    }


def mamba2_step(p: Dict, cfg: Mamba2Config, x: torch.Tensor, cache: Dict
                ) -> Tuple[torch.Tensor, Dict]:
    """Single-token decode. x: (B, 1, D)."""
    b = x.shape[0]
    h, hd, ds = cfg.n_heads, cfg.head_dim, cfg.d_state
    zxbcdt = dense(p["in_proj"], x)
    z, xbc, dt = _split_proj(zxbcdt, cfg)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                 state=cache["conv"])
    xin = xbc[..., :cfg.d_inner]
    bm = xbc[..., cfg.d_inner:cfg.d_inner + ds]
    cm = xbc[..., cfg.d_inner + ds:]
    dt = softplus(dt[:, 0].float() + p["dt_bias"])              # (B,H)
    a = -torch.exp(p["A_log"].float())
    log_a = dt * a
    q = cm[:, 0, None, :].expand(b, h, ds)
    k = bm[:, 0, None, :].expand(b, h, ds)
    v = xin[:, 0].reshape(b, h, hd)
    y, new_ssm = gla_step(q, k, v, log_a, dt, cache["ssm"])
    y = y.reshape(b, 1, cfg.d_inner)
    return _skip_and_out(p, cfg, y, xin, z), {"conv": new_conv,
                                              "ssm": new_ssm}
