"""xLSTM blocks (arXiv:2405.04517): mLSTM (matrix memory, parallelizable)
and sLSTM (scalar memory, true recurrence), as in the JAX package's
``models/xlstm.py``.

mLSTM is the gated-linear-attention recurrence with a per-head scalar
forget gate, so it runs on the chunked GLA core of ``models/layers.py``.
sLSTM has a nonlinear hidden-to-gate dependency and runs as a Python loop
over time (the reference's ``lax.scan``), its cell in float32.

Leaves: the dense weights, ``conv_w``, ``conv_b`` and ``skip`` (cast to
the activations' bfloat16 at each use by the reference) are stored as the
caller's ``dtype``; the norm scales and sLSTM's recurrent ``r_gates``
(used in float32) stay float32.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core import jaxrand
from repro_torch.models.layers import (COMPUTE_DTYPE, dense, dense_init,
                                       draw_normal, gated_linear_attention,
                                       gelu_tanh, gla_step, rmsnorm,
                                       rmsnorm_init, silu, softplus)
from repro_torch.models.mamba2 import _causal_conv


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    n_heads: int = 4
    expand: int = 2          # mLSTM up-projection
    d_conv: int = 4
    ffn_factor: float = 4.0 / 3.0   # sLSTM FFN

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


def _bf16_scale(hd: int, dtype) -> float:
    """``hd ** -0.5`` as a weakly typed scalar times a ``dtype`` array:
    rounded to ``dtype`` first."""
    return float(torch.tensor(hd ** -0.5, dtype=dtype))


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_init(key: torch.Tensor, cfg: XLSTMConfig, device=None,
               dtype=COMPUTE_DTYPE) -> Dict:
    ks = jaxrand.split(key, 8)
    dm, di = cfg.d_model, cfg.d_inner

    def dn(k, d_in, d_out):
        return dense_init(k, d_in, d_out, device=device, dtype=dtype)
    return {
        "norm": rmsnorm_init(dm, device),
        "up_l": dn(ks[0], dm, di),               # main path
        "up_r": dn(ks[1], dm, di),               # gate path
        "conv_w": draw_normal(ks[2], (cfg.d_conv, di), 0.2, device, dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "wq": dn(ks[3], di, di),
        "wk": dn(ks[4], di, di),
        "wv": dn(ks[5], di, di),
        "w_if": dn(ks[6], di, 2 * cfg.n_heads),  # input + forget gates
        "skip": torch.ones((di,), dtype=dtype, device=device),
        "out_norm": rmsnorm_init(di, device),
        "down": dn(ks[7], di, dm),
    }


def _mlstm_gates(p, xc, cfg: XLSTMConfig):
    gf = dense(p["w_if"], xc).float()
    i_pre, f_pre = torch.chunk(gf, 2, dim=-1)          # (B,T,H)
    log_f = -softplus(-f_pre)                          # log sigmoid(f)
    i_gate = torch.exp(torch.clamp_max(i_pre, 0.0))    # stabilized exp
    return log_f, i_gate


def _mlstm_out(p, cfg: XLSTMConfig, x, y, xc, right):
    y = rmsnorm(p["out_norm"], y) + xc * p["skip"].to(x.dtype)
    return x + dense(p["down"], y * right)


def mlstm_apply(p: Dict, cfg: XLSTMConfig, x: torch.Tensor,
                chunk: int = 128) -> torch.Tensor:
    b, t, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    xn = rmsnorm(p["norm"], x)
    left = dense(p["up_l"], xn)
    right = silu(dense(p["up_r"], xn))
    # causal conv on the main path (Mamba2's, the same taps and rounding)
    xc, _ = _causal_conv(left, p["conv_w"], p["conv_b"])

    q = dense(p["wq"], xc).reshape(b, t, h, hd)
    kk = dense(p["wk"], xc).reshape(b, t, h, hd) * _bf16_scale(hd, xc.dtype)
    v = dense(p["wv"], left).reshape(b, t, h, hd)
    log_f, i_gate = _mlstm_gates(p, xc, cfg)

    padn = (-t) % chunk
    if padn:
        def z2(a):
            return torch.nn.functional.pad(
                a, (0, 0) * (a.dim() - 2) + (0, padn))
        q, kk, v, log_f, i_gate = map(z2, (q, kk, v, log_f, i_gate))
    y = gated_linear_attention(q, kk, v, log_f, i_gate, chunk=chunk)
    y = y[:, :t].reshape(b, t, cfg.d_inner)
    return _mlstm_out(p, cfg, x, y, xc, right)


def mlstm_init_cache(cfg: XLSTMConfig, batch: int, dtype=torch.float32,
                     device=None) -> Dict:
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, cfg.n_heads, cfg.head_dim,
                              cfg.head_dim), dtype=torch.float32,
                             device=device),
    }


def mlstm_step(p: Dict, cfg: XLSTMConfig, x: torch.Tensor, cache: Dict
               ) -> Tuple[torch.Tensor, Dict]:
    b = x.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    xn = rmsnorm(p["norm"], x)
    left = dense(p["up_l"], xn)
    right = silu(dense(p["up_r"], xn))
    xc, new_conv = _causal_conv(left, p["conv_w"], p["conv_b"],
                                state=cache["conv"])

    q = dense(p["wq"], xc).reshape(b, h, hd)
    kk = dense(p["wk"], xc).reshape(b, h, hd) * _bf16_scale(hd, xc.dtype)
    v = dense(p["wv"], left).reshape(b, h, hd)
    log_f, i_gate = _mlstm_gates(p, xc, cfg)
    y, new_state = gla_step(q, kk, v, log_f[:, 0], i_gate[:, 0],
                            cache["state"])
    y = y.reshape(b, 1, cfg.d_inner)
    return _mlstm_out(p, cfg, x, y, xc, right), {"conv": new_conv,
                                                 "state": new_state}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_init(key: torch.Tensor, cfg: XLSTMConfig, device=None,
               dtype=COMPUTE_DTYPE) -> Dict:
    ks = jaxrand.split(key, 4)
    dm = cfg.d_model
    hd = dm // cfg.n_heads
    d_ff = int(cfg.ffn_factor * dm)
    return {
        "norm": rmsnorm_init(dm, device),
        "w_gates": dense_init(ks[0], dm, 4 * dm, device=device,
                              dtype=dtype),                  # i, f, z, o
        # per-head recurrent matrices (block-diagonal R), float32
        "r_gates": draw_normal(ks[1], (cfg.n_heads, hd, 4 * hd),
                               hd ** -0.5, device, torch.float32),
        "out_norm": rmsnorm_init(dm, device),
        "ffn_up": dense_init(ks[2], dm, 2 * d_ff, device=device,
                             dtype=dtype),                   # gated
        "ffn_down": dense_init(ks[3], d_ff, dm, device=device, dtype=dtype),
    }


def slstm_cell(p, cfg: XLSTMConfig, wx: torch.Tensor, state):
    """wx: (B, 4*D) precomputed input contribution; state: (h, c, n, m),
    each (B, D) float32."""
    h_prev, c_prev, n_prev, m_prev = state
    b = h_prev.shape[0]
    nh, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    rh = torch.einsum("bhd,hde->bhe", h_prev.reshape(b, nh, hd),
                      p["r_gates"].float()).reshape(b, 4 * cfg.d_model)
    z_all = (wx + rh).float()
    i_pre, f_pre, z_pre, o_pre = torch.chunk(z_all, 4, dim=-1)
    # stabilized exponential gating (xLSTM eq. 15-17)
    log_f = -softplus(-f_pre)
    m = torch.maximum(log_f + m_prev, i_pre)
    i_g = torch.exp(i_pre - m)
    f_g = torch.exp(log_f + m_prev - m)
    z = torch.tanh(z_pre)
    o = torch.sigmoid(o_pre)
    c = f_g * c_prev + i_g * z
    n = f_g * n_prev + i_g
    h = o * c / torch.clamp_min(torch.abs(n), 1.0)
    return (h, c, n, m)


def _slstm_ffn(p, x: torch.Tensor, hs: torch.Tensor) -> torch.Tensor:
    y = rmsnorm(p["out_norm"], hs.to(x.dtype))
    up, gate = torch.chunk(dense(p["ffn_up"], y), 2, dim=-1)
    return x + dense(p["ffn_down"], gelu_tanh(gate) * up)


def slstm_apply(p: Dict, cfg: XLSTMConfig, x: torch.Tensor) -> torch.Tensor:
    b, t, _ = x.shape
    xn = rmsnorm(p["norm"], x)
    wx = dense(p["w_gates"], xn)                     # (B,T,4D)
    cache = slstm_init_cache(cfg, b, device=x.device)
    state = (cache["h"], cache["c"], cache["n"], cache["m"])
    hs = []
    for i in range(t):
        state = slstm_cell(p, cfg, wx[:, i], state)
        hs.append(state[0])
    return _slstm_ffn(p, x, torch.stack(hs, dim=1))


def slstm_init_cache(cfg: XLSTMConfig, batch: int, device=None) -> Dict:
    dm = cfg.d_model

    def z():
        return torch.zeros((batch, dm), dtype=torch.float32, device=device)
    return {"h": z(), "c": z(), "n": z(), "m": z() - 1e9}


def slstm_step(p: Dict, cfg: XLSTMConfig, x: torch.Tensor, cache: Dict
               ) -> Tuple[torch.Tensor, Dict]:
    xn = rmsnorm(p["norm"], x)
    wx = dense(p["w_gates"], xn)[:, 0]
    state = (cache["h"], cache["c"], cache["n"], cache["m"])
    h, c, n, m = slstm_cell(p, cfg, wx, state)
    return _slstm_ffn(p, x, h[:, None, :]), {"h": h, "c": c, "n": n,
                                             "m": m}
