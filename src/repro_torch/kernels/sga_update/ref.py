"""Plain PyTorch versions of the SGA kernels (their oracles).

``sga_update_ref`` ports ``repro/kernels/sga_update/ref.py``: Algorithm
1's small-gradient bank, the SGD step and the Q1.7 round/clip,
elementwise.  ``lr`` and ``g_th`` broadcast against the operands: scalars
for the flat update, (B, 1) columns for the row-batched one.
``torch.round`` rounds half to even like ``jnp.round``.

``head_train_rows_ref`` is a tick's whole head-training budget, epoch by
epoch, as ``head_train_rows`` runs it in one launch.  Its batch means are
the sums times the float32 reciprocal of N, as XLA compiles the
reference's jitted ``/ n`` and as the kernel computes them
(``core.means``).
"""

from __future__ import annotations

import torch

from repro_torch.core import means


def sga_update_ref(w: torch.Tensor, g: torch.Tensor, accum: torch.Tensor,
                   lr: torch.Tensor, g_th: torch.Tensor,
                   w_scale: float = 1.0 / 128, w_max: float = 127.0 / 128,
                   a_scale: float = 2.0 ** -15):
    """Returns (new_w, new_accum)."""
    small = torch.abs(g) < g_th
    banked = torch.round((accum + torch.where(small, g, 0.0)) / a_scale) \
        * a_scale
    fire = small & (torch.abs(banked) >= g_th)
    g_upd = torch.where(small, torch.where(fire, banked, 0.0), g)
    new_a = torch.where(fire, 0.0, banked)
    new_w = w - lr * g_upd
    new_w = torch.clamp(torch.round(new_w / w_scale) * w_scale,
                        -w_max - w_scale, w_max)
    return new_w, new_a


def _quant(x: torch.Tensor, fmt) -> torch.Tensor:
    """clamp(round(x / scale), qmin, qmax) * scale for fmt = (scale, qmin,
    qmax); the scale is a power of two, so x * (1 / scale) is the same
    quotient."""
    scale, qmin, qmax = fmt
    return torch.clamp(torch.round(x * (1.0 / scale)), qmin, qmax) * scale


def error_exponent(err: torch.Tensor, mode: str,
                   max_exponent) -> torch.Tensor:
    """Eq (2)'s s = ceil / floor(log2(1 / max|err|)) read from the binary
    exponent of the float32 quotient (``frexp``), clamped by
    ``max_exponent``; 0 for a zero error.  Equals the reference's log2 on
    every value the quantized loop can meet (k / 256)."""
    m = torch.amax(torch.abs(err))
    inv = 1.0 / torch.clamp(m, min=torch.finfo(torch.float32).tiny)
    mant, ex = torch.frexp(inv)            # inv = mant * 2**ex, mant in [.5, 1)
    s = ex - 1 if mode == "floor" else torch.where(mant == 0.5, ex - 1, ex)
    if max_exponent is not None:
        s = torch.clamp(s, max=int(max_exponent))
    return torch.where(m > 0, s, torch.zeros_like(s))


def head_train_rows_ref(w, b, accum_w, accum_b, feats, onehot, start,
                        epochs, lut: torch.Tensor, spec) -> None:
    """The plain version of ``head_train_rows``: for each row r, epochs
    ``start[r] .. start[r] + epochs[r] - 1`` of the quantized head loop
    (``core.onchip_training.epoch_grads`` without RGP, then the SGA update
    of ``sga_update_ref``) on (w[r], b[r], accum_w[r], accum_b[r]), written
    back in place.  ``spec`` is an ``ops.HeadTrainSpec``."""
    for r in range(len(w)):
        wr, br, awr, abr = w[r], b[r], accum_w[r], accum_b[r]
        f, oh = feats[r], onehot[r]
        inv_n = means.reciprocal(f.shape[0])
        for e in range(start[r], start[r] + epochs[r]):
            lr = spec.lr(e)
            lr_t = torch.tensor(lr, device=f.device)
            th_t = torch.tensor(spec.threshold(lr), device=f.device)
            z = _quant(f @ wr + br, spec.act)
            z = z - torch.amax(z, dim=-1, keepdim=True)
            idx = torch.clamp(torch.round((z - spec.lut_min)
                                          * (1.0 / spec.lut_step)),
                              0, lut.shape[0] - 1)
            ev = lut[idx.to(torch.int64)]
            den = torch.sum(ev, dim=-1, keepdim=True)
            p = torch.round(ev / torch.clamp(den, min=1.0 / 256.0)
                            * 256.0) / 256.0
            err = p - oh
            if spec.error_scale is not None:
                scale = torch.tensor(spec.error_scale, dtype=torch.float32,
                                     device=f.device)
            else:
                scale = torch.exp2(error_exponent(
                    err, spec.error_scale_mode,
                    spec.error_scale_max_exponent).to(torch.float32))
            err = _quant(err * scale, spec.error)
            gw = _quant(f.T @ err * inv_n, spec.grad)
            gb = _quant(torch.sum(err, dim=0) * inv_n, spec.grad)
            wr, awr = sga_update_ref(wr, gw, awr, lr_t, th_t,
                                     w_scale=spec.w_scale, w_max=spec.w_max,
                                     a_scale=spec.a_scale)
            br, abr = sga_update_ref(br, gb, abr, lr_t, th_t,
                                     w_scale=spec.w_scale, w_max=spec.w_max,
                                     a_scale=spec.a_scale)
        w[r].copy_(wr)
        b[r].copy_(br)
        accum_w[r].copy_(awr)
        accum_b[r].copy_(abr)
