"""On-chip learning for model customization (paper §III, §V-C).

Port of ``repro/core/onchip_training.py``.  Fine-tunes ONLY the final
classifier layer, entirely in fixed point:

    weight/gradient/error : Q1.7      activation : Q1.3.4
    SGA accumulators      : 16-bit fixed point (Q1.15)

with the paper's error scaling (Eq 1-2) and Small Gradient Accumulation
(Algorithm 1, Eq 3), and the hardware loss path: a LUT exp for the softmax
and an 8-bit division (§V-C).

Every step lies on a fixed-point grid, so the loop is bit-identical to the
reference in any summation order: Q1.3.4 x Q1.7 products lie on a 2**-11
grid and their sums stay far below 2**13, the LUT softmax sums 1/256-grid
values and divides once (an IEEE division, as in the reference), and the
batch means are the sums times the float32 reciprocal of N, as XLA
compiles the reference's jitted ``/ n`` (``core.means``).  The learning-rate
schedule is computed in float32 on the host (powers of two, exact), and
``lr * g`` is one rounded product followed by one rounded difference, as
in the reference.

Random Gradient Prediction (Eq 4, ``rgp=True``) adds quantized normal
noise to the gradients, drawn with ``core.jaxrand`` down the reference's
key chain (``HeadState.key`` from ``PRNGKey(cfg.seed)``, a three-way
``split`` per epoch), so an RGP fine-tune is the reference's bit for bit.

``head_train_spec`` and ``fused_head_route`` describe the loop to the
fused kernel that runs a tick's whole budget of epochs in one launch
(``kernels.sga_update.ops.head_train_batch``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import jaxrand, means
from repro_torch.core.quantize import (ACCUM_Q, ACT_Q, ERROR_Q, GRAD_Q,
                                       WEIGHT_Q, QFormat,
                                       error_scale_exponent)
from repro_torch.kernels import resolve_device
from repro_torch.kernels.sga_update import ops as sga_ops

# ---------------------------------------------------------------------------
# Hardware softmax: LUT exp + 8-bit division (paper §V-C)
# ---------------------------------------------------------------------------

# The FC output is Q1.3.4: after max-subtraction z' lies on the 1/16 grid
# in [-15.9375, 0], exactly 256 points -> one 256-entry LUT of Q0.8
# fractions.  Built once on the CPU and copied to each device it is used
# on, so every device reads the same table.
_LUT_STEP = ACT_Q.scale                      # 1/16
_LUT_SIZE = 256
_LUT_MIN = -(_LUT_SIZE - 1) * _LUT_STEP       # -15.9375
_EXP_LUT = torch.round(torch.exp(
    torch.arange(_LUT_SIZE, dtype=torch.int32) * _LUT_STEP + _LUT_MIN)
    * 256.0) / 256.0
_LUTS: Dict[torch.device, torch.Tensor] = {}


def train_lut(device: torch.device) -> torch.Tensor:
    """The softmax LUT on ``device`` (also the fused kernel's operand)."""
    lut = _LUTS.get(device)
    if lut is None:
        lut = _LUTS[device] = _EXP_LUT.to(device)
    return lut


def lut_softmax(logits_q: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis through the hardware LUT path.
    ``logits_q`` must already be on the Q1.3.4 grid; the division is
    rounded to 8 fractional bits (the fixed 8-bit divider)."""
    z = logits_q - torch.amax(logits_q, dim=-1, keepdim=True)
    idx = torch.clamp(torch.round((z - _LUT_MIN) / _LUT_STEP), 0,
                      _LUT_SIZE - 1)
    e = train_lut(logits_q.device)[idx.to(torch.int64)]
    denom = torch.sum(e, dim=-1, keepdim=True)
    p = e / torch.clamp(denom, min=1.0 / 256.0)
    return torch.round(p * 256.0) / 256.0


# ---------------------------------------------------------------------------
# Small Gradient Accumulation (Algorithm 1)
# ---------------------------------------------------------------------------


def sga_threshold(lr: torch.Tensor,
                  weight_fmt: QFormat = WEIGHT_Q) -> torch.Tensor:
    """Eq (3): G_th = (min(weight)/2) / LR, min(weight) = one weight LSB;
    one float32 division."""
    lr = torch.as_tensor(lr, dtype=torch.float32)
    return (weight_fmt.scale / 2.0) / lr


def sga_step(grad: torch.Tensor, accum: torch.Tensor, g_th: torch.Tensor,
             accum_fmt: QFormat = ACCUM_Q
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One elementwise SGA step (Algorithm 1, magnitude-symmetric form):
    sub-threshold gradients bank into the 16-bit accumulator, and a bank
    that crosses the threshold is released as the update and reset.
    Returns (g_update, new_accum)."""
    small = torch.abs(grad) < g_th
    banked = accum_fmt.quantize(accum + torch.where(small, grad, 0.0))
    fire = small & (torch.abs(banked) >= g_th)
    g_update = torch.where(small, torch.where(fire, banked, 0.0), grad)
    new_accum = torch.where(fire, 0.0, banked)
    return g_update, new_accum


# ---------------------------------------------------------------------------
# The quantized last-layer fine-tuning loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OnChipTrainConfig:
    epochs: int = 1000
    lr_init: float = 1.0 / 16.0          # paper §VI-A3
    lr_min: float = 1.0 / 128.0
    lr_halve_every: int = 10
    error_scaling: bool = True
    # None -> dynamic Eq(2) per batch; the paper's chip fixes 1.375
    fixed_error_scale: Optional[float] = None
    # dynamic-exponent variant (ignored with fixed_error_scale): 'ceil' is
    # the paper's Eq(2), 'floor' keeps one bit of headroom;
    # error_scale_max_exponent clamps the shift from above
    error_scale_mode: str = "ceil"
    error_scale_max_exponent: Optional[int] = None
    sga: bool = True
    rgp: bool = False
    rgp_lambda: float = 8.0
    quantized: bool = True               # False -> full-precision baseline
    seed: int = 0
    weight_fmt: QFormat = WEIGHT_Q
    act_fmt: QFormat = ACT_Q
    grad_fmt: QFormat = GRAD_Q
    error_fmt: QFormat = ERROR_Q
    accum_fmt: QFormat = ACCUM_Q


class HeadState(NamedTuple):
    w: torch.Tensor          # (D, C) on the weight grid
    b: torch.Tensor          # (C,)
    accum_w: torch.Tensor    # SGA banks
    accum_b: torch.Tensor
    key: torch.Tensor        # (2,) jaxrand key of the RGP draws


def lr_schedule(cfg: OnChipTrainConfig, epoch: int,
                device=None) -> torch.Tensor:
    """Step-halving learning rate at ``epoch``, floored at ``lr_min``: a
    float32 scalar on ``device`` (the CPU for ``None``).  Computed in
    float32 as the reference does."""
    lr = np.float32(cfg.lr_init) * np.float32(0.5) ** np.float32(
        int(epoch) // cfg.lr_halve_every)
    lr = np.maximum(lr, np.float32(cfg.lr_min))
    return torch.tensor(lr, dtype=torch.float32, device=device)


def head_logits(features_q: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                cfg: OnChipTrainConfig) -> torch.Tensor:
    """8-bit FC forward; output requantized onto the activation grid."""
    z = features_q @ w + b
    return cfg.act_fmt.quantize(z) if cfg.quantized else z


def rgp_noise(key: torch.Tensor, shape, lam: float,
              fmt: QFormat = GRAD_Q) -> torch.Tensor:
    """Eq (4): quantize(N(0, 1) / lambda) on the gradient grid."""
    return fmt.quantize(jaxrand.normal(key, tuple(shape)) / lam)


def epoch_grads(state: HeadState, epoch: int, features_q: torch.Tensor,
                labels_1hot: torch.Tensor, cfg: OnChipTrainConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                           torch.Tensor]:
    """The pre-optimizer half of one epoch: forward, hardware softmax,
    error scaling (Eq 1-2), gradient quantization and, with ``rgp``, the
    Random Gradient Prediction noise.  Returns (gw, gb, lr, key):
    everything ``apply_update`` (or the batched ``sga_update`` kernel)
    needs to transition the head state.  The batch means are the sums
    times the float32 reciprocal of N, as the reference's jitted ``/ n``
    compiles (``core.means``)."""
    inv_n = means.reciprocal(features_q.shape[0])
    lr = lr_schedule(cfg, epoch, device=features_q.device)

    logits = head_logits(features_q, state.w, state.b, cfg)
    if cfg.quantized:
        probs = lut_softmax(logits)
    else:
        probs = torch.softmax(logits, dim=-1)
    err = probs - labels_1hot                       # dCE/dlogits

    if cfg.quantized:
        if cfg.error_scaling:
            if cfg.fixed_error_scale is not None:
                scale = torch.tensor(cfg.fixed_error_scale,
                                     dtype=torch.float32,
                                     device=err.device)
            else:
                scale = torch.exp2(error_scale_exponent(
                    err, mode=cfg.error_scale_mode,
                    max_exponent=cfg.error_scale_max_exponent
                ).to(torch.float32))
        else:
            scale = torch.tensor(1.0, dtype=torch.float32, device=err.device)
        err = cfg.error_fmt.quantize(err * scale)
        # accumulated sample by sample into the gradient SRAM; the batch
        # mean is what the scaling factor was calibrated against (§V-C)
        gw = cfg.grad_fmt.quantize(features_q.T @ err * inv_n)
        gb = cfg.grad_fmt.quantize(torch.sum(err, dim=0) * inv_n)
    else:
        gw = features_q.T @ err * inv_n
        gb = torch.sum(err, dim=0) * inv_n

    key = state.key
    if cfg.rgp and cfg.quantized:
        key, k1, k2 = jaxrand.split(key, 3)
        gw = cfg.grad_fmt.quantize(gw + rgp_noise(k1, gw.shape,
                                                  cfg.rgp_lambda,
                                                  cfg.grad_fmt))
        gb = cfg.grad_fmt.quantize(gb + rgp_noise(k2, gb.shape,
                                                  cfg.rgp_lambda,
                                                  cfg.grad_fmt))
    return gw, gb, lr, key


def apply_update(state: HeadState, gw: torch.Tensor, gb: torch.Tensor,
                 lr: torch.Tensor, key, cfg: OnChipTrainConfig) -> HeadState:
    """The optimizer half of one epoch: SGA banking (Alg 1) + SGD step +
    weight quantization, in plain tensor ops (the batched customization
    path runs the same transition through the ``sga_update`` kernel)."""
    accum_w, accum_b = state.accum_w, state.accum_b
    if cfg.sga and cfg.quantized:
        g_th = sga_threshold(lr, cfg.weight_fmt)
        gw, accum_w = sga_step(gw, accum_w, g_th, cfg.accum_fmt)
        gb, accum_b = sga_step(gb, accum_b, g_th, cfg.accum_fmt)

    if cfg.quantized:
        w = cfg.weight_fmt.quantize(state.w - lr * gw)
        b = cfg.weight_fmt.quantize(state.b - lr * gb)
    else:
        w = state.w - lr * gw
        b = state.b - lr * gb
    return HeadState(w, b, accum_w, accum_b, key)


def _tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def finetune_init(features, labels, w0, b0, cfg: OnChipTrainConfig,
                  num_classes: Optional[int] = None, device=None
                  ) -> Tuple[HeadState, torch.Tensor, torch.Tensor]:
    """Quantize the feature buffer and the initial head and build the
    optimizer state on ``device`` (``None`` means CUDA).  Returns (state,
    features_q, labels_1hot) for ``finetune_epochs``."""
    dev = resolve_device(device)
    features = _tensor(features, dev)
    labels = _tensor(labels, dev, torch.int64)
    w0, b0 = _tensor(w0, dev), _tensor(b0, dev)
    c = num_classes or w0.shape[-1]
    labels_1hot = torch.nn.functional.one_hot(labels, c).to(torch.float32)
    feats = cfg.act_fmt.quantize(features) if cfg.quantized else features
    w = cfg.weight_fmt.quantize(w0) if cfg.quantized else w0
    b = cfg.weight_fmt.quantize(b0) if cfg.quantized else b0
    state = HeadState(w=w, b=b, accum_w=torch.zeros_like(w),
                      accum_b=torch.zeros_like(b),
                      key=jaxrand.PRNGKey(cfg.seed, device=dev))
    return state, feats, labels_1hot


def finetune_epochs(state: HeadState, features_q: torch.Tensor,
                    labels_1hot: torch.Tensor, cfg: OnChipTrainConfig,
                    start_epoch: int, num_epochs: int) -> HeadState:
    """Run ``num_epochs`` full-batch epochs from ``start_epoch``.  The
    epoch index drives the LR schedule, so chunked calls compose
    bit-identically to one call."""
    for e in range(start_epoch, start_epoch + num_epochs):
        gw, gb, lr, key = epoch_grads(state, e, features_q, labels_1hot,
                                      cfg)
        state = apply_update(state, gw, gb, lr, key, cfg)
    return state


def quantized_head_finetune(features, labels, w0, b0,
                            cfg: OnChipTrainConfig,
                            num_classes: Optional[int] = None, device=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Customize a classifier head: features (N, D) from the SRAM feature
    buffer, labels (N,) class ids.  Returns the fine-tuned (w, b) on the
    weight grid, on ``device`` (``None`` means CUDA).  Equals
    ``finetune_init`` + ``finetune_epochs(0, cfg.epochs)``."""
    state, feats, labels_1hot = finetune_init(features, labels, w0, b0,
                                              cfg, num_classes, device)
    state = finetune_epochs(state, feats, labels_1hot, cfg, 0, cfg.epochs)
    return state.w, state.b


def head_accuracy(features: torch.Tensor, labels: torch.Tensor,
                  w: torch.Tensor, b: torch.Tensor,
                  cfg: OnChipTrainConfig) -> torch.Tensor:
    feats = cfg.act_fmt.quantize(features) if cfg.quantized else features
    logits = head_logits(feats, w, b, cfg)
    labels = labels.to(logits.device)
    return means.mean((torch.argmax(logits, -1) == labels).to(torch.float32),
                      0)


# ---------------------------------------------------------------------------
# The fused route: a tick's epochs in one kernel launch
# ---------------------------------------------------------------------------


def _max_code(fmt: QFormat) -> int:
    return max(-fmt.qmin, fmt.qmax)


def head_train_exact(cfg: OnChipTrainConfig, n: int, d: int) -> bool:
    """Whether every sum of the quantized head loop is exact in float32 in
    any order, for n utterances of d features: the forward's
    d max|act| max|w| + max|b| and the gradient's n max|act| max|err|,
    each counted in units of its product grid, are at most 2**24.  The
    paper formats (Q1.3.4 activations, Q1.7 weights and errors) hold it
    at d = 576 for n up to 1024."""
    a, w, e = (_max_code(f) for f in (cfg.act_fmt, cfg.weight_fmt,
                                      cfg.error_fmt))
    forward = d * a * w + w * 2 ** cfg.act_fmt.frac_bits
    gradient = n * a * e
    return max(forward, gradient) <= 2 ** 24


def fused_head_route(cfg: OnChipTrainConfig, n: int, d: int, c: int
                     ) -> bool:
    """The rule that sends a session's training ticks to the fused kernel
    (one launch per tick for all such sessions) rather than epoch by
    epoch: a quantized loop with SGA and without RGP (whose noise is drawn
    through ``core.jaxrand`` between the halves of an epoch), inside the
    exactness bound (``head_train_exact``), whose state fits a block's
    shared memory on an H100.  It reads the configuration and the buffer's
    shape only, never the device or the data: the other sessions take the
    per-epoch ``sga_update_rows`` launch, bitwise the same loop."""
    return (cfg.quantized and cfg.sga and not cfg.rgp
            and head_train_exact(cfg, n, d)
            and sga_ops.head_train_smem(d, c, n) <= sga_ops.HEAD_SMEM_BYTES)


def head_train_spec(cfg: OnChipTrainConfig) -> sga_ops.HeadTrainSpec:
    """The fused kernel's launch constants for ``cfg`` (sessions with
    equal specs share a launch)."""
    fmt = lambda f: (f.scale, f.qmin, f.qmax)
    return sga_ops.HeadTrainSpec(
        act=fmt(cfg.act_fmt), error=fmt(cfg.error_fmt),
        grad=fmt(cfg.grad_fmt), w_scale=cfg.weight_fmt.scale,
        w_max=cfg.weight_fmt.max_value, a_scale=cfg.accum_fmt.scale,
        lr_init=cfg.lr_init, lr_min=cfg.lr_min,
        lr_halve_every=cfg.lr_halve_every,
        error_scale=(cfg.fixed_error_scale if cfg.error_scaling else 1.0),
        error_scale_mode=cfg.error_scale_mode,
        error_scale_max_exponent=cfg.error_scale_max_exponent,
        lut_min=_LUT_MIN, lut_step=_LUT_STEP)

