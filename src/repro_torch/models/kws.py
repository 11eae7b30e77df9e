"""The paper's IMC-aware binary KWS network (paper §II, §IV).

Port of ``repro/models/kws.py``:

  L1  binarized sinc conv  1 -> 24ch, k=15, stride 4          (digital)
  L2  binary group conv   24 -> 96,  k=3, cpg=24, pool 2      (IMC)
  L3  binary group conv   96 -> 192, k=3, cpg=24, pool 2      (IMC)
  L4  binary group conv  192 -> 288, k=3, cpg=24              (IMC)
  L5  binary group conv  288 -> 384, k=3, cpg=24, pool 2      (IMC)
  L6  binary group conv  384 -> 576, k=3, cpg=24, pool 2      (IMC)
  GAP -> ACT_Q -> FC 576 -> 10                                 (digital)

Three forwards: ``forward_train``, the float QAT path (straight-through
binarization, annealed ``tanh`` or surrogate-gradient phases, optional
injected chip offsets and SA noise for the noise-aware recovery
fine-tune); ``forward_eval``, the float path with frozen statistics; and
``hw_forward``, the count-exact silicon path over the parameters that
``fold_params`` folds.  With ``use_kernel=True`` every IMC layer
(conv1..conv5) of ``hw_forward`` runs as one launch of the fused kernel
(``repro_torch.kernels.imc_mav``), on a CUDA device the hand-written
Hopper kernel.  The float path's convolution is the plain per-tap
product of ``core.imc.binary_group_conv_counts`` (the reference's is a
plain XLA convolution, no Pallas kernel), differentiated by autograd.

The float path follows the reference as XLA compiles it under ``jit``:
means are sums times float32 reciprocals (``core.means``), and the fixed
normalization divides by ``sqrt(fan_in)`` as a product with its float32
reciprocal.  ``init_params`` draws from a ``core.jaxrand`` key exactly as
the reference draws from a ``jax.random`` key, so one seed gives both
packages the same net.

Layouts are the JAX package's: activations (B, T, C), weights
(K, C_in // groups, C_out).  ``hw_params_from_numpy`` and
``params_from_numpy`` carry the reference's parameter trees across (as
numpy leaves), which is how the tests feed both packages the same net.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import imc, jaxrand, means
from repro_torch.core.sa_noise import SANoiseField, field_window_noise
from repro_torch.core.binary import (binarize, binarize_sg, channel_shuffle,
                                     or_maxpool, rsign)
from repro_torch.core.energy import CYCLES_PER_DECISION
from repro_torch.core.quantize import ACT_Q, WEIGHT_Q
from repro_torch.kernels import resolve_device
from repro_torch.kernels.imc_mav import ops as mav_ops


@dataclasses.dataclass(frozen=True)
class KWSConfig:
    channels: Tuple[int, ...] = (24, 96, 192, 288, 384, 576)
    kernels: Tuple[int, ...] = (15, 3, 3, 3, 3, 3)
    strides: Tuple[int, ...] = (4, 1, 1, 1, 1, 1)
    pools: Tuple[int, ...] = (1, 2, 2, 1, 2, 2)
    channels_per_group: int = 24
    num_classes: int = 10
    sample_len: int = 16_000
    sample_rate: int = 16_000
    bias_mapping: str = "best"          # paper §IV-A: pick best of 4
    bn_momentum: float = 0.9
    # 'fixed': the in-memory-BN threshold semantics the paper net uses;
    # 'batch': standard BN statistics
    bn_mode: str = "fixed"

    @property
    def num_conv_layers(self) -> int:
        return len(self.channels)

    def groups(self, layer: int) -> int:
        if layer == 0:
            return 1
        return self.channels[layer - 1] // self.channels_per_group

    def imc_layer_names(self):
        """conv1..conv5: the IMC-mapped layers (conv0 = digital sinc)."""
        return [f"conv{i}" for i in range(1, self.num_conv_layers)]


PAPER_KWS = KWSConfig()


class KWSState(NamedTuple):
    """BN running statistics."""
    mean: Dict[str, torch.Tensor]
    var: Dict[str, torch.Tensor]


def xla_linspace(start: float, stop: float, n: int) -> torch.Tensor:
    """``jnp.linspace(start, stop, n)`` in float32 as XLA's CPU code gives
    it (CPU tensor): element i < n - 1 is ``start * (1 - i * r) + i * (stop
    * r)`` with r = f32(1 / (n - 1)), the second product fused into the sum
    (an FMA), and the last is ``stop``.  Up to 34 points XLA unrolls the
    loop and element 1 fuses the first product instead."""
    s, e = np.float32(start), np.float32(stop)
    if n == 1:
        return torch.tensor([float(s)])
    r = np.float32(1.0) / np.float32(n - 1)
    i = torch.arange(n - 1, dtype=torch.float32)
    er = float(e * r)
    sub = 1.0 - i * float(r)
    out = jaxrand.fma(i, er, float(s) * sub)
    if 2 < n <= 34:
        out[1] = jaxrand.fma(torch.tensor(float(s)), float(sub[1]), er)
    return torch.cat([out, torch.tensor([float(e)])])


def init_params(key: torch.Tensor, cfg: KWSConfig = PAPER_KWS,
                device=None) -> Dict:
    """Float parameters drawn from the ``jaxrand`` key ``key`` as the
    reference draws them from a ``jax.random`` key (a ``split`` into one
    key per conv layer plus one, ``normal`` draws scaled by 0.1 for the
    binary layers' latent weights and by 1 / sqrt(d) for the FC), so a
    seed gives the reference's net bit for bit, on ``device`` (the draws
    are made there: ``jaxrand`` gives the same bits on every device).  The
    sinc band edges are ``jnp.linspace``'s (``xla_linspace``)."""
    dev = resolve_device(device)
    keys = jaxrand.split(key.to(dev), cfg.num_conv_layers + 1)
    n0 = cfg.channels[0]
    params: Dict = {
        "conv0": {
            "low_hz": xla_linspace(700.0, 6200.0, n0),
            "band_hz": torch.full((n0,), 300.0) + xla_linspace(0.0, 900.0,
                                                               n0),
            "gamma": torch.ones(n0), "beta": torch.full((n0,), -0.6),
            "offset": torch.zeros(n0),
        }
    }
    for i in range(1, cfg.num_conv_layers):
        cin_g = cfg.channels[i - 1] // cfg.groups(i)
        shape = (cfg.kernels[i], cin_g, cfg.channels[i])
        params[f"conv{i}"] = {
            "w": jaxrand.normal(keys[i], shape).cpu() * 0.1,
            "gamma": torch.ones(cfg.channels[i]),
            "beta": torch.full((cfg.channels[i],), -0.25),
            "offset": torch.zeros(cfg.channels[i]),
        }
    d = cfg.channels[-1]
    params["fc"] = {
        "w": jaxrand.normal(keys[-1], (d, cfg.num_classes)).cpu()
        * float(np.float32(1.0) / np.sqrt(np.float32(d))),
        "b": torch.zeros(cfg.num_classes),
    }
    return {name: {k: v.to(dev) for k, v in p.items()}
            for name, p in params.items()}


def init_state(cfg: KWSConfig = PAPER_KWS, device=None) -> KWSState:
    dev = resolve_device(device)
    mean, var = {}, {}
    for i in range(cfg.num_conv_layers):
        c = cfg.channels[i]
        mean[f"conv{i}"] = torch.zeros(c, device=dev)
        if cfg.bn_mode == "fixed":
            # fixed mode normalizes by sqrt(fan_in), which the stats carry
            cin = 1 if i == 0 else cfg.channels[i - 1]
            fan_in = (cin // cfg.groups(i)) * cfg.kernels[i]
            var[f"conv{i}"] = torch.full((c,), float(fan_in) - 1e-5,
                                         device=dev)
        else:
            var[f"conv{i}"] = torch.ones(c, device=dev)
    return KWSState(mean=mean, var=var)


def sinc_kernel(low_hz: torch.Tensor, band_hz: torch.Tensor, k: int,
                sample_rate: int) -> torch.Tensor:
    """Band-pass windowed-sinc kernels, (k, 1, C). Binarized by the caller."""
    dev = low_hz.device
    low = torch.abs(low_hz) + 30.0
    high = torch.clamp(low + torch.abs(band_hz), 30.0,
                       sample_rate / 2 - 30.0)
    n = torch.arange(k, device=dev, dtype=torch.float32)
    t = (n - (k - 1) / 2.0) / sample_rate                     # (k,)
    window = 0.54 - 0.46 * torch.cos(2 * math.pi * n / (k - 1))

    def bp(f):
        return 2 * f[:, None] * torch.sinc(2 * f[:, None] * t[None, :])

    h = (bp(high) - bp(low)) * window                         # (C, k)
    h = h / (torch.amax(torch.abs(h), dim=-1, keepdim=True) + 1e-6)
    return h.transpose(0, 1)[:, None, :]                      # (k, 1, C)


# ---------------------------------------------------------------------------
# Float forwards (QAT training / eval)
# ---------------------------------------------------------------------------


def _inv_sqrt(n: int) -> float:
    """f32(1) / f32(sqrt(n)): XLA's constant for ``/ jnp.sqrt(float(n))``."""
    return float(np.float32(1.0) / np.sqrt(np.float32(n)))


def _batchnorm_train(counts, gamma, beta, running_mean, running_var,
                     momentum: float):
    """Batch statistics over (B, T); the means and the variance are
    ``jnp.mean`` / ``jnp.var`` as compiled (``core.means``)."""
    mu = means.mean(counts, (0, 1))
    var = means.mean(torch.square(counts - mu), (0, 1))
    y = gamma * (counts - mu) / torch.sqrt(var + 1e-5) + beta
    new_mean = momentum * running_mean + (1 - momentum) * mu
    new_var = momentum * running_var + (1 - momentum) * var
    return y, new_mean, new_var


def _batchnorm_eval(counts, gamma, beta, mean, var):
    return gamma * (counts - mean) / torch.sqrt(var + 1e-5) + beta


def _pinned_stats(state: KWSState, name: str, fan_in: int):
    """Fixed mode's running statistics: zero mean, variance fan_in - 1e-5
    (what ``fold_params`` needs to fold the fixed normalization)."""
    return (torch.zeros_like(state.mean[name]),
            torch.full_like(state.var[name], float(fan_in)) - 1e-5)


def _float_forward(params, state: KWSState, x: torch.Tensor, cfg: KWSConfig,
                   train: bool,
                   chip_offsets: Optional[Dict[str, torch.Tensor]] = None,
                   sa_noise_std: float = 0.0,
                   rng: Optional[torch.Tensor] = None,
                   soft_alpha: Optional[float] = None):
    """The float path on audio x (B, sample_len): (logits, features, new
    state).  ``soft_alpha``: None is the hard sign with the clipped
    straight-through gradient; a > 0 the annealed ``tanh(a * x)`` for
    weights and activations; a < 0 the hard forward with the surrogate
    gradient of ``binarize_sg(|a|)``, the IMC layers thresholded on the
    exact in-memory bias grid (parity and range, straight through), so
    the trained net is the folded silicon's.  ``chip_offsets`` ({conv_i:
    (C_i,)}) and ``sa_noise_std`` (a normal per count, drawn down a
    ``jaxrand.split`` chain of ``rng``, one key per IMC layer) inject the
    chip's non-idealities into the IMC layers' counts: the noise-aware
    forward of the recovery fine-tune.  ``x`` may be any array-like; it
    is moved to the parameters' device."""
    new_mean, new_var = dict(state.mean), dict(state.var)
    h = as_tensor(x, params["fc"]["w"].device)[..., None]   # (B, T, 1)
    for i in range(cfg.num_conv_layers):
        name = f"conv{i}"
        p = params[name]
        latent = (sinc_kernel(p["low_hz"], p["band_hz"], cfg.kernels[0],
                              cfg.sample_rate) if i == 0 else p["w"])
        if soft_alpha is not None and soft_alpha > 0:
            w = torch.tanh(soft_alpha * latent)        # annealed binarization
        elif soft_alpha is not None and soft_alpha < 0:
            w = binarize_sg(latent, -soft_alpha)
        else:
            w = binarize(latent)
        counts = imc.binary_group_conv_counts(h, w, cfg.groups(i),
                                              cfg.strides[i])
        if chip_offsets is not None and i > 0:
            counts = counts + chip_offsets[name]
        if sa_noise_std > 0.0 and rng is not None and i > 0:
            rng, sub = jaxrand.split(rng)
            counts = counts + sa_noise_std * jaxrand.normal(
                sub, tuple(counts.shape))
        if cfg.bn_mode == "fixed":
            fan_in = w.shape[0] * w.shape[1]
            new_mean[name], new_var[name] = _pinned_stats(state, name,
                                                          fan_in)
            if soft_alpha is not None and soft_alpha < 0 and i > 0:
                # hard phase: threshold on the exact in-memory bias grid
                # (count domain, parity and [-64, 64], straight through)
                g = p["gamma"]
                g_safe = torch.where(torch.abs(g) < 0.05,
                                     torch.sign(g) * 0.05 + 1e-9, g)
                b_eff = (p["beta"] + p["offset"]) * float(
                    np.sqrt(np.float32(fan_in))) / g_safe
                b_q = b_eff + (imc.map_bias(b_eff, cfg.bias_mapping)
                               - b_eff).detach()
                flip = torch.where(g >= 0, 1.0, -1.0)
                h = binarize_sg((counts + b_q) * flip, -soft_alpha)
                h = channel_shuffle(h, cfg.groups(i))
                if cfg.pools[i] > 1:
                    h = or_maxpool(h, cfg.pools[i], axis=1)
                continue
            y = p["gamma"] * counts * _inv_sqrt(fan_in) + p["beta"]
        elif train:
            y, new_mean[name], new_var[name] = _batchnorm_train(
                counts, p["gamma"], p["beta"], state.mean[name],
                state.var[name], cfg.bn_momentum)
        else:
            y = _batchnorm_eval(counts, p["gamma"], p["beta"],
                                state.mean[name], state.var[name])
        if soft_alpha is not None and soft_alpha > 0:
            h = torch.tanh(soft_alpha * (y + p["offset"]))
        elif soft_alpha is not None and soft_alpha < 0:
            h = binarize_sg(y + p["offset"], -soft_alpha)
        else:
            h = rsign(y, p["offset"])
        h = channel_shuffle(h, cfg.groups(i))          # Fig 9 digital block
        if cfg.pools[i] > 1:
            h = or_maxpool(h, cfg.pools[i], axis=1)
    feats = ACT_Q.quantize_ste(means.mean(h, 1))       # GAP, then QAT
    wq = WEIGHT_Q.quantize_ste(params["fc"]["w"])      # 8-bit FC (QAT)
    bq = WEIGHT_Q.quantize_ste(params["fc"]["b"])
    logits = feats @ wq + bq
    return logits, feats, KWSState(mean=new_mean, var=new_var)


def forward_train(params, state: KWSState, x, cfg: KWSConfig = PAPER_KWS,
                  chip_offsets=None, sa_noise_std: float = 0.0, rng=None,
                  soft_alpha=None):
    """The QAT forward: (logits, new BN state)."""
    logits, _, new_state = _float_forward(params, state, x, cfg, True,
                                          chip_offsets, sa_noise_std, rng,
                                          soft_alpha=soft_alpha)
    return logits, new_state


def forward_eval(params, state: KWSState, x, cfg: KWSConfig = PAPER_KWS):
    """The float path with frozen statistics: (logits, features)."""
    logits, feats, _ = _float_forward(params, state, x, cfg, False)
    return logits, feats


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean negative log-likelihood of the integer ``labels``."""
    logp = torch.log_softmax(logits, dim=-1)
    return -means.mean(torch.gather(logp, 1, labels[:, None]), (0, 1))


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Share of rows whose first maximal logit is the label."""
    return means.mean((torch.argmax(logits, -1) == labels).to(torch.float32),
                      0)


# ---------------------------------------------------------------------------
# Hardware folding and the count-exact hardware path
# ---------------------------------------------------------------------------


class HWParams(NamedTuple):
    w_bin: Dict[str, torch.Tensor]    # ±1 weights per conv layer
    bias: Dict[str, torch.Tensor]     # folded count-domain biases
    flip: Dict[str, torch.Tensor]     # BN-decoder sign (±1)
    fc_w: torch.Tensor                # Q1.7
    fc_b: torch.Tensor


class PackedHWParams(NamedTuple):
    """HWParams plus the fused kernel's fold-time packed weights: each IMC
    layer's ±1 weights as the kernel's int8 B rows, (groups, K, cog, 32)
    (``ops.pack_weights_s8``).  Packing once models programming the SRAM
    arrays; everything that takes HWParams takes this too."""

    hw: HWParams
    packed: Dict[str, torch.Tensor]   # conv1..conv5


def as_hw_params(hw) -> Tuple[HWParams, Optional[Dict[str, torch.Tensor]]]:
    """Normalize an HWParams-or-PackedHWParams to (hw, packed-or-None)."""
    if isinstance(hw, PackedHWParams):
        return hw.hw, hw.packed
    return hw, None


def hw_device(hw) -> torch.device:
    return as_hw_params(hw)[0].fc_w.device


def pack_hw_params(hw, cfg: KWSConfig = PAPER_KWS) -> PackedHWParams:
    """Pack every IMC layer's kernel weights once (fold time)."""
    hw, _ = as_hw_params(hw)
    packed = {name: mav_ops.pack_weights_s8(hw.w_bin[name], cfg.groups(i))
              for i, name in enumerate(cfg.imc_layer_names(), start=1)}
    return PackedHWParams(hw=hw, packed=packed)


def fold_params(params, state: KWSState, cfg: KWSConfig = PAPER_KWS,
                macro: imc.IMCMacroConfig = imc.DEFAULT_MACRO,
                bn_constraints: bool = True, fc_quant: bool = True,
                pack: bool = False):
    """Fold BN (+ learnable offsets) into biases, apply the IMC bias grid
    (parity + [-64, 64]) to the IMC layers, a 1/128 grid to the digital
    layer 0, and quantize the FC to Q1.7.  ``bn_constraints=False`` keeps
    the real biases everywhere and ``fc_quant=False`` the float FC (the
    Table III ablation points; the unconstrained fold equals the float
    ``forward_eval``).  ``pack=True`` returns PackedHWParams."""
    w_bin, bias, flip = {}, {}, {}
    for i in range(cfg.num_conv_layers):
        name = f"conv{i}"
        p = params[name]
        if i == 0:
            w = binarize(sinc_kernel(p["low_hz"], p["band_hz"],
                                     cfg.kernels[0], cfg.sample_rate))
        else:
            w = binarize(p["w"])
        w_bin[name] = w
        b, f = imc.fold_bn_to_bias(p["gamma"], p["beta"], state.mean[name],
                                   state.var[name], p["offset"])
        if not bn_constraints:
            bias[name] = b
        elif i == 0:
            bias[name] = torch.round(b * 128.0) / 128.0
        else:
            bias[name] = imc.map_bias(b, cfg.bias_mapping, macro)
        flip[name] = f
    fw, fb = params["fc"]["w"], params["fc"]["b"]
    if fc_quant:
        fw, fb = WEIGHT_Q.quantize(fw), WEIGHT_Q.quantize(fb)
    hw = HWParams(w_bin=w_bin, bias=bias, flip=flip, fc_w=fw, fc_b=fb)
    return pack_hw_params(hw, cfg) if pack else hw


def _leaf(tree, field: str):
    return tree[field] if isinstance(tree, Mapping) else getattr(tree, field)


def as_tensor(v, device) -> torch.Tensor:
    """A float32 tensor on ``device`` from a tensor or an array-like (numpy
    arrays are copied, so read-only ones are fine)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(v, np.float32), device=device)


def hw_params_from_numpy(tree, cfg: KWSConfig = PAPER_KWS,
                         device=None) -> PackedHWParams:
    """The reference's folded ``HWParams`` (numpy leaves; a NamedTuple or a
    dict with fields w_bin/bias/flip/fc_w/fc_b) as the port's packed
    parameters on ``device``."""
    dev = resolve_device(device)
    hw = HWParams(
        *[{k: as_tensor(v, dev) for k, v in _leaf(tree, f).items()}
          for f in ("w_bin", "bias", "flip")],
        fc_w=as_tensor(_leaf(tree, "fc_w"), dev),
        fc_b=as_tensor(_leaf(tree, "fc_b"), dev))
    return pack_hw_params(hw, cfg)


def params_from_numpy(params, state, device=None) -> Tuple[Dict, KWSState]:
    """The reference's float parameters ({layer: {leaf: array}}) and BN
    state (``KWSState`` or a dict with mean/var) as the port's, for
    ``fold_params``."""
    dev = resolve_device(device)
    p = {name: {k: as_tensor(v, dev) for k, v in leaves.items()}
         for name, leaves in params.items()}
    st = KWSState(
        mean={k: as_tensor(v, dev) for k, v in _leaf(state, "mean").items()},
        var={k: as_tensor(v, dev) for k, v in _leaf(state, "var").items()})
    return p, st


def hw_conv_layer(hw: HWParams, i: int, h: torch.Tensor,
                  cfg: KWSConfig = PAPER_KWS, *,
                  packed: Optional[torch.Tensor] = None,
                  chip_offset: Optional[torch.Tensor] = None,
                  sa_key: Optional[torch.Tensor] = None,
                  sa_noise: Optional[torch.Tensor] = None,
                  sa_noise_std: float = 0.0,
                  use_kernel: bool = False) -> torch.Tensor:
    """One conv layer of the hardware path on activations (B, T, C_in)
    (layer 0: (B, T, 1) audio): counts -> mav_sa -> shuffle -> OR-pool.

    Shared by ``hw_forward`` and the streaming path (``serving.stream``),
    so both run the same op chain.  The SA noise is drawn from
    ``sa_key``/``sa_noise_std`` or given as ``sa_noise``, an explicit
    (B, t_conv, C_out) pre-sign operand; layer 0 takes neither noise nor
    offset."""
    name = f"conv{i}"
    if use_kernel and i > 0:
        return mav_ops.fused_conv_mav(
            h, hw.w_bin[name], hw.bias[name], hw.flip[name],
            groups=cfg.groups(i), stride=cfg.strides[i], pool=cfg.pools[i],
            chip_offset=chip_offset, sa_key=sa_key,
            sa_noise_std=sa_noise_std, sa_noise=sa_noise, packed=packed)
    return _sense(hw, i, _counts(hw, i, h, cfg, chip_offset), cfg,
                  sa_key=sa_key, sa_noise_std=sa_noise_std,
                  sa_noise=sa_noise)


def _counts(hw: HWParams, i: int, h: torch.Tensor, cfg: KWSConfig,
            chip_offset: Optional[torch.Tensor]) -> torch.Tensor:
    """Layer i's pre-SA counts, the chip's static offset included."""
    counts = imc.binary_group_conv_counts(h, hw.w_bin[f"conv{i}"],
                                          cfg.groups(i), cfg.strides[i])
    return counts if chip_offset is None else counts + chip_offset


def _sense(hw: HWParams, i: int, counts: torch.Tensor, cfg: KWSConfig, *,
           sa_key: Optional[torch.Tensor] = None, sa_noise_std: float = 0.0,
           sa_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Counts -> mav_sa -> channel shuffle -> OR-pool (Fig 9's digital
    block after each layer)."""
    name = f"conv{i}"
    h = imc.mav_sa(counts, hw.bias[name], hw.flip[name], sa_key=sa_key,
                   sa_noise_std=sa_noise_std, sa_noise=sa_noise)
    h = channel_shuffle(h, cfg.groups(i))
    if cfg.pools[i] > 1:
        h = or_maxpool(h, cfg.pools[i], axis=1)
    return h


def gap_fc(hw: HWParams, h: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """GAP -> ACT_Q -> FC over final activations (B, T, C): (logits,
    features).  The mean is ``jnp.mean``'s as compiled, the sum times the
    float32 reciprocal of T (``core.means``); every FC product then lies
    on a 2**-11 grid, so the logits are exact in any order."""
    feats = ACT_Q.quantize(means.mean(h, 1))
    return feats @ hw.fc_w + hw.fc_b, feats


def hw_forward(hw, x, cfg: KWSConfig = PAPER_KWS,
               chip_offsets: Optional[Dict[str, torch.Tensor]] = None,
               sa_noise_std: float = 0.0,
               rng: Optional[torch.Tensor] = None,
               collect_counts: bool = False,
               use_kernel: bool = False,
               sa_noise: Optional[Dict[str, torch.Tensor]] = None,
               sa_noise_field: Optional[SANoiseField] = None,
               device=None):
    """The silicon path on audio windows x (B, sample_len): integer counts
    -> in-memory BN -> SA sign.  Returns (logits, features) and, with
    ``collect_counts``, the per-layer pre-SA counts (the chip's test mode;
    it runs the unfused path, since the kernel never materializes counts).

    SA noise comes from ``rng``/``sa_noise_std`` (a fresh draw per IMC
    layer down a ``split`` chain of the ``jaxrand`` key ``rng``), from
    ``sa_noise`` (an explicit per-layer dict of (B, t_conv, C_out)
    pre-sign operands) or from ``sa_noise_field`` (a ``core.sa_noise``
    batch of (stream key, window index) pairs, expanded to the explicit
    form: the offline oracle of a noisy stream).  ``chip_offsets``
    ({conv_i: (C_i,)}), ``sa_noise``, ``rng`` and the field's keys are
    moved to ``device``; ``hw`` must already live there."""
    dev = resolve_device(device)
    if hw_device(hw) != dev:
        raise ValueError(f"hw_forward: parameters are on {hw_device(hw)}, "
                         f"not on {dev}")
    if sa_noise_field is not None:
        if sa_noise is not None or rng is not None or sa_noise_std > 0.0:
            raise ValueError("pass only one of rng / sa_noise / "
                             "sa_noise_std / sa_noise_field")
        if sa_noise_field.keys.shape[0] != len(x):
            raise ValueError(
                f"sa_noise_field has {sa_noise_field.keys.shape[0]} rows "
                f"for a batch of {len(x)}")
        sa_noise = field_window_noise(sa_noise_field._replace(
            keys=sa_noise_field.keys.to(dev)), cfg)
        sa_noise_std = sa_noise_field.std
    if rng is not None and sa_noise is not None:
        raise ValueError("pass either rng or explicit sa_noise, not both")
    if rng is not None:
        rng = rng.to(dev)
    hw, packed_all = as_hw_params(hw)
    x = as_tensor(x, dev)
    counts_log: Dict[str, torch.Tensor] = {}
    h = x[..., None]
    for i in range(cfg.num_conv_layers):
        name = f"conv{i}"
        key = noise_i = off_i = None
        if rng is not None and sa_noise_std > 0.0 and i > 0:
            rng, key = jaxrand.split(rng)
        if sa_noise and i > 0 and name in sa_noise:
            noise_i = as_tensor(sa_noise[name], dev)
        if chip_offsets and i > 0:
            off_i = as_tensor(chip_offsets[name], dev)
        std_i = sa_noise_std if i > 0 else 0.0
        if not collect_counts:
            h = hw_conv_layer(hw, i, h, cfg,
                              packed=packed_all[name] if (packed_all and i)
                              else None,
                              chip_offset=off_i, sa_key=key,
                              sa_noise=noise_i, sa_noise_std=std_i,
                              use_kernel=use_kernel)
            continue
        counts_log[name] = _counts(hw, i, h, cfg, off_i)
        h = _sense(hw, i, counts_log[name], cfg, sa_key=key,
                   sa_noise_std=std_i, sa_noise=noise_i)
    logits, feats = gap_fc(hw, h)
    if collect_counts:
        return logits, feats, counts_log
    return logits, feats


def silence_columns(hw, cfg: KWSConfig = PAPER_KWS,
                    chip_offsets: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Dict[str, torch.Tensor]:
    """Each conv layer's steady-state response to silent (all-zero) audio:
    {conv_i: (C_i,)} — the gated-hop fill of the always-on serving path.
    Valid convolutions of a constant input are constant, so every column
    of every layer equals one vector set by the folded biases and the
    chip's static offsets."""
    hwp, _ = as_hw_params(hw)
    h = torch.zeros((1, cfg.sample_len, 1), device=hw_device(hw))
    out = {}
    for i in range(cfg.num_conv_layers):
        off = chip_offsets[f"conv{i}"] if (chip_offsets and i) else None
        h = hw_conv_layer(hwp, i, h, cfg, chip_offset=off, use_kernel=False)
        out[f"conv{i}"] = h[0, 0]
    return out


def layer_stats(cfg: KWSConfig = PAPER_KWS):
    """Per-layer op counts per decision for the energy model
    (``core.energy``): controller cycles spread over the chip's 160k
    cycles/decision by each layer's temporal occupancy."""
    t = cfg.sample_len
    t_per_layer = []
    for i in range(cfg.num_conv_layers):
        t = (t - cfg.kernels[i]) // cfg.strides[i] + 1
        t_per_layer.append(t)
        t //= cfg.pools[i]
    total_t = sum(t_per_layer) + cfg.channels[-1]
    stats = []
    for i in range(cfg.num_conv_layers):
        t = t_per_layer[i]
        cin = 1 if i == 0 else cfg.channels[i - 1]
        fan_in = (cin // cfg.groups(i)) * cfg.kernels[i]
        stats.append({
            "name": f"conv{i}" if i else "sinc(L1)",
            "kind": "digital" if i == 0 else "imc",
            "macs": int(t * cfg.channels[i] * fan_in),
            "in_bits": int(t * cin * (8 if i == 0 else 1)),
            "out_bits": int(t * cfg.channels[i]),
            "cycles": int(t / total_t * CYCLES_PER_DECISION),
        })
    d = cfg.channels[-1]
    stats.append({
        "name": "gap+fc", "kind": "fc",
        "macs": int(d * cfg.num_classes + d),
        "in_bits": int(d * 8), "out_bits": int(cfg.num_classes * 8),
        "cycles": int(d / total_t * CYCLES_PER_DECISION),
    })
    return stats
