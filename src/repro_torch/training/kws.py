"""Training, recovery and customization drivers for the KWS model (paper
§IV-B, §V-C, §VI-A3).

Port of ``repro/training/kws.py``:

* ``train_base``, the float QAT training loop (Adam on a warmed-up cosine
  schedule, annealed binarization through ``TrainConfig.alpha_schedule``,
  the polarization pull of latent weights toward ±1, latents clamped
  after each step); with ``chip_offsets`` / ``sa_noise_std`` it is the
  paper's noise-aware recovery fine-tune.  Batches come from numpy's
  ``default_rng(seed)`` and the noise keys from a ``jaxrand`` chain, as
  the reference draws them.  ``evaluate`` is the float path's accuracy;
* the batched hardware forward (``_hw_batched``) behind the hardware
  path's accuracy (``evaluate_hw``, the rows of the paper's Tables II and
  III) and the customization feature buffer (``hw_features``), and the
  chip's test-mode bias compensation,
  both as one driver (``calibrate_and_compensate``) and as the
  tick-resumable pieces the serving sessions run
  (``calibration_ideal_counts`` + ``compensate_layer_bias``).

The test mode measures ideal counts + the chip's static offset + fresh SA
read noise, drawn per layer from the calibration split chain
(``calibration_layer_keys``) with ``core.jaxrand``, so the compensated
biases are the reference's.  The hardware forward draws fresh noise per
chunk (``sa_noise_std``/``seed``) or evaluates a stream's noise field
(``sa_noise_field``: the offline oracle of a session's captures).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import compensation, imc, jaxrand, means
from repro_torch.core.quantize import WEIGHT_Q
from repro_torch.core.sa_noise import SANoiseField
from repro_torch.kernels import resolve_device
from repro_torch.models import kws
from repro_torch.optim import adam, cosine_schedule


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 30
    batch_size: int = 60
    lr: float = 0.01               # paper: Adam, lr 0.01 decayed
    lr_min: float = 1e-6
    seed: int = 0
    log_every: int = 50
    # annealed binarization: (fraction_of_epochs, alpha); positive alpha =
    # tanh soft, negative = hard forward with a surrogate gradient, None =
    # hard with the clipped straight-through gradient
    alpha_schedule: tuple = ((0.4, 2.0), (0.6, 5.0), (0.75, 12.0),
                             (0.9, -5.0), (1.0, -10.0))
    # polarization pull of latent weights toward +/-1 during soft phases
    polarize_weight: float = 1e-3


def _alpha_at(tcfg: TrainConfig, epoch: int):
    frac = (epoch + 1) / max(1, tcfg.epochs)
    for upto, alpha in tcfg.alpha_schedule:
        if frac <= upto:
            return alpha
    return tcfg.alpha_schedule[-1][1] if tcfg.alpha_schedule else None


def _batches(x: np.ndarray, y: np.ndarray, bs: int,
             rng: np.random.Generator) -> Iterator[Tuple[np.ndarray,
                                                         np.ndarray]]:
    idx = rng.permutation(len(y))
    for i in range(0, len(y) - bs + 1, bs):
        j = idx[i:i + bs]
        yield x[j], y[j]


def _clamp_latents(params: Dict, cfg: kws.KWSConfig) -> Dict:
    """BNN practice: latent conv weights inside [-1, 1] (where the clipped
    straight-through gradient lives), |gamma| >= 0.05 in the IMC layers,
    and the FC inside the Q1.7 range."""
    p = dict(params)
    for i in range(1, cfg.num_conv_layers):
        name = f"conv{i}"
        g = p[name]["gamma"]
        g = torch.where(torch.abs(g) < 0.05,
                        torch.where(g >= 0, 0.05, -0.05), g)
        p[name] = {**p[name], "w": torch.clamp(p[name]["w"], -1.0, 1.0),
                   "gamma": g}
    m = WEIGHT_Q.max_value
    p["fc"] = {"w": torch.clamp(p["fc"]["w"], -m, m),
               "b": torch.clamp(p["fc"]["b"], -m, m)}
    return p


def _train_step(params, state, x, y, key, alpha, cfg, tcfg, chip_offsets,
                sa_noise_std):
    """Loss, gradients and the new BN state of one batch."""
    names = [(n, k) for n in sorted(params) for k in sorted(params[n])]
    live = {n: {k: v.detach().requires_grad_(True) for k, v in d.items()}
            for n, d in params.items()}
    with torch.enable_grad():
        logits, new_state = kws.forward_train(
            live, state, x, cfg, chip_offsets=chip_offsets,
            sa_noise_std=sa_noise_std, rng=key, soft_alpha=alpha)
        loss = kws.cross_entropy(logits, y)
        if alpha is not None and tcfg.polarize_weight:
            # pull latent conv weights toward +/-1, so that the final hard
            # binarization is a small perturbation
            pol = sum(means.mean((1.0 - w * w) ** 2, tuple(range(w.dim())))
                      for w in (live[f"conv{i}"]["w"]
                                for i in range(1, cfg.num_conv_layers)))
            loss = loss + tcfg.polarize_weight * pol
        grads = torch.autograd.grad(loss, [live[n][k] for n, k in names],
                                    allow_unused=True)
    tree: Dict = {n: {} for n in params}
    for (n, k), g in zip(names, grads):
        tree[n][k] = torch.zeros_like(params[n][k]) if g is None else g
    return loss.detach(), kws.accuracy(logits.detach(), y), tree, new_state


def train_base(xtr: np.ndarray, ytr: np.ndarray,
               cfg: kws.KWSConfig = kws.PAPER_KWS,
               tcfg: TrainConfig = TrainConfig(),
               params=None, state=None,
               chip_offsets: Optional[Dict[str, torch.Tensor]] = None,
               sa_noise_std: float = 0.0, verbose: bool = True,
               history: Optional[List[dict]] = None, device=None):
    """QAT training on audio windows ``xtr`` (N, sample_len) and labels
    ``ytr`` (N,), numpy.  With ``chip_offsets`` ({conv_i: (C_i,)}) and
    ``sa_noise_std`` this is the paper's noise-aware recovery fine-tune
    (start from trained ``params``).  Returns (params, state) on
    ``device`` (``None`` means CUDA).  ``history``, when given, receives
    one dict per step (epoch, alpha, loss, acc; loss and acc as 0-dim
    tensors on the device, so logging costs no synchronization)."""
    dev = resolve_device(device)
    if params is None:
        params = kws.init_params(jaxrand.PRNGKey(tcfg.seed, device="cpu"),
                                 cfg, device=dev)
    if state is None:
        state = kws.init_state(cfg, device=dev)
    if chip_offsets is not None:
        chip_offsets = {k: kws.as_tensor(v, dev)
                        for k, v in chip_offsets.items()}

    steps_per_epoch = max(1, len(ytr) // tcfg.batch_size)
    opt = adam(cosine_schedule(tcfg.lr, tcfg.epochs * steps_per_epoch,
                               warmup_steps=steps_per_epoch // 2,
                               min_lr=tcfg.lr_min))
    opt_state = opt.init(params)
    rng = np.random.default_rng(tcfg.seed)
    key = jaxrand.PRNGKey(tcfg.seed + 1, device=dev)
    t0 = time.time()
    it = 0
    for epoch in range(tcfg.epochs):
        alpha = _alpha_at(tcfg, epoch)
        for xb, yb in _batches(xtr, ytr, tcfg.batch_size, rng):
            key, sub = jaxrand.split(key)
            x = kws.as_tensor(xb, dev)
            y = torch.as_tensor(np.asarray(yb), dtype=torch.int64,
                                device=dev)
            loss, acc, grads, state = _train_step(
                params, state, x, y, sub, alpha, cfg, tcfg, chip_offsets,
                sa_noise_std)
            params, opt_state = opt.update(grads, opt_state, params)
            params = _clamp_latents(params, cfg)
            it += 1
            if history is not None:
                history.append({"epoch": epoch, "alpha": alpha,
                                "loss": loss, "acc": acc})
            if verbose and it % tcfg.log_every == 0:
                print(f"  epoch {epoch} it {it} a={alpha} "
                      f"loss {float(loss):.4f} acc {float(acc):.3f} "
                      f"({time.time() - t0:.0f}s)", flush=True)
    return params, state


def evaluate(params, state, x: np.ndarray, y: np.ndarray,
             cfg: kws.KWSConfig = kws.PAPER_KWS, batch: int = 200,
             device=None) -> float:
    """Accuracy of the float path (``forward_eval``) over ``x`` in chunks
    of ``batch``; ``params`` and ``state`` live on ``device`` (``None``
    means CUDA)."""
    dev = resolve_device(device)
    correct = 0
    with torch.no_grad():
        for i in range(0, len(y), batch):
            logits = kws.forward_eval(params, state,
                                      kws.as_tensor(x[i:i + batch], dev),
                                      cfg)[0]
            labels = torch.as_tensor(np.asarray(y[i:i + batch]),
                                     dtype=torch.int64, device=dev)
            correct += int(torch.sum(torch.argmax(logits, -1) == labels))
    return correct / len(y)


def _check_device(hw, device) -> torch.device:
    dev = resolve_device(device)
    if kws.hw_device(hw) != dev:
        raise ValueError(f"parameters are on {kws.hw_device(hw)}, not on "
                         f"{dev}")
    return dev


def _hw_batched(hw, x, cfg: kws.KWSConfig, out_index: int, *,
                chip_offsets, sa_noise_std: float, seed: int, batch: int,
                use_kernel: bool, sa_noise_field: Optional[SANoiseField],
                device) -> torch.Tensor:
    """The chunked hardware forward shared by ``evaluate_hw`` (logits,
    ``out_index`` 0) and ``hw_features`` (features, 1): ``hw_forward``
    over x (N, sample_len) in chunks of ``batch``, concatenated.

    SA noise is a fresh draw per chunk (``sa_noise_std``, a key split
    from ``PRNGKey(seed)`` for each chunk; a ragged last chunk draws at
    its own shape) or, with ``sa_noise_field``, each example's recorded
    (stream key, window) field, whose rows ride their batch slice: the
    offline oracle of a stream's or a session's noise, bit for bit.
    ``hw`` lives on ``device`` (``None`` means CUDA)."""
    dev = _check_device(hw, device)
    x = kws.as_tensor(x, dev)
    if sa_noise_field is not None:
        if sa_noise_std > 0.0:
            raise ValueError("pass either sa_noise_std or sa_noise_field, "
                             "not both")
        if sa_noise_field.keys.shape[0] != x.shape[0]:
            raise ValueError(
                f"sa_noise_field has {sa_noise_field.keys.shape[0]} rows "
                f"for {x.shape[0]} examples")
        f = sa_noise_field
        return torch.cat([kws.hw_forward(
            hw, x[i:i + batch], cfg, chip_offsets=chip_offsets,
            sa_noise_field=f._replace(keys=f.keys[i:i + batch],
                                      hops=f.hops[i:i + batch]),
            use_kernel=use_kernel, device=dev)[out_index]
            for i in range(0, x.shape[0], batch)], dim=0)
    outs, key = [], jaxrand.PRNGKey(seed, device=dev)
    for i in range(0, x.shape[0], batch):
        key, sub = jaxrand.split(key)
        outs.append(kws.hw_forward(hw, x[i:i + batch], cfg,
                                   chip_offsets=chip_offsets,
                                   sa_noise_std=sa_noise_std, rng=sub,
                                   use_kernel=use_kernel,
                                   device=dev)[out_index])
    return torch.cat(outs, dim=0)


def evaluate_hw(hw, x, y, cfg: kws.KWSConfig = kws.PAPER_KWS,
                chip_offsets: Optional[Dict[str, torch.Tensor]] = None,
                sa_noise_std: float = 0.0, seed: int = 0, batch: int = 200,
                use_kernel: bool = False,
                sa_noise_field: Optional[SANoiseField] = None,
                device=None) -> float:
    """Accuracy of the hardware path (``hw`` is ``HWParams`` or
    ``PackedHWParams`` on ``device``, ``None`` meaning CUDA) on windows x
    (N, sample_len) with labels y (N,), in chunks of ``batch``, with the
    noise modes of ``hw_features``.  The accuracy is taken on the host in
    numpy, as the reference takes it: the mean of the float64 hits."""
    logits = _hw_batched(hw, x, cfg, 0, chip_offsets=chip_offsets,
                         sa_noise_std=sa_noise_std, seed=seed, batch=batch,
                         use_kernel=use_kernel,
                         sa_noise_field=sa_noise_field, device=device)
    return float(np.mean(np.argmax(logits.cpu().numpy(), -1)
                         == np.asarray(y)))


def hw_features(hw, x, cfg: kws.KWSConfig = kws.PAPER_KWS,
                chip_offsets: Optional[Dict[str, torch.Tensor]] = None,
                sa_noise_std: float = 0.0, seed: int = 0, batch: int = 200,
                use_kernel: bool = False,
                sa_noise_field: Optional[SANoiseField] = None,
                device=None) -> torch.Tensor:
    """GAP features (N, D) of audio windows x (N, sample_len) through the
    hardware path, in chunks of ``batch``: the customization feature
    buffer (§V-C).  SA noise is a fresh draw per chunk
    (``sa_noise_std``, keys split from ``PRNGKey(seed)``) or, with
    ``sa_noise_field``, each example's recorded (stream key, window)
    field, which reproduces a session's captured features bit for bit.
    ``hw`` lives on ``device`` (``None`` means CUDA)."""
    return _hw_batched(hw, x, cfg, 1, chip_offsets=chip_offsets,
                       sa_noise_std=sa_noise_std, seed=seed, batch=batch,
                       use_kernel=use_kernel, sa_noise_field=sa_noise_field,
                       device=device)


def calibration_ideal_counts(hw, xcal, cfg: kws.KWSConfig = kws.PAPER_KWS,
                             device=None) -> Dict[str, torch.Tensor]:
    """The test-mode reference measurement: each IMC layer's ideal
    (noise-free, offset-free) pre-SA counts of the calibration windows,
    {conv_i: (N, t_conv, C_i)}.  One forward of the unfused path (the
    kernel never materializes counts)."""
    dev = _check_device(hw, device)
    hwp, _ = kws.as_hw_params(hw)
    _, _, log = kws.hw_forward(hwp, kws.as_tensor(xcal, dev), cfg,
                               chip_offsets=None, collect_counts=True,
                               device=dev)
    return log


def compensate_layer_bias(bias_int: torch.Tensor,
                          ideal_counts: torch.Tensor,
                          chip_offset: torch.Tensor,
                          key: Optional[torch.Tensor] = None,
                          sa_noise_std: float = 1.0,
                          macro: imc.IMCMacroConfig = imc.DEFAULT_MACRO,
                          return_est: bool = False):
    """One layer of test-mode compensation: measure ideal + the chip's
    static offset + fresh SA read noise (``sa_noise_std * normal(key,
    counts.shape)``; ``key`` is the layer's slot of
    ``calibration_layer_keys``, and may be None at zero noise), estimate
    the per-channel discrepancy and fold it into the in-memory BN bias.
    ``return_est=True`` also returns the raw per-channel estimate."""
    measured = ideal_counts + chip_offset
    if sa_noise_std > 0.0:
        if key is None:
            raise ValueError("compensate_layer_bias: read noise needs the "
                             "layer's key (calibration_layer_keys)")
        measured = measured + sa_noise_std * jaxrand.normal(
            key.to(ideal_counts.device), tuple(ideal_counts.shape))
    est = compensation.estimate_channel_offsets(ideal_counts, measured)
    new_bias = compensation.compensate_bias(bias_int, est, macro)
    if return_est:
        return new_bias, est
    return new_bias


def calibration_layer_keys(cfg: kws.KWSConfig = kws.PAPER_KWS,
                           seed: int = 0, device=None
                           ) -> Dict[str, torch.Tensor]:
    """The per-layer measurement keys of the calibration split chain,
    shared by ``calibrate_and_compensate`` and the tick-resumable
    sessions so both take identical read-noise samples (``device=None``
    means CUDA)."""
    key = jaxrand.PRNGKey(seed, device=device)
    out = {}
    for name in cfg.imc_layer_names():
        key, sub = jaxrand.split(key)
        out[name] = sub
    return out


def calibrate_and_compensate(hw, xcal,
                             chip_offsets: Dict[str, torch.Tensor],
                             cfg: kws.KWSConfig = kws.PAPER_KWS,
                             macro: imc.IMCMacroConfig = imc.DEFAULT_MACRO,
                             sa_noise_std: float = 1.0, seed: int = 0,
                             sa_noise_field: Optional[SANoiseField] = None,
                             device=None):
    """Paper §IV-B: estimate per-channel MAV offsets through the chip's
    test mode (layer-local, matched inputs: ideal counts + static offset
    + fresh read noise from ``calibration_layer_keys(cfg, seed)``) and fold
    the compensation into the in-memory BN biases.  It runs
    ``calibration_ideal_counts`` + ``compensate_layer_bias``, the pieces
    the serving sessions run one layer per tick.  ``sa_noise_field`` does
    not touch the measurement (the test mode digitizes pre-SA counts); it
    is only checked against ``xcal``, as the reference does, so an offline
    oracle can thread one field through calibration and features.
    Returns the same kind of parameters as ``hw`` (packed parameters are
    re-packed)."""
    if sa_noise_field is not None \
            and sa_noise_field.keys.shape[0] != len(xcal):
        raise ValueError(
            f"sa_noise_field has {sa_noise_field.keys.shape[0]} rows for "
            f"{len(xcal)} calibration utterances")
    dev = _check_device(hw, device)
    hwp, packed = kws.as_hw_params(hw)
    ideal_log = calibration_ideal_counts(hwp, xcal, cfg, device=dev)
    keys = calibration_layer_keys(cfg, seed, device=dev)
    new_bias = dict(hwp.bias)
    for name in cfg.imc_layer_names():
        new_bias[name] = compensate_layer_bias(
            hwp.bias[name], ideal_log[name],
            kws.as_tensor(chip_offsets[name], dev), keys[name],
            sa_noise_std, macro)
    out = hwp._replace(bias=new_bias)
    return kws.pack_hw_params(out, cfg) if packed is not None else out
