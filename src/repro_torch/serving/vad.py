"""Voice-activity gating: the always-on power front end (paper §VI, Fig 16).

Port of ``repro/serving/vad.py``: a per-hop log-energy estimate, smoothed
by an EMA and classified speech/silence through hysteresis thresholds,
with a hangover that holds "speech" for ``hang`` hops after the level
falls below the off threshold.  ``wake_margin`` is consumed by the
scheduler (deferred silent hops replayed on a speech onset).  ``force``
pins the classification.  Batched over streams and mask-aware;
``vad_scan`` classifies a block of K hops in sequence.

The smoothed level is the reference's bit for bit as its server runs it
(``vad_step`` under ``jit``): the mean square summed in XLA's CPU order,
its reciprocal-product mean, XLA's float32 log and the constants and FMAs
its compile folds the decibel scale and the EMA into.  The step is a few
dozen operations on one value per stream, so it runs on the host in
numpy, where each hop's audio arrives and the gating decision is read;
the state tensors may live on any device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import jaxrand, means

_FLOOR_DB = -120.0                 # silence level the EMA starts from
_EPS = 1e-12                       # keeps log10 finite on all-zero hops
# 10 * log10(x) = log(x) * f32(f32(1 / ln 10) * 10), jnp.log10's constant
# times ten, folded into one float32 product by the reference's compile
_DB_PER_NEPER = float(np.float32(0.4342944819032518) * np.float32(10.0))
_XLA_WINDOW = 32                   # XLA CPU's reduction window


@dataclasses.dataclass(frozen=True)
class VADConfig:
    threshold_on_db: float = -40.0   # silence -> speech above this level
    threshold_off_db: float = -50.0  # speech -> silence below this level
    ema: float = 0.6                 # log-energy EMA (0 = no smoothing)
    hang: int = 2                    # hops speech is held after the level
    #                                  drops below threshold_off_db
    wake_margin: int = 2             # silent hops buffered for replay on a
    #                                  speech onset (scheduler-side)
    force: Optional[str] = None      # 'speech' | 'silence' override

    def __post_init__(self):
        if self.force not in (None, "speech", "silence"):
            raise ValueError(f"force={self.force!r} must be None, "
                             f"'speech' or 'silence'")
        if self.threshold_off_db > self.threshold_on_db:
            raise ValueError("threshold_off_db must not exceed "
                             "threshold_on_db (hysteresis band)")
        if self.hang < 0 or self.wake_margin < 0:
            raise ValueError("hang and wake_margin must be >= 0")


class VADState(NamedTuple):
    """Per-stream detector state (leading axis = batch of streams)."""

    level_db: torch.Tensor          # (B,) smoothed log-energy, dBFS
    speech: torch.Tensor            # (B,) bool — current classification
    hang: torch.Tensor              # (B,) int32 hangover countdown
    seen: torch.Tensor              # (B,) int32 hops observed


def vad_init(n: int, device=None) -> VADState:
    return VADState(
        level_db=torch.full((n,), _FLOOR_DB, device=device),
        speech=torch.zeros((n,), dtype=torch.bool, device=device),
        hang=torch.zeros((n,), dtype=torch.int32, device=device),
        seen=torch.zeros((n,), dtype=torch.int32, device=device))


def _row_sum(x: np.ndarray) -> np.ndarray:
    """Sum over the last axis in XLA's CPU order: while more than 32 values
    are left, each run of 32 (zero-padded at the end) is summed left to
    right (the tree-reduction rewrite's ``reduce-window``); then the rest,
    left to right.  ``np.add.accumulate`` adds in sequence in float32."""
    n = x.shape[-1]
    while n > _XLA_WINDOW:
        m = -(-n // _XLA_WINDOW)
        if m * _XLA_WINDOW != n:
            x = np.pad(x, [(0, 0)] * (x.ndim - 1)
                       + [(0, m * _XLA_WINDOW - n)])
        x = x.reshape(*x.shape[:-1], m, _XLA_WINDOW)
        x, n = np.add.accumulate(x, axis=-1)[..., -1], m
    return np.add.accumulate(x, axis=-1)[..., -1]


def _log_energy(audio: np.ndarray) -> np.ndarray:
    """Natural log of a hop's mean square plus ``_EPS``, (B, hop) -> (B,)
    float32, as the reference's jitted ``vad_step`` computes it: the
    squares summed in XLA's order (``_row_sum``), the mean and the epsilon
    in one FMA with the float32 reciprocal of the hop (``core.means``),
    and XLA's float32 ``log`` (``jaxrand.logf_host``)."""
    sq = _row_sum(audio * audio).astype(np.float64)
    ms = (sq * means.reciprocal(audio.shape[-1]) + _EPS).astype(np.float32)
    return jaxrand.logf_host(ms)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def frame_energy_db(audio: torch.Tensor) -> torch.Tensor:
    """Mean-square energy of one hop in dBFS: (B, hop) -> (B,).
    ``10 * log10(m)`` is the natural log times one float32 constant, as
    XLA folds it (``_DB_PER_NEPER``)."""
    db = _log_energy(_host(audio).astype(np.float32)) \
        * np.float32(_DB_PER_NEPER)
    return torch.from_numpy(db).to(audio.device)


def vad_step(vcfg: VADConfig, state: VADState, audio: torch.Tensor,
             active: Optional[torch.Tensor] = None
             ) -> Tuple[VADState, torch.Tensor]:
    """Classify one hop of audio (B, hop) per stream.  Inactive streams
    keep their state and report their previous classification.  Returns
    (new_state, speech flags (B,) bool) on the state's device.  The
    detector is a few dozen operations on B values: it runs on the host
    in numpy, where the hop's audio arrives."""
    f32 = np.float32
    level_db, was, hang, seen = (_host(t) for t in state)
    a = _host(audio).astype(f32)
    act = (np.ones(a.shape[0], bool) if active is None
           else _host(active).astype(bool))
    # ema * level + (1 - ema) * e as the reference's compile folds and
    # contracts it: e's decibel factor and (1 - ema) become one float32
    # constant, and the sum is an FMA over ema * level
    ln = _log_energy(a)
    ema_db = f32(_DB_PER_NEPER) * f32(1.0 - vcfg.ema)
    smoothed = (level_db.astype(np.float64) * float(f32(vcfg.ema))
                + (ln * ema_db)).astype(f32)
    level = np.where(seen > 0, smoothed, ln * f32(_DB_PER_NEPER))
    # hysteresis: the live threshold depends on the current classification
    hot = np.where(was, level >= f32(vcfg.threshold_off_db),
                   level >= f32(vcfg.threshold_on_db))
    new_hang = np.where(hot, vcfg.hang,
                        np.maximum(hang - 1, 0)).astype(np.int32)
    # the pre-decrement counter gates the hold: hang=N keeps speech for
    # exactly N hops after the level falls below threshold_off_db
    speech = hot | (was & (hang > 0))
    if vcfg.force is not None:
        speech = np.full_like(speech, vcfg.force == "speech")
    dev = state.level_db.device
    out = lambda new, old: torch.from_numpy(np.where(act, new, old)).to(dev)
    new_state = VADState(level_db=out(level, level_db),
                         speech=out(speech, was), hang=out(new_hang, hang),
                         seen=out(seen + 1, seen).to(torch.int32))
    return new_state, out(speech, was)


def vad_scan(vcfg: VADConfig, state: VADState, audio: torch.Tensor,
             active: torch.Tensor) -> Tuple[VADState, torch.Tensor]:
    """Classify K hops in sequence: audio (K, B, hop) and active (K, B)
    -> (final state, speech flags (K, B)).  The detector runs on the host,
    so a compiled serving block (``serving.compiled``) classifies its K
    ticks as K ``vad_step`` calls, equal to them by construction; an
    all-inactive step is an exact no-op (the masked writes keep every
    row), as it is in the reference's ``lax.scan``."""
    flags = []
    for a, act in zip(audio, active):
        state, f = vad_step(vcfg, state, a, act)
        flags.append(f)
    if not flags:
        return state, torch.zeros((0,) + tuple(active.shape[1:]),
                                  dtype=torch.bool,
                                  device=state.speech.device)
    return state, torch.stack(flags)


def vad_reset_slot(state: VADState, slot: int) -> VADState:
    """Zero one slot's detector state (stream admission / eviction)."""
    new = VADState(*(t.clone() for t in state))
    new.level_db[slot] = _FLOOR_DB
    new.speech[slot] = False
    new.hang[slot] = 0
    new.seen[slot] = 0
    return new
