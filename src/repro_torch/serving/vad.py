"""Voice-activity gating: the always-on power front end (paper §VI, Fig 16).

Port of ``repro/serving/vad.py``: a per-hop log-energy estimate, smoothed
by an EMA and classified speech/silence through hysteresis thresholds,
with a hangover that holds "speech" for ``hang`` hops after the level
falls below the off threshold.  ``wake_margin`` is consumed by the
scheduler (deferred silent hops replayed on a speech onset).  ``force``
pins the classification.  Batched over streams and mask-aware.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

_FLOOR_DB = -120.0                 # silence level the EMA starts from
_EPS = 1e-12                       # keeps log10 finite on all-zero hops


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


def frame_energy_db(audio: torch.Tensor) -> torch.Tensor:
    """Mean-square energy of one hop in dBFS: (B, hop) -> (B,).  The mean
    is ``sum / n`` as in ``jnp.mean``."""
    ms = torch.square(audio).sum(dim=-1) / audio.shape[-1]
    return 10.0 * torch.log10(ms + _EPS)


def vad_step(vcfg: VADConfig, state: VADState, audio: torch.Tensor,
             active: Optional[torch.Tensor] = None
             ) -> Tuple[VADState, torch.Tensor]:
    """Classify one hop of audio (B, hop) per stream.  Inactive streams
    keep their state and report their previous classification.  Returns
    (new_state, speech flags (B,) bool)."""
    b = audio.shape[0]
    if active is None:
        active = torch.ones((b,), dtype=torch.bool, device=audio.device)
    e = frame_energy_db(audio)
    level = torch.where(state.seen > 0,
                        vcfg.ema * state.level_db + (1.0 - vcfg.ema) * e, e)
    # hysteresis: the live threshold depends on the current classification
    hot = torch.where(state.speech, level >= vcfg.threshold_off_db,
                      level >= vcfg.threshold_on_db)
    hang = torch.where(hot, vcfg.hang,
                       torch.clamp(state.hang - 1, min=0)).to(torch.int32)
    # the pre-decrement counter gates the hold: hang=N keeps speech for
    # exactly N hops after the level falls below threshold_off_db
    speech = hot | (state.speech & (state.hang > 0))
    if vcfg.force == "speech":
        speech = torch.ones_like(speech)
    elif vcfg.force == "silence":
        speech = torch.zeros_like(speech)
    new_state = VADState(
        level_db=torch.where(active, level, state.level_db),
        speech=torch.where(active, speech, state.speech),
        hang=torch.where(active, hang, state.hang),
        seen=torch.where(active, state.seen + 1, state.seen))
    return new_state, torch.where(active, speech, state.speech)


def vad_reset_slot(state: VADState, slot: int) -> VADState:
    """Zero one slot's detector state (stream admission / eviction)."""
    new = VADState(*(t.clone() for t in state))
    new.level_db[slot] = _FLOOR_DB
    new.speech[slot] = False
    new.hang[slot] = 0
    new.seen[slot] = 0
    return new
