"""Per-hop decision logic: posterior smoothing + hysteresis + refractory.

Port of ``repro/serving/decision.py``.  One logit vector per hop is a noisy
view of a keyword, so the posterior is averaged over the last ``smooth``
hops (dividing by the hops actually seen); after a trigger the detector
disarms until the smoothed score of the fired keyword falls below
``threshold_off``; and at least ``refractory`` hops separate triggers.
Batched over streams (leading axis) and mask-aware: inactive streams keep
their state verbatim and never trigger.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch


@dataclasses.dataclass(frozen=True)
class DecisionConfig:
    smooth: int = 5                 # hops of posterior smoothing
    threshold_on: float = 0.7       # smoothed posterior to fire
    threshold_off: float = 0.5      # re-arm level (hysteresis)
    refractory: int = 10            # min hops between triggers
    background_class: Optional[int] = None   # class that never triggers


class DecisionState(NamedTuple):
    posteriors: torch.Tensor        # (B, smooth, K) softmax ring
    seen: torch.Tensor              # (B,) int32 hops accumulated
    armed: torch.Tensor             # (B,) bool — hysteresis state
    refractory: torch.Tensor        # (B,) int32 hops until re-fire allowed
    last_kw: torch.Tensor           # (B,) int32 keyword of the last trigger


class DecisionOut(NamedTuple):
    trigger: torch.Tensor           # (B,) bool — keyword fired this hop
    keyword: torch.Tensor           # (B,) int32 argmax keyword
    score: torch.Tensor             # (B,) smoothed posterior of `keyword`
    posterior: torch.Tensor         # (B, K) smoothed posterior vector


def decision_init(n: int, num_classes: int,
                  dcfg: DecisionConfig = DecisionConfig(),
                  device=None) -> DecisionState:
    i32 = dict(dtype=torch.int32, device=device)
    return DecisionState(
        posteriors=torch.zeros((n, dcfg.smooth, num_classes), device=device),
        seen=torch.zeros((n,), **i32),
        armed=torch.ones((n,), dtype=torch.bool, device=device),
        refractory=torch.zeros((n,), **i32),
        last_kw=torch.zeros((n,), **i32))


def decision_step(dcfg: DecisionConfig, state: DecisionState,
                  logits: torch.Tensor,
                  active: Optional[torch.Tensor] = None):
    """Advance the decision state with one hop of logits (B, K).  Returns
    (new_state, DecisionOut)."""
    b = logits.shape[0]
    if active is None:
        active = torch.ones((b,), dtype=torch.bool, device=logits.device)
    # softmax written as jax.nn.softmax computes it: exp(x - max) / sum
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    post = e / e.sum(dim=-1, keepdim=True)
    ring = torch.cat([state.posteriors[:, 1:], post[:, None]], dim=1)
    seen = torch.clamp(state.seen + 1, max=dcfg.smooth)
    smoothed = ring.sum(dim=1) / torch.clamp(seen, min=1)[:, None]

    scored = smoothed
    if dcfg.background_class is not None:
        scored = scored.clone()
        scored[:, dcfg.background_class] = -torch.inf
    keyword = torch.argmax(scored, dim=-1).to(torch.int32)
    score = torch.gather(smoothed, 1, keyword[:, None].long())[:, 0]

    can_fire = (state.armed & (state.refractory == 0)
                & (score >= dcfg.threshold_on))
    trigger = can_fire & active
    # hysteresis tracks the last-fired keyword: re-arm when ITS smoothed
    # posterior decays below threshold_off
    last_score = torch.gather(smoothed, 1, state.last_kw[:, None].long())[:, 0]
    rearm = last_score <= dcfg.threshold_off
    new_armed = torch.where(trigger, False, state.armed | rearm)
    new_refractory = torch.where(
        trigger, dcfg.refractory,
        torch.clamp(state.refractory - 1, min=0)).to(torch.int32)
    new_last_kw = torch.where(trigger, keyword, state.last_kw)

    m = active
    new_state = DecisionState(
        posteriors=torch.where(m[:, None, None], ring, state.posteriors),
        seen=torch.where(m, seen, state.seen),
        armed=torch.where(m, new_armed, state.armed),
        refractory=torch.where(m, new_refractory, state.refractory),
        last_kw=torch.where(m, new_last_kw, state.last_kw))
    return new_state, DecisionOut(trigger=trigger, keyword=keyword,
                                  score=score, posterior=smoothed)


def reset_slot(state: DecisionState, slot: int) -> DecisionState:
    """Zero one slot's decision state (stream admission / eviction)."""
    new = DecisionState(*(t.clone() for t in state))
    new.posteriors[slot] = 0.0
    new.seen[slot] = 0
    new.armed[slot] = True
    new.refractory[slot] = 0
    new.last_kw[slot] = 0
    return new
