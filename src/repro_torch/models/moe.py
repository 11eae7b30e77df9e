"""Mixture-of-experts layer of the LM stack: its configuration.

The expert layer itself (``moe_init``, ``moe_apply``) is not ported yet
(``ROADMAP.md`` queue 1, item 7c); ``MoEConfig`` is here so that every
architecture config of ``repro_torch.configs`` loads, field for field the
JAX package's."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff_expert: int
    num_experts: int
    top_k: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0                # total shared intermediate size
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
