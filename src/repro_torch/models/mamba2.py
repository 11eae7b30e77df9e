"""Mamba2 (SSD) layer of the LM stack: its configuration.

The layer itself (``mamba2_init``, ``mamba2_apply``, ``mamba2_step``) is
not ported yet (``ROADMAP.md`` queue 1, item 7d); ``Mamba2Config`` is here
so that every architecture config of ``repro_torch.configs`` loads, field
for field the JAX package's."""

from __future__ import annotations

import dataclasses


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
