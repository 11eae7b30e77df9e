"""xLSTM (mLSTM / sLSTM) blocks of the LM stack: their configuration.

The blocks themselves are not ported yet (``ROADMAP.md`` queue 1, item
7e); ``XLSTMConfig`` is here so that every architecture config of
``repro_torch.configs`` loads, field for field the JAX package's."""

from __future__ import annotations

import dataclasses


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
