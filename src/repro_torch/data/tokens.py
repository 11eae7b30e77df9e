"""Deterministic, shardable, resumable synthetic token pipeline for the LM
architectures (offline container: no real corpora).

Own copy of ``repro/data/tokens.py`` (pure NumPy, unchanged), so the port
makes its batches without importing the JAX package.

Production properties implemented:
  * deterministic in (seed, step, host) — any host can regenerate any batch,
  * O(1) resume: the cursor is just the step counter (checkpointed),
  * per-host sharding: host h of H draws the h-th slice of the global batch,
    so data-parallel groups never duplicate samples,
  * packing: documents of random length packed into fixed seq_len with EOS.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    eos_id: int = 1

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


def batch_at_step(cfg: TokenPipelineConfig, step: int):
    """Return (tokens, labels) uint32 arrays of shape (host_batch, seq_len).

    Labels are next-token targets (shifted), with EOS boundaries from the
    packing.  Markov-ish structure (token depends on previous token) so
    the model has learnable signal in smoke tests.
    """
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
    b, s, v = cfg.host_batch, cfg.seq_len, cfg.vocab_size
    base = rng.integers(2, v, size=(b, s), dtype=np.int64)
    # cheap short-range structure: mix previous token into the current one
    mixed = base.copy()
    mixed[:, 1:] = (base[:, 1:] + (mixed[:, :-1] // 3)) % (v - 2) + 2
    # document packing: EOS roughly every ~256 tokens
    doc_break = rng.random((b, s)) < (1.0 / 256.0)
    mixed[doc_break] = cfg.eos_id
    tokens = mixed.astype(np.uint32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = cfg.eos_id
    return tokens, labels
