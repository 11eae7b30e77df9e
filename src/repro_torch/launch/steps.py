"""Prefill / decode step builders of the LM stack, used by the server.

The JAX package's ``launch/steps.py`` builds jit-able steps and the
abstract input specs of every (architecture x shape) cell; the port keeps
the step builders of the serving path.  The train step, the optimizer and
the spec helpers come with the training slice (``ROADMAP.md`` queue 1,
item 7b), the encoder-decoder steps with item 7f.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm as LM


def _no_encdec(cfg: ArchConfig) -> None:
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder family is not ported yet "
            f"(ROADMAP.md queue 1, item 7f)")


def make_prefill_step(cfg: ArchConfig):
    """``prefill_step(params, batch)`` -> (last logits, caches); ``batch``
    holds "tokens" (B, S) and, for the VLM family, "frames" (B, P, D)."""
    _no_encdec(cfg)

    def prefill_step(params, batch):
        prefix = batch.get("frames") if cfg.family == "vlm" else None
        return LM.prefill(params, cfg, batch["tokens"],
                          prefix_embeds=prefix)
    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """``decode_fn(params, caches, batch)`` -> (logits (B, 1, Vpad),
    new caches); ``batch`` holds "tokens" (B, 1) and "index"."""
    _no_encdec(cfg)

    def decode_fn(params, caches, batch):
        return LM.decode_step(params, cfg, batch["tokens"], caches,
                              batch["index"])
    return decode_fn


def init_params_for(cfg: ArchConfig,
                    generator: Optional[torch.Generator] = None,
                    device=None, seed: int = 0):
    """Random parameters of ``cfg`` on ``device`` (``None`` means CUDA)."""
    _no_encdec(cfg)
    return LM.init_lm(cfg, generator=generator, device=device, seed=seed)
