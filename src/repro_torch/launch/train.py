"""LM training driver with the fault-tolerance loop: checkpoint / restart
and a simulated failure, the JAX package's ``launch/train.py`` on one
device.

Run (CPU, reduced config):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-14b \\
      --reduced --steps 50 --ckpt-dir /tmp/ckpt --ckpt-every 20 \\
      --device cpu
Auto-resumes from the latest checkpoint in --ckpt-dir.  Without
``--device`` it trains on CUDA.
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import get_config
from repro_torch.core import jaxrand
from repro_torch.data.tokens import TokenPipelineConfig, batch_at_step
from repro_torch.kernels import resolve_device
from repro_torch.launch.steps import (init_params_for, make_optimizer,
                                      make_train_step)


def model_batch(cfg, tokens, labels, device) -> dict:
    """``batch_at_step``'s (tokens, labels) as a step's batch on
    ``device``; the frames of the VLM family's prefix and of the encdec
    family's encoder input are ones in bfloat16, as the reference feeds
    them."""
    batch = {"tokens": torch.as_tensor(tokens.astype(np.int64),
                                       device=device),
             "labels": torch.as_tensor(labels.astype(np.int64),
                                       device=device)}
    if cfg.family in ("vlm", "encdec"):
        batch["frames"] = torch.ones(
            (tokens.shape[0], cfg.frontend_len, cfg.d_model),
            dtype=torch.bfloat16, device=device)
    return batch


def train_loop(arch: str, steps: int, *, reduced: bool = True,
               batch: int = 8, seq: int = 64, lr: float = 3e-4,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
               fail_at: Optional[int] = None, log_every: int = 10,
               seed: int = 0, device=None):
    """Returns (params, final_metrics).  ``fail_at`` raises a simulated
    failure at that step (the fault-tolerance test restarts the loop and
    checks the resumed trajectory).  Float32 parameters drawn from
    ``PRNGKey(seed)`` on ``device`` (``None`` means CUDA)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    pipe = TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                               global_batch=batch, seed=seed)
    optimizer = make_optimizer(cfg, lr=lr, steps=steps)
    step_fn = make_train_step(cfg, optimizer)

    params = init_params_for(cfg, jaxrand.PRNGKey(seed, device="cpu"),
                             device=dev, dtype=torch.float32)
    opt_state = optimizer.init(params)
    start_step = 0
    rng_key = jaxrand.PRNGKey(seed + 1, device="cpu")

    ckpt = Checkpointer(ckpt_dir) if ckpt_dir else None
    if ckpt is not None:
        restored = ckpt.restore(params, opt_state)
        if restored is not None:
            params, opt_state, meta = restored
            start_step = meta["step"]
            rng_key = jaxrand.key_from_numpy(
                np.asarray(meta["rng_key"], np.uint32), device="cpu")
            print(f"[train] resumed from step {start_step}", flush=True)

    t0 = time.time()
    metrics = {}
    for step in range(start_step, steps):
        if fail_at is not None and step == fail_at:
            raise RuntimeError(f"simulated node failure at step {step}")
        tokens, labels = batch_at_step(pipe, step)
        params, opt_state, metrics = step_fn(
            params, opt_state, model_batch(cfg, tokens, labels, dev))
        if (step + 1) % log_every == 0:
            print(f"[train] step {step + 1} loss "
                  f"{float(metrics['loss']):.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
        if ckpt is not None and (step + 1) % ckpt_every == 0:
            ckpt.save(step + 1, params, opt_state, data_step=step + 1,
                      rng_key=rng_key)
    return params, {k: float(v) for k, v in metrics.items()}


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    train_loop(args.arch, args.steps, reduced=args.reduced,
               batch=args.batch, seq=args.seq, lr=args.lr,
               ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
               fail_at=args.fail_at, device=args.device)
    print("[train] done")


if __name__ == "__main__":
    main()
