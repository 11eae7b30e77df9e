"""Batched greedy LM server: a fresh KV cache per request, the prompt fed
one token at a time (teacher-forced prefill), then greedy decoding over
the real vocabulary, as the JAX package's ``launch/serve.py`` serves.

Run:  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-14b \\
          --reduced --requests 6 --max-new 12 [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core import jaxrand
from repro_torch.kernels import resolve_device
from repro_torch.launch.steps import init_params_for, make_decode_step
from repro_torch.models import lm as LM


class Server:
    """Slot-based batched decoder (continuous batching light): fixed B
    slots; each slot holds one request's cache position.  ``reduced=False``
    serves the architecture at its published width and depth.  Parameters
    (bfloat16, drawn from ``PRNGKey(seed)`` as the reference's ``Server``
    draws them) and caches live on ``device`` (``None`` means CUDA)."""

    def __init__(self, arch: str, reduced: bool = True, slots: int = 4,
                 max_len: int = 128, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.cfg = get_config(arch)
        if reduced:
            self.cfg = self.cfg.reduced()
        if self.cfg.family == "encdec":
            raise NotImplementedError("serve driver targets decoder LMs")
        self.slots = slots
        self.max_len = max_len
        self.params = init_params_for(
            self.cfg, jaxrand.PRNGKey(seed, device="cpu"),
            device=self.device)
        self.decode = make_decode_step(self.cfg)
        self.caches = LM.init_cache(self.cfg, slots, max_len,
                                    device=self.device)
        self.positions = np.zeros(slots, np.int32)
        self.tokens = np.full((slots, 1), 1, np.int32)

    def submit_and_run(self, prompts: List[np.ndarray], max_new: int = 16):
        """Greedy-decode each prompt: a fresh cache per request, the prompt
        fed step by step, then ``max_new`` greedy tokens."""
        outs = []
        for prompt in prompts:
            caches = LM.init_cache(self.cfg, 1, self.max_len,
                                   device=self.device)
            # the prompt goes to the device once; each step reads a slice
            ids = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                                  device=self.device)[None, :]
            tok = ids[:, :1]
            generated = []
            pos = 0
            for t in range(len(prompt) - 1):    # teacher-forced prefill
                _, caches = self.decode(self.params, caches,
                                        {"tokens": tok, "index": pos})
                pos += 1
                tok = ids[:, t + 1:t + 2]
            for _ in range(max_new):
                logits, caches = self.decode(self.params, caches,
                                             {"tokens": tok, "index": pos})
                pos += 1
                nxt = torch.argmax(logits[:, -1, :self.cfg.vocab_size],
                                   dim=-1, keepdim=True)
                generated.append(int(nxt))
                tok = nxt
            outs.append(generated)
        return outs


def prompts_for(cfg, requests: int, seed: int = 0) -> List[np.ndarray]:
    """``main``'s traffic: ``requests`` prompts of 4-9 tokens drawn from
    ``default_rng(seed)`` over [2, vocab_size)."""
    rng = np.random.default_rng(seed)
    return [rng.integers(2, cfg.vocab_size, size=rng.integers(4, 10))
            for _ in range(requests)]


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    srv = Server(args.arch, reduced=True, device=args.device)
    prompts = prompts_for(srv.cfg, args.requests)
    t0 = time.time()
    outs = srv.submit_and_run(prompts, max_new=args.max_new)
    dt = time.time() - t0
    total_tokens = sum(len(o) for o in outs)
    for i, o in enumerate(outs):
        print(f"[serve] req{i}: {o}")
    print(f"[serve] {total_tokens} tokens in {dt:.1f}s "
          f"({total_tokens / dt:.1f} tok/s, {srv.device.type}, reduced "
          f"config)")


if __name__ == "__main__":
    main()
