"""The LM stack on the card against its own CPU path, on the same
parameters: one check, with one tolerance and one rule for greedy tokens,
shared by ``chip_smoke.py`` (phase 16) and ``tests/test_torch_cuda.py``.

Tolerance: every element within ``LM_ULPS`` bfloat16 ulps of the CPU
tensor's largest magnitude.  cuBLAS sums the bfloat16 products in another
order than the CPU, and CUDA's ``exp``, ``sin``, ``cos`` and ``rsqrt`` are
not the CPU's, so a bfloat16 rounding flips now and then and the flip
travels through the layers.  Greedy tokens: equal, or forked only where
the CPU's top-2 margin at the fork is within the same ``LM_ULPS``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from repro_torch.launch import serve
from repro_torch.models import lm as LM

LM_ULPS = 4


def _ulp(t: torch.Tensor) -> float:
    """One bfloat16 ulp of ``t``'s largest magnitude."""
    return 2.0 ** (torch.floor(torch.log2(t.abs().max())).item() - 7)


def ulps_apart(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| in bfloat16 ulps of ``want``'s largest
    magnitude."""
    g, w = got.float().cpu(), want.float().cpu()
    return float((g - w).abs().max()) / _ulp(w)


def greedy_forks(got: List[List[int]], want: List[List[int]],
                 steps_logits: List[torch.Tensor], prompts, vocab: int
                 ) -> List[Dict]:
    """Greedy tokens ``got`` against ``want``, whose server's decode steps
    gave ``steps_logits`` (one (Vpad,) row a step, in order): the forks,
    each where ``want``'s top-2 margin is within ``LM_ULPS``; a fork past
    that margin raises ``AssertionError``."""
    forks, step = [], 0
    for r, (g, w, prompt) in enumerate(zip(got, want, prompts)):
        step += len(prompt) - 1
        if len(g) != len(w):
            raise AssertionError(f"request {r}: {len(g)} tokens against "
                                 f"{len(w)}")
        for j, (a, b) in enumerate(zip(g, w)):
            if a != b:
                row = steps_logits[step + j][:vocab].float().cpu()
                top2 = torch.topk(row, 2).values
                margin = float(top2[0] - top2[1]) / _ulp(row)
                if margin > LM_ULPS:
                    raise AssertionError(
                        f"request {r} token {j}: {a} against {b}, the "
                        f"reference's top-2 margin {margin:.2f} ulps")
                forks.append(dict(request=r, token=j, margin_ulps=margin))
                break
        step += len(w)
    return forks


def card_against_cpu(arch: str, device, steps: int = 8, requests: int = 4,
                     max_new: int = 8) -> Dict:
    """``arch``'s reduced config on ``device`` against the CPU with the
    CPU server's parameters: prefill's last logits and caches (the VLM
    with its prefix frames), ``steps`` teacher-forced decode steps (logits
    and caches), and the servers' greedy tokens on ``main()``'s traffic.
    Returns the gaps in ulps and the forks; raises ``AssertionError``
    past ``LM_ULPS`` or on a fork past its margin."""
    cpu = serve.Server(arch, reduced=True, device="cpu")
    card = serve.Server(arch, reduced=True, device=device)
    cfg = cpu.cfg
    card.params = LM.tree_map(lambda a: a.to(card.device), cpu.params)
    rng = np.random.default_rng(1)
    tokens = rng.integers(2, cfg.vocab_size, (2, steps))
    frames = None
    if cfg.family == "vlm":
        frames = torch.tensor(rng.standard_normal(
            (2, cfg.frontend_len, cfg.d_model)), dtype=torch.float32)
    pc = LM.prefill(cpu.params, cfg, tokens, prefix_embeds=frames)
    pg = LM.prefill(card.params, cfg, tokens, prefix_embeds=None
                    if frames is None else frames.to(card.device))
    if pg[0].device != card.device:
        raise AssertionError(f"{arch}: prefill ran on {pg[0].device}")

    def caches_apart(g, c):
        return max(ulps_apart(a[k], b[k]) for a, b in zip(g, c)
                   for k in ("k", "v"))
    out = {"prefill_ulps": ulps_apart(pg[0], pc[0]),
           "prefill_cache_ulps": caches_apart(pg[1], pc[1]),
           "decode_ulps": 0.0, "decode_cache_ulps": 0.0}
    cc = LM.init_cache(cfg, 2, steps, device="cpu")
    cg = LM.init_cache(cfg, 2, steps, device=card.device)
    for t in range(steps):
        lc, cc = LM.decode_step(cpu.params, cfg, tokens[:, t:t + 1], cc, t)
        lg, cg = LM.decode_step(card.params, cfg, tokens[:, t:t + 1], cg, t)
        out["decode_ulps"] = max(out["decode_ulps"], ulps_apart(lg, lc))
        out["decode_cache_ulps"] = max(out["decode_cache_ulps"],
                                       caches_apart(cg, cc))
    for key, v in out.items():
        if not v <= LM_ULPS:
            raise AssertionError(f"{arch}: {key} {v:.2f} > {LM_ULPS}")
    prompts = serve.prompts_for(cfg, requests)
    steps_c = []
    decode_c = cpu.decode

    def recording(params, caches, batch):
        logits, caches = decode_c(params, caches, batch)
        steps_c.append(logits[0, -1])
        return logits, caches
    cpu.decode = recording
    want = cpu.submit_and_run(prompts, max_new=max_new)
    got = card.submit_and_run(prompts, max_new=max_new)
    out["forks"] = greedy_forks(got, want, steps_c, prompts,
                                cfg.vocab_size)
    out["tokens_equal"] = got == want
    return out
