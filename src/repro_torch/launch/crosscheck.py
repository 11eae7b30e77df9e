"""The LM stack on the card against its own CPU path, on the same
parameters: the checks, their tolerances and the rule for greedy tokens,
shared by ``chip_smoke.py`` (phases 16 and 17) and
``tests/test_torch_cuda.py``.

Serving: every element within ``LM_ULPS`` bfloat16 ulps of the CPU
tensor's largest magnitude.  cuBLAS sums the bfloat16 products in another
order than the CPU, and CUDA's ``exp``, ``sin``, ``cos`` and ``rsqrt`` are
not the CPU's, so a bfloat16 rounding flips now and then and the flip
travels through the layers.  Greedy tokens: equal, or forked only where
the CPU's top-2 margin at the fork is within the same ``LM_ULPS``.

Routing (the ``moe`` family): the card's experts are the CPU's, token by
token and rank by rank, except where the CPU's router logits at the first
rank that differs are within ``ROUTE_ULPS`` bfloat16 ulps (of the token's
largest logit) of the next rank's: a near-tie that an ulp of the card's
logits can turn (``route_forks``).  Each fork is reported with its gap;
the outputs after it are held to the same tolerances as everywhere.

The encoder-decoder family (``encdec_card_against_cpu``), which the
``Server`` does not serve (nor does the reference's), runs the reference's
prefill and decode cells (``encdec_generate``) and is held as the dense
family is, its encoder's memory too.

The parameter draw (``jaxrand``, correctly rounded operations only) is
bitwise the CPU's.  Training (``train_step_card_against_cpu``): the same
flips travel back through the backward's bfloat16 cotangents, so the
tolerances are those that hold the port's CPU step to the JAX package's
(``tests/_lm_train_cases.py``): the loss within ``TRAIN_LOSS_RTOL``, each
gradient leaf (and ``mu``) within ``TRAIN_GRAD_SHARE`` of its largest
magnitude (``nu`` twice that), the new parameters within two learning
rates and ``TRAIN_PARAMS_EQUAL`` of them bit-equal (Adam's first step is
about ``-lr * sign(g)``); the recurrent families with the loss and
gradient tolerances their CPU tests state (``TRAIN_FAMILY``).

The recurrent families carry each flip down the recurrence to every
later position, so they are held to their own ``LM_ULPS_FAMILY``
(``lm_ulps``), about twice the largest gap ``chip_smoke.py`` measured
on an H100: the reduced xLSTM's logits 5.0 ulps from the CPU's, its
float32 matrix state 7.63, and at full width an 8-token forward 6.08
from its own teacher-forced decode (zamba2: 2.0, 1.59 and 3.0).  Their
caches (conv windows, float32 matrix and sLSTM states, the zamba2 shared
block's K/V) are held leaf by leaf to the same limit.  Their train step
is held to loss rtol 5e-4 and gradients 6e-2 (``TRAIN_FAMILY``): the
reference's own loss moves by up to 2e-4 when one embedding element
moves by one bfloat16 ulp (``tests/test_torch_xlstm.py``).
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core import jaxrand
from repro_torch.data.tokens import TokenPipelineConfig, batch_at_step
from repro_torch.launch import serve, steps, train
from repro_torch.models import encdec as ED
from repro_torch.models import lm as LM
from repro_torch.models import moe as MOE
from repro_torch.optim.optimizers import tree_leaves

LM_ULPS = 4
LM_ULPS_FAMILY = {"xlstm": 16, "hybrid": 6}
ROUTE_ULPS = LM_ULPS
TRAIN_LOSS_RTOL = 2e-4
TRAIN_GRAD_SHARE = 3e-2
TRAIN_PARAMS_EQUAL = 0.99
RESUME_ATOL = 1e-4          # the reference's resume test
# loss rtol and gradient share of a train step, per family where the
# recurrence carries a bfloat16 flip to every later position (the CPU
# tests against the JAX package state them too)
TRAIN_FAMILY = {"xlstm": (5e-4, 6e-2), "hybrid": (5e-4, 6e-2)}


def lm_ulps(cfg) -> float:
    """The serving tolerance of ``cfg``'s family, in bfloat16 ulps."""
    return LM_ULPS_FAMILY.get(cfg.family, LM_ULPS)


def _ulp(t: torch.Tensor) -> float:
    """One bfloat16 ulp of ``t``'s largest magnitude."""
    return 2.0 ** (torch.floor(torch.log2(t.abs().max())).item() - 7)


def ulps_apart(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| in bfloat16 ulps of ``want``'s largest
    magnitude."""
    g, w = got.float().cpu(), want.float().cpu()
    return float((g - w).abs().max()) / _ulp(w)


def route_forks(got: List[Dict], want: List[Dict]) -> List[Dict]:
    """The routing ``got`` (``models.moe.record_routes``' list of one run)
    against ``want`` (the CPU's run of the same calls): each token whose
    ordered experts differ, with the call, the first rank that differs
    and the CPU's logit gap there to the next rank in bfloat16 ulps of the
    token's largest logit.  A gap past ``ROUTE_ULPS`` raises
    ``AssertionError``."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} routed calls against {len(want)}")
    forks = []
    for c, (g, w) in enumerate(zip(got, want)):
        diff = g["expert_idx"].cpu() != w["expert_idx"].cpu()
        if not bool(diff.any()):
            continue
        logits = torch.sort(w["logits"].cpu(), dim=-1, descending=True,
                            stable=True).values
        for b, t in diff.any(-1).nonzero().tolist():
            r = int(diff[b, t].nonzero()[0])
            row = logits[b, t]
            gap = float(row[r] - row[r + 1]) / _ulp(row)
            if gap > ROUTE_ULPS:
                raise AssertionError(
                    f"call {c} row {b} token {t}: the experts differ at "
                    f"rank {r}, the CPU's logit gap {gap:.2f} ulps")
            forks.append(dict(call=c, row=b, token=t, rank=r,
                              gap_ulps=gap))
    return forks


def greedy_forks(got: List[List[int]], want: List[List[int]],
                 steps_logits: List[torch.Tensor], prompts, vocab: int,
                 ulps: float = LM_ULPS) -> List[Dict]:
    """Greedy tokens ``got`` against ``want``, whose server's decode steps
    gave ``steps_logits`` (one (Vpad,) row a step, in order): the forks,
    each where ``want``'s top-2 margin is within ``ulps``; a fork past
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
                if margin > ulps:
                    raise AssertionError(
                        f"request {r} token {j}: {a} against {b}, the "
                        f"reference's top-2 margin {margin:.2f} ulps")
                forks.append(dict(request=r, token=j, margin_ulps=margin))
                break
        step += len(w)
    return forks


def routed(run):
    """``run()`` and the routing of its ``moe_apply`` calls
    (``models.moe.record_routes``): (result, routes)."""
    with MOE.record_routes() as routes:
        res = run()
    return res, routes


def card_against_cpu(arch: str, device, steps: int = 8, requests: int = 4,
                     max_new: int = 8) -> Dict:
    """``arch``'s reduced config on ``device`` against the CPU, each
    server with its own draw from ``PRNGKey(0)`` (nothing carried in; the
    draws must be bitwise equal): prefill's last logits and caches (the
    VLM with its prefix frames), ``steps`` teacher-forced decode steps
    (logits and caches), and the servers' greedy tokens on ``main()``'s
    traffic; for the ``moe`` family the routing of the prefill and of each
    step (``route_forks``).  Returns the gaps in ulps, the token forks and
    (MoE) the routing forks; raises ``AssertionError`` on a draw that
    differs, past ``lm_ulps(cfg)`` or on a fork past its margin."""
    cpu = serve.Server(arch, reduced=True, device="cpu")
    card = serve.Server(arch, reduced=True, device=device)
    cfg = cpu.cfg
    # each server drew its own parameters from PRNGKey(0): bit for bit
    for a, b in zip(LM.leaves(card.params), LM.leaves(cpu.params)):
        if a.device != card.device or not torch.equal(a.cpu(), b):
            raise AssertionError(f"{arch}: the server's draw on "
                                 f"{card.device} is not the CPU's")
    rng = np.random.default_rng(1)
    tokens = rng.integers(2, cfg.vocab_size, (2, steps))
    frames = None
    if cfg.family == "vlm":
        frames = torch.tensor(rng.standard_normal(
            (2, cfg.frontend_len, cfg.d_model)), dtype=torch.float32)
    pc, rc = routed(lambda: LM.prefill(cpu.params, cfg, tokens,
                                       prefix_embeds=frames))
    pg, rg = routed(lambda: LM.prefill(
        card.params, cfg, tokens, prefix_embeds=None
        if frames is None else frames.to(card.device)))
    if pg[0].device != card.device:
        raise AssertionError(f"{arch}: prefill ran on {pg[0].device}")
    forks = {"prefill": route_forks(rg, rc), "decode": []}

    def caches_apart(g, c):
        return max(0.0 if torch.equal(a.cpu(), b) else ulps_apart(a, b)
                   for a, b in zip(LM.leaves(g), LM.leaves(c)))
    out = {"prefill_ulps": ulps_apart(pg[0], pc[0]),
           "prefill_cache_ulps": caches_apart(pg[1], pc[1]),
           "decode_ulps": 0.0, "decode_cache_ulps": 0.0}
    cc = LM.init_cache(cfg, 2, steps, device="cpu")
    cg = LM.init_cache(cfg, 2, steps, device=card.device)
    for t in range(steps):
        tok = tokens[:, t:t + 1]
        (lc, cc), rc = routed(lambda: LM.decode_step(cpu.params, cfg, tok,
                                                     cc, t))
        (lg, cg), rg = routed(lambda: LM.decode_step(card.params, cfg, tok,
                                                     cg, t))
        forks["decode"] += [dict(f, step=t) for f in route_forks(rg, rc)]
        out["decode_ulps"] = max(out["decode_ulps"], ulps_apart(lg, lc))
        out["decode_cache_ulps"] = max(out["decode_cache_ulps"],
                                       caches_apart(cg, cc))
    limit = lm_ulps(cfg)
    for key, v in out.items():
        if not v <= limit:
            raise AssertionError(f"{arch}: {key} {v:.2f} > {limit} "
                                 f"(routing forks {forks})")
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
                                cfg.vocab_size, limit)
    out["tokens_equal"] = got == want
    if cfg.family == "moe":
        out["route_forks"] = forks
    return out


# ---------------------------------------------------------------------------
# the encoder-decoder family
# ---------------------------------------------------------------------------


def encdec_frames(cfg, n: int, seed: int) -> torch.Tensor:
    """``n`` requests' stub frame embeddings (n, frontend_len, d_model),
    float32 standard normals from ``default_rng(seed)``, on the CPU."""
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.standard_normal(
        (n, cfg.frontend_len, cfg.d_model)), dtype=torch.float32)


def encdec_generate(params, cfg, prompts, frames, max_new: int,
                    max_len: int = 128, prefill=None, decode=None):
    """Greedy decoding of the encdec family through the reference's
    prefill and decode cells (its ``Server`` serves decoder LMs only).
    Per request: ``make_prefill_step`` on its frames (S_enc, D) and its
    prompt (encode and prefill), then a fresh ``init_dec_cache(max_len)``
    fed the prompt teacher-forced through ``make_decode_step`` against the
    prefill's memory, then ``max_new`` greedy tokens over the real
    vocabulary, as ``serve.Server`` serves (the first greedy step takes
    the prompt's last token).  ``prefill`` / ``decode`` replace the built
    steps (a caller's timing wrappers).  Returns (tokens per request,
    records per request: the prefill's logits, K/V and memory, every
    step's (Vpad,) logits, and the decode cache's first S positions after
    the prompt's last token)."""
    dev = params["embed"].device
    prefill = prefill or steps.make_prefill_step(cfg)
    decode = decode or steps.make_decode_step(cfg)
    outs, records = [], []
    for prompt, fr in zip(prompts, frames):
        ids = torch.as_tensor(np.asarray(prompt), dtype=torch.long,
                              device=dev)[None, :]
        s = ids.shape[1]
        last, kv, memory = prefill(params, {
            "frames": torch.as_tensor(fr, device=dev)[None],
            "tokens": ids})
        cache = ED.init_dec_cache(cfg, 1, max_len, device=dev)
        rec = {"prefill": last, "kv": kv, "memory": memory, "steps": []}
        tok, generated = ids[:, :1], []
        for pos in range(s - 1 + max_new):
            logits, cache = decode(params, cache, {
                "tokens": tok, "memory": memory, "index": pos})
            rec["steps"].append(logits[0, -1])
            if pos < s - 1:                       # teacher-forced prompt
                tok = ids[:, pos + 1:pos + 2]
                continue
            if pos == s - 1:
                rec["cache"] = {k: v[:, :, :s] for k, v in cache.items()}
            tok = torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1,
                               keepdim=True)
            generated.append(int(tok))
        outs.append(generated)
        records.append(rec)
    return outs, records


def encdec_card_against_cpu(arch: str, device, steps_n: int = 8,
                            requests: int = 4, max_new: int = 8) -> Dict:
    """The encdec ``arch``'s reduced config on ``device`` against the CPU,
    each with its own bfloat16 draw from ``PRNGKey(0)`` (bitwise equal):
    ``make_prefill_step`` on frames from a numpy seed and ``steps_n``
    tokens (last logits, every K/V leaf, the memory), ``steps_n``
    teacher-forced ``make_decode_step`` steps against each side's memory
    (logits and cache), and ``encdec_generate``'s greedy tokens on
    ``main()``'s prompts, each request with its own seeded frames (forks
    only within the top-2 margin).  Returns the gaps in ulps and the
    forks; raises ``AssertionError`` past ``lm_ulps(cfg)``."""
    cfg = serve.get_config(arch).reduced()
    key = jaxrand.PRNGKey(0, device="cpu")
    cpu = steps.init_params_for(cfg, key, device="cpu")
    card = steps.init_params_for(cfg, key, device=device)
    for a, b in zip(LM.leaves(card), LM.leaves(cpu)):
        if a.device.type != torch.device(device).type or \
                not torch.equal(a.cpu(), b):
            raise AssertionError(f"{arch}: the draw on {device} is not "
                                 f"the CPU's")
    rng = np.random.default_rng(1)
    tokens = torch.tensor(rng.integers(2, cfg.vocab_size, (2, steps_n)))
    frames = encdec_frames(cfg, 2, 1)
    prefill = steps.make_prefill_step(cfg)
    decode = steps.make_decode_step(cfg)
    pc = prefill(cpu, {"frames": frames, "tokens": tokens})
    pg = prefill(card, {"frames": frames.to(device),
                        "tokens": tokens.to(device)})
    if pg[0].device.type != torch.device(device).type:
        raise AssertionError(f"{arch}: prefill ran on {pg[0].device}")

    def apart(g, c):
        return max(0.0 if torch.equal(a.cpu(), b) else ulps_apart(a, b)
                   for a, b in zip(LM.leaves(g), LM.leaves(c)))
    out = {"prefill_ulps": ulps_apart(pg[0], pc[0]),
           "prefill_cache_ulps": apart(pg[1], pc[1]),
           "memory_ulps": apart(pg[2], pc[2]),
           "decode_ulps": 0.0, "decode_cache_ulps": 0.0}
    cc = ED.init_dec_cache(cfg, 2, steps_n, device="cpu")
    cg = ED.init_dec_cache(cfg, 2, steps_n, device=device)
    for t in range(steps_n):
        lc, cc = decode(cpu, cc, {"tokens": tokens[:, t:t + 1],
                                  "memory": pc[2], "index": t})
        lg, cg = decode(card, cg, {"tokens": tokens[:, t:t + 1].to(device),
                                   "memory": pg[2], "index": t})
        out["decode_ulps"] = max(out["decode_ulps"], ulps_apart(lg, lc))
        out["decode_cache_ulps"] = max(out["decode_cache_ulps"],
                                       apart(cg, cc))
    limit = lm_ulps(cfg)
    for key_, v in out.items():
        if not v <= limit:
            raise AssertionError(f"{arch}: {key_} {v:.2f} > {limit}")
    prompts = serve.prompts_for(cfg, requests)
    req_frames = encdec_frames(cfg, requests, 2)
    want, rec_c = encdec_generate(cpu, cfg, prompts, req_frames, max_new)
    got, _ = encdec_generate(card, cfg, prompts, req_frames.to(device),
                             max_new)
    out["forks"] = greedy_forks(got, want, [x for r in rec_c
                                            for x in r["steps"]],
                                prompts, cfg.vocab_size, limit)
    out["tokens_equal"] = got == want
    return out


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def init_card_against_cpu(arch: str, device) -> Dict:
    """``arch``'s reduced parameters drawn from ``PRNGKey(0)`` on
    ``device`` and on the CPU, as float32 (training) and bfloat16
    (serving) leaves: bitwise equal, or ``AssertionError``."""
    cfg = serve.get_config(arch).reduced()
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        got, want = (tree_leaves(steps.init_params_for(
            cfg, jaxrand.PRNGKey(0, device="cpu"), device=d, dtype=dtype))
            for d in (device, "cpu"))
        for a, b in zip(got, want):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"{arch}: the {dtype} draw on "
                                     f"{device} is not the CPU's")
            n += b.numel()
    return {"leaves": len(want), "elements": n}


def _shares(got, want) -> List[float]:
    """Per leaf: max |got - want| over max |want|."""
    out = []
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        w = w.detach().float()
        gap = float((g.detach().float().cpu() - w).abs().max())
        out.append(gap / max(float(w.abs().max()), 1e-30))
    return out


def train_step_card_against_cpu(arch: str, device, batch: int = 2,
                                seq: int = 32) -> Dict:
    """One ``make_train_step`` step of ``arch``'s reduced config on
    ``device`` against the CPU, from the same float32 ``PRNGKey(0)``
    parameters and the token pipeline's step-0 batch (the VLM's prefix
    frames ones, the encdec family's frames seeded normals), and
    ``loss_and_grads``' gradients on both; for the ``moe`` family the
    routing forks of each of the two runs (``route_forks``).  Returns the gaps; raises ``AssertionError`` past
    the training tolerances."""
    cfg = serve.get_config(arch).reduced()
    params = steps.init_params_for(cfg, jaxrand.PRNGKey(0, device="cpu"),
                                   device="cpu", dtype=torch.float32)
    pipe = TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                               global_batch=batch)
    tokens, labels = batch_at_step(pipe, 0)
    opt = steps.make_optimizer(cfg)
    step = steps.make_train_step(cfg, opt)
    runs = {}
    for d in ("cpu", device):
        p = LM.tree_map(lambda a: a.to(d), params)
        b = train.model_batch(cfg, tokens, labels, d)
        if cfg.family == "encdec":
            # ones frames make the encoder's attention uniform, its wq and
            # wk gradients rounding noise on both sides: seeded frames
            b["frames"] = encdec_frames(cfg, batch, 0).to(
                d, torch.bfloat16)
        (_, grads), r_grads = routed(lambda: steps.loss_and_grads(cfg, p, b))
        res, r_step = routed(lambda: step(p, opt.init(p), b))
        runs[str(d)] = dict(grads=grads, out=res, routes=(r_grads, r_step))
    cpu, card = runs["cpu"], runs[str(device)]
    forks = {k: len(route_forks(g, c)) for k, g, c in zip(
        ("loss_and_grads", "step"), card["routes"], cpu["routes"])}
    if next(iter(tree_leaves(card["grads"]))).device.type != \
            torch.device(device).type:
        raise AssertionError(f"{arch}: the step did not run on {device}")
    lr = float(opt.schedule(1))
    p_c, o_c, m_c = cpu["out"]
    p_g, o_g, m_g = card["out"]
    equal = total_n = 0
    for g, w in zip(tree_leaves(p_g), tree_leaves(p_c)):
        g = g.cpu()
        allowed = 2 * lr + 2 * torch.finfo(torch.float32).eps * w.abs()
        if not bool(((g - w).abs() <= allowed).all()):
            raise AssertionError(f"{arch}: a parameter moved past 2 lr")
        equal += int((g == w).sum())
        total_n += w.numel()
    out = {"loss_cpu": float(m_c["loss"]), "loss_card": float(m_g["loss"]),
           "params_equal": equal / total_n,
           "grad_share": max(_shares(card["grads"], cpu["grads"])),
           "mu_share": max(_shares(o_g.mu, o_c.mu)),
           "nu_share": max(_shares(o_g.nu, o_c.nu)),
           "route_forks": forks}
    out["loss_rtol"] = abs(out["loss_card"] - out["loss_cpu"]) / abs(
        out["loss_cpu"])
    loss_rtol, share = TRAIN_FAMILY.get(cfg.family, (TRAIN_LOSS_RTOL,
                                                     TRAIN_GRAD_SHARE))
    for key, limit in (("loss_rtol", loss_rtol), ("grad_share", share),
                       ("mu_share", share), ("nu_share", 2 * share)):
        if not out[key] <= limit:
            raise AssertionError(f"{arch}: {key} {out[key]:.3g} > {limit} "
                                 f"(routing forks {forks})")
    if not out["params_equal"] >= TRAIN_PARAMS_EQUAL:
        raise AssertionError(f"{arch}: {out['params_equal']:.4f} of the "
                             f"parameters bit-equal")
    return out


def resume_against_straight(arch: str, device, root: str, n: int = 12,
                            fail_at: int = 9, ckpt_every: int = 4,
                            batch: int = 4, seq: int = 32) -> Dict:
    """The reference's fault-tolerance test on ``device``: ``n`` steps of
    ``train_loop`` straight, against a run that fails at ``fail_at`` and
    resumes from its last checkpoint (under ``root``).  The final losses
    must be within ``RESUME_ATOL``; returns them, whether the two runs
    are bit for bit equal (losses and parameters) and the leaves that
    differ."""
    kw = dict(reduced=True, batch=batch, seq=seq, ckpt_every=ckpt_every,
              log_every=10 ** 9, device=device)
    p_a, straight = train.train_loop(arch, n, ckpt_dir=os.path.join(
        root, "straight"), **kw)
    try:
        train.train_loop(arch, n, ckpt_dir=os.path.join(root, "failed"),
                         fail_at=fail_at, **kw)
    except RuntimeError as e:
        if "simulated node failure" not in str(e):
            raise
    else:
        raise AssertionError(f"{arch}: no simulated failure at {fail_at}")
    p_b, resumed = train.train_loop(arch, n, ckpt_dir=os.path.join(
        root, "failed"), **kw)
    differ = [i for i, (x, y) in enumerate(zip(tree_leaves(p_a),
                                               tree_leaves(p_b)))
              if not torch.equal(x, y)]
    out = {"straight": straight["loss"], "resumed": resumed["loss"],
           "gap": abs(straight["loss"] - resumed["loss"]),
           "bitwise": straight == resumed and not differ,
           "leaves_differ": differ}
    if not out["gap"] < RESUME_ATOL:
        raise AssertionError(f"{arch}: resumed loss {resumed['loss']} "
                             f"against {straight['loss']}")
    return out
