"""Roofline analysis of the LM cells: the JAX package's
``launch/analysis.py`` with the card's constants.

Three terms per (arch x shape x mesh), in seconds:

  compute    = FLOPs / (chips * PEAK_FLOPS)     [bfloat16 tensor-core peak]
  memory     = HBM bytes / (chips * HBM_BW)
  collective = collective bytes per rank / LINK_BW

The constants are an NVIDIA H100 SXM's (NVIDIA's data sheet, dense rates,
at its 700 W limit): 989e12 bfloat16 FLOP/s, 3.35e12 HBM bytes/s, 80 GB
of HBM (``HBM_BYTES``, the dry run's memory check), and NVLink's 900 GB/s
as 450e9 bytes/s each way.  ``build_roofline`` takes
them as keywords, so the reference's TPU constants can be passed too.

FLOPs and HBM bytes use exact parameter counts (``steps.abstract_params``,
meta tensors) and the reference's analytic activation and attention terms,
with the same arithmetic.

The reference parses the collective bytes out of XLA's compiled HLO.  The
port has no HLO: its collectives are the ones its sharded steps issue
(``launch/sharded.py``).  ``count_collectives`` counts them as they run,
per rank and per op, by the reference's op names; the dry run takes the
same numbers from the steps' plan (``sharded.*_plan``) without running.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.configs.base import SHAPES, ArchConfig

PEAK_FLOPS = 989e12          # bf16 / card
HBM_BW = 3.35e12             # bytes/s / card
LINK_BW = 450e9              # bytes/s / card, each way (NVLink)
HBM_BYTES = 80 * 2 ** 30     # bytes / card (H100 SXM, 80 GB)

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")


# ---------------------------------------------------------------------------
# Collective bytes
# ---------------------------------------------------------------------------

_COUNTERS: List[Dict[str, float]] = []


def zero_collectives() -> Dict[str, float]:
    return {**{k: 0.0 for k in COLLECTIVE_OPS}, "total": 0.0}


@contextlib.contextmanager
def count_collectives() -> Iterator[Dict[str, float]]:
    """Counts the bytes of every collective this rank issues inside the
    block (each op's output, as the reference counts an HLO collective's
    result shape), by op name, with their ``total``."""
    counts = zero_collectives()
    _COUNTERS.append(counts)
    try:
        yield counts
    finally:
        _COUNTERS.remove(counts)


def record(op: str, nbytes: int) -> None:
    """Adds one collective of ``op`` moving ``nbytes`` to every open
    ``count_collectives`` block."""
    if op not in COLLECTIVE_OPS:
        raise ValueError(f"not a collective: {op}")
    for counts in _COUNTERS:
        counts[op] += nbytes
        counts["total"] += nbytes


# ---------------------------------------------------------------------------
# Analytic FLOPs / bytes
# ---------------------------------------------------------------------------


def param_counts(cfg: ArchConfig) -> Dict[str, float]:
    """Exact parameter counts from the meta-device parameters."""
    return dict(_param_counts(cfg))


@functools.lru_cache(maxsize=None)
def _param_counts(cfg: ArchConfig) -> tuple:
    """``param_counts`` as an immutable tuple of items, once per config
    (the roofline's FLOPs and bytes both ask for it)."""
    from repro_torch.launch.steps import abstract_params
    from repro_torch.optim.optimizers import tree_leaves
    params = abstract_params(cfg)
    total = float(sum(np.prod(x.shape) for x in tree_leaves(params)))
    embed = float(np.prod(params["embed"].shape))
    if "unembed" in params:
        embed += float(np.prod(params["unembed"].shape))
    n_active = total
    if cfg.moe is not None:
        # routed-expert params: (w_gate + w_up + w_down) per expert
        e, d, f = (cfg.moe.num_experts, cfg.moe.d_model, cfg.moe.d_ff_expert)
        routed = cfg.n_layers * e * (3 * d * f)
        n_active = total - routed * (1.0 - cfg.moe.top_k / e)
    return (("total", total), ("embed", embed), ("active", n_active),
            ("active_nonembed", n_active - embed))


def _mixer_flops_per_token(cfg: ArchConfig, context: int) -> float:
    """Attention / SSM flops per token per layer (fwd), excluding the
    projections (those are in the parameter term)."""
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        d_attn = cfg.n_heads * cfg.head_dim
        return 2.0 * 2.0 * context * d_attn        # QK^T + AV
    if cfg.family == "xlstm":
        x = cfg.xlstm
        c = 128.0
        dk = dv = x.head_dim
        return 2.0 * x.n_heads * (c * (dk + dv) + 3 * dk * dv)
    if cfg.family == "hybrid":
        mb = cfg.mamba
        c = 128.0
        dk, dv, h = mb.d_state, mb.head_dim, mb.n_heads
        return 2.0 * h * (c * (dk + dv) + 3 * dk * dv)
    return 0.0


def analytic_flops(cfg: ArchConfig, shape_name: str) -> Dict[str, float]:
    sh = SHAPES[shape_name]
    b, s, kind = sh["global_batch"], sh["seq_len"], sh["kind"]
    pc = param_counts(cfg)
    n = pc["active_nonembed"]
    d = cfg.d_model

    if kind == "train":
        tokens = b * (s + (cfg.frontend_len if cfg.family in ("vlm",)
                           else 0))
        base = 6.0 * n * tokens                     # fwd+bwd matmuls
        mixer = 3.0 * tokens * cfg.n_layers * _mixer_flops_per_token(
            cfg, context=s / 2)
        embed_flops = 6.0 * tokens * d * cfg.vocab_padded
        return {"flops": base + mixer + embed_flops, "tokens": tokens,
                "model_flops": 6.0 * pc["active"] * tokens}
    if kind == "prefill":
        tokens = b * s
        base = 2.0 * n * tokens
        mixer = tokens * cfg.n_layers * _mixer_flops_per_token(
            cfg, context=s / 2)
        embed_flops = 2.0 * tokens * d * cfg.vocab_padded
        return {"flops": base + mixer + embed_flops, "tokens": tokens,
                "model_flops": 2.0 * pc["active"] * tokens}
    # decode: one token per sequence, attention reads the full cache
    tokens = b * 1
    base = 2.0 * n * tokens
    mixer = tokens * cfg.n_layers * _mixer_flops_per_token(cfg, context=s)
    embed_flops = 2.0 * tokens * d * cfg.vocab_padded
    return {"flops": base + mixer + embed_flops, "tokens": tokens,
            "model_flops": 2.0 * pc["active"] * tokens}


def analytic_bytes(cfg: ArchConfig, shape_name: str) -> Dict[str, float]:
    """Approximate global HBM traffic per step."""
    sh = SHAPES[shape_name]
    b, s, kind = sh["global_batch"], sh["seq_len"], sh["kind"]
    pc = param_counts(cfg)
    d = cfg.d_model
    if kind == "train":
        tokens = b * s
        # params: read fwd (bf16) + read bwd + write grads + opt update
        # (read params+m+v fp32, write params+m+v fp32)
        pbytes = pc["total"] * (2 + 2 + 4 + 6 * 4)
        # activations: remat => ~2 fwd writes + 1 bwd read of layer inputs
        abytes = 3.0 * tokens * d * cfg.n_layers * 2
        return {"bytes": pbytes + abytes}
    if kind == "prefill":
        tokens = b * s
        pbytes = pc["total"] * 2
        abytes = 2.0 * tokens * d * cfg.n_layers * 2
        cache = 2.0 * b * s * cfg.n_kv_heads * cfg.head_dim * cfg.n_layers * 2
        return {"bytes": pbytes + abytes + cache}
    # decode
    pbytes = pc["total"] * 2
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        if cfg.moe:
            pbytes = pc["active"] * 2    # only routed-to experts are touched
        cache = 2.0 * b * s * cfg.n_kv_heads * cfg.head_dim * cfg.n_layers * 2
    else:
        # recurrent state read+write
        if cfg.family == "xlstm":
            x = cfg.xlstm
            st = b * x.n_heads * x.head_dim * x.head_dim * 4
        else:
            mb = cfg.mamba
            st = b * mb.n_heads * mb.d_state * mb.head_dim * 4
        cache = 2.0 * st * cfg.n_layers
    return {"bytes": pbytes + cache}


# ---------------------------------------------------------------------------
# Roofline assembly
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    hlo_flops: float               # the analytic total (the reference's name)
    cost_analysis_flops: Optional[float]
    collective_bytes: float
    bytes_per_device: Optional[float]
    peak_flops: float = PEAK_FLOPS

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / max(self.hlo_flops, 1.0)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / max(terms): the bound with perfect
        compute / communication overlap."""
        ideal = self.model_flops / (self.chips * self.peak_flops)
        return ideal / max(self.bound_s, 1e-30)

    @property
    def roofline_fraction_serial(self) -> float:
        """useful-compute time / sum(terms): the bound with no overlap."""
        ideal = self.model_flops / (self.chips * self.peak_flops)
        return ideal / max(self.compute_s + self.memory_s
                           + self.collective_s, 1e-30)

    def as_dict(self):
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant, useful_ratio=self.useful_ratio,
                 roofline_fraction=self.roofline_fraction,
                 roofline_fraction_serial=self.roofline_fraction_serial,
                 bound_s=self.bound_s)
        return d


def build_roofline(cfg: ArchConfig, shape_name: str, chips: int,
                   collectives: Dict[str, float],
                   cost_flops: Optional[float] = None,
                   bytes_per_device: Optional[float] = None, *,
                   peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                   link_bw: float = LINK_BW) -> Roofline:
    """The roofline of one cell; ``collectives`` holds the per-rank
    collective bytes by op with their ``total`` (``count_collectives`` or
    the dry run's plan)."""
    fl = analytic_flops(cfg, shape_name)
    by = analytic_bytes(cfg, shape_name)
    coll_bytes = collectives["total"]
    return Roofline(
        arch=cfg.name, shape=shape_name, chips=chips,
        compute_s=fl["flops"] / (chips * peak_flops),
        memory_s=by["bytes"] / (chips * hbm_bw),
        collective_s=coll_bytes / link_bw,   # per-rank bytes already
        model_flops=fl["model_flops"],
        hlo_flops=fl["flops"],
        cost_analysis_flops=cost_flops,
        collective_bytes=coll_bytes,
        bytes_per_device=bytes_per_device,
        peak_flops=peak_flops,
    )
