"""Shared layer library of the LM stack: norms, rotary position
embeddings, dense projections, attention (MHA / GQA, optional QK-norm and
bias) with its KV cache, the SwiGLU / GeLU MLP, and the chunked gated
linear attention core (``gated_linear_attention``, ``gla_step``) that
Mamba2 and mLSTM run on.

Every layer is an (init, apply) pair over explicit parameter dicts, as in
the JAX package's ``models/layers.py``.  Products run in bfloat16 with
float32 accumulation (``float32_accumulation``, which the LM's entry points
hold), reductions in float32.  The inits draw from a ``core.jaxrand`` key
down the reference's ``split`` tree, so a key gives the reference's
numbers bit for bit.  The reference keeps float32 leaves and casts them to
bfloat16 at every use: the port stores its leaves as ``dtype``, float32
for training (the reference's leaves, whose gradients are float32) or
bfloat16 for serving (that cast stored once, the same numbers), and keeps
the norm scales in float32, where the reference uses them.

``ShardingPolicy`` maps the activations' logical axes onto mesh axes, as
the reference's does: its helpers (``btd``, ``btf``, ``bthd``, ``btv``,
``bt_seq_sharded``) are the identity on a plain tensor and redistribute a
``DTensor`` to the placement its ``Spec`` names.  The model functions do
not take a policy: the sharded steps of ``launch/sharded.py`` run them on
plain tensors, a rank's rows of the batch, and read the policy's
``data_axes`` for the axes that split the batch (the loss, the gradients
and the MoE router's statistics are summed over them).  The reference's
``serve_mode`` knob is not carried over: it picks the lowering of the
reference's cache write (masked or dynamic-update-slice, the same
numbers), which the port does not have.

Numerics against the reference on the CPU: ``rmsnorm`` and ``layernorm``
take their means as ``core.means`` does (the sum times the float32
reciprocal, as XLA compiles ``jnp.mean``), but XLA's CPU code sums the
squares in another order and takes ``rsqrt`` as an estimate refined by a
Newton step (about one in seven results is an ulp off the correctly
rounded one), and its jitted ``pow``, ``sin`` and ``cos`` are not torch's
either.  The bfloat16 products sum in another order than XLA's, and XLA
may skip a bfloat16 rounding inside a fusion.  So a float32 result can
differ from the reference's by an ulp or a few, and a bfloat16 one by an
ulp (``tests/test_torch_lm.py`` states each tolerance and its cause).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import jaxrand, means

COMPUTE_DTYPE = torch.bfloat16
MASK_VALUE = -1e30


# ---------------------------------------------------------------------------
# Sharding policy
# ---------------------------------------------------------------------------


class Spec(tuple):
    """A partition spec, JAX's ``PartitionSpec`` as a tuple: entry ``i``
    names the mesh axes that split tensor dimension ``i`` (``None``, an
    axis name, or a tuple of names, the first the outermost); dimensions
    past the last entry are whole.  A one-name tuple is stored as the
    name, as ``PartitionSpec`` stores it, so ``tuple(spec)`` equals
    ``tuple(PartitionSpec(...))`` for the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"

    def axes(self, dim: int) -> Tuple[str, ...]:
        """The mesh axes that split dimension ``dim``, outermost first."""
        e = self[dim] if dim < len(self) else None
        return () if e is None else (e,) if isinstance(e, str) else e


def placements(spec: Spec, mesh_dim_names) -> list:
    """``spec`` as ``DTensor`` placements, one per mesh dimension:
    ``Shard(d)`` where the mesh axis splits tensor dimension ``d``, else
    ``Replicate()``.  A DTensor shards a dimension over its mesh dims in
    mesh order, outermost first, so the axes of one entry must come in
    mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_dim_names)
    out = [Replicate()] * len(names)
    for d in range(len(spec)):
        axes = spec.axes(d)
        where = [names.index(a) for a in axes]
        if where != sorted(where):
            raise ValueError(f"{spec}: the axes {axes} of dimension {d} "
                             f"are not in the mesh's order {names}")
        for i in where:
            out[i] = Shard(d)
    return out


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """Maps logical activation axes onto mesh axes (the reference's
    ``ShardingPolicy``, field for field).

    data_axes: mesh axes carrying the batch (e.g. ("pod", "data")).
    model_axis: mesh axis for tensor / expert parallelism.
    fsdp_axis: mesh axis over which parameters and optimizer state are
      sharded; None disables FSDP.
    enabled=False turns every constraint into a no-op.
    axis_sizes: the mesh's axis sizes, for the divisibility checks.
    ep_axis: the MoE expert-parallel axis, "model" or "data".
    """

    data_axes: Tuple[str, ...] = ()
    model_axis: Optional[str] = None
    fsdp_axis: Optional[str] = None
    enabled: bool = False
    axis_sizes: Optional[Dict[str, int]] = None
    ep_axis: str = "model"

    def size(self, axis) -> int:
        if not self.axis_sizes:
            return 1
        if isinstance(axis, tuple):
            n = 1
            for a in axis:
                n *= self.axis_sizes.get(a, 1)
            return n
        return self.axis_sizes.get(axis, 1)

    def _maybe(self, x: torch.Tensor, spec: Spec) -> torch.Tensor:
        from torch.distributed.tensor import DTensor
        if not self.enabled or not isinstance(x, DTensor):
            return x
        mesh = x.device_mesh
        return x.redistribute(mesh, placements(spec, mesh.mesh_dim_names))

    # logical constraint helpers ------------------------------------------
    def btd(self, x):            # (batch, seq, d_model)
        return self._maybe(x, Spec(self.data_axes or None, None, None))

    def btf(self, x):            # (batch, seq, ff/hidden): TP-sharded cols
        return self._maybe(x, Spec(self.data_axes or None, None,
                                   self.model_axis))

    def bthd(self, x):           # (batch, seq, heads, head_dim)
        h = x.shape[2]
        tp = self.size(self.model_axis)
        head_ax = self.model_axis if (tp > 1 and h % tp == 0) else None
        return self._maybe(x, Spec(self.data_axes or None, None, head_ax,
                                   None))

    def btv(self, x):            # (batch, seq, vocab): logits
        return self._maybe(x, Spec(self.data_axes or None, None,
                                   self.model_axis))

    def bt_seq_sharded(self, x):  # sequence parallelism for long KV caches
        return self._maybe(x, Spec(None, self.data_axes or None, None,
                                   None))


NO_SHARDING = ShardingPolicy()


@contextlib.contextmanager
def float32_accumulation():
    """cuBLAS accumulates bfloat16 products in float32 inside (torch's
    default lets it reduce them at lower precision); the setting is
    restored on exit.  On the CPU it changes nothing."""
    matmul = torch.backends.cuda.matmul
    keep = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = keep


# elements of one chunk of a draw: the int64 counters and the float64
# temporaries of the normal of a 2**26-element chunk take ~0.5 GB each
DRAW_CHUNK = 1 << 26


def draw_normal(key: torch.Tensor, shape, scale: float, device,
                dtype=COMPUTE_DTYPE) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32) * scale`` on ``device``,
    stored as ``dtype``; on the meta device the shape only.  In the
    partitionable threefry an element's draw depends on its flat index
    alone, so the draw goes in chunks of ``DRAW_CHUNK`` counters
    (``jaxrand.bits_at``), each written into its slice of the leaf."""
    dev = torch.device(device)
    out = torch.empty(shape, dtype=dtype, device=dev)
    if dev.type == "meta":
        return out
    key = key.to(dev)
    flat = out.view(-1)
    # the reference multiplies by a weakly typed scalar: by its float32
    s = float(np.float32(scale))
    for start in range(0, flat.numel(), DRAW_CHUNK):
        stop = min(flat.numel(), start + DRAW_CHUNK)
        idx = torch.arange(start, stop, dtype=torch.int64, device=dev)
        x = jaxrand.normal_from_bits(jaxrand.bits_at(key, idx))
        flat[start:stop] = (x * s).to(dtype)
    return out


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, device=None) -> Dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rmsnorm(p: Dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = means.mean(xf * xf, -1).unsqueeze(-1)
    y = xf * torch.rsqrt(var + eps) * p["scale"]
    return y.to(x.dtype)


def layernorm_init(d: int, device=None) -> Dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layernorm(p: Dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = means.mean(xf, -1).unsqueeze(-1)
    centered = xf - mu
    var = means.mean(centered * centered, -1).unsqueeze(-1)
    y = centered * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float = 1e4,
               device=None) -> torch.Tensor:
    """``1 / theta ** (2i / head_dim)`` for i < head_dim / 2, float32, as
    XLA computes the reference's: its simplifier rewrites ``1 / pow(theta,
    x)`` into ``pow(theta, -x)``, one correctly rounded power (a quotient
    of the rounded power parts from it in 4 of 16 frequencies at head_dim
    32: ``tests/_encdec_sweep.py --rope``).  The power is taken in float64
    and rounded once, the same bits on every host and on the card."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return torch.pow(float(theta), -exps.double()).float()


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """What ``_rotate`` multiplies by, for positions (B, S) or (S,)
    (``lm.decode_step`` makes them once for every layer of a step): the
    float64 (B, S, 1, 2, hd/2) table of [cos, sin] and the float32 one of
    [-sin, cos].  The angles are the reference's float32 products; their
    cosines and sines are taken in float64 and rounded once to float32, so
    each is the correctly rounded float32 value on every host and on the
    card.  XLA's CPU code calls the C library's ``cosf`` / ``sinf``
    (glibc's: 1.5% of cosines and 1.3% of sines of random angles in [-100,
    100] are not correctly rounded; ``tests/_encdec_sweep.py --rope``):
    where it parts from the rounded value, so does the port, by one
    float32 ulp of a table entry."""
    freqs = rope_freqs(head_dim, theta, device=positions.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = (positions[..., None].float() * freqs).double()   # (B, S, hd/2)
    cos, sin = torch.cos(ang).float(), torch.sin(ang).float()
    return (torch.stack([cos, sin], -2)[:, :, None].double(),
            torch.stack([-sin, cos], -2)[:, :, None])


def _rotate(x: torch.Tensor, tables) -> torch.Tensor:
    """x: (B, S, H, hd) rotated by ``rope_tables``, as XLA's CPU code
    computes the reference's ``x1 * cos - x2 * sin`` and ``x1 * sin + x2 *
    cos``: LLVM contracts each into one fused multiply-add of the first
    product onto the rounded second, ``fma(x1, cos, -(x2 * sin))`` and
    ``fma(x1, sin, x2 * cos)``.  Both halves at once: x1 times the float64
    table is exact (24 by 24 bits at most), x2 times the float32 one is
    rounded to float32, and their float64 sum is rounded once to float32,
    the same bits on every host and on the card (2 of 4.2 M bfloat16
    outputs at positions 0-255 part from XLA's, where a rotation of two
    roundings with torch's float32 tables parted in 350:
    ``tests/_encdec_sweep.py --rope``).  The mixed-type products promote
    as they load, so a call is five elementwise launches."""
    exact, rounded = tables
    x1, x2 = torch.chunk(x, 2, dim=-1)
    out = (x1[..., None, :] * exact + x2[..., None, :] * rounded).float()
    return out.flatten(-2).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,)."""
    return _rotate(x, rope_tables(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# Dense projections
# ---------------------------------------------------------------------------


def dense_init(key: torch.Tensor, d_in: int, d_out: int,
               bias: bool = False, scale: Optional[float] = None,
               device=None, dtype=COMPUTE_DTYPE) -> Dict:
    scale = scale if scale is not None else d_in ** -0.5
    p = {"w": draw_normal(key, (d_in, d_out), scale, device, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p: Dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


# ---------------------------------------------------------------------------
# Attention (MHA / GQA, optional QK-norm & bias), with KV-cache support
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False            # qwen3 style
    rope_theta: float = 1e4
    causal: bool = True


def attn_init(key: torch.Tensor, cfg: AttnConfig, device=None,
              dtype=COMPUTE_DTYPE) -> Dict:
    k1, k2, k3, k4 = jaxrand.split(key, 4)
    p = {
        "wq": dense_init(k1, cfg.d_model, cfg.n_heads * cfg.head_dim,
                         cfg.qkv_bias, device=device, dtype=dtype),
        "wk": dense_init(k2, cfg.d_model, cfg.n_kv_heads * cfg.head_dim,
                         cfg.qkv_bias, device=device, dtype=dtype),
        "wv": dense_init(k3, cfg.d_model, cfg.n_kv_heads * cfg.head_dim,
                         cfg.qkv_bias, device=device, dtype=dtype),
        "wo": dense_init(k4, cfg.n_heads * cfg.head_dim, cfg.d_model,
                         device=device, dtype=dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(cfg.head_dim, device)
        p["k_norm"] = rmsnorm_init(cfg.head_dim, device)
    return p


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, Hkv * n_rep, hd), each kv head repeated
    ``n_rep`` times in place (``jnp.repeat`` on the head axis)."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _write_cache(buf: torch.Tensor, new: torch.Tensor, index: int) -> None:
    """``dynamic_update_slice_in_dim(buf, new, index, axis=1)`` written
    into ``buf``: the start is clamped so that the slice fits, as XLA
    clamps it."""
    s = new.shape[1]
    start = min(max(int(index), 0), buf.shape[1] - s)
    buf[:, start:start + s] = new.to(buf.dtype)


def attention(p: Dict, cfg: AttnConfig, x: torch.Tensor,
              rope: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache: Optional[Dict] = None,
              cache_index=None,
              kv_override: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self- (or cross-, via ``kv_override``) attention.

    rope: ``rope_tables`` of the positions of x's tokens, which rotate q
    and k; ``None`` means ``arange(s)`` (plus ``cache_index``), the only
    positions the reference's LM passes.
    cache: {"k", "v"} of (B, S_max, Hkv, hd) for incremental decoding; the
    new kv is written into these buffers at ``cache_index`` (an int or a
    0-dim tensor), and they are returned as the new cache (callers that
    keep the old cache pass a copy: ``lm.decode_step`` copies each stacked
    cache once per step).  Returns (out, new_cache)."""
    b, s, _ = x.shape
    dev = x.device
    q = dense(p["wq"], x).reshape(b, s, cfg.n_heads, cfg.head_dim)
    kv_src = x if kv_override is None else kv_override
    sk = kv_src.shape[1]
    k = dense(p["wk"], kv_src).reshape(b, sk, cfg.n_kv_heads, cfg.head_dim)
    v = dense(p["wv"], kv_src).reshape(b, sk, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q)
        k = rmsnorm(p["k_norm"], k)
    if kv_override is None:                     # RoPE only for self-attn
        if rope is None:
            rope = rope_tables(torch.arange(s, device=dev) + (
                0 if cache_index is None else int(cache_index)),
                cfg.head_dim, cfg.rope_theta)
        q = _rotate(q, rope)
        k = _rotate(k, rope)

    new_cache = None
    if cache is not None:
        # decode: write the new kv at cache_index, attend over the cache
        _write_cache(cache["k"], k, cache_index)
        _write_cache(cache["v"], v, cache_index)
        new_cache = cache
        k, v = cache["k"], cache["v"]
        sk = k.shape[1]

    n_rep = cfg.n_heads // cfg.n_kv_heads
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)

    # the reference scales the bfloat16 logits by a weakly typed scalar,
    # so by the scale rounded to bfloat16; XLA then skips the product's
    # bfloat16 rounding before the float32 cast (excess precision), and so
    # does the port: the product is taken and kept in float32
    scale = float(torch.tensor(cfg.head_dim ** -0.5, dtype=q.dtype))
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if cfg.causal and cache is None and kv_override is None and s == sk:
        future = torch.ones((s, sk), dtype=torch.bool, device=dev).triu(1)
        logits = logits.masked_fill(future[None, None], MASK_VALUE)
    elif cache is not None:
        # decode: mask future cache slots
        future = torch.arange(sk, device=dev)[None, None, None, :] > (
            int(cache_index)
            + torch.arange(s, device=dev)[None, None, :, None])
        logits = logits.masked_fill(future, MASK_VALUE)
    m = torch.amax(logits, dim=-1, keepdim=True)
    e = torch.exp(logits - m)
    w = (e / torch.sum(e, dim=-1, keepdim=True)).to(q.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v)
    out = out.reshape(b, s, cfg.n_heads * cfg.head_dim)
    return dense(p["wo"], out), new_cache


# ---------------------------------------------------------------------------
# MLP: SwiGLU (llama family) or GeLU (starcoder2 family)
# ---------------------------------------------------------------------------


def mlp_init(key: torch.Tensor, d_model: int, d_ff: int,
             gated: bool = True, bias: bool = False, device=None,
             dtype=COMPUTE_DTYPE) -> Dict:
    ks = jaxrand.split(key, 3)
    p = {"w_up": dense_init(ks[0], d_model, d_ff, bias, device=device,
                            dtype=dtype),
         "w_down": dense_init(ks[1], d_ff, d_model, bias, device=device,
                              dtype=dtype)}
    if gated:
        p["w_gate"] = dense_init(ks[2], d_model, d_ff, bias, device=device,
                                 dtype=dtype)
    return p


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA compiles it: ``x * 1 / (1 + exp(-x))``, each
    step rounded to ``x``'s dtype (bitwise the reference's on bfloat16)."""
    return x * torch.reciprocal(torch.exp(-x) + 1.0)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation, as XLA compiles
    it: each step rounded to ``x``'s dtype, the constants too (bitwise the
    reference's on bfloat16; ``F.gelu(approximate="tanh")`` rounds once
    and parts from it in about half the values)."""
    c1, c2 = (float(torch.tensor(c, dtype=x.dtype))
              for c in (0.044715, (2.0 / math.pi) ** 0.5))
    inner = (x + x * x * x * c1) * c2
    return x * ((torch.tanh(inner) + 1.0) * 0.5)


def mlp(p: Dict, x: torch.Tensor, gated: bool = True) -> torch.Tensor:
    up = dense(p["w_up"], x)
    if gated:
        h = silu(dense(p["w_gate"], x)) * up
    else:
        h = gelu_tanh(up)
    return dense(p["w_down"], h)


# ---------------------------------------------------------------------------
# Chunked gated linear attention core
# ---------------------------------------------------------------------------
# Both mLSTM (xLSTM) and SSD (Mamba2) are linear recurrences
#     S_t = a_t * S_{t-1} + b_t * k_t v_t^T ,   y_t = q_t . S_t
# with per-(head, step) scalar decay a_t and input gate b_t: the chunkwise
# parallel form below serves both, with batched products in place of a
# length-T sequential scan.

CUMSUM_BASE = 16


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.cumsum`` as XLA compiles it (its reduce-window rewriter): the
    axis cut into blocks of ``CUMSUM_BASE``, each block summed in order,
    then each block's total plus the sum, in order, of the blocks before
    it (the block sums themselves the same way when there are more than
    ``CUMSUM_BASE`` blocks).  Float32 adds in XLA's order, where torch's
    CPU ``cumsum`` accumulates in float64 and CUDA's scans in a tree."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n <= CUMSUM_BASE:
        out = [x[..., 0]]
        for i in range(1, n):
            out.append(out[-1] + x[..., i])
        return torch.stack(out, -1).movedim(-1, dim)
    pad = (-n) % CUMSUM_BASE
    xp = torch.nn.functional.pad(x, (0, pad))
    blocks = xp.reshape(*x.shape[:-1], -1, CUMSUM_BASE)
    inner = cumsum(blocks, -1)
    before = cumsum(inner[..., -1], -1)
    before = torch.cat([torch.zeros_like(before[..., :1]),
                        before[..., :-1]], -1)
    out = (inner + before[..., None]).reshape(*x.shape[:-1], -1)
    return out[..., :n].movedim(-1, dim)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, that is
    ``max(x, 0) + log1p(exp(-|x|))``, the reference's formula (torch's
    ``F.softplus`` takes ``log1p(exp(x))`` below a threshold instead).
    XLA's CPU ``exp`` and ``log1p`` are not torch's, so a value may
    still differ from the reference's in its last bit."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def gated_linear_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, log_a: torch.Tensor,
                           b: torch.Tensor, chunk: int = 128,
                           initial_state: Optional[torch.Tensor] = None,
                           return_state: bool = False):
    """q,k: (B,T,H,Dk); v: (B,T,H,Dv); log_a,b: (B,T,H) scalar gates.

    Returns y: (B,T,H,Dv) in v's dtype (+ the final float32 state
    (B,H,Dk,Dv) if return_state).  T must be a multiple of ``chunk``
    (pad upstream).  A Python loop over the chunks, the reference's
    ``lax.scan``; each chunk's products in float32."""
    bsz, t, h, dk = q.shape
    dv = v.shape[-1]
    assert t % chunk == 0, (t, chunk)
    n = t // chunk

    def rs(x):
        return x.reshape(bsz, n, chunk, *x.shape[2:]).transpose(0, 1)
    qc, kc, vc = rs(q), rs(k), rs(v)            # (n, B, c, H, D)
    lac, bc = rs(log_a), rs(b)                  # (n, B, c, H)
    # cumulative log-decay within the chunk, inclusive of step t
    cum = cumsum(lac, 2)                        # (n, B, c, H)
    total = cum[:, :, -1:, :]                   # (n, B, 1, H)
    if initial_state is None:
        state = torch.zeros((bsz, h, dk, dv), dtype=torch.float32,
                            device=q.device)
    else:
        state = initial_state.float()
    # future positions j > t get -1e30 BEFORE the exp: exp of a large
    # positive rel times a zero mask would give inf * 0 = NaN in the
    # backward
    future = torch.ones((chunk, chunk), dtype=torch.bool,
                        device=q.device).triu(1)[None, :, :, None]
    ys = []
    for i in range(n):
        qi, ki, vi, cumi, toti, bi = (qc[i], kc[i], vc[i], cum[i], total[i],
                                      bc[i])
        # inter-chunk: y_inter[t] = a(<=t) * q_t . S_prev
        decay_t = torch.exp(cumi)                              # (B,c,H)
        y_inter = torch.einsum("bchd,bhdv->bchv",
                               (qi * decay_t[..., None]).float(), state)
        # intra-chunk: y_intra[t] = sum_{j<=t} (a(j+1..t) b_j) (q_t.k_j) v_j
        rel = cumi[:, :, None, :] - cumi[:, None, :, :]        # (B,c,c,H)
        gate = torch.exp(rel.masked_fill(future, MASK_VALUE))
        att = torch.einsum("bchd,bjhd->bcjh", qi.float(), ki.float())
        att = att * gate * bi[:, None, :, :]                   # b_j
        y_intra = torch.einsum("bcjh,bjhv->bchv", att, vi.float())
        # state update: S = a(chunk) S + sum_j a(j+1..end) b_j k_j v_j^T
        tail = torch.exp(toti - cumi) * bi                     # (B,c,H)
        kv = torch.einsum("bchd,bchv->bhdv",
                          (ki * tail[..., None]).float(), vi.float())
        state = torch.exp(toti[:, 0, :])[..., None, None] * state + kv
        ys.append((y_inter + y_intra).to(v.dtype))
    y = torch.stack(ys, 1).reshape(bsz, t, h, dv)
    if return_state:
        return y, state
    return y


def gla_step(q, k, v, log_a, b, state):
    """Single decode step of the same recurrence.
    q,k: (B,H,Dk); v: (B,H,Dv); log_a,b: (B,H); state: (B,H,Dk,Dv)
    float32.  Returns (y in v's dtype, the new float32 state)."""
    a = torch.exp(log_a.float())[..., None, None]
    kv = torch.einsum("bhd,bhv->bhdv", k.float(), v.float()) * \
        b[..., None, None]
    new_state = a * state + kv
    y = torch.einsum("bhd,bhdv->bhv", q.float(), new_state)
    return y.to(v.dtype), new_state
