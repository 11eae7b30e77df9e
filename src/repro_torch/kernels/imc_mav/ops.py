"""Wrappers of the IMC kernels: the fused layer (K1) and the per-group
product tile (K5).

Port of ``repro/kernels/imc_mav/ops.py``.  ``fused_conv_mav`` /
``fused_conv_mav_step`` run the whole grouped IMC layer (binary group
conv + chip offset + word-line bias + pre-sign noise operand + BN-decoder
flip + SA sign + channel shuffle + OR-maxpool) in exactly one launch for
a whole batch of streams.  ``conv_mav`` is the per-group layer the fused
one replaced, kept as its baseline: im2col patches per conv group and one
``mav_matmul`` launch each (``groups`` launches per layer).

The SA noise is drawn here from ``sa_key``/``sa_noise_std`` (the
fresh-draw form, ``core.jaxrand``, the reference's numbers) or given as
an explicit pre-sign operand; the kernels draw nothing.

For a CUDA tensor a wrapper launches the hand-written kernel
(``csrc/imc_fused.cu``, ``csrc/imc_mav.cu``) and raises if it cannot; for
a CPU tensor it runs the plain version (``ref.py``).  Both kernels take
activations in {-1, 0, +1} and compute in int8 on the tensor cores.  K1
takes its weights as int8 B rows packed at fold time
(``pack_weights_s8``); K5 takes ternary float32 or bfloat16 operands and
converts them as it stages them.  Each launch picks its own block tile
(``block_tile``, ``mav_tile`` report them).
``COUNTS`` (K1) and ``COUNTS_MAV`` (K5) count kernel launches, and
nothing else.  ``CALLS`` counts the fused layer's calls on either route
(the kernel on a CUDA tensor, the plain version on a CPU tensor), per
thread: the launch auditor (``obs.audit``) reads it where the JAX
package's patched ``pl.pallas_call``, and on the card it moves with
``COUNTS``.  A call made while the current stream captures a CUDA graph
launches nothing (the launch is recorded and runs at each replay), so
neither count moves for it; the compiled tick (``serving.compiled``) adds
a replay's launches to ``COUNTS`` itself.
"""

from __future__ import annotations

import ctypes
import functools
import pathlib
import threading
from typing import Optional, Tuple

import torch

from repro_torch import kernels
from repro_torch.core import jaxrand
from repro_torch.kernels.imc_mav.ref import fused_conv_mav_ref, imc_mav_ref

SOURCE = pathlib.Path(__file__).parent / "csrc" / "imc_fused.cu"
MAV_SOURCE = pathlib.Path(__file__).parent / "csrc" / "imc_mav.cu"

COUNTS = kernels.LaunchCount()          # K1: imc_fused
COUNTS_MAV = kernels.LaunchCount()      # K5: imc_mav


class CallCount:
    """Calls of ``fused_conv_mav`` since the last ``reset``, on either
    route, counted per thread: the pools of a sharded server that tick on
    threads of their own (``ShardedStreamServer(parallel=True)``) each
    read only their own calls.  ``calls`` and ``reset`` act on the
    calling thread's count."""

    def __init__(self):
        self._local = threading.local()

    @property
    def calls(self) -> int:
        return getattr(self._local, "calls", 0)

    @calls.setter
    def calls(self, value: int) -> None:
        self._local.calls = value

    def reset(self) -> None:
        self.calls = 0


CALLS = CallCount()                     # K1's calls, kernel or plain


def pack_weights(w: torch.Tensor, groups: int) -> torch.Tensor:
    """(K, cpg, C_out) -> (groups, K*cpg, cog) contiguous: each group's
    weights are one contiguous block, group-major (the JAX package's
    packed layout; the kernel takes ``pack_weights_s8``)."""
    k, cpg, c_out = w.shape
    cog = c_out // groups
    return (w.reshape(k * cpg, groups, cog).permute(1, 0, 2)
            .contiguous())


def slot_bytes(cpg: int) -> int:
    """Bytes of a group's int8 row: cpg channels rounded up to whole
    32-deep k-steps of the tensor-core product."""
    return -(-cpg // 32) * 32


def pack_weights_s8(w: torch.Tensor, groups: int) -> torch.Tensor:
    """(K, cpg, C_out) ±1 -> the kernel's int8 B rows, (groups, K, cog,
    32 s) with s = ceil(cpg / 32): row (g, j, n) holds w[j, c, g*cog + n]
    at byte c, zero for cpg <= c < 32 s, s 32-deep int8 k-steps of the
    tensor-core product.  A kernel block copies its groups' rows to shared
    memory as they are.  Done once at fold time
    (``models.kws.pack_hw_params``), which models programming the SRAM
    arrays."""
    k, cpg, c_out = w.shape
    cog = c_out // groups
    if c_out % groups:
        raise ValueError(f"pack_weights_s8: {c_out} outputs do not split "
                         f"into {groups} groups")
    rows = torch.zeros((groups, k, cog, slot_bytes(cpg)), dtype=torch.int8,
                       device=w.device)
    rows[..., :cpg] = (w.reshape(k, cpg, groups, cog).permute(2, 0, 3, 1)
                       .to(torch.int8))
    return rows


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.imc_fused_launch.argtypes = [p] * 7 + [i] * 12 + [p]
    lib.imc_fused_launch.restype = i
    lib.imc_fused_plan.argtypes = [i] * 9 + [p]
    lib.imc_fused_plan.restype = i
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The built kernel library (compiled at first use)."""
    return kernels.load_library("imc_fused", [SOURCE], _declare)


def _declare_mav(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.imc_mav_launch.argtypes = [p] * 6 + [i] * 5 + [p]
    lib.imc_mav_launch.restype = i
    lib.imc_mav_plan.argtypes = [i] * 4 + [p]
    lib.imc_mav_plan.restype = i
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p


def mav_library() -> ctypes.CDLL:
    """The built K5 library (compiled at first use)."""
    return kernels.load_library("imc_mav", [MAV_SOURCE], _declare_mav)


def _operand(name: str, v: torch.Tensor, shape, device) -> torch.Tensor:
    if v.device != device or v.dtype != torch.float32:
        raise ValueError(f"imc_fused: {name} must be float32 on {device}, "
                         f"got {v.dtype} on {v.device}")
    if tuple(v.shape) != tuple(shape):
        raise ValueError(f"imc_fused: {name} has shape {tuple(v.shape)}, "
                         f"expected {tuple(shape)}")
    return v.contiguous()


def imc_fused(x: torch.Tensor, wq: torch.Tensor, bias: torch.Tensor,
              flip: torch.Tensor, off: Optional[torch.Tensor],
              noise: Optional[torch.Tensor], *, k: int, groups: int,
              stride: int, pool: int) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: x (B, T, C_in) with values in
    {-1, 0, +1}; wq the int8 B rows (``pack_weights_s8``); bias, flip,
    off (C_out,); noise (B, T_out, C_out) or None.  Returns
    (B, T_out // pool, C_out) on PyTorch's current stream, without
    synchronising.  Any group width runs; a layer whose smallest block
    tile needs more shared memory than a block of the card has raises."""
    dev = x.device
    b, t, c_in = x.shape
    cpg = c_in // groups
    cog = wq.shape[2] if wq.dim() == 4 else -1
    if (wq.dtype != torch.int8
            or tuple(wq.shape) != (groups, k, cog, slot_bytes(cpg))
            or c_in != groups * cpg):
        raise ValueError(f"imc_fused: x {tuple(x.shape)} does not match "
                         f"weights {tuple(wq.shape)} {wq.dtype} (k={k}, "
                         f"groups={groups}; the int8 rows of "
                         f"pack_weights_s8)")
    if wq.device != dev:
        raise ValueError(f"imc_fused: weights on {wq.device}, x on {dev}")
    c_out = groups * cog
    t_out = (t - k) // stride + 1
    t_pool = t_out // pool
    x = _operand("x", x, (b, t, c_in), dev)
    wq = wq.contiguous()
    if x.data_ptr() % 16:          # the kernel reads 16-byte words
        x = x.clone()
    if wq.data_ptr() % 16:
        wq = wq.clone()
    bias = _operand("bias", bias, (c_out,), dev)
    flip = _operand("flip", flip, (c_out,), dev)
    if off is not None:
        off = _operand("chip_offset", off, (c_out,), dev)
    if noise is not None:
        noise = _operand("sa_noise", noise, (b, t_out, c_out), dev)
        if noise.data_ptr() % 8:   # read in pairs
            noise = noise.clone()
    out = torch.empty((b, t_pool, c_out), dtype=torch.float32, device=dev)
    lib = library()

    def ptr(v):
        return None if v is None else v.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.imc_fused_launch(
            ptr(x), ptr(wq), ptr(bias), ptr(flip), ptr(off), ptr(noise),
            ptr(out), b, t, c_in, k, cpg, c_out, groups, stride, pool,
            t_pool, t_out, _sm_count(dev), stream)
    if status == -1:
        raise ValueError(f"imc_fused: no block tile of {groups} groups x "
                         f"{cpg} -> {cog} channels fits the shared memory "
                         f"of a block of the card")
    kernels.check_launch(lib, "imc_fused", status)
    if not torch.cuda.is_current_stream_capturing():
        COUNTS.add()    # a launch recorded into a CUDA graph runs at replays
    return out


def block_tile(b: int, t_pool: int, groups: int, cog: int, k: int,
               stride: int, pool: int, device: torch.device,
               cpg: int = 32) -> Tuple[int, int, int]:
    """The block tile K1's launch takes for a layer call on ``device``
    (``cpg`` input channels per group): (pooled columns, groups,
    shared-memory bytes) per block; (0, 0, 0) if none fits."""
    tile = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        nbytes = library().imc_fused_plan(b, t_pool, groups, cog, k, cpg,
                                          stride, pool, _sm_count(device),
                                          tile)
    return tile[0], tile[1], nbytes


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def imc_mav(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
            flip: torch.Tensor,
            noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K5 on CUDA tensors: x (M, K), w (K, N) with values in
    {-1, 0, +1}, both float32 or both bfloat16 (the kernel converts them
    to int8 for its tensor-core products, exact for those values only);
    bias/flip (N,) and noise (M, N) float32.  Returns (M, N) ±1 in x's
    dtype on PyTorch's current stream, without synchronising.  The launch
    plans its own row tile (``mav_tile`` reports it)."""
    dev = x.device
    m, k = x.shape
    k2, n = w.shape
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise ValueError(f"imc_mav: x and w must both be float32 or both "
                         f"bfloat16, got {x.dtype} and {w.dtype}")
    if k2 != k or w.device != dev:
        raise ValueError(f"imc_mav: w {tuple(w.shape)} on {w.device} does "
                         f"not match x {tuple(x.shape)} on {dev}")
    x, w = x.contiguous(), w.contiguous()
    bias = _operand("bias", bias, (n,), dev)
    flip = _operand("flip", flip, (n,), dev)
    if noise is not None:
        noise = _operand("noise", noise, (m, n), dev)
        if noise.data_ptr() % 16:      # read with 16-byte loads
            noise = noise.clone()
    out = torch.empty((m, n), dtype=x.dtype, device=dev)
    lib = mav_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.imc_mav_launch(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), flip.data_ptr(),
            None if noise is None else noise.data_ptr(), out.data_ptr(),
            m, k, n, int(x.dtype == torch.bfloat16), _sm_count(dev), stream)
    kernels.check_launch(lib, "imc_mav", status)
    COUNTS_MAV.add()
    return out


def mav_tile(m: int, k: int, n: int,
             device: torch.device) -> Tuple[int, int, int]:
    """The block tile K5's launch takes for an (m, k) x (k, n) product on
    ``device``: (rows per block, column chunks of 128, shared-memory bytes
    per block)."""
    tile = (ctypes.c_int * 2)()
    with torch.cuda.device(device):
        nbytes = mav_library().imc_mav_plan(m, k, n, _sm_count(device), tile)
    return tile[0], tile[1], nbytes


def mav_matmul(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
               flip: torch.Tensor,
               noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One product tile with the SA epilogue: x (M, K), w (K, N) in
    {-1, 0, +1} -> (M, N) ±1 in x's dtype.  The reference pads to its TPU
    tiles; the kernel guards its ragged edges instead, with the same
    result."""
    if x.device.type == "cuda":
        return imc_mav(x, w, bias, flip, noise)
    if x.device.type != "cpu":
        raise ValueError(f"mav_matmul: no kernel for {x.device}")
    return imc_mav_ref(x, w, bias, flip, noise)


def _im2col(x: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """x (B, T, C) -> patches (B, T_out, k*C), tap-major."""
    b, t, c = x.shape
    t_out = (t - k) // stride + 1
    taps = [x[:, j:j + stride * (t_out - 1) + 1:stride] for j in range(k)]
    return torch.stack(taps, dim=2).reshape(b, t_out, k * c)


def conv_mav(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
             flip: torch.Tensor, groups: int, stride: int = 1,
             sa_key: Optional[torch.Tensor] = None,
             sa_noise_std: float = 0.0) -> torch.Tensor:
    """The per-group IMC layer (the fused layer's baseline): one
    ``mav_matmul`` per conv group over materialized im2col patches, no
    pool or shuffle.  x: (B, T, C_in) ±1;  w: (K, C_in // groups, C_out)
    ±1.  Returns (B, T_out, C_out) in pre-shuffle channel order.  With
    ``sa_key`` and ``sa_noise_std > 0`` each group draws its own noise
    ``(B*T_out, cog)`` down a ``split`` chain, as the reference does."""
    b, _, _ = x.shape
    k, cpg, c_out = w.shape
    cog = c_out // groups
    t_out = (x.shape[1] - k) // stride + 1
    outs = []
    key = sa_key
    for g in range(groups):
        xg = x[..., g * cpg:(g + 1) * cpg]
        wg = w[..., g * cog:(g + 1) * cog]
        patches = _im2col(xg, k, stride).reshape(b * t_out, k * cpg)
        noise = None
        if key is not None and sa_noise_std > 0:
            key, sub = jaxrand.split(key)
            noise = sa_noise_std * jaxrand.normal(sub, (b * t_out, cog))
        og = mav_matmul(patches, wg.reshape(k * cpg, cog),
                        bias[g * cog:(g + 1) * cog],
                        flip[g * cog:(g + 1) * cog], noise)
        outs.append(og.reshape(b, t_out, cog))
    return torch.cat(outs, dim=-1)


def fused_conv_mav(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   flip: torch.Tensor, groups: int, stride: int = 1,
                   pool: int = 1,
                   chip_offset: Optional[torch.Tensor] = None,
                   sa_key: Optional[torch.Tensor] = None,
                   sa_noise_std: float = 0.0,
                   sa_noise: Optional[torch.Tensor] = None,
                   packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole IMC layer in one launch.

    x: (B, T, C_in) in {-1, 0, +1} (free slots carry zeros);  w: (K,
    C_in // groups, C_out) ±1;  bias/flip/chip_offset: (C_out,).  The SA
    noise is either drawn here,
    ``sa_noise_std * normal(sa_key, (B, T_out, C_out))`` (the same draw as
    ``core.imc.mav_sa``, so the fused and unfused paths agree noise
    included), or given as ``sa_noise``, an explicit pre-pool, pre-sign
    operand (B, T_out, C_out).  Returns (B, T_out // pool, C_out) ±1 in
    post-shuffle channel order.  ``packed`` is ``pack_weights_s8(w,
    groups)`` precomputed at fold time."""
    k = w.shape[0]
    t_out = (x.shape[1] - k) // stride + 1
    if t_out // pool <= 0:
        raise ValueError(
            f"fused_conv_mav: input T={x.shape[1]} yields no complete pool "
            f"window (k={k}, stride={stride}, pool={pool}) — input too "
            f"short for this layer")
    if sa_key is not None and sa_noise_std > 0:
        sa_noise = sa_noise_std * jaxrand.normal(
            sa_key, (x.shape[0], t_out, w.shape[2]))
    if x.device.type == "cuda":
        if packed is None:
            packed = pack_weights_s8(w, groups)
        out = imc_fused(x, packed, bias, flip, chip_offset, sa_noise, k=k,
                        groups=groups, stride=stride, pool=pool)
    elif x.device.type == "cpu":
        out = fused_conv_mav_ref(x, w, bias, flip, groups=groups,
                                 stride=stride, pool=pool,
                                 chip_offset=chip_offset, sa_noise=sa_noise)
    else:
        raise ValueError(f"fused_conv_mav: no kernel for {x.device}")
    if (x.device.type == "cpu"
            or not torch.cuda.is_current_stream_capturing()):
        CALLS.calls += 1
    return out


def fused_conv_mav_step(x_tail: torch.Tensor, w: torch.Tensor,
                        bias: torch.Tensor, flip: torch.Tensor, groups: int,
                        stride: int = 1, pool: int = 1,
                        chip_offset: Optional[torch.Tensor] = None,
                        sa_noise: Optional[torch.Tensor] = None,
                        packed: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Time-sliced streaming entry: the same single launch over a layer's
    streaming tail (carry columns + the hop's fresh columns, B, T_tail,
    C_in).  The caller (``serving.stream``) guarantees the tail starts on
    a pool-window boundary of the full window, so the fused OR-maxpool
    pairs exactly the columns the full-window path pairs."""
    k = w.shape[0]
    t_conv = (x_tail.shape[1] - k) // stride + 1
    if t_conv < pool:
        raise ValueError(
            f"fused_conv_mav_step: tail T={x_tail.shape[1]} yields {t_conv} "
            f"conv columns — not enough for one pool-{pool} window")
    return fused_conv_mav(x_tail, w, bias, flip, groups=groups,
                          stride=stride, pool=pool, chip_offset=chip_offset,
                          sa_noise=sa_noise, packed=packed)
