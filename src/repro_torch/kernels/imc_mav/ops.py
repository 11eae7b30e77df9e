"""Wrapper of the fused IMC layer kernel (K1).

Port of ``repro/kernels/imc_mav/ops.py::fused_conv_mav`` /
``fused_conv_mav_step``: the whole grouped IMC layer (binary group conv +
chip offset + word-line bias + pre-sign noise operand + BN-decoder flip +
SA sign + channel shuffle + OR-maxpool) in exactly one launch for a whole
batch of streams.

For a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/imc_fused.cu``) and raises if it cannot; for a CPU tensor it runs
the plain version (``ref.fused_conv_mav_ref``).  ``COUNTS.launches``
counts kernel launches, and nothing else: it takes the place of the JAX
package's launch auditor, which patched ``pl.pallas_call``.
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import Optional

import torch

from repro_torch import kernels
from repro_torch.kernels.imc_mav.ref import fused_conv_mav_ref

SOURCE = pathlib.Path(__file__).parent / "csrc" / "imc_fused.cu"


COUNTS = kernels.LaunchCount()


def pack_weights(w: torch.Tensor, groups: int) -> torch.Tensor:
    """(K, cpg, C_out) -> (groups, K*cpg, cog) contiguous: each group's
    weights are one contiguous block, which the kernel stages whole into
    shared memory.  Done once at fold time (``models.kws.pack_hw_params``)."""
    k, cpg, c_out = w.shape
    cog = c_out // groups
    return (w.reshape(k * cpg, groups, cog).permute(1, 0, 2)
            .contiguous())


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.imc_fused_launch.argtypes = [p] * 7 + [i] * 11 + [p]
    lib.imc_fused_launch.restype = i
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The built kernel library (compiled at first use)."""
    return kernels.load_library("imc_fused", [SOURCE], _declare)


def _operand(name: str, v: torch.Tensor, shape, device) -> torch.Tensor:
    if v.device != device or v.dtype != torch.float32:
        raise ValueError(f"imc_fused: {name} must be float32 on {device}, "
                         f"got {v.dtype} on {v.device}")
    if tuple(v.shape) != tuple(shape):
        raise ValueError(f"imc_fused: {name} has shape {tuple(v.shape)}, "
                         f"expected {tuple(shape)}")
    return v.contiguous()


def imc_fused(x: torch.Tensor, wp: torch.Tensor, bias: torch.Tensor,
              flip: torch.Tensor, off: Optional[torch.Tensor],
              noise: Optional[torch.Tensor], *, k: int, groups: int,
              stride: int, pool: int) -> torch.Tensor:
    """Launch the kernel on CUDA tensors: x (B, T, C_in), wp packed
    (groups, k*cpg, cog), bias/flip/off (C_out,), noise (B, T_out, C_out)
    or None.  Returns (B, T_out // pool, C_out) on PyTorch's current
    stream, without synchronising."""
    dev = x.device
    b, t, c_in = x.shape
    g, kg, cog = wp.shape
    c_out = g * cog
    cpg = kg // k
    if g != groups or cpg * k != kg or c_in != groups * cpg:
        raise ValueError(f"imc_fused: x {tuple(x.shape)} does not match "
                         f"packed weights {tuple(wp.shape)} (k={k}, "
                         f"groups={groups})")
    t_out = (t - k) // stride + 1
    t_pool = t_out // pool
    x = _operand("x", x, (b, t, c_in), dev)
    wp = _operand("weights", wp, (g, kg, cog), dev)
    bias = _operand("bias", bias, (c_out,), dev)
    flip = _operand("flip", flip, (c_out,), dev)
    if off is not None:
        off = _operand("chip_offset", off, (c_out,), dev)
    if noise is not None:
        noise = _operand("sa_noise", noise, (b, t_out, c_out), dev)
    out = torch.empty((b, t_pool, c_out), dtype=torch.float32, device=dev)
    lib = library()

    def ptr(v):
        return None if v is None else v.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.imc_fused_launch(
            ptr(x), ptr(wp), ptr(bias), ptr(flip), ptr(off), ptr(noise),
            ptr(out), b, t, c_in, k, cpg, c_out, groups, stride, pool,
            t_pool, t_out, stream)
    kernels.check_launch(lib, "imc_fused", status)
    COUNTS.launches += 1
    return out


def fused_conv_mav(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   flip: torch.Tensor, groups: int, stride: int = 1,
                   pool: int = 1,
                   chip_offset: Optional[torch.Tensor] = None,
                   sa_noise: Optional[torch.Tensor] = None,
                   packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The whole IMC layer in one launch.

    x: (B, T, C_in) ±1;  w: (K, C_in // groups, C_out) ±1;
    bias/flip/chip_offset: (C_out,);  sa_noise: an explicit pre-pool,
    pre-sign operand (B, T_out, C_out).  Returns (B, T_out // pool, C_out)
    ±1 in post-shuffle channel order.  ``packed`` is ``pack_weights(w,
    groups)`` precomputed at fold time."""
    k = w.shape[0]
    t_out = (x.shape[1] - k) // stride + 1
    if t_out // pool <= 0:
        raise ValueError(
            f"fused_conv_mav: input T={x.shape[1]} yields no complete pool "
            f"window (k={k}, stride={stride}, pool={pool}) — input too "
            f"short for this layer")
    if x.device.type == "cuda":
        if packed is None:
            packed = pack_weights(w, groups)
        return imc_fused(x, packed, bias, flip, chip_offset, sa_noise, k=k,
                         groups=groups, stride=stride, pool=pool)
    if x.device.type != "cpu":
        raise ValueError(f"fused_conv_mav: no kernel for {x.device}")
    return fused_conv_mav_ref(x, w, bias, flip, groups=groups,
                              stride=stride, pool=pool,
                              chip_offset=chip_offset, sa_noise=sa_noise)


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
