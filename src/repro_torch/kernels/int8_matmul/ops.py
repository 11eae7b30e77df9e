"""Wrapper of the int8 matmul kernel (K4) and the value-domain FC on it.

Port of ``repro/kernels/int8_matmul/ops.py``.  ``int8_matmul`` is the
chip's digital FC datapath (§V-C): int8 operands, an int32 accumulator,
an int32 bias, a rounding arithmetic right shift back onto the output
grid and saturation to int8.  ``quantized_fc`` is its value-domain
interface: codes through ``ACT_Q``/``WEIGHT_Q``, the bias on the product
grid, ``shift = w_fmt.frac_bits``.  The reference pads to its TPU tiles;
the kernel guards its ragged edges instead, with the same result.

For a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/int8_matmul.cu``: int8 tensor-core products, a split-K plan for
the FC head's few outputs and a tiled one for the rest) and raises if it
cannot; for a CPU tensor it
runs the plain version (``ref.int8_matmul_ref``).  ``COUNTS`` counts
kernel launches and nothing else.
"""

from __future__ import annotations

import ctypes
import pathlib

import torch

from repro_torch import kernels
from repro_torch.core.quantize import ACT_Q, WEIGHT_Q, QFormat
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref

SOURCE = pathlib.Path(__file__).parent / "csrc" / "int8_matmul.cu"
COUNTS = kernels.LaunchCount()


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.int8_matmul_launch.argtypes = [p] * 4 + [i] * 5 + [p]
    lib.int8_matmul_launch.restype = i
    lib.int8_matmul_plan.argtypes = [i] * 3
    lib.int8_matmul_plan.restype = i
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The built kernel library (compiled at first use)."""
    return kernels.load_library("int8_matmul", [SOURCE], _declare)


def int8_matmul_launch(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                       shift: int = 7, out_max: int = 127) -> torch.Tensor:
    """Launch K4 on CUDA tensors: x (M, K) int8, w (K, N) int8, bias (N,)
    int32.  Returns (M, N) int8 on PyTorch's current stream, without
    synchronising.  The launch picks its plan by shape (``split_k``): K
    split across the warps of a block for a few outputs over a long
    fan-in (the FC head), else 64 x 64 tensor-core tiles."""
    dev = x.device
    m, k = x.shape
    k2, n = w.shape
    for name, v, dtype in (("x", x, torch.int8), ("w", w, torch.int8),
                           ("bias", bias, torch.int32)):
        if v.device != dev or v.dtype != dtype:
            raise ValueError(f"int8_matmul: {name} must be {dtype} on "
                             f"{dev}, got {v.dtype} on {v.device}")
    if k2 != k or tuple(bias.shape) != (n,):
        raise ValueError(f"int8_matmul: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)} and bias {tuple(bias.shape)} "
                         f"do not form a product")
    if not 0 <= shift < 32 or not 0 <= out_max <= 127:
        raise ValueError(f"int8_matmul: shift={shift} must be in [0, 32) "
                         f"and out_max={out_max} in [0, 127]")
    x, w, bias = x.contiguous(), w.contiguous(), bias.contiguous()
    out = torch.empty((m, n), dtype=torch.int8, device=dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.int8_matmul_launch(
            x.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            m, k, n, int(shift), int(out_max), stream)
    kernels.check_launch(lib, "int8_matmul", status)
    COUNTS.add()
    return out


def split_k(m: int, k: int, n: int) -> bool:
    """Whether K4's launch takes its split-K plan for an (m, k) x (k, n)
    product (else the tiled one)."""
    return bool(library().int8_matmul_plan(m, k, n))


def int8_matmul(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *,
                shift: int = 7, out_max: int = 127) -> torch.Tensor:
    """x (M, K) int8, w (K, N) int8, bias (N,) int32 -> (M, N) int8 codes
    = clip(((x @ w + bias) + 2**(shift-1)) >> shift)."""
    if x.device.type == "cuda":
        return int8_matmul_launch(x, w, bias, shift, out_max)
    if x.device.type != "cpu":
        raise ValueError(f"int8_matmul: no kernel for {x.device}")
    return int8_matmul_ref(x, w, bias, shift, out_max)


def quantized_fc(feats: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 act_fmt: QFormat = ACT_Q,
                 w_fmt: QFormat = WEIGHT_Q) -> torch.Tensor:
    """Value-domain FC through the int8 kernel: real features (M, D) ->
    codes on ``act_fmt``, w/b on ``w_fmt``; the bias joins the accumulator
    on the product grid (act scale x weight scale), and the right shift
    by ``w_fmt.frac_bits`` brings the sum back onto ``act_fmt``'s grid.
    Returns real values on that grid, (M, N) float32."""
    xq = act_fmt.to_int(feats, torch.int8)
    wq = w_fmt.to_int(w, torch.int8)
    bq = torch.round(b / (act_fmt.scale * w_fmt.scale)).to(torch.int32)
    out = int8_matmul(xq, wq, bq, shift=w_fmt.frac_bits,
                      out_max=act_fmt.qmax)
    return out.to(torch.float32) * act_fmt.scale
