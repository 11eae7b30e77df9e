"""Wrappers of the fused SGA update kernel (K2 row-batched, K3 flat).

Port of ``repro/kernels/sga_update/ops.py``: ``sga_update_batch`` stacks
every enrollment session's flattened optimizer state into one row each and
transitions them all in ONE launch, each row with its own learning rate
and threshold (the customization path, ``serving.customize``);
``sga_update_tree`` applies the same update leaf by leaf with scalar
operands.  Unlike the TPU kernels there is no padding of N to a block:
the kernel guards its ragged tail.

For CUDA tensors the wrappers launch the hand-written kernel
(``csrc/sga_update.cu``) and raise if they cannot; for CPU tensors they
run the plain version (``ref.sga_update_ref``).  ``COUNTS_ROWS`` and
``COUNTS_FLAT`` count the two entries' kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import pathlib
from typing import Tuple

import torch

from repro_torch import kernels
from repro_torch.kernels.sga_update.ref import sga_update_ref

SOURCE = pathlib.Path(__file__).parent / "csrc" / "sga_update.cu"
COUNTS_ROWS = kernels.LaunchCount()      # K2: sga_update_rows
COUNTS_FLAT = kernels.LaunchCount()      # K3: sga_update

W_SCALE, W_MAX, A_SCALE = 1.0 / 128, 127.0 / 128, 2.0 ** -15


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sga_update_rows_launch.argtypes = ([p] * 7 + [i, i] + [f] * 4
                                           + [p])
    lib.sga_update_rows_launch.restype = i
    lib.sga_update_launch.argtypes = [p] * 3 + [f, f] + [p, p, i] \
        + [f] * 4 + [p]
    lib.sga_update_launch.restype = i
    lib.cuda_error_string.argtypes = [i]
    lib.cuda_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The built kernel library (compiled at first use)."""
    return kernels.load_library("sga_update", [SOURCE], _declare)


def _state(name: str, v: torch.Tensor, shape, device) -> torch.Tensor:
    if v.device != device or v.dtype != torch.float32:
        raise ValueError(f"sga_update: {name} must be float32 on {device}, "
                         f"got {v.dtype} on {v.device}")
    if tuple(v.shape) != tuple(shape):
        raise ValueError(f"sga_update: {name} has shape {tuple(v.shape)}, "
                         f"expected {tuple(shape)}")
    return v.contiguous()


def _bounds(w_scale: float, w_max: float) -> Tuple[float, float]:
    """The weight clip [lo, hi], in double precision as the reference's
    Python constants are."""
    return -w_max - w_scale, w_max


def sga_update_rows(w: torch.Tensor, g: torch.Tensor, accum: torch.Tensor,
                    lr: torch.Tensor, g_th: torch.Tensor, *,
                    w_scale: float = W_SCALE, w_max: float = W_MAX,
                    a_scale: float = A_SCALE
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2 on CUDA tensors: w/g/accum (B, N), lr/g_th (B,) float32.
    Returns (new_w, new_accum) on PyTorch's current stream, without
    synchronising."""
    dev = w.device
    b, n = w.shape
    w = _state("w", w, (b, n), dev)
    g = _state("g", g, (b, n), dev)
    accum = _state("accum", accum, (b, n), dev)
    lr = _state("lr", lr, (b,), dev)
    g_th = _state("g_th", g_th, (b,), dev)
    new_w, new_a = torch.empty_like(w), torch.empty_like(accum)
    lo, hi = _bounds(w_scale, w_max)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.sga_update_rows_launch(
            w.data_ptr(), g.data_ptr(), accum.data_ptr(), lr.data_ptr(),
            g_th.data_ptr(), new_w.data_ptr(), new_a.data_ptr(), b, n,
            w_scale, lo, hi, a_scale, stream)
    kernels.check_launch(lib, "sga_update_rows", status)
    COUNTS_ROWS.launches += 1
    return new_w, new_a


def sga_update_flat(w: torch.Tensor, g: torch.Tensor, accum: torch.Tensor,
                    lr: float, g_th: float, *, w_scale: float = W_SCALE,
                    w_max: float = W_MAX, a_scale: float = A_SCALE
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 on flat CUDA tensors (N,) with scalar ``lr``/``g_th``
    (rounded to float32, as the reference's static scalars are)."""
    dev = w.device
    (n,) = w.shape
    w = _state("w", w, (n,), dev)
    g = _state("g", g, (n,), dev)
    accum = _state("accum", accum, (n,), dev)
    new_w, new_a = torch.empty_like(w), torch.empty_like(accum)
    lo, hi = _bounds(w_scale, w_max)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.sga_update_launch(
            w.data_ptr(), g.data_ptr(), accum.data_ptr(), float(lr),
            float(g_th), new_w.data_ptr(), new_a.data_ptr(), n, w_scale, lo,
            hi, a_scale, stream)
    kernels.check_launch(lib, "sga_update", status)
    COUNTS_FLAT.launches += 1
    return new_w, new_a


def sga_update_batch(w: torch.Tensor, g: torch.Tensor, accum: torch.Tensor,
                     lr: torch.Tensor, g_th: torch.Tensor, *,
                     w_scale: float = W_SCALE, w_max: float = W_MAX,
                     a_scale: float = A_SCALE
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Session-batched fused SGA update: ONE launch for B rows.

    w/g/accum: (B, N) stacked flattened optimizer states (one row per
    enrollment session); lr/g_th: (B,) per-row scalars, since each session
    sits at its own point of the LR schedule.  Returns (new_w,
    new_accum)."""
    if w.device.type == "cuda":
        return sga_update_rows(w, g, accum, lr, g_th, w_scale=w_scale,
                               w_max=w_max, a_scale=a_scale)
    if w.device.type != "cpu":
        raise ValueError(f"sga_update_batch: no kernel for {w.device}")
    lr = torch.as_tensor(lr, dtype=torch.float32)[:, None]
    g_th = torch.as_tensor(g_th, dtype=torch.float32)[:, None]
    return sga_update_ref(w, g, accum, lr, g_th, w_scale=w_scale,
                          w_max=w_max, a_scale=a_scale)


def _flatten(tree):
    """Tensor leaves of nested dicts / lists / tuples, and a rebuild."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        raise TypeError(f"sga_update_tree: unsupported node {type(tree)}")
    sizes = [len(p[0]) for p in parts]

    def rebuild(leaves):
        out, i = [], 0
        for (_, fn), k in zip(parts, sizes):
            out.append(fn(leaves[i:i + k]))
            i += k
        if keys is not None:
            return dict(zip(keys, out))
        return type(tree)(*out) if hasattr(tree, "_fields") else \
            type(tree)(out)

    return [leaf for p in parts for leaf in p[0]], rebuild


def sga_update_tree(params, grads, accums, lr: float, g_th: float):
    """Apply the fused update leaf by leaf (shapes preserved): one K3
    launch per CUDA leaf, the plain version for CPU leaves.  Returns
    (new_params, new_accums)."""
    leaves_w, rebuild = _flatten(params)
    leaves_g, _ = _flatten(grads)
    leaves_a, _ = _flatten(accums)
    if not len(leaves_w) == len(leaves_g) == len(leaves_a):
        raise ValueError("sga_update_tree: params, grads and accums differ "
                         "in structure")
    new_w, new_a = [], []
    for w, g, a in zip(leaves_w, leaves_g, leaves_a):
        shape = w.shape
        if w.device.type == "cuda":
            nw, na = sga_update_flat(w.reshape(-1), g.reshape(-1),
                                     a.reshape(-1), lr, g_th)
        elif w.device.type == "cpu":
            nw, na = sga_update_ref(
                w, g, a, torch.tensor(lr, dtype=torch.float32),
                torch.tensor(g_th, dtype=torch.float32))
        else:
            raise ValueError(f"sga_update_tree: no kernel for {w.device}")
        new_w.append(nw.reshape(shape))
        new_a.append(na.reshape(shape))
    return rebuild(new_w), rebuild(new_a)
