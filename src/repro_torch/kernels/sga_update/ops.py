"""Wrappers of the SGA kernels: the fused update (K2 row-batched, K3
flat) and a training tick's whole head-training budget in one launch.

Port of ``repro/kernels/sga_update/ops.py``: ``sga_update_batch`` stacks
every enrollment session's flattened optimizer state into one row each and
transitions them all in ONE launch, each row with its own learning rate
and threshold; ``sga_update_tree`` applies the same update to every leaf
of a parameter tree with scalar operands, in one launch per tree (up to
``TREE_MAX_LEAVES`` leaves a launch), the leaves read where they lie.
Unlike the TPU kernels there is no padding of N to a block: the kernels
guard their ragged tails.

``head_train_batch`` runs, for every session row, its own budget of
epochs of the quantized head loop (forward, LUT softmax, error scaling,
gradients, SGA update) in one launch per call (up to ``HEAD_MAX_ROWS``
rows): the customization path's training tick (``serving.customize``).

For CUDA tensors the wrappers launch the hand-written kernels
(``csrc/sga_update.cu``) and raise if they cannot; for CPU tensors they
run the plain versions (``ref.py``).  ``COUNTS_ROWS``, ``COUNTS_FLAT``
and ``COUNTS_HEAD`` count the three entries' kernel launches, and nothing
else.
"""

from __future__ import annotations

import ctypes
import dataclasses
import pathlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.kernels.sga_update.ref import (head_train_rows_ref,
                                                sga_update_ref)

SOURCE = pathlib.Path(__file__).parent / "csrc" / "sga_update.cu"
COUNTS_ROWS = kernels.LaunchCount()      # K2: sga_update_rows
COUNTS_FLAT = kernels.LaunchCount()      # K3: sga_update
COUNTS_HEAD = kernels.LaunchCount()      # head_train_rows

# rows one head_train_rows launch takes (kHeadRows in the source), and the
# shared memory a block of an H100 may have
HEAD_MAX_ROWS = 48
HEAD_SMEM_BYTES = 232448
# leaves one launch of the flat entry takes (kTreeLeaves in the source)
TREE_MAX_LEAVES = 64

W_SCALE, W_MAX, A_SCALE = 1.0 / 128, 127.0 / 128, 2.0 ** -15


class _TreeLeaf(ctypes.Structure):
    """``TreeLeafArg`` of the source: one leaf of a flat-entry launch."""
    _fields_ = [("w", ctypes.c_void_p), ("g", ctypes.c_void_p),
                ("a", ctypes.c_void_p), ("wo", ctypes.c_void_p),
                ("ao", ctypes.c_void_p), ("n", ctypes.c_longlong)]


class _HeadRow(ctypes.Structure):
    """``HeadRowArg`` of the source: one session row of a launch."""
    _fields_ = [("w", ctypes.c_void_p), ("b", ctypes.c_void_p),
                ("aw", ctypes.c_void_p), ("ab", ctypes.c_void_p),
                ("feats", ctypes.c_void_p), ("onehot", ctypes.c_void_p),
                ("n", ctypes.c_int), ("start", ctypes.c_int),
                ("epochs", ctypes.c_int), ("unused", ctypes.c_int)]


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.head_train_rows_launch.argtypes = ([p, i, p, i, i, p] + [f] * 8
                                           + [i, i, f, i, p])
    lib.head_train_rows_launch.restype = i
    lib.head_train_max_rows.argtypes = []
    lib.head_train_max_rows.restype = i
    lib.head_train_smem.argtypes = [i, i, i]
    lib.head_train_smem.restype = i
    lib.head_error_exponent_launch.argtypes = [p, p, i, i, i, p]
    lib.head_error_exponent_launch.restype = i
    lib.sga_update_rows_launch.argtypes = ([p] * 7 + [i, i] + [f] * 4
                                           + [p])
    lib.sga_update_rows_launch.restype = i
    lib.sga_update_tree_launch.argtypes = [p, i] + [f] * 6 + [p]
    lib.sga_update_tree_launch.restype = i
    lib.sga_update_tree_max_leaves.argtypes = []
    lib.sga_update_tree_max_leaves.restype = i
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
    COUNTS_ROWS.add()
    return new_w, new_a


def sga_update_flat(w: torch.Tensor, g: torch.Tensor, accum: torch.Tensor,
                    lr: float, g_th: float, *, w_scale: float = W_SCALE,
                    w_max: float = W_MAX, a_scale: float = A_SCALE
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K3 on flat CUDA tensors (N,) with scalar ``lr``/``g_th``
    (rounded to float32, as the reference's static scalars are): a tree of
    one leaf."""
    if w.dim() != 1:
        raise ValueError(f"sga_update: w must be flat (N,), got shape "
                         f"{tuple(w.shape)}")
    (new_w,), (new_a,) = _tree_launch([w], [g], [accum], lr, g_th,
                                      w_scale, w_max, a_scale)
    return new_w, new_a


def _tree_launch(ws, gs, accs, lr, g_th, w_scale, w_max, a_scale):
    """K3 on the leaves of one CUDA device: one launch per
    ``TREE_MAX_LEAVES`` non-empty leaves, each leaf read where it lies
    (copied only if it is not contiguous).  The outputs of all leaves are
    views of one allocation; returns the flat (new_w, new_accum) lists."""
    dev = ws[0].device
    if dev.type != "cuda":
        raise ValueError(f"sga_update: no kernel for {dev}")
    ptrs, sizes, keep, total = [], [], [], 0
    for w, g, a in zip(ws, gs, accs):
        n = w.numel()
        row = []
        for name, v in (("w", w), ("g", g), ("accum", a)):
            if v.device != dev:
                raise ValueError(f"sga_update_tree: the tree's leaves lie "
                                 f"on more than one device: {dev} and "
                                 f"{v.device}")
            if v.dtype != torch.float32 or v.numel() != n:
                raise ValueError(f"sga_update: {name} must be float32 of "
                                 f"{n} elements, got {v.dtype} of "
                                 f"{v.numel()}")
            if not v.is_contiguous():
                v = v.contiguous()
                keep.append(v)          # alive until it is launched on
            row.append(v.data_ptr())
        ptrs.append((row, total))
        sizes.append(n)
        total += n
    out = torch.empty(2 * total, dtype=torch.float32, device=dev)
    base_w, base_a = out.data_ptr(), out.data_ptr() + 4 * total
    args = [(*row, base_w + 4 * off, base_a + 4 * off, n)
            for (row, off), n in zip(ptrs, sizes) if n]
    lo, hi = _bounds(w_scale, w_max)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for first in range(0, len(args), TREE_MAX_LEAVES):
            chunk = args[first:first + TREE_MAX_LEAVES]
            table = (_TreeLeaf * len(chunk))(*[_TreeLeaf(*a) for a in chunk])
            status = lib.sga_update_tree_launch(
                ctypes.addressof(table), len(chunk), float(lr), float(g_th),
                w_scale, lo, hi, a_scale, stream)
            kernels.check_launch(lib, "sga_update", status)
            COUNTS_FLAT.add()
    views = torch.split_with_sizes(out, sizes + sizes)     # one call
    return list(views[:len(sizes)]), list(views[len(sizes):])


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
    """Apply the fused update to every leaf (shapes preserved): one K3
    launch for a tree of CUDA leaves (one per ``TREE_MAX_LEAVES`` leaves),
    the plain version for a tree of CPU leaves; a tree on more than one
    device raises.  Returns (new_params, new_accums)."""
    leaves_w, rebuild = _flatten(params)
    leaves_g, _ = _flatten(grads)
    leaves_a, _ = _flatten(accums)
    if not len(leaves_w) == len(leaves_g) == len(leaves_a):
        raise ValueError("sga_update_tree: params, grads and accums differ "
                         "in structure")
    if not leaves_w:
        return rebuild([]), rebuild([])
    dev = leaves_w[0].device
    if dev.type == "cuda":
        new_w, new_a = _tree_launch(leaves_w, leaves_g, leaves_a, lr, g_th,
                                    W_SCALE, W_MAX, A_SCALE)
        for i, w in enumerate(leaves_w):
            if w.dim() != 1:
                new_w[i], new_a[i] = new_w[i].view(w.shape), \
                    new_a[i].view(w.shape)
    elif dev.type == "cpu":
        devices = {v.device for v in (*leaves_w, *leaves_g, *leaves_a)}
        if len(devices) > 1:
            raise ValueError(f"sga_update_tree: the tree's leaves lie on "
                             f"more than one device: "
                             f"{sorted(map(str, devices))}")
        lr_t = torch.tensor(lr, dtype=torch.float32)
        th_t = torch.tensor(g_th, dtype=torch.float32)
        new_w, new_a = [], []
        for w, g, a in zip(leaves_w, leaves_g, leaves_a):
            nw, na = sga_update_ref(w, g, a, lr_t, th_t)
            new_w.append(nw.reshape(w.shape))
            new_a.append(na.reshape(w.shape))
    else:
        raise ValueError(f"sga_update_tree: no kernel for {dev}")
    return rebuild(new_w), rebuild(new_a)


@dataclasses.dataclass(frozen=True)
class HeadTrainSpec:
    """The constants one ``head_train_rows`` launch shares across its rows
    (``core.onchip_training.head_train_spec`` makes it from a train
    config): the activation, error and gradient formats as (scale, qmin,
    qmax) with power-of-two scales; the weight grid and clip (``w_scale``,
    ``w_max``) and the bank grid ``a_scale``; the step-halving learning
    rate; the error scale (a fixed factor, 1.0 without scaling, or None
    for Eq (2)'s dynamic exponent with its mode and clamp); the softmax
    LUT's first point and step."""

    act: Tuple[float, int, int]
    error: Tuple[float, int, int]
    grad: Tuple[float, int, int]
    w_scale: float
    w_max: float
    a_scale: float
    lr_init: float
    lr_min: float
    lr_halve_every: int
    error_scale: Optional[float]
    error_scale_mode: str
    error_scale_max_exponent: Optional[int]
    lut_min: float
    lut_step: float

    def lr(self, epoch: int) -> np.float32:
        """The learning rate at ``epoch``, in float32 as
        ``onchip_training.lr_schedule`` computes it."""
        lr = np.float32(self.lr_init) * np.float32(0.5) ** np.float32(
            int(epoch) // self.lr_halve_every)
        return np.maximum(lr, np.float32(self.lr_min))

    def threshold(self, lr: np.float32) -> np.float32:
        """Eq (3)'s G_th = (w_scale / 2) / lr, one float32 division."""
        return np.float32(self.w_scale / 2.0) / np.float32(lr)


def head_train_smem(d: int, c: int, n: int) -> int:
    """Shared-memory bytes a ``head_train_rows`` block of an (n, d)
    feature buffer and a (d, c) head needs at least: the state and its
    banks, the 256-entry LUT, the (n, c) logits and a block maximum (the
    features then read from L2)."""
    return 4 * (2 * (d * c + c) + 256 + n * c + 16)


def _fmts(spec: HeadTrainSpec):
    vals = []
    for scale, qmin, qmax in (spec.act, spec.error, spec.grad):
        vals += [scale, 1.0 / scale, qmin, qmax]
    return (ctypes.c_float * 12)(*vals)


def head_train_rows(w: Sequence[torch.Tensor], b: Sequence[torch.Tensor],
                    accum_w: Sequence[torch.Tensor],
                    accum_b: Sequence[torch.Tensor],
                    feats: Sequence[torch.Tensor],
                    onehot: Sequence[torch.Tensor], start: Sequence[int],
                    epochs: Sequence[int], lut: torch.Tensor,
                    spec: HeadTrainSpec) -> None:
    """Launch the fused head training on CUDA tensors: row r runs epochs
    ``start[r] .. start[r] + epochs[r] - 1`` on its head w[r] (D, C),
    b[r] (C,) and banks accum_w[r], accum_b[r], with features feats[r]
    (N_r, D) on the activation grid and one-hot labels onehot[r] (N_r, C),
    all float32 and contiguous; ``lut`` is the (256,) softmax table.  The
    state is updated in place on PyTorch's current stream, without
    synchronising: one launch per ``HEAD_MAX_ROWS`` rows."""
    rows = len(w)
    if not rows:
        return
    dev = w[0].device
    d, c = w[0].shape
    lut = _state("lut", lut, (256,), dev)
    args = []
    for r in range(rows):
        n = feats[r].shape[0]
        for name, v, shape in (("w", w[r], (d, c)), ("b", b[r], (c,)),
                               ("accum_w", accum_w[r], (d, c)),
                               ("accum_b", accum_b[r], (c,)),
                               ("feats", feats[r], (n, d)),
                               ("onehot", onehot[r], (n, c))):
            if _state(name, v, shape, dev) is not v:
                raise ValueError(f"head_train_rows: {name} of row {r} must "
                                 f"be contiguous (it is updated in place)")
        if epochs[r] < 0 or start[r] < 0:
            raise ValueError(f"head_train_rows: row {r} has start "
                             f"{start[r]} and {epochs[r]} epochs")
        args.append((w[r].data_ptr(), b[r].data_ptr(),
                     accum_w[r].data_ptr(), accum_b[r].data_ptr(),
                     feats[r].data_ptr(), onehot[r].data_ptr(), n,
                     int(start[r]), int(epochs[r]), 0))
    lo, hi = _bounds(spec.w_scale, spec.w_max)
    if spec.error_scale is None:
        mode = 2 if spec.error_scale_mode == "floor" else 1
        fixed = 1.0
    else:
        mode, fixed = 0, float(np.float32(spec.error_scale))
    max_exp = (2 ** 31 - 1 if spec.error_scale_max_exponent is None
               else int(spec.error_scale_max_exponent))
    fmts = _fmts(spec)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for lo_row in range(0, rows, HEAD_MAX_ROWS):
            chunk = args[lo_row:lo_row + HEAD_MAX_ROWS]
            table = (_HeadRow * len(chunk))(*[_HeadRow(*a) for a in chunk])
            status = lib.head_train_rows_launch(
                ctypes.addressof(table), len(chunk), lut.data_ptr(), d, c,
                ctypes.addressof(fmts), spec.lut_min, 1.0 / spec.lut_step,
                spec.w_scale, lo, hi, spec.a_scale, spec.lr_init,
                spec.lr_min, spec.lr_halve_every, mode, fixed, max_exp,
                stream)
            if status == -1:
                raise ValueError(
                    f"head_train_rows: a ({d}, {c}) head with up to "
                    f"{max(a[6] for a in chunk)} utterances does not fit "
                    f"the shared memory of a block of the card")
            kernels.check_launch(lib, "head_train_rows", status)
            COUNTS_HEAD.add()


def head_error_exponent(m: torch.Tensor, mode: str = "ceil",
                        max_exponent: Optional[int] = None) -> torch.Tensor:
    """Eq (2)'s exponent of each max|err| in ``m`` (float32, >= 0, on a
    card) as the fused kernel computes it, int32: the card check of that
    arithmetic (``chip_smoke.py`` holds it against the exact exponent on
    every value the loop can meet)."""
    m = _state("m", m, tuple(m.shape), m.device).reshape(-1)
    out = torch.empty(m.shape, dtype=torch.int32, device=m.device)
    lib = library()
    with torch.cuda.device(m.device):
        status = lib.head_error_exponent_launch(
            m.data_ptr(), out.data_ptr(), m.numel(),
            2 if mode == "floor" else 1,
            2 ** 31 - 1 if max_exponent is None else int(max_exponent),
            torch.cuda.current_stream(m.device).cuda_stream)
    kernels.check_launch(lib, "head_error_exponent", status)
    return out


def head_train_batch(w, b, accum_w, accum_b, feats, onehot, start, epochs,
                     lut: torch.Tensor, spec: HeadTrainSpec) -> None:
    """A training tick's head-training budget for every session row, in
    place: the kernel (one launch) for CUDA tensors, the plain version
    for CPU tensors.  Arguments as ``head_train_rows``."""
    if not len(w):
        return
    if w[0].device.type == "cuda":
        return head_train_rows(w, b, accum_w, accum_b, feats, onehot,
                               start, epochs, lut, spec)
    if w[0].device.type != "cpu":
        raise ValueError(f"head_train_batch: no kernel for {w[0].device}")
    return head_train_rows_ref(w, b, accum_w, accum_b, feats, onehot,
                               start, epochs, lut, spec)
