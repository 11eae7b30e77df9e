"""±1 binarization with its straight-through estimators, channel shuffle
and OR-maxpool (paper §II).

Port of ``repro/core/binary.py``:

- ``binarize``: sign(x) in {-1, +1} with the clipped straight-through
  gradient (passed where |x| <= 1);
- ``binarize_sg``: the same hard forward with the surrogate gradient
  alpha * (1 - tanh(alpha x)**2), for the hard phases of training;
- ``rsign``: ReActNet's learnable-threshold sign(x + offset) (paper Fig 2);
- ``binary_matmul``: the ±1 inner product (#agree - #disagree).

Each estimator is a ``torch.autograd.Function`` whose backward is the
reference's ``custom_vjp`` rule, in the reference's operation order.
"""

from __future__ import annotations

import torch


def _sign(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


class _BinarizeSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return _sign(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g * (torch.abs(x) <= 1.0).to(g.dtype)


class _BinarizeSG(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.save_for_backward(x)
        ctx.alpha = alpha
        return _sign(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        t = torch.tanh(ctx.alpha * x)
        return g * ctx.alpha * (1.0 - t * t), None


def binarize(x: torch.Tensor) -> torch.Tensor:
    """sign(x) in {-1, +1}; zero (and -0.0) maps to +1.  Backward: the
    gradient passes where |x| <= 1 and is zero elsewhere."""
    return _BinarizeSTE.apply(x)


def binarize_sg(x: torch.Tensor, alpha: float) -> torch.Tensor:
    """Hard sign forward, tanh-derivative surrogate backward
    (g * alpha * (1 - tanh(alpha x)**2)): the forward is the bit-exact
    binary network while the gradient stays informative."""
    return _BinarizeSG.apply(x, alpha)


def rsign(x: torch.Tensor, offset: torch.Tensor,
          channel_axis: int = -1) -> torch.Tensor:
    """Learnable-threshold binarization sign(x + offset), ``offset`` per
    channel along ``channel_axis``."""
    shape = [1] * x.dim()
    shape[channel_axis] = x.shape[channel_axis]
    return binarize(x + offset.reshape(shape))


def binary_matmul(x_bin: torch.Tensor, w_bin: torch.Tensor) -> torch.Tensor:
    """Inner product of ±1 operands, (#agree - #disagree)."""
    return torch.matmul(x_bin, w_bin)


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """ShuffleNet channel shuffle on the last axis: pre-shuffle channel
    g*cog + a moves to a*groups + g (paper Fig 9's digital block)."""
    if groups <= 1:
        return x
    c = x.shape[-1]
    if c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    shape = x.shape[:-1]
    return (x.reshape(*shape, groups, c // groups)
            .transpose(-1, -2)
            .reshape(*shape, c))


def or_maxpool(x_bin: torch.Tensor, window: int, axis: int = 1
               ) -> torch.Tensor:
    """Max-pool on ±1 activations (== logical OR) over ``window`` adjacent
    positions of ``axis``; a trailing partial window is dropped."""
    n_out = x_bin.shape[axis] // window
    x = x_bin.narrow(axis, 0, n_out * window)
    shape = x.shape[:axis] + (n_out, window) + x.shape[axis + 1:]
    return torch.amax(x.reshape(shape), dim=axis + 1)
