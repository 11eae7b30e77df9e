"""±1 binarization, channel shuffle and OR-maxpool (forward only).

Port of ``repro/core/binary.py``'s inference half: the serving path never
takes a gradient, so the straight-through estimators are not ported.
"""

from __future__ import annotations

import torch


def binarize(x: torch.Tensor) -> torch.Tensor:
    """sign(x) in {-1, +1}; zero (and -0.0) maps to +1."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


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
