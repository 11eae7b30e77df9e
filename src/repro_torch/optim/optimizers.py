"""Adam, SGD with momentum, cosine and step-decay schedules and global-norm
clipping over trees of tensors.

Port of ``repro/optim/optimizers.py``.  A tree is a tensor, ``None``, or
a dict or list of trees; its leaves are taken in sorted key order and list
order, as JAX flattens them (``tree_leaves``, ``tree_map``).  Updates run under
``torch.no_grad()`` and return new tensors.

The step counter is a Python int, so the schedule and Adam's bias
corrections are float32 scalars computed on the host with numpy, the
same numbers on every device.  Each follows the reference's expression
as XLA compiles it under ``jit``: a division by a static number is a
product with its float32 reciprocal (``core.means``), and Python
constants are rounded to float32 once.  ``cos``, ``pow`` and the sums of
``clip_by_global_norm`` round differently from XLA's by an ulp or two;
the tests state that tolerance.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.means import reciprocal

Schedule = Callable[[int], np.float32]
Tree = Any
f32 = np.float32


def tree_leaves(tree: Tree) -> list:
    """The tensors of ``tree`` in JAX's order (dict keys sorted, lists in
    order)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_unflatten(tree: Tree, leaves: list) -> Tree:
    """A tree of ``tree``'s structure holding ``leaves``, taken in
    ``tree_leaves``' order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, list):
            return [build(x) for x in t]
        return next(it)
    return build(tree)


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, keeping the dict and list structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def cosine_schedule(base_lr: float, total_steps: int,
                    warmup_steps: int = 0, min_lr: float = 0.0) -> Schedule:
    """Linear warm-up over ``warmup_steps``, then a cosine from ``base_lr``
    to ``min_lr`` at ``total_steps``."""
    half_range = f32(0.5 * (base_lr - min_lr))
    inv_warm = f32(reciprocal(max(1, warmup_steps)))
    inv_span = f32(reciprocal(max(1, total_steps - warmup_steps)))

    def fn(step: int) -> np.float32:
        s = f32(step)
        if s < warmup_steps:
            return f32(base_lr) * s * inv_warm
        prog = np.clip((s - f32(warmup_steps)) * inv_span, f32(0), f32(1))
        return f32(min_lr) + half_range * (
            f32(1) + np.cos(f32(math.pi) * prog))
    return fn


def step_decay_schedule(base_lr: float, decay: float, every: int,
                        min_lr: float = 0.0) -> Schedule:
    """The paper's customization schedule: ``base_lr * decay**(step //
    every)``, floored at ``min_lr`` (§VI-A3: 1/16, halved every 10 epochs,
    down to 1/128)."""
    def fn(step: int) -> np.float32:
        lr = f32(base_lr) * f32(decay) ** f32(int(step) // every)
        return np.maximum(lr, f32(min_lr))
    return fn


class OptState(NamedTuple):
    step: int
    mu: Tree          # first moment / momentum
    nu: Tree          # second moment (Adam only)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], OptState]
    update: Callable[[Tree, OptState, Tree], Tuple[Tree, OptState]]
    schedule: Schedule


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    """Scale ``grads`` so that their global L2 norm is at most
    ``max_norm``.  Returns (clipped grads, the norm before clipping)."""
    with torch.no_grad():
        total = 0
        for g in tree_leaves(grads):
            total = total + torch.sum(torch.square(g))
        gnorm = torch.sqrt(total)
        scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
        return tree_map(lambda g: g * scale, grads), gnorm


def adam(schedule: Schedule, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8, weight_decay: float = 0.0,
         clip_norm: Optional[float] = None) -> Optimizer:
    """Adam(W): bias-corrected moments, the step ``lr * (m / (sqrt(v) +
    eps) + weight_decay * p)``."""
    def init(params: Tree) -> OptState:
        return OptState(step=0, mu=tree_map(torch.zeros_like, params),
                        nu=tree_map(torch.zeros_like, params))

    def update(grads: Tree, state: OptState, params: Tree
               ) -> Tuple[Tree, OptState]:
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = state.step + 1
        lr = float(schedule(step))
        b1c = float(f32(1) - f32(b1) ** f32(step))
        b2c = float(f32(1) - f32(b2) ** f32(step))
        with torch.no_grad():
            mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.mu,
                          grads)
            nu = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.nu,
                          grads)

            def upd(p, m, v):
                mh, vh = m / b1c, v / b2c
                return p - lr * (mh / (torch.sqrt(vh) + eps)
                                 + weight_decay * p)

            new_params = tree_map(upd, params, mu, nu)
        return new_params, OptState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update, schedule=schedule)


def sgd(schedule: Schedule, momentum: float = 0.0,
        clip_norm: Optional[float] = None) -> Optimizer:
    """SGD with optional heavy-ball momentum (``mu = momentum * mu + g``)."""
    def init(params: Tree) -> OptState:
        return OptState(step=0, mu=tree_map(torch.zeros_like, params),
                        nu=None)

    def update(grads: Tree, state: OptState, params: Tree
               ) -> Tuple[Tree, OptState]:
        if clip_norm is not None:
            grads, _ = clip_by_global_norm(grads, clip_norm)
        step = state.step + 1
        lr = float(schedule(step))
        with torch.no_grad():
            mu = (tree_map(lambda m, g: momentum * m + g, state.mu, grads)
                  if momentum else grads)
            new_params = tree_map(lambda p, m: p - lr * m, params, mu)
        return new_params, OptState(step=step,
                                    mu=mu if momentum else state.mu,
                                    nu=None)

    return Optimizer(init=init, update=update, schedule=schedule)
