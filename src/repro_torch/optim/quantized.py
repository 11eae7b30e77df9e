"""Fixed-point SGD with SGA banking as a tree optimizer (paper Alg 1).

Port of ``repro/optim/quantized.py``: gradients quantized to Q1.7,
optionally perturbed by RGP noise (drawn with ``core.jaxrand`` down the
reference's key chain: one ``split`` per leaf, in the tree's leaf order),
banked by SGA into 16-bit accumulators, and the step ``p - lr * g``
quantized back onto the weight grid.  Every value lies on a fixed-point
grid, so the update is the reference's bit for bit.  It runs the plain
``sga_step`` per leaf, as the reference does; the SGA kernels serve the
customization sessions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import jaxrand
from repro_torch.core.onchip_training import rgp_noise, sga_step, sga_threshold
from repro_torch.core.quantize import ACCUM_Q, GRAD_Q, WEIGHT_Q, QFormat
from repro_torch.optim.optimizers import (Tree, tree_leaves, tree_map,
                                          tree_unflatten)


class QuantizedSGDState(NamedTuple):
    step: int
    accum: Tree              # SGA banks, one per parameter leaf
    key: torch.Tensor        # jaxrand key of the RGP draws


def quantized_sgd_init(params: Tree, seed: int = 0) -> QuantizedSGDState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return QuantizedSGDState(step=0,
                             accum=tree_map(torch.zeros_like, params),
                             key=jaxrand.PRNGKey(seed, device=dev))


def quantized_sgd_step(grads: Tree, state: QuantizedSGDState, params: Tree,
                       lr, sga: bool = True,
                       rgp_lambda: Optional[float] = None,
                       weight_fmt: QFormat = WEIGHT_Q,
                       grad_fmt: QFormat = GRAD_Q,
                       accum_fmt: QFormat = ACCUM_Q
                       ) -> Tuple[Tree, QuantizedSGDState]:
    """One step over every leaf, in the tree's leaf order (so the RGP key
    chain is the reference's).  Returns (new params, new state)."""
    key = state.key
    lr = torch.as_tensor(lr, dtype=torch.float32, device=key.device)
    g_th = sga_threshold(lr, weight_fmt)
    new_p, new_a = [], []
    with torch.no_grad():
        for g, a, p in zip(tree_leaves(grads), tree_leaves(state.accum),
                           tree_leaves(params)):
            g = grad_fmt.quantize(g)
            if rgp_lambda is not None:
                key, sub = jaxrand.split(key)
                g = grad_fmt.quantize(g + rgp_noise(sub, g.shape, rgp_lambda,
                                                    grad_fmt))
            if sga:
                g, a = sga_step(g, a, g_th, accum_fmt)
            new_p.append(weight_fmt.quantize(p - lr * g))
            new_a.append(a)
    return tree_unflatten(params, new_p), QuantizedSGDState(
        step=state.step + 1, accum=tree_unflatten(params, new_a), key=key)
