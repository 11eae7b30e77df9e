"""Pipeline parallelism (GPipe) as a library feature: the JAX package's
``launch/pipeline.py`` on ``torch.distributed``.

Layers are split into S stages along a ``pipe`` mesh axis; microbatches
stream through the stages, each tick's outputs passed one stage on around
a ring (``batch_isend_irecv``, the reference's ``ppermute``), in the
classic GPipe schedule of S + M - 1 ticks for M microbatches.  The last
stage writes microbatch ``t - (S - 1)`` at tick ``t``; a final
``all_reduce(SUM)`` over the axis (the reference's ``psum``) hands every
stage the outputs, exactly, since only the last stage's are nonzero.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.launch import analysis
from repro_torch.optim.optimizers import tree_map


def pipeline_apply(layer_fn: Callable, mesh, n_microbatches: int,
                   axis: str = "pipe"):
    """Returns ``fn(stage_params, x)`` running a GPipe pipeline over the
    mesh axis ``axis``.

    ``layer_fn(params_for_stage, x_microbatch) -> x_microbatch`` applies
    one stage's layers.  ``stage_params`` leaves are stacked over stages
    (leading dim = n_stages): whole tensors, or ``DTensor``s sharded over
    ``axis`` on that dim.  ``x``: (batch, ...) with batch % n_microbatches
    == 0, the same on every rank; every rank returns the whole output."""
    group = mesh.get_group(axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    stage = mesh.get_local_rank(axis)
    ranks = dist.get_process_group_ranks(group)
    nxt, prv = ranks[(stage + 1) % n_stages], ranks[(stage - 1) % n_stages]

    def mine(a):
        if hasattr(a, "to_local"):                    # a DTensor over axis
            return a.to_local()[0]
        return a[stage]

    def run(stage_params, x):
        params = tree_map(mine, stage_params)
        mb = x.reshape(n_microbatches, -1, *x.shape[1:])
        buf = torch.zeros_like(mb[0])
        outs = torch.zeros_like(mb)
        for t in range(n_stages + n_microbatches - 1):
            # stage 0 ingests microbatch t (if any)
            incoming = mb[t] if t < n_microbatches else torch.zeros_like(buf)
            y = layer_fn(params, incoming if stage == 0 else buf)
            # pass to the next stage
            if n_stages > 1:
                buf = torch.empty_like(y)
                reqs = dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                    dist.P2POp(dist.irecv, buf, prv, group)])
                for r in reqs:
                    r.wait()
                analysis.record("collective-permute",
                                buf.numel() * buf.element_size())
            else:
                buf = y
            # the last stage emits microbatch t - (n_stages - 1)
            emit = t - (n_stages - 1)
            if 0 <= emit < n_microbatches and stage == n_stages - 1:
                outs[emit] = y
        # only the last stage holds the outputs; replicate to all stages
        dist.all_reduce(outs, group=group)
        analysis.record("all-reduce", outs.numel() * outs.element_size())
        return outs.reshape(x.shape)

    return run
