"""Elastic scaling: re-mesh and reshard from a checkpoint after losing
ranks, the JAX package's ``launch/elastic.py`` on ``torch.distributed``.

The recovery path:
  1. find the ranks still healthy,
  2. rebuild the mesh with the largest valid (data, model) factorization
     (``best_mesh_shape``, ``remesh``),
  3. restore the latest checkpoint on the host and lay it out on the new
     mesh (``reshard_to``),
  4. resume the token pipeline from the checkpointed step
     (``data.tokens.batch_at_step`` is stateless).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.launch.mesh_policy import map_specs
from repro_torch.launch.sharded import MeshView, spec_dims
from repro_torch.models.layers import placements


def best_mesh_shape(n_devices: int, model_parallel_target: int
                    ) -> Tuple[int, int]:
    """Largest (data, model) grid for the available ranks: keep model
    parallelism at the largest divisor of the target that fits (halving,
    since TP degrees must divide head and ff dims)."""
    model = min(model_parallel_target, n_devices)
    while model > 1 and (n_devices % model != 0):
        model //= 2
    return n_devices // model, model


def remesh(ranks: Optional[Sequence[int]] = None,
           model_parallel_target: int = 16) -> DeviceMesh:
    """A (data, model) mesh over the first ``data * model`` of ``ranks``
    (every rank of the process group by default), its axes in new process
    groups, on the process group's device: "cuda" under NCCL, else "cpu".
    Every rank of the process group calls it; a rank outside the mesh gets
    no coordinate."""
    ranks = list(ranks) if ranks is not None else list(
        range(dist.get_world_size()))
    data, model = best_mesh_shape(len(ranks), model_parallel_target)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    grid = torch.tensor(ranks[:data * model]).reshape(data, model)
    return DeviceMesh(device_type, grid, mesh_dim_names=("data", "model"))


def reshard_to(mesh: DeviceMesh, tree, spec_tree):
    """A host tree (e.g. restored from a checkpoint) laid out on ``mesh``:
    every leaf at a ``Spec`` of ``spec_tree`` becomes a ``DTensor`` whose
    local shard is this rank's slice, on the mesh's device; other leaves
    (the optimizer's step) stay as they are."""
    m = MeshView(mesh)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device("cpu"))

    def put(spec, x):
        if not isinstance(x, torch.Tensor):
            return x
        local = m.shard(x, spec_dims(spec, m.names)).to(dev)
        return m.wrap(local.contiguous(), x.shape,
                      placements(spec, m.names))
    return map_specs(put, spec_tree, tree)
