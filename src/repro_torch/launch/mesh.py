"""Process groups and device meshes of the LM stack: the JAX package's
``launch/mesh.py`` on ``torch.distributed``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks
of the process group, with the reference's axis names: 16 x 16 ("data",
"model") for one pod, 2 x 16 x 16 ("pod", "data", "model") for two.  A
rank is one card (or one CPU process with ``device="cpu"``), so a mesh
needs as many ranks as it has positions; one that does not fit the world
raises.  Building a mesh starts nothing: ``init_distributed`` makes the
process group first.

On one card (``python3 chip_smoke.py --launch``) the world is one rank
and the mesh 1 x 1; with ``torchrun --nproc-per-node N`` each rank reads
its place from torchrun's environment.
"""

from __future__ import annotations

import math
import os
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.kernels import resolve_device

PRODUCTION = ((16, 16), ("data", "model"))
PRODUCTION_MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


def init_distributed(device=None) -> dist.ProcessGroup:
    """The default process group for ``device`` (``None`` means CUDA):
    NCCL on CUDA, gloo on the CPU.  Under torchrun (``RANK`` and
    ``WORLD_SIZE`` set) it joins torchrun's world, each rank on card
    ``LOCAL_RANK``; otherwise it makes a world of one rank on a
    ``HashStore``.  A group that already exists is kept if its backend is
    the device's."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}"
                               f", not {backend} for {dev}")
        return dist.group.WORLD
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.group.WORLD


def _device_mesh(shape: Sequence[int], names: Sequence[str],
                 device=None) -> DeviceMesh:
    """A mesh of ``shape`` over every rank of the process group, axes
    ``names``, on ``device``'s type (``None`` means CUDA)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first")
    need, world = math.prod(shape), dist.get_world_size()
    if need != world:
        raise ValueError(f"a {tuple(shape)} mesh needs {need} ranks; the "
                         f"process group has {world}")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> DeviceMesh:
    """Single pod: 16 x 16 (data, model).  Multi-pod: 2 x 16 x 16 (pod,
    data, model): DP across pods, FSDP over ``data``, TP / EP over
    ``model``."""
    shape, names = PRODUCTION_MULTI_POD if multi_pod else PRODUCTION
    return _device_mesh(shape, names, device)


def make_debug_mesh(n_data: int = 2, n_model: int = 2,
                    device=None) -> DeviceMesh:
    """A small (data, model) mesh for the distribution tests."""
    return _device_mesh((n_data, n_model), ("data", "model"), device)
