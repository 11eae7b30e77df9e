"""Sharded train, prefill and decode steps on a live mesh: the port's
counterpart of ``jax.jit(step, in_shardings=..., out_shardings=...)``
under the reference's activation policy (``dryrun.py``,
``tests/test_distribution.py``).

Parameters, Adam's moments and decode caches live as ``DTensor``s at
``MeshPolicy``'s placements; a batch is a plain tensor that every rank
holds whole.  A step

  * gathers every parameter leaf whole (``all_gather_into_tensor`` over
    each mesh dim that shards it, the innermost first);
  * takes this rank's rows of the batch (``batch_specs``: the batch axes
    split dimension 0; ranks that differ only on other axes hold the same
    rows).  The step's ``ShardingPolicy`` (``activation_policy`` with
    ``data_axes`` the axes that split this batch) names the axes every
    batch statistic is summed over;
  * runs the single-device step (``launch/steps.py``) on those rows;
  * train: scales the loss and the gradients by the rank's share of the
    rows and sums them over the batch axes (``all_reduce``), keeps this
    rank's shard of each gradient and runs the optimizer on the local
    shards.  The MoE family's load-balancing loss reads the router's
    means over the global batch, as the reference's sharded step does:
    each MoE layer sums its rows' two means of E floats over the batch
    axes (``moe.batch_statistics``; under remat the layer's forward, and
    so that sum, runs again in the backward);
  * prefill / decode: gathers the logits' rows over the batch axes and
    keeps this rank's shard of the caches (a decode step first gathers
    each cache over its non-batch axes).

So the ``model`` axis shards the memory a rank holds between steps, but
not the work and not the peak: during a step every rank holds the whole
model, gathered in its stored dtype (float32 to train), and in a train
step the whole float32 gradients too, before it keeps its shards of them.
A rank's peak is at least the whole parameters plus, to train, the whole
gradients, on top of its shards (the dry run's ``step_floor_bytes``); a
cell whose floor exceeds the card's memory cannot run this step.
Gathering each layer's leaves as the layer runs and reduce-scattering the
gradients (FSDP) is on ROADMAP's speed list, beside tensor-parallel
products.  On a mesh of one rank every gather and sum is skipped and
every slice is the whole tensor: the step is the plain step, bit for bit,
with the same peak memory.

``train_plan``, ``prefill_plan`` and ``decode_plan`` list the bytes of
the collectives each step issues, per rank and per op, from shapes alone
(the dry run's collective term); ``analysis.count_collectives`` counts
them as a step runs, and the two agree.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.launch import analysis
from repro_torch.launch import steps as S
from repro_torch.launch.mesh_policy import MeshPolicy, map_specs, \
    map_with_path
from repro_torch.models import encdec as ED
from repro_torch.models import lm as LM
from repro_torch.models import moe as MOE
from repro_torch.models.layers import COMPUTE_DTYPE, ShardingPolicy, Spec
from repro_torch.optim.optimizers import OptState, tree_map

Dims = Dict[int, List[str]]        # tensor dim -> mesh axes, outermost first


def spec_dims(spec: Spec, names: Sequence[str]) -> Dims:
    """The tensor dims ``spec`` shards, each with its mesh axes in mesh
    order."""
    return {d: sorted(spec.axes(d), key=list(names).index)
            for d in range(len(spec)) if spec.axes(d)}


def _placement_dims(pl, names: Sequence[str]) -> Dims:
    dims: Dims = {}
    for name, p in zip(names, pl):
        if p.is_shard():
            dims.setdefault(p.dim, []).append(name)
    return dict(sorted(dims.items()))


def _gather_steps(shape: Sequence[int], dims: Dims, sizes: Dict[str, int],
                  skip: Sequence[str] = ()
                  ) -> Iterator[Tuple[int, str, Tuple[int, ...]]]:
    """(tensor dim, mesh axis, output shape) of each all-gather that makes
    a shard of ``shape`` whole over every axis but ``skip``: per dimension
    the innermost axis first; an axis of size 1 moves nothing."""
    cur = list(shape)
    for d, axes in dims.items():
        for a in reversed(axes):
            if a in skip or sizes[a] == 1:
                continue
            cur[d] *= sizes[a]
            yield d, a, tuple(cur)


def _local_shape(shape: Sequence[int], dims: Dims,
                 sizes: Dict[str, int]) -> Tuple[int, ...]:
    out = list(shape)
    for d, axes in dims.items():
        n = math.prod(sizes[a] for a in axes)
        if out[d] % n:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"divide over {axes} ({n})")
        out[d] //= n
    return tuple(out)


def shard_bytes(shape: Sequence[int], itemsize: int, spec: Spec,
                sizes: Dict[str, int]) -> int:
    """The bytes of one rank's shard of a ``shape`` leaf at ``spec``."""
    local = _local_shape(shape, spec_dims(spec, list(sizes)), sizes)
    return math.prod(local) * itemsize


class MeshView:
    """A live mesh as the steps use it: axis names, sizes, this rank's
    coordinate; gathers, slices and sums over its axes' process groups,
    each collective counted (``analysis.record``)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.sizes = dict(zip(self.names, mesh.shape))
        coord = mesh.get_coordinate()
        if coord is None:
            raise RuntimeError("this rank is not in the mesh")
        self.coord = dict(zip(self.names, coord))

    def gather(self, x: torch.Tensor, dims: Dims, skip=()) -> torch.Tensor:
        for d, a, _ in _gather_steps(x.shape, dims, self.sizes, skip):
            k = self.sizes[a]
            out = torch.empty(k * x.numel(), dtype=x.dtype, device=x.device)
            dist.all_gather_into_tensor(out, x.reshape(-1),
                                        group=self.mesh.get_group(a))
            analysis.record("all-gather", out.numel() * out.element_size())
            x = torch.cat(out.view((k,) + tuple(x.shape)).unbind(0), dim=d)
        return x

    def shard(self, x: torch.Tensor, dims: Dims, skip=()) -> torch.Tensor:
        """This rank's slice of ``x`` over every axis of ``dims`` but
        ``skip`` (a view)."""
        for d, axes in dims.items():
            axes = [a for a in axes if a not in skip]
            n = math.prod(self.sizes[a] for a in axes)
            if n == 1:
                continue
            idx = 0
            for a in axes:
                idx = idx * self.sizes[a] + self.coord[a]
            step = x.shape[d] // n
            x = x.narrow(d, idx * step, step)
        return x

    def sum(self, x: torch.Tensor, axes: Sequence[str]) -> torch.Tensor:
        """``x`` summed in place over ``axes``, the innermost first."""
        for a in reversed(axes):
            if self.sizes[a] > 1:
                dist.all_reduce(x, group=self.mesh.get_group(a))
                analysis.record("all-reduce", x.numel() * x.element_size())
        return x

    def wrap(self, local: torch.Tensor, like_shape, pl):
        from torch.distributed.tensor import DTensor
        shape = tuple(like_shape)
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        return DTensor.from_local(local, self.mesh, pl, run_check=False,
                                  shape=shape, stride=stride)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def whole(m: MeshView, x) -> torch.Tensor:
    """A ``DTensor`` leaf gathered whole over ``m`` (a plain tensor as it
    is); every rank of the mesh calls it."""
    if not _is_dtensor(x):
        return x
    return m.gather(x.to_local(), _placement_dims(x.placements, m.names))


def _rows(m: MeshView, policy: MeshPolicy, batch):
    """(this rank's rows of every batch leaf, the step's activation
    policy: ``data_axes`` the axes that split this batch)."""
    bspecs = policy.batch_specs(batch)
    rows = map_specs(lambda s, x: m.shard(x, spec_dims(s, m.names)),
                     bspecs, batch)
    axes = spec_dims(bspecs["tokens"], m.names).get(0, [])
    return rows, dataclasses.replace(policy.activation_policy(),
                                     data_axes=tuple(axes))


def _gather_rows(m: MeshView, x: torch.Tensor,
                 act: ShardingPolicy) -> torch.Tensor:
    return (m.gather(x, {0: list(act.data_axes)}) if act.data_axes
            else x)


def _policy_mesh(policy: MeshPolicy) -> MeshView:
    if policy.mesh is None:
        raise ValueError("a sharded step needs a MeshPolicy over a live "
                         "DeviceMesh")
    return MeshView(policy.mesh)


def _global_router_means(m: MeshView, act: ShardingPolicy, share: float):
    """``moe.batch_statistics``' function: a MoE layer's means over its
    rows taken to the global batch's, each rank's means times its share
    summed over the batch axes.  The router-probability mean keeps its
    own rows' gradient (``me_g + (me - me.detach())`` is ``me_g``), so the
    gradients summed over the ranks times their shares are the global
    aux loss's."""
    def fn(me, ce):
        both = m.sum(torch.cat([me.detach(), ce]) * share, act.data_axes)
        me_g, ce_g = both.split(me.numel())
        return me_g + (me - me.detach()), ce_g
    return fn


def make_train_step(cfg, policy: MeshPolicy, optimizer=None):
    """``train_step(params, opt_state, batch)`` -> (params, opt_state,
    {"loss", "total"}) with ``params`` and the optimizer's moments as
    ``DTensor``s (``elastic.reshard_to``; ``optimizer.init`` of them) and
    the batch whole on every rank.  The loss is the mean over the global
    batch, and the MoE family's aux loss the global batch's."""
    optimizer = optimizer or S.make_optimizer(cfg)
    m = _policy_mesh(policy)

    def train_step(params, opt_state, batch):
        full = tree_map(lambda x: whole(m, x), params)
        rows, act = _rows(m, policy, batch)
        share = 1.0 / act.size(act.data_axes)
        if share == 1.0:
            (total, loss), grads = S.loss_and_grads(cfg, full, rows)
        else:
            with MOE.batch_statistics(_global_router_means(m, act, share)):
                (total, loss), grads = S.loss_and_grads(cfg, full, rows)
        del full
        metrics = torch.stack([loss, total])
        if share != 1.0:
            metrics = m.sum(metrics * share, act.data_axes)
            grads = tree_map(lambda g: m.sum(g * share, act.data_axes),
                             grads)
        local = lambda t: t.to_local() if _is_dtensor(t) else t
        grads = tree_map(
            lambda g, p: m.shard(g, _placement_dims(p.placements, m.names))
            if _is_dtensor(p) else g, grads, params)
        new_p, new_o = optimizer.update(
            grads, OptState(opt_state.step, tree_map(local, opt_state.mu),
                            tree_map(local, opt_state.nu)),
            tree_map(local, params))
        rewrap = lambda new, old: (m.wrap(new, old.shape, old.placements)
                                   if _is_dtensor(old) else new)
        return (tree_map(rewrap, new_p, params),
                OptState(new_o.step, tree_map(rewrap, new_o.mu, opt_state.mu),
                         tree_map(rewrap, new_o.nu, opt_state.nu)),
                {"loss": metrics[0], "total": metrics[1]})
    return train_step


def global_caches(cfg, batch: int, seq: int):
    """Meta tensors of the caches a prefill of ``batch`` x ``seq`` makes."""
    if cfg.family == "encdec":
        return ED.init_dec_cache(cfg, batch, seq, device="meta")
    return LM.init_cache(cfg, batch, seq, device="meta")


def make_prefill_step(cfg, policy: MeshPolicy):
    """``prefill_step(params, batch)`` -> (last logits, caches[, memory])
    as ``steps.make_prefill_step``'s, the logits (and the encdec family's
    memory) whole on every rank, the caches ``DTensor``s at
    ``cache_specs``."""
    m = _policy_mesh(policy)
    step = S.make_prefill_step(cfg)

    def prefill_step(params, batch):
        full = tree_map(lambda x: whole(m, x), params)
        rows, act = _rows(m, policy, batch)
        out = step(full, rows)
        del full
        b, s = batch["tokens"].shape
        if cfg.family == "vlm" and "frames" in batch:
            s += batch["frames"].shape[1]
        like = global_caches(cfg, b, s)
        specs = policy.cache_specs(like)

        def keep(spec, pl, c, g):
            local = m.shard(c, spec_dims(spec, m.names), skip=act.data_axes)
            return m.wrap(local, g.shape, pl)
        caches = map_specs(keep, specs, policy.shardings(specs), out[1],
                           like)
        rest = tuple(_gather_rows(m, x, act) for x in out[2:])
        return (_gather_rows(m, out[0], act), caches) + rest
    return prefill_step


def make_decode_step(cfg, policy: MeshPolicy):
    """``decode_fn(params, caches, batch)`` -> (logits (B, 1, Vpad) whole
    on every rank, new caches as ``DTensor``s at the given caches'
    placements)."""
    m = _policy_mesh(policy)
    step = S.make_decode_step(cfg)

    def decode_fn(params, caches, batch):
        full = tree_map(lambda x: whole(m, x), params)
        rows, act = _rows(m, policy, batch)
        axes = act.data_axes
        mine = tree_map(lambda c: m.gather(
            c.to_local(), _placement_dims(c.placements, m.names), skip=axes),
            caches)
        logits, new = step(full, mine, rows)
        del full, mine
        new = tree_map(lambda n, c: m.wrap(
            m.shard(n, _placement_dims(c.placements, m.names), skip=axes),
            c.shape, c.placements), new, caches)
        return _gather_rows(m, logits, act), new
    return decode_fn


# ---------------------------------------------------------------------------
# The collective plans (shapes only: the dry run)
# ---------------------------------------------------------------------------


def _leaves_with_specs(specs, tree) -> List[Tuple[Spec, torch.Tensor]]:
    out: List[Tuple[Spec, torch.Tensor]] = []
    map_specs(lambda s, x: out.append((s, x)), specs, tree)
    return out


def _add(counts, op: str, nbytes: int) -> None:
    counts[op] += nbytes
    counts["total"] += nbytes


def _plan_gathers(counts, pairs, sizes, skip=()) -> None:
    """The all-gathers that make each (spec, leaf) whole but ``skip``."""
    names = list(sizes)
    for spec, x in pairs:
        dims = spec_dims(spec, names)
        local = _local_shape(x.shape, dims, sizes)
        for _, _, shape in _gather_steps(local, dims, sizes, skip):
            _add(counts, "all-gather", math.prod(shape) * x.element_size())


def _batch_axes(policy: MeshPolicy, batch) -> List[str]:
    spec = policy.batch_specs(batch)["tokens"]
    return spec_dims(spec, list(policy.sizes)).get(0, [])


def _rows_spec(axes) -> Spec:
    return Spec(tuple(axes) or None)


def _router_stats(cfg, params) -> int:
    """The floats each step's forward and backward sum for the MoE
    router's statistics (``_global_router_means``): two means of E floats
    per MoE layer, twice under remat."""
    found: List[int] = []
    map_with_path(lambda path, x: found.append(
        (x.shape[0] if x.dim() == 3 else 1) * 2 * x.shape[-1])
        if path.endswith("router/w") else None, params)
    return sum(found) * (2 if cfg.remat else 1)


def train_plan(policy: MeshPolicy, cfg, params, batch) -> Dict[str, float]:
    """Per-rank collective bytes of one ``make_train_step`` step on
    ``params`` and ``batch`` (meta tensors do)."""
    sizes, counts = policy.sizes, analysis.zero_collectives()
    leaves = _leaves_with_specs(policy.param_specs(params), params)
    _plan_gathers(counts, leaves, sizes)
    stats = _router_stats(cfg, params)
    for a in _batch_axes(policy, batch):
        if sizes[a] > 1:
            _add(counts, "all-reduce", 2 * 4)                  # the metrics
            for _, x in leaves:
                _add(counts, "all-reduce", x.numel() * 4)     # float32 grads
            if stats:
                _add(counts, "all-reduce", stats * 4)    # the router's means
    return counts


def logits_shape(cfg, b: int) -> Tuple[int, int, int]:
    """A prefill's or decode step's logits: (B, 1, Vpad), bfloat16."""
    return (b, 1, cfg.vocab_padded)


def prefill_plan(policy: MeshPolicy, cfg, params, batch) -> Dict[str, float]:
    """Per-rank collective bytes of one ``make_prefill_step`` step."""
    sizes, counts = policy.sizes, analysis.zero_collectives()
    _plan_gathers(counts, _leaves_with_specs(policy.param_specs(params),
                                             params), sizes)
    rows = _rows_spec(_batch_axes(policy, batch))
    outs = [torch.empty(logits_shape(cfg, batch["tokens"].shape[0]),
                        dtype=COMPUTE_DTYPE, device="meta")]
    if cfg.family == "encdec":                                 # the memory
        outs.append(batch["frames"])
    _plan_gathers(counts, [(rows, x) for x in outs], sizes)
    return counts


def decode_plan(policy: MeshPolicy, cfg, params, caches,
                batch) -> Dict[str, float]:
    """Per-rank collective bytes of one ``make_decode_step`` step on
    caches laid out at ``cache_specs``."""
    sizes, counts = policy.sizes, analysis.zero_collectives()
    _plan_gathers(counts, _leaves_with_specs(policy.param_specs(params),
                                             params), sizes)
    axes = _batch_axes(policy, batch)
    _plan_gathers(counts, _leaves_with_specs(policy.cache_specs(caches),
                                             caches), sizes, skip=axes)
    logits = torch.empty(logits_shape(cfg, batch["tokens"].shape[0]),
                         dtype=COMPUTE_DTYPE, device="meta")
    _plan_gathers(counts, [(_rows_spec(axes), logits)], sizes)
    return counts
