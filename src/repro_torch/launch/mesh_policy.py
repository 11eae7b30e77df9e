"""Per-architecture partition specs for the LM production mesh: the JAX
package's ``launch/mesh_policy.py``, rule for rule.

Layout:
  * batch over ("pod", "data"): DP across pods, plain DP within a pod;
  * parameters and optimizer state sharded over "data" (FSDP / ZeRO-3)
    and over "model" (TP): column-parallel up-projections, row-parallel
    down-projections, expert-parallel MoE stacks, the embedding's feature
    dimension;
  * KV caches: batch over "data", sequence over "model";
  * every ``model`` / ``data`` assignment is guarded by divisibility: a
    dimension that does not divide is whole on that axis.

A ``MeshPolicy`` needs only the mesh's axis names and sizes, so the dry
run plans 256- and 512-rank meshes in one process.  Given a live
``DeviceMesh`` it also turns specs into ``DTensor`` placements
(``shardings``) and drives the sharded steps (``launch/sharded.py``).
Specs are ``models.layers.Spec`` tuples, leaf for leaf the reference's
``PartitionSpec``s.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Dict, Tuple

from repro_torch.models.layers import ShardingPolicy, Spec, placements
from repro_torch.optim.optimizers import OptState

# natural (unstacked) trailing-rank and spec templates per parameter name.
# 'C' = column-parallel last dim, 'R' = row-parallel first-of-two,
# 'E' = expert-stacked 3D, 'V' = vocab-parallel, '-' = replicate.
_RULES = [
    (r"(wq|wk|wv|w_up|w_gate|up_l|up_r|in_proj|w_gates|ffn_up|w_if)/w$", "C"),
    (r"(wo|w_down|down|out_proj|ffn_down)/w$", "R"),
    (r"(wq|wk|wv|wo|w_up|w_gate|w_down|up_l|up_r|in_proj|out_proj|"
     r"w_gates|ffn_up|ffn_down|down|w_if)/b$", "B"),
    (r"router/w$", "Crep"),       # router: small, replicate cols
    (r"router/b$", "-"),
    (r"moe/w_gate$", "E"), (r"moe/w_up$", "E"), (r"moe/w_down$", "Ed"),
    (r"shared/w_gate/w$", "C"), (r"shared/w_up/w$", "C"),
    (r"shared/w_down/w$", "R"), (r"shared_gate/w$", "Crep"),
    (r"conv_w$", "Conv"), (r"conv_b$", "Bc"),
    (r"r_gates$", "-"),
    (r"embed$", "V"), (r"unembed$", "Vt"),
]


def map_specs(fn: Callable, specs, *trees):
    """``fn(spec, *leaves)`` at every ``Spec`` of ``specs``, walking the
    matching leaves of ``trees`` (dicts, lists, ``OptState``s and
    ``None`` as the spec tree has them); the result has ``specs``'
    structure."""
    if specs is None:
        return None
    if isinstance(specs, Spec):
        return fn(specs, *trees)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(t[k] for t in trees))
                for k, v in specs.items()}
    if isinstance(specs, OptState):
        return OptState(*(map_specs(fn, s, *(t[i] for t in trees))
                          for i, s in enumerate(specs)))
    if isinstance(specs, list):
        return [map_specs(fn, s, *(t[i] for t in trees))
                for i, s in enumerate(specs)]
    raise TypeError(f"not a spec tree node: {type(specs).__name__}")


def map_with_path(fn: Callable, tree, path: Tuple[str, ...] = ()):
    """``fn("a/0/b", leaf)`` over a dict / list tree, the path as the
    reference's ``_path_str`` writes ``treemap_with_path``'s keys."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn("/".join(path), tree)


def _map_leaves(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(fn, v) for v in tree]
    return fn(tree)


class MeshPolicy:
    """Factory for partition specs on a mesh.

    ``mesh`` is a live ``DeviceMesh`` or a mapping of axis name to size in
    the mesh's order (``{"data": 16, "model": 16}``).

    Knobs (the reference's but ``serve_mode``, which changes none of its
    specs: it picks the lowering of the reference's cache write):
      no_fsdp     replicate params over ``data`` (DP grad sync remains);
      ep_axis     "model" (baseline) or "data": MoE experts stationary on
                  the data axis, expert FFN TP over model;
      pure_dp     fold the model axis into data parallelism and replicate
                  params.
    """

    def __init__(self, mesh, *, no_fsdp: bool = False,
                 ep_axis: str = "model", pure_dp: bool = False):
        if hasattr(mesh, "mesh_dim_names"):
            self.mesh = mesh
            names = tuple(mesh.mesh_dim_names)
            self.sizes: Dict[str, int] = dict(zip(names, mesh.shape))
        else:
            self.mesh = None
            self.sizes = {str(k): int(v) for k, v in dict(mesh).items()}
            names = tuple(self.sizes)
        self.has_pod = "pod" in names
        self.data_axes: Tuple[str, ...] = (("pod", "data") if self.has_pod
                                           else ("data",))
        self.model_axis = "model" if "model" in names else None
        self.fsdp_axis = ("data" if ("data" in names and not no_fsdp)
                          else None)
        if pure_dp:
            self.data_axes = self.data_axes + (("model",)
                                               if "model" in names else ())
            self.model_axis = None
            self.fsdp_axis = None
        self.ep_axis_name = ep_axis

    # -- helpers ----------------------------------------------------------
    def _fits(self, dim: int, axis) -> bool:
        if axis is None:
            return False
        n = 1
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            n *= self.sizes[a]
        return dim % n == 0

    def _m(self, dim: int):
        return self.model_axis if self._fits(dim, self.model_axis) else None

    def _f(self, dim: int):
        return self.fsdp_axis if self._fits(dim, self.fsdp_axis) else None

    def _b(self, dim: int):
        """Batch axes (largest prefix of data_axes that divides dim)."""
        if self._fits(dim, self.data_axes):
            return self.data_axes
        if self.has_pod and self._fits(dim, ("data",)):
            return ("data",)
        return None

    def activation_policy(self) -> ShardingPolicy:
        return ShardingPolicy(data_axes=self.data_axes,
                              model_axis=self.model_axis,
                              fsdp_axis=self.fsdp_axis, enabled=True,
                              axis_sizes=dict(self.sizes),
                              ep_axis=self.ep_axis_name)

    # -- parameter specs ---------------------------------------------------
    def _leaf_spec(self, path: str, shape: Tuple[int, ...]) -> Spec:
        kind = None
        for pat, k in _RULES:
            if re.search(pat, path):
                kind = k
                break
        nd = len(shape)

        def pad(spec_tail):
            """prepend None for stacked leading dims"""
            return Spec(*([None] * (nd - len(spec_tail)) + list(spec_tail)))

        if kind == "C":
            return pad([self._f(shape[-2]), self._m(shape[-1])])
        if kind == "R":
            return pad([self._m(shape[-2]), self._f(shape[-1])])
        if kind in ("B", "Bc"):
            return pad([self._m(shape[-1])])
        if kind == "Crep":
            return pad([self._f(shape[-2]), None])
        if kind == "E":      # (E, D, F)
            if self.ep_axis_name == "data" and self._fits(shape[-3], "data"):
                return pad(["data", None, self._m(shape[-1])])
            if self._m(shape[-3]):   # baseline: experts over model, FSDP D
                return pad([self._m(shape[-3]), self._f(shape[-2]), None])
            # an expert count that does not divide: the ffn dim over model
            return pad([None, self._f(shape[-2]), self._m(shape[-1])])
        if kind == "Ed":     # (E, F, D)
            if self.ep_axis_name == "data" and self._fits(shape[-3], "data"):
                return pad(["data", self._m(shape[-2]), None])
            if self._m(shape[-3]):
                return pad([self._m(shape[-3]), None, self._f(shape[-2])])
            return pad([None, self._m(shape[-2]), self._f(shape[-1])])
        if kind == "Conv":   # (K, C)
            return pad([None, self._m(shape[-1])])
        if kind == "V":      # (Vpad, D): the feature dim over model
            return Spec(None, self._m(shape[1]))
        if kind == "Vt":     # (D, Vpad): vocab-parallel
            return Spec(None, self._m(shape[1]))
        # default: replicate scalars / vectors; FSDP the last dim of big
        # tensors if possible
        if nd >= 2 and shape[-1] >= 1024 and self._f(shape[-1]):
            return pad([None, self._f(shape[-1])])
        return Spec()

    def param_specs(self, params) -> Any:
        return map_with_path(
            lambda path, leaf: self._leaf_spec(path, tuple(leaf.shape)),
            params)

    def opt_state_specs(self, opt_state, param_specs) -> OptState:
        """Adam moments shard like params; the step counter replicates."""
        mu = param_specs if opt_state.mu is not None else None
        nu = param_specs if opt_state.nu is not None else None
        return OptState(step=Spec(), mu=mu, nu=nu)

    # -- data / cache specs -------------------------------------------------
    def batch_specs(self, batch_shape_tree) -> Any:
        """tokens / labels (B, S) -> Spec(batch_axes, None); frames
        (B, S, D) likewise; scalars (the decode index) whole."""
        def spec(x):
            if len(x.shape) == 0:
                return Spec()
            return Spec(*([self._b(x.shape[0])] + [None] * (len(x.shape)
                                                             - 1)))
        return _map_leaves(spec, batch_shape_tree)

    def kv_cache_spec(self, shape) -> Spec:
        """(L, B, S, H, hd): batch over data, sequence over model."""
        return Spec(None, self._b(shape[1]), self._m(shape[2]), None, None)

    def cache_specs(self, cache_tree) -> Any:
        def spec(x):
            s = tuple(x.shape)
            if len(s) == 5:                     # stacked attention kv
                return self.kv_cache_spec(s)
            if len(s) == 4:                     # (L,B,K-1,C) conv or (B,H,d,d)
                return Spec(None, self._b(s[1]), None, self._m(s[-1]))
            if len(s) == 3:                     # (L?,B,C)
                return Spec(None, self._b(s[1]), None)
            if len(s) == 2:                     # (B, D) slstm state
                return Spec(self._b(s[0]), None)
            return Spec(*([None] * len(s)))
        return _map_leaves(spec, cache_tree)

    def shardings(self, spec_tree, mesh=None):
        """The ``DTensor`` placements of every spec of ``spec_tree`` on
        ``mesh`` (this policy's live mesh by default)."""
        mesh = mesh if mesh is not None else self.mesh
        if mesh is None:
            raise ValueError("shardings needs a live DeviceMesh")
        return map_specs(lambda s: placements(s, mesh.mesh_dim_names),
                         spec_tree)
