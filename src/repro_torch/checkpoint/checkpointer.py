"""Fault-tolerant checkpointing of training state: the JAX package's
``checkpoint/checkpointer.py``, with the same layout on disk.

* atomic: written into ``<dir>/tmp.<step>.*``, ``meta.json`` fsynced, then
  renamed to ``<dir>/step_<n>``; a crash mid-save never corrupts the
  latest checkpoint, and a directory without ``meta.json`` never counts;
* complete training state: params, optimizer state, data cursor, RNG key
  (``meta.json``'s ``rng_key``, the key's two uint32 words as a list),
  step; a resume is bit-identical;
* bounded retention (``keep_last``) and ``latest_step`` for auto-restart;
* storage: one ``.npz`` per tree, its leaves ``leaf_0``, ``leaf_1``, ...
  in the JAX package's flatten order (dict keys sorted, lists and tuples
  in order, an ``OptState`` as ``(step, mu, nu)``, ``None`` no leaf), so a
  checkpoint written by either package loads in the other given a
  ``like`` tree.  The ``.treedef`` file beside it describes the structure
  for a reader; loading never reads it (the ``like`` tree gives it).

Tensors are saved as numpy arrays (bfloat16 ones as float32, which holds
them exactly) and loaded as ``like``'s dtype on ``like``'s device; a
Python int leaf (the port's ``OptState.step``) is saved as int32, as the
reference's step is, and loaded as an int.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import jaxrand


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _flatten(tree) -> List[Any]:
    """The leaves of ``tree`` in the JAX package's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flatten(v)]
    return [tree]


def _unflatten(like, leaves: List[Any]):
    """A tree of ``like``'s structure holding ``leaves`` (in ``_flatten``'s
    order), each converted to its ``like`` leaf's kind."""
    want = len(_flatten(like))
    if want != len(leaves):
        raise ValueError(f"the checkpoint holds {len(leaves)} leaves, the "
                         f"like tree {want}")
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*[build(v) for v in node])
        if isinstance(node, (list, tuple)):
            return type(node)([build(v) for v in node])
        return _from_numpy(next(it), node)
    return build(like)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _from_numpy(arr: np.ndarray, like):
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=like.device,
                                                  dtype=like.dtype)
    if isinstance(like, int):
        return int(arr)
    return np.asarray(arr)


def _structure(tree) -> str:
    """A readable outline of the tree (``*`` for a leaf)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return type(tree).__name__ + "(" + ", ".join(
            f"{f}={_structure(v)}" for f, v in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_structure(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def save_pytree(path: str, tree) -> None:
    arrays = {f"leaf_{i}": _to_numpy(x) for i, x in enumerate(_flatten(tree))}
    np.savez(path, **arrays)
    with open(path + ".treedef", "w") as f:
        f.write(_structure(tree))


def load_pytree(path: str, like) -> Any:
    with np.load(path, allow_pickle=False) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
    return _unflatten(like, leaves)


class Checkpointer:
    def __init__(self, directory: str, keep_last: int = 3):
        self.dir = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def save(self, step: int, params, opt_state, data_step: int,
             rng_key, extra: Optional[Dict] = None) -> str:
        tmp = tempfile.mkdtemp(prefix=f"tmp.{step}.", dir=self.dir)
        try:
            save_pytree(os.path.join(tmp, "params.npz"), params)
            save_pytree(os.path.join(tmp, "opt_state.npz"), opt_state)
            words = (jaxrand.key_to_numpy(rng_key)
                     if isinstance(rng_key, torch.Tensor)
                     else np.asarray(rng_key))
            meta = {"step": step, "data_step": data_step,
                    "rng_key": words.tolist(), "extra": extra or {}}
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            final = self._step_dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)                      # atomic commit
        except Exception:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return self._step_dir(step)

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_last]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.dir):
            m = re.match(r"step_(\d+)$", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "meta.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, params_like, opt_like, step: Optional[int] = None):
        """Returns (params, opt_state, meta) or None if no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        d = self._step_dir(step)
        params = load_pytree(os.path.join(d, "params.npz"), params_like)
        opt_state = load_pytree(os.path.join(d, "opt_state.npz"), opt_like)
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        return params, opt_state, meta
