"""Multi-pod dry run: the JAX package's ``launch/dryrun.py`` without a
compiler.

For every (architecture x input shape) cell, lay the cell's parameters,
optimizer state, batch and caches out on the production mesh (16 x 16,
and 2 x 16 x 16 with a pod axis) by ``MeshPolicy``'s specs, and prove the
layout coherent: every sharded dimension divides its axes and every
leaf's local shape resolves.  Nothing is allocated (meta tensors) and no
process group is needed, so one process plans 256 and 512 ranks.

Each record keeps the reference's keys: ``memory_analysis``'s
``argument_bytes`` and ``output_bytes`` are one rank's shard bytes,
summed exactly; ``temp_bytes``, ``peak_bytes`` and ``cost_analysis_flops``
have no counterpart without a compiler and are ``null``.  The port adds
``memory_analysis.step_floor_bytes``, a lower bound of a rank's peak in
the sharded step (``launch/sharded.py`` gathers every parameter whole,
and to train the float32 gradients whole too): the arguments, with the
parameters' shards in the step's stored dtype (float32 to train,
bfloat16 with float32 norm scales to serve), plus the whole parameters
in that dtype plus, to train, the whole gradients, activations not
counted; ``fits_card`` says whether that floor is within one card's
memory (``analysis.HBM_BYTES``).  A cell that does not fit is still
``ok``: its layout is coherent, and the step that would run it is what
falls short.  ``collectives``
are the per-rank bytes of the collectives the port's sharded step would
issue (``sharded.*_plan``); the roofline uses the card's constants
(``analysis``).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-14b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all \\
      --both-meshes --out r.json
"""

from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from typing import Dict, List, Optional

from repro_torch.launch import analysis, sharded
from repro_torch.launch.mesh import PRODUCTION, PRODUCTION_MULTI_POD
from repro_torch.launch.mesh_policy import MeshPolicy, map_specs
from repro_torch.optim.optimizers import tree_leaves


def should_skip(cfg, shape_name: str) -> Optional[str]:
    if shape_name == "long_500k" and not cfg.supports_long_context:
        return ("long_500k requires sub-quadratic attention; "
                f"{cfg.name} is full-attention (DESIGN.md §6)")
    return None


def production_axes(multi_pod: bool) -> Dict[str, int]:
    """The production mesh's axis sizes, in mesh order."""
    shape, names = PRODUCTION_MULTI_POD if multi_pod else PRODUCTION
    return dict(zip(names, shape))


def _shard_sum(mp: MeshPolicy, specs, tree) -> int:
    """One rank's bytes of every tensor leaf of ``tree`` at ``specs`` (the
    optimizer's int step counts as the reference's int32 scalar)."""
    out: List[int] = []

    def add(spec, x):
        if isinstance(x, int):
            out.append(4)
        else:
            out.append(sharded.shard_bytes(x.shape, x.element_size(), spec,
                                           mp.sizes))
    map_specs(add, specs, tree)
    return sum(out)


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> Dict:
    """Plan one cell; return the reference's dry-run / roofline record."""
    from repro_torch.configs.base import SHAPES, get_config
    from repro_torch.launch.steps import (abstract_params, cache_specs,
                                          init_params_for, input_specs,
                                          make_optimizer)

    cfg = get_config(arch)
    skip = should_skip(cfg, shape_name)
    if skip:
        return {"arch": arch, "shape": shape_name, "status": "skip",
                "reason": skip}

    kind = SHAPES[shape_name]["kind"]
    mp = MeshPolicy(production_axes(multi_pod))
    t0 = time.time()
    batch = input_specs(cfg, shape_name)
    params = abstract_params(cfg)
    pspecs = mp.param_specs(params)
    bspecs = mp.batch_specs(batch)
    p_bytes = _shard_sum(mp, pspecs, params)
    # what a rank of the sharded step holds on top of its shards
    stored = params if kind == "train" else init_params_for(cfg,
                                                            device="meta")
    whole = (_shard_sum(mp, pspecs, stored) - p_bytes
             + sum(x.numel() * x.element_size() for x in tree_leaves(stored)))
    b_bytes = _shard_sum(mp, bspecs, batch)
    if kind == "train":
        opt_state = make_optimizer(cfg).init(params)       # meta tensors
        o_bytes = _shard_sum(mp, mp.opt_state_specs(opt_state, pspecs),
                             opt_state)
        args = p_bytes + o_bytes + b_bytes
        outs = p_bytes + o_bytes + 2 * 4                    # + the metrics
        coll = sharded.train_plan(mp, cfg, params, batch)
        whole += sum(x.numel() * 4 for x in tree_leaves(params))  # grads
    elif kind == "prefill":
        b, s = batch["tokens"].shape
        if cfg.family == "vlm":
            s += cfg.frontend_len
        caches = sharded.global_caches(cfg, b, s)
        c_bytes = _shard_sum(mp, mp.cache_specs(caches), caches)
        args = p_bytes + b_bytes
        outs = math.prod(sharded.logits_shape(cfg, b)) * 2 + c_bytes
        if cfg.family == "encdec":                          # the memory
            outs += batch["frames"].numel() * batch["frames"].element_size()
        coll = sharded.prefill_plan(mp, cfg, params, batch)
    else:  # decode
        caches = cache_specs(cfg, shape_name)
        c_bytes = _shard_sum(mp, mp.cache_specs(caches), caches)
        args = p_bytes + c_bytes + b_bytes
        outs = (math.prod(sharded.logits_shape(
            cfg, batch["tokens"].shape[0])) * 2 + c_bytes)
        coll = sharded.decode_plan(mp, cfg, params, caches, batch)
    t_plan = time.time() - t0

    chips = math.prod(mp.sizes.values())
    roof = analysis.build_roofline(cfg, shape_name, chips=chips,
                                   collectives=coll)
    return {
        "arch": arch, "shape": shape_name, "status": "ok",
        "multi_pod": multi_pod, "chips": chips,
        "lower_s": round(t_plan, 1), "compile_s": 0.0,
        "memory_analysis": {"argument_bytes": args, "output_bytes": outs,
                            "temp_bytes": None, "peak_bytes": None,
                            "step_floor_bytes": args + whole},
        "fits_card": args + whole <= analysis.HBM_BYTES,
        "cost_analysis_flops": None,
        "collectives": dict(coll),
        "roofline": roof.as_dict(),
    }


def run_all(archs, shapes, meshes, log=print) -> List[Dict]:
    """Every cell of ``archs`` x ``shapes`` x ``meshes`` (multi-pod
    flags); a cell that raises is an ``error`` record."""
    results = []
    for arch in archs:
        for shape in shapes:
            for mp_flag in meshes:
                tag = f"{arch} x {shape} ({'2x16x16' if mp_flag else '16x16'})"
                try:
                    rec = run_cell(arch, shape, mp_flag)
                    extra = ""
                    if rec["status"] == "ok":
                        r = rec["roofline"]
                        extra = (f" dominant={r['dominant']}"
                                 f" frac={r['roofline_fraction']:.3f}"
                                 + ("" if rec["fits_card"] else
                                    " (over one card's memory)"))
                    log(f"[dryrun] {tag}: {rec['status']}{extra}")
                except Exception as e:
                    rec = {"arch": arch, "shape": shape,
                           "multi_pod": mp_flag, "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-2000:]}
                    log(f"[dryrun] {tag}: ERROR {type(e).__name__}: {e}")
                results.append(rec)
    return results


def main(argv=None) -> None:
    from repro_torch.configs.base import ARCH_IDS, SHAPES

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = run_all(archs, shapes, meshes,
                      log=lambda s: print(s, flush=True))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    ok = sum(1 for r in results if r["status"] == "ok")
    skip = sum(1 for r in results if r["status"] == "skip")
    err = sum(1 for r in results if r["status"] == "error")
    over = sum(1 for r in results if r["status"] == "ok"
               and not r["fits_card"])
    print(f"[dryrun] done: {ok} ok ({over} over one card's memory), "
          f"{skip} skip, {err} error")
    if err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
