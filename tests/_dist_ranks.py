"""The port's side of ``tests/test_torch_distributed.py``: what each of 8
gloo ranks runs (``run``, started by ``torch.multiprocessing.spawn``).
It imports no JAX, reads the test's seeded inputs from ``inputs.npz`` and
writes its results to ``rank<r>.npz``: the compressed and exact means,
the GPipe pipeline, ``reshard_to``'s local shards, the 2 x 4 sharded
train steps of a dense and a MoE config (every rank gathers them whole),
the sharded prefill and decode steps, an elastic resume onto 4 ranks
(its parameters and moments gathered whole), and the collective counter
beside each step's plan."""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

WORLD = 8
ARCH = "qwen2.5-14b"
MOE_ARCH = "qwen2-moe-a2.7b"
TRAIN_ARCHS = {"train": ARCH, "moe_train": MOE_ARCH}   # prefix -> arch
COMPRESS_CASES = ("seeded", "tiny", "pow2", "pow2_up", "pow2_down",
                  "q_below", "q_above")
ELASTIC_STEPS = 2            # on 2 x 4, then one more on 4 ranks
PROMPT = 8                   # prefill / decode tokens (B = 4)
CACHE = 16                   # the decode cache's length


def layer_fn(p, x):
    """One pipeline stage (both packages compute it)."""
    return torch.tanh(x @ p["w"] + p["b"])


def tree_from(flat, like):
    from repro_torch.optim.optimizers import tree_leaves, tree_unflatten
    assert len(flat) == len(tree_leaves(like))
    return tree_unflatten(like, [torch.as_tensor(a) for a in flat])


def _whole_tree(m, tree):
    """Every DTensor leaf of ``tree`` gathered whole (a collective: every
    rank of the mesh calls it)."""
    from repro_torch.launch import sharded
    from repro_torch.optim.optimizers import tree_map
    return tree_map(lambda x: sharded.whole(m, x), tree)


def _leaves(tree):
    """The leaves as numpy (bfloat16 widened to float32)."""
    from repro_torch.optim.optimizers import tree_leaves
    return [(x.float() if x.dtype == torch.bfloat16 else x).detach().numpy()
            for x in tree_leaves(tree)]


def _counts(c):
    from repro_torch.launch import analysis
    return np.array([c[k] for k in analysis.COLLECTIVE_OPS + ("total",)])


def run(rank: int, root: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(root, "store"), WORLD),
        rank=rank, world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    try:
        out = _run(rank, root)
        np.savez(os.path.join(root, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def _run(rank: int, root: str) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.base import get_config
    from repro_torch.core import grad_compress as gc
    from repro_torch.launch import (analysis, elastic, mesh as M, pipeline,
                                    sharded, steps)
    from repro_torch.launch.mesh_policy import MeshPolicy
    from repro_torch.models import lm as LM

    inp = np.load(os.path.join(root, "inputs.npz"))
    out = {}

    # -- the compressed and exact means over the 8 ranks -------------------
    for c in COMPRESS_CASES:
        g = torch.from_numpy(inp[f"g/{c}"][rank])
        r = torch.from_numpy(inp[f"r/{c}"][rank])
        mean, resid = gc.compressed_allreduce_mean(g, r)
        out[f"cm/{c}"], out[f"cr/{c}"] = mean.numpy(), resid.numpy()
        out[f"ce/{c}"] = gc.exact_allreduce_mean(g).numpy()

    # -- GPipe: 4 stages x 4 microbatches, twice over ("data") -------------
    pmesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "pipe"))
    run_pipe = pipeline.pipeline_apply(layer_fn, pmesh, 4, axis="pipe")
    with analysis.count_collectives() as cc:
        out["pipe"] = run_pipe(
            {"w": torch.from_numpy(inp["pipe_w"]),
             "b": torch.from_numpy(inp["pipe_b"])},
            torch.from_numpy(inp["pipe_x"])).numpy()
    out["pipe_counts"] = _counts(cc)

    # -- the reduced LM on the 2 x 4 mesh -----------------------------------
    cfg = get_config(ARCH).reduced()
    like = steps.abstract_params(cfg)
    n_leaves = int(inp["train_n_leaves"])
    params = tree_from([inp[f"train_init/{i}"] for i in range(n_leaves)],
                       like)
    mesh = M.make_debug_mesh(2, 4, device="cpu")
    m = sharded.MeshView(mesh)
    policy = MeshPolicy(mesh)
    pspecs = policy.param_specs(params)
    dparams = elastic.reshard_to(mesh, params, pspecs)
    for i, x in enumerate(_leaves_dt(dparams)):
        out[f"shard/{i}"] = x

    opt = steps.make_optimizer(cfg)
    tokens = torch.from_numpy(inp["tokens"]).long()
    batch = {"tokens": tokens, "labels": tokens}
    step = steps.make_train_step(cfg, opt, policy=policy)
    for tag, arch in TRAIN_ARCHS.items():
        tcfg = get_config(arch).reduced()
        tlike = steps.abstract_params(tcfg)
        flat = [inp[f"{tag}_init/{i}"]
                for i in range(int(inp[f"{tag}_n_leaves"]))]
        tp = elastic.reshard_to(mesh, tree_from(flat, tlike),
                                policy.param_specs(tlike))
        topt = steps.make_optimizer(tcfg)
        with analysis.count_collectives() as cc:
            p2, o2, met = steps.make_train_step(tcfg, topt, policy=policy)(
                tp, topt.init(tp), batch)
        out[f"{tag}_counts"] = _counts(cc)
        out[f"{tag}_plan"] = _counts(sharded.train_plan(policy, tcfg, tlike,
                                                        batch))
        out[f"{tag}_metrics"] = np.array([float(met["loss"]),
                                          float(met["total"])])
        _put_state(out, tag, m, p2, o2)

    # -- sharded prefill and decode -----------------------------------------
    prompt = torch.from_numpy(inp["prompt"]).long()
    prefill = steps.make_prefill_step(cfg, policy=policy)
    with analysis.count_collectives() as cc:
        logits, caches = prefill(dparams, {"tokens": prompt})
    out["serve_prefill_counts"] = _counts(cc)
    out["serve_prefill_plan"] = _counts(sharded.prefill_plan(
        policy, cfg, like, {"tokens": prompt}))
    out["serve_prefill"] = logits.float().numpy()
    for i, x in enumerate(_leaves(_whole_tree(m, caches))):
        out[f"serve_prefill_cache/{i}"] = x
    empty = LM.init_cache(cfg, prompt.shape[0], CACHE, device="cpu")
    cache = elastic.reshard_to(mesh, empty, policy.cache_specs(empty))
    decode = steps.make_decode_step(cfg, policy=policy)
    dl = []
    for t in range(PROMPT):
        b = {"tokens": prompt[:, t:t + 1], "index": torch.tensor(t)}
        with analysis.count_collectives() as cc:
            lg, cache = decode(dparams, cache, b)
        dl.append(lg.float().numpy())
    out["serve_decode_counts"] = _counts(cc)
    out["serve_decode_plan"] = _counts(sharded.decode_plan(
        policy, cfg, like, LM.init_cache(cfg, prompt.shape[0], CACHE,
                                         device="meta"), b))
    out["serve_decode"] = np.stack(dl)
    for i, x in enumerate(_leaves(_whole_tree(m, cache))):
        out[f"serve_decode_cache/{i}"] = x

    # -- elastic: 2 steps on 2 x 4, a checkpoint, 1 more on 4 ranks --------
    ckpt = Checkpointer(os.path.join(root, "ckpt"))
    p, o = dparams, opt.init(dparams)
    losses = []
    for k in range(ELASTIC_STEPS):
        t = torch.from_numpy(inp[f"elastic_tokens/{k}"]).long()
        p, o, met = step(p, o, {"tokens": t, "labels": t})
        losses.append(float(met["loss"]))
    whole_p = _whole_tree(m, p)
    whole_o = type(o)(o.step, _whole_tree(m, o.mu), _whole_tree(m, o.nu))
    if rank == 0:
        ckpt.save(ELASTIC_STEPS, whole_p, whole_o,
                  data_step=ELASTIC_STEPS, rng_key=np.zeros(2, np.uint32))
    dist.barrier()
    small = elastic.remesh(range(4), model_parallel_target=2)
    if rank < 4:
        pol4 = MeshPolicy(small)
        rp, ro, _ = ckpt.restore(params, opt.init(params))
        sp4 = pol4.param_specs(rp)
        p4 = elastic.reshard_to(small, rp, sp4)
        o4 = elastic.reshard_to(small, ro, pol4.opt_state_specs(ro, sp4))
        t = torch.from_numpy(inp[f"elastic_tokens/{ELASTIC_STEPS}"]).long()
        p4, o4, met = steps.make_train_step(cfg, opt, policy=pol4)(
            p4, o4, {"tokens": t, "labels": t})
        losses.append(float(met["loss"]))
        out["elastic_mesh"] = np.array(small.shape)
        out["elastic_metrics"] = np.array([float(met["loss"]),
                                           float(met["total"])])
        _put_state(out, "elastic", sharded.MeshView(small), p4, o4)
    out["elastic_losses"] = np.array(losses)
    return out


def _put_state(out: dict, tag: str, m, params, opt_state) -> None:
    """A sharded step's parameters and Adam state, gathered whole over
    ``m`` (every rank of it calls this), into ``out`` under ``tag``."""
    for name, tree in (("params", params), ("mu", opt_state.mu),
                       ("nu", opt_state.nu)):
        for i, x in enumerate(_leaves(_whole_tree(m, tree))):
            out[f"{tag}_{name}/{i}"] = x
    out[f"{tag}_step"] = np.array(opt_state.step)


def _leaves_dt(tree):
    """The local shards of a DTensor tree, as numpy."""
    from repro_torch.optim.optimizers import tree_leaves
    return [x.to_local().numpy() for x in tree_leaves(tree)]
