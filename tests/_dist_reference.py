"""The JAX package's side of ``tests/test_torch_distributed.py``, run as
``python tests/_dist_reference.py DIR`` in a process of its own with 8
host devices (``--xla_force_host_platform_device_count=8``), on meshes of
Auto axes (``jax.sharding.Mesh``; jax 0.9's ``jax.make_mesh`` gives
Explicit axes, which the reference's ``with_sharding_constraint`` refuses).
It reads the test's seeded inputs from ``DIR/inputs.npz`` and writes
``DIR/reference.npz``: the compressed and exact means under
``shard_map``, the GPipe pipeline, the 2 x 4 mesh's addressable shards of
the reduced qwen2.5-14b's parameters, the sharded train step of each
config the inputs name (``<tag>_arch``: the reduced qwen2.5-14b and
qwen2-moe-a2.7b; the MoE's one-process step too), and the dry run's argument bytes on the reduced
qwen2.5-14b's tiny cell."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh, PartitionSpec as P


def main(root: str) -> None:
    devices = jax.devices()
    assert len(devices) == 8, devices
    from repro.configs.base import get_config
    from repro.core.grad_compress import (compressed_allreduce_mean,
                                          exact_allreduce_mean)
    from repro.launch import steps
    from repro.launch.mesh_policy import MeshPolicy
    from repro.launch.pipeline import pipeline_apply

    inp = np.load(os.path.join(root, "inputs.npz"))
    out = {}

    dp = Mesh(np.array(devices), ("dp",))

    def both(g, r):
        m, res = compressed_allreduce_mean(g[0], r[0], "dp")
        return m[None], res[None], exact_allreduce_mean(g[0], "dp")[None]
    run = jax.jit(shard_map(both, mesh=dp, in_specs=(P("dp"), P("dp")),
                            out_specs=(P("dp"), P("dp"), P("dp"))))
    for c in [k[2:] for k in inp.files if k.startswith("g/")]:
        m, res, e = run(inp[f"g/{c}"], inp[f"r/{c}"])
        out[f"cm/{c}"], out[f"cr/{c}"] = np.asarray(m), np.asarray(res)
        out[f"ce/{c}"] = np.asarray(e)

    pipe = Mesh(np.array(devices[:4]), ("pipe",))
    fn = pipeline_apply(lambda p, x: jnp.tanh(x @ p["w"] + p["b"]), pipe, 4)
    out["pipe"] = np.asarray(jax.jit(fn)(
        {"w": inp["pipe_w"], "b": inp["pipe_b"]}, inp["pipe_x"]))

    mesh = Mesh(np.array(devices).reshape(2, 4), ("data", "model"))
    mp = MeshPolicy(mesh)
    tokens = jnp.asarray(inp["tokens"])
    for tag in [k[:-len("_arch")] for k in inp.files
                if k.endswith("_arch")]:
        cfg = get_config(str(inp[f"{tag}_arch"])).reduced()
        like = steps.abstract_params(cfg)
        leaves = [jnp.asarray(inp[f"{tag}_init/{i}"])
                  for i in range(int(inp[f"{tag}_n_leaves"]))]
        params = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(like), leaves)
        with mesh:
            pspecs = mp.param_specs(params)
            placed = jax.device_put(params, mp.shardings(pspecs))
            if tag == "train":
                for i, leaf in enumerate(jax.tree_util.tree_leaves(placed)):
                    for s in leaf.addressable_shards:
                        out[f"shard/{i}/{s.device.id}"] = np.asarray(s.data)
            opt = steps.make_optimizer(cfg)
            opt_state = opt.init(params)
            step = jax.jit(
                steps.make_train_step(cfg, mp.activation_policy(), opt),
                in_shardings=(mp.shardings(pspecs),
                              mp.shardings(mp.opt_state_specs(opt_state,
                                                              pspecs)),
                              None))
            p2, o2, met = step(params, opt_state,
                               {"tokens": tokens, "labels": tokens})
        out[f"{tag}_metrics"] = np.array([float(met["loss"]),
                                          float(met["total"])])
        for name, tree in (("params", p2), ("mu", o2.mu), ("nu", o2.nu)):
            for i, x in enumerate(jax.tree_util.tree_leaves(tree)):
                out[f"{tag}_{name}/{i}"] = np.asarray(x)
        out[f"{tag}_step"] = np.asarray(o2.step)
        if cfg.family == "moe":
            # the one-process step too: the reference's sharded MoE step
            # routes some tokens otherwise (its router's product is
            # partitioned on the mesh), so it is not its own plain step
            p2, o2, met = jax.jit(steps.make_train_step(cfg, optimizer=opt))(
                params, opt.init(params), {"tokens": tokens,
                                           "labels": tokens})
            out[f"{tag}_plain_metrics"] = np.array([float(met["loss"]),
                                                    float(met["total"])])
            for name, tree in (("params", p2), ("mu", o2.mu),
                               ("nu", o2.nu)):
                for i, x in enumerate(jax.tree_util.tree_leaves(tree)):
                    out[f"{tag}_plain_{name}/{i}"] = np.asarray(x)
            out[f"{tag}_plain_step"] = np.asarray(o2.step)
    cfg = get_config("qwen2.5-14b").reduced()

    # the dry run on the reduced config's tiny cell, as the reference's
    # own test patches it, on an Auto-axes 2 x 4 mesh of the 8 devices
    import repro.configs.base as base
    import repro.configs.qwen2_5_14b as q
    import repro.launch.dryrun as dr
    import repro.launch.mesh as mesh_mod
    mesh_mod.make_production_mesh = lambda multi_pod=False: mesh
    base.SHAPES["tiny_train"] = dict(seq_len=64, global_batch=4,
                                     kind="train")
    q.CONFIG = cfg
    rec = dr.run_cell("qwen2.5-14b", "tiny_train", False)
    out["dry_args"] = np.array(rec["memory_analysis"]["argument_bytes"])
    np.savez(os.path.join(root, "reference.npz"), **out)


if __name__ == "__main__":
    main(sys.argv[1])
