"""The port's launch planning against the JAX package's, in one process
with no ranks: ``MeshPolicy``'s specs, ``best_mesh_shape``, the analytic
FLOPs and bytes, the roofline, the dry run's argument bytes, XLA's
``_pow2_scale`` in ``core/grad_compress.py``, and the world-1 pieces of
``launch/mesh.py`` and ``ShardingPolicy``.

The reference's ``MeshPolicy`` reads only a mesh's ``axis_names`` and
``devices.shape``, so it gets a stand-in with ``np.empty(shape)`` devices;
the port's takes the axis sizes.  Specs are compared leaf for leaf as
tuples, every architecture at full width, on the 16 x 16, 2 x 16 x 16,
2 x 4 and 1 x 1 meshes, under each knob.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import functools
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import get_config as jget
from repro.core import grad_compress as jgc
from repro.launch import analysis as janalysis
from repro.launch import elastic as jelastic
from repro.launch import steps as jsteps
from repro.launch.mesh_policy import MeshPolicy as JMeshPolicy
from repro_torch.configs.base import SHAPES, get_config
from repro_torch.core import grad_compress as gc
from repro_torch.launch import analysis, dryrun, elastic, mesh, steps
from repro_torch.launch.mesh_policy import MeshPolicy
from repro_torch.models import layers as L
from repro_torch.optim.optimizers import tree_leaves

MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")),
          ((1, 1), ("data", "model"))]
KNOBS = [{}, {"no_fsdp": True}, {"ep_axis": "data"}, {"serve_mode": True},
         {"pure_dp": True}]
DECODE = [s for s, v in SHAPES.items() if v["kind"] == "decode"]
TPU = dict(peak_flops=janalysis.PEAK_FLOPS, hbm_bw=janalysis.HBM_BW,
           link_bw=janalysis.ICI_BW)


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """Both packages' abstract parameters, inputs and decode caches."""
    jcfg, cfg = jget(arch), get_config(arch)
    return dict(
        jparams=jsteps.abstract_params(jcfg),
        params=steps.abstract_params(cfg),
        jopt=jsteps.abstract_opt_state(jcfg),
        opt=steps.abstract_opt_state(cfg),
        jbatch={s: jsteps.input_specs(jcfg, s) for s in JSHAPES},
        batch={s: steps.input_specs(cfg, s) for s in SHAPES},
        jcache={s: jsteps.cache_specs(jcfg, s) for s in DECODE},
        cache={s: steps.cache_specs(cfg, s) for s in DECODE})


@pytest.fixture
def cached_params(monkeypatch):
    """Both packages' ``abstract_params`` memoized for the test (the
    analytic counts draw them anew on every call)."""
    for mod in (jsteps, steps):
        monkeypatch.setattr(mod, "abstract_params", functools.lru_cache(
            maxsize=None)(mod.abstract_params))


def _jleaves(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _same(jspecs, specs):
    want = [tuple(s) for s in _jleaves(jspecs)]
    got = [tuple(s) for s in tree_leaves(specs)]
    assert got == want


def _policies(shape, names, knobs):
    """The reference's policy under ``knobs`` and the port's.  The port
    has no ``serve_mode``: the reference's changes only its cache-write
    lowering, so its specs under ``serve_mode`` are the port's default
    ones."""
    stand_in = types.SimpleNamespace(axis_names=names,
                                     devices=np.empty(shape))
    port = {k: v for k, v in knobs.items() if k != "serve_mode"}
    return (JMeshPolicy(stand_in, **knobs),
            MeshPolicy(dict(zip(names, shape)), **port))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_reference_leaf_for_leaf(arch):
    t = _trees(arch)
    assert [x.shape for x in jax.tree_util.tree_leaves(t["jparams"])] == [
        tuple(x.shape) for x in tree_leaves(t["params"])]
    for shape, names in MESHES:
        for knobs in KNOBS:
            jmp, mp = _policies(shape, names, knobs)
            jp, pp = jmp.param_specs(t["jparams"]), mp.param_specs(
                t["params"])
            _same(jp, pp)
            jo = jmp.opt_state_specs(t["jopt"], jp)
            po = mp.opt_state_specs(t["opt"], pp)
            assert tuple(po.step) == tuple(jo.step)
            _same(jo.mu, po.mu)
            _same(jo.nu, po.nu)
            for s in SHAPES:
                _same(jmp.batch_specs(t["jbatch"][s]),
                      mp.batch_specs(t["batch"][s]))
            for s in DECODE:
                _same(jmp.cache_specs(t["jcache"][s]),
                      mp.cache_specs(t["cache"][s]))
            ap = mp.activation_policy()
            jap = jmp.activation_policy()
            for f in ("data_axes", "model_axis", "fsdp_axis", "enabled",
                      "ep_axis"):
                assert getattr(ap, f) == getattr(jap, f), f
            assert ap.axis_sizes == {k: int(v)
                                     for k, v in jap.axis_sizes.items()}


def test_best_mesh_shape_equals_the_reference():
    for n in range(1, 601):
        for target in range(1, 33):
            assert elastic.best_mesh_shape(n, target) == \
                jelastic.best_mesh_shape(n, target)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_counts_equal_the_reference(arch, cached_params):
    jcfg, cfg = jget(arch), get_config(arch)
    assert analysis.param_counts(cfg) == janalysis.param_counts(jcfg)
    for s in SHAPES:
        assert analysis.analytic_flops(cfg, s) == \
            janalysis.analytic_flops(jcfg, s)
        assert analysis.analytic_bytes(cfg, s) == \
            janalysis.analytic_bytes(jcfg, s)
        want = janalysis.build_roofline(jcfg, s, 256, hlo_text="",
                                        cost_flops=1.5e15,
                                        bytes_per_device=3e9).as_dict()
        got = analysis.build_roofline(
            cfg, s, 256, analysis.zero_collectives(), cost_flops=1.5e15,
            bytes_per_device=3e9, **TPU).as_dict()
        assert got.pop("peak_flops") == janalysis.PEAK_FLOPS
        assert got == want


def _ref_shard_sum(jmp, specs, tree):
    sizes = dict(zip(jmp.mesh.axis_names, jmp.mesh.devices.shape))
    total = 0
    for spec, leaf in zip(_jleaves(specs), jax.tree_util.tree_leaves(tree)):
        n = 1
        for e in spec:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                n *= sizes[a]
        total += math.prod(leaf.shape) * leaf.dtype.itemsize // n
    return total


@pytest.mark.parametrize("arch,shape,multi_pod", [
    ("qwen2.5-14b", "train_4k", False),
    ("qwen3-moe-30b-a3b", "decode_32k", True),
    ("zamba2-1.2b", "prefill_32k", False),
    ("xlstm-125m", "long_500k", True)])
def test_dryrun_argument_bytes_equal_the_reference_shard_sum(
        arch, shape, multi_pod, cached_params):
    rec = dryrun.run_cell(arch, shape, multi_pod)
    assert rec["status"] == "ok"
    dims = ((2, 16, 16), ("pod", "data", "model")) if multi_pod else (
        (16, 16), ("data", "model"))
    jmp, _ = _policies(*dims, {})
    t = _trees(arch)
    pspecs = jmp.param_specs(t["jparams"])
    want = _ref_shard_sum(jmp, pspecs, t["jparams"]) + _ref_shard_sum(
        jmp, jmp.batch_specs(t["jbatch"][shape]), t["jbatch"][shape])
    kind = SHAPES[shape]["kind"]
    if kind == "train":
        want += _ref_shard_sum(jmp, jmp.opt_state_specs(t["jopt"], pspecs),
                               t["jopt"])
    if kind == "decode":
        want += _ref_shard_sum(jmp, jmp.cache_specs(t["jcache"][shape]),
                               t["jcache"][shape])
    ma = rec["memory_analysis"]
    assert ma["argument_bytes"] == want
    assert ma["temp_bytes"] is ma["peak_bytes"] is None
    # the sharded step's floor: the whole parameters as the step stores
    # them (float32 to train, the port's serving dtypes to serve), and to
    # train the whole float32 gradients, on top of the shards
    jp = t["jparams"]
    if kind == "train":
        whole = 2 * sum(math.prod(x.shape) * 4
                        for x in jax.tree_util.tree_leaves(jp))
    else:
        served = steps.init_params_for(get_config(arch), device="meta")
        whole = (_ref_shard_sum(jmp, pspecs, served) - _ref_shard_sum(
            jmp, pspecs, jp) + sum(x.numel() * x.element_size()
                                   for x in tree_leaves(served)))
    assert ma["step_floor_bytes"] == want + whole
    assert rec["fits_card"] == (want + whole <= 80 * 2 ** 30)
    assert rec["cost_analysis_flops"] is None
    assert rec["roofline"]["chips"] == (512 if multi_pod else 256)
    assert rec["collectives"]["total"] == sum(
        rec["collectives"][k] for k in analysis.COLLECTIVE_OPS) > 0


def test_dryrun_plans_every_cell_on_both_meshes(cached_params, capsys):
    dryrun.main(["--both-meshes"])
    lines = capsys.readouterr().out.splitlines()
    # every train_4k cell but the small models', and mistral-large-123b's
    # serving cells, need more than one card's memory in the sharded step
    assert lines[-1] == ("[dryrun] done: 64 ok (16 over one card's "
                         "memory), 16 skip, 0 error")


def test_pow2_scale_is_xlas_on_every_exponent_and_boundary():
    """``_pow2_scale`` against the reference's jitted one: every
    power-of-two boundary of ``127 / max_abs`` and an ulp either side,
    2**18 seeded magnitudes over the float32 range, the smallest normals
    and the subnormals, and zero."""
    f32 = np.float32
    rng = np.random.default_rng(3)
    edges = (f32(127) * f32(2) ** np.arange(-126, 121, dtype=f32)).astype(
        f32)
    x = np.concatenate([
        edges, np.abs(rng.standard_normal(1 << 18)).astype(f32)
        * f32(10) ** rng.integers(-37, 38, 1 << 18).astype(f32),
        np.geomspace(1e-38, 1e-36, 4096).astype(f32),
        np.array([0, 1e-45, 3e-39, 3e38], f32)])
    x = x[np.isfinite(x)]
    x = np.concatenate([x, np.nextafter(x, f32(np.inf)),
                        np.nextafter(x, f32(0))]).astype(f32)
    want = np.asarray(jax.jit(jax.vmap(jgc._pow2_scale))(x))
    got = gc._pow2_scale(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # most scales are not powers of two: XLA's exp of s * float32(ln 2)
    assert (np.frexp(want)[0] != 0.5).mean() > 0.5


def test_quantize_and_dequantize_equal_the_reference():
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(4096) * 3).astype(np.float32)
    x[:8] = [0.5, 1.5, -0.5, -2.5, 127.4, 200, -300, 0]
    for s in (np.float32(1.0), np.float32(0.75), np.float32(42.000004)):
        q = gc.quantize_int8(torch.from_numpy(x), torch.tensor(s))
        jq = np.asarray(jgc.quantize_int8(jnp.asarray(x), s))
        np.testing.assert_array_equal(q.numpy(), jq)
        np.testing.assert_array_equal(
            gc.dequantize_int8(q, torch.tensor(s)).numpy(),
            np.asarray(jgc.dequantize_int8(jnp.asarray(jq), s)))


def test_spec_normalizes_as_partition_spec():
    P = jax.sharding.PartitionSpec
    for entries in [(("data",), None), (("pod", "data"), "model"), (),
                    (None, None, "model")]:
        assert tuple(L.Spec(*entries)) == tuple(P(*entries))
    s = L.Spec(("pod", "data"), None, "model")
    assert s.axes(0) == ("pod", "data") and s.axes(1) == () and \
        s.axes(2) == ("model",) and s.axes(5) == ()


def test_sharding_policy_helpers_are_the_identity_on_plain_tensors():
    jmp, mp = _policies((2, 4), ("data", "model"), {})
    pol = mp.activation_policy()
    x = torch.zeros(2, 3, 8, 5)
    for f in ("btd", "btf", "bthd", "btv", "bt_seq_sharded"):
        assert getattr(pol, f)(x) is x
    assert L.NO_SHARDING.btd(x) is x and L.NO_SHARDING.size("model") == 1
    assert pol.size("model") == 4 and pol.size(("data", "model")) == 8


@pytest.fixture
def world_of_one():
    """A gloo process group of one rank (``mesh.init_distributed``),
    destroyed after the test."""
    import torch.distributed as dist
    mesh.init_distributed(device="cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_meshes_and_policies_on_a_world_of_one(world_of_one):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    m = mesh.make_debug_mesh(1, 1, device="cpu")
    assert m.mesh_dim_names == ("data", "model") and m.shape == (1, 1)
    with pytest.raises(ValueError, match=r"\(16, 16\) mesh needs 256 ranks;"
                       r" the process group has 1"):
        mesh.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks"):
        mesh.make_production_mesh(multi_pod=True, device="cpu")
    mp = MeshPolicy(m)
    assert mp.sizes == {"data": 1, "model": 1} and mp.mesh is m
    x = torch.arange(24.0).reshape(2, 3, 4)
    spec = L.Spec("data", None, "model")
    d = elastic.reshard_to(m, {"x": x}, {"x": spec})["x"]
    assert isinstance(d, DTensor)
    assert list(d.placements) == [Shard(0), Shard(2)]
    assert torch.equal(d.to_local(), x)
    pol = mp.activation_policy()
    y = pol.btd(d)
    assert isinstance(y, DTensor) and list(y.placements) == [Shard(0),
                                                             Replicate()]
    assert torch.equal(y.full_tensor(), x)
    assert mp.shardings({"a": spec, "b": [L.Spec()]}) == {
        "a": [Shard(0), Shard(2)], "b": [[Replicate(), Replicate()]]}
    with pytest.raises(ValueError, match="mesh's order"):
        L.placements(L.Spec(("model", "data")), m.mesh_dim_names)


def test_init_distributed_follows_the_device_rule(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.init_distributed()
    with pytest.raises(RuntimeError, match="init_distributed first"):
        mesh.make_debug_mesh(1, 1, device="cpu")
