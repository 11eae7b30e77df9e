"""The port's launch code on ``torch.distributed`` against the JAX
package's, on the CPU: 8 gloo ranks (``tests/_dist_ranks.py``, one
``spawn``) against the reference's functions on 8 host devices
(``tests/_dist_reference.py``, one subprocess), both on the same seeded
inputs, run once for the module and side by side.

The reference runs on meshes of Auto axes (``jax.sharding.Mesh``): jax
0.9's ``jax.make_mesh`` gives Explicit axes, on which the reference's
``with_sharding_constraint`` raises, and the reference's own
``tests/test_distribution.py`` fails for that reason (and, for the
compressed all-reduce, in its own ``mean[0:1]`` indexing afterwards), not
for its functions.

Held here:
- ``compressed_allreduce_mean``'s mean and residual bit for bit on every
  rank, on seeded inputs and where ``127 / max_abs`` is a power of two, an
  ulp either side of one, or ``max_abs`` an ulp off such a value (the
  scale is XLA's ``log`` and ``exp``, ``core/grad_compress.py``);
  ``exact_allreduce_mean`` within 2 float32 ulps of the largest input
  (gloo's sum order);
- ``pipeline_apply`` (4 stages, 4 microbatches) bit for bit against the
  port's stages applied in sequence, and within 1e-6 relative of the
  reference's pipeline (XLA's ``tanh`` is not torch's);
- ``reshard_to``'s local shards bit for bit against the reference's
  ``addressable_shards`` on the 2 x 4 mesh;
- the 2 x 4 sharded train steps of the reduced qwen2.5-14b and
  qwen2-moe-a2.7b (tokens (4, 32)) against the reference's on the same
  parameters, within the LM training tolerances of
  ``tests/_lm_train_cases.py``, and the port's single-process steps
  against the same: the dense config against the reference's sharded
  step; the MoE against the reference's one-process step, its
  load-balancing loss (the global batch's router means) within
  ``AUX_RTOL``, and against the reference's sharded step within the gap
  between that step and the reference's own one-process step;
- the sharded prefill and 8 decode steps within ``crosscheck.LM_ULPS`` of
  the single-process steps;
- an elastic resume (2 steps on 2 x 4, a checkpoint, ``remesh`` to 4
  ranks as 2 x 2, 1 more step) against 3 unsharded steps: the losses
  within rtol 5e-4, and the parameters and Adam's moments held as one
  step is held against the reference (``_lm_train_cases.check_step``),
  the parameters within twice the three steps' learning rates;
- the dry run's ``argument_bytes`` on the reduced config's tiny cell equal
  to the reference's XLA ``memory_analysis``;
- every rank's collective counter on the sharded steps equal to the
  steps' plan (the dry run's collective term).
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _dist_ranks as R
import _lm_train_cases as cases
from repro_torch.configs.base import get_config
from repro_torch.core import jaxrand
from repro_torch.launch import crosscheck, steps
from repro_torch.models import lm as LM
from repro_torch.optim.optimizers import OptState, tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 400
N = 1000                           # elements per rank in the compress cases
PIPE_REL = 1e-6
ELASTIC_RTOL = 5e-4
ELASTIC_NEAR = 0.1           # of the resumed step's lr
# the MoE's load-balancing loss, read as total - loss in float32: one
# spacing of a loss near 6.8 is 1.4e-4 of an aux near 2.3e-3
AUX_RTOL = 2e-3
# the reference's own sharded MoE step against its one-process step
# (measured 6.0e-4 on the 2 x 4 mesh)
MOE_MESH_RTOL = 1e-3


def _pow2_cases(rng):
    """(g, r) pairs (8, N) whose largest |g + r| over the ranks sits on a
    power-of-two boundary of ``127 / max_abs``; r is zero."""
    f32 = np.float32
    m0 = f32(127) * f32(2.0 ** -6)                  # 127 / m0 == 64
    assert f32(127) / m0 == f32(64)
    near = [m0]
    for _ in range(300):
        near.append(np.nextafter(near[-1], f32(np.inf)))
    q = [f32(127) / m for m in near]
    below = next(m for m, v in zip(near, q)
                 if v == np.nextafter(f32(64), f32(0)))
    lo = [m0]
    for _ in range(300):
        lo.append(np.nextafter(lo[-1], f32(0)))
    above = next(m for m in lo
                 if f32(127) / m == np.nextafter(f32(64), f32(np.inf)))
    targets = {"pow2": m0, "pow2_up": np.nextafter(m0, f32(np.inf)),
               "pow2_down": np.nextafter(m0, f32(0)), "q_below": below,
               "q_above": above}
    out = {}
    for k, (name, m) in enumerate(targets.items()):
        g = (rng.standard_normal((8, N)) * 0.3).astype(f32)
        g = np.clip(g, -0.9 * m, 0.9 * m).astype(f32)
        g[k % 8, 17 + k] = -m if k % 2 else m
        out[name] = (g, np.zeros_like(g))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dist"))
    cfgs = {tag: get_config(arch).reduced()
            for tag, arch in R.TRAIN_ARCHS.items()}
    params = {tag: steps.init_params_for(
        c, jaxrand.PRNGKey(0, device="cpu"), device="cpu",
        dtype=torch.float32) for tag, c in cfgs.items()}
    rng = np.random.default_rng(5)
    inputs = {}
    for tag, p in params.items():
        inputs[f"{tag}_arch"] = np.array(R.TRAIN_ARCHS[tag])
        inputs[f"{tag}_n_leaves"] = np.array(len(tree_leaves(p)))
        for i, x in enumerate(tree_leaves(p)):
            inputs[f"{tag}_init/{i}"] = x.numpy()
    cfg = cfgs["train"]
    cases_in = {"seeded": (
        (rng.standard_normal((8, N)) * 0.01).astype(np.float32),
        (rng.standard_normal((8, N)) * 1e-4).astype(np.float32))}
    # gradients near 1e-13: scales near 2**46, where XLA's exp2 is not a
    # power of two
    cases_in["tiny"] = (
        (rng.standard_normal((8, N)) * 1e-13).astype(np.float32),
        (rng.standard_normal((8, N)) * 1e-15).astype(np.float32))
    cases_in.update(_pow2_cases(rng))
    for c, (g, r) in cases_in.items():
        inputs[f"g/{c}"], inputs[f"r/{c}"] = g, r
    inputs["pipe_x"] = rng.standard_normal((8, 16)).astype(np.float32)
    inputs["pipe_w"] = (rng.standard_normal((4, 16, 16)) * 0.3).astype(
        np.float32)
    inputs["pipe_b"] = (rng.standard_normal((4, 16)) * 0.1).astype(
        np.float32)
    inputs["tokens"] = rng.integers(2, cfg.vocab_size, (4, 32)).astype(
        np.int32)
    inputs["prompt"] = rng.integers(2, cfg.vocab_size, (4, R.PROMPT)).astype(
        np.int32)
    for k in range(R.ELASTIC_STEPS + 1):
        inputs[f"elastic_tokens/{k}"] = rng.integers(
            2, cfg.vocab_size, (4, 32)).astype(np.int32)
    np.savez(os.path.join(root, "inputs.npz"), **inputs)

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + " --xla_force_host_platform_device_count=8")
    ref = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "_dist_reference.py"),
         root], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    try:
        ctx = mp.spawn(R.run, args=(root,), nprocs=R.WORLD, join=False)
        t0 = time.time()
        while not ctx.join(timeout=5):
            if time.time() - t0 > DEADLINE_S:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError("the gloo ranks did not finish")
        log, _ = ref.communicate(timeout=DEADLINE_S)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0, log[-6000:]
    return types.SimpleNamespace(
        cfgs=cfgs, params=params, inputs=inputs,
        ref=dict(np.load(os.path.join(root, "reference.npz"))),
        ranks=[dict(np.load(os.path.join(root, f"rank{r}.npz")))
               for r in range(R.WORLD)])


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("case", R.COMPRESS_CASES)
def test_compressed_mean_is_the_reference_bit_for_bit(runs, case):
    g, r = runs.inputs[f"g/{case}"], runs.inputs[f"r/{case}"]
    f32 = np.float32
    q = {"pow2": f32(64), "q_below": np.nextafter(f32(64), f32(0)),
         "q_above": np.nextafter(f32(64), f32(np.inf))}
    if case in q:                     # the boundary the case is built on
        assert f32(127) / np.abs(g + r).max() == q[case]
    for rank, out in enumerate(runs.ranks):
        np.testing.assert_array_equal(_bits(out[f"cm/{case}"]),
                                      _bits(runs.ref[f"cm/{case}"][rank]))
        np.testing.assert_array_equal(_bits(out[f"cr/{case}"]),
                                      _bits(runs.ref[f"cr/{case}"][rank]))
    # every rank agrees, and the residual is within one quantization step
    assert all(np.array_equal(o[f"cm/{case}"], runs.ranks[0][f"cm/{case}"])
               for o in runs.ranks)
    step = np.abs(g + r).max() / 127
    assert max(np.abs(o[f"cr/{case}"]).max() for o in runs.ranks) \
        <= step * 1.01


@pytest.mark.parametrize("case", R.COMPRESS_CASES)
def test_exact_mean_within_two_ulps(runs, case):
    """gloo sums the 8 addends in another order than XLA's ``pmean``: an
    error on the scale of the addends, so 2 ulps of the largest input
    (measured at most 0.75; 3 ulps of the largest mean on the tiny case)."""
    want = runs.ref[f"ce/{case}"]
    ulp = np.spacing(np.abs(runs.inputs[f"g/{case}"]).max())
    for rank, out in enumerate(runs.ranks):
        assert np.abs(out[f"ce/{case}"] - want[rank]).max() <= 2 * ulp


def test_pipeline_equals_the_stages_in_sequence(runs):
    w = torch.from_numpy(runs.inputs["pipe_w"])
    b = torch.from_numpy(runs.inputs["pipe_b"])
    x = torch.from_numpy(runs.inputs["pipe_x"])
    outs = []
    for mb in x.reshape(4, -1, x.shape[1]):
        for s in range(4):
            mb = R.layer_fn({"w": w[s], "b": b[s]}, mb)
        outs.append(mb)
    want = torch.cat(outs).numpy()
    for out in runs.ranks:
        np.testing.assert_array_equal(out["pipe"], want)
    ref = runs.ref["pipe"]
    assert np.abs(want - ref).max() <= PIPE_REL * np.abs(ref).max()
    # the ring passed one microbatch a tick, and one all-reduce replicated
    counts = runs.ranks[0]["pipe_counts"]
    mb_bytes = want.nbytes // 4
    assert counts[4] == (4 + 4 - 1) * mb_bytes          # collective-permute
    assert counts[1] == want.nbytes                     # all-reduce


def test_reshard_to_gives_the_reference_addressable_shards(runs):
    n = int(runs.inputs["train_n_leaves"])
    for rank, out in enumerate(runs.ranks):
        for i in range(n):
            np.testing.assert_array_equal(
                out[f"shard/{i}"], runs.ref[f"shard/{i}/{rank}"])


def _state(out, tag, n):
    """(params, opt_state, metrics) of a step that ``out`` holds under
    ``tag``, as numpy leaves."""
    leaves = lambda k: [out[f"{tag}_{k}/{i}"] for i in range(n)]
    return (leaves("params"),
            OptState(int(out[f"{tag}_step"]), leaves("mu"), leaves("nu")),
            dict(zip(("loss", "total"), out[f"{tag}_metrics"])))


def _n(runs, tag):
    return int(runs.inputs[f"{tag}_n_leaves"])


def _case(runs, tag):
    return {"arch": R.TRAIN_ARCHS[tag], "cfg": runs.cfgs[tag]}


# the reference step each port step is held to with ``check_step``: its
# sharded step for the dense config; for the MoE its one-process step,
# since its sharded MoE step is not that function (below)
REF_STEP = {"train": "train", "moe_train": "moe_train_plain"}


def _check_against_reference(runs, tag, got):
    ref = (_state(runs.ref, REF_STEP[tag], _n(runs, tag)), None)
    cases.check_step(_case(runs, tag), ref, got)
    # the load-balancing loss (total - loss) of the global batch
    aux = lambda m: float(m["total"]) - float(m["loss"])
    want = aux(ref[0][2])
    assert abs(aux(got[2]) - want) <= AUX_RTOL * abs(want) or want == 0, \
        (aux(got[2]), want)


@pytest.mark.parametrize("tag", list(R.TRAIN_ARCHS))
def test_sharded_train_step_against_the_reference(runs, tag):
    _check_against_reference(runs, tag,
                             _state(runs.ranks[0], tag, _n(runs, tag)))
    # every rank reports the same global loss and gathers the same state
    for o in runs.ranks[1:]:
        np.testing.assert_array_equal(o[f"{tag}_metrics"],
                                      runs.ranks[0][f"{tag}_metrics"])
        for i in range(_n(runs, tag)):
            np.testing.assert_array_equal(
                o[f"{tag}_params/{i}"], runs.ranks[0][f"{tag}_params/{i}"])


@pytest.mark.parametrize("tag", list(R.TRAIN_ARCHS))
def test_single_process_step_against_the_reference(runs, tag):
    cfg, params = runs.cfgs[tag], runs.params[tag]
    tokens = torch.from_numpy(runs.inputs["tokens"]).long()
    opt = steps.make_optimizer(cfg)
    got = steps.make_train_step(cfg, opt)(
        params, opt.init(params), {"tokens": tokens, "labels": tokens})
    _check_against_reference(runs, tag, got)


def test_sharded_moe_step_against_the_reference_sharded_step(runs):
    """The reference's sharded MoE step on the 2 x 4 mesh is not its own
    one-process step: with the router's product partitioned on the mesh,
    86% of its logits differ from the one-process step's, by up to 1.83,
    and its loss by 6.0e-4 of itself (measured; 1.6e-4 on an 8 x 1 mesh,
    6.4e-4 on 4 x 2).  The port's sharded step computes the one-process
    function (held above), so against the reference's sharded step it
    is held to that gap."""
    got = runs.ranks[0]["moe_train_metrics"]
    want = runs.ref["moe_train_metrics"]
    plain = runs.ref["moe_train_plain_metrics"]
    assert np.abs(want - plain).max() > 1e-4 * np.abs(plain).max()
    np.testing.assert_allclose(got, want, rtol=MOE_MESH_RTOL)


def test_sharded_serving_steps_against_one_process(runs):
    cfg, params = runs.cfgs["train"], runs.params["train"]
    prompt = torch.from_numpy(runs.inputs["prompt"]).long()
    logits, caches = steps.make_prefill_step(cfg)(params,
                                                  {"tokens": prompt})
    cache = LM.init_cache(cfg, prompt.shape[0], R.CACHE, device="cpu")
    dl = []
    decode = steps.make_decode_step(cfg)
    for t in range(R.PROMPT):
        lg, cache = decode(params, cache, {"tokens": prompt[:, t:t + 1],
                                           "index": torch.tensor(t)})
        dl.append(lg.float())
    for out in runs.ranks:
        ulps = crosscheck.ulps_apart
        assert ulps(torch.from_numpy(out["serve_prefill"]),
                    logits.float()) <= crosscheck.LM_ULPS
        assert ulps(torch.from_numpy(out["serve_decode"]),
                    torch.stack(dl)) <= crosscheck.LM_ULPS
        for key, tree in (("prefill_cache", caches), ("decode_cache", cache)):
            for i, want in enumerate(tree_leaves(tree)):
                got = torch.from_numpy(out[f"serve_{key}/{i}"])
                assert ulps(got, want.float()) <= crosscheck.LM_ULPS, \
                    (key, i)


def test_elastic_resume_against_unsharded_steps(runs):
    """2 steps on 2 x 4, a checkpoint, 1 step on 2 x 2, against 3
    unsharded steps.  Each Adam step moves an element by at most about
    its lr, and a gradient whose sign differs moves it by twice that the
    other way, so every element is held within twice the sum of the three
    steps' learning rates (plus two float32 spacings).  After the first
    step Adam's update depends on the gradients' size, not only their
    sign, and the sharded gradients (each rank's 2 rows, summed) round
    otherwise than the 4-row batch's: measured, 33% of the elements
    bit-equal, the median gap 0.0017 of the last step's lr, 0.11% of the
    elements farther than 0.1 of it.  So at least ``PARAMS_EQUAL`` of the
    elements within ``ELASTIC_NEAR`` of the last lr, where a resume that
    restored the first parameters, reset the moments or skipped the step
    moves nearly every element by about an lr; the moments within the
    shares ``check_step`` holds them to."""
    cfg, n = runs.cfgs["train"], _n(runs, "train")
    opt = steps.make_optimizer(cfg)
    step = steps.make_train_step(cfg, opt)
    p, o, losses = runs.params["train"], opt.init(runs.params["train"]), []
    for k in range(R.ELASTIC_STEPS + 1):
        t = torch.from_numpy(runs.inputs[f"elastic_tokens/{k}"]).long()
        p, o, m = step(p, o, {"tokens": t, "labels": t})
        losses.append(float(m["loss"]))
    lrs = sum(float(opt.schedule(k + 1))
              for k in range(R.ELASTIC_STEPS + 1))
    for out in runs.ranks[:4]:
        assert tuple(out["elastic_mesh"]) == (2, 2)
        np.testing.assert_allclose(out["elastic_losses"], losses,
                                   rtol=ELASTIC_RTOL)
        got_p, got_o, _ = _state(out, "elastic", n)
        assert got_o.step == o.step == R.ELASTIC_STEPS + 1
        near = total = 0
        last = float(opt.schedule(R.ELASTIC_STEPS + 1))
        for got, want in zip(got_p, tree_leaves(p)):
            want = want.numpy()
            allowed = 2 * lrs + 2 * np.spacing(np.abs(want))
            assert (np.abs(got - want) <= allowed).all()
            near += int((np.abs(got - want) <= ELASTIC_NEAR * last).sum())
            total += want.size
        assert near >= cases.PARAMS_EQUAL * total, near / total
        cases.within_share(got_o.mu, o.mu, cases.GRAD_SHARE, "mu")
        cases.within_share(got_o.nu, o.nu, 2 * cases.GRAD_SHARE, "nu")
    # ranks outside the smaller mesh stepped twice only
    assert all(len(o["elastic_losses"]) == R.ELASTIC_STEPS
               for o in runs.ranks[4:])


def test_dryrun_argument_bytes_equal_the_reference_xla_figure(
        runs, monkeypatch):
    import repro_torch.configs.qwen2_5_14b as q
    from repro_torch.configs import base
    from repro_torch.launch import dryrun
    monkeypatch.setattr(q, "CONFIG", runs.cfgs["train"])
    monkeypatch.setitem(base.SHAPES, "tiny_train",
                        dict(seq_len=64, global_batch=4, kind="train"))
    # the reference's test shrinks the production mesh to 2 x 4
    monkeypatch.setattr(dryrun, "production_axes",
                        lambda multi_pod: {"data": 2, "model": 4})
    rec = dryrun.run_cell(R.ARCH, "tiny_train", False)
    assert rec["status"] == "ok"
    assert rec["memory_analysis"]["argument_bytes"] == int(
        runs.ref["dry_args"]) == 895748


@pytest.mark.parametrize("what", ["train", "moe_train", "serve_prefill",
                                  "serve_decode"])
def test_collective_counter_equals_the_plan(runs, what):
    for out in runs.ranks:
        np.testing.assert_array_equal(out[f"{what}_counts"],
                                      out[f"{what}_plan"])
    assert runs.ranks[0][f"{what}_counts"][-1] > 0
