"""The port's token pipeline, checkpointer and training loop against the
JAX package's, on the CPU, on the reduced configs.

- ``data.tokens.batch_at_step``: bitwise the reference's, host sharding
  included (``tests/test_data.py``'s two cases).
- ``checkpoint.checkpointer.Checkpointer``: ``tests/test_checkpoint.py``'s
  round trip, retention and atomicity cases, and a checkpoint of the LM's
  parameters and Adam state saved by the reference loads in the port, and
  the port's in the reference, leaf for leaf.
- One train step on internvl2-2b (its prefix frames and label offset),
  internlm2-20b, mistral-large-123b and qwen3-moe-30b-a3b (QK-norm, the
  MoE layers and their aux loss) against the reference's, within the
  tolerances of ``tests/_lm_train_cases.py`` (qwen2.5-14b and
  starcoder2-15b are in ``tests/test_torch_lm_train.py``, qwen2-moe-a2.7b
  in ``tests/test_torch_moe.py``).
- ``launch.train.train_loop``: 4 steps of the reduced qwen2.5-14b (batch
  4, seq 32) against the reference's: the final loss within
  ``LOOP_RTOL``, the parameters within twice the sum of the steps'
  learning rates of each other; and a straight run against a failed run
  resumed from its checkpoint, bit for bit.  ``LOOP_RTOL``'s cause: from
  the second step on, Adam's step is ``m / sqrt(v)`` of two gradient
  histories that differ by ``cases.GRAD_SHARE`` of each leaf's largest
  gradient, so an element with a small gradient steps in another
  direction, and most elements differ after a few steps (10% of them
  equal after three).  Measured: the losses of steps 1-4 apart by 1.4e-6,
  1.6e-5, 2.2e-5 and 2.5e-4 of themselves, the parameters by at most 1.3
  times the learning rates' sum; from the reference's own parameters
  before step 4 the port's loss is within 3.3e-5.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _lm_train_cases as cases
from repro.checkpoint import checkpointer as jckpt
from repro.data import tokens as jtokens
from repro.launch import train as jtrain
from repro.optim.optimizers import OptState as JOptState
from repro_torch.checkpoint import checkpointer
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import get_config
from repro_torch.core import jaxrand
from repro_torch.data.tokens import TokenPipelineConfig, batch_at_step
from repro_torch.launch import steps, train
from repro_torch.optim.optimizers import OptState, tree_leaves, tree_map


# ---------------------------------------------------------------------------
# the token pipeline
# ---------------------------------------------------------------------------


def _pipes(**kw):
    return TokenPipelineConfig(**kw), jtokens.TokenPipelineConfig(**kw)


def test_token_pipeline_deterministic_resumable_and_the_reference():
    cfg, jcfg = _pipes(vocab_size=1000, seq_len=64, global_batch=8, seed=3)
    for step in (0, 17, 18, 12345):
        a, b = batch_at_step(cfg, step)
        ja, jb = jtokens.batch_at_step(jcfg, step)
        assert a.dtype == ja.dtype == np.uint32
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(b, jb)
        a2, b2 = batch_at_step(cfg, step)          # any step, any time
        np.testing.assert_array_equal(a, a2)
        np.testing.assert_array_equal(b, b2)
    assert not np.array_equal(batch_at_step(cfg, 17)[0],
                              batch_at_step(cfg, 18)[0])


def test_token_pipeline_host_sharding():
    full, _ = _pipes(vocab_size=500, seq_len=32, global_batch=8, seed=1)
    t = {}
    for h in (0, 1):
        cfg, jcfg = _pipes(vocab_size=500, seq_len=32, global_batch=8,
                           seed=1, num_hosts=2, host_id=h)
        t[h], _ = batch_at_step(cfg, 0)
        np.testing.assert_array_equal(t[h], jtokens.batch_at_step(jcfg,
                                                                  0)[0])
        assert t[h].shape == (4, 32)
    assert not np.array_equal(t[0], t[1])       # hosts draw different data
    tokens, labels = batch_at_step(full, 2)
    np.testing.assert_array_equal(tokens[:, 1:], labels[:, :-1])
    assert (labels[:, -1] == full.eos_id).all()


# ---------------------------------------------------------------------------
# the checkpointer
# ---------------------------------------------------------------------------


def _equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def test_save_restore_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_last=2)
    params = {"w": torch.arange(6.0).reshape(2, 3), "b": torch.zeros(3),
              "layers": [{"x": torch.ones(2, dtype=torch.bfloat16)}]}
    opt = OptState(step=7, mu=tree_map(torch.zeros_like, params),
                   nu=tree_map(torch.ones_like, params))
    ck.save(10, params, opt, data_step=10,
            rng_key=jaxrand.PRNGKey(1, device="cpu"))
    got = ck.restore(params, opt)
    assert got is not None
    p2, o2, meta = got
    assert _equal(params, p2) and _equal(opt.mu, o2.mu)
    assert _equal(opt.nu, o2.nu) and o2.step == 7 and isinstance(o2.step,
                                                                 int)
    assert p2["layers"][0]["x"].dtype == torch.bfloat16
    assert meta["step"] == 10 and meta["data_step"] == 10
    assert meta["rng_key"] == [0, 1]
    with pytest.raises(ValueError, match="leaves"):
        ck.restore({"w": params["w"]}, opt)


def test_retention_and_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep_last=2)
    params = {"w": torch.ones(3)}
    assert ck.latest_step() is None and ck.restore(params, params) is None
    for s in (1, 2, 3, 4):
        ck.save(s, params, params, data_step=s,
                rng_key=jaxrand.PRNGKey(0, device="cpu"))
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4


def test_no_partial_checkpoint_on_failure(tmp_path, monkeypatch):
    """Atomicity: a directory without ``meta.json`` never counts, and a
    save that fails midway (here: writing the optimizer state) leaves
    nothing behind."""
    ck = Checkpointer(str(tmp_path))
    os.makedirs(os.path.join(str(tmp_path), "step_00000099"))
    assert ck.all_steps() == []
    save = checkpointer.save_pytree

    def failing(path, tree):
        if path.endswith("opt_state.npz"):
            raise OSError("disk full")
        save(path, tree)
    monkeypatch.setattr(checkpointer, "save_pytree", failing)
    with pytest.raises(OSError, match="disk full"):
        ck.save(5, {"w": torch.ones(2)}, {"w": torch.ones(2)}, data_step=5,
                rng_key=[0, 0])
    assert sorted(os.listdir(str(tmp_path))) == ["step_00000099"]
    assert ck.all_steps() == []


def _lm_state(arch):
    """The reduced ``arch``'s reference parameters (float32) and an Adam
    state of nonzero moments at step 5, in both packages' forms."""
    c = cases.case(arch)
    jp = c["jparams"]
    jopt = JOptState(step=jnp.int32(5),
                     mu=jax.tree_util.tree_map(lambda a: a * 0.5, jp),
                     nu=jax.tree_util.tree_map(lambda a: a * a, jp))
    p = c["params"]
    opt = OptState(step=5, mu=tree_map(lambda a: a * 0.5, p),
                   nu=tree_map(lambda a: a * a, p))
    return c["cfg"], jp, jopt, p, opt


def _np_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


def test_reference_checkpoint_loads_in_the_port(tmp_path):
    cfg, jp, jopt, p, opt = _lm_state("internvl2-2b")
    jckpt.Checkpointer(str(tmp_path)).save(
        7, jp, jopt, data_step=7, rng_key=jax.random.PRNGKey(3))
    like_o = steps.make_optimizer(cfg).init(p)
    p2, o2, meta = Checkpointer(str(tmp_path)).restore(p, like_o)
    assert o2.step == 5 and meta["step"] == 7 and meta["rng_key"] == [0, 3]
    for got, want in ((p2, jp), (o2.mu, jopt.mu), (o2.nu, jopt.nu)):
        g = tree_leaves(got)
        assert all(x.device.type == "cpu" and x.dtype == torch.float32
                   for x in g)
        assert all(np.array_equal(x.numpy(), y)
                   for x, y in zip(g, _np_leaves(want)))
    assert _equal(p2, p) and _equal(o2.nu, opt.nu)


def test_port_checkpoint_loads_in_the_reference(tmp_path):
    cfg, jp, jopt, p, opt = _lm_state("qwen2.5-14b")
    Checkpointer(str(tmp_path)).save(
        9, p, opt, data_step=9, rng_key=jaxrand.PRNGKey(4, device="cpu"))
    p2, o2, meta = jckpt.Checkpointer(str(tmp_path)).restore(jp, jopt)
    assert int(o2.step) == 5 and o2.step.dtype == jnp.int32
    assert meta["rng_key"] == np.asarray(jax.random.PRNGKey(4)).tolist()
    for got, want in ((p2, jp), (o2.mu, jopt.mu), (o2.nu, jopt.nu)):
        assert jax.tree_util.tree_structure(got) == \
            jax.tree_util.tree_structure(want)
        assert all(np.array_equal(x, y) for x, y in
                   zip(_np_leaves(got), _np_leaves(want)))


# ---------------------------------------------------------------------------
# one train step on the other three archs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ("internvl2-2b", "internlm2-20b",
                                  "mistral-large-123b",
                                  "qwen3-moe-30b-a3b"))
def test_train_step_against_the_reference(arch):
    c = cases.case(arch)
    ref = cases.ref_step(c)
    cfg = c["cfg"]
    opt = steps.make_optimizer(cfg)
    got = steps.make_train_step(cfg, opt)(c["params"],
                                          opt.init(c["params"]), c["batch"])
    _, grads = steps.loss_and_grads(cfg, c["params"], c["batch"])
    loss = float(got[2]["loss"])
    assert 0.5 * np.log(cfg.vocab_size) < loss < 2.5 * np.log(
        cfg.vocab_size)
    cases.check_step(c, ref, got, grads)


# ---------------------------------------------------------------------------
# the training loop
# ---------------------------------------------------------------------------

LOOP = dict(reduced=True, batch=4, seq=32, log_every=100)
LOOP_RTOL = 5e-4


def test_train_loop_against_the_reference():
    n = 4
    jparams, want = jtrain.train_loop("qwen2.5-14b", n, **LOOP)
    params, got = train.train_loop("qwen2.5-14b", n, device="cpu", **LOOP)
    for k in ("loss", "total"):
        assert abs(got[k] - want[k]) <= LOOP_RTOL * abs(want[k]), k
    cfg = get_config("qwen2.5-14b").reduced()
    sched = steps.make_optimizer(cfg, steps=n).schedule
    moved = 2 * sum(float(sched(t)) for t in range(1, n + 1))
    for g, w in zip(tree_leaves(params), _np_leaves(jparams)):
        assert (np.abs(g.numpy() - w) <= moved + 4 * np.spacing(
            np.abs(w))).all()


def test_train_loop_resumes_bit_for_bit(tmp_path, capsys):
    """12 steps straight against a run that fails at step 9 and resumes
    from its step-8 checkpoint (the reference's slow test, at batch 2,
    seq 16): the same final loss and parameters, bit for bit."""
    kw = dict(LOOP, batch=2, seq=16, ckpt_every=4, device="cpu")
    straight_p, straight = train.train_loop(
        "qwen2.5-14b", 12, ckpt_dir=str(tmp_path / "a"), **kw)
    with pytest.raises(RuntimeError, match="simulated node failure"):
        train.train_loop("qwen2.5-14b", 12, ckpt_dir=str(tmp_path / "b"),
                         fail_at=9, **kw)
    resumed_p, resumed = train.train_loop(
        "qwen2.5-14b", 12, ckpt_dir=str(tmp_path / "b"), **kw)
    assert "resumed from step 8" in capsys.readouterr().out
    assert resumed == straight
    assert _equal(resumed_p, straight_p)
    ck = Checkpointer(str(tmp_path / "b"))
    assert ck.all_steps() == [4, 8, 12]
    with open(tmp_path / "b" / "step_00000012" / "meta.json") as f:
        assert json.load(f)["rng_key"] == [0, 1]     # PRNGKey(seed + 1)


def test_train_main_and_the_device_rule(capsys, monkeypatch):
    train.main(["--arch", "internvl2-2b", "--reduced", "--steps", "2",
                "--batch", "2", "--seq", "8", "--device", "cpu"])
    assert "[train] done" in capsys.readouterr().out
    # the encoder-decoder (item 7f, ported) takes its steps, its frames
    # the reference's ones
    _, metrics = train.train_loop("seamless-m4t-medium", 2, batch=2,
                                  seq=16, log_every=10 ** 9, device="cpu")
    assert np.isfinite(metrics["loss"])
    # the zamba2 hybrid (item 7d, ported) takes its steps
    _, metrics = train.train_loop("zamba2-1.2b", 2, batch=2, seq=16,
                                  log_every=10 ** 9, device="cpu")
    assert np.isfinite(metrics["loss"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.train_loop("qwen2.5-14b", 1)
