"""The fused head training of the customization path
(``repro_torch.kernels.sga_update.ops.head_train_batch``: a training
tick's whole budget of epochs for every session row in one launch)
against the JAX package's per-epoch loop, on the CPU, bit for bit.

On the CPU the wrapper runs its plain version (``ref.head_train_rows_ref``);
the JAX side runs what its customization path runs every round:
``epoch_grads`` per session, then one ``sga_update_batch`` (the Pallas
``sga_update_rows`` kernel in interpret mode) over the rows still
training.  Three rows of different N start at different epochs of the
LR schedule with budgets (10, 7, 10), SGA banks already loaded, under
fixed, dynamic (ceil, and floor with a clamp) and no error scaling; the
first row holds an utterance whose LUT softmax rounds an exact tie.
Then the routing rule: RGP sessions and sessions outside the kernel's
exactness bound train epoch by epoch through ``sga_update_batch``, and
land on the port's offline loop.  tests/test_torch_cuda.py holds the
kernel against the plain version on a card.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import onchip_training as jot
from repro.kernels.sga_update import ops as jops
from repro_torch.core import jaxrand
from repro_torch.core import onchip_training as ot
from repro_torch.core import quantize
from repro_torch.kernels.sga_update import ops, ref
from repro_torch.models import kws
from repro_torch.serving import CustomizeConfig, StreamServer
from repro_torch.training import kws as tr

from _sga_cases import TIE_KS, head_rows

D, C = 576, 10
NS, STARTS, BUDGETS = (10, 7, 12), (0, 13, 35), (10, 7, 10)
CONFIGS = {
    "fixed-1.375": dict(fixed_error_scale=1.375),
    "dynamic-ceil": dict(),
    "dynamic-floor-max3": dict(error_scale_mode="floor",
                               error_scale_max_exponent=3),
    "no-scaling": dict(error_scaling=False),
}


def _jax_loop(rows, jcfg):
    """The JAX customization path's rounds: epoch_grads per row, jitted as
    that path runs it (``repro/serving/customize.py``), then one
    sga_update_batch over the rows still training."""
    grads_fn = jax.jit(lambda st, e, f, oh: jot.epoch_grads(st, e, f, oh,
                                                            jcfg))
    states = [jot.HeadState(*(jnp.asarray(r[k]) for k in ("w", "b", "aw",
                                                          "ab")),
                            key=jnp.zeros(2, jnp.uint32)) for r in rows]
    for rnd in range(max(BUDGETS)):
        batch = [i for i in range(len(rows)) if rnd < BUDGETS[i]]
        grads = [grads_fn(states[i], jnp.int32(STARTS[i] + rnd),
                          jnp.asarray(rows[i]["f"]),
                          jnp.asarray(rows[i]["onehot"]))
                 for i in batch]
        cat = lambda a, b: jnp.concatenate([a.reshape(-1), b.reshape(-1)])
        lrs = jnp.stack([g[2] for g in grads])
        nw, na = jops.sga_update_batch(
            jnp.stack([cat(states[i].w, states[i].b) for i in batch]),
            jnp.stack([cat(g[0], g[1]) for g in grads]),
            jnp.stack([cat(states[i].accum_w, states[i].accum_b)
                       for i in batch]),
            lrs, jot.sga_threshold(lrs, jcfg.weight_fmt), interpret=True)
        for j, i in enumerate(batch):
            states[i] = jot.HeadState(
                nw[j, :D * C].reshape(D, C), nw[j, D * C:],
                na[j, :D * C].reshape(D, C), na[j, D * C:], states[i].key)
    return states


def test_rows_hold_a_lut_tie():
    """The first row's zero-feature utterance rounds an exact tie in the
    LUT softmax at epoch 0 (round half to even decides it)."""
    lut = ot._EXP_LUT.numpy()
    e = lut[255 - np.asarray(TIE_KS)]
    scaled = e / e.sum() * 256
    assert np.sum(scaled % 1 == 0.5) == 2


@pytest.mark.parametrize("name", list(CONFIGS))
def test_plain_version_matches_jax_loop(name):
    rows = head_rows(list(CONFIGS).index(name), NS)
    jcfg = jot.OnChipTrainConfig(**CONFIGS[name])
    tcfg = ot.OnChipTrainConfig(**CONFIGS[name])
    want = _jax_loop(rows, jcfg)
    t = {k: [torch.tensor(r[k]) for r in rows]
         for k in ("w", "b", "aw", "ab", "f", "onehot")}
    before = [v.clone() for v in t["w"]]
    ops.COUNTS_HEAD.reset()
    ops.head_train_batch(t["w"], t["b"], t["aw"], t["ab"], t["f"],
                         t["onehot"], list(STARTS), list(BUDGETS),
                         ot.train_lut(torch.device("cpu")),
                         ot.head_train_spec(tcfg))
    assert ops.COUNTS_HEAD.launches == 0          # no kernel on the CPU
    for i, st in enumerate(want):
        for got, ref_v in zip((t["w"][i], t["b"][i], t["aw"][i],
                               t["ab"][i]), st[:4]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(ref_v))
        assert not torch.equal(t["w"][i], before[i])   # it trained


@pytest.mark.parametrize("mode,max_exponent", [("ceil", None),
                                               ("floor", None),
                                               ("ceil", 2), ("floor", 3)])
def test_error_exponent_from_bits_on_every_grid_value(mode, max_exponent):
    """The exponent read from the quotient's binary exponent (kernel and
    plain version) equals ``error_scale_exponent`` (held against JAX's
    log2 in test_torch_onchip_training.py) on all 257 values k / 256."""
    for k in range(257):
        err = torch.zeros((3, C))
        err[1, 4] = -k / 256.0
        assert int(ref.error_exponent(err, mode, max_exponent)) == int(
            quantize.error_scale_exponent(err, mode, max_exponent)), k


def test_route_rule():
    """The exactness bound of the paper formats holds up to N = 1024
    utterances of 576 features; RGP, the float loop, no SGA, an
    activation format too wide for the bound and a head too large for a
    block's shared memory take the per-epoch route."""
    cfg = ot.OnChipTrainConfig()
    assert ot.head_train_exact(cfg, 1024, 576)
    assert not ot.head_train_exact(cfg, 1025, 576)
    assert ot.fused_head_route(cfg, 1024, 576, 10)
    assert not ot.fused_head_route(cfg, 1025, 576, 10)
    for kw in (dict(rgp=True), dict(quantized=False), dict(sga=False),
               dict(act_fmt=quantize.QFormat(3, 12))):
        assert not ot.fused_head_route(ot.OnChipTrainConfig(**kw), 10, 576,
                                       10), kw
    assert not ot.fused_head_route(cfg, 10, 576, 100)
    assert ot.head_train_spec(cfg) == ot.head_train_spec(
        ot.OnChipTrainConfig(epochs=7))
    assert ot.head_train_spec(cfg) != ot.head_train_spec(
        ot.OnChipTrainConfig(fixed_error_scale=1.375))


L, HOP = 640, 64
CFG = kws.KWSConfig(sample_len=L)


@pytest.fixture(scope="module")
def hw():
    params = kws.init_params(jaxrand.PRNGKey(5, device="cpu"), CFG,
                             device="cpu")
    return kws.fold_params(params, kws.init_state(CFG, device="cpu"), CFG,
                           pack=True)


@pytest.mark.parametrize("train", [
    dict(rgp=True, seed=3),
    dict(act_fmt=quantize.QFormat(3, 12, "act:Q1.3.12"))],
    ids=["rgp", "out-of-bound"])
def test_per_epoch_route_sessions(hw, monkeypatch, train):
    """A session with RGP, and one whose formats pass the exactness bound,
    beside a fused-route session: each tick the first two take one
    ``sga_update_batch`` per epoch and the third one fused call; all land
    on the port's offline loop (held against JAX elsewhere)."""
    fused, rows = [], []
    fused_fn, rows_fn = ops.head_train_batch, ops.sga_update_batch

    def count_fused(*args):
        fused.append(len(args[0]))
        return fused_fn(*args)

    def count_rows(w, *args, **kw):
        rows.append(w.shape[0])
        return rows_fn(w, *args, **kw)

    monkeypatch.setattr(ops, "head_train_batch", count_fused)
    monkeypatch.setattr(ops, "sga_update_batch", count_rows)
    srv = StreamServer(hw, CFG, hop=HOP, slots=4, device="cpu")
    rng = np.random.default_rng(9)
    sessions, labels = [], []
    for k, tcfg in enumerate((ot.OnChipTrainConfig(epochs=14, **train),
                              ot.OnChipTrainConfig(epochs=14))):
        sess = srv.customize(f"user{k}", CustomizeConfig(
            train=tcfg, epochs_per_tick=5, compensate=False))
        labels.append([int(v) for v in rng.integers(0, C, 3)])
        for lab in labels[-1]:
            sess.enroll(lab, rng.uniform(-1, 1, L).astype(np.float32))
        sess.finish_enrollment()
        sessions.append(sess)
    for _ in range(80):
        srv.step()
        if all(s.phase == "swapped" for s in sessions):
            break
    assert all(s.phase == "swapped" for s in sessions)
    assert fused == [1, 1, 1] and rows == [1] * 14
    hwp = hw.hw
    for sess, labs in zip(sessions, labels):
        feats = tr.hw_features(hw, np.stack(sess.windows), CFG,
                               device="cpu")
        w, b = ot.quantized_head_finetune(feats, labs, hwp.fc_w, hwp.fc_b,
                                          sess.ccfg.train, device="cpu")
        assert torch.equal(torch.tensor(sess.result.fc_w), w)
        assert torch.equal(torch.tensor(sess.result.fc_b), b)
