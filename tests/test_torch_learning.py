"""The port's float learning pieces against the JAX package, on the CPU:
the straight-through estimators (``core.binary``, ``core.quantize``), the
IMC macro accounting (``core.imc.map_layer_to_macros``), the optimizers
(``optim``), and the float path of the KWS net (``models.kws``:
``init_params`` from a ``jaxrand`` key, ``forward_eval``,
``forward_train`` in its three ``soft_alpha`` regimes, with chip offsets
and SA noise, ``cross_entropy``, ``accuracy`` and the unconstrained fold).

Bitwise wherever the reference is exact: the draws, the hard forwards,
the straight-through masks, the fixed-point optimizer.  Every other check
states its tolerance and the operation that breaks bit equality:

* ``binarize_sg``'s backward and the ``soft_alpha > 0`` path take
  ``tanh``, whose XLA and PyTorch float32 versions differ by an ulp or
  two: rtol 1e-5 per operation;
* gradients sum over the batch and time in another order than XLA's
  convolution: 1e-5 of the leaf's largest gradient on the hard paths.
  On the soft path the gradients cancel so deeply at initialization that
  the reference's own float32 gradient is up to ~4e-3 (of the leaf's
  largest) away from its float64 value; there the port is held to lie as
  close to the float64 gradient as the reference does (within 2x, plus
  1e-6 of the leaf's largest);
* ``cross_entropy``, ``cosine_schedule``, Adam and ``clip_by_global_norm``
  take ``exp``/``log``, ``cos``, ``pow``, ``sqrt`` and sums: rtol 1e-6.

The JAX side runs jitted, as ``train_base`` and ``evaluate`` run it.  One
module-scoped net at ``KWSConfig(sample_len=600)``.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binary as jbin
from repro.core import imc as jimc
from repro.core import quantize as jq
from repro.models import kws as jkws
from repro.optim import optimizers as jopt
from repro.optim import quantized as jqo
from repro_torch.core import binary, imc, jaxrand, quantize
from repro_torch.models import kws
from repro_torch.optim import optimizers as opt
from repro_torch.optim import quantized as qo

JCFG = jkws.KWSConfig(sample_len=600)
CFG = kws.KWSConfig(sample_len=600)
CPU = torch.device("cpu")


def _eq(port, ref):
    np.testing.assert_array_equal(port.detach().numpy(), np.asarray(ref))


def _close(port, ref, rtol, atol=0.0):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=atol)


def _np_tree(tree):
    return {n: {k: np.asarray(v) for k, v in d.items()}
            for n, d in tree.items()}


def _torch_tree(tree, grad=False):
    return {n: {k: torch.tensor(np.asarray(v)).requires_grad_(grad)
                for k, v in d.items()} for n, d in tree.items()}


# ---------------------------------------------------------------------------
# straight-through estimators
# ---------------------------------------------------------------------------

def _grid(seed, n=4096):
    """Values on and around the estimators' edges: 0, ±1, the Q1.7 range,
    plus a spread."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1.2, n).astype(np.float32)
    x[:8] = [0.0, -0.0, 1.0, -1.0, 127 / 128, -1.0, 1.0 + 2 ** -23,
             -1.0 - 2 ** -23]
    return x


def _vjp_pair(jfn, tfn, x, cot):
    jy, jg = jax.vjp(jfn, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    ty = tfn(xt)
    tg, = torch.autograd.grad(ty, xt, torch.tensor(cot))
    return (ty, tg), (jy, jg(jnp.asarray(cot))[0])


def test_binarize_forward_and_straight_through_mask():
    x, cot = _grid(0), _grid(1)
    (ty, tg), (jy, jg) = _vjp_pair(jbin.binarize, binary.binarize, x, cot)
    _eq(ty, jy)
    _eq(tg, jg)


@pytest.mark.parametrize("alpha", [5.0, 10.0])
def test_binarize_sg_forward_and_surrogate_gradient(alpha):
    """Forward bitwise; backward g * alpha * (1 - tanh(alpha x)**2) within
    rtol 1e-5, plus what a few ulps of tanh near ±1 make of 1 - t**2
    (XLA's tanh is not torch's; each ulp of t moves 1 - t**2 by up to
    2**-23): |delta| <= 1e-5 |g'| + 4 * 2**-23 * alpha |g|."""
    x, cot = _grid(2), _grid(3)
    (ty, tg), (jy, jg) = _vjp_pair(lambda a: jbin.binarize_sg(a, alpha),
                                   lambda a: binary.binarize_sg(a, alpha),
                                   x, cot)
    _eq(ty, jy)
    ref = np.asarray(jg)
    bound = 1e-5 * np.abs(ref) + 4 * 2.0 ** -23 * alpha * np.abs(cot)
    assert np.all(np.abs(tg.numpy() - ref) <= bound)


def test_rsign_and_binary_matmul():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 24)).astype(np.float32)
    off = rng.normal(size=24).astype(np.float32)
    _eq(binary.rsign(torch.tensor(x), torch.tensor(off)),
        jbin.rsign(jnp.asarray(x), jnp.asarray(off)))
    _eq(binary.rsign(torch.tensor(x), torch.tensor(off[:5]), 1),
        jbin.rsign(jnp.asarray(x), jnp.asarray(off[:5]), 1))
    a = np.where(rng.random((16, 72)) < 0.5, 1.0, -1.0).astype(np.float32)
    b = np.where(rng.random((72, 24)) < 0.5, 1.0, -1.0).astype(np.float32)
    _eq(binary.binary_matmul(torch.tensor(a), torch.tensor(b)),
        jbin.binary_matmul(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("fmt", ["WEIGHT_Q", "ACT_Q"])
def test_quantize_ste_forward_and_clipped_mask(fmt):
    jf, tf = getattr(jq, fmt), getattr(quantize, fmt)
    x = _grid(5) * np.float32(4 if fmt == "ACT_Q" else 0.6)
    x[8:12] = [tf.max_value, -tf.max_value, tf.max_value + 2 ** -10,
               tf.min_value]
    cot = _grid(6)
    (ty, tg), (jy, jg) = _vjp_pair(jf.quantize_ste, tf.quantize_ste, x, cot)
    _eq(ty, jy)
    _eq(tg, jg)
    _eq(quantize.quantize_ste(torch.tensor(x), tf),
        jq.quantize_ste(jnp.asarray(x), jf))


@pytest.mark.parametrize("kw", [dict(), dict(fixed_scale=1.375),
                                dict(mode="floor", max_exponent=3)],
                         ids=["ceil", "fixed", "floor-max3"])
def test_scale_error(kw):
    rng = np.random.default_rng(7)
    for scale_by in (1.0, 1 / 64, 0.0):
        err = (np.round(rng.uniform(-1, 1, (9, 10)) * 256) / 256
               * scale_by).astype(np.float32)
        tq, ts = quantize.scale_error(torch.tensor(err), **kw)
        jq_, js = jq.scale_error(jnp.asarray(err), **kw)
        _eq(tq, jq_)
        _eq(ts, js)


def test_stochastic_round_draws_the_references_uniforms():
    x = _grid(8)[:1000] * np.float32(0.5)
    for seed in (0, 11):
        _eq(quantize.stochastic_round(torch.tensor(x), quantize.WEIGHT_Q,
                                      jaxrand.PRNGKey(seed, device=CPU)),
            jq.stochastic_round(jnp.asarray(x), jq.WEIGHT_Q,
                                jax.random.PRNGKey(seed)))


# ---------------------------------------------------------------------------
# macro accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("macro", [dict(), dict(rows=128, cols=32)],
                         ids=["default", "128x32"])
def test_map_layer_to_macros(macro):
    for i in range(1, jkws.PAPER_KWS.num_conv_layers):
        args = (f"conv{i}", jkws.PAPER_KWS.channels[i],
                jkws.PAPER_KWS.channels_per_group, 3, 0.5 + 0.1 * i)
        got = imc.map_layer_to_macros(*args, macro=imc.IMCMacroConfig(
            **macro))
        want = jimc.map_layer_to_macros(*args, macro=jimc.IMCMacroConfig(
            **macro))
        assert got.__dict__ == want.__dict__


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

def _param_tree(seed):
    rng = np.random.default_rng(seed)
    return {"b": {"w": rng.normal(size=(6, 4)).astype(np.float32),
                  "v": rng.normal(size=4).astype(np.float32)},
            "a": {"w": rng.normal(size=(3, 3)).astype(np.float32)}}


def _flat(tree):
    return {(n, k): v for n, d in tree.items() for k, v in d.items()}


def test_schedules():
    """step_decay at 0.5 bitwise; the cosine (XLA's and numpy's float32
    cos differ by an ulp) within rtol 1e-6."""
    for args in ((1 / 16, 0.5, 10, 1 / 128), (0.01, 0.5, 3)):
        tf, jf = opt.step_decay_schedule(*args), \
            jopt.step_decay_schedule(*args)
        for s in range(0, 90, 7):
            assert tf(s) == np.float32(jf(s))
    for args in ((0.01, 120, 30, 1e-6), (0.01, 9, 0, 0.0), (0.3, 50, 7, 0.1)):
        tf = opt.cosine_schedule(*args)
        jf = jax.jit(jopt.cosine_schedule(*args))
        for s in range(0, args[1] + 5):
            np.testing.assert_allclose(tf(s), np.asarray(jf(s)), rtol=1e-6,
                                       atol=1e-12)


@pytest.mark.parametrize("clip", [None, 0.5])
def test_adam_and_sgd_updates(clip):
    """Three steps from the same gradients: rtol 1e-6 (pow, sqrt, sums)."""
    params = _param_tree(0)
    sched = jopt.cosine_schedule(0.01, 10, 2)
    for name, jmake, tmake in (
            ("adam", lambda: jopt.adam(sched, weight_decay=1e-4,
                                       clip_norm=clip),
             lambda: opt.adam(opt.cosine_schedule(0.01, 10, 2),
                              weight_decay=1e-4, clip_norm=clip)),
            ("sgd", lambda: jopt.sgd(sched, momentum=0.9, clip_norm=clip),
             lambda: opt.sgd(opt.cosine_schedule(0.01, 10, 2), momentum=0.9,
                             clip_norm=clip))):
        jo, to = jmake(), tmake()
        jp = {n: {k: jnp.asarray(v) for k, v in d.items()}
              for n, d in params.items()}
        tp = _torch_tree(params)
        js, ts = jo.init(jp), to.init(tp)
        jupd = jax.jit(jo.update)
        for step in range(3):
            g = _param_tree(10 + step)
            jp, js = jupd({n: {k: jnp.asarray(v) for k, v in d.items()}
                           for n, d in g.items()}, js, jp)
            tp, ts = to.update(_torch_tree(g), ts, tp)
            assert ts.step == int(js.step) == step + 1
            for key, v in _flat(tp).items():
                _close(v, _flat(jp)[key], rtol=1e-6, atol=1e-9)


def test_clip_by_global_norm():
    g = _param_tree(3)
    tg, tn = opt.clip_by_global_norm(_torch_tree(g), 1.0)
    jg, jn = jax.jit(lambda t: jopt.clip_by_global_norm(t, 1.0))(
        {n: {k: jnp.asarray(v) for k, v in d.items()} for n, d in g.items()})
    _close(tn, jn, rtol=1e-6)
    for key, v in _flat(tg).items():
        _close(v, _flat(jg)[key], rtol=1e-6)
    assert opt.tree_leaves(tg)[0] is tg["a"]["w"]      # sorted key order


@pytest.mark.parametrize("kw", [dict(), dict(rgp_lambda=8.0),
                                dict(sga=False)], ids=["sga", "rgp", "sgd"])
def test_quantized_sgd_step(kw):
    """Fixed-point grids throughout: bitwise, RGP draws included (the key
    chain follows the tree's sorted leaf order)."""
    rng = np.random.default_rng(9)
    q7 = lambda a: (np.clip(np.round(a * 128), -128, 127) / 128).astype(
        np.float32)
    params = {n: {k: q7(v * 0.3) for k, v in d.items()}
              for n, d in _param_tree(4).items()}
    js = jqo.quantized_sgd_init({n: {k: jnp.asarray(v) for k, v in d.items()}
                                 for n, d in params.items()}, seed=3)
    ts = qo.quantized_sgd_init(_torch_tree(params), seed=3)
    jp, tp = ({n: {k: jnp.asarray(v) for k, v in d.items()}
               for n, d in params.items()}, _torch_tree(params))
    for step in range(4):
        g = {n: {k: (rng.normal(size=v.shape) * 0.05).astype(np.float32)
                 for k, v in d.items()} for n, d in params.items()}
        lr = 1 / 16 / 2 ** step
        jp, js = jqo.quantized_sgd_step(
            {n: {k: jnp.asarray(v) for k, v in d.items()}
             for n, d in g.items()}, js, jp, lr, **kw)
        tp, ts = qo.quantized_sgd_step(_torch_tree(g), ts, tp, lr, **kw)
        for key, v in _flat(tp).items():
            _eq(v, _flat(jp)[key])
        for key, v in _flat(ts.accum).items():
            _eq(v, _flat(js.accum)[key])
        _eq(ts.key, js.key)


# ---------------------------------------------------------------------------
# the float path of the KWS net
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def net():
    """The reference's net from PRNGKey(1), its state, 8 windows of audio
    on the 1/127 grid, labels and a chip's offsets."""
    params = jkws.init_params(jax.random.PRNGKey(1), JCFG)
    rng = np.random.default_rng(2)
    x = (np.round(rng.uniform(-1, 1, (8, 600)) * 127) / 127).astype(
        np.float32)
    y = rng.integers(0, 10, 8)
    offs = {f"conv{i}": (rng.normal(size=CFG.channels[i]) * 4).astype(
        np.float32) for i in range(1, CFG.num_conv_layers)}
    return dict(params=params, state=jkws.init_state(JCFG), x=x, y=y,
                offs=offs)


@pytest.mark.parametrize("n", [2, 7, 24, 34, 35, 100])
def test_linspace_is_jnp_linspace(n):
    rng = np.random.default_rng(n)
    for a, b in ((700.0, 6200.0), (0.0, 900.0),
                 tuple(rng.uniform(-1e3, 1e4, 2).astype(np.float32))):
        _eq(kws.xla_linspace(float(a), float(b), n),
            jnp.linspace(float(a), float(b), n))


@pytest.mark.parametrize("seed", [0, 1, 5])
def test_init_params_draws_the_references_net(seed):
    want = _np_tree(jkws.init_params(jax.random.PRNGKey(seed), JCFG))
    got = kws.init_params(jaxrand.PRNGKey(seed, device=CPU), CFG,
                          device="cpu")
    assert sorted(got) == sorted(want)
    for n in want:
        assert sorted(got[n]) == sorted(want[n])
        for k in want[n]:
            _eq(got[n][k], want[n][k])


def test_forward_eval_and_unconstrained_fold(net):
    """forward_eval bitwise; the unconstrained fold is the reference's,
    and its hardware path equals the float path to 1e-5 (the reference's
    own fold check, tests/test_kws_model.py)."""
    jl, jf = jax.jit(lambda p, s, x: jkws.forward_eval(p, s, x, JCFG))(
        net["params"], net["state"], net["x"])
    tp, ts = kws.params_from_numpy(_np_tree(net["params"]),
                                   jkws.init_state(JCFG), device="cpu")
    tl, tf = kws.forward_eval(tp, ts, torch.tensor(net["x"]), CFG)
    _eq(tl, jl)
    _eq(tf, jf)
    hw_u = kws.fold_params(tp, ts, CFG, bn_constraints=False)
    jhw_u = jkws.fold_params(net["params"], net["state"], JCFG,
                             bn_constraints=False, fc_quant=False)
    hw_fq = kws.fold_params(tp, ts, CFG, bn_constraints=False, fc_quant=False)
    for name in jhw_u.bias:
        _eq(hw_fq.bias[name], jhw_u.bias[name])
    _eq(hw_fq.fc_w, jhw_u.fc_w)
    _, feats_u = kws.hw_forward(hw_u, net["x"], CFG, device="cpu")
    np.testing.assert_allclose(feats_u.numpy(), tf.numpy(), atol=1e-5)


def _value_and_grad(net, alpha, noisy):
    """Loss, logits, new state and gradients of the cross entropy through
    forward_train on both packages."""
    jo = ({k: jnp.asarray(v) for k, v in net["offs"].items()} if noisy
          else None)
    std = 1.0 if noisy else 0.0

    def loss(p):
        lg, ns = jkws.forward_train(p, net["state"], net["x"], JCFG,
                                    chip_offsets=jo, sa_noise_std=std,
                                    rng=jax.random.PRNGKey(7),
                                    soft_alpha=alpha)
        return jkws.cross_entropy(lg, jnp.asarray(net["y"])), (lg, ns)

    (jl, (jlg, jns)), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        net["params"])
    tp = _torch_tree(net["params"], grad=True)
    tlg, tns = kws.forward_train(
        tp, kws.init_state(CFG, device="cpu"), torch.tensor(net["x"]), CFG,
        chip_offsets=({k: torch.tensor(v) for k, v in net["offs"].items()}
                      if noisy else None),
        sa_noise_std=std, rng=jaxrand.PRNGKey(7, device=CPU),
        soft_alpha=alpha)
    tl = kws.cross_entropy(tlg, torch.tensor(net["y"]))
    names = [(n, k) for n in sorted(tp) for k in sorted(tp[n])]
    tg = torch.autograd.grad(tl, [tp[n][k] for n, k in names],
                             allow_unused=True)
    tg = {nk: (torch.zeros_like(tp[nk[0]][nk[1]]) if g is None else g)
          for nk, g in zip(names, tg)}
    return (tl, tlg, tns, tg), (jl, jlg, jns, jg)


@pytest.mark.parametrize("alpha", [None, -5.0], ids=["hard-ste",
                                                    "hard-sg"])
def test_forward_train_hard_paths(net, alpha):
    """With chip offsets and SA noise: logits, loss and new state bitwise
    (integer counts, the reciprocal rule, the jaxrand noise); gradients
    within 1e-5 of each leaf's largest (sum order).  The clean hard
    forward is ``forward_eval``'s, held bitwise above."""
    (tl, tlg, tns, tg), (jl, jlg, jns, jg) = _value_and_grad(net, alpha,
                                                            True)
    _eq(tlg, jlg)
    _eq(tl, jl)
    for name in jns.mean:
        _eq(tns.mean[name], jns.mean[name])
        _eq(tns.var[name], jns.var[name])
    for (n, k), g in tg.items():
        ref = np.asarray(jg[n][k])
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max() + 1e-30)


def test_forward_train_soft_path(net):
    """soft_alpha = 2: logits within rtol 1e-5 (tanh, float conv sums);
    gradients as close to the float64 gradient as the reference's own
    float32 gradient is (see the module docstring)."""
    (tl, tlg, _, tg), (jl, jlg, _, jg) = _value_and_grad(net, 2.0, False)
    _close(tlg, jlg, rtol=1e-5, atol=1e-6)
    _close(tl, jl, rtol=1e-6)

    def loss(p):
        lg, _ = jkws.forward_train(p, net["state"], net["x"], JCFG,
                                   soft_alpha=2.0)
        return jkws.cross_entropy(lg, jnp.asarray(net["y"]))

    with jax.enable_x64(True):
        as64 = lambda t: jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a), jnp.float64), t)
        g64 = jax.jit(jax.grad(
            lambda p, s, x: jkws.cross_entropy(jkws.forward_train(
                p, s, x, JCFG, soft_alpha=2.0)[0], jnp.asarray(net["y"]))))(
            as64(net["params"]), as64(net["state"]),
            jnp.asarray(net["x"], jnp.float64))
        g64 = _np_tree(g64)
    for (n, k), g in tg.items():
        truth = g64[n][k]
        scale = np.abs(truth).max()
        ref_err = np.abs(np.asarray(jg[n][k]) - truth).max()
        port_err = np.abs(g.numpy() - truth).max()
        assert port_err <= 2 * ref_err + 1e-6 * scale, (n, k)


def test_batch_statistics_mode(net):
    """bn_mode='batch': the batch mean is the reciprocal product, the
    variance jnp.var's; logits within rtol 1e-5 (the normalization's
    float sums), new running statistics within rtol 1e-5."""
    jcfg = jkws.KWSConfig(sample_len=600, bn_mode="batch")
    cfg = kws.KWSConfig(sample_len=600, bn_mode="batch")
    js = jkws.init_state(jcfg)
    jl, jns = jax.jit(lambda p, s, x: jkws.forward_train(p, s, x, jcfg))(
        net["params"], js, net["x"])
    tp, ts = kws.params_from_numpy(_np_tree(net["params"]), js, device="cpu")
    tl, tns = kws.forward_train(tp, ts, torch.tensor(net["x"]), cfg)
    _close(tl, jl, rtol=1e-5, atol=1e-6)
    for name in jns.mean:
        _close(tns.mean[name], jns.mean[name], rtol=1e-5, atol=1e-6)
        _close(tns.var[name], jns.var[name], rtol=1e-5, atol=1e-6)


def test_cross_entropy_and_accuracy():
    rng = np.random.default_rng(12)
    logits = (rng.normal(size=(7, 10)) * 3).astype(np.float32)
    logits[2, 4] = logits[2, 7] = logits[2].max() + 1     # argmax tie
    labels = rng.integers(0, 10, 7)
    labels[2] = 4
    _close(kws.cross_entropy(torch.tensor(logits), torch.tensor(labels)),
           jax.jit(jkws.cross_entropy)(logits, labels), rtol=1e-6)
    for lab in (labels, np.zeros(7, np.int64)):
        _eq(kws.accuracy(torch.tensor(logits), torch.tensor(lab)),
            jax.jit(jkws.accuracy)(logits, lab))
