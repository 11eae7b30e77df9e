"""The port's Hopper kernel on a card: ``imc_fused`` against its plain
PyTorch version, bit for bit, and one launch per IMC layer on the served
paths.

Every test here needs a CUDA device and skips without one (the CUDA kernel
has no CPU mode).  This file imports nothing of JAX, so it also runs on a
machine that has PyTorch and a card but no JAX:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.imc_mav import ops, ref
from repro_torch.models import kws
from repro_torch.serving import stream as sv
from repro_torch.serving.scheduler import StreamServer
from repro_torch.serving.vad import VADConfig

pytestmark = pytest.mark.cuda

# (c_in, c_out, groups, stride, pool): conv1..conv5 of the paper net, and
# a stride-2 layer whose conv length leaves a pool remainder
LAYERS = [
    pytest.param(24, 96, 1, 1, 2, id="L2-g1-pool2"),
    pytest.param(96, 192, 4, 1, 2, id="L3-g4-pool2"),
    pytest.param(192, 288, 8, 1, 1, id="L4-g8-nopool"),
    pytest.param(288, 384, 12, 1, 2, id="L5-g12-pool2"),
    pytest.param(384, 576, 16, 1, 2, id="L6-g16-pool2"),
    pytest.param(48, 96, 2, 2, 2, id="stride2-odd"),
]
L, HOP = 640, 64


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _inputs(seed, b, t, c_in, c_out, groups, stride, dev):
    rng = np.random.default_rng(seed)
    pm1 = lambda *s: np.where(rng.random(s) < 0.5, 1.0, -1.0)
    t_out = (t - 3) // stride + 1
    arrays = (pm1(b, t, c_in), pm1(3, c_in // groups, c_out),
              np.round(rng.normal(size=c_out) * 8) * 2, pm1(c_out),
              4.0 * rng.normal(size=c_out),
              1.5 * rng.normal(size=(b, t_out, c_out)))
    return [torch.tensor(a, dtype=torch.float32, device=dev) for a in arrays]


@pytest.mark.parametrize("case", ["clean", "chip", "noise"])
@pytest.mark.parametrize("c_in,c_out,groups,stride,pool", LAYERS)
def test_kernel_matches_plain_version(dev, c_in, c_out, groups, stride, pool,
                                      case):
    x, w, bias, flip, off, noise = _inputs(c_out, 4, 301, c_in, c_out,
                                           groups, stride, dev)
    off = None if case == "clean" else off
    noise = noise if case == "noise" else None
    ops.COUNTS.reset()
    got = ops.fused_conv_mav(x, w, bias, flip, groups=groups, stride=stride,
                             pool=pool, chip_offset=off, sa_noise=noise)
    want = ref.fused_conv_mav_ref(x, w, bias, flip, groups=groups,
                                  stride=stride, pool=pool,
                                  chip_offset=off, sa_noise=noise)
    torch.cuda.synchronize()
    assert ops.COUNTS.launches == 1
    assert got.shape == want.shape and torch.equal(got, want)


def test_kernel_rejects_mismatched_operands(dev):
    x, w, bias, flip, off, noise = _inputs(1, 2, 40, 96, 192, 4, 1, dev)
    with pytest.raises(ValueError, match="float32"):
        ops.fused_conv_mav(x.double(), w, bias, flip, groups=4)
    with pytest.raises(ValueError, match="sa_noise has shape"):
        ops.fused_conv_mav(x, w, bias, flip, groups=4, sa_noise=noise[:, 1:])
    with pytest.raises(ValueError, match="does not match"):
        ops.fused_conv_mav(x, w, bias, flip, groups=2,
                           packed=ops.pack_weights(w, 4))


def _hw(dev, cfg):
    params = kws.init_params(torch.Generator().manual_seed(5), cfg,
                             device=dev)
    return kws.fold_params(params, kws.init_state(cfg, device=dev), cfg,
                           pack=True)


def test_hw_forward_launches_once_per_imc_layer(dev):
    cfg = kws.KWSConfig(sample_len=L)
    hw = _hw(dev, cfg)
    x = np.random.default_rng(1).uniform(-1, 1, (3, L))
    ops.COUNTS.reset()
    lk, fk = kws.hw_forward(hw, x, cfg, use_kernel=True, device=dev)
    assert ops.COUNTS.launches == cfg.num_conv_layers - 1
    lp, fp = kws.hw_forward(hw, x, cfg, use_kernel=False, device=dev)
    assert ops.COUNTS.launches == cfg.num_conv_layers - 1
    assert torch.equal(lk, lp) and torch.equal(fk, fp)


def test_stream_steps_launch_once_per_imc_layer(dev):
    cfg = kws.KWSConfig(sample_len=L)
    hw = _hw(dev, cfg)
    audio = torch.tensor(np.random.default_rng(2).uniform(-1, 1, (2, L + 5 * HOP)),
                         dtype=torch.float32, device=dev)
    engines = [sv.StreamEngine(hw, cfg, HOP, use_kernel=k, device=dev)
               for k in (True, False)]
    results = []
    for eng in engines:
        ops.COUNTS.reset()
        lg0, st = eng.init(audio[:, :L])
        lg1, st = eng.step(st, audio[:, L:L + HOP])
        lg4, st = eng.multi_step(st, audio[:, L + HOP:], 4)
        results.append((ops.COUNTS.launches, lg0, lg1, lg4, st))
    assert results[0][0] == 3 * (cfg.num_conv_layers - 1)
    assert results[1][0] == 0
    for a, b in zip(results[0][1:4], results[1][1:4]):
        assert torch.equal(a, b)
    st_k, st_p = results[0][4], results[1][4]
    for a, b in zip([st_k.audio_carry, *st_k.carries, st_k.ring],
                    [st_p.audio_carry, *st_p.carries, st_p.ring]):
        assert torch.equal(a, b)


def test_server_kernel_equals_plain_version(dev):
    cfg = kws.KWSConfig(sample_len=L)
    hw = _hw(dev, cfg)
    rng = np.random.default_rng(3)
    auds = []
    for _ in range(3):
        x = rng.uniform(-1, 1, L + 16 * HOP).astype(np.float32)
        x[L + 2 * HOP:L + 8 * HOP] *= 1e-4          # a silent run: gating
        auds.append(x)
    runs = []
    for use_kernel in (True, False):
        srv = StreamServer(hw, cfg, hop=HOP, slots=3, vad=VADConfig(),
                           use_kernel=use_kernel, device=dev)
        for i, x in enumerate(auds):
            srv.submit(f"s{i}", x)
            srv.finish(f"s{i}")
        ops.COUNTS.reset()
        events = srv.drain()
        runs.append((events, srv.stats(), ops.COUNTS.launches))
    (ev_k, st_k, n_k), (ev_p, _, n_p) = runs
    assert ev_k == ev_p and ev_k
    calls = st_k["batched_calls"]
    assert st_k["gated_hops"] > 0
    assert n_k == 5 * (calls["init"] + calls["hop"] + calls["replay"])
    assert n_p == 0
