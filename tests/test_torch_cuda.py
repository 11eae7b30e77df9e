"""The port's Hopper kernels on a card: ``imc_fused`` and the fused SGA
update (``sga_update_rows``, ``sga_update``) against their plain PyTorch
versions, bit for bit; one ``imc_fused`` launch per IMC layer on the
served paths, and one ``sga_update_rows`` launch per training round of
the customization sessions.

Every test here needs a CUDA device and skips without one (the CUDA kernel
has no CPU mode).  This file imports nothing of JAX, so it also runs on a
machine that has PyTorch and a card but no JAX:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.onchip_training import OnChipTrainConfig
from repro_torch.kernels.imc_mav import ops, ref
from repro_torch.kernels.sga_update import ops as sga_ops
from repro_torch.kernels.sga_update.ref import sga_update_ref
from repro_torch.models import kws
from repro_torch.serving import CustomizeConfig
from repro_torch.serving import customize as cz
from repro_torch.serving import stream as sv
from repro_torch.serving.scheduler import StreamServer
from repro_torch.serving.vad import VADConfig

from _sga_cases import sga_rows

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


@pytest.mark.parametrize("lrs", [[1 / 16], [1 / 16, 1 / 128],
                                 [1 / 16, 0.05, 1 / 32, 1 / 128, 0.03,
                                  1 / 64, 0.1, 1 / 8]],
                         ids=["B1", "B2", "B8"])
def test_sga_rows_kernel_matches_plain_version(dev, lrs):
    w, g, a, lr, g_th = (torch.tensor(v, device=dev)
                         for v in sga_rows(len(lrs), lrs))
    sga_ops.COUNTS_ROWS.reset()
    got = sga_ops.sga_update_batch(w, g, a, lr, g_th)
    want = sga_update_ref(w, g, a, lr[:, None], g_th[:, None])
    torch.cuda.synchronize()
    assert sga_ops.COUNTS_ROWS.launches == 1
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("lr", [1 / 16, 0.05, 1 / 128])
def test_sga_flat_kernel_matches_plain_version(dev, lr):
    w, g, a, _, g_th = sga_rows(9, [lr], n=5003)
    tree = lambda v: {"w": torch.tensor(v[0, :4000], device=dev),
                      "b": torch.tensor(v[0, 4000:], device=dev)}
    sga_ops.COUNTS_FLAT.reset()
    got = sga_ops.sga_update_tree(tree(w), tree(g), tree(a), lr,
                                  float(g_th[0]))
    torch.cuda.synchronize()
    assert sga_ops.COUNTS_FLAT.launches == 2
    for k in ("w", "b"):
        want = sga_update_ref(tree(w)[k], tree(g)[k], tree(a)[k],
                              torch.tensor(lr, device=dev),
                              torch.tensor(float(g_th[0]), device=dev))
        assert torch.equal(got[0][k], want[0])
        assert torch.equal(got[1][k], want[1])


def test_sga_kernel_rejects_mismatched_operands(dev):
    w, g, a, lr, g_th = (torch.tensor(v, device=dev)
                         for v in sga_rows(2, [1 / 16, 1 / 32], n=500))
    with pytest.raises(ValueError, match="float32"):
        sga_ops.sga_update_batch(w, g.double(), a, lr, g_th)
    with pytest.raises(ValueError, match="lr has shape"):
        sga_ops.sga_update_batch(w, g, a, lr[:1], g_th)


def test_sessions_launch_one_sga_update_per_round(dev, monkeypatch):
    """Two concurrent sessions on the card: one ``sga_update_rows``
    launch per training round, ``imc_fused`` still once per IMC layer and
    batched call, and the same results and events as the plain route and
    as the CPU path (``score`` within 1e-6 there)."""
    cfg = kws.KWSConfig(sample_len=L)
    hw = _hw(dev, cfg)
    rng = np.random.default_rng(4)
    live = rng.uniform(-1, 1, L + 50 * HOP).astype(np.float32)
    utts = [rng.uniform(-1, 1, L).astype(np.float32) for _ in range(6)]
    labels = [int(v) for v in rng.integers(0, cfg.num_classes, 6)]
    rounds = []
    update = cz.CustomizationManager._kernel_update

    def counted(self, sessions, grads):
        rounds.append(len(sessions))
        return update(self, sessions, grads)

    monkeypatch.setattr(cz.CustomizationManager, "_kernel_update", counted)

    def run(device, use_kernel):
        hw_d = hw if device == dev else _to_cpu(hw)
        srv = StreamServer(hw_d, cfg, hop=HOP, slots=9, vad=VADConfig(),
                           use_kernel=use_kernel, device=device)
        sessions = []
        for k, per_tick in enumerate((5, 3)):
            sess = srv.customize(f"user{k}", CustomizeConfig(
                train=OnChipTrainConfig(epochs=23), epochs_per_tick=per_tick,
                calib_sa_noise_std=0.0, use_kernel=use_kernel))
            for j in range(3):
                sess.enroll(labels[3 * k + j], utts[3 * k + j])
            sess.finish_enrollment()
            sessions.append(sess)
        srv.submit("live", live[:L])
        rounds.clear()
        ops.COUNTS.reset()
        sga_ops.COUNTS_ROWS.reset()
        events, pos = [], L
        for _ in range(200):
            if pos < len(live):
                srv.submit("live", live[pos:pos + HOP])
                pos += HOP
            events.extend(srv.step())
            if all(s.phase == "swapped" for s in sessions):
                break
        assert all(s.phase == "swapped" for s in sessions)
        return dict(events=events, stats=srv.stats(), rounds=list(rounds),
                    sga=sga_ops.COUNTS_ROWS.launches,
                    imc=ops.COUNTS.launches,
                    results=[s.result for s in sessions])

    kern, plain = run(dev, True), run(dev, False)
    cpu = run(torch.device("cpu"), True)
    assert kern["sga"] == len(kern["rounds"]) == len(cpu["rounds"])
    assert 23 <= kern["sga"] < 46 and 2 in kern["rounds"]
    assert plain["sga"] == 0 and plain["rounds"] == []
    calls = kern["stats"]["batched_calls"]
    assert kern["imc"] == 5 * (calls["init"] + calls["hop"]
                               + calls["replay"])
    assert kern["events"] == plain["events"]
    # the card and the CPU agree on every decision; the score's softmax
    # and smoothing round differently in the last ulp between devices
    strip = lambda evs: [{k: v for k, v in e.items() if k != "score"}
                         for e in evs]
    assert strip(kern["events"]) == strip(cpu["events"])
    np.testing.assert_allclose([e["score"] for e in kern["events"]],
                               [e["score"] for e in cpu["events"]], rtol=0,
                               atol=1e-6)
    for r_k, r_p, r_c in zip(kern["results"], plain["results"],
                             cpu["results"]):
        for r in (r_p, r_c):
            assert np.array_equal(r_k.fc_w, r.fc_w)
            assert np.array_equal(r_k.fc_b, r.fc_b)
            assert r_k.history == r.history
            for name in cfg.imc_layer_names():
                assert np.array_equal(r_k.bias[name], r.bias[name])


def _to_cpu(hw):
    return kws.PackedHWParams(
        hw=kws.HWParams(*[{k: v.cpu() for k, v in d.items()}
                          for d in (hw.hw.w_bin, hw.hw.bias, hw.hw.flip)],
                        fc_w=hw.hw.fc_w.cpu(), fc_b=hw.hw.fc_b.cpu()),
        packed={k: v.cpu() for k, v in hw.packed.items()})
