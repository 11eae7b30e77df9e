"""The port's Hopper kernels on a card: ``imc_fused`` (on ±1 and on
{-1, 0, +1} activations, at every kind of block tile its launch plans and
at group widths off the paper's), the fused SGA update
(``sga_update_rows``, ``sga_update`` on whole trees in one launch,
ragged and misaligned leaves), the fused head training
(``head_train_rows``), the per-group product tile ``imc_mav`` (on ±1 and
{-1, 0, +1} operands, from unaligned bases, in K chunks) and
``int8_matmul`` (both of its plans, at the rails) against their plain
PyTorch versions, bit for bit; one
``imc_fused`` launch per IMC layer on the served paths (SA noise on too,
and at cpg 6 and 48), one ``imc_mav`` launch per conv group, one
``head_train_rows`` launch per training tick of the customization
sessions and one ``sga_update_rows`` launch per epoch of an RGP session;
the SA-noise field made on the card equal to the CPU's; the front door
on the card: the recompute server (``streaming=False``), the dynamic hop
on a noisy chip, autoscaling to 16 slots with a customized slot riding
the resizes, each kernel route equal to the plain one with one
``imc_fused`` launch per IMC layer and IMC forward, and K1 at the paper
net's hop-2048 and hop-4096 tails; a customization session on a noisy
chip equal on the kernel route, the plain route and the CPU; and the
self-healing chip: K1 on pre-sign operands holding stuck rails (±1e4)
and fractional drift at the hop-1024 tails, a faulted, noisy,
health-monitored server and the stuck-column and drift-heal scenarios,
each equal on the kernel route, the plain route and the CPU; the means
at their smallest ties (the T = 448 GAP at every GAP site, the N = 7 head
on both K2 routes) equal to the reference's values; and the float
learning path: ``forward_eval`` on the card equal to the CPU, its
unconstrained fold through K1, and a ``train_base`` step of the recovery
fine-tune on the card against the CPU; the hardware half of the learning
path: ``evaluate_hw`` / ``hw_features`` through K1 (clean, fresh SA
draws with a ragged chunk, a noise field) equal to the plain route and
the CPU, 5 launches a chunk; the serving telemetry: the launch
auditor's count of fused calls equal to K1's launches, and telemetry on
equal to off, on a gated, faulted, canary-monitored server; and crash
safety and scale-out: a card server's snapshot restored on the card
(10 more K1 launches for the recomputed canary expectation) and on the
CPU, and a fleet of two pools on the card equal to one server,
sequential and ``parallel=True``; the LM stack: the reduced servers on the
card against the CPU, the ``jaxrand`` parameter draw on the card bitwise
the CPU's, one train step on the card against the CPU, and a training run
resumed from its checkpoint against the straight run; and the launch code
on a world-1 NCCL group: the sharded train, prefill and decode steps on a
1 x 1 mesh bit for bit the plain ones, and the int8 compressed mean on
NCCL bit for bit the same function on gloo on the CPU.

Every test here needs a CUDA device and skips without one (the CUDA kernel
has no CPU mode).  This file imports nothing of JAX, so it also runs on a
machine that has PyTorch and a card but no JAX:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py
"""

import collections

import numpy as np
import pytest
import torch

from repro_torch.core import imc, jaxrand, sa_noise
from repro_torch.core import onchip_training as ot
from repro_torch.core.onchip_training import OnChipTrainConfig
from repro_torch.kernels.imc_mav import ops, ref
from repro_torch.kernels.int8_matmul import ops as i8_ops
from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref
from repro_torch.kernels.sga_update import ops as sga_ops
from repro_torch.kernels.sga_update import ref as sga_ref
from repro_torch.kernels.sga_update.ref import sga_update_ref
from repro_torch.models import kws
from repro_torch.serving import CompiledTickConfig, CustomizeConfig
from repro_torch.serving import stream as sv
from repro_torch.serving.scheduler import StreamServer
from repro_torch.serving.vad import VADConfig

from _mean_cases import (GAP_FEAT0, HEAD_GW10, gap_head, gap_tie_ring,
                         head_tie_case)
from _sga_cases import head_rows, sga_rows

pytestmark = pytest.mark.cuda

SgaPair = collections.namedtuple("SgaPair", "w b")

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


def _inputs(seed, b, t, c_in, c_out, groups, stride, dev, kind="pm1"):
    """x ±1 (``pm1``), in {-1, 0, +1} (``ternary``) or ±1 with streams 0
    and 2 all zero (``zero_streams``, the carries of free slots); w ±1;
    biases, flips, chip offsets and a pre-sign noise operand."""
    rng = np.random.default_rng(seed)
    pm1 = lambda *s: np.where(rng.random(s) < 0.5, 1.0, -1.0)
    t_out = (t - 3) // stride + 1
    x = pm1(b, t, c_in)
    if kind == "ternary":
        x = rng.integers(-1, 2, (b, t, c_in)).astype(np.float64)
    elif kind == "zero_streams":
        x[0] = x[2] = 0.0
    arrays = (x, pm1(3, c_in // groups, c_out),
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


@pytest.mark.parametrize("kind", ["zero_streams", "ternary"])
@pytest.mark.parametrize("case", ["clean", "chip", "noise"])
@pytest.mark.parametrize("c_in,c_out,groups,stride,pool", LAYERS)
def test_kernel_matches_plain_version_on_zero_carries(dev, c_in, c_out,
                                                      groups, stride, pool,
                                                      case, kind):
    """The kernel is exact on x in {-1, 0, +1}: whole streams of zeros (the
    carries of free slots) and mixed ternary rows, through the fold-time
    int8 weights and through weights packed on the call."""
    x, w, bias, flip, off, noise = _inputs(c_out + 7, 4, 301, c_in, c_out,
                                           groups, stride, dev, kind)
    off = None if case == "clean" else off
    noise = noise if case == "noise" else None
    want = ref.fused_conv_mav_ref(x, w, bias, flip, groups=groups,
                                  stride=stride, pool=pool,
                                  chip_offset=off, sa_noise=noise)
    for packed in (ops.pack_weights_s8(w, groups), None):
        got = ops.fused_conv_mav(x, w, bias, flip, groups=groups,
                                 stride=stride, pool=pool, chip_offset=off,
                                 sa_noise=noise, packed=packed)
        torch.cuda.synchronize()
        assert got.shape == want.shape and torch.equal(got, want)


# (c_in, c_out, groups, stride, pool, B, T) -> the block tile (pooled
# columns, groups) the launch plans on a 132-SM H100: every column tile,
# one group, a part of the groups and all of them, tiles past the columns
# and ragged ones, a stride-2 layer whose conv length leaves a pool
# remainder
PLANNED_TILES = [
    pytest.param((24, 96, 1, 1, 2, 4, 20), (16, 1), id="16x1-past-columns"),
    pytest.param((192, 288, 8, 1, 1, 8, 118), (16, 2), id="16x2of8-nopool"),
    pytest.param((96, 192, 4, 1, 2, 4, 2000), (16, 4), id="16x4of4"),
    pytest.param((288, 384, 12, 1, 2, 8, 301), (16, 3), id="16x3of12"),
    pytest.param((192, 288, 8, 1, 1, 8, 104), (32, 1), id="32x1"),
    pytest.param((192, 288, 8, 1, 1, 8, 230), (32, 2), id="32x2of8"),
    pytest.param((384, 576, 16, 1, 2, 8, 1200), (32, 8), id="32x8of16"),
    pytest.param((192, 288, 8, 1, 1, 8, 2000), (64, 8), id="64x8of8"),
    pytest.param((24, 96, 1, 1, 2, 4, 7944), (64, 1), id="64x1"),
    pytest.param((24, 96, 1, 1, 2, 4, 15882), (128, 1), id="128x1"),
    pytest.param((48, 96, 2, 2, 2, 8, 15883), (128, 2),
                 id="128x2of2-stride2-odd"),
]


@pytest.mark.parametrize("shape,tile", PLANNED_TILES)
def test_kernel_matches_plain_version_at_each_planned_tile(dev, shape, tile):
    """Shapes at which the launch plans each kind of block tile give the
    plain version's result (zero streams, offsets and noise on)."""
    c_in, c_out, groups, stride, pool, b, t = shape
    if ops._sm_count(dev) != 132:
        pytest.skip("the planned tiles listed are a 132-SM card's")
    x, w, bias, flip, off, noise = _inputs(c_out + t, b, t, c_in, c_out,
                                           groups, stride, dev,
                                           "zero_streams")
    t_pool = ((t - 3) // stride + 1) // pool
    assert ops.block_tile(b, t_pool, groups, c_out // groups, 3, stride,
                          pool, dev)[:2] == tile
    got = ops.fused_conv_mav(x, w, bias, flip, groups=groups, stride=stride,
                             pool=pool, chip_offset=off, sa_noise=noise)
    want = ref.fused_conv_mav_ref(x, w, bias, flip, groups=groups,
                                  stride=stride, pool=pool, chip_offset=off,
                                  sa_noise=noise)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("hop", [1024, 64])
def test_block_tiles_fill_the_card(dev, hop):
    """The block tile of every paper layer at B = 8 fits the shared-memory
    budget; a full window fills at least one wave of the card's SMs, and
    a hop tail gets at least as many blocks as the one-group, 16-column
    tile gives (up to the plan's 1.9 blocks per SM)."""
    cfg = kws.PAPER_KWS
    sms = ops._sm_count(dev)
    geom = sv.make_stream_geometry(cfg, hop)
    for i in range(1, cfg.num_conv_layers):
        groups, pool = cfg.groups(i), cfg.pools[i]
        cog = cfg.channels[i] // groups
        for t, full in ((geom.layers[i].t_in, True),
                        (geom.layers[i].tail_in, False)):
            t_pool = ((t - 3) + 1) // pool
            pt, gc, nbytes = ops.block_tile(8, t_pool, groups, cog, 3, 1,
                                            pool, dev)
            assert pt % 16 == 0 and groups % gc == 0
            assert 0 < nbytes <= 72 * 1024
            blocks = 8 * -(-t_pool // pt) * (groups // gc)
            assert blocks >= min(8 * -(-t_pool // 16) * groups, 1.9 * sms)
            if full:
                assert blocks >= sms


# (c_in, c_out, groups): group widths off the paper's cpg 24 (cpg 6, 18,
# 40, 48: two int8 k-steps a tap; cog 9, 18, 48), and the IMC layers of
# KWSConfig(channels_per_group=6) and of the cpg-48 net
GROUP_WIDTHS = [
    pytest.param(24, 36, 4, id="cpg6-cog9"),
    pytest.param(36, 48, 2, id="cpg18"),
    pytest.param(96, 72, 4, id="cog18"),
    pytest.param(80, 96, 2, id="cpg40"),
    pytest.param(80, 36, 2, id="cpg40-cog18"),
    pytest.param(96, 18, 2, id="cpg48-cog9"),
    pytest.param(24, 96, 4, id="cpg6-L2"), pytest.param(96, 192, 16,
                                                        id="cpg6-L3"),
    pytest.param(192, 288, 32, id="cpg6-L4"),
    pytest.param(288, 384, 48, id="cpg6-L5"),
    pytest.param(384, 576, 64, id="cpg6-L6"),
    pytest.param(48, 96, 1, id="cpg48-L2"), pytest.param(96, 192, 2,
                                                         id="cpg48-L3"),
    pytest.param(192, 288, 4, id="cpg48-L4"),
    pytest.param(288, 384, 6, id="cpg48-L5"),
    pytest.param(384, 576, 8, id="cpg48-L6"),
]


@pytest.mark.parametrize("kind", ["pm1", "zero_streams", "ternary"])
@pytest.mark.parametrize("c_in,c_out,groups", GROUP_WIDTHS)
def test_kernel_matches_plain_version_at_group_widths(dev, c_in, c_out,
                                                      groups, kind):
    """Any cpg and cog that divide the layer: one launch, the plain
    version's result, on ±1, zero-stream and ternary rows, without and
    with offsets and noise, on a full-window and a hop-tail length."""
    for t in (301, 9):
        x, w, bias, flip, off, noise = _inputs(c_out + t, 4, t, c_in, c_out,
                                               groups, 1, dev, kind)
        for o, n in ((None, None), (off, None), (off, noise)):
            ops.COUNTS.reset()
            got = ops.fused_conv_mav(x, w, bias, flip, groups=groups, pool=2,
                                     chip_offset=o, sa_noise=n)
            want = ref.fused_conv_mav_ref(x, w, bias, flip, groups=groups,
                                          pool=2, chip_offset=o, sa_noise=n)
            torch.cuda.synchronize()
            assert ops.COUNTS.launches == 1
            assert torch.equal(got, want), (t, o is None, n is None)


def test_kernel_rejects_group_widths_it_does_not_take(dev):
    """The wrapper refuses only a layer whose smallest block tile needs
    more shared memory than a block of the card has: here a group of 4096
    outputs, whose int8 rows alone pass it; wide groups that fit the card
    but not the planner's 72 KB budget launch."""
    x, w, bias, flip, _, _ = _inputs(1, 2, 40, 32, 4096, 1, 1, dev)
    ops.COUNTS.reset()
    with pytest.raises(ValueError, match="no block tile"):
        ops.fused_conv_mav(x, w, bias, flip, groups=1)
    assert ops.COUNTS.launches == 0
    x, w, bias, flip, _, _ = _inputs(1, 2, 40, 32, 1024, 1, 1, dev)
    assert ops.block_tile(2, 19, 1, 1024, 3, 1, 2, dev)[2] > 72 * 1024
    got = ops.fused_conv_mav(x, w, bias, flip, groups=1, pool=2)
    assert torch.equal(got, ref.fused_conv_mav_ref(x, w, bias, flip,
                                                   groups=1, pool=2))


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
    params = kws.init_params(jaxrand.PRNGKey(5, device="cpu"), cfg,
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


@pytest.mark.parametrize("kw", [
    dict(channels_per_group=6),
    dict(channels=(48, 96, 192, 288, 384, 576), channels_per_group=48)],
    ids=["cpg6", "cpg48"])
def test_server_kernel_equals_plain_version_at_group_widths(dev, kw):
    """The nets of cpg 6 and 48 serve on the card: the kernel and plain
    routes give the same events and state leaves, one ``imc_fused`` launch
    per IMC layer and batched call."""
    cfg = kws.KWSConfig(sample_len=L, **kw)
    hw = _hw(dev, cfg)
    rng = np.random.default_rng(13)
    auds = []
    for _ in range(3):
        x = rng.uniform(-1, 1, L + 12 * HOP).astype(np.float32)
        x[L + 2 * HOP:L + 7 * HOP] *= 1e-4
        auds.append(x)
    runs = []
    for use_kernel in (True, False):
        srv = StreamServer(hw, cfg, hop=HOP, slots=2, vad=VADConfig(),
                           use_kernel=use_kernel, device=dev)
        for i, x in enumerate(auds):
            srv.submit(f"s{i}", x)
            srv.finish(f"s{i}")
        ops.COUNTS.reset()
        events = srv.drain()
        runs.append((events, srv.stats(), ops.COUNTS.launches, srv))
    (ev_k, st_k, n_k, srv_k), (ev_p, _, n_p, srv_p) = runs
    assert ev_k == ev_p and ev_k
    st_a, st_b = srv_k._state, srv_p._state
    for a, b in zip([st_a.audio_carry, *st_a.carries, st_a.ring, st_a.hop],
                    [st_b.audio_carry, *st_b.carries, st_b.ring, st_b.hop]):
        assert torch.equal(a, b)
    calls = st_k["batched_calls"]
    assert st_k["gated_hops"] > 0 and calls["replay"] > 0
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
    """A two-leaf tree in one K3 launch (one launch a tree since the flat
    entry takes every leaf of a tree at once)."""
    w, g, a, _, g_th = sga_rows(9, [lr], n=5003)
    tree = lambda v: {"w": torch.tensor(v[0, :4000], device=dev),
                      "b": torch.tensor(v[0, 4000:], device=dev)}
    sga_ops.COUNTS_FLAT.reset()
    got = sga_ops.sga_update_tree(tree(w), tree(g), tree(a), lr,
                                  float(g_th[0]))
    torch.cuda.synchronize()
    assert sga_ops.COUNTS_FLAT.launches == 1
    for k in ("w", "b"):
        want = sga_update_ref(tree(w)[k], tree(g)[k], tree(a)[k],
                              torch.tensor(lr, device=dev),
                              torch.tensor(float(g_th[0]), device=dev))
        assert torch.equal(got[0][k], want[0])
        assert torch.equal(got[1][k], want[1])


RAGGED = (1, 3, 1023, 1025, 5770)


def _ragged_tree(v, dev, offset=0):
    """Leaves of ``RAGGED`` sizes cut from row 0 of ``v`` in nested dicts,
    a list and a namedtuple; with ``offset`` 1 each leaf a view 4 bytes
    into its own allocation."""
    leaves, i = [], 0
    for n in RAGGED:
        buf = torch.tensor(v[0, i:i + n + offset], device=dev)
        leaves.append(buf[offset:])
        i += n + offset
    return {"fc": SgaPair(leaves[0], leaves[1]),
            "convs": [leaves[2], {"w": leaves[3].reshape(1, -1)}],
            "head": leaves[4].reshape(577, 10)}


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "view-4B"])
@pytest.mark.parametrize("lr", [1 / 16, 0.05])
def test_sga_tree_kernel_one_launch_on_ragged_trees(dev, lr, offset):
    """Ragged leaves (1 to 5770 elements) with the tie cases of
    ``sga_rows`` in one launch, bitwise the plain version leaf by leaf, on
    leaves of their own allocations and on views at a 4-byte offset into
    them (read in place)."""
    w, g, a, _, g_th = sga_rows(11, [lr], n=sum(RAGGED) + len(RAGGED))
    trees = [_ragged_tree(v, dev, offset) for v in (w, g, a)]
    leaves = [sga_ops._flatten(t)[0] for t in trees]
    if offset:
        assert all(v.data_ptr() % 16 == 4 for v in leaves[0])
    sga_ops.COUNTS_FLAT.reset()
    got_w, got_a = sga_ops.sga_update_tree(*trees, lr, float(g_th[0]))
    torch.cuda.synchronize()
    assert sga_ops.COUNTS_FLAT.launches == 1
    assert isinstance(got_w["fc"], SgaPair)
    lr_t = torch.tensor(lr, device=dev)
    th_t = torch.tensor(float(g_th[0]), device=dev)
    for lw, lg, la, nw, na in zip(*leaves, sga_ops._flatten(got_w)[0],
                                  sga_ops._flatten(got_a)[0]):
        pw, pa = sga_update_ref(lw, lg, la, lr_t, th_t)
        assert nw.shape == lw.shape
        assert torch.equal(nw, pw) and torch.equal(na, pa)


def test_sga_tree_kernel_splits_only_past_its_leaf_table(dev):
    """64 leaves in one launch, 65 in two; empty leaves launch nothing."""
    assert sga_ops.library().sga_update_tree_max_leaves() == \
        sga_ops.TREE_MAX_LEAVES
    w, g, a, _, g_th = sga_rows(12, [1 / 32], n=65 * 40)
    for n_leaves, launches in ((64, 1), (65, 2)):
        tree = [[torch.tensor(v[0, 40 * i:40 * i + 13 + i % 27], device=dev)
                 for i in range(n_leaves)] for v in (w, g, a)]
        sga_ops.COUNTS_FLAT.reset()
        got_w, got_a = sga_ops.sga_update_tree(*tree, 1 / 32,
                                               float(g_th[0]))
        torch.cuda.synchronize()
        assert sga_ops.COUNTS_FLAT.launches == launches
        for lw, lg, la, nw, na in zip(*tree, got_w, got_a):
            pw, pa = sga_update_ref(lw, lg, la, torch.tensor(1 / 32,
                                                             device=dev),
                                    torch.tensor(float(g_th[0]),
                                                 device=dev))
            assert torch.equal(nw, pw) and torch.equal(na, pa)
    empty = [torch.zeros(0, device=dev)]
    sga_ops.COUNTS_FLAT.reset()
    nw, na = sga_ops.sga_update_tree(empty, empty, empty, 1 / 32, 0.25)
    assert sga_ops.COUNTS_FLAT.launches == 0 and nw[0].shape == (0,)


def test_sga_tree_on_two_devices_raises(dev):
    """A tree whose leaves lie on the card and on the CPU is refused: a
    CUDA leaf never runs the plain version."""
    w = {"a": torch.zeros(8, device=dev), "b": torch.zeros(8)}
    with pytest.raises(ValueError, match="more than one device"):
        sga_ops.sga_update_tree(w, w, w, 1 / 16, 0.0625)


def test_sga_kernel_rejects_mismatched_operands(dev):
    w, g, a, lr, g_th = (torch.tensor(v, device=dev)
                         for v in sga_rows(2, [1 / 16, 1 / 32], n=500))
    with pytest.raises(ValueError, match="float32"):
        sga_ops.sga_update_batch(w, g.double(), a, lr, g_th)
    with pytest.raises(ValueError, match="lr has shape"):
        sga_ops.sga_update_batch(w, g, a, lr[:1], g_th)


def test_sessions_launch_one_sga_update_per_round(dev, monkeypatch):
    """Two concurrent sessions on the card: one ``head_train_rows`` launch
    per training tick for both rows, no per-epoch ``sga_update_rows``,
    ``imc_fused`` still once per IMC layer and batched call, and the same
    results and events as the plain route and as the CPU path (``score``
    within 1e-6 there)."""
    cfg = kws.KWSConfig(sample_len=L)
    hw = _hw(dev, cfg)
    rng = np.random.default_rng(4)
    live = rng.uniform(-1, 1, L + 50 * HOP).astype(np.float32)
    utts = [rng.uniform(-1, 1, L).astype(np.float32) for _ in range(6)]
    labels = [int(v) for v in rng.integers(0, cfg.num_classes, 6)]
    ticks = []
    fused = sga_ops.head_train_batch

    def counted(w, *args):
        ticks.append(len(w))
        return fused(w, *args)

    monkeypatch.setattr(sga_ops, "head_train_batch", counted)

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
        ticks.clear()
        ops.COUNTS.reset()
        sga_ops.COUNTS_ROWS.reset()
        sga_ops.COUNTS_HEAD.reset()
        events, pos = [], L
        for _ in range(200):
            if pos < len(live):
                srv.submit("live", live[pos:pos + HOP])
                pos += HOP
            events.extend(srv.step())
            if all(s.phase == "swapped" for s in sessions):
                break
        assert all(s.phase == "swapped" for s in sessions)
        return dict(events=events, stats=srv.stats(), ticks=list(ticks),
                    head=sga_ops.COUNTS_HEAD.launches,
                    rows=sga_ops.COUNTS_ROWS.launches,
                    imc=ops.COUNTS.launches,
                    results=[s.result for s in sessions])

    kern, plain = run(dev, True), run(dev, False)
    cpu = run(torch.device("cpu"), True)
    assert kern["head"] == len(kern["ticks"]) == len(cpu["ticks"])
    assert kern["rows"] == 0 and 2 in kern["ticks"]
    assert 23 // 5 <= kern["head"] < 23
    assert plain["head"] == plain["rows"] == 0 and plain["ticks"] == []
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


def test_rgp_session_takes_one_sga_update_per_epoch(dev):
    """An RGP session on the card trains epoch by epoch: one
    ``sga_update_rows`` launch per epoch and no fused launch; its head
    equals the plain route's and the CPU path's (the noise drawn through
    ``core.jaxrand`` on the card equals the CPU's)."""
    cfg = kws.KWSConfig(sample_len=L)
    hw = _hw(dev, cfg)
    rng = np.random.default_rng(8)
    utts = [rng.uniform(-1, 1, L).astype(np.float32) for _ in range(3)]
    labels = [int(v) for v in rng.integers(0, cfg.num_classes, 3)]
    results = []
    for device, use_kernel in ((dev, True), (dev, False), ("cpu", True)):
        srv = StreamServer(hw if device == dev else _to_cpu(hw), cfg,
                           hop=HOP, slots=2, device=device)
        sess = srv.customize("user", CustomizeConfig(
            train=OnChipTrainConfig(epochs=12, rgp=True, seed=3),
            epochs_per_tick=5, compensate=False, use_kernel=use_kernel))
        for lab, u in zip(labels, utts):
            sess.enroll(lab, u)
        sess.finish_enrollment()
        sga_ops.COUNTS_ROWS.reset()
        sga_ops.COUNTS_HEAD.reset()
        for _ in range(60):
            srv.step()
            if sess.phase == "swapped":
                break
        assert sess.phase == "swapped"
        results.append((sess.result, sga_ops.COUNTS_ROWS.launches,
                        sga_ops.COUNTS_HEAD.launches))
    (r_k, n_k, h_k), (r_p, n_p, h_p), (r_c, _, _) = results
    assert (n_k, h_k, n_p, h_p) == (12, 0, 0, 0)
    for r in (r_p, r_c):
        assert np.array_equal(r_k.fc_w, r.fc_w)
        assert np.array_equal(r_k.fc_b, r.fc_b)


@pytest.mark.parametrize("mode,max_exponent", [("ceil", None),
                                               ("floor", None),
                                               ("ceil", 2)])
def test_head_train_exponent_on_every_grid_value(dev, mode, max_exponent):
    """The fused kernel's Eq (2) exponent, read from the quotient's bits,
    equals the CPU's ``error_scale_exponent`` on all 257 values k / 256."""
    grid = torch.arange(257, dtype=torch.float32) / 256.0
    got = sga_ops.head_error_exponent(grid.to(dev), mode, max_exponent)
    from repro_torch.core import quantize
    want = [int(quantize.error_scale_exponent(v[None], mode, max_exponent))
            for v in grid]
    assert got.tolist() == want


def _head_inputs(dev, ns, seed):
    rows = head_rows(seed, ns)
    return {k: [torch.tensor(r[k], device=dev) for r in rows]
            for k in ("w", "b", "aw", "ab", "f", "onehot")}


@pytest.mark.parametrize("scaling", [
    dict(fixed_error_scale=1.375), dict(), dict(error_scale_mode="floor",
                                                error_scale_max_exponent=3),
    dict(error_scaling=False)], ids=["fixed", "ceil", "floor-max3", "none"])
@pytest.mark.parametrize("b", [1, 2, 3, 8])
@pytest.mark.parametrize("n", [1, 10, 64])
def test_head_train_kernel_matches_plain_version(dev, b, n, scaling):
    """B session rows of N utterances at the paper head (576 x 10), each
    from its own epoch with its own budget, in one launch: the state the
    plain version reaches, bitwise (row 0 holds a softmax tie)."""
    starts = [(0, 13, 35, 190, 7, 99, 41, 3)[i] for i in range(b)]
    budgets = [(10, 7, 10, 10, 1, 4, 0, 9)[i] for i in range(b)]
    ns = [n if i % 2 == 0 else max(1, n - 3) for i in range(b)]
    spec = ot.head_train_spec(OnChipTrainConfig(**scaling))
    got, want = (_head_inputs(dev, ns, 100 * b + n) for _ in range(2))
    args = lambda t: (t["w"], t["b"], t["aw"], t["ab"], t["f"], t["onehot"],
                      starts, budgets, ot.train_lut(dev), spec)
    sga_ops.COUNTS_HEAD.reset()
    sga_ops.head_train_batch(*args(got))
    assert sga_ops.COUNTS_HEAD.launches == 1
    sga_ref.head_train_rows_ref(*args(want))
    torch.cuda.synchronize()
    for k in ("w", "b", "aw", "ab"):
        for x, y in zip(got[k], want[k]):
            assert torch.equal(x, y), k


def test_head_train_launches_per_row_chunk(dev):
    """More rows than one launch's parameters hold: one launch per
    ``HEAD_MAX_ROWS`` rows, each row still the plain version's; the
    Python constants agree with the source."""
    lib = sga_ops.library()
    assert lib.head_train_max_rows() == sga_ops.HEAD_MAX_ROWS
    assert lib.head_train_smem(576, 10, 64) == sga_ops.head_train_smem(
        576, 10, 64)
    b = sga_ops.HEAD_MAX_ROWS + 3
    spec = ot.head_train_spec(OnChipTrainConfig())
    got, want = (_head_inputs(dev, [4] * b, 7) for _ in range(2))
    args = lambda t: (t["w"], t["b"], t["aw"], t["ab"], t["f"], t["onehot"],
                      list(range(b)), [2] * b, ot.train_lut(dev), spec)
    sga_ops.COUNTS_HEAD.reset()
    sga_ops.head_train_batch(*args(got))
    assert sga_ops.COUNTS_HEAD.launches == 2
    sga_ref.head_train_rows_ref(*args(want))
    torch.cuda.synchronize()
    for k in ("w", "b", "aw", "ab"):
        for x, y in zip(got[k], want[k]):
            assert torch.equal(x, y), k


def test_head_train_rejects_what_it_cannot_update_in_place(dev):
    t = _head_inputs(dev, [3], 1)
    spec = ot.head_train_spec(OnChipTrainConfig())
    lut = ot.train_lut(dev)
    with pytest.raises(ValueError, match="contiguous"):
        sga_ops.head_train_batch([t["w"][0].t().contiguous().t()], t["b"],
                                 t["aw"], t["ab"], t["f"], t["onehot"], [0],
                                 [1], lut, spec)
    with pytest.raises(ValueError, match="float32"):
        sga_ops.head_train_batch([t["w"][0].double()], t["b"], t["aw"],
                                 t["ab"], t["f"], t["onehot"], [0], [1], lut,
                                 spec)


def _to_cpu(hw):
    return kws.PackedHWParams(
        hw=kws.HWParams(*[{k: v.cpu() for k, v in d.items()}
                          for d in (hw.hw.w_bin, hw.hw.bias, hw.hw.flip)],
                        fc_w=hw.hw.fc_w.cpu(), fc_b=hw.hw.fc_b.cpu()),
        packed={k: v.cpu() for k, v in hw.packed.items()})


# -- K5: the per-group product tile -----------------------------------------


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noise"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(64, 72, 24), (300, 72, 96),
                                   (257, 48, 130), (512, 128, 576),
                                   (1, 5, 1), (31960, 72, 96)])
def test_imc_mav_kernel_matches_plain_version(dev, m, k, n, dtype, noisy):
    rng = np.random.default_rng(m + k + n)
    pm1 = lambda *s: torch.tensor(np.where(rng.random(s) < 0.5, 1.0, -1.0),
                                  dtype=torch.float32, device=dev)
    x, w, flip = pm1(m, k).to(dtype), pm1(k, n).to(dtype), pm1(n)
    bias = torch.tensor(np.round(rng.normal(size=n) * 10) * 2,
                        dtype=torch.float32, device=dev)
    noise = (torch.tensor(4.0 * rng.normal(size=(m, n)), dtype=torch.float32,
                          device=dev) if noisy else None)
    ops.COUNTS_MAV.reset()
    got = ops.mav_matmul(x, w, bias, flip, noise)
    want = ref.imc_mav_ref(x, w, bias, flip, noise)
    torch.cuda.synchronize()
    assert ops.COUNTS_MAV.launches == 1
    assert got.dtype == dtype and torch.equal(got, want)


def _ternary(gen, shape, dtype, dev):
    return (torch.randint(-1, 2, shape, generator=gen, device=dev)
            .to(dtype))


def _mav_operands(gen, m, k, n, dtype, dev, noisy):
    x, w = _ternary(gen, (m, k), dtype, dev), _ternary(gen, (k, n), dtype,
                                                         dev)
    flip = _ternary(gen, (n,), torch.float32, dev).sign()
    flip[flip == 0] = 1.0
    bias = torch.round(torch.randn(n, generator=gen, device=dev) * 4) * 2
    noise = (4.0 * torch.randn((m, n), generator=gen, device=dev)
             if noisy else None)
    return x, w, bias, flip, noise


def _mav_check(x, w, bias, flip, noise):
    ops.COUNTS_MAV.reset()
    got = ops.mav_matmul(x, w, bias, flip, noise)
    want = ref.imc_mav_ref(x, w, bias, flip, noise)
    torch.cuda.synchronize()
    assert ops.COUNTS_MAV.launches == 1
    assert got.dtype == x.dtype and torch.equal(got, want), (
        f"{(got != want).sum().item()} of {got.numel()} outputs differ")


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noise"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 36, 96, 129, 576])
@pytest.mark.parametrize("k", [5, 33, 72, 128, 200])
@pytest.mark.parametrize("m", [1, 17, 3952, 31960])
def test_imc_mav_kernel_matches_plain_version_on_ternary(dev, m, k, n, dtype,
                                                         noisy):
    """x and w in {-1, 0, +1} (the kernel's int8 contract) at ragged and
    full-width shapes, noise with N % 4 != 0 included."""
    gen = torch.Generator(device=dev).manual_seed(m * 1009 + k * 31 + n)
    _mav_check(*_mav_operands(gen, m, k, n, dtype, dev, noisy))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(3952, 72, 36), (257, 5, 96),
                                   (31960, 72, 96)])
def test_imc_mav_kernel_on_an_unaligned_base(dev, m, k, n, dtype):
    """x as rows of a larger tensor starting one value past a 16-byte
    boundary: contiguous, so the wrapper passes it as it is."""
    gen = torch.Generator(device=dev).manual_seed(k)
    x, w, bias, flip, noise = _mav_operands(gen, m, k, n, dtype, dev, True)
    base = torch.empty(m * k + 1, dtype=dtype, device=dev)
    base[1:] = x.reshape(-1)
    xu = base[1:].view(m, k)
    assert xu.is_contiguous() and xu.data_ptr() % 16
    _mav_check(xu, w, bias, flip, noise)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(300, 257, 40), (64, 1000, 129),
                                   (17, 600, 576)])
def test_imc_mav_kernel_stages_long_fan_ins_in_chunks(dev, m, k, n, dtype):
    gen = torch.Generator(device=dev).manual_seed(k + n)
    _mav_check(*_mav_operands(gen, m, k, n, dtype, dev, True))


@pytest.mark.parametrize("m,k,n", [(31960, 72, 96), (15960, 72, 48),
                                   (7960, 72, 36), (7944, 72, 32),
                                   (3952, 72, 36), (1, 5, 1),
                                   (31960, 200, 576), (64, 1000, 129)])
def test_imc_mav_row_tiles_follow_the_plan(dev, m, k, n):
    """The per-group shapes of the paper net (B = 8, full window) and wide
    ones: the planned grid has a block for at least every other SM, or the
    smallest row tile, and two blocks fit an SM's shared memory."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows, chunks, nbytes = ops.mav_tile(m, k, n, dev)
    assert rows in (16, 32, 64, 128) and chunks == -(-n // 128)
    assert 2 * -(-m // rows) * chunks >= sms or rows == 16
    assert 0 < nbytes <= 110 * 1024


@pytest.mark.parametrize("std", [0.0, 1.0])
def test_conv_mav_launches_once_per_group(dev, std):
    x, w, bias, flip, _, _ = _inputs(7, 2, 80, 192, 288, 8, 1, dev)
    key = jaxrand.PRNGKey(3, device=dev)
    ops.COUNTS_MAV.reset()
    got = ops.conv_mav(x, w, bias, flip, groups=8, sa_key=key,
                       sa_noise_std=std)
    assert ops.COUNTS_MAV.launches == 8
    cpu = ops.conv_mav(x.cpu(), w.cpu(), bias.cpu(), flip.cpu(), groups=8,
                       sa_key=key.cpu(), sa_noise_std=std)
    assert torch.equal(got.cpu(), cpu)


# -- K4: the int8 FC datapath ------------------------------------------------


@pytest.mark.parametrize("shift", [0, 4, 7])
@pytest.mark.parametrize("m,k,n", [(512, 128, 128), (8, 576, 10),
                                   (37, 50, 11), (256, 576, 128)])
def test_int8_kernel_matches_plain_version(dev, m, k, n, shift):
    rng = np.random.default_rng(m * k + n + shift)
    x = torch.tensor(rng.integers(-128, 128, (m, k)), dtype=torch.int8,
                     device=dev)
    w = torch.tensor(rng.integers(-128, 128, (k, n)), dtype=torch.int8,
                     device=dev)
    b = torch.tensor(rng.integers(-2 ** 16, 2 ** 16, n), dtype=torch.int32,
                     device=dev)
    i8_ops.COUNTS.reset()
    got = i8_ops.int8_matmul(x, w, b, shift=shift)
    want = int8_matmul_ref(x, w, b, shift=shift)
    torch.cuda.synchronize()
    assert i8_ops.COUNTS.launches == 1
    assert got.dtype == torch.int8 and torch.equal(got, want)


@pytest.mark.parametrize("shift", [0, 4, 7])
def test_int8_kernel_saturates_and_wraps(dev, shift):
    """Operands at -128 and 127, biases near the int32 ends (the adds
    wrap), a saturating ``out_max`` below 127."""
    rng = np.random.default_rng(shift)
    x = torch.tensor(rng.choice([-128, 127], (40, 64)), dtype=torch.int8,
                     device=dev)
    w = torch.tensor(rng.choice([-128, 127], (64, 24)), dtype=torch.int8,
                     device=dev)
    b = torch.tensor(np.concatenate([np.full(8, 2 ** 31 - 51),
                                     np.full(8, -2 ** 31),
                                     rng.integers(-2 ** 20, 2 ** 20, 8)]),
                     dtype=torch.int32, device=dev)
    for out_max in (127, 63):
        got = i8_ops.int8_matmul(x, w, b, shift=shift, out_max=out_max)
        assert torch.equal(got, int8_matmul_ref(x, w, b, shift, out_max))


def _int8_operands(gen, m, k, n, dev):
    x = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    b = torch.randint(-2 ** 16, 2 ** 16, (n,), generator=gen, device=dev,
                      dtype=torch.int32)
    return x, w, b


@pytest.mark.parametrize("shift", [0, 7])
@pytest.mark.parametrize("n", [1, 10, 129])
@pytest.mark.parametrize("m", [1, 8, 512])
@pytest.mark.parametrize("k", [1, 3, 50, 576, 4096])
def test_int8_kernel_matches_plain_version_on_both_plans(dev, m, k, n,
                                                         shift):
    gen = torch.Generator(device=dev).manual_seed(m * 7919 + k * 13 + n)
    x, w, b = _int8_operands(gen, m, k, n, dev)
    i8_ops.COUNTS.reset()
    got = i8_ops.int8_matmul(x, w, b, shift=shift)
    want = int8_matmul_ref(x, w, b, shift=shift)
    torch.cuda.synchronize()
    assert i8_ops.COUNTS.launches == 1
    assert torch.equal(got, want)


def test_int8_plans_by_shape(dev):
    """The FC head splits K; the tiled shapes and short fan-ins do not;
    the shapes above take both plans."""
    assert i8_ops.split_k(8, 576, 10)
    assert i8_ops.split_k(8, 4096, 129) and i8_ops.split_k(1, 576, 1)
    assert not i8_ops.split_k(512, 128, 128)
    assert not i8_ops.split_k(256, 576, 128)
    assert not i8_ops.split_k(8, 50, 10)
    assert not i8_ops.split_k(512, 4096, 10)


@pytest.mark.parametrize("m,k,n", [(8, 576, 10), (8, 4096, 129),
                                   (512, 128, 128), (37, 50, 11)])
def test_int8_kernel_rails_and_wrapping_biases_on_both_plans(dev, m, k, n):
    """x and w at -128 (the largest products) and mixed rails, biases near
    the int32 ends (the adds wrap), out_max 127 and 63, every shift."""
    gen = torch.Generator(device=dev).manual_seed(m + k + n)
    x = torch.full((m, k), -128, dtype=torch.int8, device=dev)
    w = torch.full((k, n), -128, dtype=torch.int8, device=dev)
    x[m // 2:] = torch.where(
        torch.rand((m - m // 2, k), generator=gen, device=dev) < 0.5,
        -128, 127).to(torch.int8)
    ends = torch.tensor([2 ** 31 - 1, -2 ** 31, 2 ** 31 - 51, -2 ** 31 + 7],
                        dtype=torch.int32, device=dev)
    b = ends[torch.arange(n, device=dev) % 4]
    for shift in (0, 4, 7, 31):
        for out_max in (127, 63):
            got = i8_ops.int8_matmul(x, w, b, shift=shift, out_max=out_max)
            want = int8_matmul_ref(x, w, b, shift, out_max)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (shift, out_max)


def test_quantized_fc_on_the_card_equals_the_cpu(dev):
    rng = np.random.default_rng(576)
    feats = torch.tensor(rng.integers(0, 17, (8, 576)) / 16.0,
                         dtype=torch.float32)
    w = torch.tensor(rng.normal(size=(576, 10)) * 0.05, dtype=torch.float32)
    b = torch.tensor(rng.normal(size=10) * 0.1, dtype=torch.float32)
    got = i8_ops.quantized_fc(feats.to(dev), w.to(dev), b.to(dev))
    assert torch.equal(got.cpu(), i8_ops.quantized_fc(feats, w, b))


# -- the SA-noise field and noisy serving ------------------------------------


def test_noise_field_on_the_card_equals_the_cpu(dev):
    cfg = kws.KWSConfig(sample_len=L)
    keys = jaxrand.split(jaxrand.PRNGKey(12, device=dev), 3)
    field = sa_noise.SANoiseField(keys, torch.tensor([0, 4, 31], device=dev),
                                  1.0, HOP)
    on_card = sa_noise.field_window_noise(field, cfg)
    on_cpu = sa_noise.field_window_noise(field._replace(
        keys=keys.cpu(), hops=field.hops.cpu()), cfg)
    for name in on_cpu:
        assert torch.equal(on_card[name].cpu(), on_cpu[name])
    n = jaxrand.normal(keys, (1 << 16,))
    assert torch.equal(n.cpu(), jaxrand.normal(keys.cpu(), (1 << 16,)))
    chans = {f"conv{i}": cfg.channels[i] for i in range(1, 6)}
    offs = imc.sample_chip_offsets(jaxrand.PRNGKey(0, device=dev), chans,
                                   imc.IMCNoiseParams())
    offs_cpu = imc.sample_chip_offsets(jaxrand.PRNGKey(0, "cpu"), chans,
                                       imc.IMCNoiseParams())
    for name in chans:
        assert torch.equal(offs[name].cpu(), offs_cpu[name])


@pytest.mark.parametrize("fill", ["constant", "retention"])
def test_noisy_server_kernel_equals_plain_version(dev, fill):
    """SA noise 1.0 and chip offsets: the kernel route and the plain route
    serve the same events and states, ``imc_fused`` launches once per IMC
    layer and batched call, and the card agrees with the CPU on every
    decision (``score`` within 1e-6)."""
    cfg = kws.KWSConfig(sample_len=L)
    hw = _hw(dev, cfg)
    chans = {f"conv{i}": cfg.channels[i] for i in range(1, 6)}
    chip = imc.sample_chip_offsets(jaxrand.PRNGKey(0, "cpu"), chans,
                                   imc.IMCNoiseParams())
    rng = np.random.default_rng(3)
    auds = []
    for _ in range(3):
        x = rng.uniform(-1, 1, L + 16 * HOP).astype(np.float32)
        x[L + 2 * HOP:L + 8 * HOP] *= 1e-4
        auds.append(x)
    runs = []
    for device, use_kernel in ((dev, True), (dev, False), ("cpu", True)):
        srv = StreamServer(hw if device == dev else _to_cpu(hw), cfg,
                           hop=HOP, slots=3, vad=VADConfig(),
                           chip_offsets=chip, sa_noise_std=1.0, seed=5,
                           silence_fill=fill, use_kernel=use_kernel,
                           device=device)
        for i, x in enumerate(auds):
            srv.submit(f"s{i}", x)
            srv.finish(f"s{i}")
        ops.COUNTS.reset()
        events = srv.drain()
        runs.append((events, srv.stats(), ops.COUNTS.launches, srv))
    (ev_k, st_k, n_k, srv_k), (ev_p, _, n_p, srv_p), (ev_c, _, _, _) = runs
    assert ev_k == ev_p and ev_k
    for a, b in zip(srv_k._state, srv_p._state):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    calls = st_k["batched_calls"]
    assert st_k["gated_hops"] > 0
    assert n_k == 5 * (calls["init"] + calls["hop"] + calls["replay"])
    assert n_p == 0
    strip = lambda evs: [{k: v for k, v in e.items() if k != "score"}
                         for e in evs]
    assert strip(ev_k) == strip(ev_c)
    np.testing.assert_allclose([e["score"] for e in ev_k],
                               [e["score"] for e in ev_c], rtol=0, atol=1e-6)


# -- the front door: recompute path, dynamic hop, autoscaling --------------


def _served_pair(dev, auds, **kw):
    """The same traffic through the kernel route and the plain route on
    the card: (events, stats, imc_fused launches, server) for each."""
    cfg = kws.KWSConfig(sample_len=L)
    hw = _hw(dev, cfg)
    runs = []
    for use_kernel in (True, False):
        srv = StreamServer(hw, cfg, hop=HOP, use_kernel=use_kernel,
                           device=dev, **kw)
        for i, x in enumerate(auds):
            srv.submit(f"s{i}", x)
            srv.finish(f"s{i}")
        ops.COUNTS.reset()
        events = []
        # step until every stream retired (``drain`` stops at a tick that
        # moves no buffer, which a hop retarget can make)
        while srv.active_streams():
            events.extend(srv.step())
        runs.append((events, srv.stats(), ops.COUNTS.launches, srv))
    (ev_k, st_k, n_k, srv_k), (ev_p, _, n_p, srv_p) = runs
    assert ev_k == ev_p and ev_k
    for a, b in zip(srv_k._state, srv_p._state):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    assert n_k == 5 * st_k["imc_passes"] and n_p == 0
    return ev_k, st_k


def _gappy(rng, n_streams, hops, gap=(2, 8)):
    auds = []
    for _ in range(n_streams):
        x = rng.uniform(-1, 1, L + hops * HOP).astype(np.float32)
        x[L + gap[0] * HOP:L + gap[1] * HOP] *= 1e-4
        auds.append(x)
    return auds


def test_recompute_server_kernel_equals_plain_version(dev):
    """``streaming=False``: every hop is one ``hw_forward`` over the full
    windows.  The kernel and plain routes serve the same events and
    windows with VAD gating and wake replays (one launch per IMC layer
    and IMC forward); with every hop computed the recompute server's
    events equal the streaming server's."""
    rng = np.random.default_rng(31)
    auds = _gappy(rng, 3, 16)
    _, st = _served_pair(dev, auds, slots=3, vad=VADConfig(),
                         streaming=False)
    calls = st["batched_calls"]
    assert st["mode"] == "recompute" and st["gated_hops"] > 0
    assert st["imc_passes"] > calls["init"] + calls["hop"] + calls["replay"]
    forced = [_served_pair(dev, auds, slots=3, streaming=streaming,
                           vad=VADConfig(force="speech"))[0]
              for streaming in (False, True)]
    assert forced[0] == forced[1]


def test_dynamic_hop_noisy_server_kernel_equals_plain_version(dev):
    """Dynamic hop (x4) on a noisy chip: the kernel runs the hop-128 and
    hop-256 tails and the retarget re-inits, equal to the plain route."""
    cfg = kws.KWSConfig(sample_len=L)
    chans = {f"conv{i}": cfg.channels[i] for i in range(1, 6)}
    chip = imc.sample_chip_offsets(jaxrand.PRNGKey(0, "cpu"), chans,
                                   imc.IMCNoiseParams(mav_offset_std=4.0))
    rng = np.random.default_rng(7)
    wav = (1e-4 * rng.standard_normal(L + 40 * HOP)).astype(np.float32)
    wav[:L] = rng.uniform(-1, 1, L)
    wav[L + 30 * HOP:] = rng.uniform(-1, 1, 10 * HOP)
    other = rng.uniform(-1, 1, L + 40 * HOP).astype(np.float32)
    other[L:L + 28 * HOP] *= 1e-4
    from repro_torch.serving import DynamicHopConfig
    _, st = _served_pair(
        dev, [wav, other], slots=2, chip_offsets=chip,
        sa_noise_std=1.0, seed=4,
        dynamic_hop=DynamicHopConfig(max_multiplier=4, widen_after=3,
                                     calm_silence=2),
        vad=VADConfig(threshold_on_db=-40.0, threshold_off_db=-50.0,
                      wake_margin=1, hang=0))
    assert st["hop_retargets"] >= 3


def test_autoscale_to_16_slots_with_a_customized_slot(dev):
    """A pool of 4 slots grows to 16 under queue pressure, rejects past
    its queue bound and shrinks back; a customized stream rides the
    resizes.  Kernel and plain routes agree, one launch per IMC layer and
    batched call at B = 16."""
    from repro_torch.serving import AdmissionConfig
    from repro_torch.serving.customize import CustomizationResult
    cfg = kws.KWSConfig(sample_len=L)
    hw = _hw(dev, cfg)
    bias = {n: hw.hw.bias[n].cpu().numpy() + (2.0 if n == "conv2" else 0.0)
            for n in cfg.imc_layer_names()}
    fc_w = hw.hw.fc_w.cpu().numpy().copy()
    fc_w[:, 2] += 3 / 128
    result = CustomizationResult(bias=bias, fc_w=fc_w,
                                 fc_b=hw.hw.fc_b.cpu().numpy(), epochs=1,
                                 n_utterances=1, history=[], energy={})
    rng = np.random.default_rng(8)
    auds = _gappy(rng, 20, 10, gap=(3, 7))
    runs = []
    for use_kernel in (True, False):
        srv = StreamServer(hw, cfg, hop=HOP, slots=4, vad=VADConfig(),
                           use_kernel=use_kernel, device=dev,
                           admission=AdmissionConfig(
                               max_queue=14, min_slots=4, max_slots=16,
                               scale_up_after=1, scale_down_after=2))
        srv.install_custom("s1", result)
        ops.COUNTS.reset()
        places = [srv.submit(f"s{i}", x) for i, x in enumerate(auds)]
        for sid in list(srv._streams):
            srv.finish(sid)
        events, slots = [], []
        for _ in range(60):
            events.extend(srv.step())
            slots.append(srv.slots)
        runs.append((places, events, slots, srv.stats(),
                     ops.COUNTS.launches))
    (pl_k, ev_k, sl_k, st_k, n_k), (pl_p, ev_p, sl_p, st_p, n_p) = runs
    assert pl_k == pl_p and "rejected" in pl_k
    assert ev_k == ev_p and sl_k == sl_p
    assert max(sl_k) == 16 and sl_k[-1] == 4
    assert st_k["rejected_streams"] > 0
    assert n_k == 5 * st_k["imc_passes"] and n_p == 0


@pytest.mark.parametrize("hop", [2048, 4096])
@pytest.mark.parametrize("kind", ["pm1", "zero_streams", "ternary"])
def test_kernel_matches_plain_version_at_wide_hop_tails(dev, hop, kind):
    """K1 at the paper net's per-hop tail shapes of the widened hops
    (B = 8), every IMC layer, clean / chip / noise, bitwise."""
    cfg = kws.PAPER_KWS
    geom = sv.make_stream_geometry(cfg, hop)
    for i in range(1, cfg.num_conv_layers):
        c_in, c_out, g = cfg.channels[i - 1], cfg.channels[i], cfg.groups(i)
        x, w, bias, flip, off, noise = _inputs(
            100 + i, 8, geom.layers[i].tail_in, c_in, c_out, g,
            cfg.strides[i], dev, kind)
        for o, n in ((None, None), (off, None), (off, noise)):
            ops.COUNTS.reset()
            got = ops.fused_conv_mav(x, w, bias, flip, groups=g,
                                     stride=cfg.strides[i],
                                     pool=cfg.pools[i], chip_offset=o,
                                     sa_noise=n)
            assert ops.COUNTS.launches == 1
            want = ref.fused_conv_mav_ref(x, w, bias, flip, groups=g,
                                          stride=cfg.strides[i],
                                          pool=cfg.pools[i], chip_offset=o,
                                          sa_noise=n)
            assert torch.equal(got, want), (i, o is None, n is None)


def test_noisy_customization_session_kernel_equals_plain_version(dev):
    """One session on a noisy chip (SA noise 1.0, chip offsets, VAD on,
    the test mode's read noise 1.0): the kernel route's result and events
    equal the plain route's on the card and the CPU path's (``score``
    within 1e-6 there); its captures re-extract under the noise field."""
    cfg = kws.KWSConfig(sample_len=L)
    hw = _hw(dev, cfg)
    chans = {f"conv{i}": cfg.channels[i] for i in range(1, 6)}
    chip = imc.sample_chip_offsets(jaxrand.PRNGKey(0, "cpu"), chans,
                                   imc.IMCNoiseParams(mav_offset_std=4.0))
    rng = np.random.default_rng(21)
    live = rng.uniform(-1, 1, L + 40 * HOP).astype(np.float32)
    utts = [rng.uniform(-1, 1, L).astype(np.float32) for _ in range(3)]
    labels = [int(v) for v in rng.integers(0, cfg.num_classes, 3)]

    def run(device, use_kernel):
        srv = StreamServer(hw if device == dev else _to_cpu(hw), cfg,
                           hop=HOP, slots=4, chip_offsets=chip,
                           sa_noise_std=1.0, seed=11, vad=VADConfig(),
                           use_kernel=use_kernel, device=device)
        sess = srv.customize("user", CustomizeConfig(
            train=OnChipTrainConfig(epochs=12), epochs_per_tick=5,
            calib_sa_noise_std=1.0, calib_seed=4, use_kernel=use_kernel))
        srv.submit("live", live[:L])
        for lab, u in zip(labels, utts):
            sess.enroll(lab, u)
        sess.finish_enrollment()
        ops.COUNTS.reset()
        events, pos = [], L
        for _ in range(300):
            if pos < len(live):
                srv.submit("live", live[pos:pos + HOP])
                pos += HOP
            events.extend(srv.step())
            if sess.phase == "swapped":
                break
        assert sess.phase == "swapped"
        srv.submit("user", live[:L + 4 * HOP])
        srv.finish("user")
        events.extend(srv.drain())
        return dict(events=events, result=sess.result, srv=srv,
                    imc=ops.COUNTS.launches)

    kern, plain = run(dev, True), run(dev, False)
    cpu = run(torch.device("cpu"), True)
    assert kern["events"] == plain["events"]
    assert kern["imc"] == 5 * kern["srv"].stats()["imc_passes"]
    assert plain["imc"] == 0
    strip = lambda evs: [{k: v for k, v in e.items() if k != "score"}
                         for e in evs]
    assert strip(kern["events"]) == strip(cpu["events"])
    np.testing.assert_allclose([e["score"] for e in kern["events"]],
                               [e["score"] for e in cpu["events"]], rtol=0,
                               atol=1e-6)
    for r in (plain["result"], cpu["result"]):
        rk = kern["result"]
        assert np.array_equal(rk.fc_w, r.fc_w)
        assert np.array_equal(rk.fc_b, r.fc_b)
        assert rk.history == r.history
        for name in cfg.imc_layer_names():
            assert np.array_equal(rk.bias[name], r.bias[name])


# -- the self-healing chip: faults in the riders, canaries, heals ----------


@pytest.mark.parametrize("kind", ["pm1", "zero_streams", "ternary"])
def test_kernel_on_rails_and_fractional_drift_at_hop_tails(dev, kind):
    """K1 at the paper net's hop-1024 tail shapes (B = 8) with the
    pre-sign operand a faulted chip gives it: SA noise plus stuck rails
    (±1e4) on some channels and a fractional drift on the rest, and the
    rails and drift alone; bitwise equal to the plain version."""
    cfg = kws.PAPER_KWS
    geom = sv.make_stream_geometry(cfg, 1024)
    rng = np.random.default_rng(40)
    for i in range(1, cfg.num_conv_layers):
        c_in, c_out, g = cfg.channels[i - 1], cfg.channels[i], cfg.groups(i)
        x, w, bias, flip, off, noise = _inputs(
            200 + i, 8, geom.layers[i].tail_in, c_in, c_out, g,
            cfg.strides[i], dev, kind)
        delta = np.round(rng.normal(size=c_out) * 40.0, 2)
        delta[rng.choice(c_out, 4, replace=False)] = 1e4
        delta[rng.choice(c_out, 4, replace=False)] = -1e4
        delta = torch.tensor(delta, dtype=torch.float32, device=dev)
        for operand in (noise + delta, delta.expand_as(noise)):
            ops.COUNTS.reset()
            got = ops.fused_conv_mav(x, w, bias, flip, groups=g,
                                     stride=cfg.strides[i],
                                     pool=cfg.pools[i], chip_offset=off,
                                     sa_noise=operand)
            assert ops.COUNTS.launches == 1
            want = ref.fused_conv_mav_ref(x, w, bias, flip, groups=g,
                                          stride=cfg.strides[i],
                                          pool=cfg.pools[i],
                                          chip_offset=off, sa_noise=operand)
            assert torch.equal(got, want), i


def _reliability_runs(dev, make, drive):
    """``drive(srv)`` on a server from ``make(hw, device, use_kernel)`` on
    the kernel route, the plain route and the CPU: (events, stats,
    imc_fused launches, server) for each, kernel and plain checked equal
    (events, states, health and fault stats)."""
    cfg = kws.KWSConfig(sample_len=L)
    hw = _hw(dev, cfg)
    runs = []
    for device, use_kernel in ((dev, True), (dev, False), ("cpu", True)):
        srv = make(hw if device == dev else _to_cpu(hw), cfg, device,
                   use_kernel)
        ops.COUNTS.reset()
        events = drive(srv)
        runs.append((events, srv.stats(), ops.COUNTS.launches, srv))
    (ev_k, st_k, n_k, srv_k), (ev_p, st_p, n_p, srv_p), (ev_c, st_c, _,
                                                          srv_c) = runs
    assert ev_k == ev_p and ev_k
    for a, b in zip(srv_k._state, srv_p._state):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    assert n_k == 5 * st_k["imc_passes"] and n_p == 0
    strip = lambda evs: [{k: v for k, v in e.items() if k != "score"}
                         for e in evs]
    assert strip(ev_k) == strip(ev_c)
    np.testing.assert_allclose([e["score"] for e in ev_k],
                               [e["score"] for e in ev_c], rtol=0, atol=1e-6)
    for st in (st_p, st_c):
        assert st["health"] == st_k["health"]
        assert st["faults"] == st_k["faults"]
        assert st["imc_passes"] == st_k["imc_passes"]
    for srv in (srv_p, srv_c):
        assert (srv._heal_delta is None) == (srv_k._heal_delta is None)
        for name, d in (srv_k._heal_delta or {}).items():
            assert np.array_equal(d, srv._heal_delta[name])
    return ev_k, st_k


def test_faulted_noisy_monitored_server_kernel_equals_plain_and_cpu(dev):
    """SA noise 1.5, chip offsets, stuck columns, trim flips and a drift
    walk, canaries every 3 ticks: the kernel route equals the plain route
    and the CPU, one ``imc_fused`` launch per IMC layer and forward."""
    from repro_torch.serving import FaultConfig, HealthConfig
    chans = {f"conv{i}": kws.KWSConfig(sample_len=L).channels[i]
             for i in range(1, 6)}
    chip = imc.sample_chip_offsets(jaxrand.PRNGKey(9, "cpu"), chans,
                                   imc.IMCNoiseParams(mav_offset_std=4.0))
    rng = np.random.default_rng(2)
    auds = [rng.uniform(-1, 1, L + 14 * HOP).astype(np.float32)
            for _ in range(2)]

    def make(hw, cfg, device, use_kernel):
        srv = StreamServer(hw, cfg, hop=HOP, slots=3, chip_offsets=chip,
                           sa_noise_std=1.5, seed=11,
                           faults=FaultConfig(drift_std=0.2, seed=3),
                           health=HealthConfig(interval=3),
                           use_kernel=use_kernel, device=device)
        srv.faults.inject_stuck("conv2", [0, 5])
        srv.faults.inject_bit_flips(n=3)
        return srv

    def drive(srv):
        for i, x in enumerate(auds):
            srv.submit(f"s{i}", x)
            srv.finish(f"s{i}")
        events = []
        while srv.active_streams():
            events.extend(srv.step())
        return events

    _, st = _reliability_runs(dev, make, drive)
    assert st["health"]["canaries"] >= 2 and st["faults"]["drift_rms"]


@pytest.mark.parametrize("scenario", ["stuck", "drift"])
def test_stuck_and_drift_heal_kernel_equals_plain_and_cpu(dev, scenario):
    """The reference's stuck-column (masked) and drift (healed) scenarios
    at ``sample_len=640``: the canary expectations and captures run
    through K1, the heal rides the chip-global rider, and the kernel
    route walks the same states, heals and masks as the plain route and
    the CPU."""
    from repro_torch.serving import FaultConfig, HealthConfig
    chans = {f"conv{i}": kws.KWSConfig(sample_len=L).channels[i]
             for i in range(1, 6)}
    chip = (imc.sample_chip_offsets(jaxrand.PRNGKey(9, "cpu"), chans,
                                    imc.IMCNoiseParams(mav_offset_std=4.0))
            if scenario == "drift" else None)

    def make(hw, cfg, device, use_kernel):
        return StreamServer(hw, cfg, hop=HOP, slots=3, chip_offsets=chip,
                            faults=FaultConfig(seed=3),
                            health=HealthConfig(interval=4,
                                                layers_per_tick=2),
                            use_kernel=use_kernel, device=device)

    def drive(srv):
        rng = np.random.default_rng(0)
        srv.submit("a", rng.standard_normal(L).astype(np.float32))
        events = []
        for t in range(40):
            if t == 12 and scenario == "stuck":
                srv.faults.inject_stuck("conv3", [2, 7])
            elif t == 12:
                srv.faults._drift["conv2"][:] = 40.0
                srv.faults._dirty = True
            srv.submit("a", rng.standard_normal(HOP).astype(np.float32))
            events.extend(srv.step())
        return events

    events, st = _reliability_runs(dev, make, drive)
    h = st["health"]
    assert h["state"] == "healthy" and h["recoveries"] >= 1
    assert any(e["degraded"] for e in events)
    assert h["masked_channels"] == ({"conv3": [2, 7]} if scenario == "stuck"
                                    else {})


# ---------------------------------------------------------------------------
# means as the reference computes them, and the float learning path
# ---------------------------------------------------------------------------

def test_gap_tie_on_the_card(dev):
    """T = 448 (``tests/_mean_cases.py``): feats[0, 0] is 0.4375 through
    ``gap_fc``, ``_ring_logits`` (shared and per-stream heads) and the
    capture's GAP, on the card as on the CPU."""
    from repro_torch.serving.customize import capture_features
    ring = gap_tie_ring(batch=2)
    w, b = gap_head()
    heads = np.stack([w, w[:, ::-1].copy()])
    got = {}
    for d in (dev, "cpu"):
        t = lambda a: torch.tensor(a, device=d)
        hw = kws.HWParams(w_bin={}, bias={}, flip={}, fc_w=t(w), fc_b=t(b))
        logits, feats = kws.gap_fc(hw, t(ring))
        got[str(d)] = [feats, logits,
                       sv._ring_logits(hw, t(ring), None, None),
                       sv._ring_logits(hw, t(ring), t(heads), t(
                           np.stack([b, b]))),
                       capture_features(t(ring[0]))]
    card, cpu = got[str(dev)], got["cpu"]
    assert float(card[0][0, 0]) == float(card[4][0]) == GAP_FEAT0
    for a, c in zip(card, cpu):
        assert torch.equal(a.cpu(), c)


@pytest.mark.parametrize("epochs", [1, 30])
def test_head_tie_on_both_k2_routes(dev, epochs):
    """N = 7: gw[1, 0] is 7/128 on the card; the per-epoch route
    (``epoch_grads`` then ``sga_update_rows``) and the fused route
    (``head_train_rows``) land on the same head as their plain versions
    and as the CPU."""
    feats, labels, w, b = head_tie_case()
    tcfg = OnChipTrainConfig()
    spec, heads = ot.head_train_spec(tcfg), {}
    for d in (dev, "cpu"):
        st, fq, oh = ot.finetune_init(feats, labels, w, b, tcfg, device=d)
        flat = [torch.cat([st.w.reshape(-1), st.b])[None],
                torch.cat([st.accum_w.reshape(-1), st.accum_b])[None]]
        sga_ops.COUNTS_ROWS.reset()
        for e in range(epochs):
            s = ot.HeadState(flat[0][0, :6].reshape(2, 3), flat[0][0, 6:],
                             flat[1][0, :6].reshape(2, 3), flat[1][0, 6:],
                             st.key)
            gw, gb, lr, _ = ot.epoch_grads(s, e, fq, oh, tcfg)
            if e == 0:
                assert float(gw[1, 0]) == HEAD_GW10
            g = torch.cat([gw.reshape(-1), gb])[None]
            th = ot.sga_threshold(lr)
            nw, na = sga_ops.sga_update_batch(flat[0], g, flat[1],
                                              lr.reshape(1), th.reshape(1))
            pw, pa = sga_update_ref(flat[0], g, flat[1], lr, th)
            assert torch.equal(nw, pw) and torch.equal(na, pa)
            flat = [nw, na]
        assert sga_ops.COUNTS_ROWS.launches == (epochs if torch.device(d) == dev
                                                else 0)
        fused = [v.clone() for v in (st.w, st.b, st.accum_w, st.accum_b)]
        plain = [v.clone() for v in fused]
        sga_ops.head_train_batch(*([v] for v in fused), [fq], [oh], [0],
                                 [epochs], ot.train_lut(fq.device), spec)
        sga_ref.head_train_rows_ref(*([v] for v in plain), [fq], [oh], [0],
                                    [epochs], ot.train_lut(fq.device), spec)
        fused = torch.cat([v.reshape(-1) for v in fused])
        assert torch.equal(fused, torch.cat([v.reshape(-1) for v in plain]))
        per_epoch = torch.cat([flat[0][0, :6], flat[0][0, 6:],
                               flat[1][0, :6], flat[1][0, 6:]])
        assert torch.equal(fused, per_epoch)
        if epochs == 1:
            assert float(fused[9 + 3]) == HEAD_GW10     # accum_w[1, 0]
        heads[str(d)] = fused.cpu()
    assert torch.equal(heads[str(dev)], heads["cpu"])


def test_float_path_folds_through_k1(dev):
    """The float path on the card: ``forward_eval`` of a jaxrand-key net
    equals the CPU's bitwise, and the unconstrained fold through K1 (5
    launches) gives its features to 1e-5 (the reference's fold check)."""
    cfg = kws.KWSConfig(sample_len=L)
    x = np.random.default_rng(2).uniform(-1, 1, (8, L)).astype(np.float32)
    nets, out = {}, {}
    for d in (dev, "cpu"):
        nets[str(d)] = (kws.init_params(jaxrand.PRNGKey(1, device="cpu"),
                                        cfg, device=d),
                        kws.init_state(cfg, device=d))
        with torch.no_grad():
            out[str(d)] = kws.forward_eval(*nets[str(d)], x, cfg)
    logits, feats = out[str(dev)]
    assert torch.equal(logits.cpu(), out["cpu"][0])
    hw_u = kws.fold_params(*nets[str(dev)], cfg, bn_constraints=False)
    ops.COUNTS.reset()
    _, f_hw = kws.hw_forward(hw_u, x, cfg, use_kernel=True, device=dev)
    assert ops.COUNTS.launches == 5
    assert float(torch.max(torch.abs(f_hw - feats))) <= 1e-5


@pytest.mark.parametrize("alpha", [2.0, -5.0])
def test_train_step_on_the_card_equals_the_cpu(dev, alpha):
    """One ``train_base`` step of the recovery fine-tune (chip offsets, SA
    noise 1.0) from identical parameters on the card and the CPU: the
    loss within rtol 1e-3, the BN state bitwise, 95% of the parameters
    within 1e-4 |p| + 1e-5 (Adam's first step normalizes each element's
    gradient, so rounding-noise gradients step by up to the learning
    rate), no TF32."""
    from repro_torch.training import kws as tr
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = kws.KWSConfig(sample_len=L)
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (8, L)).astype(np.float32)
    y = rng.integers(0, 10, 8)
    chans = {f"conv{i}": cfg.channels[i] for i in range(1, 6)}
    chip = imc.sample_chip_offsets(jaxrand.PRNGKey(9, "cpu"), chans,
                                   imc.IMCNoiseParams(mav_offset_std=4.0))
    tcfg = tr.TrainConfig(epochs=1, batch_size=8, lr_min=0.01,
                          alpha_schedule=((1.0, alpha),))
    res = {}
    for d in (dev, "cpu"):
        hist = []
        res[str(d)] = tr.train_base(x, y, cfg, tcfg, chip_offsets=chip,
                                    sa_noise_std=1.0, verbose=False,
                                    history=hist, device=d), hist
    (pk, sk), hk = res[str(dev)]
    (pc, sc), hc = res["cpu"]
    assert abs(float(hk[0]["loss"]) - float(hc[0]["loss"])) \
        <= 1e-3 * abs(float(hc[0]["loss"]))
    for name in sc.mean:
        assert torch.equal(sk.mean[name].cpu(), sc.mean[name])
        assert torch.equal(sk.var[name].cpu(), sc.var[name])
    off = total = 0
    for n in pc:
        for k in pc[n]:
            d = torch.abs(pk[n][k].cpu() - pc[n][k])
            off += int(torch.sum(d > 1e-4 * torch.abs(pc[n][k]) + 1e-5))
            total += d.numel()
            assert float(d.max()) <= 0.02
    assert off <= 0.05 * total


# ---------------------------------------------------------------------------
# the hardware half of the learning path, and the serving telemetry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["clean", "fresh", "field"])
def test_evaluate_hw_through_k1_equals_plain_and_cpu(dev, mode):
    """``_hw_batched`` logits and features through K1 equal the plain
    route on the card and the CPU, chunk by chunk (7 windows in chunks of
    3: a ragged last chunk draws its noise at its own shape), with 5 K1
    launches a chunk; ``evaluate_hw`` gives the same accuracy on all
    three."""
    from repro_torch.training import kws as tr
    cfg = kws.KWSConfig(sample_len=L)
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (7, L)).astype(np.float32)
    y = rng.integers(0, 10, 7)
    chans = {f"conv{i}": cfg.channels[i] for i in range(1, 6)}
    chip = imc.sample_chip_offsets(jaxrand.PRNGKey(11, "cpu"), chans,
                                   imc.IMCNoiseParams(mav_offset_std=8.0))
    kw = {}
    if mode != "clean":
        kw["chip_offsets"] = chip
    if mode == "fresh":
        kw.update(sa_noise_std=1.0, seed=3)
    params = kws.init_params(jaxrand.PRNGKey(5, device="cpu"), cfg,
                             device="cpu")
    hw_cpu = kws.fold_params(params, kws.init_state(cfg, device="cpu"), cfg,
                             pack=True)
    hw_dev = kws.fold_params(kws.init_params(
        jaxrand.PRNGKey(5, device="cpu"), cfg, device=dev),
        kws.init_state(cfg, device=dev), cfg, pack=True)
    outs, accs = {}, {}
    for where, hw, use_kernel in (("kernel", hw_dev, True),
                                  ("plain", hw_dev, False),
                                  ("cpu", hw_cpu, True)):
        d = "cpu" if where == "cpu" else dev
        if mode == "field":
            kw["sa_noise_field"] = sa_noise.SANoiseField(
                jaxrand.split(jaxrand.PRNGKey(13, d), 7),
                torch.tensor([0, 2, 9, 1, 5, 3, 7], device=d), 1.0, HOP)
        ops.COUNTS.reset()
        outs[where] = [tr._hw_batched(
            hw, x, cfg, i, batch=3, use_kernel=use_kernel, device=d,
            **{"chip_offsets": None, "sa_noise_std": 0.0, "seed": 0,
               "sa_noise_field": None, **kw}).cpu() for i in (0, 1)]
        assert ops.COUNTS.launches == (2 * 5 * 3 if where == "kernel"
                                       else 0)
        accs[where] = tr.evaluate_hw(hw, x, y, cfg, batch=3,
                                     use_kernel=use_kernel, device=d, **kw)
    for i in (0, 1):
        assert torch.equal(outs["kernel"][i], outs["plain"][i])
        assert torch.equal(outs["kernel"][i], outs["cpu"][i])
    assert accs["kernel"] == accs["plain"] == accs["cpu"]


def test_launch_auditor_counts_k1_launches(dev):
    """Telemetry fully on (recorder, auditor in raise mode, trace) on a
    gated, faulted server with canaries every 4 ticks: events and every
    state leaf equal telemetry off; no violation; the auditor's fused
    calls (in regions and outside them) equal K1's launches, tick by
    tick and in all, and 5 x ``imc_passes``."""
    from repro_torch.obs import ObsConfig
    from repro_torch.serving import FaultConfig, HealthConfig
    cfg = kws.KWSConfig(sample_len=L)
    hw = kws.fold_params(kws.init_params(jaxrand.PRNGKey(5, device="cpu"),
                                         cfg, device=dev),
                         kws.init_state(cfg, device=dev), cfg, pack=True)
    rng = np.random.default_rng(7)
    wavs = []
    for _ in range(2):
        w = rng.uniform(-1, 1, L + 20 * HOP).astype(np.float32)
        w[L + 4 * HOP:L + 9 * HOP] *= 1e-4
        wavs.append(w)
    runs = []
    for obs in (ObsConfig(recorder=256, audit="raise", trace=True),
                ObsConfig()):
        srv = StreamServer(hw, cfg, hop=HOP, slots=3, seed=3, device=dev,
                           vad=VADConfig(threshold_on_db=-40.0,
                                         threshold_off_db=-50.0,
                                         wake_margin=1, hang=0),
                           faults=FaultConfig(seed=3),
                           health=HealthConfig(interval=4), obs=obs)
        srv.faults.inject_bit_flips(n=2)
        for i, w in enumerate(wavs):
            srv.submit(f"s{i}", w)
            srv.finish(f"s{i}")
        ops.COUNTS.reset()
        events, per_tick = [], []
        for _ in range(26):
            n0 = ops.COUNTS.launches
            events.extend(srv.step())
            per_tick.append(ops.COUNTS.launches - n0)
        runs.append((srv, events, per_tick, ops.COUNTS.launches))
    (on, ev_on, ticks_on, n_on), (off, ev_off, _, n_off) = runs
    assert ev_on == ev_off and n_on == n_off
    for a, b in zip([on._state.audio_carry, *on._state.carries,
                     on._state.ring], [off._state.audio_carry,
                                       *off._state.carries, off._state.ring]):
        assert torch.equal(a, b)
    s = on.auditor.stats()
    assert s["violations"] == 0 and s["calls"]["gate"] > 0
    assert s["traced_launches"] + s["outside_regions"] == n_on
    assert [h["k1_calls"] for h in on.auditor.history()] == ticks_on
    assert s["outside_regions"] >= 10           # the canary expectation
    assert n_on == 5 * on.stats()["imc_passes"]
    assert on.health.stats() == off.health.stats()


# ---------------------------------------------------------------------------
# crash-safe snapshots and the sharded fleet on the card
# ---------------------------------------------------------------------------


def _state_leaves(state):
    return [x for a in state for x in (a if isinstance(a, tuple) else (a,))]


def test_card_snapshot_restores_on_the_cpu(dev, tmp_path):
    """A faulted, noisy, gated, canary-monitored card server snapshotted
    to a file at tick 8 with a recovery in flight: a fresh card server
    restored from it plays the next 8 ticks as the uninterrupted one did
    (events, every state leaf, health and faults), K1 launching 10 more
    times for the recomputed canary expectation; a CPU server restored
    from the same file serves the same events (``score`` within 1e-6)
    and carries, bit for bit."""
    from repro_torch.serving import FaultConfig, HealthConfig
    cfg = kws.KWSConfig(sample_len=L)
    hw = _hw(dev, cfg)
    chans = {f"conv{i}": cfg.channels[i] for i in range(1, 6)}
    chip = imc.sample_chip_offsets(jaxrand.PRNGKey(9, "cpu"), chans,
                                   imc.IMCNoiseParams(mav_offset_std=4.0))
    rng = np.random.default_rng(0)
    first = [rng.uniform(-1, 1, L).astype(np.float32) for _ in range(2)]
    hops = [(rng.uniform(-1, 1, HOP).astype(np.float32),
             ((1.0 if t % 5 < 2 else 1e-4)
              * rng.uniform(-1, 1, HOP)).astype(np.float32))
            for t in range(16)]

    def make(hw, device):
        return StreamServer(
            hw, cfg, hop=HOP, slots=3, chip_offsets=chip, sa_noise_std=1.0,
            vad=VADConfig(threshold_on_db=-40.0, threshold_off_db=-50.0,
                          wake_margin=1, hang=0),
            faults=FaultConfig(drift_std=0.2, seed=3),
            health=HealthConfig(interval=2, quarantine_after=1,
                                layers_per_tick=1), seed=7, device=device)

    def play(srv, t0, t1):
        events = []
        for t in range(t0, t1):
            if t == 1:
                srv.faults.inject_stuck("conv2", [1, 4])
                srv.faults.inject_bit_flips(n=2)
            srv.submit("a", hops[t][0])
            srv.submit("b", hops[t][1])
            events.extend(srv.step())
        return events

    srv = make(hw, dev)
    srv.submit("a", first[0])
    srv.submit("b", first[1])
    play(srv, 0, 8)
    assert srv.health._recovery is not None
    path = str(tmp_path / "card.npz")
    srv.snapshot(path)
    passes0 = srv._imc_passes
    runs = []
    for s in (srv, make(hw, dev), make(_to_cpu(hw), "cpu")):
        if s is not srv:
            s.restore(path)
        ops.COUNTS.reset()
        runs.append((play(s, 8, 16), ops.COUNTS.launches, s))
    (ev, n, srv), (ev2, n2, card), (ev3, _, cpu) = runs
    assert ev == ev2 and ev
    assert n == 5 * (srv._imc_passes - passes0)
    assert n2 == 5 * (card._imc_passes - passes0) == n + 10
    for x, y, z in zip(_state_leaves(srv._state), _state_leaves(card._state),
                       _state_leaves(cpu._state)):
        assert torch.equal(x, y) and torch.equal(x.cpu(), z)
    for x, y in zip(_state_leaves(srv._dstate), _state_leaves(card._dstate)):
        assert torch.equal(x, y)
    strip = lambda evs: [{k: v for k, v in e.items() if k != "score"}
                         for e in evs]
    assert strip(ev) == strip(ev3)
    np.testing.assert_allclose([e["score"] for e in ev],
                               [e["score"] for e in ev3], rtol=0, atol=1e-6)
    for s in (card, cpu):
        assert s.health.stats() == srv.health.stats()
        assert s.faults.stats() == srv.faults.stats()


def test_two_pool_fleet_on_one_card_equals_one_server(dev):
    """``ShardedStreamServer(devices=2)`` puts both pools on the card;
    with SA noise and chip offsets each stream's events equal one 4-slot
    card server's, each pool launches K1 once per IMC layer and forward,
    and ``parallel=True`` under the raising auditor serves the same."""
    from repro_torch.obs import ObsConfig
    from repro_torch.serving import ShardedStreamServer
    cfg = kws.KWSConfig(sample_len=L)
    hw = _hw(dev, cfg)
    chans = {f"conv{i}": cfg.channels[i] for i in range(1, 6)}
    chip = imc.sample_chip_offsets(jaxrand.PRNGKey(9, dev), chans,
                                   imc.IMCNoiseParams(mav_offset_std=4.0))
    kw = dict(hop=HOP, sa_noise_std=0.5, chip_offsets=chip, seed=0)
    wavs = {f"s{i}": np.random.default_rng(100 + i).uniform(
        -1, 1, L + 6 * HOP).astype(np.float32) for i in range(4)}
    runs = []
    for make in (lambda: StreamServer(hw, cfg, slots=4, device=dev, **kw),
                 lambda: ShardedStreamServer(hw, cfg, devices=2, slots=2,
                                             **kw),
                 lambda: ShardedStreamServer(
                     hw, cfg, devices=2, slots=2, parallel=True,
                     obs=ObsConfig(audit="raise"), **kw)):
        srv = make()
        for sid, w in wavs.items():
            srv.submit(sid, w)
            srv.finish(sid)
        ops.COUNTS.reset()
        events = srv.drain()
        runs.append((events, ops.COUNTS.launches, srv))
    (ev1, n1, one), (ev2, n2, seq), (ev3, n3, par) = runs
    par.close()
    per = lambda evs: {s: [{k: v for k, v in e.items() if k != "device"}
                           for e in evs if e["stream"] == s] for s in wavs}
    assert per(ev2) == per(ev1) and ev3 == ev2 and ev1
    assert seq.devices == [dev, dev]
    assert sorted(seq.where(s) for s in wavs) == [0, 0, 1, 1]
    passes = sum(p._imc_passes for p in seq.pools)
    assert n2 == n3 == 5 * passes and n1 == 5 * one._imc_passes
    assert par.stats()["audit"]["violations"] == 0


# -- compiled ticks: blocks replayed as CUDA graphs -------------------------


def _duty_wave(n, seed, period=3 * HOP):
    """Uniform noise with seeded runs of near-silence (the compiled
    tests' traffic), so gating and wake replays happen."""
    r = np.random.default_rng(seed)
    x = r.uniform(-1.0, 1.0, n).astype(np.float32)
    for t in range(0, n, period):
        if r.random() > 0.45:
            x[t:t + period] *= 1e-4
    return x


def test_captured_k1_replays_equal_eager_launches(dev):
    """K1 recorded into a CUDA graph: its replay equals the eager launch
    bit for bit on new operands written into the same buffers, the
    recorded call counts no launch, and the profiler sees the kernel in
    a replay."""
    from torch.profiler import ProfilerActivity, profile
    x, w, bias, flip, off, noise = _inputs(3, 8, 40, 96, 192, 4, 1, dev)
    packed = ops.pack_weights_s8(w, 4)

    def call():
        return ops.fused_conv_mav(x, w, bias, flip, groups=4, pool=2,
                                  chip_offset=off, sa_noise=noise,
                                  packed=packed)

    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        call()                                  # warm-up
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    ops.COUNTS.reset()
    calls = ops.CALLS.calls
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="thread_local"):
        out = call()
    assert ops.COUNTS.launches == 0 and ops.CALLS.calls == calls
    for seed in (4, 5):
        x2, _, _, _, off2, noise2 = _inputs(seed, 8, 40, 96, 192, 4, 1, dev)
        x.copy_(x2)
        off.copy_(off2)
        noise.copy_(noise2)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            graph.replay()
            torch.cuda.synchronize()
        assert torch.equal(out, call())
        names = [e.key for e in prof.key_averages()]
        assert any("imc_fused_kernel" in k for k in names), names


def _compiled_pair(dev, cfg, hw, block=8, **kw):
    return (StreamServer(hw, cfg, hop=HOP, slots=3, device=dev, **kw),
            StreamServer(hw, cfg, hop=HOP, slots=3, device=dev,
                         compiled=CompiledTickConfig(block=block), **kw))


def _advance_to(srv, ticks):
    events = []
    while srv._steps < ticks:
        events += (srv.step_block(ticks - srv._steps)
                   if srv._compiled is not None else srv.step())
    return events


def _same_servers(a, b):
    for x, y in zip(_state_leaves(a._state), _state_leaves(b._state)):
        assert torch.equal(x, y)
    for x, y in zip(a._dstate, b._dstate):
        assert torch.equal(x, y)
    for x, y in zip(a._vstate, b._vstate):
        assert torch.equal(x, y)


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noise"])
def test_compiled_blocks_equal_interpreted_ticks_on_the_card(dev, noisy):
    """Blocks replayed as CUDA graphs serve the interpreted ticks' events
    and state bit for bit, gated, with wake replays (and SA noise and
    chip offsets), K1 launching 5 x ``imc_passes`` on both servers."""
    cfg = kws.KWSConfig(sample_len=L)
    hw = _hw(dev, cfg)
    kw = dict(vad=VADConfig())
    if noisy:
        chans = {f"conv{i}": cfg.channels[i] for i in range(1, 6)}
        kw.update(sa_noise_std=0.5, chip_offsets=imc.sample_chip_offsets(
            jaxrand.PRNGKey(9, dev), chans,
            imc.IMCNoiseParams(mav_offset_std=4.0)))
    ref, cand = _compiled_pair(dev, cfg, hw, **kw)
    for srv in (ref, cand):
        for i in range(3):
            srv.submit(f"s{i}", _duty_wave(L + 22 * HOP, 100 + i))
    runs = []
    for srv in (ref, cand):
        ops.COUNTS.reset()
        events = _advance_to(srv, 30)
        runs.append((events, ops.COUNTS.launches))
    (ev_ref, n_ref), (ev_cand, n_cand) = runs
    assert ev_ref == ev_cand and ev_ref
    _same_servers(ref, cand)
    assert n_ref == 5 * ref._imc_passes and n_cand == 5 * cand._imc_passes
    assert cand._compiled_ticks > 15
    (steps,) = cand._compiled._steps.values()
    assert set(steps.graphs) == {"compute", "fill"}
    assert ref.stats()["batched_calls"]["replay"] > 0


def test_compiled_blocks_through_resize_restore_and_faults(dev):
    """Blocks interleaved with interpreted ticks, a pool resize, a
    restore into a fresh server and a fault injection, on the card: every
    tensor the graphs read is copied in at each block, so the run stays
    the interpreted one's, bit for bit."""
    from repro_torch.serving import AdmissionConfig, FaultConfig
    cfg = kws.KWSConfig(sample_len=L)
    hw = _hw(dev, cfg)
    chans = {f"conv{i}": cfg.channels[i] for i in range(1, 6)}
    kw = dict(vad=VADConfig(), sa_noise_std=0.2,
              chip_offsets=imc.sample_chip_offsets(
                  jaxrand.PRNGKey(9, dev), chans,
                  imc.IMCNoiseParams(mav_offset_std=4.0)),
              faults=FaultConfig(drift_std=0.2, seed=4),
              admission=AdmissionConfig(min_slots=2, max_slots=4))

    def make(compiled):
        return StreamServer(hw, cfg, hop=HOP, slots=2, device=dev,
                            compiled=CompiledTickConfig(block=4) if compiled
                            else None, **kw)

    ref, cand = make(False), make(True)
    for srv in (ref, cand):
        for i in range(2):
            srv.submit(f"s{i}", _duty_wave(L + 30 * HOP, 200 + i))
    ev = [_advance_to(ref, 5), _advance_to(cand, 5)]
    for i, srv in enumerate((ref, cand)):
        ev[i] += srv.step()
        srv._resize(4)
        srv.submit("s2", _duty_wave(L + 12 * HOP, 202))
        ev[i] += _advance_to(srv, 12)
    fresh = make(True)
    fresh.restore(cand.snapshot())
    cand = fresh
    launches = []
    for i, srv in enumerate((ref, cand)):
        srv.faults.inject_stuck("conv3", [2, 7])
        ops.COUNTS.reset()
        p0 = srv._imc_passes
        ev[i] += _advance_to(srv, 24)
        launches.append((ops.COUNTS.launches, srv._imc_passes - p0))
    assert ev[0] == ev[1] and ev[0]
    _same_servers(ref, cand)
    assert all(n == 5 * p for n, p in launches)
    assert cand._compiled_ticks > 0


def test_parallel_fleet_of_compiled_pools_on_one_card(dev):
    """Two compiled pools on the card capture and replay on threads of
    their own (``parallel=True``) under the raising auditor: each
    stream's events equal one server's, K1 = 5 x the pools'
    ``imc_passes``."""
    from repro_torch.obs import ObsConfig
    from repro_torch.serving import ShardedStreamServer
    cfg = kws.KWSConfig(sample_len=L)
    hw = _hw(dev, cfg)
    kw = dict(hop=HOP, sa_noise_std=0.5, vad=VADConfig(), seed=0)
    wavs = {f"s{i}": _duty_wave(L + 12 * HOP, 500 + i) for i in range(4)}
    one = StreamServer(hw, cfg, slots=4, device=dev, **kw)
    fleets = [ShardedStreamServer(hw, cfg, devices=2, slots=2,
                                  parallel=parallel,
                                  compiled=CompiledTickConfig(block=8),
                                  obs=ObsConfig(audit="raise"), **kw)
              for parallel in (False, True)]
    runs = []
    for srv in [one] + fleets:
        for sid, w in wavs.items():
            srv.submit(sid, w)
            srv.finish(sid)
        ops.COUNTS.reset()
        runs.append((srv.drain(), ops.COUNTS.launches))
    fleets[1].close()
    per = lambda evs: {s: [{k: v for k, v in e.items() if k != "device"}
                           for e in evs if e["stream"] == s] for s in wavs}
    (ev1, _), (ev_seq, n_seq), (ev_par, n_par) = runs
    assert per(ev_seq) == per(ev1) and per(ev_par) == per(ev1) and ev1
    for fleet, n in zip(fleets, (n_seq, n_par)):
        assert n == 5 * sum(p._imc_passes for p in fleet.pools)
        assert all(p._compiled_ticks > 0 for p in fleet.pools)
        assert fleet.stats()["audit"]["violations"] == 0


# ---------------------------------------------------------------------------
# The LM stack's serving path and the examples on the card
# ---------------------------------------------------------------------------

LM_CARD_ARCHS = ["qwen2.5-14b", "starcoder2-15b", "internvl2-2b",
                 "qwen3-moe-30b-a3b", "qwen2-moe-a2.7b", "zamba2-1.2b",
                 "xlstm-125m"]


@pytest.mark.parametrize("arch", LM_CARD_ARCHS)
def test_reduced_lm_on_the_card_equals_the_cpu(dev, arch):
    """Prefill (the VLM with its prefix frames) and 8 teacher-forced
    decode steps on the card against the CPU on the same parameters, and
    ``Server(device="cuda")``'s greedy tokens on ``main()``'s traffic
    against the CPU server's: ``launch.crosscheck``'s tolerance and fork
    rules (the MoE routing's too), which ``chip_smoke.py`` phase 16 (b)
    applies too; the recurrent families to their own tolerance,
    ``crosscheck.lm_ulps``."""
    from repro_torch.launch import crosscheck
    out = crosscheck.card_against_cpu(arch, dev)
    limit = crosscheck.lm_ulps(crosscheck.serve.get_config(arch))
    for key in ("prefill_ulps", "prefill_cache_ulps", "decode_ulps",
                "decode_cache_ulps"):
        assert out[key] <= limit, (key, out[key])


@pytest.mark.parametrize("arch", LM_CARD_ARCHS + ["seamless-m4t-medium"])
def test_lm_draw_on_the_card_equals_the_cpu(dev, arch):
    """``init_params_for`` from ``PRNGKey(0)`` on the card: the CPU's
    float32 and bfloat16 leaves bit for bit (``jaxrand``)."""
    from repro_torch.launch import crosscheck
    assert crosscheck.init_card_against_cpu(arch, dev)["leaves"] > 0


@pytest.mark.parametrize("arch", LM_CARD_ARCHS + ["seamless-m4t-medium"])
def test_reduced_train_step_on_the_card_against_the_cpu(dev, arch):
    """One ``make_train_step`` step on the card against the CPU from the
    same float32 parameters and batch: ``launch.crosscheck``'s training
    tolerances (a MoE step with its routing forks counted; the recurrent
    families' own, ``crosscheck.TRAIN_FAMILY``), which ``chip_smoke.py``
    phase 17 (a) and (c) apply too."""
    from repro_torch.launch import crosscheck
    out = crosscheck.train_step_card_against_cpu(arch, dev)
    family = crosscheck.serve.get_config(arch).family
    assert out["loss_rtol"] <= crosscheck.TRAIN_FAMILY.get(
        family, (crosscheck.TRAIN_LOSS_RTOL,))[0]
    assert out["params_equal"] >= crosscheck.TRAIN_PARAMS_EQUAL


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "qwen2-moe-a2.7b"])
def test_forced_tie_routes_to_the_lower_index_on_the_card(dev, arch):
    """A MoE layer whose router columns 1 and 3 are equal (their
    probabilities tie on every token), then all equal: on the card the
    stable sort ranks the lower index first, as on the CPU, and the
    layer's output equals the CPU's within ``crosscheck.LM_ULPS``."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import crosscheck
    from repro_torch.models import lm as LM
    from repro_torch.models import moe as MOE
    mcfg = get_config(arch).reduced().moe
    p = MOE.moe_init(jaxrand.PRNGKey(3, device="cpu"), mcfg, "cpu")
    x = torch.tensor(np.random.default_rng(6).standard_normal(
        (2, 8, mcfg.d_model)), dtype=torch.bfloat16)

    def both_devices():
        runs = []
        for d in ("cpu", dev):
            with MOE.record_routes() as r:
                out, _ = MOE.moe_apply(LM.tree_map(lambda a: a.to(d), p),
                                       mcfg, x.to(d))
            runs.append((out.cpu(), r[0]["expert_idx"].cpu()))
        (out_c, idx_c), (out_g, idx_g) = runs
        assert torch.equal(idx_g, idx_c)
        assert crosscheck.ulps_apart(out_g, out_c) <= crosscheck.LM_ULPS
        return idx_g
    router = p["router"]["w"]
    router[:, 3] = router[:, 1]
    rows = both_devices().reshape(-1, mcfg.top_k).tolist()
    both = [r for r in rows if 1 in r and 3 in r]
    assert both and all(r.index(1) < r.index(3) for r in both)
    router[:] = router[:, :1]
    assert (both_devices() == torch.arange(mcfg.top_k)).all()


def test_reduced_encdec_on_the_card_equals_the_cpu(dev):
    """The reduced seamless-m4t-medium on the card against the CPU
    (``crosscheck.encdec_card_against_cpu``, which ``chip_smoke.py``
    phase 16 (b) runs too): ``make_prefill_step``'s last logits, K/V and
    memory, 8 teacher-forced ``make_decode_step`` steps and the greedy
    tokens of ``encdec_generate``, within ``crosscheck.lm_ulps``."""
    from repro_torch.launch import crosscheck
    out = crosscheck.encdec_card_against_cpu("seamless-m4t-medium", dev)
    limit = crosscheck.lm_ulps(
        crosscheck.serve.get_config("seamless-m4t-medium"))
    for key in ("prefill_ulps", "prefill_cache_ulps", "memory_ulps",
                "decode_ulps", "decode_cache_ulps"):
        assert out[key] <= limit, (key, out[key])


def test_reduced_encdec_training_resumes_on_the_card(dev, tmp_path):
    """The reference's fault-tolerance test on the card for the reduced
    seamless-m4t-medium: 12 steps straight against a failure at step 9
    resumed from step 8, final losses within 1e-4."""
    from repro_torch.launch import crosscheck
    out = crosscheck.resume_against_straight("seamless-m4t-medium", dev,
                                             str(tmp_path))
    assert out["gap"] < crosscheck.RESUME_ATOL


def test_reduced_training_resumes_on_the_card(dev, tmp_path):
    """The reference's fault-tolerance test on the card: 12 steps of the
    reduced qwen2.5-14b straight against a run that fails at step 9 and
    resumes from its step-8 checkpoint, final losses within 1e-4."""
    from repro_torch.launch import crosscheck
    out = crosscheck.resume_against_straight("qwen2.5-14b", dev,
                                             str(tmp_path))
    assert out["gap"] < crosscheck.RESUME_ATOL


def test_stream_kws_example_on_the_card(dev, monkeypatch, capsys):
    """The ``stream_kws`` example at its smoke size on the card: K1 five
    launches per IMC forward, and the same lines as on the CPU but the
    device and the decisions/s."""
    from repro_torch.examples import stream_kws
    monkeypatch.setenv("REPRO_EXAMPLES_SMOKE", "1")
    keep = lambda out: [ln for ln in out.splitlines()
                        if "decisions/s" not in ln and "serving" not in ln]
    stream_kws.main(["--device", "cpu"])
    want = keep(capsys.readouterr().out)
    ops.COUNTS.reset()
    stream_kws.main(["--device", "cuda"])
    got = keep(capsys.readouterr().out)
    assert ops.COUNTS.launches > 0 and ops.COUNTS.launches % 5 == 0
    assert got == want


# ---------------------------------------------------------------------------
# The launch code on the card: a world-1 NCCL group, a 1 x 1 mesh
# ---------------------------------------------------------------------------


@pytest.fixture
def nccl_world(dev):
    """A world-1 NCCL process group (``launch.mesh.init_distributed``),
    destroyed after the test."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    M.init_distributed(dev)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def test_world1_sharded_steps_are_the_plain_steps_on_the_card(dev,
                                                             nccl_world):
    """The reduced internvl2-2b on a 1 x 1 mesh: the sharded train step
    (parameters and Adam's moments as ``DTensor``s) bit for bit the plain
    step, and the sharded prefill and decode steps bit for bit the plain
    ones; no collective moves a byte, as the plans say (``chip_smoke.py``
    phase 18 (a) runs the full width)."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import TokenPipelineConfig, batch_at_step
    from repro_torch.launch import analysis, elastic, sharded, steps, train
    from repro_torch.launch import mesh as M
    from repro_torch.launch.mesh_policy import MeshPolicy
    from repro_torch.models import lm as LM
    from repro_torch.optim.optimizers import OptState, tree_leaves
    cfg = get_config("internvl2-2b").reduced()
    params = steps.init_params_for(cfg, jaxrand.PRNGKey(0, device="cpu"),
                                   device=dev, dtype=torch.float32)
    opt = steps.make_optimizer(cfg)
    state = opt.init(params)
    pipe = TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=32,
                               global_batch=4)
    batch = train.model_batch(cfg, *batch_at_step(pipe, 0), dev)
    mesh = M.make_debug_mesh(1, 1, device=dev)
    policy = MeshPolicy(mesh)
    specs = policy.param_specs(params)
    dparams = elastic.reshard_to(mesh, params, specs)
    dstate = OptState(0, elastic.reshard_to(mesh, state.mu, specs),
                      elastic.reshard_to(mesh, state.nu, specs))
    want = steps.make_train_step(cfg, opt)(params, state, batch)
    with analysis.count_collectives() as coll:
        got = steps.make_train_step(cfg, opt, policy=policy)(
            dparams, dstate, batch)
    for a, b in zip(tree_leaves([got[0], got[1].mu, got[1].nu]),
                    tree_leaves([want[0], want[1].mu, want[1].nu])):
        assert torch.equal(_whole(a), b)
    assert torch.equal(got[2]["loss"], want[2]["loss"])
    assert coll["total"] == 0 == sharded.train_plan(policy, cfg, params,
                                                    batch)["total"]

    prompt = batch["tokens"][:, :8]
    frames = batch["frames"]
    lw, cw = steps.make_prefill_step(cfg)(params, {"tokens": prompt,
                                                   "frames": frames})
    lg, cg = steps.make_prefill_step(cfg, policy=policy)(
        dparams, {"tokens": prompt, "frames": frames})
    assert torch.equal(lg, lw)
    assert all(torch.equal(_whole(a), b)
               for a, b in zip(tree_leaves(cg), tree_leaves(cw)))
    cache = LM.init_cache(cfg, 4, 16, device=dev)
    dcache = elastic.reshard_to(mesh, cache, policy.cache_specs(cache))
    decode = steps.make_decode_step(cfg)
    sdecode = steps.make_decode_step(cfg, policy=policy)
    for t in range(8):
        b = {"tokens": prompt[:, t:t + 1], "index": torch.tensor(t)}
        lw, cache = decode(params, cache, b)
        lg, dcache = sdecode(dparams, dcache, b)
        assert torch.equal(lg, lw)
    assert all(torch.equal(_whole(a), b)
               for a, b in zip(tree_leaves(dcache), tree_leaves(cache)))


@pytest.mark.parametrize("scale", [1e-2, 1e-13, 127 / 64],
                         ids=["seeded", "tiny", "pow2_edge"])
def test_compressed_mean_on_nccl_equals_gloo_on_the_cpu(dev, nccl_world,
                                                        scale):
    """``compressed_allreduce_mean`` on the card (NCCL, world 1) against
    the same function on a gloo group on the CPU, bit for bit: seeded
    gradients and residuals, gradients near 1e-13 (XLA's scale is no power
    of two there) and a largest magnitude of 127 / 64 (``127 / max_abs``
    exactly 64); ``chip_smoke.py`` phase 18 (b) runs the full-width
    gradient tree."""
    import torch.distributed as dist
    from repro_torch.core import grad_compress as gcmp
    gen = torch.Generator().manual_seed(7)
    g = torch.randn(8, 1000, generator=gen) * scale
    r = torch.randn(8, 1000, generator=gen) * scale * 1e-2
    if scale == 127 / 64:
        g = g.clamp(-1.9, 1.9)
        g[3, 5] = 127 / 64
        r = torch.zeros_like(g)
    cpu_group = dist.new_group(ranks=[0], backend="gloo")
    try:
        want = gcmp.compressed_allreduce_mean(g, r, group=cpu_group)
    finally:
        dist.destroy_process_group(cpu_group)
    got = gcmp.compressed_allreduce_mean(g.to(dev), r.to(dev))
    for a, b in zip(got, want):
        assert a.device.type == "cuda"
        assert torch.equal(a.cpu(), b)
