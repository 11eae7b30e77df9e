"""Compiled ticks on the port (``repro_torch.serving.compiled``), on the
CPU, where a block's steps run eagerly.

The port of ``tests/test_compiled.py`` at its small config: a compiled
server (``StreamServer(compiled=CompiledTickConfig(...))``) held against
the port's own interpreted server over the same traffic, bit for bit:
events, every stream, decision and VAD state leaf, the recorder's events
and every registry cell but the wall time, the ``serving.compiled``
counts and ``serving.imc_passes`` (a block counts one IMC forward per
step that computes; the fused layer's calls, ``ops.CALLS``, are held to 5
x ``imc_passes`` on both servers instead).  JAX's compiled tick fails its
own soak and golden tests, so it is no oracle here; two cases are held
against JAX's interpreted server in ``test_torch_compiled_jax.py``.

Covered: the reference's eight cases, faults injected between and
drifting inside blocks, the SLO shed that falls back, ``step()`` routing
one-tick blocks, block sizes 1 to 32, ``drain``, admission and eviction
mid-run, snapshots across tick modes, blocks interleaved with
interpreted ticks, a resize, a restore and an injection, the launch
auditor in raise mode, the sharded fleet (sequential and
``parallel=True``) against the plain fleet and one server, the stats
section, a soak over random interleavings with the reference's failing
example (seed 3840) among its seeds, ``vad_scan`` against ``vad_step``s
and ``stream_multi_step`` against sequential steps with noise and riders.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import numpy as np
import pytest
import torch

import _equiv as eq
from repro_torch.core import faults as flt
from repro_torch.core import imc, jaxrand
from repro_torch.kernels.imc_mav import ops
from repro_torch.models import kws
from repro_torch.obs import ObsConfig
from repro_torch.serving import (AdmissionConfig, CompiledTickConfig,
                                 DynamicHopConfig, ShardedStreamServer,
                                 StreamServer, VADConfig, stream as sv,
                                 vad as vd)

L, HOP = 640, 64
CFG = kws.KWSConfig(sample_len=L)
CHANS = {f"conv{i}": CFG.channels[i] for i in range(1, CFG.num_conv_layers)}
# a block counts one IMC forward per step that computes, the interpreted
# tick one per replay call and one per batched hop
EXCLUDES = eq.COUNTER_EXCLUDES + ("serving.imc_passes",)

pytestmark = [pytest.mark.streaming, pytest.mark.compiled]


@pytest.fixture(scope="module")
def hw():
    params = kws.init_params(jaxrand.PRNGKey(5, device="cpu"), CFG,
                             device="cpu")
    return kws.fold_params(params, kws.init_state(CFG, device="cpu"), CFG,
                           pack=True)


def _chip(std=4.0):
    return imc.sample_chip_offsets(jaxrand.PRNGKey(9, "cpu"), CHANS,
                                   imc.IMCNoiseParams(mav_offset_std=std))


def _duty(n, seed, duty=0.45, period=3 * HOP):
    """Speech/silence duty-cycled audio (the reference test's): uniform
    noise with seeded runs of near-silence, so gating, wake replays and
    calm ticks all happen."""
    r = np.random.default_rng(seed)
    x = r.uniform(-1.0, 1.0, n).astype(np.float32)
    t = 0
    while t < n:
        if r.random() > duty:
            x[t:t + period] *= 1e-4
        t += period
    return x


def _server(hw, block=None, slots=3, **kw):
    return StreamServer(hw, CFG, hop=HOP, slots=slots, device="cpu",
                        compiled=(CompiledTickConfig(block=block)
                                  if block else None), **kw)


def _same(ref, cand, what, counters=True):
    eq.assert_server_equal(ref, cand, what, counters=False)
    if counters:
        eq.assert_counters_equal(ref, cand, what, exclude=EXCLUDES)
    if ref.recorder is not None:
        assert cand.recorder.events() == ref.recorder.events(), what


def _advance(srv, ticks):
    """``eq.advance_to`` with the fused layer's calls counted."""
    c0, p0 = ops.CALLS.calls, srv._imc_passes
    events = eq.advance_to(srv, ticks)
    assert ops.CALLS.calls - c0 == 5 * (srv._imc_passes - p0)
    return events


def _run_pair(hw, kw, ticks=30, n_streams=3, block=8, slots=3, inject=None,
              audio_len=None, inject_at=None):
    """An interpreted server and a compiled one over the same traffic to
    the same tick (``inject`` applied to both at the start, or at tick
    ``inject_at``), then the equivalence contract."""
    kw = dict(kw, obs=ObsConfig(recorder=512))
    ref = _server(hw, slots=slots, **kw)
    cand = _server(hw, block=block, slots=slots, **kw)
    n = audio_len if audio_len is not None else L + 22 * HOP
    auds = [_duty(n, 100 + i) for i in range(n_streams)]
    for srv in (ref, cand):
        if inject is not None and inject_at is None:
            inject(srv)
        for i, x in enumerate(auds):
            srv.submit(f"s{i}", x)
    events = []
    for srv in (ref, cand):
        ev = []
        if inject_at is not None:
            ev += _advance(srv, inject_at)
            inject(srv)
        events.append(ev + _advance(srv, ticks))
    assert cand._steps == ref._steps == ticks
    eq.assert_events_equal(events[0], events[1], "compiled vs interpreted")
    _same(ref, cand, "compiled vs interpreted")
    return ref, cand, events[0]


CASES = {
    "gated_clean": lambda: dict(vad=VADConfig()),
    "ungated": lambda: dict(),
    "noise_and_chip": lambda: dict(vad=VADConfig(), sa_noise_std=0.15,
                                   chip_offsets=_chip()),
    "wake_margin2": lambda: dict(
        vad=VADConfig(threshold_on_db=-40.0, threshold_off_db=-50.0,
                      wake_margin=2, hang=0), sa_noise_std=0.2),
    "fault_drift": lambda: dict(vad=VADConfig(),
                                faults=flt.FaultConfig(drift_std=0.5)),
    "dynamic_hop": lambda: dict(
        vad=VADConfig(),
        dynamic_hop=DynamicHopConfig(widen_after=4, max_multiplier=2)),
    "dynhop_duty_aware": lambda: dict(
        vad=VADConfig(),
        dynamic_hop=DynamicHopConfig(widen_after=5, max_multiplier=2,
                                     calm_silence=2)),
    "autoscale": lambda: dict(
        vad=VADConfig(),
        admission=AdmissionConfig(min_slots=1, max_slots=3,
                                  scale_up_after=2, scale_down_after=3)),
}


def test_config_rejects_block_below_one():
    with pytest.raises(ValueError, match="block"):
        CompiledTickConfig(block=0)
    assert CompiledTickConfig().block == 8


@pytest.mark.parametrize("case", sorted(CASES))
def test_compiled_block_bitident(hw, case):
    """Blocks of steady ticks equal the interpreted ticks bit for bit:
    events, carries, recorder and counters."""
    ref, cand, events = _run_pair(hw, CASES[case](), ticks=30)
    assert events
    assert cand._compiled_ticks > 0, "no block ran"
    assert cand._compiled_blocks <= cand._compiled_ticks
    if case in ("gated_clean", "wake_margin2", "noise_and_chip"):
        assert ref.stats()["batched_calls"]["replay"] > 0


def test_compiled_injected_faults_bitident(hw):
    """Stuck columns and trim-bit flips injected between blocks, on a
    noisy chip with offsets, ride the blocks' riders as they ride the
    interpreted calls."""
    def inject(srv):
        srv.faults.inject_stuck("conv2", [0, 5])
        srv.faults.inject_bit_flips(n=2)
    ref, cand, _ = _run_pair(
        hw, dict(vad=VADConfig(), sa_noise_std=0.3, chip_offsets=_chip(),
                 faults=flt.FaultConfig(drift_std=0.3, seed=3)),
        inject=inject, inject_at=9)
    assert cand._compiled_ticks > 0
    assert cand.faults.stats() == ref.faults.stats()


def test_compiled_slo_shed_falls_back(hw):
    """A backlog over the latency SLO is structural: the horizon refuses
    the block and the interpreted tick sheds; blocks serve the stretches
    within the SLO in between."""
    kw = dict(vad=VADConfig(), obs=ObsConfig(recorder=512),
              admission=AdmissionConfig(max_lag_s=(L + 6 * HOP) / 16000))
    ref = _server(hw, **kw)
    cand = _server(hw, block=8, **kw)
    auds = [_duty(L + 60 * HOP, 100 + i) for i in range(3)]
    cuts = [0, L + 20 * HOP, L + 24 * HOP, L + 28 * HOP, L + 44 * HOP,
            L + 48 * HOP, L + 52 * HOP, L + 60 * HOP]
    ev = [[], []]
    for r, (a, b) in enumerate(zip(cuts, cuts[1:])):
        for i, srv in enumerate((ref, cand)):
            for sid, x in enumerate(auds):
                srv.submit(f"s{sid}", x[a:b])
            ev[i] += _advance(srv, 4 * (r + 1))
    eq.assert_events_equal(ev[0], ev[1], "SLO shed")
    _same(ref, cand, "SLO shed")
    assert ref.stats()["shed"]["events"] >= 6
    assert cand._compiled_ticks > 0


def test_step_routes_single_tick_blocks(hw):
    """``step()`` on a compiled server serves eligible ticks as one-tick
    blocks, with the interpreted tick's events."""
    ref = _server(hw, slots=2, vad=VADConfig())
    cand = _server(hw, block=8, slots=2, vad=VADConfig())
    for srv in (ref, cand):
        for i in range(2):
            srv.submit(f"s{i}", _duty(L + 10 * HOP, 40 + i))
    ev_ref, ev_cand = [], []
    for _ in range(14):
        ev_ref.extend(ref.step())
        ev_cand.extend(cand.step())
    eq.assert_events_equal(ev_ref, ev_cand, "step() routing")
    _same(ref, cand, "step() routing")
    assert cand._compiled_ticks > 0
    assert cand._compiled_blocks == cand._compiled_ticks


def test_block_sizes_all_equal(hw):
    """Every block size serves the same decisions; bigger blocks take
    fewer blocks."""
    kw = dict(vad=VADConfig(), sa_noise_std=0.2)
    runs = {}
    for block in (1, 2, 3, 4, 8, 32):
        srv = _server(hw, block=block, slots=2, **kw)
        for i in range(2):
            srv.submit(f"s{i}", _duty(L + 16 * HOP, 70 + i))
        runs[block] = (srv, _advance(srv, 20))
    ref_srv, ref_ev = runs[1]
    for block, (srv, ev) in runs.items():
        eq.assert_events_equal(ref_ev, ev, f"block={block}")
        eq.assert_server_equal(ref_srv, srv, f"block={block}",
                               counters=False)
        eq.assert_counters_equal(ref_srv, srv, f"block={block}",
                                 exclude=EXCLUDES)
    assert runs[32][0]._compiled_blocks < runs[1][0]._compiled_blocks


def test_compiled_drain_matches(hw):
    """``drain()`` in blocks retires what the interpreted drain retires,
    in as many ticks."""
    ref = _server(hw, slots=2, vad=VADConfig())
    cand = _server(hw, block=8, slots=2, vad=VADConfig())
    for srv in (ref, cand):
        for i in range(2):
            srv.submit(f"s{i}", _duty(L + 12 * HOP, 55 + i))
            srv.finish(f"s{i}")
    ev_ref, ev_cand = ref.drain(), cand.drain()
    eq.assert_events_equal(ev_ref, ev_cand, "drain")
    assert ref._steps == cand._steps
    _same(ref, cand, "drain")
    assert cand._compiled_ticks > 0 and not cand.active_streams()


def test_compiled_admission_eviction_mid_run(hw):
    """An admission and an eviction mid-run end a block; the interpreted
    tick does the structural work and blocks resume after."""
    kw = dict(vad=VADConfig(), sa_noise_std=0.2)
    ref = _server(hw, slots=3, **kw)
    cand = _server(hw, block=4, slots=3, **kw)
    for srv in (ref, cand):
        srv.submit("a", _duty(L + 20 * HOP, 1))
        srv.submit("b", _duty(L + 20 * HOP, 2))
    ev_ref, ev_cand = _advance(ref, 6), _advance(cand, 6)
    for srv in (ref, cand):
        srv.submit("c", _duty(L + 12 * HOP, 3))
        srv.evict("a")
    ev_ref += _advance(ref, 18)
    ev_cand += _advance(cand, 18)
    eq.assert_events_equal(ev_ref, ev_cand, "admit/evict mid-run")
    _same(ref, cand, "admit/evict mid-run")
    assert cand._compiled_ticks > 0


def test_snapshot_restore_across_tick_modes(hw):
    """A snapshot taken mid-run by a compiled server restores into an
    interpreted one and into a compiled one, and both continue as the
    uninterrupted server."""
    kw = dict(vad=VADConfig(), sa_noise_std=0.25, chip_offsets=_chip(),
              faults=flt.FaultConfig(seed=5))
    cand = _server(hw, block=4, slots=2, **kw)
    for i in range(2):
        cand.submit(f"s{i}", _duty(L + 18 * HOP, 90 + i))
    _advance(cand, 7)
    snap = cand.snapshot()
    plain = _server(hw, slots=2, **kw)
    plain.restore(snap)
    resumed = _server(hw, block=4, slots=2, **kw)
    resumed.restore(snap)
    ev_plain = _advance(plain, 20)
    ev_resumed = _advance(resumed, 20)
    ev_cand = _advance(cand, 20)
    eq.assert_events_equal(ev_cand, ev_plain, "compiled -> interpreted")
    eq.assert_events_equal(ev_cand, ev_resumed, "compiled -> compiled")
    eq.assert_server_equal(cand, plain, "compiled -> interpreted",
                           counters=False)
    eq.assert_server_equal(cand, resumed, "compiled -> compiled",
                           counters=False)
    eq.assert_counters_equal(cand, resumed, "compiled -> compiled",
                             exclude=eq.COUNTER_EXCLUDES)
    assert resumed._compiled_ticks > 0 and ev_cand


def test_blocks_interleaved_with_structural_changes(hw):
    """Blocks, interpreted ticks, a resize, a restore and a fault
    injection in one run: every tensor a block reads is replaced between
    blocks, and the run stays bit for bit the interpreted one's."""
    kw = dict(vad=VADConfig(), sa_noise_std=0.2, chip_offsets=_chip(),
              faults=flt.FaultConfig(drift_std=0.2, seed=4),
              admission=AdmissionConfig(min_slots=2, max_slots=4))
    ref = _server(hw, slots=2, **kw)
    cand = _server(hw, block=4, slots=2, **kw)
    for srv in (ref, cand):
        for i in range(2):
            srv.submit(f"s{i}", _duty(L + 30 * HOP, 200 + i))
    ev = [_advance(ref, 5), _advance(cand, 5)]
    for i, srv in enumerate((ref, cand)):
        ev[i] += srv.step()                  # an interpreted tick
        srv._resize(4)                       # grow the pool
        srv.submit("s2", _duty(L + 12 * HOP, 202))
        ev[i] += _advance(srv, 12)
    snap = cand.snapshot()
    fresh = _server(hw, block=4, slots=2, **kw)
    fresh.restore(snap)
    cand = fresh
    for i, srv in enumerate((ref, cand)):
        srv.faults.inject_stuck("conv3", [2, 7])
        ev[i] += _advance(srv, 24)
    eq.assert_events_equal(ev[0], ev[1], "interleaved")
    eq.assert_server_equal(ref, cand, "interleaved", counters=False)
    assert cand.slots == ref.slots and cand._compiled_ticks > 0


def test_compiled_audit_raise_clean(hw):
    """The raising launch auditor on a gated noisy run: no violation, one
    ``compiled`` call per block attributed to its first tick, and the
    other ticks of a block with no launch."""
    srv = _server(hw, block=8, slots=2, vad=VADConfig(), sa_noise_std=0.2,
                  chip_offsets=_chip(), obs=ObsConfig(audit="raise"))
    for i in range(2):
        srv.submit(f"s{i}", _duty(L + 16 * HOP, 20 + i))
        srv.finish(f"s{i}")
    srv.drain()
    s = srv.auditor.stats()
    assert s["violations"] == 0
    assert s["calls"]["compiled"] == srv._compiled_blocks > 0
    hist = srv.auditor.history()
    blocks = [h for h in hist if h["calls"]["compiled"]]
    assert blocks and all(h["calls"]["compiled"] == 1 for h in blocks)
    assert any(h["launches"] == 0 for h in hist)
    assert sum(h["k1_calls"] for h in hist) == 5 * srv._imc_passes


@pytest.mark.parametrize("parallel", [False, True],
                         ids=["sequential", "parallel"])
def test_sharded_compiled_bitident(hw, parallel):
    """A fleet of compiled pools serves each stream the events of the
    plain fleet and of one server, each pool's raising auditor clean and
    counting its own blocks."""
    obs = ObsConfig(audit="raise")
    kw = dict(hop=HOP, sa_noise_std=0.2, vad=VADConfig(), seed=0, obs=obs)
    oracle = StreamServer(hw, CFG, slots=4, device="cpu", **kw)
    plain = ShardedStreamServer(hw, CFG, devices=["cpu", "cpu"], slots=2,
                                parallel=parallel, **kw)
    fast = ShardedStreamServer(hw, CFG, devices=["cpu", "cpu"], slots=2,
                               parallel=parallel,
                               compiled=CompiledTickConfig(block=8), **kw)
    for i in range(4):
        w = _duty(L + 12 * HOP, 500 + i)
        for srv in (oracle, plain, fast):
            srv.submit(f"s{i}", w)
            srv.finish(f"s{i}")
    ev_o, ev_p, ev_f = oracle.drain(), plain.drain(), fast.drain()
    for fleet in (plain, fast):
        fleet.close()
    eq.assert_events_equal(ev_p, ev_f, "plain vs compiled fleet",
                           by_stream=True)
    eq.assert_events_equal(ev_o, ev_f, "one server vs compiled fleet",
                           by_stream=True)
    assert ev_f and not fast.active_streams()
    for d, pool in enumerate(fast.pools):
        assert pool._compiled_ticks > 0
        s = pool.auditor.stats()
        assert s["violations"] == 0 and s["device"] == d
        assert s["calls"]["compiled"] == pool._compiled_blocks > 0
    # a fleet without compiled pools: step_block is one interpreted tick
    steps = plain.pools[0]._steps
    plain.step_block()
    assert plain.pools[0]._steps == steps + 1


def test_compiled_stats_section(hw):
    srv = _server(hw, block=4, slots=2)
    srv.submit("s0", _duty(L + 8 * HOP, 7))
    srv.finish("s0")
    srv.drain()
    st = srv.stats()["compiled"]
    assert st["block"] == 4
    assert st["ticks"] >= st["blocks"] > 0
    assert "compiled" not in _server(hw, slots=2).stats()


# ---------------------------------------------------------------------------
# the soak: random interleavings, the reference's failing example first
# ---------------------------------------------------------------------------


def _soak(hw, seed, rounds=8):
    """Submits, speech and silence bursts, evictions, finishes and a
    mid-soak snapshot swap, served by an interpreted server and a compiled
    one advanced to the same tick after every round (held then), and
    drained at the end (the compiled drain judges a block by its last
    tick, so both stop after the same tick)."""
    rng = np.random.default_rng(seed)
    kw = dict(use_kernel=False, sa_noise_std=0.5,
              vad=VADConfig(threshold_on_db=-40.0, threshold_off_db=-50.0,
                            wake_margin=1, hang=0),
              dynamic_hop=DynamicHopConfig(widen_after=3, max_multiplier=2),
              faults=flt.FaultConfig(drift_std=0.1, seed=seed), seed=seed)
    oracle = _server(hw, **kw)
    cand = _server(hw, block=4, **kw)
    alive = {}
    ev_o, ev_c = [], []
    for t in range(rounds):
        r = rng.random()
        if r < 0.4 and len(alive) < 3:
            sid = f"s{t}"
            alive[sid] = True
            w = rng.uniform(-1, 1, L).astype(np.float32)
            oracle.submit(sid, w)
            cand.submit(sid, w)
        elif r < 0.5 and alive:
            sid = rng.choice(sorted(alive))
            del alive[sid]
            oracle.evict(sid)
            cand.evict(sid)
        elif r < 0.6 and alive:
            sid = rng.choice(sorted(alive))
            del alive[sid]
            oracle.finish(sid)
            cand.finish(sid)
        for sid in list(alive):
            amp = 1.0 if rng.random() < 0.6 else 1e-4
            n = int(rng.integers(1, 4)) * HOP
            w = (amp * rng.standard_normal(n)).astype(np.float32)
            oracle.submit(sid, w)
            cand.submit(sid, w)
        target = oracle._steps + int(rng.integers(1, 5))
        ev_o += eq.advance_to(oracle, target)
        ev_c += eq.advance_to(cand, target)
        eq.assert_events_equal(ev_o, ev_c, f"seed={seed} round {t}")
        eq.assert_server_equal(oracle, cand, f"seed={seed} round {t}",
                               counters=False)
        if t == rounds // 2:
            cand2 = _server(hw, block=4, **kw)
            cand2.restore(cand.snapshot())
            cand = cand2
    for sid in alive:
        oracle.finish(sid)
        cand.finish(sid)
    ev_o += oracle.drain()
    ev_c += cand.drain()
    eq.assert_events_equal(ev_o, ev_c, f"soak seed={seed}")
    assert oracle._steps == cand._steps
    eq.assert_server_equal(oracle, cand, f"soak seed={seed}",
                           counters=False)


@pytest.mark.parametrize("seed", [3840, 0, 17, 4242])
def test_compiled_soak(hw, seed):
    """Any interleaving keeps the compiled server the interpreted one, bit
    for bit.  Seed 3840 is the example the reference's own soak fails on:
    there an interpreted ``drain()`` stops after a widening retarget's
    tick with audio still buffered, and a block-stepped drain did not."""
    _soak(hw, seed)


# ---------------------------------------------------------------------------
# the pieces: vad_scan, stream_multi_step
# ---------------------------------------------------------------------------


def test_vad_scan_equals_steps_and_pads_exactly():
    """``vad_scan`` over K hops equals K ``vad_step`` calls, state and
    flags; all-inactive padded steps change nothing."""
    rng = np.random.default_rng(3)
    k, b = 7, 4
    vcfg = VADConfig(hang=1)
    amp = np.where(rng.random((k, b, 1)) < 0.5, 1.0, 1e-4)
    audio = torch.from_numpy(
        (amp * rng.uniform(-1, 1, (k, b, HOP))).astype(np.float32))
    active = torch.from_numpy(rng.random((k, b)) < 0.8)
    st = vd.vad_init(b, device="cpu")
    want = []
    for t in range(k):
        st, f = vd.vad_step(vcfg, st, audio[t], active[t])
        want.append(f)
    got_st, got = vd.vad_scan(vcfg, vd.vad_init(b, device="cpu"), audio,
                              active)
    assert torch.equal(got, torch.stack(want))
    for x, y in zip(got_st, st):
        assert torch.equal(x, y)
    pad = torch.zeros((3, b, HOP))
    pst, pflags = vd.vad_scan(vcfg, vd.vad_init(b, device="cpu"),
                              torch.cat([audio, pad + 0.5]),
                              torch.cat([active, torch.zeros((3, b),
                                                             dtype=bool)]))
    for x, y in zip(pst, st):
        assert torch.equal(x, y)
    assert torch.equal(pflags[:k], got)
    assert torch.equal(pflags[k:], got[-1].expand(3, b))
    empty_st, flags = vd.vad_scan(vcfg, st, audio[:0], active[:0])
    assert flags.shape == (0, b) and empty_st is st


def test_multi_step_equals_sequential_steps_with_noise_and_riders(hw):
    """A wake replay's one multi-hop call equals the block's n single
    steps, with SA noise, chip offsets and per-stream riders (bias deltas
    and heads): logits and every state leaf."""
    geom = sv.make_stream_geometry(CFG, HOP)
    rng = np.random.default_rng(8)
    b, n = 3, 4
    chip = _chip()
    keys = jaxrand.fold_in(jaxrand.PRNGKey(1, "cpu"),
                           torch.arange(b, dtype=torch.int64))
    kw = dict(chip_offsets=chip, sa_noise_std=0.5)
    delta = {k: torch.from_numpy(rng.integers(-3, 4, (b, c)).astype(
        np.float32)) for k, c in CHANS.items()}
    hwp, _ = kws.as_hw_params(hw)
    head_w = hwp.fc_w.expand((b,) + hwp.fc_w.shape).clone()
    head_w[1] = torch.from_numpy(np.round(rng.normal(
        size=hwp.fc_w.shape) * 64).astype(np.float32) / 128)
    head_b = hwp.fc_b.expand((b,) + hwp.fc_b.shape).clone()
    riders = dict(bias_delta=delta, head_w=head_w, head_b=head_b)
    win = torch.from_numpy(rng.uniform(-1, 1, (b, L)).astype(np.float32))
    _, st0 = sv.stream_init(hw, win, CFG, geom, keys=keys, **kw, **riders)
    audio = torch.from_numpy(rng.uniform(-1, 1, (b, n * HOP)).astype(
        np.float32))
    lg_multi, st_multi = sv.stream_multi_step(hw, st0, audio, CFG, geom, n,
                                              **kw, **riders)
    st = st0
    for j in range(n):
        lg, st = sv.stream_step(hw, st, audio[:, j * HOP:(j + 1) * HOP],
                                CFG, geom, **kw, **riders)
        assert torch.equal(lg, lg_multi[:, j])
    eq.assert_leaves_equal(st_multi, st, "multi-step vs steps")
