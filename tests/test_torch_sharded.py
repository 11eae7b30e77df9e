"""The port's sharded serving tier (``repro_torch.serving.shard`` and
``repro_torch.sharding``) on the CPU.

* The placement policy picks the same pools as the JAX package's
  ``PlacementPolicy`` on random load views, under both strategies
  (pure Python on both sides).
* The cases of ``tests/test_sharded_serving.py``, run as port fleets of
  two 2-slot pools (``devices=["cpu", "cpu"]``) against one 4-slot port
  server: each stream's events are bitwise equal (noise and chip
  offsets, VAD gating, faults and drift, snapshot bundles, a random
  interleaving with a mid-run fleet swap), rejections consume no uid,
  events carry their pool, and the rollup sums the pools.
* One small noisy, gated scenario against JAX's ``ShardedStreamServer``
  on its plain route: events (``score`` within 1e-6), placements and the
  fleet rollup less its wall fields.
* ``parallel=True`` under ``ObsConfig(audit="raise")`` with canaries and
  a customization session (``tests/test_obs.py``'s sharded audit case):
  no violation, and the events of the sequential fleet.

Small config: ``sample_len=640``, ``hop=64``; the port's net from
``init_params(PRNGKey(5))``, carried to JAX as numpy
(``test_torch_noise.jax_hw``).
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import numpy as np
import pytest
import torch

import _equiv as eq
from repro import sharding as jsh
from repro.models import kws as jkws
from repro.serving import ShardedStreamServer as JShardedStreamServer
from repro.serving import VADConfig as JVADConfig
from repro_torch.core import imc, jaxrand
from repro_torch.core.onchip_training import OnChipTrainConfig
from repro_torch.models import kws
from repro_torch.obs import ObsConfig
from repro_torch.serving import (AdmissionConfig, CustomizeConfig,
                                 FaultConfig, HealthConfig,
                                 ShardedStreamServer, StreamServer,
                                 VADConfig)
from repro_torch.sharding import (PlacementConfig, PlacementPolicy,
                                  PoolLoad)
from test_torch_noise import CHANS, jax_hw

L, HOP = 640, 64
CFG = kws.KWSConfig(sample_len=L)
JCFG = jkws.KWSConfig(sample_len=L)
CPU2 = ["cpu", "cpu"]
SCORE_ATOL = 1e-6
GATE_VAD = dict(threshold_on_db=-40.0, threshold_off_db=-50.0,
                wake_margin=1, hang=0)


@pytest.fixture(scope="module")
def hw():
    params = kws.init_params(jaxrand.PRNGKey(5, device="cpu"), CFG,
                             device="cpu")
    return kws.fold_params(params, kws.init_state(CFG, device="cpu"), CFG,
                           pack=True)


def _chip(std=4.0):
    return imc.sample_chip_offsets(jaxrand.PRNGKey(9, "cpu"), CHANS,
                                   imc.IMCNoiseParams(mav_offset_std=std))


def _wav(seed, n):
    return np.random.default_rng(seed).uniform(-1, 1, n).astype(np.float32)


def _pair(hw, **kw):
    """A 4-slot port server and a 2 x 2 port fleet, built alike."""
    return (StreamServer(hw, CFG, slots=4, device="cpu", **kw),
            ShardedStreamServer(hw, CFG, devices=CPU2, slots=2, **kw))


def _feed(servers, wavs):
    for srv in servers:
        for sid, w in wavs.items():
            srv.submit(sid, w)
            srv.finish(sid)


def _equiv(ev_oracle, ev_sharded):
    return eq.assert_events_equal(ev_oracle, ev_sharded, "sharded vs one",
                                  by_stream=True)


# ---------------------------------------------------------------------------
# the placement policy
# ---------------------------------------------------------------------------


def test_placement_least_loaded_then_queue_then_rr():
    p = PlacementPolicy(3)
    assert p.place([PoolLoad(1, 0), PoolLoad(3, 0), PoolLoad(2, 0)]) == 1
    assert p.place([PoolLoad(2, 4), PoolLoad(2, 1), PoolLoad(2, 2)]) == 1
    assert p.place([PoolLoad(2, 0), PoolLoad(2, 0), PoolLoad(2, 0)]) == 2
    assert p.place([PoolLoad(2, 0), PoolLoad(2, 0), PoolLoad(2, 0)]) == 0
    pd = PlacementPolicy(2, PlacementConfig(duty_aware=True))
    assert pd.place([PoolLoad(2, 0, duty=0.9),
                     PoolLoad(2, 0, duty=0.1)]) == 1


def test_placement_round_robin_snapshot_and_errors():
    p = PlacementPolicy(2, PlacementConfig(strategy="round_robin"))
    loads = [PoolLoad(0, 9), PoolLoad(4, 0)]
    assert [p.place(loads) for _ in range(4)] == [0, 1, 0, 1]
    snap = p.snapshot()
    q = PlacementPolicy(2, PlacementConfig(strategy="round_robin"))
    q.restore(snap)
    assert q.place(loads) == p.place(loads)
    with pytest.raises(ValueError, match="strategy mismatch"):
        PlacementPolicy(2).restore(snap)
    with pytest.raises(ValueError, match="strategy must be one of"):
        PlacementConfig(strategy="hash")
    with pytest.raises(ValueError, match="expected 2 load entries"):
        p.place([PoolLoad(1, 0)])
    with pytest.raises(ValueError, match="n_devices"):
        PlacementPolicy(0)


@pytest.mark.parametrize("strategy,duty_aware", [
    ("least_loaded", False), ("least_loaded", True), ("round_robin", False)])
def test_placement_matches_jax_policy(strategy, duty_aware):
    """The same pools as the JAX package's policy, pick by pick, over 400
    random load views of 1 to 5 pools, and the same snapshots."""
    rng = np.random.default_rng(7)
    for n in range(1, 6):
        port = PlacementPolicy(n, PlacementConfig(strategy, duty_aware))
        ref = jsh.PlacementPolicy(n, jsh.PlacementConfig(strategy,
                                                         duty_aware))
        for _ in range(80):
            views = [(int(rng.integers(0, 3)), int(rng.integers(0, 3)),
                      None if rng.random() < 0.2
                      else float(rng.integers(0, 4)) / 4)
                     for _ in range(n)]
            assert (port.place([PoolLoad(*v) for v in views])
                    == ref.place([jsh.PoolLoad(*v) for v in views]))
            assert port.snapshot() == ref.snapshot()


# ---------------------------------------------------------------------------
# the fleet against one server, bitwise per stream
# ---------------------------------------------------------------------------


def test_sharded_bitident_noise_and_chip_offsets(hw):
    """SA-noise fields keyed by the global uid and chip offsets: stream s3
    lands on pool 1 slot 1, and draws the field one server draws for it."""
    oracle, sh = _pair(hw, hop=HOP, sa_noise_std=0.3, chip_offsets=_chip(),
                       seed=0)
    wavs = {f"s{i}": _wav(100 + i, L + 4 * HOP) for i in range(4)}
    _feed((oracle, sh), wavs)
    po = _equiv(oracle.drain(), sh.drain())
    assert all(len(v) == 5 for v in po.values())   # init + 4 hops each
    assert sorted(sh.where(s) for s in wavs) == [0, 0, 1, 1]
    assert sh.devices == [torch.device("cpu")] * 2


def test_sharded_bitident_vad_gating(hw):
    """Gated fills and the wake replay are per slot: a quiet stretch
    gates on whichever pool the stream lives on, as on one server."""
    oracle, sh = _pair(hw, hop=HOP, vad=VADConfig(**GATE_VAD), seed=0)
    rng = np.random.default_rng(11)
    wavs = {}
    for i in range(4):
        w = rng.uniform(-1, 1, L + 10 * HOP).astype(np.float32)
        w[L + 3 * HOP:L + 7 * HOP] *= 1e-4        # silent stretch
        wavs[f"s{i}"] = w
    _feed((oracle, sh), wavs)
    _equiv(oracle.drain(), sh.drain())
    st = sh.stats()
    assert st["fleet"]["gated_hops"] > 0
    assert st["fleet"]["gated_hops"] == oracle.stats()["gated_hops"]


def test_sharded_bitident_faults_and_drift(hw):
    """One FaultConfig, a FaultModel per pool ticked once per router
    tick: the drift stays in lockstep with one server, and a fleet-wide
    campaign perturbs every stream alike."""
    fcfg = FaultConfig(drift_std=0.2, seed=3)
    oracle, sh = _pair(hw, hop=HOP, faults=fcfg, seed=0)
    assert len(sh.fault_models) == 2
    _feed((oracle, sh), {f"s{i}": _wav(300 + i, L + 6 * HOP)
                         for i in range(4)})
    ev_o, ev_s = [], []
    for _ in range(3):
        ev_o += oracle.step()
        ev_s += sh.step()
    for fm in [oracle.faults] + sh.fault_models:
        fm.inject_bit_flips(n=4)
        fm.inject_stuck("conv2", [1, 5], value=-1)
    ev_o += oracle.drain()
    ev_s += sh.drain()
    _equiv(ev_o, ev_s)
    with pytest.raises(ValueError, match="not a FaultModel"):
        ShardedStreamServer(hw, CFG, devices=CPU2, slots=2, hop=HOP,
                            faults=oracle.faults)


def test_sharded_snapshot_restore_bit_identical(hw, tmp_path):
    """A mid-run bundle restored into a fresh fleet: the rest equals one
    uninterrupted server; a fleet of the wrong width refuses it."""
    kw = dict(hop=HOP, sa_noise_std=0.25, chip_offsets=_chip(),
              faults=FaultConfig(seed=5), seed=0)
    oracle = StreamServer(hw, CFG, slots=4, device="cpu", **kw)

    def mk():
        return ShardedStreamServer(hw, CFG, devices=CPU2, slots=2, **kw)

    sh = mk()
    _feed((oracle, sh), {f"s{i}": _wav(400 + i, L + 6 * HOP)
                         for i in range(4)})
    ev_o, ev_s = [], []
    for _ in range(3):
        ev_o += oracle.step()
        ev_s += sh.step()
    path = str(tmp_path / "fleet.npz")
    assert sh.snapshot(path) == path
    assert not [f for f in tmp_path.iterdir() if f.name.startswith(".tmp")]
    sh2 = mk()
    sh2.restore(path)
    assert sh2.where("s0") == sh.where("s0")
    assert sh2._next_uid == sh._next_uid and sh2._steps == sh._steps
    ev_o += oracle.drain()
    ev_s += sh2.drain()
    po = _equiv(ev_o, ev_s)
    assert sum(len(v) for v in po.values()) > 0
    with pytest.raises(ValueError, match="device pools"):
        ShardedStreamServer(hw, CFG, devices=["cpu"] * 3, slots=2,
                            **kw).restore(path)
    with pytest.raises(ValueError, match="sharded snapshot bundle"):
        mk().restore(oracle.snapshot())


def test_sharded_soak_with_fleet_swap(hw):
    """The reference's dual soak, one interleaving: submits, speech and
    silence, evictions, finishes, bit flips and a mid-run snapshot swap
    into a fresh fleet, against one 4-slot server."""
    seed = 17
    kw = dict(hop=HOP, sa_noise_std=0.5, vad=VADConfig(**GATE_VAD),
              faults=FaultConfig(drift_std=0.1, seed=seed), seed=seed)
    oracle = StreamServer(hw, CFG, slots=4, device="cpu", **kw)

    def mk():
        return ShardedStreamServer(hw, CFG, devices=CPU2, slots=2, **kw)

    sh = mk()
    rng = np.random.default_rng(seed)
    alive, ev_o, ev_s = {}, [], []
    ticks = 10
    for t in range(ticks):
        r = rng.random()
        if r < 0.35 and len(alive) < 4:
            sid = f"s{t}"
            alive[sid] = True
            w = rng.uniform(-1, 1, L).astype(np.float32)
            oracle.submit(sid, w)
            sh.submit(sid, w)
        elif r < 0.45 and alive:
            sid = rng.choice(sorted(alive))
            del alive[sid]
            oracle.evict(sid)
            sh.evict(sid)
        elif r < 0.55 and alive:
            sid = rng.choice(sorted(alive))
            del alive[sid]
            oracle.finish(sid)
            sh.finish(sid)
        elif r < 0.65:
            for fm in [oracle.faults] + sh.fault_models:
                fm.inject_bit_flips(n=1)
        for sid in list(alive):
            amp = 1.0 if rng.random() < 0.6 else 1e-4
            w = (amp * rng.standard_normal(HOP)).astype(np.float32)
            oracle.submit(sid, w)
            sh.submit(sid, w)
        ev_o += oracle.step()
        ev_s += sh.step()
        if t == ticks // 2:
            sh2 = mk()
            sh2.restore(sh.snapshot())
            sh = sh2
    for sid in alive:
        oracle.finish(sid)
        sh.finish(sid)
    ev_o += oracle.drain()
    ev_s += sh.drain()
    assert _equiv(ev_o, ev_s)


def test_router_rejection_consumes_no_uid(hw):
    sh = ShardedStreamServer(hw, CFG, devices=CPU2, slots=1, hop=HOP,
                             seed=0, admission=AdmissionConfig(max_queue=0))
    for i in range(2):
        assert sh.submit(f"s{i}", _wav(i, L)) == "slot"
    uid_before = sh._next_uid
    assert sh.submit("overflow", _wav(9, L)) == "rejected"
    assert sh.where("overflow") is None
    assert sh._next_uid == uid_before
    assert sh.stats()["fleet"]["rejected_streams"] == 1
    with pytest.raises(RuntimeError, match="admission queue is full"):
        sh.customize("late")


def test_events_device_tags_and_fleet_rollup(hw):
    obs = ObsConfig(recorder=32, audit="raise", trace=False)
    sh = ShardedStreamServer(hw, CFG, devices=CPU2, slots=2, hop=HOP,
                             seed=0, obs=obs)
    for i in range(4):
        sh.submit(f"s{i}", _wav(500 + i, L + 3 * HOP))
        sh.finish(f"s{i}")
    events = sh.drain()
    assert events
    for ev in events:
        assert ev["device"] == sh.where(ev["stream"])
    st = sh.stats()
    assert st["devices"] == 2 and len(st["per_device"]) == 2
    assert st["fleet"]["decisions"] == sum(
        d["decisions"] for d in st["per_device"]) == len(events)
    assert st["audit"]["violations"] == 0
    assert [a["device"] for a in st["audit"]["per_device"]] == [0, 1]
    assert [d["device_label"] for d in st["per_device"]] == [0, 1]


def test_device_arguments():
    """A count of pools needs a card; ``device=`` belongs to ``devices``."""
    params = kws.init_params(jaxrand.PRNGKey(5, device="cpu"), CFG,
                             device="cpu")
    hw = kws.fold_params(params, kws.init_state(CFG, device="cpu"), CFG)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices=\\['cpu', 'cpu'\\]"):
            ShardedStreamServer(hw, CFG, devices=2, hop=HOP)
    with pytest.raises(ValueError, match="devices="):
        ShardedStreamServer(hw, CFG, devices=CPU2, hop=HOP, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        ShardedStreamServer(hw, CFG, devices=0, hop=HOP)


# ---------------------------------------------------------------------------
# against JAX's fleet
# ---------------------------------------------------------------------------


_WALL = ("hop_wall_s", "decisions_per_sec")


def test_sharded_matches_jax_fleet(hw):
    """A noisy, gated 2 x 2 fleet with chip offsets: the port's events,
    placements and rollup (less its wall fields) equal JAX's fleet."""
    vad = dict(GATE_VAD)
    chip_t = _chip()
    chip_j = {k: np.asarray(v.numpy()) for k, v in chip_t.items()}
    ref = JShardedStreamServer(jax_hw(hw), JCFG, devices=2, slots=2,
                               hop=HOP, use_kernel=False, compiled=None,
                               sa_noise_std=0.5, chip_offsets=chip_j,
                               vad=JVADConfig(**vad), seed=4)
    port = ShardedStreamServer(hw, CFG, devices=CPU2, slots=2, hop=HOP,
                               sa_noise_std=0.5, chip_offsets=chip_t,
                               vad=VADConfig(**vad), seed=4)
    rng = np.random.default_rng(23)
    wavs = {}
    for i in range(5):                         # the fifth one queues
        w = rng.uniform(-1, 1, L + 5 * HOP).astype(np.float32)
        w[L + HOP:L + 4 * HOP] *= 1e-4
        wavs[f"s{i}"] = w
    events = []
    for srv in (ref, port):
        for sid, w in wavs.items():
            assert srv.submit(sid, w) in ("slot", "queued")
            srv.finish(sid)
        events.append(srv.drain())
    ev_ref, ev_port = events
    strip = lambda es: [{k: v for k, v in e.items() if k != "score"}
                        for e in es]
    assert strip(ev_port) == strip(ev_ref)
    np.testing.assert_allclose([e["score"] for e in ev_port],
                               [e["score"] for e in ev_ref], rtol=0,
                               atol=SCORE_ATOL)
    assert {s: port.where(s) for s in wavs} == {s: ref.where(s)
                                                for s in wavs}
    sp, sj = port.stats(), ref.stats()
    assert ({k: v for k, v in sp["fleet"].items() if k not in _WALL}
            == {k: v for k, v in sj["fleet"].items() if k not in _WALL})
    assert sp["fleet"]["gated_hops"] > 0
    for k in ("devices", "steps", "streams_placed", "placement"):
        assert sp[k] == sj[k], k


# ---------------------------------------------------------------------------
# parallel pools under the launch auditor
# ---------------------------------------------------------------------------


def _audited_fleet(hw, parallel):
    """Inference, canaries and an enrollment session mixed across two
    pools with the auditor in raise mode; returns the fleet, the
    session, the drained events and the session's tick events."""
    rng = np.random.default_rng(21)
    vad = VADConfig(threshold_on_db=-30.0, threshold_off_db=-40.0,
                    wake_margin=1, hang=0)
    sh = ShardedStreamServer(hw, CFG, devices=CPU2, slots=3, hop=HOP,
                             vad=vad, seed=3, parallel=parallel,
                             obs=ObsConfig(audit="raise"),
                             health=HealthConfig(interval=4))
    sess = sh.customize("u0", CustomizeConfig(
        train=OnChipTrainConfig(epochs=8, fixed_error_scale=1.375),
        epochs_per_tick=4, layers_per_tick=5))
    for c in range(2):
        sess.enroll(c, rng.uniform(-1, 1, L).astype(np.float32))
    sess.finish_enrollment()
    for i in range(3):
        w = rng.uniform(-1, 1, L + 6 * HOP).astype(np.float32)
        w[L + 2 * HOP:L + 4 * HOP] *= 1e-4
        sh.submit(f"live{i}", w)
        sh.finish(f"live{i}")
    events = sh.drain()
    more = []
    for _ in range(200):
        if sess.done:
            break
        more += sh.step()
    sh.close()
    return sh, sess, events, more


def test_parallel_pools_audit_raise(hw):
    """Two pools ticking on threads of their own each count only their
    own fused calls: no violation in raise mode, every pool computed,
    and the events, session result and per-pool audit histories of the
    sequential fleet."""
    runs = [_audited_fleet(hw, parallel) for parallel in (False, True)]
    (seq, s_seq, ev_seq, more_seq), (par, s_par, ev_par, more_par) = runs
    assert s_par.done and ev_par
    assert ev_par == ev_seq and more_par == more_seq
    assert {par.where(f"live{i}") for i in range(3)} == {0, 1}
    np.testing.assert_array_equal(s_par.result.fc_w, s_seq.result.fc_w)
    st = par.stats()
    assert st["audit"]["violations"] == 0
    for d, (p, q) in enumerate(zip(par.pools, seq.pools)):
        s = p.auditor.stats()
        assert s["device"] == d and s["mode"] == "raise"
        assert s["violations"] == 0 and s["max_hop_calls_per_tick"] <= 1
        assert s["calls"]["hop"] > 0 and s["traced_launches"] > 0
        assert p.auditor.history() == q.auditor.history()
    assert sum(p.auditor.stats()["calls"]["gate"] for p in par.pools) > 0
    assert sum(p.stats()["learn_hops"] for p in par.pools) > 0
