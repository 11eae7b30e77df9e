"""Crash-safe snapshots of the port's server (``StreamServer.snapshot`` /
``restore``, ``HealthMonitor.snapshot`` / ``restore`` and the sessions'
state) on the CPU.

* Against JAX: the port's snapshot and the JAX interpreted server's,
  taken at the same tick of one noisy, gated, faulted, health-monitored
  run with a recovery in flight, have the same spec tree, and every
  array leaf and scalar is equal in value, dtype and shape, bitwise.  The
  stated exceptions: wall fields (``wall_s``, ``serving.hop_wall_s``),
  the port-only ``serving.imc_passes`` counter, and the score tolerance
  (1e-6 on the decision state's posteriors and on trigger scores).  A
  port server restored from the JAX snapshot then serves JAX's events.
* Round trips, port against port (``tests/test_reliability.py``'s
  cases): a restore from a path continues bit-identically; a session
  restored mid-enrollment, mid-calibration, mid-extraction or
  mid-training reaches the same ``CustomizationResult``, and a session
  on the per-epoch route (RGP) too; the mismatch errors are raised.
* Telemetry (``tests/test_obs.py``): v2 carries the registry and the
  recorder.  A version-1 payload (counters as attributes) is read.
* The reference's soak (24 ticks, a restore into a fresh server every 8)
  serves the events of the same soak without restores.

Small config: ``sample_len=640``, ``hop=64``; the port's net from
``init_params(PRNGKey(5))``, carried to JAX as numpy
(``test_torch_noise.jax_hw``).
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.core import faults as jflt
from repro.core import imc as jimc
from repro.models import kws as jkws
from repro.serving import HealthConfig as JHealthConfig
from repro.serving import StreamServer as JStreamServer
from repro.serving import VADConfig as JVADConfig
from repro_torch.core import imc, jaxrand
from repro_torch.core import faults as flt
from repro_torch.core.onchip_training import OnChipTrainConfig
from repro_torch.models import kws
from repro_torch.obs import ObsConfig
from repro_torch.serving import (CustomizeConfig, FaultConfig, HealthConfig,
                                 StreamServer, VADConfig)
from repro_torch.serving import scheduler as sched
from test_torch_noise import CHANS, jax_hw

L, HOP = 640, 64
CFG = kws.KWSConfig(sample_len=L)
JCFG = jkws.KWSConfig(sample_len=L)
SCORE_ATOL = 1e-6
VAD = dict(threshold_on_db=-40.0, threshold_off_db=-50.0, wake_margin=1,
           hang=0)
HEALTH = dict(interval=2, quarantine_after=1, layers_per_tick=1)
FAULTS = dict(drift_std=0.2, seed=3)


@pytest.fixture(scope="module")
def hw():
    params = kws.init_params(jaxrand.PRNGKey(5, device="cpu"), CFG,
                             device="cpu")
    return kws.fold_params(params, kws.init_state(CFG, device="cpu"), CFG,
                           pack=True)


def _chip():
    return imc.sample_chip_offsets(jaxrand.PRNGKey(9, "cpu"), CHANS,
                                   imc.IMCNoiseParams(mav_offset_std=4.0))


def _server(hw, **kw):
    """The faulted, monitored, noisy, gated server of the round trips."""
    return StreamServer(hw, CFG, hop=HOP, slots=3, device="cpu",
                        chip_offsets=_chip(), sa_noise_std=1.0,
                        vad=VADConfig(**VAD), faults=FaultConfig(**FAULTS),
                        health=HealthConfig(**HEALTH), seed=7, **kw)


class _Traffic:
    """Two streams, one loud, one that falls quiet every few hops; stuck
    columns and trim-bit flips injected at tick 1."""

    def __init__(self, ticks, seed=0):
        rng = np.random.default_rng(seed)
        self.first = [rng.uniform(-1, 1, L).astype(np.float32)
                      for _ in range(2)]
        self.hops = [(rng.uniform(-1, 1, HOP).astype(np.float32),
                      ((1.0 if t % 5 < 2 else 1e-4)
                       * rng.uniform(-1, 1, HOP)).astype(np.float32))
                     for t in range(ticks)]

    def start(self, srv):
        srv.submit("a", self.first[0])
        srv.submit("b", self.first[1])

    def play(self, srv, t0, t1):
        events = []
        for t in range(t0, t1):
            if t == 1:
                srv.faults.inject_stuck("conv2", [1, 4])
                srv.faults.inject_bit_flips(n=2)
            srv.submit("a", self.hops[t][0])
            srv.submit("b", self.hops[t][1])
            events.append(srv.step())
        return events


def _same_events(ev_port, ev_ref):
    strip = lambda es: [{k: v for k, v in e.items() if k != "score"}
                        for e in es]
    assert strip(ev_port) == strip(ev_ref)
    np.testing.assert_allclose([e["score"] for e in ev_port],
                               [e["score"] for e in ev_ref], rtol=0,
                               atol=SCORE_ATOL)


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _same_state(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# leaf by leaf against the JAX package's snapshot
# ---------------------------------------------------------------------------

_WALL = ("wall_s", "hop_wall_s")
# the port counts its IMC forwards, which the JAX package does not
_ONE_SIDED_COUNTERS = ("serving.imc_passes",)
_NODES = ("none", "v", "arr", "nt", "tuple", "list", "dict", "pkl")


def _is_node(x):
    return isinstance(x, dict) and x.get("t") in _NODES and (
        set(x) <= {"t", "v", "k", "c", "items", "keys"})


def _same_value(a, b, where, atol=0.0):
    if atol:
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=where)
    else:
        assert np.array_equal(a, b), where


def _fields(obj):
    return (vars(obj) if not dataclasses.is_dataclass(obj)
            else {f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(obj)})


def _same_pickled(a, b, where):
    """Two unpickled objects (the packages' own classes) by their
    fields."""
    if hasattr(a, "__dict__") or dataclasses.is_dataclass(a):
        fa, fb = _fields(a), _fields(b)
        assert sorted(fa) == sorted(fb), where
        for k in fa:
            _same_pickled(fa[k], fb[k], f"{where}.{k}")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert np.array_equal(np.asarray(a), np.asarray(b)), where
    else:
        assert a == b, where


def _compare(a, b, arr_a, arr_b, where="", seen=None):
    """Walk two snapshot specs in step: plain JSON sections and encoded
    nodes alike.  Returns the paths of the array leaves compared."""
    seen = [] if seen is None else seen
    last = where.rsplit(".", 1)[-1]
    if last in _WALL:
        return seen
    if _is_node(a):
        assert _is_node(b) and a["t"] == b["t"], where
        t = a["t"]
        if t == "v":
            if last == "score":
                assert abs(a["v"] - b["v"]) <= SCORE_ATOL, where
            else:
                assert a["v"] == b["v"] and type(a["v"]) is type(b["v"]), \
                    where
        elif t == "arr":
            x, y = arr_a[a["k"]], arr_b[b["k"]]
            assert x.dtype == y.dtype and x.shape == y.shape, \
                f"{where}: {x.dtype}{x.shape} vs {y.dtype}{y.shape}"
            # the decision state's posteriors: softmax and smoothing sums
            atol = SCORE_ATOL if where.startswith(".dstate") and \
                x.dtype == np.float32 else 0.0
            _same_value(x, y, where, atol)
            seen.append(where)
        elif t == "pkl":
            _same_pickled(pickle.loads(bytes(arr_a[a["k"]])),
                          pickle.loads(bytes(arr_b[b["k"]])), where)
        elif t in ("nt", "tuple", "list"):
            assert a.get("c") == b.get("c"), where
            assert len(a["items"]) == len(b["items"]), where
            for i, (x, y) in enumerate(zip(a["items"], b["items"])):
                _compare(x, y, arr_a, arr_b, f"{where}[{i}]", seen)
        elif t == "dict":
            assert a["keys"] == b["keys"], f"{where}: keys"
            for k, x, y in zip(a["keys"], a["items"], b["items"]):
                _compare(x, y, arr_a, arr_b, f"{where}.{k}", seen)
        return seen
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), f"{where}: {sorted(a)} vs {sorted(b)}"
        for k in a:
            _compare(a[k], b[k], arr_a, arr_b, f"{where}.{k}", seen)
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _compare(x, y, arr_a, arr_b, f"{where}[{i}]", seen)
    else:
        assert a == b and type(a) is type(b), f"{where}: {a!r} vs {b!r}"
    return seen


def _counters(spec):
    return [c for c in spec["counters"]["cells"]
            if c[0] not in ("serving.hop_wall_s",) + _ONE_SIDED_COUNTERS]


def test_snapshot_leaves_match_jax(hw):
    """At tick 8 (a recovery in flight, its ideal counts, keys and new
    biases set) the port's snapshot is the JAX server's, leaf for leaf;
    a port server restored from JAX's snapshot serves JAX's next ticks."""
    chip_t = _chip()
    chip_j = {k: np.asarray(v.numpy()) for k, v in chip_t.items()}
    ref = JStreamServer(jax_hw(hw), JCFG, hop=HOP, slots=3,
                        use_kernel=False, compiled=None, chip_offsets=chip_j,
                        sa_noise_std=1.0, vad=JVADConfig(**VAD),
                        faults=jflt.FaultConfig(**FAULTS),
                        health=JHealthConfig(**HEALTH),
                        obs=jobs.ObsConfig(recorder=128), seed=7)
    port = _server(hw, obs=ObsConfig(recorder=128))
    traffic = _Traffic(10)
    snaps, events = [], []
    for srv in (ref, port):
        traffic.start(srv)
        events.append(traffic.play(srv, 0, 8))
        snaps.append(srv.snapshot())
    for a, b in zip(events[1], events[0]):
        _same_events(a, b)
    assert port.health._recovery is not None
    assert port.health._recovery["bias"]
    (sj, aj), (sp, ap) = [(s["spec"], s["arrays"]) for s in snaps]
    assert _counters(sp) == _counters(sj)
    cj, cp = dict(sj), dict(sp)
    cj.pop("counters")
    cp.pop("counters")
    seen = _compare(cp, cj, ap, aj)
    assert len(seen) == len(ap) == len(aj)         # every leaf, once
    for part in (".base_key", ".state[4]", ".health.recovery.ideal.conv1",
                 ".health.recovery.keys.conv1", ".health.recovery.bias",
                 ".faults", ".heal", ".vstate", ".streams.b.recent"):
        assert any(w.startswith(part) for w in seen), part
    assert sp["recorder"]["events"] and sp["recorder"] == sj["recorder"]

    # the JAX package's snapshot restores into the port
    back = _server(hw, obs=ObsConfig(recorder=128))
    back.restore(snaps[0])
    tail = [traffic.play(srv, 8, 10) for srv in (ref, back)]
    for a, b in zip(tail[1], tail[0]):
        _same_events(a, b)
    assert back.health.stats() == ref.health.stats()
    assert back.faults.stats() == ref.faults.stats()


# ---------------------------------------------------------------------------
# round trips
# ---------------------------------------------------------------------------


def test_snapshot_restore_from_path_bit_identical(hw, tmp_path):
    """Snapshot to disk mid-recovery, restore into a fresh server: the
    next 8 ticks give the same events, state leaves, decision and VAD
    state, health, fault and registry state; the file is written
    atomically and holds only arrays (``allow_pickle=False`` loads it)."""
    traffic = _Traffic(16)
    srv = _server(hw)
    traffic.start(srv)
    traffic.play(srv, 0, 8)
    path = os.fspath(tmp_path / "server.npz")
    assert srv.snapshot(path) == path
    assert sorted(os.listdir(tmp_path)) == ["server.npz"]
    with np.load(path, allow_pickle=False) as data:
        assert "meta" in data.files
    ev1 = traffic.play(srv, 8, 16)
    srv2 = _server(hw)
    srv2.restore(path)
    ev2 = traffic.play(srv2, 8, 16)
    assert ev1 == ev2 and sum(map(len, ev1)) > 0
    _same_state(srv._state, srv2._state)
    _same_state(srv._dstate, srv2._dstate)
    _same_state(srv._vstate, srv2._vstate)
    assert srv2._vstate.level_db.device.type == "cpu"
    assert srv.health.stats() == srv2.health.stats()
    assert srv.faults.stats() == srv2.faults.stats()
    cells = lambda s: [c for c in s.metrics.snapshot()["cells"]
                       if "wall" not in c[0] and "imc_passes" not in c[0]]
    assert cells(srv) == cells(srv2)
    # the expected canary state is not in the snapshot: the restored
    # monitor recomputes it at its first canary, two B = 1 forwards the
    # uninterrupted one had made before the cut
    assert srv2._imc_passes == srv._imc_passes + 2


def _session_server(hw):
    return StreamServer(hw, CFG, hop=HOP, slots=4, device="cpu",
                        sa_noise_std=1.0, seed=2)


def _open_sessions(srv, rng_seed=1):
    rng = np.random.default_rng(rng_seed)
    sessions = []
    for s, ccfg in enumerate((
            CustomizeConfig(train=OnChipTrainConfig(
                epochs=24, fixed_error_scale=1.375)),
            CustomizeConfig(train=OnChipTrainConfig(
                epochs=6, fixed_error_scale=1.375, rgp=True),
                epochs_per_tick=3))):
        sess = srv.customize(f"enroll{s}", ccfg)
        for j in range(2):
            sess.enroll(j % CFG.num_classes,
                        rng.standard_normal(L).astype(np.float32))
        sess.finish_enrollment()
        sessions.append(sess)
    return sessions


def _finish(srv):
    for _ in range(300):
        if all(s.done for s in srv._cust.sessions):
            return [s.result for s in srv._cust.sessions]
        srv.step()
    raise AssertionError([s.phase for s in srv._cust.sessions])


def test_snapshot_restore_mid_customization_sessions(hw):
    """Two sessions (the fused head route, and RGP on the per-epoch
    route) snapshotted in memory at every phase they pass through: each
    restore into a fresh server reaches the uninterrupted run's
    ``CustomizationResult``, bit for bit."""
    srv = _session_server(hw)
    _open_sessions(srv)
    snaps, seen = [], set()
    for _ in range(300):
        phase = srv._cust.sessions[0].phase
        if phase not in seen and phase != "swapped":
            seen.add(phase)
            snaps.append((phase, srv.snapshot()))
        if all(s.done for s in srv._cust.sessions):
            break
        srv.step()
    want = [s.result for s in srv._cust.sessions]
    assert {"enrolling", "calibrating", "extracting",
            "training"} <= {p for p, _ in snaps}
    for phase, snap in snaps:
        srv2 = _session_server(hw)
        srv2.restore(snap)
        got = _finish(srv2)
        for r1, r2 in zip(want, got):
            for name in r1.bias:
                assert np.array_equal(r1.bias[name], r2.bias[name]), phase
            assert np.array_equal(r1.fc_w, r2.fc_w), phase
            assert np.array_equal(r1.fc_b, r2.fc_b), phase
            assert r1.history == r2.history, phase
        assert srv2._cust._next_sid == 2


def test_snapshot_restore_rejects_mismatches(hw):
    srv = StreamServer(hw, CFG, hop=HOP, slots=2, device="cpu")
    snap = srv.snapshot()
    with pytest.raises(ValueError, match="configuration mismatch"):
        StreamServer(hw, CFG, hop=2 * HOP, slots=2,
                     device="cpu").restore(snap)
    with pytest.raises(ValueError, match="configuration mismatch"):
        StreamServer(hw, CFG, hop=HOP, slots=2, device="cpu",
                     vad=VADConfig()).restore(snap)
    with pytest.raises(ValueError, match="fault-model mismatch"):
        StreamServer(hw, CFG, hop=HOP, slots=2, device="cpu",
                     faults=FaultConfig(seed=0)).restore(snap)
    with pytest.raises(ValueError, match="health mismatch"):
        StreamServer(hw, CFG, hop=HOP, slots=2, device="cpu",
                     health=HealthConfig()).restore(snap)
    with pytest.raises(ValueError, match=r"outside this server's \[3, 3\]"):
        StreamServer(hw, CFG, hop=HOP, slots=3, device="cpu").restore(snap)
    bad = {"spec": dict(snap["spec"], version=9), "arrays": snap["arrays"]}
    with pytest.raises(ValueError, match="unknown snapshot version"):
        StreamServer(hw, CFG, hop=HOP, slots=2, device="cpu").restore(bad)
    with pytest.raises(TypeError, match="str keys"):
        sched._snap_encode({1: 2}, {})


@dataclasses.dataclass
class Holder:
    w: object


def test_snapshot_holds_no_tensors(hw):
    """Every table entry is a numpy array, and what is pickled holds no
    tensor: a dataclass with a tensor field is pickled with a numpy copy."""
    srv = _session_server(hw)
    _open_sessions(srv)
    for _ in range(3):
        srv.step()
    snap = srv.snapshot()
    assert all(type(a) is np.ndarray for a in snap["arrays"].values())

    arrays = {}
    node = sched._snap_encode(Holder(torch.arange(3.0)), arrays)
    assert node["t"] == "pkl"
    back = sched._snap_decode(node, arrays)
    assert isinstance(back.w, np.ndarray) and back.w.tolist() == [0, 1, 2]


# ---------------------------------------------------------------------------
# telemetry and version 1
# ---------------------------------------------------------------------------


def test_snapshot_v2_roundtrips_registry_and_recorder(hw, tmp_path):
    obs = ObsConfig(recorder=64, audit="flag", trace=True)
    rng = np.random.default_rng(11)
    wav = rng.uniform(-1, 1, L + 10 * HOP).astype(np.float32)
    wav[L + 2 * HOP:L + 6 * HOP] *= 1e-4
    head, tail = wav[:L + 5 * HOP], wav[L + 5 * HOP:]

    def mk():
        return StreamServer(hw, CFG, hop=HOP, slots=1, device="cpu",
                            vad=VADConfig(**VAD), seed=3, obs=obs)

    srv = mk()
    srv.submit("s0", head)
    for _ in range(6):
        srv.step()
    path = tmp_path / "server.npz"
    srv.snapshot(path)
    srv2 = mk()
    srv2.restore(path)
    assert srv2.metrics.snapshot() == srv.metrics.snapshot()
    assert srv2.recorder.events() == srv.recorder.events()
    assert srv2._steps == srv._steps
    ev1, ev2 = [], []
    for s, ev in ((srv, ev1), (srv2, ev2)):
        s.submit("s0", tail)
        s.finish("s0")
        ev.extend(s.drain())
    assert ev1 == ev2 and ev1
    det = lambda reg: [c for c in reg.snapshot()["cells"]
                       if "wall" not in c[0]]
    assert det(srv2.metrics) == det(srv.metrics)


def test_snapshot_version_1_is_read(hw):
    """A v1 payload keeps its counters as server attributes and no
    recorder: restore sets them through the registry-backed properties."""
    srv = _server(hw)
    traffic = _Traffic(7)
    traffic.start(srv)
    traffic.play(srv, 0, 4)
    snap = srv.snapshot()
    attrs = {name: getattr(srv, name) for name, v in
             vars(StreamServer).items() if isinstance(v, property)
             and name.startswith("_") and not name.startswith("__")}
    spec = dict(snap["spec"], version=1, counters=attrs)
    spec.pop("recorder")
    srv2 = _server(hw)
    srv2.restore({"spec": spec, "arrays": snap["arrays"]})
    for name, val in attrs.items():
        assert getattr(srv2, name) == val, name
    assert traffic.play(srv, 4, 7) == traffic.play(srv2, 4, 7)


# ---------------------------------------------------------------------------
# the soak
# ---------------------------------------------------------------------------


def _soak(hw, seed, ticks, snapshot_every):
    """The reference's randomized soak: admissions, evictions, gated
    audio, fault injections and (with ``snapshot_every``) a restore into
    a fresh server every ``snapshot_every`` ticks.  Returns the events
    and the final stats."""
    def mk():
        return StreamServer(hw, CFG, hop=HOP, slots=3, device="cpu",
                            chip_offsets=_chip(), sa_noise_std=1.0,
                            vad=VADConfig(),
                            faults=FaultConfig(drift_std=0.1, seed=seed),
                            health=HealthConfig(interval=5), seed=seed)

    rng = np.random.default_rng(seed)
    srv = mk()
    alive, events = {}, []
    for t in range(ticks):
        r = rng.random()
        if r < 0.25 and len(alive) < 5:
            sid = f"s{t}"
            alive[sid] = True
            srv.submit(sid, rng.uniform(-1, 1, L).astype(np.float32))
        elif r < 0.35 and alive:
            sid = rng.choice(sorted(alive))
            del alive[sid]
            srv.evict(sid)
        elif r < 0.45:
            kind = rng.integers(3)
            if kind == 0:
                srv.faults.inject_bit_flips(n=1)
            elif kind == 1:
                name = f"conv{1 + int(rng.integers(CFG.num_conv_layers - 1))}"
                srv.faults.inject_stuck(
                    name, [int(rng.integers(CFG.channels[int(name[4:])]))])
            else:
                srv.faults.clear()
        for sid in list(alive):
            amp = 1.0 if rng.random() < 0.5 else 1e-4
            srv.submit(sid, (amp * rng.standard_normal(HOP))
                       .astype(np.float32))
        events.append(srv.step())
        if snapshot_every and (t + 1) % snapshot_every == 0:
            srv2 = mk()
            srv2.restore(srv.snapshot())
            assert srv2.health.stats() == srv.health.stats()
            assert srv2.faults.stats() == srv.faults.stats()
            srv = srv2
        assert srv.health.state in srv.health.STATES
        live = [rec.stream_id for rec in srv._slots
                if rec is not None and not rec.internal]
        assert len(live) == len(set(live))
    st = srv.stats()
    assert st["steps"] == ticks
    return events, st


def test_soak_with_restores_serves_the_same_events(hw):
    ev_plain, st_plain = _soak(hw, seed=13, ticks=24, snapshot_every=0)
    ev_swap, st_swap = _soak(hw, seed=13, ticks=24, snapshot_every=8)
    assert ev_swap == ev_plain and sum(map(len, ev_plain)) > 0
    assert st_swap["health"]["canaries"] >= 1
    assert st_swap["health"] == st_plain["health"]
    assert st_swap["faults"] == st_plain["faults"]


def test_fault_model_snapshot_through_the_codec():
    """A FaultModel's snapshot survives the codec and the .npz spec's
    JSON, and resumes the same drift walk."""
    a = flt.FaultModel.for_config(CFG, FaultConfig(drift_std=0.3, seed=7))
    for _ in range(3):
        a.tick()
    a.inject_stuck("conv2", [1, 4], value=-1)
    arrays = {}
    node = sched._snap_encode(a.snapshot(), arrays)
    b = flt.FaultModel.for_config(CFG, FaultConfig(drift_std=0.3, seed=7))
    b.restore(sched._snap_decode(node, arrays))
    for _ in range(3):
        a.tick()
        b.tick()
    for name, d in a.deltas().items():
        np.testing.assert_array_equal(d, b.deltas()[name])
