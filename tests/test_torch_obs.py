"""The port's telemetry pieces (``repro_torch.obs``) against the JAX
package's, on the CPU: the unit cases of ``tests/test_obs.py`` (the
registry, the flight recorder, ``ObsConfig``, the launch auditor's rules
and the trace builder), case by case, and the same writes, records and
calls through both packages (parametrized): the registry's snapshot
payload, nested view, totals and Prometheus text, the recorder's ring,
snapshot and JSON lines, the auditor's violations, history and stats.
The served runs are in ``test_torch_obs_server.py``.

Stated differences (``ROADMAP.md`` queue 3): the port's auditor counts
the fused layer's calls (``kernels.imc_mav.ops.CALLS``, both routes)
where the reference counts fresh Pallas traces, so its violation texts
say "fused" where the reference's say "pallas", and its history and
stats add ``k1_calls`` / ``outside_regions``.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import json
import re

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro_torch.kernels.imc_mav import ops
from repro_torch.obs import (FlightRecorder, LaunchAuditError, LaunchAuditor,
                             MetricsRegistry, ObsConfig, TraceBuilder,
                             counter_property)


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------


def test_registry_kinds_labels_values():
    reg = MetricsRegistry()
    reg.inc("calls", cause="hop")
    reg.inc("calls", 3, cause="hop")
    reg.inc("calls", cause="gate")
    reg.set_gauge("depth", 7)
    reg.observe("uj", 2.0)
    reg.observe("uj", 4.0)
    assert reg.value("calls", cause="hop") == 4
    assert reg.value("calls", cause="gate") == 1
    assert reg.value("calls") == 0               # unlabelled cell absent
    assert reg.total("calls") == 5
    assert reg.value("depth") == 7
    h = reg.value("uj")
    assert h["count"] == 2 and h["sum"] == 6.0
    assert h["min"] == 2.0 and h["max"] == 4.0 and h["mean"] == 3.0
    assert {"cause": "hop"} in reg.labels("calls")
    col = reg.collect()
    assert col["calls"]["kind"] == "counter"
    assert col["uj"]["kind"] == "histogram"
    reg.inc("pair", a=1, b=2)                    # label order never
    reg.inc("pair", b=2, a=1)                    # splits a cell
    assert reg.value("pair", a=1, b=2) == 2


def test_registry_kind_conflict_raises():
    reg = MetricsRegistry()
    reg.inc("x")
    with pytest.raises(ValueError, match="already registered"):
        reg.set_gauge("x", 1)
    with pytest.raises(ValueError, match="already registered"):
        reg.observe("x", 1.0)


def test_registry_snapshot_restore_roundtrip():
    reg = MetricsRegistry()
    reg.inc("c", 5, cause="hop")
    reg.set_gauge("g", -2.5)
    reg.observe("h", 1.0, layer="conv2")
    reg.observe("h", 9.0, layer="conv2")
    snap = reg.snapshot()
    json.dumps(snap)                             # JSON-serializable
    reg2 = MetricsRegistry()
    reg2.inc("junk")                             # must be cleared
    reg2.restore(snap)
    assert reg2.snapshot() == snap
    assert reg2.value("junk", default=None) is None
    assert reg2.value("h", layer="conv2") == reg.value("h", layer="conv2")
    reg2.inc("c", cause="hop")                   # write paths still work
    assert reg2.value("c", cause="hop") == 6
    with pytest.raises(ValueError, match="version"):
        reg2.restore({"version": 99, "cells": []})


def test_registry_merge_semantics():
    a, b = MetricsRegistry(), MetricsRegistry()
    a.inc("c", 2)
    b.inc("c", 3)
    a.set_gauge("g", 1)
    b.set_gauge("g", 9)
    a.observe("h", 1.0)
    b.observe("h", 5.0)
    b.inc("only_b", kind="x")
    a.merge(b)
    assert a.value("c") == 5                     # counters sum
    assert a.value("g") == 9                     # gauges last-write
    h = a.value("h")                             # histograms pool
    assert h["count"] == 2 and h["min"] == 1.0 and h["max"] == 5.0
    assert a.value("only_b", kind="x") == 1
    b2 = MetricsRegistry()
    b2.set_gauge("c", 1)
    with pytest.raises(ValueError, match="already registered"):
        a.merge(b2)


def test_registry_prometheus_text():
    reg = MetricsRegistry()
    reg.inc("serving.batched_calls", 4, cause="hop")
    reg.set_gauge("health.state", 0)
    reg.observe("serving.tick_uj", 2.5)
    lines = reg.prometheus_text().strip().split("\n")
    assert "# TYPE serving_batched_calls counter" in lines
    assert 'serving_batched_calls{cause="hop"} 4' in lines
    assert "# TYPE health_state gauge" in lines
    assert "# TYPE serving_tick_uj summary" in lines
    assert "serving_tick_uj_count 1" in lines
    assert "serving_tick_uj_sum 2.5" in lines
    sample = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*"
                        r"(\{[a-zA-Z0-9_]+=\"[^\"]*\""
                        r"(,[a-zA-Z0-9_]+=\"[^\"]*\")*\})? \S+$")
    for line in lines:
        if not line.startswith("#"):
            assert sample.match(line), line


def test_counter_property_attribute_api():
    class Holder:
        n = counter_property("demo.n")
        k = counter_property("demo.k", cause="hop")

        def __init__(self):
            self._metrics = MetricsRegistry()

    h = Holder()
    assert h.n == 0
    h.n += 1
    h.n += 1
    h.k = 5
    assert h.n == 2
    assert h._metrics.value("demo.n") == 2
    assert h._metrics.value("demo.k", cause="hop") == 5
    h._metrics.set_counter("demo.n", 9)
    assert h.n == 9                              # reads go through too


_REG_WRITES = {
    "counters": [("inc", "serving.steps", 1, {}),
                 ("inc", "serving.batched_calls", 4, {"cause": "hop"}),
                 ("set_counter", "serving.hops", 7, {"kind": "speech"}),
                 ("inc", "serving.batched_calls", 2, {"cause": "gate"})],
    "gauges": [("set_gauge", "health.state", 0, {}),
               ("set_gauge", "health.state", 2, {}),
               ("set_gauge", "faults.drift", -1.25, {"layer": "conv2"})],
    "histograms": [("observe", "serving.tick_uj", 2.5, {}),
                   ("observe", "serving.tick_uj", 0.125, {}),
                   ("observe", "lat", 3.0, {"b": "x", "a": "y"})],
    "mixed": [("inc", "customize.epochs", 3, {}),
              ("observe", "serving.tick_uj", 14.3, {}),
              ("set_gauge", "health.state", 1, {}),
              ("inc", "health.transitions", 1, {"to": "degraded"}),
              ("observe", "serving.tick_uj", 0.5, {})],
}


@pytest.mark.parametrize("case", sorted(_REG_WRITES))
def test_registry_matches_reference(case):
    """The same writes give the reference's snapshot payload, nested
    view, totals and Prometheus text; each package restores the other's
    snapshot; a merge pools alike."""
    regs = []
    for cls in (MetricsRegistry, jobs.MetricsRegistry):
        reg = cls()
        for op, name, v, labels in _REG_WRITES[case]:
            getattr(reg, op)(name, v, **labels)
        regs.append(reg)
    port, ref = regs
    assert port.snapshot() == ref.snapshot()
    assert port.collect() == ref.collect()
    assert port.prometheus_text() == ref.prometheus_text()
    for name in {w[1] for w in _REG_WRITES[case]}:
        assert port.total(name) == ref.total(name)
        assert port.labels(name) == ref.labels(name)
    back = MetricsRegistry()
    back.restore(ref.snapshot())
    assert back.snapshot() == ref.snapshot()
    there = jobs.MetricsRegistry()
    there.restore(port.snapshot())
    assert there.prometheus_text() == port.prometheus_text()
    port.merge(back)
    ref.merge(there)
    assert port.snapshot() == ref.snapshot()


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------


def test_recorder_wraparound_and_dropped():
    rec = FlightRecorder(capacity=4)
    for i in range(10):
        rec.record(i, "tick", uj=float(i))
    assert len(rec) == 4
    assert rec.dropped() == 6
    evs = rec.events()
    assert [e["seq"] for e in evs] == [6, 7, 8, 9]
    assert [e["tick"] for e in evs] == [6, 7, 8, 9]
    rec.record(10, "admit", stream="s0")
    assert rec.events("admit")[0]["stream"] == "s0"
    assert len(rec.events("tick")) == 3
    with pytest.raises(ValueError):
        FlightRecorder(capacity=0)


def test_recorder_snapshot_roundtrip_and_dump(tmp_path):
    rec = FlightRecorder(capacity=3)
    for i in range(5):
        rec.record(i, "tick", computed=i)
    snap = rec.snapshot()
    json.dumps(snap)
    rec2 = FlightRecorder(capacity=8)
    rec2.restore(snap)
    assert rec2.capacity == 3
    assert rec2.events() == rec.events()
    assert rec2.dropped() == rec.dropped()
    rec2.record(5, "tick")                       # seq continues
    assert rec2.events()[-1]["seq"] == 5
    path = tmp_path / "flight.jsonl"
    assert rec.dump(path) == 3
    got = [json.loads(line) for line in path.read_text().splitlines()]
    assert got == rec.events()
    with pytest.raises(ValueError, match="version"):
        rec2.restore({"version": 99})


@pytest.mark.parametrize("capacity", [3, 64])
def test_recorder_matches_reference(tmp_path, capacity):
    """The same records: the reference's ring, snapshot and JSON lines,
    and each package restores the other's snapshot."""
    recs = [FlightRecorder(capacity), jobs.FlightRecorder(capacity)]
    for r in recs:
        for i in range(7):
            r.record(i, "tick", init=0, computed=i, uj=round(i / 3, 4))
            r.record(i, "evict", stream=f"s{i}", slot=i % 2, internal=False)
    port, ref = recs
    assert port.snapshot() == ref.snapshot()
    assert port.dropped() == ref.dropped()
    assert port.dump(tmp_path / "a") == ref.dump(tmp_path / "b")
    assert (tmp_path / "a").read_text() == (tmp_path / "b").read_text()
    back = FlightRecorder()
    back.restore(ref.snapshot())
    assert back.snapshot() == ref.snapshot()


# ---------------------------------------------------------------------------
# ObsConfig
# ---------------------------------------------------------------------------


def test_obsconfig_validation_and_env(monkeypatch):
    assert ObsConfig() == ObsConfig(recorder=0, audit="off", trace=False)
    with pytest.raises(ValueError):
        ObsConfig(audit="bogus")
    with pytest.raises(ValueError):
        ObsConfig(recorder=-1)
    monkeypatch.setenv("REPRO_OBS_RECORDER", "32")
    monkeypatch.setenv("REPRO_OBS_AUDIT", "raise")
    monkeypatch.setenv("REPRO_OBS_TRACE", "1")
    assert ObsConfig.from_env() == ObsConfig(recorder=32, audit="raise",
                                             trace=True)
    ref = jobs.ObsConfig.from_env()
    assert (ref.recorder, ref.audit, ref.trace) == (32, "raise", True)
    monkeypatch.setenv("REPRO_OBS_TRACE", "0")
    assert not ObsConfig.from_env().trace


# ---------------------------------------------------------------------------
# Launch auditor
# ---------------------------------------------------------------------------


def test_auditor_catches_doubled_hop():
    """Two batched hop calls in one tick (a per-slot hop loop) are
    flagged, or raise."""
    aud = LaunchAuditor(imc_layers=5, mode="flag")
    aud.begin_tick(0)
    with aud.region("hop"):
        pass
    with aud.region("hop"):
        pass
    aud.end_tick()
    assert len(aud.violations) == 1
    assert aud.violations[0]["cause"] == "hop"
    assert aud.stats()["max_hop_calls_per_tick"] == 2

    aud = LaunchAuditor(imc_layers=5, mode="raise")
    aud.begin_tick(0)
    with aud.region("hop"):
        pass
    with aud.region("hop"):
        pass
    with pytest.raises(LaunchAuditError, match="hop"):
        aud.end_tick()


def test_auditor_gate_and_overtrace_rules():
    aud = LaunchAuditor(imc_layers=5, mode="raise")
    aud.begin_tick(0)
    with pytest.raises(LaunchAuditError, match="gate"):
        aud._on_call("gate", traced=1)           # a gate fill launches 0
    aud = LaunchAuditor(imc_layers=5, mode="raise")
    aud.begin_tick(0)
    aud._on_call("hop", traced=5)
    with pytest.raises(LaunchAuditError, match="replay"):
        aud._on_call("replay", traced=6)
    aud = LaunchAuditor(imc_layers=5, mode="flag", batch_init=False)
    aud.begin_tick(0)
    aud._on_call("init", traced=0)
    aud._on_call("init", traced=0)
    aud.end_tick()
    assert aud.violations == []                  # doubled init: fine
    aud = LaunchAuditor(imc_layers=5, mode="flag", batch_init=True)
    aud.begin_tick(0)
    aud._on_call("init", traced=0)
    aud._on_call("init", traced=0)
    aud.end_tick()
    assert [v["cause"] for v in aud.violations] == ["init"]

    with pytest.raises(ValueError):
        LaunchAuditor(imc_layers=5, mode="sometimes")
    with pytest.raises(ValueError):
        LaunchAuditor(imc_layers=0)
    aud = LaunchAuditor(imc_layers=5)
    with pytest.raises(ValueError):
        with aud.region("bogus"):
            pass


def test_auditor_device_label_attribution():
    aud = LaunchAuditor(imc_layers=5, mode="flag", device=1)
    aud.begin_tick(0)
    with aud.region("hop"):
        pass
    with aud.region("hop"):
        pass
    aud.end_tick()
    assert aud.violations[0]["device"] == 1
    assert aud.stats()["device"] == 1
    aud = LaunchAuditor(imc_layers=5, mode="raise", device=3)
    aud.begin_tick(0)
    with pytest.raises(LaunchAuditError, match=r"device 3"):
        aud._on_call("gate", traced=1)
    assert "device" not in LaunchAuditor(imc_layers=5).stats()


def test_auditor_history_attribution():
    aud = LaunchAuditor(imc_layers=5, mode="flag", history=2)
    for tick in range(3):
        aud.begin_tick(tick)
        with aud.region("hop"):
            pass
        if tick == 0:
            with aud.region("gate"):
                pass
        aud.end_tick()
    hist = aud.history()
    assert len(hist) == 2                        # bounded
    assert [h["tick"] for h in hist] == [1, 2]
    assert all(h["calls"]["hop"] == 1 for h in hist)
    assert all(h["launches_per_layer"] == 1 for h in hist)
    s = aud.stats()
    assert s["ticks"] == 3 and s["violations"] == 0
    assert s["calls"]["hop"] == 3 and s["calls"]["gate"] == 1


_AUDIT_SEQS = {
    "clean": [("begin", 0), ("hop", 5), ("gate", 0), ("end",),
              ("begin", 1), ("init", 5), ("replay", 5), ("hop", 5),
              ("end",)],
    "doubled_hop": [("begin", 0), ("hop", 5), ("hop", 5), ("end",)],
    "doubled_gate": [("begin", 2), ("gate", 0), ("gate", 0), ("end",)],
    "doubled_init": [("begin", 0), ("init", 5), ("init", 5), ("end",)],
    "overtrace": [("begin", 0), ("replay", 6), ("end",)],
    "gate_traced": [("begin", 0), ("gate", 2), ("end",)],
    "compiled_alone": [("begin", 0), ("compiled", 5), ("end",),
                       ("begin", 1), ("end",)],
    "compiled_mixed": [("begin", 0), ("compiled", 5), ("hop", 5), ("end",),
                       ("begin", 1), ("compiled", 5), ("compiled", 5),
                       ("end",)],
}
_REF_HISTORY_KEYS = ("tick", "calls", "launches", "launches_per_layer")


@pytest.mark.parametrize("case", sorted(_AUDIT_SEQS))
@pytest.mark.parametrize("batch_init", [True, False])
def test_auditor_rules_match_reference(case, batch_init):
    """The same ticks and calls (``_on_call(cause, traced)``) give the
    reference's violations, per-tick history and stats."""
    auds = [LaunchAuditor(5, mode="flag", batch_init=batch_init),
            jobs.LaunchAuditor(5, mode="flag", batch_init=batch_init)]
    for aud in auds:
        for step in _AUDIT_SEQS[case]:
            if step[0] == "begin":
                aud.begin_tick(step[1])
            elif step[0] == "end":
                aud.end_tick()
            else:
                ops.CALLS.calls += step[1]   # the calls a region counts
                aud._on_call(step[0], traced=step[1])
    port, ref = auds
    # the details name what each counts (fused calls, Pallas traces)
    assert ([(v["tick"], v["cause"]) for v in port.violations]
            == [(v["tick"], v["cause"]) for v in ref.violations])
    assert ([{k: h[k] for k in _REF_HISTORY_KEYS} for h in port.history()]
            == ref.history())
    got = port.stats()
    assert got.pop("outside_regions") == 0
    assert got == ref.stats()


def test_auditor_counts_fused_calls():
    """A region counts the fused layer's calls made inside it on the plain
    route; a recompute replay may run ``passes`` forwards; a tick's calls
    outside any region are accounted for, not ruled on."""
    x = torch.tensor(np.random.default_rng(0).choice(
        [-1.0, 1.0], size=(2, 20, 48)).astype(np.float32))
    w = torch.ones((3, 24, 48))
    bias, flip = torch.zeros(48), torch.ones(48)

    def layer():
        ops.fused_conv_mav(x, w, bias, flip, groups=2)

    aud = LaunchAuditor(imc_layers=2, mode="raise")
    aud.begin_tick(0)
    with aud.region("hop"):
        layer()
        layer()
    with aud.region("replay", passes=2):
        for _ in range(4):
            layer()
    layer()                                      # outside any region
    aud.end_tick()
    h = aud.history()[0]
    assert (h["k1_calls"], h["outside_regions"]) == (7, 1)
    assert aud.stats()["traced_launches"] == 6
    aud.begin_tick(1)
    with pytest.raises(LaunchAuditError, match="replay"):
        with aud.region("replay"):
            for _ in range(3):
                layer()
    with pytest.raises(LaunchAuditError, match="gate"):
        with aud.region("gate"):
            layer()


# ---------------------------------------------------------------------------
# Trace builder
# ---------------------------------------------------------------------------


def test_trace_builder_relative_timestamps():
    tb = TraceBuilder(process_name="p")
    tb.span("a", 10.0, 10.5, tick=0)
    tb.span("b", 11.0, 11.25, tick=1)
    tb.counter("c", 11.5, depth=3)
    tb.instant("i", 12.0)
    evs = tb.to_chrome()["traceEvents"][1:]
    assert evs[0]["ts"] == 0.0 and evs[0]["dur"] == 5e5
    assert evs[1]["ts"] == 1e6 and evs[1]["dur"] == 2.5e5
    assert evs[2]["ph"] == "C" and evs[2]["args"] == {"depth": 3}
    assert evs[3]["ph"] == "i" and evs[3]["ts"] == 2e6
    ref = jobs.TraceBuilder(process_name="p")
    ref.span("a", 10.0, 10.5, tick=0)
    ref.span("b", 11.0, 11.25, tick=1)
    ref.counter("c", 11.5, depth=3)
    ref.instant("i", 12.0)
    assert tb.to_chrome() == ref.to_chrome()
