"""Chrome / Perfetto trace export for the serving tick.

Own copy of ``repro/obs/trace.py``.  ``TraceBuilder`` collects complete
events (``"ph": "X"``), one span per tick section (init, replay, hop,
gate, decide, riders and the whole tick) with wall-clock durations and
attributes (tick, slots, modelled uJ), plus counter samples and instant
markers, and writes the Chrome trace-event JSON that ``chrome://tracing``
and the Perfetto UI load.

Timestamps are microseconds from the earliest start, rebased at export
(the whole-tick span starts first but is recorded last within a tick),
so a trace is deterministic up to wall-clock jitter.
"""

from __future__ import annotations

import json

__all__ = ["TraceBuilder"]


class TraceBuilder:
    def __init__(self, process_name="repro_torch.serving"):
        # events hold absolute perf_counter seconds in "ts"; to_chrome()
        # rebases everything onto the earliest start at export time
        self._events = []
        self._process_name = process_name

    def __len__(self):
        return len(self._events)

    def span(self, name, t_start_s, t_end_s, tid=0, **args):
        """Record a complete span; times are ``time.perf_counter()`` values."""
        self._events.append({
            "name": str(name),
            "ph": "X",
            "ts": float(t_start_s),
            "dur": max(0.0, (t_end_s - t_start_s) * 1e6),
            "pid": 0,
            "tid": int(tid),
            "args": args,
        })

    def counter(self, name, t_s, **values):
        """Record a counter track sample (Perfetto renders as a graph)."""
        self._events.append({
            "name": str(name),
            "ph": "C",
            "ts": float(t_s),
            "pid": 0,
            "args": values,
        })

    def instant(self, name, t_s, **args):
        """Record an instant marker (admission, alarm, swap...)."""
        self._events.append({
            "name": str(name),
            "ph": "i",
            "ts": float(t_s),
            "pid": 0,
            "tid": 0,
            "s": "p",
            "args": args,
        })

    def to_chrome(self):
        meta = [{
            "name": "process_name",
            "ph": "M",
            "pid": 0,
            "args": {"name": self._process_name},
        }]
        t0 = min((e["ts"] for e in self._events), default=0.0)
        events = [dict(e, ts=(e["ts"] - t0) * 1e6) for e in self._events]
        return {"traceEvents": meta + events,
                "displayTimeUnit": "ms"}

    def dump(self, path):
        """Write Chrome trace-event JSON; returns the span/event count."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)
            f.write("\n")
        return len(self._events)
