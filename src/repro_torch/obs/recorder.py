"""Per-tick flight recorder: a bounded ring of structured serving events.

Own copy of ``repro/obs/recorder.py``.  The recorder keeps the last
``capacity`` events of the serving loop (admissions, rejections,
evictions, SLO sheds, hop retargets, health transitions, heal-job
phases, customization-session phases and each tick's composition and
modelled energy), so an alarm or a crash can dump the recent history
without the server logging anything in steady state.

Events are plain dicts ``{"seq", "tick", "kind", ...fields}``; ``seq`` is
a sequence number that survives the ring's wraparound (``dropped()``
says how many events fell off).  ``snapshot()``/``restore()`` round-trip
the ring in the reference's format, and ``dump(path)`` writes it as JSON
lines with sorted keys.
"""

from __future__ import annotations

import json
from collections import deque

__all__ = ["FlightRecorder"]

_SNAP_VERSION = 1


class FlightRecorder:
    def __init__(self, capacity=256):
        if capacity < 1:
            raise ValueError("flight recorder capacity must be >= 1")
        self.capacity = int(capacity)
        self._ring = deque(maxlen=self.capacity)
        self._seq = 0

    def record(self, tick, kind, **fields):
        event = {"seq": self._seq, "tick": int(tick), "kind": str(kind)}
        event.update(fields)
        self._seq += 1
        self._ring.append(event)
        return event

    def events(self, kind=None):
        """Events oldest-first, optionally filtered by ``kind``."""
        if kind is None:
            return list(self._ring)
        return [e for e in self._ring if e["kind"] == kind]

    def __len__(self):
        return len(self._ring)

    def dropped(self):
        """How many events have fallen off the ring."""
        return self._seq - len(self._ring)

    def dump(self, path):
        """Write the ring oldest-first as JSON lines; returns the count."""
        events = self.events()
        with open(path, "w") as f:
            for event in events:
                f.write(json.dumps(event, sort_keys=True) + "\n")
        return len(events)

    def snapshot(self):
        return {"version": _SNAP_VERSION, "capacity": self.capacity,
                "seq": self._seq, "events": self.events()}

    def restore(self, payload):
        if payload.get("version") != _SNAP_VERSION:
            raise ValueError(
                f"unsupported recorder snapshot version "
                f"{payload.get('version')!r}")
        self.capacity = int(payload["capacity"])
        self._ring = deque(payload["events"], maxlen=self.capacity)
        self._seq = int(payload["seq"])
