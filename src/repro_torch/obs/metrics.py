"""Metrics registry for the serving stack.

Own copy of the counter and gauge core of ``repro/obs/metrics.py``.  Cells
are keyed by ``(name, labels)``, labels being a sorted tuple of ``(key,
value)`` pairs, so one metric name can be split by cause or kind.  A
counter is incremented (``inc``) or set (``set_counter``); a gauge is
last-write-wins (``set_gauge``); a name keeps the kind it was first
written as.  ``counter_property`` lets a serving class keep attribute
counters (``srv._steps += 1``) that live in its registry.  Histograms,
snapshots, merging and Prometheus export wait for the slices that need
them.
"""

from __future__ import annotations

COUNTER = "counter"
GAUGE = "gauge"


def _label_key(labels):
    return tuple(sorted(labels.items()))


class MetricsRegistry:
    """Labelled counters and gauges in one map."""

    def __init__(self):
        self._kinds = {}          # name -> kind
        self._cells = {}          # (name, labelkey) -> number

    def _kind(self, name, kind):
        have = self._kinds.setdefault(name, kind)
        if have != kind:
            raise ValueError(
                f"metric {name!r} already registered as {have}, not {kind}")

    def inc(self, name, value=1, **labels):
        self._kind(name, COUNTER)
        key = (name, _label_key(labels))
        self._cells[key] = self._cells.get(key, 0) + value

    def set_counter(self, name, value, **labels):
        """Directly set a counter cell."""
        self._kind(name, COUNTER)
        self._cells[(name, _label_key(labels))] = value

    def set_gauge(self, name, value, **labels):
        """Set a gauge cell (last write wins)."""
        self._kind(name, GAUGE)
        self._cells[(name, _label_key(labels))] = value

    def value(self, name, default=0, **labels):
        """Cell value (counter or gauge) for an exact label set."""
        return self._cells.get((name, _label_key(labels)), default)

    def collect(self):
        """Nested view: ``{name: [{"labels": {...}, "value": v}, ...]}``
        (counters and gauges alike)."""
        out = {}
        for (name, lk), value in sorted(self._cells.items()):
            out.setdefault(name, []).append({"labels": dict(lk),
                                             "value": value})
        return out


def counter_property(name, doc=None, **labels):
    """A registry-backed attribute: ``self._steps += 1`` reads and writes
    one counter cell of ``self._metrics``."""

    def fget(self):
        return self._metrics.value(name, **labels)

    def fset(self, value):
        self._metrics.set_counter(name, value, **labels)

    return property(fget, fset, doc=doc or f"registry counter {name!r}")
