"""Metrics registry for the serving stack.

Own copy of the counter core of ``repro/obs/metrics.py``.  Cells are keyed
by ``(name, labels)``, labels being a sorted tuple of ``(key, value)``
pairs, so one metric name can be split by cause or kind.
``counter_property`` lets a serving class keep attribute counters
(``srv._steps += 1``) that live in its registry.  Gauges, histograms,
snapshots, merging and Prometheus export wait for the slices that need
them.
"""

from __future__ import annotations


def _label_key(labels):
    return tuple(sorted(labels.items()))


class MetricsRegistry:
    """Labelled counters in one map."""

    def __init__(self):
        self._cells = {}          # (name, labelkey) -> number

    def inc(self, name, value=1, **labels):
        key = (name, _label_key(labels))
        self._cells[key] = self._cells.get(key, 0) + value

    def set_counter(self, name, value, **labels):
        """Directly set a counter cell."""
        self._cells[(name, _label_key(labels))] = value

    def value(self, name, default=0, **labels):
        """Cell value for an exact label set."""
        return self._cells.get((name, _label_key(labels)), default)

    def collect(self):
        """Nested view: ``{name: [{"labels": {...}, "value": v}, ...]}``."""
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
