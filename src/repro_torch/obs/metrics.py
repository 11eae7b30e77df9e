"""Metrics registry for the serving stack.

Own copy of ``repro/obs/metrics.py``.  One registry holds every counter,
gauge and histogram a ``StreamServer`` emits (the server, its health
monitor, its customization sessions, VAD gating and the modelled energy).
Cells are keyed by ``(name, labels)``, labels being a sorted tuple of
``(key, value)`` pairs, so one metric name can be split by layer, cause
or kind; a name keeps the kind it was first written as.

Three cell kinds:

* **counter**: incremented (``inc``) or set (``set_counter``, which
  snapshot restores and the registry-backed attributes use);
* **gauge**: last write wins (``set_gauge``);
* **histogram**: a running ``count/sum/min/max`` summary (``observe``),
  without buckets, so the serving tick's cost stays flat.

``snapshot()`` returns a JSON-serializable payload in the reference's
format and version, and ``restore()`` round-trips it; ``merge()`` folds
another registry in (counters sum, gauges last-write, histograms pool);
``prometheus_text()`` renders the registry in the Prometheus text
exposition format, as the reference renders it.  ``counter_property``
lets a serving class keep attribute counters (``srv._steps += 1``) that
live in its registry.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = [
    "MetricsRegistry",
    "counter_property",
]

_SNAP_VERSION = 1

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"


def _label_key(labels):
    return tuple(sorted(labels.items()))


@dataclass
class _Hist:
    count: int = 0
    total: float = 0.0
    min: float = field(default=float("inf"))
    max: float = field(default=float("-inf"))

    def observe(self, value):
        value = float(value)
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value

    def merge(self, other):
        if other.count == 0:
            return
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def summary(self):
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0}
        return {"count": self.count, "sum": self.total, "min": self.min,
                "max": self.max, "mean": self.total / self.count}


class MetricsRegistry:
    """Labelled counters/gauges/histograms behind one snapshotable map."""

    def __init__(self):
        # name -> kind; (name, labelkey) -> number | _Hist
        self._kinds = {}
        self._cells = {}

    # -- write paths ------------------------------------------------------

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
        """Directly set a counter cell (snapshot restore / reset paths)."""
        self._kind(name, COUNTER)
        self._cells[(name, _label_key(labels))] = value

    def set_gauge(self, name, value, **labels):
        self._kind(name, GAUGE)
        self._cells[(name, _label_key(labels))] = value

    def observe(self, name, value, **labels):
        self._kind(name, HISTOGRAM)
        key = (name, _label_key(labels))
        cell = self._cells.get(key)
        if cell is None:
            cell = self._cells[key] = _Hist()
        cell.observe(value)

    # -- read paths -------------------------------------------------------

    def value(self, name, default=0, **labels):
        """Cell value for an exact label set (histograms: summary dict)."""
        cell = self._cells.get((name, _label_key(labels)))
        if cell is None:
            return default
        if isinstance(cell, _Hist):
            return cell.summary()
        return cell

    def total(self, name):
        """Sum of a counter/gauge across every label set (0 if absent)."""
        out = 0
        for (n, _), cell in self._cells.items():
            if n == name and not isinstance(cell, _Hist):
                out += cell
        return out

    def labels(self, name):
        """Every label dict registered under ``name``."""
        return [dict(lk) for (n, lk) in self._cells if n == name]

    def collect(self):
        """Nested view:
        ``{name: {"kind": ..., "cells": [{labels, value}, ...]}}``."""
        out = {}
        for (name, lk), cell in sorted(self._cells.items(),
                                       key=lambda kv: kv[0]):
            entry = out.setdefault(
                name, {"kind": self._kinds[name], "cells": []})
            value = cell.summary() if isinstance(cell, _Hist) else cell
            entry["cells"].append({"labels": dict(lk), "value": value})
        return out

    # -- lifecycle --------------------------------------------------------

    def snapshot(self):
        cells = []
        for (name, lk), cell in sorted(self._cells.items(),
                                       key=lambda kv: kv[0]):
            if isinstance(cell, _Hist):
                payload = {"count": cell.count, "sum": cell.total,
                           "min": cell.min, "max": cell.max}
            else:
                payload = cell
            cells.append([name, self._kinds[name], list(map(list, lk)),
                          payload])
        return {"version": _SNAP_VERSION, "cells": cells}

    def restore(self, payload):
        if payload.get("version") != _SNAP_VERSION:
            raise ValueError(
                f"unsupported metrics snapshot version "
                f"{payload.get('version')!r}")
        self._kinds.clear()
        self._cells.clear()
        for name, kind, lk, value in payload["cells"]:
            self._kinds.setdefault(name, kind)
            key = (name, tuple((k, v) for k, v in lk))
            if kind == HISTOGRAM:
                cell = _Hist()
                cell.count = value["count"]
                cell.total = value["sum"]
                cell.min = value["min"]
                cell.max = value["max"]
                self._cells[key] = cell
            else:
                self._cells[key] = value

    def merge(self, other):
        """Fold ``other`` in: counters sum, gauges last-write, hists pool."""
        for (name, lk), cell in other._cells.items():
            kind = other._kinds[name]
            self._kind(name, kind)
            key = (name, lk)
            if kind == COUNTER:
                self._cells[key] = self._cells.get(key, 0) + cell
            elif kind == GAUGE:
                self._cells[key] = cell
            else:
                mine = self._cells.get(key)
                if mine is None:
                    mine = self._cells[key] = _Hist()
                mine.merge(cell)

    # -- export -----------------------------------------------------------

    def prometheus_text(self):
        """Prometheus text exposition (dots become underscores)."""
        lines = []
        by_name = {}
        for (name, lk), cell in sorted(self._cells.items(),
                                       key=lambda kv: kv[0]):
            by_name.setdefault(name, []).append((lk, cell))
        for name, cells in by_name.items():
            kind = self._kinds[name]
            pname = name.replace(".", "_").replace("-", "_")
            ptype = {COUNTER: "counter", GAUGE: "gauge",
                     HISTOGRAM: "summary"}[kind]
            lines.append(f"# TYPE {pname} {ptype}")
            for lk, cell in cells:
                lab = ",".join(f'{k}="{v}"' for k, v in lk)
                lab = "{" + lab + "}" if lab else ""
                if isinstance(cell, _Hist):
                    lines.append(f"{pname}_count{lab} {cell.count}")
                    lines.append(f"{pname}_sum{lab} {cell.total}")
                else:
                    lines.append(f"{pname}{lab} {cell}")
        return "\n".join(lines) + "\n"


def counter_property(name, doc=None, **labels):
    """A registry-backed attribute: ``self._steps += 1`` keeps working.

    Builds a property whose getter/setter read and write one counter cell
    of ``self._metrics``, so the serving classes keep their historical
    attribute API (``srv._steps``, ``srv._init_calls``, ...) while every
    count lives in — and snapshots through — the registry.
    """

    def fget(self):
        return self._metrics.value(name, **labels)

    def fset(self, value):
        self._metrics.set_counter(name, value, **labels)

    return property(fget, fset, doc=doc or f"registry counter {name!r}")
