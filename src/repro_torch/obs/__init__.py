"""Observability for the serving stack (port of ``repro.obs``).

Four pieces, all optional except the registry:

* :class:`MetricsRegistry`: labelled counters, gauges and histograms;
  the serving classes' ``stats()`` dicts are views over one registry per
  server (always on: it is the counter storage);
* :class:`FlightRecorder`: a bounded ring of structured per-tick events,
  dumpable on an alarm;
* :class:`LaunchAuditor`: enforces the one-fused-launch-per-IMC-layer
  contract per tick, counting the fused layer's calls at its wrapper,
  with ``flag`` and ``raise`` modes;
* :class:`TraceBuilder`: per-tick spans as Chrome / Perfetto trace JSON.

``ObsConfig`` selects which extras a ``StreamServer`` turns on; the
default (all off) serves exactly what the server serves with everything
on.  ``ObsConfig.from_env()`` reads ``REPRO_OBS_AUDIT`` /
``REPRO_OBS_RECORDER`` / ``REPRO_OBS_TRACE``, the names the JAX package
reads, so a run can turn the auditor on without touching call sites.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from .audit import AUDIT_MODES, LaunchAuditError, LaunchAuditor
from .metrics import MetricsRegistry, counter_property
from .recorder import FlightRecorder
from .trace import TraceBuilder

__all__ = [
    "AUDIT_MODES",
    "FlightRecorder",
    "LaunchAuditError",
    "LaunchAuditor",
    "MetricsRegistry",
    "ObsConfig",
    "TraceBuilder",
    "counter_property",
]


@dataclass(frozen=True)
class ObsConfig:
    """What telemetry a ``StreamServer`` runs beyond the registry.

    recorder   flight-recorder ring capacity in events; 0 disables it.
    audit      launch-auditor mode: "off", "flag" or "raise".
    trace      collect per-tick spans (dump with
               ``StreamServer.trace.dump(path)``).
    """

    recorder: int = 0
    audit: str = "off"
    trace: bool = False

    def __post_init__(self):
        if self.audit not in AUDIT_MODES:
            raise ValueError(
                f"audit must be one of {AUDIT_MODES}, got {self.audit!r}")
        if self.recorder < 0:
            raise ValueError("recorder capacity must be >= 0")

    @classmethod
    def from_env(cls):
        """Build from the ``REPRO_OBS_*`` environment variables (read at
        call time)."""
        return cls(
            recorder=int(os.environ.get("REPRO_OBS_RECORDER", "0")),
            audit=os.environ.get("REPRO_OBS_AUDIT", "off"),
            trace=os.environ.get("REPRO_OBS_TRACE", "") not in
            ("", "0", "false"),
        )
