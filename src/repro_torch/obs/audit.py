"""Launch auditor for the one-launch-per-IMC-layer contract.

Port of ``repro/obs/audit.py``.  The serving contract: every batched
scheduler tick makes ONE fused-layer call per IMC layer for all ready
slots (inference, canary and learning traffic together), and a gated
(silent-fill) tick makes none.

The auditor combines two kinds of evidence:

* **call accounting**: the scheduler wraps every batched compute call in
  :meth:`LaunchAuditor.region`, attributing it to ``(tick, cause)``,
  ``cause`` one of ``init`` / ``hop`` / ``replay`` / ``gate`` (and
  ``compiled``, kept as pure logic for a whole-tick block).  Each compute
  call implies ``imc_layers`` fused launches (conv0 is plain tensor ops);
* **counted calls**: instead of patching ``pl.pallas_call``, a region
  reads the fused layer's call count (``kernels.imc_mav.ops.CALLS``, the
  calling thread's: pools of a sharded server that tick on threads of
  their own count apart), which ``fused_conv_mav`` /
  ``fused_conv_mav_step`` advance on both routes: the kernel's launch on a CUDA tensor (where it moves with
  ``ops.COUNTS.launches``) and the plain version on a CPU tensor.  The
  reference counts fresh traces, which are 0 on a jit cache hit; the
  port counts every call, so ``traced_launches`` counts calls, and a
  streaming compute region always counts exactly ``imc_layers`` (a
  recompute replay of n hops, n x ``imc_layers``: the scheduler passes
  ``passes=n``).

Per-tick rules (checked in :meth:`end_tick`):

* at most one batched ``hop`` call;
* at most one ``gate`` fill;
* at most one ``init`` wave when the server batches admissions
  (``batch_init=True``; an unbatched server runs one B = 1 init per
  admission);
* at most one ``compiled`` block, and never alongside interpreted calls
  in the same tick;
* no region counts more than ``passes x imc_layers`` fused calls, and a
  ``gate`` region none.

Every fused call of a tick is accounted for: the tick's history entry
holds the calls counted between ``begin_tick`` and ``end_tick``
(``k1_calls``) and those made outside any region (``outside_regions``:
the health monitor's expected canary state, hop-retarget re-inits),
which no rule bounds.

``mode`` selects what a violation does: ``"flag"`` appends to
:attr:`violations`, ``"raise"`` raises :class:`LaunchAuditError`.
"""

from __future__ import annotations

from collections import deque
from contextlib import contextmanager

from repro_torch.kernels.imc_mav import ops

__all__ = ["LaunchAuditor", "LaunchAuditError", "AUDIT_MODES"]

AUDIT_MODES = ("off", "flag", "raise")

# causes whose region launches fused kernels (a gate region launches none)
_COMPUTE_CAUSES = ("init", "hop", "replay")
# a compiled whole-tick block launches fused kernels too, but its per-tick
# rule differs: the block is the tick's entire compute
_LAUNCH_CAUSES = _COMPUTE_CAUSES + ("compiled",)


class LaunchAuditError(RuntimeError):
    """A tick broke the one-launch-per-IMC-layer contract."""


class LaunchAuditor:
    def __init__(self, imc_layers, mode="flag", batch_init=True,
                 history=256, device=None):
        if mode not in AUDIT_MODES:
            raise ValueError(f"audit mode must be one of {AUDIT_MODES}, "
                             f"got {mode!r}")
        if imc_layers < 1:
            raise ValueError("imc_layers must be >= 1")
        self.imc_layers = int(imc_layers)
        self.mode = mode
        # a device label rides every violation and stats dict, so a fleet
        # rollup can attribute launches to the pool that made them
        self.device = device
        self.batch_init = bool(batch_init)
        self.violations = []
        self._ticks = 0
        self._calls = {c: 0 for c in _LAUNCH_CAUSES + ("gate",)}
        self._traced = 0
        self._outside = 0
        self._tick = None
        self._tick_calls = None
        self._tick_start = 0
        self._history = deque(maxlen=history)
        self._max_hop_calls = 0

    # -- tick lifecycle ---------------------------------------------------

    def begin_tick(self, tick):
        self._tick = int(tick)
        self._tick_calls = []
        self._tick_start = ops.CALLS.calls

    def end_tick(self):
        if self._tick is None:
            return
        counts = {c: 0 for c in _LAUNCH_CAUSES + ("gate",)}
        for call in self._tick_calls:
            counts[call["cause"]] += 1
        k1_calls = ops.CALLS.calls - self._tick_start
        outside = k1_calls - sum(call["traced"] for call in self._tick_calls)
        if counts["hop"] > 1:
            self._violate("hop", f"{counts['hop']} batched hop calls in "
                          f"one tick (max 1)")
        if counts["gate"] > 1:
            self._violate("gate", f"{counts['gate']} gate fills in one "
                          f"tick (max 1)")
        if self.batch_init and counts["init"] > 1:
            self._violate("init", f"{counts['init']} init waves in one "
                          f"batched-admission tick (max 1)")
        if counts["compiled"] > 1:
            self._violate("compiled", f"{counts['compiled']} compiled "
                          f"blocks in one tick (max 1)")
        if counts["compiled"] and any(counts[c] for c in
                                      ("init", "hop", "replay", "gate")):
            others = {c: counts[c] for c in ("init", "hop", "replay",
                                             "gate") if counts[c]}
            self._violate("compiled", f"compiled block run together with "
                          f"interpreted calls {others} in one tick (the "
                          f"block must be the tick's entire compute)")
        launches = sum(counts[c] for c in _LAUNCH_CAUSES) * self.imc_layers
        self._history.append({"tick": self._tick, "calls": counts,
                              "launches": launches,
                              "launches_per_layer":
                                  launches // self.imc_layers,
                              "k1_calls": k1_calls,
                              "outside_regions": outside})
        self._max_hop_calls = max(self._max_hop_calls, counts["hop"])
        self._outside += outside
        self._ticks += 1
        self._tick = None
        self._tick_calls = None

    # -- launch-site accounting -------------------------------------------

    @contextmanager
    def region(self, cause, passes=1):
        """Wrap one batched call site: attribute it and count the fused
        calls made inside it (``passes``: the IMC forwards the call runs,
        n for a recompute replay of n hops)."""
        if cause not in self._calls:
            raise ValueError(f"unknown launch cause {cause!r}")
        start = ops.CALLS.calls
        yield
        self._on_call(cause, ops.CALLS.calls - start, passes)

    def _on_call(self, cause, traced, passes=1):
        self._calls[cause] += 1
        self._traced += traced
        if self._tick_calls is not None:
            self._tick_calls.append(
                {"cause": cause, "traced": traced,
                 "launches": (self.imc_layers
                              if cause in _LAUNCH_CAUSES else 0)})
        if cause == "gate":
            if traced:
                self._violate(cause, f"gate fill traced {traced} fused "
                              f"launches (must trace 0)")
        elif traced > passes * self.imc_layers:
            self._violate(cause, f"{cause} call traced {traced} fused "
                          f"launches in one batched call (max "
                          f"{passes * self.imc_layers}: {passes} x "
                          f"{self.imc_layers} IMC layers)")

    def _violate(self, cause, detail):
        violation = {"tick": self._tick, "cause": cause, "detail": detail}
        if self.device is not None:
            violation["device"] = self.device
        self.violations.append(violation)
        if self.mode == "raise":
            where = (f" [device {self.device}]"
                     if self.device is not None else "")
            raise LaunchAuditError(
                f"tick {self._tick}{where}: [{cause}] {detail}")

    # -- reporting --------------------------------------------------------

    def history(self):
        """Recent per-tick launch attribution, oldest first."""
        return list(self._history)

    def stats(self):
        if self.device is not None:
            return dict(self._stats_base(), device=self.device)
        return self._stats_base()

    def _stats_base(self):
        return {
            "mode": self.mode,
            "imc_layers": self.imc_layers,
            "ticks": self._ticks,
            "calls": dict(self._calls),
            "traced_launches": self._traced,
            "outside_regions": self._outside,
            "max_hop_calls_per_tick": self._max_hop_calls,
            "violations": len(self.violations),
        }
