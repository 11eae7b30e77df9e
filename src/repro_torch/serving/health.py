"""Canary health monitoring and self-healing recompensation for serving.

Port of ``repro/serving/health.py``.  A deployed chip fails silently: an
SA offset drifting past the decision margin gives confidently wrong
keywords, not errors.  The monitor detects silicon faults
(``core.faults``) in production and re-runs the paper's §IV-B test-mode
bias compensation online to heal them:

* **canary windows**: every ``interval`` ticks the monitor submits one
  known calibration window as an internal stream (``[hop zeros,
  window]``, captured at ``window + hop``), so its init rides the batched
  admission wave and its hop rides the same batched call as live
  traffic: it adds no launch to a call (though an init wave or a hop
  tick with no live stream in it is a call of the canary's own).  The
  canary reuses one reserved uid, so its SA-noise field is fixed and its
  expected per-layer state is computed once per accepted chip, through
  the server's own engine: on the card that is the fused kernel
  (``use_kernel`` of the server; the reference computes it on its plain
  route, and the kernel is bitwise equal to it), counted in
  ``stats()["imc_passes"]``;
* **per-layer divergence**: the captured state holds every IMC layer's
  output columns (layer i's carry into layer i+1, the GAP ring for the
  last); comparing them channel-wise with the expected state localizes
  the faulty layer and columns, in bias-channel coordinates
  (``_unshuffle``);
* **the state machine**: ``healthy -> degraded`` on the first failing
  canary, ``-> quarantined`` after ``quarantine_after`` failures in a row
  (the recovery job starts), ``-> recovering`` once the recompensated
  biases are swapped in, ``-> healthy`` after ``recover_after`` clean
  canaries.  While not healthy every decision event carries
  ``degraded: True``;
* **self-healing**: the recovery job runs the test mode as a
  tick-resumable background job: one tick of
  ``calibration_ideal_counts``, then ``layers_per_tick`` layers a tick of
  ``compensate_layer_bias`` measuring the chip's current fault deltas,
  then the integer bias deltas swap in through the scheduler's
  chip-global rider row (``_set_heal_delta``).  Drift and trim flips heal
  to sub-count residuals; a channel whose requested correction the
  clipped write cannot reach is a rail and is masked at once; channels
  still divergent after ``stuck_after`` post-heal canaries are masked;
  a layer failing only in aggregate has its best-effort heal accepted,
  and the current fault + heal delta of every healed layer is frozen
  into the expected reference (``_ref_delta``, ``_frozen_layers``,
  ``accepted_layers``), so later canaries measure new faults against the
  accepted chip.

The monitor needs ``streaming=True`` (divergence reads the carries and
the GAP ring) and a fixed hop (a retarget would rebuild the canary's
state mid-capture).  Canaries pause while the server has no live
traffic, so ``drain()`` still ends.

With the server's flight recorder on, every transition is a ``health``
event (``state``, ``prev``) and each recovery phase a ``heal`` event
(``ideal`` with its layers, ``layers`` with its progress, ``apply`` with
the healed layers and the modelled energy).  The expected canary state's
two B = 1 forwards run outside the scheduler's launch-auditor regions,
so the auditor counts them as calls outside any region.

Not in this port yet: ``snapshot()`` / ``restore()`` (they come with the
server's snapshots).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import energy, jaxrand
from repro_torch.models import kws
from repro_torch.obs.metrics import counter_property
from repro_torch.training import kws as tr


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Canary cadence, divergence thresholds and recovery pacing.

    ``interval``: ticks between canary submissions; ``calib_windows``:
    calibration inputs of the recompensation measurement (canaries always
    use window 0); ``divergence_frac``: fraction of mismatching state
    cells that fails a layer; ``channel_frac``: per-channel row-mismatch
    fraction that implicates the channel (a stuck column flips about half
    its rows, so keep it below 0.5); ``quarantine_after`` /
    ``recover_after``: failing / clean canaries in a row to confirm a
    fault / declare recovery; ``stuck_after``: post-heal failing canaries
    before still-divergent channels are masked; ``layers_per_tick`` bounds
    the recompensation work per tick; ``recal_sa_noise_std`` is the test
    mode's measurement noise; ``recal_scope``: ``"prefix"`` heals conv1 up
    to the flagged layer, ``"all"`` every IMC layer."""

    interval: int = 8
    calib_windows: int = 2
    divergence_frac: float = 0.05
    channel_frac: float = 0.4
    quarantine_after: int = 2
    recover_after: int = 2
    stuck_after: int = 2
    layers_per_tick: int = 2
    recal_sa_noise_std: float = 1.0
    recal_scope: str = "prefix"
    seed: int = 0
    auto_recover: bool = True

    def __post_init__(self):
        if self.interval < 1 or self.calib_windows < 1:
            raise ValueError("interval and calib_windows must be >= 1")
        if not (0.0 < self.channel_frac <= 1.0
                and 0.0 < self.divergence_frac <= 1.0):
            raise ValueError("divergence_frac and channel_frac must be "
                             "in (0, 1]")
        if min(self.quarantine_after, self.recover_after, self.stuck_after,
               self.layers_per_tick) < 1:
            raise ValueError("state-machine counts must be >= 1")
        if self.recal_scope not in ("prefix", "all"):
            raise ValueError("recal_scope must be 'prefix' or 'all'")


class HealthMonitor:
    """One server's canary scheduler, divergence localizer and the runner
    of its recovery job.  Built by
    ``StreamServer(health=HealthConfig(...))``; the server calls
    ``on_step`` (captures) and ``tick`` (recovery work and canary spawns)
    from inside ``step()``."""

    STATES = ("healthy", "degraded", "quarantined", "recovering")

    # counters in the server's metrics registry
    canaries = counter_property("health.canaries")
    failed_canaries = counter_property("health.failed_canaries")
    recoveries = counter_property("health.recoveries")
    recovery_energy_uj = counter_property("health.recovery_energy_uj")

    def __init__(self, srv, hcfg: HealthConfig):
        if not srv.streaming:
            raise ValueError("health monitoring requires streaming=True "
                             "(divergence reads the per-layer carries and "
                             "the GAP ring)")
        if srv.hcfg is not None:
            raise ValueError("health monitoring requires a fixed hop "
                             "(dynamic_hop retargets would rebuild the "
                             "canary state mid-capture)")
        self.hcfg = hcfg
        self.srv = srv
        self._metrics = srv._metrics      # backs the counter properties
        self.state = "healthy"
        # reserved uid: the canary's noise-field key never changes
        self._uid = srv._uid
        srv._uid += 1
        window, hop = srv.geom.window, srv.geom.hop
        self._xcal = jaxrand.uniform(
            jaxrand.PRNGKey(hcfg.seed, device="cpu"),
            (hcfg.calib_windows, window), -1.0, 1.0).numpy()
        self._wav = np.concatenate([np.zeros((hop,), np.float32),
                                    self._xcal[0]])
        self._expected = None            # computed when a canary needs it
        self._pending: Optional[dict] = None
        self._canary_n = 0
        self._last_spawn = -(10 ** 9)    # the first canary fires at once
        self._fail_streak = 0
        self._ok_streak = 0
        self._post_heal_fails = 0
        self.canaries = 0
        self.failed_canaries = 0
        self.recoveries = 0
        self.recovery_energy_uj = 0.0
        self.detected_tick: Optional[int] = None
        self.quarantined_tick: Optional[int] = None
        self.implicated: Dict[str, List[int]] = {}
        self.divergence: Dict[str, float] = {}
        names = srv.cfg.imc_layer_names()
        self.masked = {name: np.zeros((srv.cfg.channels[int(name[4:])],),
                                      bool) for name in names}
        # the accepted reference delta: fault + heal residuals frozen into
        # the expected canary state when a column is written off or a
        # layer's best-effort heal is accepted
        self._ref_delta = {
            name: np.zeros((srv.cfg.channels[int(name[4:])],), np.float32)
            for name in names}
        self.accepted_layers: List[str] = []
        self._healed: List[str] = []        # layers with an applied heal
        self._frozen_layers: List[str] = []  # layers whose whole delta is
        #                                      in the accepted baseline
        self.history: List[dict] = [{"tick": 0, "state": "healthy"}]
        self._recovery: Optional[dict] = None

    # -- the expected canary state on the accepted chip ----------------------

    def _ensure_expected(self) -> None:
        """Per-layer expected state of canary window 0 on the accepted
        chip: one B = 1 init and one hop through the server's engine
        (same noise field, chip offsets and kernel route as the live
        canary), with the frozen ``_ref_delta`` as the bias-delta rider
        once any is set."""
        if self._expected is not None:
            return
        srv = self.srv
        eng, geom, dev = srv.engine, srv.geom, srv.device
        riders = ()
        if any(d.any() for d in self._ref_delta.values()):
            hwp, _ = kws.as_hw_params(eng.hw)
            riders = ({name: kws.as_tensor(d, dev)[None]
                       for name, d in self._ref_delta.items()},
                      hwp.fc_w[None], hwp.fc_b[None])
        key = srv.stream_key(self._uid)[None].to(dev)
        wav = srv._tensor(self._wav[None])
        _, st = eng.init(wav[:, :geom.window], key, *riders)
        _, st = eng.step(st, wav[:, geom.window:], *riders)
        srv._imc_passes += 2
        self._expected = self._read_row(st, 0)

    @staticmethod
    def _read_row(state, s: int) -> dict:
        """Row ``s`` of a stream state's carries and ring, on the host, in
        one device-to-host copy."""
        parts = [c[s] for c in state.carries] + [state.ring[s]]
        flat = torch.cat([p.reshape(-1) for p in parts]).cpu().numpy()
        out, at = [], 0
        for p in parts:
            n = p.numel()
            out.append(flat[at:at + n].reshape(tuple(p.shape)))
            at += n
        return {"carries": out[:-1], "ring": out[-1]}

    # -- per-tick hooks (called by StreamServer.step) ------------------------

    def on_step(self, srv) -> None:
        """Capture the pending canary's per-layer state right after the
        batched hop (before slots retire), then evaluate divergence."""
        p = self._pending
        if p is None:
            return
        rec = srv._streams.get(p["stream"])
        if (rec is None or rec.slot is None or not rec.initialized
                or rec.consumed < p["target"]):
            return
        row = self._read_row(srv._state, rec.slot)
        srv._drop_internal(p["stream"])
        self._pending = None
        self._evaluate(srv, row["carries"], row["ring"])

    def tick(self, srv) -> None:
        """Recovery work first (an apply drops a pending canary), then
        canary spawning while live traffic flows."""
        self._recovery_tick(srv)
        live = any(rec is not None and not rec.internal
                   for rec in srv._slots) or any(
            not rec.internal for rec in srv._queue)
        if (self._pending is None and live
                and srv._steps - self._last_spawn >= self.hcfg.interval):
            self._ensure_expected()
            sid = f"~canary{self._canary_n}"
            srv._submit_internal(sid, self._wav, uid=self._uid)
            self._pending = {"stream": sid,
                             "target": srv.geom.window + srv.geom.hop}
            self._last_spawn = srv._steps
            self._canary_n += 1
            self.canaries += 1

    # -- divergence and the state machine ------------------------------------

    @staticmethod
    def _unshuffle(a: np.ndarray, groups: int) -> np.ndarray:
        """Invert the post-MAV channel shuffle on the last axis, so
        divergence is reported in bias-channel coordinates (where faults
        are injected and heals are written)."""
        if groups <= 1:
            return a
        c = a.shape[-1]
        return (a.reshape(a.shape[:-1] + (c // groups, groups))
                .swapaxes(-1, -2).reshape(a.shape))

    def _transition(self, srv, state: str) -> None:
        if state != self.state:
            prev = self.state
            self.state = state
            self.history.append({"tick": srv._steps, "state": state})
            self._metrics.inc("health.transitions", to=state)
            self._metrics.set_gauge("health.state",
                                    self.STATES.index(state))
            if srv._rec is not None:
                srv._rec.record(srv._steps, "health", state=state,
                                prev=prev)

    def _evaluate(self, srv, carries: List[np.ndarray],
                  ring: np.ndarray) -> None:
        """Compare the captured canary state with the expectation layer by
        layer (``carries[m]`` holds layer m's output columns, the ring the
        last layer's), masked channels excluded.  The alarm fires on an
        implicated channel or a total mismatch >= ``divergence_frac`` at
        any layer, and localizes to the earliest layer with any
        divergence (corruption amplifies downstream)."""
        # the reference may have been reset while this canary was in
        # flight: compare against the current accepted chip
        self._ensure_expected()
        cfg = srv.cfg
        last = cfg.num_conv_layers - 1
        flagged: Dict[str, List[int]] = {}
        self.divergence = {}
        rows: List[tuple] = []
        for m in range(1, cfg.num_conv_layers):
            if m < last:
                obs, ref = carries[m], self._expected["carries"][m]
            else:
                obs, ref = ring, self._expected["ring"]
            if obs.shape[0] == 0:          # zero-width carry: no view
                continue
            g = cfg.groups(m)
            obs, ref = self._unshuffle(obs, g), self._unshuffle(ref, g)
            mism = obs != ref
            mism[:, self.masked[f"conv{m}"]] = False
            frac = mism.mean(axis=0)
            total = float(mism.mean())
            self.divergence[f"conv{m}"] = round(total, 4)
            bad = np.where(frac >= self.hcfg.channel_frac)[0]
            rows.append((f"conv{m}", total, bad))
        if any(bad.size or total >= self.hcfg.divergence_frac
               for _, total, bad in rows):
            for name, total, bad in rows:
                if bad.size or total > 0.0:
                    flagged[name] = [int(c) for c in bad]
                    break
        if flagged:
            self.failed_canaries += 1
            self._fail_streak += 1
            self._ok_streak = 0
            self.implicated = flagged
            if self.state == "healthy":
                self.detected_tick = srv._steps
                self._transition(srv, "degraded")
            if (self.state == "degraded"
                    and self._fail_streak >= self.hcfg.quarantine_after):
                self.quarantined_tick = srv._steps
                self._transition(srv, "quarantined")
                if self.hcfg.auto_recover and self._recovery is None:
                    self._start_recovery(list(flagged))
            elif self.state == "recovering":
                self._post_heal_fails += 1
                # write off only layers a heal has covered, and not while
                # a recovery job is in flight (its apply clears stale
                # divergence)
                ripe = {n: c for n, c in flagged.items()
                        if n in self._healed}
                if (self._post_heal_fails >= self.hcfg.stuck_after
                        and ripe and self._recovery is None):
                    # columns failing on their own are stuck rails: mask
                    # them; a layer failing only in aggregate keeps its
                    # best-effort heal.  Then freeze the current fault +
                    # heal delta of every healed layer (and of masked
                    # columns) into the expected reference
                    chip = srv._chip_delta
                    for name, chans in ripe.items():
                        if chans:
                            self.masked[name][np.asarray(chans,
                                                         np.int64)] = True
                        elif name not in self.accepted_layers:
                            self.accepted_layers.append(name)
                            if name not in self._frozen_layers:
                                self._frozen_layers.append(name)
                    for name in self._healed:
                        if name not in self._frozen_layers:
                            self._frozen_layers.append(name)
                    if chip is not None:
                        for name in self._frozen_layers:
                            self._ref_delta[name] = chip[name].copy()
                        for name, m_ in self.masked.items():
                            if m_.any() and name not in self._frozen_layers:
                                self._ref_delta[name][m_] = chip[name][m_]
                    self._post_heal_fails = 0
                    self._expected = None
                elif self.hcfg.auto_recover and self._recovery is None:
                    self._start_recovery(list(flagged))  # renewed drift
        else:
            self._fail_streak = 0
            self._ok_streak += 1
            self._post_heal_fails = 0
            if (self.state != "healthy"
                    and self._ok_streak >= self.hcfg.recover_after
                    and self._recovery is None):
                self.implicated = {}
                self._transition(srv, "healthy")

    # -- self-healing: the test mode as a background job ---------------------

    def _start_recovery(self, layers: List[str]) -> None:
        """Recompensate every layer up to and including the flagged one
        (``"prefix"``: divergence at layer m implicates every layer <= m,
        since the canary sees only each layer's tail columns) or every IMC
        layer (``"all"``)."""
        if self.hcfg.recal_scope == "all":
            todo = list(self.masked.keys())
        else:
            m = max(int(name[4:]) for name in layers)
            todo = [f"conv{i}" for i in range(1, m + 1)]
        self._recovery = {"phase": "ideal", "layers": todo,
                          "idx": 0, "ideal": None, "keys": None, "bias": {}}

    def _fault_measurement(self, srv, name: str, c: int) -> torch.Tensor:
        """What the test mode measures beyond the enrollment baseline: the
        chip's current fault delta on this layer."""
        if srv._faults is not None:
            return kws.as_tensor(srv._faults.deltas()[name], srv.device)
        return torch.zeros((c,), device=srv.device)

    def _recovery_tick(self, srv) -> None:
        job = self._recovery
        if job is None:
            return
        cfg, dev = srv.cfg, srv.device
        hwp, _ = kws.as_hw_params(srv.engine.hw)
        if job["phase"] == "ideal":
            # the digitized-counts reference forward: the unfused path, no
            # IMC launch; one tick, like enrollment
            job["ideal"] = tr.calibration_ideal_counts(
                srv.engine.hw, self._xcal, cfg, device=dev)
            job["keys"] = tr.calibration_layer_keys(
                cfg, self.hcfg.seed + 1 + self.recoveries, device=dev)
            job["phase"] = "layers"
            if srv._rec is not None:
                srv._rec.record(srv._steps, "heal", phase="ideal",
                                layers=list(job["layers"]))
            return
        if job["phase"] == "layers":
            offs = srv.engine.chip_offsets or {}
            todo = job["layers"][job["idx"]:
                                 job["idx"] + self.hcfg.layers_per_tick]
            for name in todo:
                c = cfg.channels[int(name[4:])]
                off = offs.get(name)
                baseline = job["ideal"][name]
                if off is not None:
                    baseline = baseline + off
                # measured = baseline + fault + noise; the new bias starts
                # from the stored (pristine) bias, so recoveries replace
                # the heal instead of stacking it
                new_bias, est = tr.compensate_layer_bias(
                    hwp.bias[name], baseline,
                    self._fault_measurement(srv, name, c),
                    job["keys"][name], self.hcfg.recal_sa_noise_std,
                    return_est=True)
                job["bias"][name] = new_bias
                # a channel whose requested correction the clipped parity
                # grid misses by more than a grid step is a rail (stuck
                # column, macro dropout): the test mode measured it as
                # unhealable, so mask it at its own layer
                shortfall = torch.abs(new_bias - (hwp.bias[name] - est))
                rails = (shortfall > 2.0).cpu().numpy()
                if rails.any():
                    self.masked[name][rails] = True
            job["idx"] += self.hcfg.layers_per_tick
            if job["idx"] >= len(job["layers"]):
                job["phase"] = "apply"
            if srv._rec is not None:
                srv._rec.record(srv._steps, "heal", phase="layers",
                                done=min(job["idx"], len(job["layers"])),
                                total=len(job["layers"]))
            return
        if job["phase"] == "apply":
            heal = {name: (b - hwp.bias[name]).cpu().numpy()
                    for name, b in job["bias"].items()}
            srv._set_heal_delta(heal)
            bias_bits = sum(8 * v.shape[0] for v in heal.values())
            e = energy.recovery_energy_summary(
                kws.layer_stats(cfg), n_cal=self.hcfg.calib_windows,
                bias_bits=bias_bits)
            self.recovery_energy_uj += e["total_uj"]
            self.recoveries += 1
            if srv._rec is not None:
                srv._rec.record(srv._steps, "heal", phase="apply",
                                layers=sorted(heal),
                                uj=round(e["total_uj"], 4))
            # a canary spawned before the heal would mix pre- and
            # post-heal hops: drop it, the next interval spawns a clean one
            if self._pending is not None:
                srv._drop_internal(self._pending["stream"])
                self._pending = None
            # a re-heal replaces the layer's heal, moving frozen layers and
            # masked columns off their frozen reference: track them
            chip = srv._chip_delta
            if chip is not None:
                for name in heal:
                    if name not in self._healed:
                        self._healed.append(name)
                    cur = chip[name]
                    if name in self._frozen_layers:
                        self._ref_delta[name] = cur.copy()
                    elif self.masked[name].any():
                        mask = self.masked[name]
                        self._ref_delta[name][mask] = cur[mask]
                self._expected = None
            # _post_heal_fails survives the re-heal: it counts failing
            # canaries since the first heal, so a fault that never comes
            # clean still reaches stuck_after
            self._ok_streak = 0
            self._transition(srv, "recovering")
            self._recovery = None

    # -- accounting ----------------------------------------------------------

    def stats(self) -> dict:
        return {
            "state": self.state,
            "canaries": self.canaries,
            "failed_canaries": self.failed_canaries,
            "detected_tick": self.detected_tick,
            "quarantined_tick": self.quarantined_tick,
            "recoveries": self.recoveries,
            "recovery_energy_uj": round(self.recovery_energy_uj, 4),
            "recovery_in_flight": self._recovery is not None,
            "implicated": self.implicated,
            "divergence": self.divergence,
            "masked_channels": {
                name: [int(c) for c in np.where(m)[0]]
                for name, m in self.masked.items() if m.any()},
            "accepted_layers": list(self.accepted_layers),
            "history": list(self.history),
        }

    # -- crash safety --------------------------------------------------------

    def snapshot(self) -> dict:
        """The monitor's state as plain data and numpy arrays (taken by
        ``StreamServer.snapshot``), the reference's fields: a recovery in
        flight keeps its ideal counts, its measurement keys (the JAX
        package's uint32 words) and its new biases.  The expected canary
        state is NOT serialized: it is a function of the server's
        configuration and the reserved uid, recomputed when the next
        canary needs it (on the card: two B = 1 forwards through the
        server's engine, 10 fused-layer calls outside every auditor
        region)."""
        r = self._recovery
        return {
            "state": self.state, "uid": self._uid,
            "canary_n": self._canary_n, "last_spawn": self._last_spawn,
            "fail_streak": self._fail_streak, "ok_streak": self._ok_streak,
            "post_heal_fails": self._post_heal_fails,
            "canaries": self.canaries,
            "failed_canaries": self.failed_canaries,
            "recoveries": self.recoveries,
            "recovery_energy_uj": self.recovery_energy_uj,
            "detected_tick": self.detected_tick,
            "quarantined_tick": self.quarantined_tick,
            "pending": dict(self._pending) if self._pending else None,
            "implicated": {k: list(v) for k, v in self.implicated.items()},
            "divergence": dict(self.divergence),
            "masked": {k: v.copy() for k, v in self.masked.items()},
            "ref_delta": {k: v.copy() for k, v in self._ref_delta.items()},
            "accepted_layers": list(self.accepted_layers),
            "healed": list(self._healed),
            "frozen_layers": list(self._frozen_layers),
            "history": [dict(h) for h in self.history],
            "recovery": ({
                "phase": r["phase"],
                "layers": list(r["layers"]),
                "idx": r["idx"],
                "ideal": (None if r["ideal"] is None else
                          {k: v.detach().cpu().numpy()
                           for k, v in r["ideal"].items()}),
                "keys": (None if r["keys"] is None else
                         {k: jaxrand.key_to_numpy(v)
                          for k, v in r["keys"].items()}),
                "bias": {k: v.detach().cpu().numpy()
                         for k, v in r["bias"].items()},
            } if r else None),
        }

    def restore(self, snap: dict) -> None:
        """Resume from a ``snapshot()`` (this package's or the JAX
        package's); a recovery in flight continues on the server's
        device."""
        dev = self.srv.device
        self.state = str(snap["state"])
        self._uid = int(snap["uid"])
        self._canary_n = int(snap["canary_n"])
        self._last_spawn = int(snap["last_spawn"])
        self._fail_streak = int(snap["fail_streak"])
        self._ok_streak = int(snap["ok_streak"])
        self._post_heal_fails = int(snap["post_heal_fails"])
        self.canaries = int(snap["canaries"])
        self.failed_canaries = int(snap["failed_canaries"])
        self.recoveries = int(snap["recoveries"])
        self.recovery_energy_uj = float(snap["recovery_energy_uj"])
        self.detected_tick = (None if snap["detected_tick"] is None
                              else int(snap["detected_tick"]))
        self.quarantined_tick = (None if snap["quarantined_tick"] is None
                                 else int(snap["quarantined_tick"]))
        self._pending = (dict(snap["pending"]) if snap["pending"]
                         else None)
        self.implicated = {k: [int(c) for c in v]
                           for k, v in snap["implicated"].items()}
        self.divergence = {k: float(v)
                           for k, v in snap["divergence"].items()}
        for name in self.masked:
            self.masked[name] = np.asarray(snap["masked"][name], bool).copy()
            self._ref_delta[name] = np.asarray(snap["ref_delta"][name],
                                               np.float32).copy()
        self.accepted_layers = [str(n) for n in snap["accepted_layers"]]
        self._healed = [str(n) for n in snap["healed"]]
        self._frozen_layers = [str(n) for n in snap["frozen_layers"]]
        self.history = [dict(h) for h in snap["history"]]
        r = snap["recovery"]
        self._recovery = (None if r is None else {
            "phase": str(r["phase"]), "layers": list(r["layers"]),
            "idx": int(r["idx"]),
            "ideal": (None if r["ideal"] is None else
                      {k: torch.tensor(np.asarray(v), device=dev)
                       for k, v in r["ideal"].items()}),
            "keys": (None if r["keys"] is None else
                     {k: jaxrand.key_from_numpy(v, dev)
                      for k, v in r["keys"].items()}),
            "bias": {k: torch.tensor(np.asarray(v), device=dev)
                     for k, v in r["bias"].items()},
        })
        self._expected = None
