"""Seeded silicon fault models for the IMC arrays (deployment-time
non-idealities: the hardware-model layer of the self-healing server).

Own copy of ``repro/core/faults.py``, with ``core.jaxrand`` in place of
``jax.random`` so one seed gives both packages the same faults.  Every
fault reduces to a per-(layer, channel) **pre-sign count delta**, the
operand row the per-stream bias-delta riders already use
(``serving.stream._merge_bias_delta``), so a faulted serving tick launches
the fused kernel exactly as often as a healthy one:

* **offset drift**: a slow per-channel random walk on top of the static
  chip offsets; step ``t``'s increment is ``drift_std * normal`` under the
  key ``fold_in(fold_in(fold_in(PRNGKey(seed), 0xD81F), layer), t)``, a
  pure function of the seed, the layer and the step, so a restored model
  resumes the walk bit for bit;
* **stuck columns / word lines** add ±``stuck_magnitude`` pre-sign (a
  rail that pins the channel's sign); a **macro dropout** is a contiguous
  stuck range;
* **SRAM bit flips** in the per-channel trim words: flipping bit ``b``
  shifts the channel's counts by ±``flip_magnitude * 2**b``.

Drift and flips are plain count offsets, so the test-mode recompensation
(``training.kws.compensate_layer_bias``) recovers them up to the
estimator's noise and the bias clip; stuck rails saturate the clip, and
the health monitor (``serving.health``) masks those columns instead.

The model lives on the host: numpy state, draws on CPU keys.  ``cfg``
arguments are duck-typed (``imc_layer_names``, ``channels``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core import jaxrand


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Knobs of one chip's fault process.

    ``drift_std``: per-tick standard deviation (in counts) of the
    per-channel offset random walk (0 disables drift); ``stuck_magnitude``
    is the pre-sign rail a stuck column reads; ``flip_magnitude`` scales
    one flipped trim bit (bit ``b`` shifts the channel by
    ``±flip_magnitude * 2**b``); ``flip_bits`` bounds the bit position a
    random flip may hit."""

    drift_std: float = 0.0
    stuck_magnitude: float = 1e4
    flip_magnitude: int = 2
    flip_bits: int = 4
    seed: int = 0

    def __post_init__(self):
        if self.drift_std < 0.0:
            raise ValueError("drift_std must be >= 0")
        if self.stuck_magnitude <= 0.0:
            raise ValueError("stuck_magnitude must be > 0")
        if self.flip_magnitude < 1 or self.flip_bits < 1:
            raise ValueError("flip_magnitude and flip_bits must be >= 1")


def _randint(key, maxval: int) -> int:
    return int(jaxrand.randint(key, (), 0, maxval))


class FaultModel:
    """Deterministic fault state of one chip's IMC layers.

    Mutation is config-driven (``tick`` advances the drift walk) or
    explicit (``inject_*``); every random choice derives from
    ``FaultConfig.seed`` and a counter, so two models with the same config
    and call sequence are bit-identical, and ``snapshot()`` / ``restore()``
    resumes the process exactly."""

    def __init__(self, channels: Dict[str, int], fcfg: FaultConfig):
        self.fcfg = fcfg
        self.channels = dict(channels)
        self._names = sorted(channels, key=lambda n: int(n[4:]))
        self._key = jaxrand.PRNGKey(fcfg.seed, device="cpu")
        self._drift = {n: np.zeros((c,), np.float32)
                       for n, c in channels.items()}
        self._flips = {n: np.zeros((c,), np.float32)
                       for n, c in channels.items()}
        self._stuck = {n: np.zeros((c,), np.int8)
                       for n, c in channels.items()}
        self._step = 0
        self._injections = 0
        self._dirty = False
        self.events: List[dict] = []

    @classmethod
    def for_config(cls, cfg, fcfg: FaultConfig) -> "FaultModel":
        """Build from a KWSConfig-like object (IMC layers conv1..convN)."""
        channels = {name: cfg.channels[int(name[4:])]
                    for name in cfg.imc_layer_names()}
        return cls(channels, fcfg)

    # -- process ------------------------------------------------------------

    @property
    def active(self) -> bool:
        """Whether any fault currently perturbs the chip."""
        return (any(v.any() for v in self._stuck.values())
                or any(v.any() for v in self._flips.values())
                or any(v.any() for v in self._drift.values()))

    def pop_dirty(self) -> bool:
        """True once after any state change (the scheduler's cue to
        refresh its rider operands)."""
        d = self._dirty
        self._dirty = False
        return d

    def tick(self) -> None:
        """Advance the drift walk one serving tick: step ``t`` adds
        ``drift_std * normal(fold(seed, layer, t))`` per layer."""
        t = self._step
        self._step += 1
        if self.fcfg.drift_std <= 0.0:
            return
        base = jaxrand.fold_in(self._key, 0xD81F)
        std = np.float32(self.fcfg.drift_std)
        for name in self._names:
            k = jaxrand.fold_in(jaxrand.fold_in(base, int(name[4:])), t)
            inc = std * jaxrand.normal(k, (self.channels[name],)).numpy()
            self._drift[name] = self._drift[name] + inc
        self._dirty = True

    # -- explicit injections ------------------------------------------------

    def _log(self, kind: str, **info) -> None:
        self.events.append({"kind": kind, "step": self._step, **info})
        self._dirty = True

    def inject_stuck(self, layer: str, channels, value: int = -1) -> None:
        """Pin columns of ``layer`` to ``value`` (+1/-1): a stuck word line
        or output column, beyond what bias compensation can cancel."""
        if value not in (-1, 1):
            raise ValueError("stuck value must be +1 or -1")
        ch = np.atleast_1d(np.asarray(channels, np.int64))
        self._stuck[layer][ch] = np.int8(value)
        self._log("stuck", layer=layer, channels=[int(c) for c in ch],
                  value=int(value))

    def inject_macro_dropout(self, layer: str, start: int = 0,
                             width: Optional[int] = None) -> None:
        """Drop a whole macro: a contiguous channel range of ``layer``
        reads stuck low."""
        c = self.channels[layer]
        width = c - start if width is None else width
        self.inject_stuck(layer, np.arange(start, min(start + width, c)),
                          value=-1)
        self.events[-1]["kind"] = "macro_dropout"

    def inject_bit_flips(self, n: int = 1,
                         layer: Optional[str] = None) -> None:
        """Flip ``n`` random SRAM trim bits (deterministic in the seed and
        the injection counter): each shifts one channel's counts by
        ``±flip_magnitude * 2**bit``.  ``layer=None`` spreads the flips
        over all IMC layers."""
        key = jaxrand.fold_in(jaxrand.fold_in(self._key, 0xF11),
                              self._injections)
        self._injections += 1
        flips = []
        for j in range(n):
            kl, kc, kb, ks = jaxrand.split(jaxrand.fold_in(key, j), 4)
            name = (layer if layer is not None else
                    self._names[_randint(kl, len(self._names))])
            ch = _randint(kc, self.channels[name])
            bit = _randint(kb, self.fcfg.flip_bits)
            sign = _randint(ks, 2) * 2 - 1
            delta = float(sign * self.fcfg.flip_magnitude * (1 << bit))
            self._flips[name][ch] += np.float32(delta)
            flips.append({"layer": name, "channel": ch, "bit": bit,
                          "delta": delta})
        self._log("bit_flips", flips=flips)

    def clear(self) -> None:
        """Repair everything (a chip swap, a test harness reset)."""
        for name in self._names:
            self._drift[name][:] = 0.0
            self._flips[name][:] = 0.0
            self._stuck[name][:] = 0
        self._log("clear")

    # -- the rider view -----------------------------------------------------

    def deltas(self) -> Dict[str, np.ndarray]:
        """The per-(layer, channel) pre-sign count delta that rides every
        slot's bias-delta row: drift + trim flips + the stuck rails, summed
        in that order in float32."""
        out = {}
        for name in self._names:
            out[name] = (self._drift[name] + self._flips[name]
                         + self._stuck[name].astype(np.float32)
                         * np.float32(self.fcfg.stuck_magnitude))
        return out

    def stuck_mask(self) -> Dict[str, np.ndarray]:
        """{layer: (C,) bool}: columns pinned by stuck / dropout faults."""
        return {name: self._stuck[name] != 0 for name in self._names}

    def stats(self) -> dict:
        stuck = {n: int((self._stuck[n] != 0).sum()) for n in self._names}
        return {
            "active": self.active,
            "step": self._step,
            "drift_std": self.fcfg.drift_std,
            "drift_rms": {
                n: round(float(np.sqrt(np.mean(self._drift[n] ** 2))), 4)
                for n in self._names if self._drift[n].any()},
            "stuck_channels": {n: c for n, c in stuck.items() if c},
            "flipped_channels": {
                n: int((self._flips[n] != 0).sum())
                for n in self._names if self._flips[n].any()},
            "injections": len(self.events),
        }

    # -- plain-array state ----------------------------------------------------

    def snapshot(self) -> dict:
        """The model's state as plain arrays and numbers."""
        return {
            "step": self._step,
            "injections": self._injections,
            "drift": {n: self._drift[n].copy() for n in self._names},
            "flips": {n: self._flips[n].copy() for n in self._names},
            "stuck": {n: self._stuck[n].copy() for n in self._names},
            "events": [dict(e) for e in self.events],
        }

    def restore(self, snap: dict) -> None:
        """Resume from a ``snapshot()`` (this package's or the JAX
        package's): the drift walk, the counters and the injected faults
        continue bit for bit."""
        self._step = int(snap["step"])
        self._injections = int(snap["injections"])
        for n in self._names:
            self._drift[n] = np.asarray(snap["drift"][n], np.float32).copy()
            self._flips[n] = np.asarray(snap["flips"][n], np.float32).copy()
            self._stuck[n] = np.asarray(snap["stuck"][n], np.int8).copy()
        self.events = [dict(e) for e in snap["events"]]
        self._dirty = True
