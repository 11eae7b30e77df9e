"""Stream placement policy for the device-sharded serving tier.

Port of ``repro/sharding/placement.py`` (pure Python, no tensors).  Every
pool runs a complete ``StreamServer`` over its own copy of the folded
model, so the only decision that spans pools is WHERE a new stream lands.
This module makes it: a small, deterministic, host-side policy that the
router (``serving.shard.ShardedStreamServer``) consults once per new
stream.

Determinism is load-bearing (the sharded and single-server runs are held
equal stream by stream): given identical load views the policy always
picks the same pool, and every tie is broken by a rotating cursor, never
by dict order or hashing.

Strategies:

* ``least_loaded`` (default): most free slots first, then the shortest
  admission queue, then (with ``duty_aware``) the lowest recent speech
  duty, so an all-silent pool takes new talkers before a busy one, then
  the rotating cursor;
* ``round_robin``: ignore the load and rotate.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

__all__ = ["PlacementConfig", "PlacementPolicy", "PoolLoad", "STRATEGIES"]

STRATEGIES = ("least_loaded", "round_robin")


@dataclasses.dataclass(frozen=True)
class PoolLoad:
    """One pool's load as the router samples it at placement time.
    ``duty`` is the pool's speech duty cycle in [0, 1] (None before the
    pool has computed a hop)."""
    free_slots: int
    queue_depth: int
    duty: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class PlacementConfig:
    strategy: str = "least_loaded"
    # break ties between equally free pools on their speech duty (the
    # quietest wins): with VAD gating, slot counts are a poor proxy for
    # the compute a pool runs
    duty_aware: bool = False

    def __post_init__(self):
        if self.strategy not in STRATEGIES:
            raise ValueError(f"placement strategy must be one of "
                             f"{STRATEGIES}, got {self.strategy!r}")


class PlacementPolicy:
    """Deterministic stream -> pool chooser over ``n_devices`` pools."""

    def __init__(self, n_devices: int,
                 cfg: Optional[PlacementConfig] = None):
        if n_devices < 1:
            raise ValueError("n_devices must be >= 1")
        self.n_devices = int(n_devices)
        self.cfg = cfg if cfg is not None else PlacementConfig()
        self._rr = 0          # the rotating tie-break cursor

    def place(self, loads: Sequence[PoolLoad]) -> int:
        """The pool index for one new stream.  ``loads`` holds one entry
        per pool, in pool order."""
        if len(loads) != self.n_devices:
            raise ValueError(f"expected {self.n_devices} load entries, "
                             f"got {len(loads)}")
        if self.cfg.strategy == "round_robin":
            d = self._rr % self.n_devices
            self._rr += 1
            return d

        def key(d: int):
            ld = loads[d]
            duty = (ld.duty if (self.cfg.duty_aware
                                and ld.duty is not None) else 0.0)
            # most free slots, then the shortest queue, then the quietest
            # pool, then the nearest at or after the cursor
            return (-ld.free_slots, ld.queue_depth, duty,
                    (d - self._rr) % self.n_devices)

        d = min(range(self.n_devices), key=key)
        self._rr = (d + 1) % self.n_devices
        return d

    # -- snapshots (they ride the sharded server's bundle) -------------------

    def snapshot(self) -> dict:
        return {"strategy": self.cfg.strategy,
                "duty_aware": self.cfg.duty_aware, "rr": self._rr}

    def restore(self, snap: dict) -> None:
        if snap["strategy"] != self.cfg.strategy:
            raise ValueError(f"placement strategy mismatch: snapshot has "
                             f"{snap['strategy']!r}, policy is "
                             f"{self.cfg.strategy!r}")
        self._rr = int(snap["rr"])
