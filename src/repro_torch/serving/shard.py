"""Device-sharded serving: per-device slot pools behind a host router.

Port of ``repro/serving/shard.py``.  The paper's accelerator is a whole
inference engine per chip (weights folded into the IMC arrays, decisions
local), so a multi-device deployment is N independent slot pools, one
full ``StreamServer`` per torch device with its own copy of the folded
model and its carries resident there, behind a thin host-side router.
Nothing per hop crosses a pool boundary:

* **placement**: a new stream is pinned to one pool for life by the
  deterministic policy of ``sharding.placement`` (most free slots, then
  the shortest queue, optionally duty-aware, a rotating tie-break);
  replay waves, canaries and customization sessions stay on the stream's
  pool because they ride that pool's batched calls;
* **per-pool invariants**: each router ``step()`` ticks every pool once,
  and each pool makes at most ONE fused call per IMC layer for all its
  ready slots (its ``LaunchAuditor`` carries the pool's ``device`` label,
  and counts its own thread's calls, so pools that tick on threads of
  their own, ``parallel=True``, never count each other's);
* **a gather only for telemetry**: ``stats()`` sums one small counter
  vector per pool, in float32, into the fleet rollup.

**Bit-identity with one server** (held by ``tests/test_torch_sharded.py``
against the port's single server and the JAX package's fleet): the router
gives every external stream a GLOBAL uid in submission order and pins it
with ``StreamServer.submit(uid=...)``.  A stream's SA-noise key is
``fold_in(PRNGKey(seed), uid)``, so with every pool sharing one ``seed``
its noise field, and so its whole decision sequence, chip offsets, fault
deltas and gating included, is the same on whichever pool it lands, and
the same as on one server fed the same streams.  Each pool builds its
own ``FaultModel`` from one shared ``FaultConfig`` and ticks it once per
router tick, so drift stays in lockstep with the single server.

**Sharded snapshots**: ``snapshot()`` bundles every pool's v2 snapshot
(its arrays prefixed ``d{i}_``) and the router's state (stream -> pool
map, the global uid counter, the steps, the placement cursor) into one
atomically written .npz; ``restore()`` on a freshly built, identically
configured fleet resumes bit for bit.

``devices`` is a count or a sequence of torch devices.  A count is
resolved against ``torch.cuda.device_count()`` at construction, wrapping
when fewer cards exist: on one card ``devices=2`` is two pools on
``cuda:0``, which is how the reference runs N logical pools on one
device.  Without a card a count raises; pass ``devices=["cpu", "cpu"]``.

**Compiled blocks**: with ``compiled=`` every pool serves compiled
ticks (``serving.compiled``); ``step_block()`` serves one block per pool
(each as long as its own boundaries allow, so pools leave tick lockstep
while each stream's events stay those of one server), and ``drain()``
steps in blocks.  A pool built without ``compiled=`` runs one
interpreted tick per ``step_block()``.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.kernels import resolve_device
from repro_torch.serving.scheduler import (StreamServer, read_snapshot,
                                           write_snapshot_file)
from repro_torch.sharding.placement import (PlacementConfig, PlacementPolicy,
                                            PoolLoad)

__all__ = ["ShardedStreamServer"]

# the fleet counter vector: one row per pool, summed in stats()
_GATHER_KEYS = ("decisions", "speech_hops", "gated_hops", "learn_hops",
                "rejected_streams", "queue_depth", "hop_wall_s")


def _pool_devices(devices) -> List[torch.device]:
    if isinstance(devices, int):
        if devices < 1:
            raise ValueError("devices must be >= 1")
        if not torch.cuda.is_available():
            raise RuntimeError(
                "devices=N counts CUDA devices and CUDA is not available: "
                "pass the pools' devices, e.g. devices=['cpu', 'cpu']")
        n = torch.cuda.device_count()
        return [torch.device("cuda", d % n) for d in range(devices)]
    return [resolve_device(d) for d in devices]


def _copy_to(tree, dev):
    """A copy of a (named) tuple / dict tree of tensors on ``dev``, owned
    by the pool (never a view of another pool's tensors)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _copy_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_copy_to(v, dev) for v in tree))
    return tree.to(dev, copy=True)


def _on(dev: torch.device):
    """The pool's device as the current CUDA device (the counterpart of
    ``jax.default_device``), or nothing for a CPU pool."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class ShardedStreamServer:
    """N per-device ``StreamServer`` pools behind a placement router."""

    def __init__(self, hw, cfg, *, hop: int,
                 devices: Union[int, Sequence] = 2,
                 slots: int = 4,
                 placement: Optional[PlacementConfig] = None,
                 parallel: bool = False,
                 faults=None,
                 seed: int = 0,
                 **server_kw):
        """``devices``: a count of pools (placed on the cards round
        robin) or their torch devices.  ``slots`` is PER POOL.
        ``faults`` must be a ``FaultConfig`` (each pool builds its own
        seeded ``FaultModel`` so injections replay identically on every
        pool); a shared ``FaultModel`` would tick once per pool.  The
        rest of ``server_kw`` goes to every pool as it is, less
        ``device``, which ``devices`` sets.

        ``parallel=True`` ticks the pools on one thread each; the default
        ticks them in turn, which keeps each pool's wall attribution
        clean."""
        if "device" in server_kw:
            raise ValueError("a sharded server places its pools through "
                             "devices=, not device=")
        self.devices = _pool_devices(devices)
        if faults is not None:
            from repro_torch.core import faults as flt
            if isinstance(faults, flt.FaultModel):
                raise ValueError(
                    "sharded serving needs a FaultConfig, not a "
                    "FaultModel: each pool builds its own seeded model "
                    "so injections replay identically on every device")
        self.n_devices = len(self.devices)
        self.cfg = cfg
        self.parallel = bool(parallel)
        self._pool_exec = (ThreadPoolExecutor(max_workers=self.n_devices)
                           if self.parallel else None)
        self.policy = PlacementPolicy(self.n_devices, placement)
        self.pools: List[StreamServer] = []
        for d, dev in enumerate(self.devices):
            with _on(dev):
                # per-pool residency: each pool computes against its own
                # copy of the folded model (the chip's in-SRAM weights)
                kw = dict(server_kw)
                kw["chip_offsets"] = _copy_to(kw.get("chip_offsets"), dev)
                self.pools.append(StreamServer(
                    _copy_to(hw, dev), cfg, hop=hop, slots=slots,
                    faults=faults, seed=seed, device_label=d, device=dev,
                    **kw))
        # the global uid counter starts past what every pool reserved at
        # construction (a health monitor reserves one canary uid, alike in
        # every pool and in the single server), then advances once per
        # accepted external stream in submission order
        self._next_uid = self.pools[0]._uid
        self._where: Dict[str, int] = {}
        self._steps = 0

    # -- routing ------------------------------------------------------------

    def _loads(self) -> List[PoolLoad]:
        out = []
        for srv in self.pools:
            total = srv._speech_hops + srv._gated_hops
            out.append(PoolLoad(
                free_slots=sum(r is None for r in srv._slots),
                queue_depth=len(srv._queue),
                duty=(srv._speech_hops / total) if total else None))
        return out

    def _route(self, stream_id: str) -> int:
        """The pool owning ``stream_id``, placing it if new (-1 when the
        chosen pool rejects it).  A new stream is created empty on its
        pool with the next GLOBAL uid, so its SA-noise field matches the
        single server's."""
        d = self._where.get(stream_id)
        if d is not None:
            return d
        d = self.policy.place(self._loads())
        with _on(self.devices[d]):
            res = self.pools[d].submit(stream_id,
                                       np.zeros((0,), np.float32),
                                       uid=self._next_uid)
        if res == "rejected":
            return -1
        self._where[stream_id] = d
        self._next_uid += 1
        return d

    def where(self, stream_id: str) -> Optional[int]:
        """The pool a stream was placed on (None if never admitted)."""
        return self._where.get(stream_id)

    # -- stream lifecycle (delegated to the owning pool) --------------------

    def submit(self, stream_id: str, chunk, user_id: Optional[str] = None):
        """Route and append audio.  Returns the pool's verdict ('slot' /
        'queued'), or 'rejected' when the chosen pool's admission queue
        is full (nothing is buffered and no uid is consumed, as on one
        server)."""
        d = self._route(stream_id)
        if d < 0:
            return "rejected"
        with _on(self.devices[d]):
            return self.pools[d].submit(stream_id, chunk, user_id=user_id)

    def finish(self, stream_id: str) -> None:
        self.pools[self._where[stream_id]].finish(stream_id)

    def evict(self, stream_id: str) -> None:
        d = self._where[stream_id]
        with _on(self.devices[d]):
            self.pools[d].evict(stream_id)

    def customize(self, stream_id: str, ccfg=None):
        """Open an enrollment session on the stream's pool (placing the
        stream first if it does not exist yet); its replay waves and
        background jobs stay on that pool."""
        d = self._route(stream_id)
        if d < 0:
            raise RuntimeError(f"cannot place stream {stream_id!r}: "
                               f"chosen pool's admission queue is full")
        with _on(self.devices[d]):
            return self.pools[d].customize(stream_id, ccfg)

    def install_custom(self, stream_id: str, result) -> None:
        d = self._route(stream_id)
        if d < 0:
            raise RuntimeError(f"cannot place stream {stream_id!r}: "
                               f"chosen pool's admission queue is full")
        with _on(self.devices[d]):
            self.pools[d].install_custom(stream_id, result)

    # -- faults -------------------------------------------------------------

    @property
    def fault_models(self):
        """The pools' FaultModels (empty when faults are off).  A
        chip-global fault campaign injects into EVERY model: same seed,
        same draws, so all pools (and the single server) change alike."""
        return [srv.faults for srv in self.pools
                if srv.faults is not None]

    # -- ticking ------------------------------------------------------------

    def _run_pool(self, d: int, fn) -> List[dict]:
        with _on(self.devices[d]):
            events = fn(self.pools[d])
        for ev in events:
            ev["device"] = d
        return events

    def _each_pool(self, fn) -> List[dict]:
        """``fn(pool)`` for every pool on its device, in turn or one
        thread per pool; the events in pool order, tagged with their
        pool."""
        if self._pool_exec is not None:
            futs = [self._pool_exec.submit(self._run_pool, d, fn)
                    for d in range(self.n_devices)]
            return [ev for f in futs for ev in f.result()]
        return [ev for d in range(self.n_devices)
                for ev in self._run_pool(d, fn)]

    def step(self) -> List[dict]:
        """One fleet tick: every pool steps exactly once (in turn, or one
        thread per pool with ``parallel=True``).  Events come in pool
        order, each tagged with its ``device``."""
        events = self._each_pool(StreamServer.step)
        self._steps += 1
        return events

    def step_block(self, max_ticks: Optional[int] = None) -> List[dict]:
        """Up to ``max_ticks`` steady-state ticks per pool, one compiled
        block each (``StreamServer.step_block``).  Each pool's block is as
        long as its own boundaries allow, so pools leave tick lockstep;
        streams never interact across pools, so each stream's events are
        still one server's.  Events come in pool order, tagged with their
        ``device``.  A pool without ``compiled=`` runs one interpreted
        tick."""
        events = self._each_pool(lambda srv: srv.step_block(max_ticks))
        self._steps += 1
        return events

    def drain(self, max_steps: int = 10_000) -> List[dict]:
        """Step the fleet until a step moves no pool's buffers (in
        compiled blocks when the pools were built with ``compiled=``, each
        pool judged by its block's last tick, as ``StreamServer.drain``
        does)."""
        events: List[dict] = []
        for _ in range(max_steps):
            before = [srv._drain_view() for srv in self.pools]
            events.extend(self._each_pool(StreamServer._drain_step))
            self._steps += 1
            if all(srv._drain_view() == srv._tick_start_view(b)
                   for srv, b in zip(self.pools, before)):
                break
        return events

    def active_streams(self) -> List[str]:
        return [sid for srv in self.pools for sid in srv.active_streams()]

    def close(self) -> None:
        """Stop the pool threads of a ``parallel=True`` fleet."""
        if self._pool_exec is not None:
            self._pool_exec.shutdown(wait=True)
            self._pool_exec = None

    # -- fleet telemetry ----------------------------------------------------

    def stats(self) -> dict:
        """The fleet rollup and each pool's ``stats()``.  The rollup sums
        one small float32 counter vector per pool, as the reference
        gathers them."""
        per_device = [srv.stats() for srv in self.pools]
        vecs = np.stack([np.asarray([float(s[k]) if s[k] is not None
                                     else 0.0 for k in _GATHER_KEYS],
                                    np.float32) for s in per_device])
        tot = dict(zip(_GATHER_KEYS, vecs.sum(axis=0).tolist()))
        total_hops = tot["speech_hops"] + tot["gated_hops"]
        fleet = {
            "decisions": int(tot["decisions"]),
            "speech_hops": int(tot["speech_hops"]),
            "gated_hops": int(tot["gated_hops"]),
            "learn_hops": int(tot["learn_hops"]),
            "rejected_streams": int(tot["rejected_streams"]),
            "queue_depth": int(tot["queue_depth"]),
            "duty_cycle": (round(tot["speech_hops"] / total_hops, 4)
                           if total_hops else None),
            "hop_wall_s": round(tot["hop_wall_s"], 4),
            "decisions_per_sec": (round(tot["decisions"]
                                        / tot["hop_wall_s"], 2)
                                  if tot["hop_wall_s"] > 0 else None),
        }
        out = {
            "devices": self.n_devices,
            "steps": self._steps,
            "streams_placed": len(self._where),
            "placement": self.policy.snapshot(),
            "fleet": fleet,
            "per_device": per_device,
        }
        if any(srv.health is not None for srv in self.pools):
            states = [srv.health.state if srv.health is not None else None
                      for srv in self.pools]
            out["health"] = {"states": states,
                             "healthy": all(s in (None, "healthy")
                                            for s in states)}
        audits = [s.get("obs", {}).get("audit") for s in per_device]
        if any(a is not None for a in audits):
            out["audit"] = {
                "violations": sum(a["violations"] for a in audits
                                  if a is not None),
                "per_device": audits,
            }
        return out

    # -- the sharded snapshot bundle ----------------------------------------

    def snapshot(self, path: Optional[str] = None):
        """Bundle every pool's snapshot and the router's state.  In
        memory: ``{"spec": ..., "arrays": ...}`` with the pools' arrays
        prefixed ``d{i}_``.  With ``path``: one .npz, written atomically.
        Take it between fleet ``step()`` calls."""
        arrays: Dict[str, np.ndarray] = {}
        pool_specs = []
        for d, srv in enumerate(self.pools):
            snap = srv.snapshot()
            pool_specs.append(snap["spec"])
            for k, v in snap["arrays"].items():
                arrays[f"d{d}_{k}"] = v
        spec = {
            "version": 1,
            "kind": "sharded",
            "devices": self.n_devices,
            "router": {"next_uid": self._next_uid,
                       "where": dict(self._where),
                       "steps": self._steps,
                       "policy": self.policy.snapshot()},
            "pools": pool_specs,
        }
        if path is None:
            return {"spec": spec, "arrays": arrays}
        return write_snapshot_file(path, spec, arrays,
                                   prefix=".tmp.shardsnap.")

    def restore(self, snap) -> None:
        """Restore a sharded bundle (a path or in memory) into THIS
        freshly built, identically configured fleet: the same pool count,
        per-pool configuration and wiring (the pools' devices may
        differ).  Resumes bit for bit, the router's placement state
        included."""
        spec, arrays = read_snapshot(snap)
        if spec.get("kind") != "sharded" or spec.get("version") != 1:
            raise ValueError(f"not a v1 sharded snapshot bundle: "
                             f"kind={spec.get('kind')!r} "
                             f"version={spec.get('version')!r}")
        if spec["devices"] != self.n_devices:
            raise ValueError(f"snapshot has {spec['devices']} device "
                             f"pools, this server has {self.n_devices}")
        for d, (srv, pool_spec) in enumerate(zip(self.pools,
                                                 spec["pools"])):
            prefix = f"d{d}_"
            pool_arrays = {k[len(prefix):]: v for k, v in arrays.items()
                           if k.startswith(prefix)}
            with _on(self.devices[d]):
                srv.restore({"spec": pool_spec, "arrays": pool_arrays})
        router = spec["router"]
        self._next_uid = int(router["next_uid"])
        self._where = {sid: int(d) for sid, d in router["where"].items()}
        self._steps = int(router["steps"])
        self.policy.restore(router["policy"])
