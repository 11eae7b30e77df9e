"""Compiled ticks: K steady scheduler ticks served as one block.

Port of ``repro/serving/compiled.py``.  The interpreted tick
(``StreamServer.step``) is host-bound: each tick issues hundreds of small
operations around the five fused-layer launches (the noise field, the
masks, the decision head, the gated fill) and several host round trips.
A compiled block serves the *steady-state* part of K ticks at once: the
VAD over the K ticks, then, per step of the hop timeline below, one
masked batched hop with the decision head, and one masked gated fill.

**What stays interpreted** (``horizon()`` returns 0 and the tick runs on
``StreamServer``'s interpreted path): the recompute server, a trace, the
health monitor, a profile store, customization sessions, a non-empty
admission queue, an internal or ``force_compute`` stream, a due admission
wave and a due shed.  The horizon clips the block before a slot
scale-down and, with the dynamic hop, keeps a retarget at the block's
last tick (one-tick blocks while the hop is widened).

**The hop timeline.**  A wake replay defers a variable number of hops, so
the block runs over a per-slot hop index j (the slot's j-th hop since the
block start: the deferred hops entering it first, then the fresh ones).
The VAD flags come back to the host first, and a host fate simulation,
the one source of truth for events, counters and bookkeeping, classifies
each hop as the interpreted tick would: computed (a regular hop, or part
of a wake replay), filled (a silent hop aged out of the wake margin) or
still deferred.  A wake replay of n hops runs as n single-hop steps
(``stream_multi_step`` equals sequential ``stream_step`` calls, bit for
bit), per-slot hop order is kept, and every batched operation is
row-independent, so the block equals K interpreted ticks bit for bit:
events, carries, decision and VAD state, noise fields, chip offsets,
fault riders (a drift that changes the chip delta mid-block is staged
per step, by each hop's compute tick) and every counter but the wall
time, the ``serving.compiled`` block and tick counts, and
``serving.imc_passes``: a block counts one IMC forward per step that
computes, where the interpreted tick counts one per replay call and one
per batched hop.

**The device half.**  A step that computes runs ``stream_step`` over all
slots with the riders, ``_select_state`` and ``decision_step`` and writes
(trigger, keyword, score) into row j of the block's output; a step that
fills runs ``gated_step`` and ``_select_state``.  The host knows both
masks before anything launches, so it runs the compute body only at the
steps where a slot computes and the fill body only where one fills: K1
launches 5 times per step that computes, the count of the reference's
``lax.cond``.  The block's operands (audio, masks, per-step chip deltas)
go to the device in one host-to-device copy and its outputs come back in
one device-to-host copy.

On the CPU (``device="cpu"``) the bodies run eagerly, step by step.  On a
card each body is a ``torch.cuda.CUDAGraph``, captured once per key
``(slots, hop multiplier, riders on, per-step chip delta, gated)`` and
replayed once per step: a graph reads and writes fixed addresses, so the
bodies read the step's operands from block-sized static buffers through a
device-side step index, the server's state and riders are copied into
static buffers at the start of each block and the state out at its end
(the server replaces those tensors between blocks), and the cache is
dropped when the slot count changes or the engine of the multiplier is
another.  A body's first use runs the step eagerly on a side stream (the
warm-up PyTorch's graph rules ask for: K1's library, its shared-memory
attribute, cuBLAS's handle) before the capture, with host syncs raising
when it runs on the main thread; the capture is ``thread_local``, so the
pools of a ``parallel=True`` fleet capture on their own threads, each
graph in its own memory pool.  A failed capture or replay raises: a
block on a card runs as replays or not at all.

Launch accounting: a launch recorded into a graph counts in neither
``ops.COUNTS`` nor ``ops.CALLS``; each replay of the compute graph adds
its K1 launches to ``COUNTS``, so K1 = 5 x ``imc_passes`` holds.  The
launch auditor sees one ``compiled`` region per block, declared with one
pass per step that computes: on the CPU every such step calls the fused
layer; on a card the block that captures counts the eager first step's
calls (its fresh trace), and a block of replays counts none (a JAX cache
hit).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.imc_mav import ops
from repro_torch.serving import decision as dec
from repro_torch.serving import stream as sv
from repro_torch.serving import vad as vd
from repro_torch.serving.scheduler import _select_state, _tree_map

__all__ = ["CompiledTickConfig", "CompiledTick"]

# one capture at a time in the process: the pools of a parallel fleet
# capture on threads of their own
_CAPTURE_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class CompiledTickConfig:
    """``block``: the most ticks one block serves (``step_block`` clamps
    any ``max_ticks`` to it; ``step()`` serves one-tick blocks).  It also
    sizes the static buffers of the card's graphs."""

    block: int = 8

    def __post_init__(self):
        if self.block < 1:
            raise ValueError("block must be >= 1")


@contextlib.contextmanager
def _syncs_raise(device: torch.device):
    """Host syncs raise inside (``torch.cuda.set_sync_debug_mode``), on a
    card and on the main thread only: the mode is process-wide, and a
    parallel fleet's other pools sync on theirs.  A sync inside a capture
    raises on any thread."""
    if (device.type != "cuda"
            or threading.current_thread() is not threading.main_thread()):
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _copy_into(dst, src) -> None:
    """Copy a (named) tuple or dict tree of tensors into ``dst``'s."""
    if isinstance(dst, dict):
        for k, d in dst.items():
            d.copy_(src[k])
        return
    _tree_map(lambda d, s: d.copy_(s), dst, src)


class _Steps:
    """The device half of a block for one key: static copies of what the
    steps read, the compute and fill bodies, and on a card one CUDA graph
    per body.

    ``stage`` holds one record per timeline step (its audio, compute
    mask, fill mask and, with a per-step chip delta, each layer's delta
    rows), filled on the host (``host``) and copied in one piece; ``out``
    holds (trigger, keyword, score) per step and slot; ``jidx`` is the
    step the bodies read and write."""

    def __init__(self, srv, key, steps: int):
        slots, mult, cust, per_tick_chip, gated = key
        self.engine = srv._engine_for(mult)
        self.cfg, self.dcfg = srv.cfg, srv.dcfg
        self.cust, self.per_tick_chip, self.gated = cust, per_tick_chip, gated
        dev = self.device = srv.device
        n, hop = slots, self.engine.geom.hop
        names = srv.cfg.imc_layer_names()
        widths = [n * hop, n, n] + (
            [n * srv.cfg.channels[int(nm[4:])] for nm in names]
            if per_tick_chip else [])
        rec = sum(widths)
        self.stage = torch.zeros((steps, rec), device=dev)
        self.host = (torch.zeros((steps, rec), pin_memory=True)
                     if dev.type == "cuda" else self.stage)
        cols, off = [], 0
        for w in widths:
            cols.append((off, off + w))
            off += w
        view = lambda t, c, shape: t[:, c[0]:c[1]].view((steps,) + shape)
        self.audio = view(self.stage, cols[0], (n, hop))
        self.cm = view(self.stage, cols[1], (n,))
        self.fm = view(self.stage, cols[2], (n,))
        hnp = self.host.numpy()
        self.h_audio = hnp[:, cols[0][0]:cols[0][1]].reshape(steps, n, hop)
        self.h_cm = hnp[:, cols[1][0]:cols[1][1]]
        self.h_fm = hnp[:, cols[2][0]:cols[2][1]]
        self.chip, self.h_chip = {}, {}
        if per_tick_chip:
            for nm, c in zip(names, cols[3:]):
                width = srv.cfg.channels[int(nm[4:])]
                self.chip[nm] = view(self.stage, c, (n, width))
                self.h_chip[nm] = hnp[:, c[0]:c[1]].reshape(steps, n, width)
        clone = lambda t: t.detach().clone()
        self.state = _tree_map(clone, srv._state)
        self.dstate = _tree_map(clone, srv._dstate)
        self.delta = self.head_w = self.head_b = self.fills = None
        if cust:
            self.delta = {k: clone(v) for k, v in srv._slot_delta.items()}
            self.head_w = clone(srv._slot_head_w)
            self.head_b = clone(srv._slot_head_b)
        if gated:
            self.fills = tuple(clone(f) for f in self._server_fills(srv))
        self.out = torch.zeros((steps, 3, n), device=dev)
        self.jidx = torch.zeros((1,), dtype=torch.int64, device=dev)
        # K1 launches per replay of the compute graph
        self.k1 = (srv.cfg.num_conv_layers - 1
                   if self.engine.use_kernel and dev.type == "cuda" else 0)
        self.graphs: Dict[str, torch.cuda.CUDAGraph] = {}
        self.capture_s: Dict[str, float] = {}   # eager first step + capture
        self.stream = (torch.cuda.Stream(dev) if dev.type == "cuda"
                       else None)

    def _server_fills(self, srv):
        return (srv._slot_fills if self.cust and srv._slot_fills is not None
                else srv._fills)

    # -- the block's operands --------------------------------------------

    def load(self, srv, rows: int) -> None:
        """Copy the staged rows, the server's state and its riders in."""
        if self.device.type == "cuda":
            self.stage[:rows].copy_(self.host[:rows], non_blocking=True)
        _copy_into(self.state, srv._state)
        _copy_into(self.dstate, srv._dstate)
        if self.cust:
            if self.per_tick_chip:
                # the chip delta rides the staged rows, step by step
                delta = srv._slot_delta
                head_w, head_b = srv._slot_head_w, srv._slot_head_b
            else:
                delta, head_w, head_b = srv._riders()
            _copy_into(self.delta, delta)
            self.head_w.copy_(head_w)
            self.head_b.copy_(head_b)
        if self.gated:
            _copy_into(self.fills, tuple(self._server_fills(srv)))

    def unload(self, srv, rows: int) -> np.ndarray:
        """Hand the state back to the server (tensors of its own) and
        bring the outputs of ``rows`` steps to the host: (rows, 3, n)."""
        srv._state = _tree_map(lambda t: t.clone(), self.state)
        srv._dstate = _tree_map(lambda t: t.clone(), self.dstate)
        return self.out[:rows].cpu().numpy().copy()

    # -- the step bodies --------------------------------------------------

    def _row(self, t: torch.Tensor) -> torch.Tensor:
        return t.index_select(0, self.jidx)[0]

    def _compute(self) -> None:
        cm = self._row(self.cm) != 0
        audio = self._row(self.audio)
        if self.cust:
            delta = self.delta
            if self.per_tick_chip:
                delta = {k: v + self._row(self.chip[k])
                         for k, v in delta.items()}
            logits, new = self.engine.step(self.state, audio, delta,
                                           self.head_w, self.head_b)
        else:
            logits, new = self.engine.step(self.state, audio)
        state = _select_state(cm, new, self.state)
        dstate, out = dec.decision_step(self.dcfg, self.dstate, logits, cm)
        _copy_into(self.state, state)
        _copy_into(self.dstate, dstate)
        self.out.index_copy_(0, self.jidx, torch.stack(
            [out.trigger.float(), out.keyword.float(), out.score])[None])

    def _fill(self) -> None:
        fm = self._row(self.fm) != 0
        new = sv.gated_step(self.state, self.cfg, self.engine.geom,
                            self.fills)
        _copy_into(self.state, _select_state(fm, new, self.state))

    def step(self, kind: str, j: int) -> None:
        """Run timeline step ``j``'s ``compute`` or ``fill`` body: eagerly
        on the CPU; on a card as a replay of its graph, captured at the
        body's first use after that step has run eagerly."""
        body = self._compute if kind == "compute" else self._fill
        if self.stream is None:
            self.jidx.fill_(j)
            body()
            return
        graph = self.graphs.get(kind)
        if graph is not None:
            self.jidx.fill_(j)
            graph.replay()
            if kind == "compute":
                ops.COUNTS.add(self.k1)
            return
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            self.jidx.fill_(j)
            with _syncs_raise(self.device):
                body()                       # the step itself, eagerly
        cur.wait_stream(self.stream)
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK, torch.cuda.graph(
                graph, stream=self.stream, capture_error_mode="thread_local"):
            body()
        self.graphs[kind] = graph
        self.capture_s[kind] = time.perf_counter() - t0


class CompiledTick:
    """The compiled-block engine of one ``StreamServer``: the horizon, the
    host fate simulation and bookkeeping of ``run``, and the device half
    (``_Steps``) per key.  It holds no serving state of its own, so
    snapshots and restores know nothing of it."""

    def __init__(self, srv, ccfg: CompiledTickConfig):
        self._srv = srv
        self.cfg = ccfg
        self._steps: Dict[tuple, _Steps] = {}
        self._slots_seen: Optional[int] = None
        # the queue depth and buffer lengths at the start of the last
        # block's last tick: drain()'s view before that tick
        self.last_view: Optional[tuple] = None

    # -- eligibility --------------------------------------------------------

    def horizon(self, max_ticks: int) -> int:
        """How many ticks one block may serve now (0: this tick runs
        interpreted).  Any condition the block does not model exactly
        gives 0; one interpreted tick usually clears it."""
        srv = self._srv
        if max_ticks < 1 or not srv.streaming:
            return 0
        if srv.trace is not None:
            return 0
        if (srv._health is not None or srv._profiles is not None
                or srv._cust is not None):
            return 0
        if srv._queue:
            return 0
        hop = srv.geom.hop
        window = srv.geom.window
        avail = 0
        any_live = False
        for rec in srv._slots:
            if rec is None:
                continue
            any_live = True
            if rec.internal or rec.force_compute:
                return 0
            if rec.initialized:
                avail = max(avail, len(rec.buf) // hop)
            elif len(rec.buf) >= window:
                return 0                     # admission wave due
        if not any_live or avail == 0:
            return 0
        k = min(max_ticks, avail)
        if srv.acfg is not None and srv.acfg.max_lag_s is not None:
            max_lag = int(srv.acfg.max_lag_s * srv.cfg.sample_rate)
            for rec in srv._streams.values():
                if rec.finished or rec.internal or rec.force_compute:
                    continue
                if sum(map(len, rec.pending)) + len(rec.buf) > max_lag:
                    return 0                 # shed due
        if srv.acfg is not None and srv.max_slots > srv.min_slots:
            # a scale-down may fire at a tick's start once idle_ticks
            # reaches the threshold: keep every tick of the block below it
            k = min(k, srv.acfg.scale_down_after - srv._idle_ticks - 1)
        if srv.hcfg is not None:
            if srv._mult != 1:
                # a narrowing retarget can land at any tick's end while
                # widened: one-tick blocks keep it at the block's end
                k = min(k, 1)
            thr = srv.hcfg.widen_after
            if srv.hcfg.calm_silence is not None:
                thr = min(thr, srv.hcfg.calm_silence)
            # a widening at the block's last tick is applied after the
            # block, as at the end of an interpreted tick
            k = min(k, thr - srv._calm_ticks)
        return max(k, 0)

    # -- the device half ----------------------------------------------------

    def _device(self, key) -> _Steps:
        srv = self._srv
        if srv.slots != self._slots_seen:
            self._steps.clear()              # graphs of another slot count
            self._slots_seen = srv.slots
        steps = self._steps.get(key)
        if steps is None or steps.engine is not srv._engine_for(key[1]):
            wake = srv.vcfg.wake_margin if srv.vcfg is not None else 0
            steps = _Steps(srv, key, self.cfg.block + wake)
            self._steps[key] = steps
        return steps

    # -- the block ----------------------------------------------------------

    def run(self, k: int) -> List[dict]:
        """Serve ``k`` ticks (``k`` from ``horizon()``: nothing structural
        fires inside the block but at its very end).  Equal to ``k``
        interpreted ``step()`` calls; returns their events in tick
        order."""
        srv = self._srv
        hop = srv.geom.hop
        window = srv.geom.window
        n = srv.slots
        m = srv.vcfg.wake_margin if srv.vcfg is not None else 0
        tick0 = srv._steps
        mult0 = srv._mult
        t_start = time.perf_counter()
        if srv._audit is not None:
            srv._audit.begin_tick(tick0)

        # the fault model in lockstep: the chip delta of each tick (the
        # interpreted tick refreshes its rider at each tick's start)
        chip_seq: Optional[list] = None
        if srv._faults is not None:
            chip_seq = []
            for _ in range(k):
                srv._faults.tick()
                if srv._faults.pop_dirty():
                    srv._refresh_chip_delta()
                chip_seq.append(srv._chip_delta)
            if all(c is chip_seq[0] for c in chip_seq):
                chip_seq = None              # constant: the rider covers it

        # stage the block's ready hops: each tick consumes one hop per
        # ready slot, and nothing is submitted inside the block, so a
        # slot's readiness is a prefix of the block
        ready = np.zeros((k, n), bool)
        audio = np.zeros((k, n, hop), np.float32)
        recs: Dict[int, object] = {}
        seq: Dict[int, list] = {}            # slot -> pending + fresh hops
        p0: Dict[int, int] = {}              # slot -> deferred hops entering
        nready: Dict[int, int] = {}          # slot -> fresh hops staged
        rem0: Dict[int, int] = {}            # slot -> samples left buffered
        for s, rec in enumerate(srv._slots):
            if rec is None or not rec.initialized:
                continue
            rs = min(k, len(rec.buf) // hop)
            recs[s] = rec
            p0[s] = len(rec.pending)
            nready[s] = rs
            chunks = np.asarray(rec.buf[:rs * hop],
                                np.float32).reshape(rs, hop)
            rec.buf = rec.buf[rs * hop:]
            rem0[s] = len(rec.buf)
            seq[s] = list(rec.pending) + list(chunks)
            ready[:rs, s] = True
            audio[:rs, s] = chunks

        # the VAD over the block, on the host where the server runs it:
        # its flags feed the fate simulation below
        if srv.vcfg is not None:
            srv._vstate, flags = vd.vad_scan(srv.vcfg, srv._vstate,
                                             torch.from_numpy(audio),
                                             torch.from_numpy(ready))
            speech = flags.numpy() & ready
        else:
            speech = ready.copy()

        # the host fate simulation, as the interpreted tick classifies
        # per tick and slot: speech wakes and replays the deferred hops,
        # silence defers the hop and ages the oldest out of the margin
        pend = {s: list(range(p0[s])) for s in recs}
        sched = []
        for t in range(k):
            tk = {"replays": [], "regular": [], "fills": []}
            for s in sorted(recs):
                if not ready[t, s]:
                    continue
                j = p0[s] + t
                if speech[t, s]:
                    if pend[s]:
                        tk["replays"].append((s, pend[s] + [j]))
                        pend[s] = []
                    else:
                        tk["regular"].append((s, j))
                else:
                    pend[s].append(j)
                    if len(pend[s]) > m:
                        tk["fills"].append((s, pend[s].pop(0)))
            sched.append(tk)

        # the masks over the timeline index j
        jcap = max((p0[s] + nready[s] for s in recs), default=0)
        cm = np.zeros((max(jcap, 1), n), bool)
        fm = np.zeros((max(jcap, 1), n), bool)
        comp_tick: Dict[tuple, int] = {}
        jmax = 0
        for t, tk in enumerate(sched):
            for s, js in tk["replays"]:
                for j in js:
                    cm[j, s] = True
                    comp_tick[(s, j)] = t
                    jmax = max(jmax, j + 1)
            for s, j in tk["regular"]:
                cm[j, s] = True
                comp_tick[(s, j)] = t
                jmax = max(jmax, j + 1)
            for s, j in tk["fills"]:
                fm[j, s] = True
                jmax = max(jmax, j + 1)

        trig = kwd = sc = None
        # the IMC forwards the block runs: one per step where a slot
        # computes (every one calls the fused layer on the CPU; on a card
        # only a capturing block's eager first step does)
        passes = int(cm[:jmax].any(axis=1).sum())
        with srv._region("compiled", max(passes, 1)):
            if jmax > 0:
                per_tick_chip = chip_seq is not None
                gated = srv.vcfg is not None
                dev = self._device((n, srv._mult, srv._cust_on,
                                    per_tick_chip, gated))
                dev.h_audio[:jmax] = 0.0
                for s in recs:
                    for j, ch in enumerate(seq[s][:jmax]):
                        dev.h_audio[j, s] = ch
                dev.h_cm[:jmax] = cm[:jmax]
                dev.h_fm[:jmax] = fm[:jmax]
                if per_tick_chip:
                    # each hop's delta is its COMPUTE tick's (a wake replay
                    # reads its wake tick's, as the interpreted replay does)
                    for name, h in dev.h_chip.items():
                        h[:jmax] = 0.0
                    for (s, j), t in comp_tick.items():
                        d = chip_seq[t]
                        if d is not None:
                            for name, h in dev.h_chip.items():
                                h[j, s] = d[name]
                dev.load(srv, jmax)
                for j in range(jmax):
                    if cm[j].any():
                        dev.step("compute", j)
                    if gated and fm[j].any():
                        dev.step("fill", j)
                outs = dev.unload(srv, jmax)
                trig = outs[:, 0] != 0
                kwd = outs[:, 1].astype(np.int64)
                sc = outs[:, 2]
        srv._imc_passes += passes
        dt = time.perf_counter() - t_start
        srv._hop_wall_s += dt
        if comp_tick:
            per_slot: Dict[int, int] = {}
            for (s, _j) in comp_tick:
                per_slot[s] = per_slot.get(s, 0) + 1
            for s, cnt in per_slot.items():
                recs[s].wall_s += dt * cnt / len(comp_tick)

        # the per-tick bookkeeping, replayed in tick order: the side
        # effects of k interpreted ticks
        events_all: List[dict] = []
        for t in range(k):
            tick = tick0 + t
            if t == k - 1:
                self.last_view = (len(srv._queue), [
                    None if rec is None
                    else rem0[s] + max(nready[s] - t, 0) * hop
                    if s in recs else len(rec.buf)
                    for s, rec in enumerate(srv._slots)])
            self._sim_autoscale()
            tk = sched[t]
            tick_events: List[dict] = []
            for s in sorted(recs):
                if not ready[t, s]:
                    continue
                rec = recs[s]
                if speech[t, s]:
                    rec.silent_run = 0
                    if rec.pending:
                        rec.pending = []     # drained by the wake replay
                else:
                    rec.silent_run += 1
                    rec.pending.append(audio[t, s])
                    if len(rec.pending) > m:
                        aged = rec.pending.pop(0)
                        rec.recent = np.concatenate(
                            [rec.recent, aged])[-window:]
                        rec.consumed += hop
                        rec.gated_hops += 1
                        srv._gated_hops += 1
            for s, js in tk["replays"]:
                rec = recs[s]
                srv._replay_calls += 1
                for j in js:
                    srv._decisions += 1
                    srv._speech_hops += 1
                    rec.recent = np.concatenate(
                        [rec.recent, seq[s][j]])[-window:]
                    rec.consumed += hop
                    rec.hops += 1
                    tick_events.append(self._event(rec, trig, kwd, sc, j, s))
            if tk["regular"]:
                srv._hop_calls += 1
                for s, j in tk["regular"]:
                    rec = recs[s]
                    srv._speech_hops += 1
                    rec.hops += 1
                    rec.consumed += hop
                    rec.recent = np.concatenate(
                        [rec.recent, seq[s][j]])[-window:]
                srv._decisions += len(tk["regular"])
                for s, j in tk["regular"]:
                    tick_events.append(
                        self._event(recs[s], trig, kwd, sc, j, s))
            if tk["fills"]:
                srv._gate_calls += 1

            # retire drained finished streams, on the VIRTUAL buffer
            # length (staging took the block's hops up front)
            for s, rec in enumerate(list(srv._slots)):
                if rec is None or not rec.finished:
                    continue
                if rec.initialized and s in recs:
                    remaining = (rem0[s]
                                 + max(nready[s] - (t + 1), 0) * hop)
                else:
                    remaining = len(rec.buf)
                if remaining < (hop if rec.initialized else window):
                    srv._free_slot(rec)
            srv._steps += 1
            silent_t = (bool(ready[t].any())
                        and not bool((speech[t] & ready[t]).any()))
            srv._retarget_hop(tick_events, woke=bool(tk["replays"]),
                              silent=silent_t)
            if srv.hcfg is not None and t < k - 1:
                assert srv._mult == mult0, \
                    "hop retarget fired inside a compiled block"
            n_replay_hops = sum(len(js) for _, js in tk["replays"])
            computed = n_replay_hops + len(tk["regular"])
            gated_n = len(tk["fills"])
            if srv._rec is not None and (computed or gated_n
                                         or tick_events):
                uj = srv._tick_uj(computed, gated_n)
                srv._rec.record(tick, "tick", init=0, computed=computed,
                                gated=gated_n, replays=len(tk["replays"]),
                                decisions=len(tick_events),
                                uj=round(uj, 4))
                srv._metrics.observe("serving.tick_uj", uj)
            events_all.extend(tick_events)

        if srv._audit is not None:
            srv._audit.end_tick()
            for t in range(1, k):
                srv._audit.begin_tick(tick0 + t)
                srv._audit.end_tick()
        srv._compiled_blocks += 1
        srv._compiled_ticks += k
        return events_all

    @staticmethod
    def _event(rec, trig, kwd, sc, j: int, s: int) -> dict:
        ev = {"stream": rec.stream_id, "hop": rec.hops - 1,
              "keyword": int(kwd[j, s]), "score": float(sc[j, s]),
              "trigger": bool(trig[j, s])}
        if ev["trigger"]:
            rec.triggers.append(ev)
        return ev

    def _sim_autoscale(self) -> None:
        """``_autoscale``'s counter bookkeeping for one tick of the block.
        The queue is empty (a horizon condition), so no pressure accrues,
        and the horizon keeps ``idle_ticks`` below the scale-down
        threshold: a due resize always lands on an interpreted tick."""
        srv = self._srv
        if srv.acfg is None or srv.max_slots <= srv.min_slots:
            return
        srv._pressure_ticks = 0
        free_tail = 0
        for rec in reversed(srv._slots):
            if rec is None:
                free_tail += 1
            else:
                break
        if free_tail and srv.slots > srv.min_slots:
            srv._idle_ticks += 1
            assert srv._idle_ticks < srv.acfg.scale_down_after, \
                "slot resize fired inside a compiled block"
        else:
            srv._idle_ticks = 0
