"""Multi-stream batched scheduler for always-on KWS serving.

Port of the core of ``repro/serving/scheduler.py::StreamServer``: a fixed
pool of stream slots, each holding one live stream's incremental
``StreamState``, an admission queue, and per tick:

* **admission** — every slotted stream whose buffer holds a full window
  initializes; with ``batch_init`` (default) the whole wave runs in ONE
  masked batched ``stream_init`` (one fused launch per IMC layer), else
  one B=1 init per stream;
* **SA noise** (``sa_noise_std > 0``) — every stream draws its read
  noise from its own per-absolute-column field, keyed by
  ``fold_in(PRNGKey(seed), uid)`` (``uid`` the stream's submission
  order, internal replay streams included), so a stream's noise does not
  depend on its slot or its batch mates; ``silence_fill="retention"``
  replaces the constant silence fill by the retained noisy read
  (``stream.retention_fills``);
* **voice-activity gating** (``vad=VADConfig(...)``) — each ready hop is
  classified speech/silence.  The last ``wake_margin`` silent hops are
  deferred (buffered host-side, state untouched); a speech onset replays
  them together with the onset hop in ONE multi-hop launch per IMC layer,
  so a keyword straddling the silence->speech edge keeps its prefix.
  Older silent hops are gated: the state advances by the constant silence
  fill (``stream.gated_step``) with no kernel launch, and emit no
  decision;
* **one batched hop** — every speech-ready slot's fresh frame rides ONE
  ``stream_step`` call, i.e. exactly one fused-kernel launch per IMC
  layer for the whole fleet; slots that are not ready ride along masked
  (their state is restored verbatim);
* **the decision head** (``serving.decision``) — smoothing, hysteresis and
  refractory triggers, batched and mask-aware;
* **customization** (``customize(stream_id)`` / ``install_custom``) — an
  enrollment and fine-tuning session (``serving.customize``) rides the
  same batched calls: enrollment hops are the stream's own hops (forced
  past the VAD gate), feature re-extraction replays the recorded windows
  as internal streams in the same batch, and each slot's compensated
  biases and fine-tuned head ride per-slot rider rows (a bias delta in the
  fused kernel's pre-sign operand, a per-slot FC head), so a mixed
  serving + learning tick still launches the fused kernel once per IMC
  layer and call.  The session's background work runs at the end of each
  tick.

Streams are evicted when their producer calls ``finish()`` and their
buffer drains, or at once by ``evict()``.  ``stats()`` reports the tick,
decision and hop counters, the batched-call counts by cause (each init /
hop / replay call costs one launch per IMC layer, a gate call none), the
learning hops and sessions, and the modelled gated energy per decision.

Not in this port yet: dynamic hop, admission control and autoscaling,
the recompute fallback, faults and health, profiles, compiled ticks,
snapshots, the flight recorder and the trace.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import energy, jaxrand
from repro_torch.kernels import resolve_device
from repro_torch.models import kws
from repro_torch.obs.metrics import MetricsRegistry, counter_property
from repro_torch.serving import decision as dec
from repro_torch.serving import stream as sv
from repro_torch.serving import vad as vd


@dataclasses.dataclass
class _Stream:
    stream_id: str
    uid: int                              # submission order; a capture's
    #                                       origin names it
    buf: np.ndarray                       # pending samples (host ring tail)
    slot: Optional[int] = None
    initialized: bool = False
    finished: bool = False                # producer called finish()
    hops: int = 0                         # decisions made (incl. window 0)
    triggers: List[dict] = dataclasses.field(default_factory=list)
    wall_s: float = 0.0                   # server time attributed to it
    pending: List[np.ndarray] = dataclasses.field(   # deferred silent hops
        default_factory=list)                        # (<= wake_margin)
    gated_hops: int = 0                   # fill-advanced (no-compute) hops
    recent: np.ndarray = dataclasses.field(     # last consumed window
        default_factory=lambda: np.zeros((0,), np.float32))
    # -- customization (serving.customize) ---------------------------------
    internal: bool = False                # session-owned replay stream: no
    #                                       decision events, not in stats
    force_compute: bool = False           # bypass VAD gating (enrollment /
    #                                       replay hops must run the IMC
    #                                       path so captures stay exact)
    consumed: int = 0                     # samples advanced through the
    #                                       stream state (capture targets)
    custom: Optional[dict] = None         # per-stream riders: {"delta":
    #                                       {conv_i: (C_i,)}, "head":
    #                                       (fc_w, fc_b), "fills": tuple}


def _tree_map(fn, tree, *rest):
    """Map ``fn`` over the tensor leaves of (named) tuples."""
    if isinstance(tree, tuple):
        items = [_tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(
            items)
    return fn(tree, *rest)


def _select_state(mask: torch.Tensor, new, old):
    """Rows of ``new`` where ``mask`` is set, rows of ``old`` elsewhere."""
    def sel(n, o):
        return torch.where(mask.reshape(mask.shape + (1,) * (n.dim() - 1)),
                           n, o)
    return _tree_map(sel, new, old)


def _scatter_slot(state, one, slot: int):
    """Write a B=1 state into row ``slot`` of a batched state."""
    def put(full, o):
        full = full.clone()
        full[slot] = o[0]
        return full
    return _tree_map(put, state, one)


class StreamServer:
    """Admit / batch / gate / decide / evict over a pool of stream slots."""

    _steps = counter_property("serving.steps")
    _hop_wall_s = counter_property("serving.hop_wall_s")
    _decisions = counter_property("serving.decisions")
    _speech_hops = counter_property("serving.hops", kind="speech")
    _gated_hops = counter_property("serving.hops", kind="gated")
    _init_calls = counter_property("serving.batched_calls", cause="init")
    _hop_calls = counter_property("serving.batched_calls", cause="hop")
    _replay_calls = counter_property("serving.batched_calls",
                                     cause="replay")
    _gate_calls = counter_property("serving.batched_calls", cause="gate")
    _learn_hops = counter_property("serving.hops", kind="learn")

    def __init__(self, hw, cfg: kws.KWSConfig, *, hop: int, slots: int = 4,
                 chip_offsets: Optional[Dict[str, torch.Tensor]] = None,
                 sa_noise_std: float = 0.0, use_kernel: bool = True,
                 decision: dec.DecisionConfig = dec.DecisionConfig(),
                 vad: Optional[vd.VADConfig] = None,
                 batch_init: bool = True,
                 silence_fill: str = "constant",
                 seed: int = 0, device=None):
        if silence_fill not in ("constant", "retention"):
            raise ValueError(f"silence_fill={silence_fill!r}: use "
                             f"'constant' or 'retention'")
        self.device = resolve_device(device)
        self._metrics = MetricsRegistry()
        self.cfg = cfg
        self.batch_init = batch_init
        self.dcfg = decision
        self.vcfg = vad
        self.seed = seed
        self.silence_fill = silence_fill
        self.slots = slots
        self.engine = sv.StreamEngine(hw, cfg, hop,
                                      chip_offsets=chip_offsets,
                                      sa_noise_std=sa_noise_std,
                                      use_kernel=use_kernel,
                                      device=self.device)
        self.geom = self.engine.geom
        # the per-stream noise-field keys are derived on the host, as the
        # reference does: fold_in(base_key, uid)
        self._base_key = jaxrand.PRNGKey(seed, device="cpu")
        self._fills = None
        if vad is not None:
            if silence_fill == "retention":
                # chip-accurate gated fill: one retained noisy SA read per
                # layer instead of the noiseless silence response
                self._fills = sv.retention_fills(
                    hw, cfg, key=jaxrand.fold_in(jaxrand.PRNGKey(
                        seed, device=self.device), 0x517),
                    sa_noise_std=sa_noise_std,
                    chip_offsets=self.engine.chip_offsets)
            else:
                self._fills = sv.silence_fills(cfg, kws.silence_columns(
                    hw, cfg, chip_offsets=self.engine.chip_offsets))

        self._state = self.engine.zeros_state(slots)
        self._dstate = dec.decision_init(slots, cfg.num_classes, decision,
                                         device=self.device)
        self._vstate = (vd.vad_init(slots, device=self.device)
                        if vad is not None else None)
        # customization (serving.customize): once enabled, batched calls
        # route through the per-slot (bias delta, FC head) variant so
        # hot-swapped and learning slots share the one-launch-per-layer
        # batch with everyone else
        self._cust = None                 # CustomizationManager
        self._cust_on = False
        self._slot_delta = None           # {conv_i: (slots, C_i)}
        self._slot_head_w = None          # (slots, D, num_classes)
        self._slot_head_b = None          # (slots, num_classes)
        self._slot_fills = None           # per-layer (slots, C_i) if VAD

        self._slots: List[Optional[_Stream]] = [None] * slots
        self._queue: collections.deque[_Stream] = collections.deque()
        self._streams: Dict[str, _Stream] = {}
        self._uid = 0
        self._steps = 0
        self._hop_wall_s = 0.0
        self._decisions = 0
        self._speech_hops = 0
        self._gated_hops = 0
        self._learn_hops = 0
        # batched-compute accounting: each init/hop/replay call is one
        # fused-kernel launch per IMC layer however many slots ride it;
        # gate calls launch nothing
        self._init_calls = 0
        self._hop_calls = 0
        self._replay_calls = 0
        self._gate_calls = 0

    @property
    def hop(self) -> int:
        return self.geom.hop

    @property
    def metrics(self) -> MetricsRegistry:
        """The server's metrics registry (it backs ``stats()``)."""
        return self._metrics

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def stream_key(self, uid: int) -> torch.Tensor:
        """The noise-field key of the stream with submission order
        ``uid``: ``fold_in(PRNGKey(seed), uid)``, (2,) on the CPU."""
        return jaxrand.fold_in(self._base_key, uid)

    # -- customization: per-slot riders + session manager -------------------

    def _base_head(self):
        hwp, _ = kws.as_hw_params(self.engine.hw)
        return hwp.fc_w, hwp.fc_b

    def _enable_customization(self) -> None:
        """Materialize the per-slot rider rows (zero bias deltas, the base
        FC head in every row) and route batched calls through the per-slot
        variant from now on.  Rows with base values are bit-exact no-ops,
        so uncustomized slots are unaffected."""
        if self._cust_on:
            return
        self._cust_on = True
        n, cfg, dev = self.slots, self.cfg, self.device
        fw, fb = self._base_head()
        self._slot_delta = {
            f"conv{i}": torch.zeros((n, cfg.channels[i]), device=dev)
            for i in range(1, cfg.num_conv_layers)}
        self._slot_head_w = fw.expand((n,) + fw.shape).clone()
        self._slot_head_b = fb.expand((n,) + fb.shape).clone()
        if self._fills is not None:
            self._slot_fills = tuple(f.expand((n,) + f.shape).clone()
                                     for f in self._fills)
        for s, rec in enumerate(self._slots):
            if rec is not None and rec.custom is not None:
                self._write_slot_custom(s, rec.custom)

    def _write_slot_custom(self, s: int, custom: Optional[dict]) -> None:
        """Sync slot ``s``'s rider rows with a stream's customization
        (``None`` resets to base).  Called on admission, eviction and
        hot-swap; only row ``s`` changes."""
        if not self._cust_on:
            return
        if custom is None:
            fw, fb = self._base_head()
            for name in self._slot_delta:
                self._slot_delta[name][s] = 0.0
            self._slot_head_w[s] = fw
            self._slot_head_b[s] = fb
            if self._slot_fills is not None:
                for t, f in zip(self._slot_fills, self._fills):
                    t[s] = f
            return
        dev = self.device
        for name in self._slot_delta:
            self._slot_delta[name][s] = kws.as_tensor(custom["delta"][name],
                                                      dev)
        self._slot_head_w[s] = kws.as_tensor(custom["head"][0], dev)
        self._slot_head_b[s] = kws.as_tensor(custom["head"][1], dev)
        if self._slot_fills is not None and custom.get("fills") is not None:
            for t, f in zip(self._slot_fills, custom["fills"]):
                t[s] = kws.as_tensor(f, dev)

    def _riders(self) -> tuple:
        """The per-slot riders of a batched call, (bias deltas, head_w,
        head_b), once customization is on; () for the base path."""
        if not self._cust_on:
            return ()
        return (self._slot_delta, self._slot_head_w, self._slot_head_b)

    def _row_custom(self, rec: "_Stream") -> tuple:
        """Rider args for a B=1 init (``batch_init`` off): the stream's own
        customization, or () for the base init path."""
        if not self._cust_on or rec.custom is None:
            return ()
        dev = self.device
        delta = {name: kws.as_tensor(rec.custom["delta"][name], dev)[None]
                 for name in self.cfg.imc_layer_names()}
        return (delta, kws.as_tensor(rec.custom["head"][0], dev)[None],
                kws.as_tensor(rec.custom["head"][1], dev)[None])

    def customize(self, stream_id: str, ccfg=None):
        """Open an enrollment / fine-tuning session attached to a live
        stream (created empty if absent): labeled utterances submitted via
        ``session.enroll`` ride the stream's normal batched hops, then the
        paper's on-chip loop (bias compensation -> error-scaled + SGA
        fine-tune) runs as bounded background jobs inside ``step()``.  See
        ``serving.customize``.  Returns the CustomizationSession."""
        from repro_torch.serving import customize as cz
        if self._cust is None:
            self._cust = cz.CustomizationManager(self)
        self._enable_customization()
        return self._cust.start(stream_id, ccfg)

    def install_custom(self, stream_id: str, result) -> None:
        """Hot-swap a finished customization (a CustomizationResult) into
        a stream: its slot's bias-delta / FC-head / silence-fill rows are
        reprogrammed in place; every other slot's rows and states are
        untouched.  The stream is created (empty) if it does not exist."""
        from repro_torch.serving import customize as cz
        self._enable_customization()
        rec = self._streams.get(stream_id)
        if rec is None:
            rec = self._new_stream(stream_id, np.zeros((0,), np.float32))
        rec.custom = cz.result_riders(result, self.engine.hw, self.cfg,
                                      chip_offsets=self.engine.chip_offsets,
                                      with_fills=self._fills is not None)
        if rec.slot is not None:
            self._write_slot_custom(rec.slot, rec.custom)

    def _submit_internal(self, stream_id: str, wav: np.ndarray,
                         custom: Optional[dict] = None) -> "_Stream":
        """Enqueue a session-owned replay stream: it rides the normal slot
        machinery and the same batched launches but emits no decision
        events and never gates.  Finished on arrival: it retires once its
        audio drains (the session captures its features first)."""
        return self._new_stream(stream_id, np.asarray(wav, np.float32),
                                internal=True, force_compute=True,
                                custom=custom, finished=True)

    def _drop_internal(self, stream_id: str) -> None:
        rec = self._streams.pop(stream_id, None)
        if rec is None:
            return
        rec.finished = True
        rec.buf = rec.buf[:0]
        rec.pending = []
        if rec.slot is not None:
            self._free_slot(rec)
        elif rec in self._queue:
            self._queue.remove(rec)

    # -- stream lifecycle ---------------------------------------------------

    def submit(self, stream_id: str, chunk: np.ndarray) -> str:
        """Append audio to a stream (created on first submit).  Returns
        'slot' (live) or 'queued' (awaiting a slot)."""
        rec = self._streams.get(stream_id)
        if rec is None:
            rec = self._new_stream(stream_id, np.zeros((0,), np.float32))
        if rec.finished:
            raise ValueError(f"stream {stream_id} already finished")
        rec.buf = np.concatenate([rec.buf, np.asarray(chunk, np.float32)])
        return "slot" if rec.slot is not None else "queued"

    def _new_stream(self, stream_id: str, buf: np.ndarray,
                    **kw) -> _Stream:
        """Register a stream (next uid), queue it and admit it if a slot
        is free."""
        rec = _Stream(stream_id=stream_id, uid=self._uid, buf=buf, **kw)
        self._uid += 1
        self._streams[stream_id] = rec
        self._queue.append(rec)
        self._try_admit()
        return rec

    def finish(self, stream_id: str) -> None:
        """Producer signals end-of-stream: the slot is freed once the
        buffered audio drains below one hop."""
        self._streams[stream_id].finished = True

    def evict(self, stream_id: str) -> None:
        """Drop a stream immediately, freeing its slot."""
        rec = self._streams[stream_id]
        rec.finished = True
        rec.buf = rec.buf[:0]
        rec.pending = []
        if rec.slot is not None:
            self._free_slot(rec)
        elif rec in self._queue:
            self._queue.remove(rec)

    def _free_slot(self, rec: _Stream) -> None:
        s = rec.slot
        self._slots[s] = None
        rec.slot = None
        self._write_slot_custom(s, None)
        self._try_admit()

    def _try_admit(self) -> None:
        for s in range(self.slots):
            if self._slots[s] is None and self._queue:
                rec = self._queue.popleft()
                rec.slot = s
                rec.initialized = False
                self._slots[s] = rec
                self._write_slot_custom(s, rec.custom)

    # -- the batched tick ---------------------------------------------------

    def _admit_ready(self):
        """Initialize every slotted stream whose buffer holds a full
        window.  Returns (init_mask, init_logits) rows for this tick."""
        window = self.geom.window
        init_mask = np.zeros((self.slots,), bool)
        init_logits = np.zeros((self.slots, self.cfg.num_classes),
                               np.float32)
        todo = [(s, rec) for s, rec in enumerate(self._slots)
                if rec is not None and not rec.initialized
                and len(rec.buf) >= window]
        if not todo:
            return init_mask, init_logits

        def _book(rec, s, first, dt):
            rec.wall_s += dt
            rec.initialized = True
            rec.hops += 1
            rec.consumed += window
            rec.recent = first.copy()
            rec.pending = []
            self._dstate = dec.reset_slot(self._dstate, s)
            if self._vstate is not None:
                self._vstate = vd.vad_reset_slot(self._vstate, s)
            init_mask[s] = True

        if self.batch_init:
            windows = np.zeros((self.slots, window), np.float32)
            keys = torch.zeros((self.slots, 2), dtype=torch.int64)
            keys[[s for s, _ in todo]] = self.stream_key(
                torch.tensor([rec.uid for _, rec in todo]))
            for s, rec in todo:
                windows[s] = rec.buf[:window]
                rec.buf = rec.buf[window:]   # the state carries the overlap
                init_mask[s] = True
            t0 = time.perf_counter()
            logits, new_state = self.engine.init(
                self._tensor(windows), keys.to(self.device),
                *self._riders())
            self._state = _select_state(self._tensor(init_mask), new_state,
                                        self._state)
            logits = logits.cpu().numpy()
            dt = time.perf_counter() - t0
            self._hop_wall_s += dt
            self._init_calls += 1
            for s, rec in todo:
                _book(rec, s, windows[s], dt / len(todo))
                init_logits[s] = logits[s]
            return init_mask, init_logits

        for s, rec in todo:
            first = rec.buf[:window]
            rec.buf = rec.buf[window:]
            t0 = time.perf_counter()
            logits, one = self.engine.init(
                self._tensor(first[None]),
                self.stream_key(rec.uid)[None].to(self.device),
                *self._row_custom(rec))
            self._state = _scatter_slot(self._state, one, s)
            init_logits[s] = logits[0].cpu().numpy()
            dt = time.perf_counter() - t0
            self._hop_wall_s += dt
            self._init_calls += 1
            _book(rec, s, first, dt)
        return init_mask, init_logits

    def _event(self, rec: _Stream, s: int, out: dec.DecisionOut) -> dict:
        ev = {"stream": rec.stream_id, "hop": rec.hops - 1,
              "keyword": int(out.keyword[s]), "score": float(out.score[s]),
              "trigger": bool(out.trigger[s])}
        if ev["trigger"]:
            rec.triggers.append(ev)
        return ev

    def step(self) -> List[dict]:
        """One scheduler tick: admissions, VAD classification, wake
        replays, ONE batched hop over every speech-ready slot, ONE masked
        no-op fill over every gated slot, then the batched decision
        update.  Returns this tick's decision events (gated hops emit
        none)."""
        hop = self.geom.hop
        window = self.geom.window
        init_mask, init_logits = self._admit_ready()

        ready = np.zeros((self.slots,), bool)
        audio = np.zeros((self.slots, hop), np.float32)
        for s, rec in enumerate(self._slots):
            if (rec is not None and rec.initialized and not init_mask[s]
                    and len(rec.buf) >= hop):
                ready[s] = True
                audio[s] = rec.buf[:hop]
                rec.buf = rec.buf[hop:]

        if self.vcfg is None:
            speech = ready.copy()
        else:
            self._vstate, sp = vd.vad_step(self.vcfg, self._vstate,
                                           self._tensor(audio),
                                           self._tensor(ready))
            speech = sp.cpu().numpy() & ready
            for s, rec in enumerate(self._slots):
                # enrollment and replay hops must run the real IMC path:
                # a gated hop would corrupt the captured feature buffer
                if ready[s] and rec is not None and rec.force_compute:
                    speech[s] = True

        compute_mask = np.zeros((self.slots,), bool)
        fill_mask = np.zeros((self.slots,), bool)
        replays: List[tuple] = []
        for s, rec in enumerate(self._slots):
            if not ready[s]:
                continue
            if speech[s]:
                if rec.pending:           # wake: replay the deferred hops
                    replays.append((s, rec.pending + [audio[s]]))
                    rec.pending = []
                else:
                    compute_mask[s] = True
            else:
                rec.pending.append(audio[s])
                if len(rec.pending) > self.vcfg.wake_margin:
                    aged = rec.pending.pop(0)
                    fill_mask[s] = True   # advance by the no-op fill
                    rec.recent = np.concatenate([rec.recent,
                                                 aged])[-window:]
                    rec.consumed += hop
                    rec.gated_hops += 1
                    self._gated_hops += 1

        events: List[dict] = []

        # wake replays: the deferred silent hops plus the onset hop in ONE
        # multi-hop launch per IMC layer for this slot
        for s, chunks in replays:
            rec = self._slots[s]
            n = len(chunks)
            mask = np.zeros((self.slots,), bool)
            mask[s] = True
            mask_t = self._tensor(mask)
            a = np.zeros((self.slots, n * hop), np.float32)
            a[s] = np.concatenate(chunks)
            t0 = time.perf_counter()
            lg, new_state = self.engine.multi_step(self._state,
                                                   self._tensor(a), n,
                                                   *self._riders())
            self._state = _select_state(mask_t, new_state, self._state)
            self._replay_calls += 1
            outs = []
            for j in range(n):
                self._dstate, out = dec.decision_step(
                    self.dcfg, self._dstate, lg[:, j], mask_t)
                outs.append(out)
            outs = [dec.DecisionOut(*(t.cpu() for t in out)) for out in outs]
            dt = time.perf_counter() - t0
            rec.wall_s += dt
            self._hop_wall_s += dt
            for ch, out in zip(chunks, outs):
                self._decisions += 1
                self._speech_hops += 1
                rec.recent = np.concatenate([rec.recent, ch])[-window:]
                rec.consumed += hop
                rec.hops += 1
                events.append(self._event(rec, s, out))

        logits = init_logits
        if compute_mask.any():
            t0 = time.perf_counter()
            hop_logits, new_state = self.engine.step(
                self._state, self._tensor(audio), *self._riders())
            self._state = _select_state(self._tensor(compute_mask),
                                        new_state, self._state)
            hop_logits = hop_logits.cpu().numpy()
            dt = time.perf_counter() - t0
            self._hop_wall_s += dt
            self._hop_calls += 1
            n_active = int(compute_mask.sum())
            for s, rec in enumerate(self._slots):
                if compute_mask[s]:
                    if rec.internal:
                        self._learn_hops += 1
                    else:
                        self._speech_hops += 1
                    rec.hops += 1
                    rec.wall_s += dt / n_active
                    rec.consumed += hop
                    rec.recent = np.concatenate([rec.recent,
                                                 audio[s]])[-window:]
            logits = np.where(compute_mask[:, None], hop_logits, init_logits)

        if fill_mask.any():
            t0 = time.perf_counter()
            fills = (self._slot_fills if self._slot_fills is not None
                     else self._fills)
            new_state = sv.gated_step(self._state, self.cfg, self.geom,
                                      fills)
            self._state = _select_state(self._tensor(fill_mask), new_state,
                                        self._state)
            self._sync()
            self._hop_wall_s += time.perf_counter() - t0
            self._gate_calls += 1

        internal = np.asarray([rec is not None and rec.internal
                               for rec in self._slots])
        decide_mask = (init_mask | compute_mask) & ~internal
        if decide_mask.any():
            self._dstate, out = dec.decision_step(
                self.dcfg, self._dstate, self._tensor(logits),
                self._tensor(decide_mask))
            self._decisions += int(decide_mask.sum())
            out = dec.DecisionOut(*(t.cpu() for t in out))
            for s, rec in enumerate(self._slots):
                if rec is not None and decide_mask[s]:
                    events.append(self._event(rec, s, out))

        # feature captures must see the post-hop states before slots retire
        if self._cust is not None:
            self._cust.on_step(self)

        # retire drained finished streams
        for rec in list(self._slots):
            if (rec is not None and rec.finished
                    and len(rec.buf) < (hop if rec.initialized
                                        else window)):
                self._free_slot(rec)
        self._steps += 1
        # background learning jobs: calibration layers, feature-replay
        # spawns, bounded fine-tune rounds, hot swaps
        if self._cust is not None:
            self._cust.tick(self)
        return events

    def drain(self, max_steps: int = 10_000) -> List[dict]:
        """Step until no slot can make progress and the queue is empty."""
        events: List[dict] = []
        for _ in range(max_steps):
            before = (len(self._queue),
                      [None if r is None else len(r.buf)
                       for r in self._slots])
            events.extend(self.step())
            after = (len(self._queue),
                     [None if r is None else len(r.buf)
                      for r in self._slots])
            if after == before:
                break
        return events

    # -- accounting ---------------------------------------------------------

    def active_streams(self) -> List[str]:
        return [r.stream_id for r in self._slots if r is not None]

    def stats(self) -> dict:
        offline = kws.layer_stats(self.cfg)
        streaming = sv.streaming_layer_stats(self.cfg, self.geom)
        macs_off = sum(s["macs"] for s in offline)
        macs_str = sum(s["macs"] for s in streaming)
        total_hops = self._speech_hops + self._gated_hops
        duty = (self._speech_hops / total_hops) if total_hops else None
        out = {
            "mode": "streaming",
            "device": str(self.device),
            "slots": self.slots,
            "queue_depth": len(self._queue),
            "steps": self._steps,
            "decisions": self._decisions,
            "hop": self.hop,
            "speech_hops": self._speech_hops,
            "gated_hops": self._gated_hops,
            "learn_hops": self._learn_hops,
            "batched_calls": {
                "init": self._init_calls,
                "hop": self._hop_calls,
                "replay": self._replay_calls,
                "gate": self._gate_calls,
            },
            "duty_cycle": round(duty, 4) if duty is not None else None,
            "hop_wall_s": round(self._hop_wall_s, 4),
            "decisions_per_sec": round(
                self._decisions / self._hop_wall_s, 2)
                if self._hop_wall_s > 0 else None,
            "macs_per_decision": {
                "offline": macs_off,
                "streaming": macs_str,
                "ratio": round(macs_str / macs_off, 4),
            },
            "per_stream": {
                rec.stream_id: {"hops": rec.hops,
                                "gated_hops": rec.gated_hops,
                                "triggers": len(rec.triggers),
                                "wall_s": round(rec.wall_s, 4)}
                for rec in self._streams.values() if not rec.internal
            },
        }
        if self._cust is not None:
            out["customization"] = self._cust.stats()
        if self.vcfg is not None:
            out["gated_energy"] = {
                k: round(v, 4) if isinstance(v, float) else v
                for k, v in energy.gated_energy_summary(
                    offline, streaming, hop_samples=self.hop,
                    duty_cycle=duty if duty is not None else 1.0).items()
            }
        return out
