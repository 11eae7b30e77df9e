"""Multi-stream batched scheduler for always-on KWS serving.

Port of ``repro/serving/scheduler.py::StreamServer``: a pool of stream
slots, each holding one live stream's incremental ``StreamState``, an
admission queue, and per tick:

* **the front door** — the profile staleness sweep, then latency-SLO
  shedding and slot autoscaling (``admission=AdmissionConfig(...)``):
  ``submit`` returns ``'rejected'`` (and buffers nothing) once every slot
  is taken and the wait queue holds ``max_queue`` streams; a stream whose
  backlog exceeds ``max_lag_s`` of audio is shed to the low-water mark
  (half the SLO, never below one window) and re-initializes from its
  freshest window; the pool grows after ``scale_up_after`` ticks with a
  waiting stream and shrinks after ``scale_down_after`` ticks with idle
  trailing slots, between ``min_slots`` and ``max_slots`` (the state, the
  decision and VAD state and the customization rider rows are padded or
  cropped with it);
* **admission** — every slotted stream whose buffer holds a full window
  initializes; with ``batch_init`` (default) the whole wave runs in ONE
  masked batched init (one fused launch per IMC layer), else one B=1
  init per stream;
* **SA noise** (``sa_noise_std > 0``) — every stream draws its read
  noise from its own per-absolute-column field, keyed by
  ``fold_in(PRNGKey(seed), uid)`` (``uid`` the stream's submission
  order, internal replay streams included, or the one ``submit(uid=)``
  pins), so a stream's noise does not depend on its slot or its batch
  mates; ``silence_fill="retention"`` replaces the constant silence fill
  by the retained noisy read (``stream.retention_fills``);
* **voice-activity gating** (``vad=VADConfig(...)``) — each ready hop is
  classified speech/silence.  The last ``wake_margin`` silent hops are
  deferred (buffered host-side, state untouched); a speech onset replays
  them together with the onset hop in ONE multi-hop launch per IMC layer,
  so a keyword straddling the silence->speech edge keeps its prefix.
  Older silent hops are gated: the state advances by the constant silence
  fill (``stream.gated_step``) with no kernel launch, and emit no
  decision;
* **one batched hop** — every speech-ready slot's fresh frame rides ONE
  step call, i.e. exactly one fused-kernel launch per IMC layer for the
  whole fleet; slots that are not ready ride along masked (their state
  is restored verbatim);
* **the decision head** (``serving.decision``) — smoothing, hysteresis and
  refractory triggers, batched and mask-aware;
* **dynamic hop** (``dynamic_hop=DynamicHopConfig(...)``) — after
  ``widen_after`` calm ticks (no posterior reaching ``calm_score``;
  ``calm_silence`` ticks when the tick was all VAD silence) the effective
  hop doubles, up to ``max_multiplier`` x the base hop; a hot posterior
  or a VAD wake narrows it back.  The stream geometry depends on the hop,
  so a retarget rebuilds every live slot's state from its last consumed
  window on that multiplier's engine (with the SA field restarting at
  window 0: a re-init reprograms the array), and deferred hops go back
  into the buffer;
* **customization** (``customize(stream_id)`` / ``install_custom``) — an
  enrollment and fine-tuning session (``serving.customize``) rides the
  same batched calls: enrollment hops are the stream's own hops (forced
  past the VAD gate), feature re-extraction replays the recorded windows
  as internal streams in the same batch, and each slot's compensated
  biases and fine-tuned head ride per-slot rider rows (a bias delta in the
  fused kernel's pre-sign operand, a per-slot FC head), so a mixed
  serving + learning tick still launches the fused kernel once per IMC
  layer and call.  The session's background work runs at the end of each
  tick;
* **profiles at admission** (``profiles=ProfileStore(...)``) —
  ``submit(stream_id, chunk, user_id=...)`` installs the user's stored
  profile onto the stream's riders; the sweep at the top of each tick
  re-installs a profile whose file changed and resets a stream whose
  profile was deleted;
* **faults and health** (``faults=FaultConfig(...)`` /
  ``health=HealthConfig(...)``) — a seeded fault model
  (``core.faults``) rides the batched calls as a chip-global pre-sign
  count delta added to every slot's bias-delta rider row, so a faulted
  tick launches the fused kernel as often as a healthy one; its drift
  advances at the top of each tick.  The health monitor
  (``serving.health``) submits canary windows as internal streams of the
  same batch, captures their state right after the batched hop, walks
  healthy -> degraded -> quarantined -> recovering, re-runs the test-mode
  compensation as background work after the customization sessions' and
  swaps the heal in through the same rider row (``_set_heal_delta``);
  decision events carry ``degraded`` while the chip is not healthy.

``streaming=False`` serves on the recompute path (``hw_forward`` over the
whole window every hop, ``stream.window_step``) with ~window/hop times
the IMC work: the streaming server's events bit for bit while no hop is
gated (a gated hop slides zeros into the window where the streaming path
shifts in the silence fill); a wake replay of n hops launches n times per
layer.  It keeps no silence fills and takes no customization session.

Streams are evicted when their producer calls ``finish()`` and their
buffer drains, or at once by ``evict()``.  ``stats()`` reports the tick,
decision and hop counters, the batched-call counts by cause (each init /
hop / replay call costs one launch per IMC layer, a gate call none;
``imc_passes`` counts the batched IMC forwards that actually ran, hop
retarget re-inits and recompute replay hops included), rejections and
sheds, the hop multiplier and its retargets, the learning hops and
sessions, and the modelled gated energy per decision; ``_tick_uj`` gives
a tick's modelled energy from its hop composition.

**Telemetry** (``obs=ObsConfig(...)``; ``None`` reads the
``REPRO_OBS_*`` environment, ``ObsConfig.from_env``): every counter
lives in the server's ``MetricsRegistry``; ``recorder=N`` keeps the last
N structured events (``reject``, ``admit``, ``evict``, ``shed``,
``hop_retarget``, ``tick``, and the health monitor's and sessions'
``health`` / ``heal`` / ``session`` records) and the ``serving.tick_uj``
histogram; ``audit="flag"|"raise"`` wraps every batched call site in a
``LaunchAuditor`` region (``init``, ``replay``, ``hop``, ``gate``) that
counts the fused layer's calls inside it; ``trace=True`` records the
``init``, ``replay``, ``hop``, ``gate``, ``decide``, ``riders`` and
``tick`` spans.  Telemetry reads the tick and changes nothing it serves.

**Crash-safe snapshots**: ``snapshot(path)`` writes the whole serving
state (carries, rings, decision and VAD state, buffers, the queue, the
noise-field keys, the registry and the recorder, the fault, health and
heal state and every mid-flight customization session) as one ``.npz``,
atomically; ``restore(path)`` on a freshly built, identically configured
server continues bit for bit.  A snapshot holds arrays and plain data
only (tensors go to numpy, keys to the JAX package's uint32 words), so a
card server's snapshot restores into a CPU server and the reverse, and
its leaves equal the JAX server's at the same tick.

``device_label`` names the server's pool in a sharded deployment
(``serving.shard``): it rides the launch auditor and ``stats()``.

**Compiled ticks** (``compiled=True`` or ``CompiledTickConfig(block=K)``,
``serving.compiled``): ``step()`` serves a steady-state tick as a
one-tick block and ``step_block()`` up to K ticks as one block; on a card
each step of a block is a CUDA graph replay, on the CPU it runs eagerly.
A tick the block does not model (admissions, sheds, resizes, sessions,
health, profiles, a trace) runs interpreted.  Both give the same events,
state and counters, bit for bit, but for the wall time, the
``serving.compiled`` counts and ``imc_passes``; ``drain()`` steps in
blocks.  Snapshots carry no compiled state.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import pickle
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import energy, jaxrand
from repro_torch.kernels import resolve_device
from repro_torch.models import kws
from repro_torch.obs import (FlightRecorder, LaunchAuditor, MetricsRegistry,
                             ObsConfig, TraceBuilder, counter_property)
from repro_torch.serving import decision as dec
from repro_torch.serving import stream as sv
from repro_torch.serving import vad as vd


@dataclasses.dataclass(frozen=True)
class DynamicHopConfig:
    """Widen the hop when nothing interesting is happening.

    A tick is *calm* when no decided hop's smoothed posterior reaches
    ``calm_score``.  After ``widen_after`` consecutive calm ticks the
    effective hop doubles, capped at ``max_multiplier`` x the base hop and
    at what the stream geometry admits; a hot posterior or a VAD wake
    narrows back to the base hop at once.  ``calm_silence`` (None: one
    threshold for both) is the calm-tick count used instead when the whole
    tick was VAD silence; streams that bypass the VAD never count as
    silent."""

    max_multiplier: int = 4
    widen_after: int = 6
    calm_score: float = 0.35
    calm_silence: Optional[int] = None

    def __post_init__(self):
        if self.max_multiplier < 1:
            raise ValueError("max_multiplier must be >= 1")
        if self.widen_after < 1:
            raise ValueError("widen_after must be >= 1")
        if self.calm_silence is not None and self.calm_silence < 1:
            raise ValueError("calm_silence must be >= 1 (or None)")


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Admission control, latency SLO and slot autoscaling.

    ``max_queue``: streams allowed to wait for a slot; a further new
    stream's ``submit`` returns ``'rejected'``.  ``max_lag_s``: per-stream
    backlog SLO in seconds of audio; a stream over it is shed to the
    low-water mark (half the SLO, never below one window) and re-admitted
    from its freshest window.  ``min_slots``/``max_slots`` bound the pool
    (both default to the constructor's ``slots``: no autoscaling); it
    grows after ``scale_up_after`` consecutive ticks with a non-empty
    queue and shrinks after ``scale_down_after`` consecutive ticks with
    idle trailing slots."""

    max_queue: Optional[int] = 8
    max_lag_s: Optional[float] = None
    min_slots: Optional[int] = None
    max_slots: Optional[int] = None
    scale_up_after: int = 2
    scale_down_after: int = 6

    def __post_init__(self):
        if self.max_queue is not None and self.max_queue < 0:
            raise ValueError("max_queue must be >= 0 (or None)")
        if self.scale_up_after < 1 or self.scale_down_after < 1:
            raise ValueError("scale_up/down_after must be >= 1")


@dataclasses.dataclass
class _Stream:
    stream_id: str
    uid: int                              # noise-field identity: submission
    #                                       order, or pinned by submit(uid=)
    buf: np.ndarray                       # pending samples (host ring tail)
    slot: Optional[int] = None
    initialized: bool = False
    finished: bool = False                # producer called finish()
    hops: int = 0                         # decisions made (incl. window 0)
    triggers: List[dict] = dataclasses.field(default_factory=list)
    wall_s: float = 0.0                   # server time attributed to it
    recent: np.ndarray = dataclasses.field(     # last consumed window: the
        default_factory=lambda: np.zeros((0,), np.float32))  # re-init
    #                                       source of a hop retarget
    pending: List[np.ndarray] = dataclasses.field(   # deferred silent hops
        default_factory=list)                        # (<= wake_margin)
    silent_run: int = 0                   # consecutive silent hops
    gated_hops: int = 0                   # fill-advanced (no-compute) hops
    sheds: int = 0
    shed_samples: int = 0
    # -- customization (serving.customize) ---------------------------------
    internal: bool = False                # session-owned replay stream: no
    #                                       decision events, not in stats,
    #                                       exempt from the SLO
    force_compute: bool = False           # bypass VAD gating (enrollment /
    #                                       replay hops must run the IMC
    #                                       path so captures stay exact)
    consumed: int = 0                     # samples advanced through the
    #                                       stream state (capture targets)
    custom: Optional[dict] = None         # per-stream riders: {"delta":
    #                                       {conv_i: (C_i,)}, "head":
    #                                       (fc_w, fc_b), "fills": tuple}
    # -- profile store (checkpoint.profiles) -------------------------------
    user_id: Optional[str] = None         # owner in the profile store
    profile_mtime: Optional[int] = None   # installed profile's st_mtime_ns
    #                                       (None: no profile installed)


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


# -- crash-safe snapshot codec ----------------------------------------------
#
# A tree -> (JSON spec, array table) encoder, the JAX package's format:
# arrays are stored losslessly as .npz entries (so restore is bit-exact),
# registered NamedTuples round-trip by class name, and other objects
# (config dataclasses, results) are pickled into uint8 arrays.  Tensors
# leave as numpy copies; a NamedTuple's ``key`` field leaves as the JAX
# package's (2,) uint32 words, which is how ``_tensors`` recognizes keys
# on the way back.  Snapshots are an own-file trust domain (like the
# profile store): only restore snapshots you wrote.

def _snap_class(name: str):
    if name == "HeadState":
        from repro_torch.core.onchip_training import HeadState
        return HeadState
    return {"StreamState": sv.StreamState,
            "WindowState": sv.WindowState,
            "DecisionState": dec.DecisionState,
            "VADState": vd.VADState}[name]


def _host(obj):
    """``obj`` with every tensor inside it (containers and dataclass
    fields) replaced by a numpy copy: what is pickled holds no device."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy().copy()
    if isinstance(obj, dict):
        return {k: _host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_host(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields = {f.name: getattr(obj, f.name)
                  for f in dataclasses.fields(obj) if f.init}
        host = {k: _host(v) for k, v in fields.items()}
        if any(host[k] is not v for k, v in fields.items()):
            return dataclasses.replace(obj, **host)
    return obj


def _snap_encode(obj, arrays: Dict[str, np.ndarray]) -> dict:
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, (bool, int, float, str)):
        return {"t": "v", "v": obj}
    if isinstance(obj, np.integer):
        return {"t": "v", "v": int(obj)}
    if isinstance(obj, np.floating):
        return {"t": "v", "v": float(obj)}
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        k = f"a{len(arrays)}"
        arrays[k] = (obj.detach().cpu().numpy().copy()
                     if isinstance(obj, torch.Tensor) else np.array(obj))
        return {"t": "arr", "k": k}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        items = [jaxrand.key_to_numpy(x)
                 if f == "key" and isinstance(x, torch.Tensor) else x
                 for f, x in zip(obj._fields, obj)]
        return {"t": "nt", "c": type(obj).__name__,
                "items": [_snap_encode(x, arrays) for x in items]}
    if isinstance(obj, tuple):
        return {"t": "tuple", "items": [_snap_encode(x, arrays)
                                        for x in obj]}
    if isinstance(obj, list):
        return {"t": "list", "items": [_snap_encode(x, arrays)
                                       for x in obj]}
    if isinstance(obj, dict):
        keys = list(obj.keys())
        if not all(isinstance(k, str) for k in keys):
            raise TypeError(f"snapshot dicts need str keys: {keys!r}")
        return {"t": "dict", "keys": keys,
                "items": [_snap_encode(obj[k], arrays) for k in keys]}
    k = f"a{len(arrays)}"
    arrays[k] = np.frombuffer(pickle.dumps(_host(obj)), dtype=np.uint8)
    return {"t": "pkl", "k": k}


def _snap_decode(spec: dict, arrays: Dict[str, np.ndarray]):
    t = spec["t"]
    if t == "none":
        return None
    if t == "v":
        return spec["v"]
    if t == "arr":
        return np.asarray(arrays[spec["k"]])
    if t == "pkl":
        return pickle.loads(bytes(np.asarray(arrays[spec["k"]])))
    if t == "nt":
        cls = _snap_class(spec["c"])
        return cls(*[_snap_decode(x, arrays) for x in spec["items"]])
    if t == "tuple":
        return tuple(_snap_decode(x, arrays) for x in spec["items"])
    if t == "list":
        return [_snap_decode(x, arrays) for x in spec["items"]]
    if t == "dict":
        return {k: _snap_decode(x, arrays)
                for k, x in zip(spec["keys"], spec["items"])}
    raise ValueError(f"unknown snapshot node type {t!r}")


def _tensors(tree, device):
    """A decoded tree's arrays as tensors of their own on ``device``
    (copies: the fused head training updates its state in place).  A
    uint32 array is a key: it comes back as the port's int64 words."""
    if isinstance(tree, np.ndarray):
        if tree.dtype == np.uint32:
            return jaxrand.key_from_numpy(tree, device)
        return torch.tensor(tree, device=device)
    if isinstance(tree, tuple):
        items = [_tensors(x, device) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(
            items)
    if isinstance(tree, list):
        return [_tensors(x, device) for x in tree]
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return tree


def write_snapshot_file(path: str, spec: dict,
                        arrays: Dict[str, np.ndarray],
                        prefix: str = ".tmp.snapshot.") -> str:
    """Write a snapshot's spec and arrays as one .npz at ``path``,
    atomically (tmp + fsync + ``os.replace``, the profile store's idiom):
    a crash mid-save leaves the previous file intact."""
    payload = dict(arrays)
    payload["meta"] = np.frombuffer(json.dumps(spec).encode("utf-8"),
                                    dtype=np.uint8)
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=prefix, suffix=".npz", dir=parent)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)                      # atomic commit
    except Exception:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    return path


def read_snapshot(snap):
    """(spec, arrays) of a snapshot given as a path or in memory."""
    if isinstance(snap, (str, os.PathLike)):
        with np.load(snap, allow_pickle=False) as data:
            spec = json.loads(bytes(data["meta"]).decode("utf-8"))
            arrays = {k: data[k] for k in data.files if k != "meta"}
        return spec, arrays
    return snap["spec"], snap["arrays"]


class StreamServer:
    """Admit / batch / gate / decide / evict over an autoscaling pool of
    stream slots."""

    _steps = counter_property("serving.steps")
    _hop_wall_s = counter_property("serving.hop_wall_s")
    _decisions = counter_property("serving.decisions")
    _speech_hops = counter_property("serving.hops", kind="speech")
    _gated_hops = counter_property("serving.hops", kind="gated")
    _learn_hops = counter_property("serving.hops", kind="learn")
    _rejected = counter_property("serving.rejected_streams")
    _shed_events = counter_property("serving.shed", what="events")
    _shed_samples = counter_property("serving.shed", what="samples")
    _calm_ticks = counter_property("serving.dynhop.calm_ticks")
    _pressure_ticks = counter_property("serving.autoscale.pressure_ticks")
    _idle_ticks = counter_property("serving.autoscale.idle_ticks")
    _hop_retargets = counter_property("serving.hop_retargets")
    _init_calls = counter_property("serving.batched_calls", cause="init")
    _hop_calls = counter_property("serving.batched_calls", cause="hop")
    _replay_calls = counter_property("serving.batched_calls",
                                     cause="replay")
    _gate_calls = counter_property("serving.batched_calls", cause="gate")
    # batched IMC forwards that ran (one fused launch per IMC layer each):
    # init, hop and replay calls, hop-retarget re-inits, and one per hop
    # of a recompute replay
    _imc_passes = counter_property("serving.imc_passes")
    _profile_swaps = counter_property("serving.profile_swaps")
    # compiled blocks and the ticks they served (serving.compiled)
    _compiled_blocks = counter_property("serving.compiled", what="blocks")
    _compiled_ticks = counter_property("serving.compiled", what="ticks")

    def __init__(self, hw, cfg: kws.KWSConfig, *, hop: int, slots: int = 4,
                 chip_offsets: Optional[Dict[str, torch.Tensor]] = None,
                 sa_noise_std: float = 0.0, use_kernel: bool = True,
                 streaming: bool = True,
                 decision: dec.DecisionConfig = dec.DecisionConfig(),
                 vad: Optional[vd.VADConfig] = None,
                 dynamic_hop: Optional[DynamicHopConfig] = None,
                 admission: Optional[AdmissionConfig] = None,
                 batch_init: bool = True,
                 faults=None, health=None, profiles=None,
                 silence_fill: str = "constant",
                 obs: Optional[ObsConfig] = None,
                 device_label: Optional[int] = None,
                 compiled=None,
                 seed: int = 0, device=None):
        if silence_fill not in ("constant", "retention"):
            raise ValueError(f"silence_fill={silence_fill!r}: use "
                             f"'constant' or 'retention'")
        self.device = resolve_device(device)
        # the registry backs every counter attribute: create it before the
        # first counter write below
        self._metrics = MetricsRegistry()
        self.obs = obs if obs is not None else ObsConfig.from_env()
        # ``device_label`` names this server's pool in a sharded
        # deployment (serving.shard): the launch auditor and the fleet
        # rollup attribute per-pool launches through it
        self.device_label = device_label
        self._rec = (FlightRecorder(self.obs.recorder)
                     if self.obs.recorder else None)
        self._audit = (LaunchAuditor(cfg.num_conv_layers - 1,
                                     mode=self.obs.audit,
                                     batch_init=batch_init,
                                     device=device_label)
                       if self.obs.audit != "off" else None)
        self.trace = TraceBuilder() if self.obs.trace else None
        self.cfg = cfg
        self.streaming = streaming
        self.base_hop = hop
        self.batch_init = batch_init
        self.dcfg = decision
        self.vcfg = vad
        self.hcfg = dynamic_hop
        self.acfg = admission
        self.seed = seed
        self.silence_fill = silence_fill
        self.min_slots = self.max_slots = slots
        if admission is not None:
            if admission.min_slots is not None:
                self.min_slots = admission.min_slots
            if admission.max_slots is not None:
                self.max_slots = admission.max_slots
            if not 1 <= self.min_slots <= slots <= self.max_slots:
                raise ValueError(
                    f"need 1 <= min_slots ({self.min_slots}) <= slots "
                    f"({slots}) <= max_slots ({self.max_slots})")
        self.slots = slots
        self._hw = hw
        self._engine_kw = dict(chip_offsets=chip_offsets,
                               sa_noise_std=sa_noise_std,
                               use_kernel=use_kernel, streaming=streaming,
                               device=self.device)
        # the hop-multiplier engine table: one engine per multiple of the
        # base hop, built at first use
        self._mult = 1
        self._engines: Dict[int, sv.StreamEngine] = {}
        self._uj_consts: Dict[int, tuple] = {}   # mult -> (speech, gated)
        # the per-stream noise-field keys are derived on the host, as the
        # reference does: fold_in(base_key, uid)
        self._base_key = jaxrand.PRNGKey(seed, device="cpu")
        self._fills = None
        if vad is not None and streaming:
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
        # the voice-activity detector runs on the host, where each hop's
        # audio arrives and the gating decision is taken: its exact level
        # (XLA's reduction order and log) is dozens of small operations,
        # which the card would run as as many launches and a read-back
        self._vstate = (vd.vad_init(slots, device="cpu")
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
        self._profiles = profiles         # checkpoint.ProfileStore or None

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
        self._rejected = 0
        self._shed_events = 0
        self._shed_samples = 0
        self._calm_ticks = 0
        self._pressure_ticks = 0
        self._idle_ticks = 0
        self._hop_retargets = 0
        # batched-compute accounting: each init/hop/replay call is one
        # fused-kernel launch per IMC layer however many slots ride it
        # (a recompute replay: one per hop); gate calls launch nothing
        self._init_calls = 0
        self._hop_calls = 0
        self._replay_calls = 0
        self._gate_calls = 0
        self._imc_passes = 0
        self._profile_swaps = 0
        self._compiled_blocks = 0
        self._compiled_ticks = 0
        # compiled ticks (serving.compiled): ``compiled=True`` (the
        # defaults) or a CompiledTickConfig serves steady-state ticks as
        # blocks; imported here, as compiled.py imports this module
        self._compiled = None
        if compiled:
            from repro_torch.serving.compiled import (CompiledTick,
                                                      CompiledTickConfig)
            ccfg = (compiled if isinstance(compiled, CompiledTickConfig)
                    else CompiledTickConfig())
            self._compiled = CompiledTick(self, ccfg)

        # -- faults and health monitoring ------------------------------------
        self._heal_delta = None           # {conv_i: (C_i,) float32} heal
        self._chip_delta = None           # {conv_i: (C_i,)} fault + heal on
        #                                   the host, None while pristine
        self._chip_delta_t = None         # the same on the device
        self._faults = None
        if faults is not None:
            from repro_torch.core import faults as flt
            self._faults = (faults if isinstance(faults, flt.FaultModel)
                            else flt.FaultModel.for_config(cfg, faults))
            # route every batched call through the rider variant up front
            # so fault deltas swap in without a mid-run mode change
            self._enable_customization()
            if self._faults.pop_dirty():
                self._refresh_chip_delta()
        self._health = None
        if health is not None:
            from repro_torch.serving import health as hl
            self._health = hl.HealthMonitor(self, health)

    # -- hop-multiplier engine table ----------------------------------------

    def _engine_for(self, mult: int) -> sv.StreamEngine:
        if mult not in self._engines:
            self._engines[mult] = sv.StreamEngine(
                self._hw, self.cfg, self.base_hop * mult, **self._engine_kw)
        return self._engines[mult]

    @property
    def engine(self) -> sv.StreamEngine:
        return self._engine_for(self._mult)

    @property
    def geom(self) -> sv.StreamGeometry:
        return self.engine.geom

    @property
    def hop(self) -> int:
        """The effective hop: base hop x the dynamic multiplier."""
        return self.base_hop * self._mult

    @property
    def hop_multiplier(self) -> int:
        return self._mult

    @property
    def metrics(self) -> MetricsRegistry:
        """The server's metrics registry (it backs ``stats()``)."""
        return self._metrics

    @property
    def recorder(self) -> Optional[FlightRecorder]:
        """The flight recorder (None unless ``obs.recorder > 0``)."""
        return self._rec

    @property
    def auditor(self) -> Optional[LaunchAuditor]:
        """The launch auditor (None unless ``obs.audit != 'off'``)."""
        return self._audit

    def _region(self, cause: str, passes: int = 1):
        """Launch-auditor region around one batched call site (a no-op
        context while the auditor is off)."""
        if self._audit is None:
            return contextlib.nullcontext()
        return self._audit.region(cause, passes)

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
        head_b), once customization is on; () for the base path.  The
        chip-global fault + heal delta rides every slot's bias-delta row:
        same operands, same launches."""
        if not self._cust_on:
            return ()
        delta = self._slot_delta
        chip = self._chip_delta_t
        if chip is not None:
            delta = {k: v + chip[k][None] for k, v in delta.items()}
        return (delta, self._slot_head_w, self._slot_head_b)

    def _row_custom(self, rec: "_Stream") -> tuple:
        """Rider args for a B=1 init (``batch_init`` off, hop-retarget
        re-inits): the stream's own customization plus the chip-global
        fault + heal delta, or () for the base init path."""
        chip = self._chip_delta_t
        if not self._cust_on or (rec.custom is None and chip is None):
            return ()
        dev = self.device
        if rec.custom is not None:
            delta = {name: kws.as_tensor(rec.custom["delta"][name], dev)
                     for name in self.cfg.imc_layer_names()}
            hw1 = kws.as_tensor(rec.custom["head"][0], dev)
            hb1 = kws.as_tensor(rec.custom["head"][1], dev)
        else:
            delta = {name: torch.zeros((self.cfg.channels[int(name[4:])],),
                                       device=dev)
                     for name in self.cfg.imc_layer_names()}
            hw1, hb1 = self._base_head()
        if chip is not None:
            delta = {k: v + chip[k] for k, v in delta.items()}
        return ({k: v[None] for k, v in delta.items()}, hw1[None],
                hb1[None])

    # -- fault injection + self-healing -------------------------------------

    @property
    def faults(self):
        """The live FaultModel (None unless built with ``faults=``).
        Inject through it between ticks: the next ``step()`` sees the
        dirty flag and refreshes the rider operands."""
        return self._faults

    @property
    def health(self):
        """The HealthMonitor (None unless built with ``health=``)."""
        return self._health

    def _refresh_chip_delta(self) -> None:
        """Rebuild the chip-global per-layer count delta: zeros + the
        injected faults + the heal, in float32 in that order.  None while
        the chip is pristine and unhealed, which keeps the rider rows at
        their base values."""
        fault = (self._faults.deltas()
                 if self._faults is not None and self._faults.active
                 else None)
        if fault is None and self._heal_delta is None:
            self._chip_delta = self._chip_delta_t = None
            return
        out = {}
        for name in self.cfg.imc_layer_names():
            v = np.zeros((self.cfg.channels[int(name[4:])],), np.float32)
            if fault is not None:
                v = v + fault[name]
            if self._heal_delta is not None and name in self._heal_delta:
                v = v + self._heal_delta[name]
            out[name] = v
        self._chip_delta = out
        self._chip_delta_t = {k: self._tensor(v) for k, v in out.items()}

    def _set_heal_delta(self, heal: Dict[str, np.ndarray]) -> None:
        """Swap a healing bias correction (per-layer pre-sign count deltas
        from the health monitor's recompensation) into every batched call.
        Entries replace any earlier heal of the same layer: recoveries
        start from the stored bias, so heals never stack."""
        self._enable_customization()
        cur = dict(self._heal_delta or {})
        cur.update({k: np.asarray(v, np.float32) for k, v in heal.items()})
        self._heal_delta = cur
        self._refresh_chip_delta()

    def customize(self, stream_id: str, ccfg=None):
        """Open an enrollment / fine-tuning session attached to a live
        stream (created empty if absent): labeled utterances submitted via
        ``session.enroll`` ride the stream's normal batched hops, then the
        paper's on-chip loop (bias compensation -> error-scaled + SGA
        fine-tune) runs as bounded background jobs inside ``step()``.  See
        ``serving.customize``.  Needs a fixed hop and the streaming path.
        Returns the CustomizationSession."""
        from repro_torch.serving import customize as cz
        if self.hcfg is not None:
            raise ValueError("customization requires a fixed hop "
                             "(dynamic_hop retargets would break the "
                             "enrollment capture alignment)")
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
                         custom: Optional[dict] = None,
                         uid: Optional[int] = None) -> "_Stream":
        """Enqueue a session-owned replay stream: it rides the normal slot
        machinery and the same batched launches but emits no decision
        events and never gates.  Finished on arrival: it retires once its
        audio drains (the session captures its features first).  ``uid``
        pins the stream's noise-field key to a reserved uid (the health
        canaries reuse one key, so every canary sees the same field)."""
        return self._new_stream(stream_id, np.asarray(wav, np.float32),
                                uid=uid, internal=True, force_compute=True,
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

    def submit(self, stream_id: str, chunk: np.ndarray,
               user_id: Optional[str] = None,
               uid: Optional[int] = None) -> str:
        """Append audio to a stream (created on first submit).  Returns the
        stream's placement: 'slot' (live), 'queued' (awaiting a slot) or
        'rejected' (admission queue full: nothing was buffered, the
        caller may retry later).

        ``user_id`` (needs ``profiles=``) ties the stream to a profile-store
        user: their stored customization is installed on the stream's
        riders, and the per-tick staleness sweep re-installs it when the
        store's copy changes (or resets to base when it is deleted).

        ``uid`` pins the stream's noise-field identity instead of taking
        the next submission number; the counter jumps past a pinned uid,
        so later streams never collide with it."""
        rec = self._streams.get(stream_id)
        if rec is None:
            if (self.acfg is not None and self.acfg.max_queue is not None
                    and all(r is not None for r in self._slots)
                    and len(self._queue) >= self.acfg.max_queue):
                self._rejected += 1
                if self._rec is not None:
                    self._rec.record(self._steps, "reject",
                                     stream=stream_id)
                return "rejected"
            rec = self._new_stream(stream_id, np.zeros((0,), np.float32),
                                   uid=uid)
        if rec.finished:
            raise ValueError(f"stream {stream_id} already finished")
        if user_id is not None and user_id != rec.user_id:
            if self._profiles is None:
                raise ValueError("submit(user_id=...) needs a profile "
                                 "store: construct with profiles=")
            self._attach_profile(rec, user_id)
        rec.buf = np.concatenate([rec.buf, np.asarray(chunk, np.float32)])
        return "slot" if rec.slot is not None else "queued"

    def _new_stream(self, stream_id: str, buf: np.ndarray,
                    uid: Optional[int] = None, **kw) -> _Stream:
        """Register a stream (the next uid, or a pinned one), queue it and
        admit it if a slot is free."""
        rec = _Stream(stream_id=stream_id,
                      uid=self._uid if uid is None else int(uid), buf=buf,
                      **kw)
        self._uid = (self._uid + 1 if uid is None
                     else max(self._uid, int(uid) + 1))
        self._streams[stream_id] = rec
        self._queue.append(rec)
        self._try_admit()
        return rec

    # -- profile store: install at admission + staleness sweep --------------

    def _attach_profile(self, rec: _Stream, user_id: str) -> None:
        """Tie ``rec`` to a store user and install their profile if one
        exists.  A user with no stored profile serves the base model but
        stays tied: the sweep picks up a later save."""
        rec.user_id = user_id
        rec.profile_mtime = None
        if self._profiles.mtime(user_id) is not None:
            self._install_profile(rec)

    def _install_profile(self, rec: _Stream) -> None:
        """(Re)load ``rec.user_id``'s stored profile into its riders.  The
        mtime is read before the load: a file replaced mid-install leaves
        a stale stamp, and the next sweep installs again."""
        from repro_torch.serving import customize as cz
        rec.profile_mtime = self._profiles.mtime(rec.user_id)
        result = self._profiles.load(rec.user_id)
        self._enable_customization()
        rec.custom = cz.result_riders(result, self.engine.hw, self.cfg,
                                      chip_offsets=self.engine.chip_offsets,
                                      with_fills=self._fills is not None)
        if rec.slot is not None:
            self._write_slot_custom(rec.slot, rec.custom)

    def _reset_profile(self, rec: _Stream) -> None:
        rec.custom = None
        rec.profile_mtime = None
        if rec.slot is not None:
            self._write_slot_custom(rec.slot, None)

    def _check_profiles(self) -> None:
        """The staleness sweep (once per tick): a stream whose stored
        profile changed under it (``st_mtime_ns`` moved: every save is a
        new inode) is re-installed from the new file; one whose profile
        was deleted drops back to the base model."""
        if self._profiles is None:
            return
        for rec in self._streams.values():
            if rec.user_id is None:
                continue
            m = self._profiles.mtime(rec.user_id)
            if m == rec.profile_mtime:
                continue
            self._profile_swaps += 1
            if m is None:
                self._reset_profile(rec)
            else:
                try:
                    self._install_profile(rec)
                except FileNotFoundError:  # deleted between stat and load
                    self._reset_profile(rec)

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
        if self._rec is not None:
            self._rec.record(self._steps, "evict", stream=rec.stream_id,
                             slot=s, internal=rec.internal)
        self._try_admit()

    def _try_admit(self) -> None:
        for s in range(self.slots):
            if self._slots[s] is None and self._queue:
                rec = self._queue.popleft()
                rec.slot = s
                rec.initialized = False
                self._slots[s] = rec
                self._write_slot_custom(s, rec.custom)

    # -- backpressure: latency SLO shedding + slot autoscaling --------------

    def _enforce_slo(self) -> None:
        """Shed streams whose buffered backlog exceeds the latency SLO:
        drop the oldest audio down to the low-water mark (half the SLO,
        never below one window) and re-initialize from the freshest
        window.  Learning streams (internal, forced) are exempt: shedding
        an enrollment utterance would corrupt the captured features."""
        if self.acfg is None or self.acfg.max_lag_s is None:
            return
        max_lag = int(self.acfg.max_lag_s * self.cfg.sample_rate)
        keep = max(self.geom.window, max_lag // 2)
        for rec in self._streams.values():
            if rec.finished or rec.internal or rec.force_compute:
                continue
            backlog = sum(map(len, rec.pending)) + len(rec.buf)
            if backlog <= max_lag:
                continue
            total = (np.concatenate(rec.pending + [rec.buf])
                     if rec.pending else rec.buf)
            dropped = backlog - keep
            rec.buf = total[-keep:]
            rec.pending = []
            rec.silent_run = 0
            rec.initialized = False
            rec.sheds += 1
            rec.shed_samples += dropped
            self._shed_events += 1
            self._shed_samples += dropped
            if self._rec is not None:
                self._rec.record(self._steps, "shed",
                                 stream=rec.stream_id, samples=dropped)

    def _autoscale(self) -> None:
        if self.acfg is None or self.max_slots <= self.min_slots:
            return
        if self._queue and self.slots < self.max_slots:
            self._idle_ticks = 0
            self._pressure_ticks += 1
            if self._pressure_ticks >= self.acfg.scale_up_after:
                self._resize(min(self.max_slots,
                                 self.slots + len(self._queue)))
                self._pressure_ticks = 0
            return
        self._pressure_ticks = 0
        free_tail = 0
        for rec in reversed(self._slots):
            if rec is not None:
                break
            free_tail += 1
        if free_tail and not self._queue and self.slots > self.min_slots:
            self._idle_ticks += 1
            if self._idle_ticks >= self.acfg.scale_down_after:
                self._resize(max(self.min_slots, self.slots - free_tail))
                self._idle_ticks = 0
        else:
            self._idle_ticks = 0

    def _resize(self, n: int) -> None:
        """Grow (append zero rows; base rider rows) or shrink (crop
        trailing free slots) the batched stream, decision and VAD state
        and the customization rider rows."""
        if n == self.slots:
            return
        if n > self.slots:
            grow = n - self.slots

            def pad(a):
                return torch.cat([a, a.new_zeros((grow,) + a.shape[1:])])

            def pad_rows(a, row):
                return torch.cat([a, row.expand((grow,) + row.shape)])

            self._state = _tree_map(pad, self._state)
            self._dstate = _tree_map(pad, self._dstate)
            if self._vstate is not None:
                self._vstate = _tree_map(pad, self._vstate)
            if self._cust_on:
                fw, fb = self._base_head()
                self._slot_delta = {k: pad(v)
                                    for k, v in self._slot_delta.items()}
                self._slot_head_w = pad_rows(self._slot_head_w, fw)
                self._slot_head_b = pad_rows(self._slot_head_b, fb)
                if self._slot_fills is not None:
                    self._slot_fills = tuple(
                        pad_rows(t, f) for t, f in zip(self._slot_fills,
                                                       self._fills))
            self._slots.extend([None] * grow)
        else:
            if any(r is not None for r in self._slots[n:]):
                raise AssertionError("only trailing free slots can be "
                                     "cropped")
            crop = lambda a: a[:n]
            self._state = _tree_map(crop, self._state)
            self._dstate = _tree_map(crop, self._dstate)
            if self._vstate is not None:
                self._vstate = _tree_map(crop, self._vstate)
            if self._cust_on:
                self._slot_delta = {k: crop(v)
                                    for k, v in self._slot_delta.items()}
                self._slot_head_w = crop(self._slot_head_w)
                self._slot_head_b = crop(self._slot_head_b)
                if self._slot_fills is not None:
                    self._slot_fills = tuple(crop(t)
                                             for t in self._slot_fills)
            self._slots = self._slots[:n]
        self.slots = n
        self._try_admit()

    # -- dynamic hop ----------------------------------------------------------

    def _feasible_mult(self, mult: int) -> bool:
        try:
            sv.make_stream_geometry(self.cfg, self.base_hop * mult)
            return True
        except ValueError:
            return False

    def _set_mult(self, mult: int) -> None:
        """Retarget the effective hop.  The stream geometry (carry sizes,
        fresh-column counts) depends on the hop, so every live slot's
        state is rebuilt from its last consumed window through ``init`` on
        the new multiplier's engine, with the slot's customization riders;
        deferred silent hops go back into the buffer, to be consumed at
        the new hop.  With SA noise a rebuilt stream's field restarts at
        window 0 (a re-init is a fresh programming of the array)."""
        if mult == self._mult:
            return
        eng = self._engine_for(mult)
        window = self.geom.window
        new_state = eng.zeros_state(self.slots)
        for s, rec in enumerate(self._slots):
            if rec is None or not rec.initialized:
                continue
            if rec.pending:
                rec.buf = np.concatenate(rec.pending + [rec.buf])
                rec.pending = []
            rec.silent_run = 0
            if len(rec.recent) >= window:
                t0 = time.perf_counter()
                _, one = eng.init(
                    self._tensor(rec.recent[None, -window:]),
                    self.stream_key(rec.uid)[None].to(self.device),
                    *self._row_custom(rec))
                new_state = _scatter_slot(new_state, one, s)
                self._sync()
                dt = time.perf_counter() - t0
                rec.wall_s += dt
                self._hop_wall_s += dt
                self._imc_passes += 1
            else:
                rec.initialized = False     # re-admit from the buffer
        self._state = new_state
        self._mult = mult
        self._hop_retargets += 1
        if self._rec is not None:
            self._rec.record(self._steps, "hop_retarget", mult=mult,
                             hop=self.base_hop * mult)

    def _retarget_hop(self, events: List[dict], woke: bool,
                      silent: bool = False) -> None:
        if self.hcfg is None:
            return
        max_score = max((e["score"] for e in events), default=0.0)
        if woke or max_score >= self.hcfg.calm_score:
            self._calm_ticks = 0
            if self._mult != 1:
                self._set_mult(1)
            return
        self._calm_ticks += 1
        after = self.hcfg.widen_after
        if silent and self.hcfg.calm_silence is not None:
            after = self.hcfg.calm_silence
        if self._calm_ticks >= after:
            self._calm_ticks = 0
            # clamped to the cap, so a max_multiplier that is no power of
            # two is still reached
            nxt = min(self._mult * 2, self.hcfg.max_multiplier)
            if nxt != self._mult and self._feasible_mult(nxt):
                self._set_mult(nxt)

    def _tick_uj(self, computed: int, gated: int) -> float:
        """Modelled uJ of one tick's hop composition at the current hop:
        a computed hop is charged the ungated per-decision energy, a gated
        fill the VAD and leakage only.  The two constants are computed once
        per hop multiplier."""
        consts = self._uj_consts.get(self._mult)
        if consts is None:
            g = energy.gated_energy_summary(
                kws.layer_stats(self.cfg),
                sv.streaming_layer_stats(self.cfg, self.geom),
                hop_samples=self.hop, duty_cycle=1.0)
            consts = (g["ungated_uj_per_decision"], g["idle_uj_per_hop"])
            self._uj_consts[self._mult] = consts
        return computed * consts[0] + gated * consts[1]

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
            rec.silent_run = 0
            self._dstate = dec.reset_slot(self._dstate, s)
            if self._vstate is not None:
                self._vstate = vd.vad_reset_slot(self._vstate, s)
            init_mask[s] = True
            if self._rec is not None:
                self._rec.record(self._steps, "admit",
                                 stream=rec.stream_id, slot=s,
                                 internal=rec.internal)

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
            with self._region("init"):
                logits, new_state = self.engine.init(
                    self._tensor(windows), keys.to(self.device),
                    *self._riders())
            self._state = _select_state(self._tensor(init_mask), new_state,
                                        self._state)
            logits = logits.cpu().numpy()
            dt = time.perf_counter() - t0
            self._hop_wall_s += dt
            self._init_calls += 1
            self._imc_passes += 1
            if self.trace is not None:
                self.trace.span("init", t0, t0 + dt, tick=self._steps,
                                slots=len(todo))
            for s, rec in todo:
                _book(rec, s, windows[s], dt / len(todo))
                init_logits[s] = logits[s]
            return init_mask, init_logits

        for s, rec in todo:
            first = rec.buf[:window]
            rec.buf = rec.buf[window:]
            t0 = time.perf_counter()
            with self._region("init"):
                logits, one = self.engine.init(
                    self._tensor(first[None]),
                    self.stream_key(rec.uid)[None].to(self.device),
                    *self._row_custom(rec))
            self._state = _scatter_slot(self._state, one, s)
            init_logits[s] = logits[0].cpu().numpy()
            dt = time.perf_counter() - t0
            self._hop_wall_s += dt
            self._init_calls += 1
            self._imc_passes += 1
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
        """One scheduler tick.  Returns this tick's decision events (one
        per deciding stream; gated hops emit none).  With ``compiled=`` a
        steady-state tick runs as a one-tick block (``serving.compiled``)
        and any other tick interpreted, with the same events, state and
        counters."""
        if self._compiled is not None and self._compiled.horizon(1) == 1:
            return self._compiled.run(1)
        return self._step_interpreted()

    def step_block(self, max_ticks: Optional[int] = None) -> List[dict]:
        """Serve up to ``max_ticks`` steady-state ticks as ONE compiled
        block and return their events in tick order: the events of as
        many ``step()`` calls.  The config's ``block`` caps the block (it
        sizes the graphs' static buffers), and the block ends early at
        any structural boundary (``CompiledTick.horizon``); a tick the
        block cannot model runs interpreted.  Without ``compiled=`` this
        is one interpreted ``step()``."""
        if self._compiled is None:
            return self._step_interpreted()
        cap = self._compiled.cfg.block
        k = self._compiled.horizon(cap if max_ticks is None
                                   else min(max_ticks, cap))
        if k < 1:
            return self._step_interpreted()
        return self._compiled.run(k)

    def _step_interpreted(self) -> List[dict]:
        """One interpreted tick: the profile sweep, the fault drift, SLO
        shedding and autoscaling, admissions, VAD classification, wake
        replays, ONE batched hop over every speech-ready slot, ONE masked
        no-op fill over every gated slot, the batched decision update, the
        session and canary captures, retirements, the hop retarget and the
        sessions' and health monitor's background work, then the tick's
        telemetry.  The compiled block is held against it."""
        tick = self._steps
        t_tick = time.perf_counter()
        if self._audit is not None:
            self._audit.begin_tick(tick)
        self._check_profiles()
        if self._faults is not None:
            self._faults.tick()                 # advance the offset drift
            if self._faults.pop_dirty():
                self._refresh_chip_delta()      # riders take the new deltas
        self._enforce_slo()
        self._autoscale()
        eng = self.engine
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
                                           torch.from_numpy(audio),
                                           torch.from_numpy(ready))
            speech = sp.numpy() & ready
            for s, rec in enumerate(self._slots):
                # enrollment and replay hops must run the real IMC path:
                # a gated hop would corrupt the captured feature buffer
                if ready[s] and rec is not None and rec.force_compute:
                    speech[s] = True
        # a tick is silent when hops ran and none carried speech: the
        # dynamic hop may widen faster on these
        silent_tick = bool(ready.any()) and not bool((speech & ready).any())

        compute_mask = np.zeros((self.slots,), bool)
        fill_mask = np.zeros((self.slots,), bool)
        replays: List[tuple] = []
        for s, rec in enumerate(self._slots):
            if not ready[s]:
                continue
            if speech[s]:
                rec.silent_run = 0
                if rec.pending:           # wake: replay the deferred hops
                    replays.append((s, rec.pending + [audio[s]]))
                    rec.pending = []
                else:
                    compute_mask[s] = True
            else:
                rec.silent_run += 1
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
        # multi-hop launch per IMC layer for this slot (one per hop on the
        # recompute path)
        for s, chunks in replays:
            rec = self._slots[s]
            n = len(chunks)
            mask = np.zeros((self.slots,), bool)
            mask[s] = True
            mask_t = self._tensor(mask)
            a = np.zeros((self.slots, n * hop), np.float32)
            a[s] = np.concatenate(chunks)
            t0 = time.perf_counter()
            with self._region("replay", 1 if self.streaming else n):
                lg, new_state = eng.multi_step(self._state,
                                               self._tensor(a), n,
                                               *self._riders())
            self._state = _select_state(mask_t, new_state, self._state)
            self._replay_calls += 1
            self._imc_passes += 1 if self.streaming else n
            outs = []
            for j in range(n):
                self._dstate, out = dec.decision_step(
                    self.dcfg, self._dstate, lg[:, j], mask_t)
                outs.append(out)
            outs = [dec.DecisionOut(*(t.cpu() for t in out)) for out in outs]
            dt = time.perf_counter() - t0
            rec.wall_s += dt
            self._hop_wall_s += dt
            if self.trace is not None:
                self.trace.span("replay", t0, t0 + dt, tick=tick,
                                stream=rec.stream_id, hops=n)
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
            with self._region("hop"):
                hop_logits, new_state = eng.step(
                    self._state, self._tensor(audio), *self._riders())
            self._state = _select_state(self._tensor(compute_mask),
                                        new_state, self._state)
            hop_logits = hop_logits.cpu().numpy()
            dt = time.perf_counter() - t0
            self._hop_wall_s += dt
            self._hop_calls += 1
            self._imc_passes += 1
            n_active = int(compute_mask.sum())
            if self.trace is not None:
                self.trace.span("hop", t0, t0 + dt, tick=tick,
                                slots=n_active)
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
            with self._region("gate"):
                if self.streaming:
                    fills = (self._slot_fills
                             if self._slot_fills is not None
                             else self._fills)
                    new_state = sv.gated_step(self._state, self.cfg,
                                              self.geom, fills)
                else:
                    new_state = sv.gated_window_step(self._state, self.geom)
                self._state = _select_state(self._tensor(fill_mask),
                                            new_state, self._state)
                self._sync()
            dt = time.perf_counter() - t0
            self._hop_wall_s += dt
            self._gate_calls += 1
            if self.trace is not None:
                self.trace.span("gate", t0, t0 + dt, tick=tick,
                                slots=int(fill_mask.sum()))

        internal = np.asarray([rec is not None and rec.internal
                               for rec in self._slots])
        decide_mask = (init_mask | compute_mask) & ~internal
        if decide_mask.any():
            t0 = time.perf_counter()
            self._dstate, out = dec.decision_step(
                self.dcfg, self._dstate, self._tensor(logits),
                self._tensor(decide_mask))
            self._decisions += int(decide_mask.sum())
            out = dec.DecisionOut(*(t.cpu() for t in out))
            if self.trace is not None:
                self.trace.span("decide", t0, time.perf_counter(),
                                tick=tick, slots=int(decide_mask.sum()))
            for s, rec in enumerate(self._slots):
                if rec is not None and decide_mask[s]:
                    events.append(self._event(rec, s, out))

        # feature captures must see the post-hop states before slots retire
        t_riders = time.perf_counter() if self.trace is not None else 0.0
        if self._cust is not None:
            self._cust.on_step(self)
        if self._health is not None:
            self._health.on_step(self)          # canary carry/ring capture
            # decisions made while the chip is not healthy are flagged
            degraded = self._health.state != "healthy"
            for ev in events:
                ev["degraded"] = degraded

        # retire drained finished streams
        for rec in list(self._slots):
            if (rec is not None and rec.finished
                    and len(rec.buf) < (hop if rec.initialized
                                        else window)):
                self._free_slot(rec)
        self._steps += 1
        self._retarget_hop(events, woke=bool(replays), silent=silent_tick)
        # background learning jobs: calibration layers, feature-replay
        # spawns, bounded fine-tune rounds, hot swaps
        if self._cust is not None:
            self._cust.tick(self)
        # health background work: recompensation, then canary spawns
        if self._health is not None:
            self._health.tick(self)

        # -- per-tick telemetry: composition, modelled uJ, spans -----------
        computed = (int(init_mask.sum()) + int(compute_mask.sum())
                    + sum(len(chunks) for _, chunks in replays))
        gated = int(fill_mask.sum())
        if self._rec is not None or self.trace is not None:
            uj = self._tick_uj(computed, gated)
            if self._rec is not None and (computed or gated or events):
                self._rec.record(tick, "tick",
                                 init=int(init_mask.sum()),
                                 computed=computed, gated=gated,
                                 replays=len(replays),
                                 decisions=len(events), uj=round(uj, 4))
                self._metrics.observe("serving.tick_uj", uj)
            if self.trace is not None:
                now = time.perf_counter()
                self.trace.span("riders", t_riders, now, tick=tick)
                self.trace.span("tick", t_tick, now, tick=tick,
                                computed=computed, gated=gated,
                                decisions=len(events), uj=round(uj, 4))
        if self._audit is not None:
            self._audit.end_tick()
        return events

    def drain(self, max_steps: int = 10_000) -> List[dict]:
        """Step until a tick moves no buffer and leaves the queue as it
        was.  With ``compiled=`` it steps in blocks and applies that rule
        to each block's last tick (the only tick of a block whose buffers
        can stay put: a widening hop retarget pushes the deferred hops
        back), so it stops after the same tick as one-tick stepping."""
        events: List[dict] = []
        for _ in range(max_steps):
            before = self._drain_view()
            events.extend(self._drain_step())
            if self._drain_view() == self._tick_start_view(before):
                break
        return events

    def _drain_view(self) -> tuple:
        return (len(self._queue),
                [None if r is None else len(r.buf) for r in self._slots])

    def _drain_step(self) -> List[dict]:
        """One step of ``drain()``: a tick, or a block with ``compiled=``."""
        if self._compiled is None:
            return self.step()
        self._compiled.last_view = None
        return self.step_block()

    def _tick_start_view(self, before: tuple) -> tuple:
        """The drain view at the start of the last tick ``_drain_step``
        served: ``before`` unless that step was a compiled block."""
        if self._compiled is not None and \
                self._compiled.last_view is not None:
            return self._compiled.last_view
        return before

    # -- crash-safe snapshots -------------------------------------------------

    def snapshot(self, path: Optional[str] = None):
        """Serialize the complete serving state (slot carries and GAP
        rings, decision and VAD state, per-stream buffers and noise-field
        keys, the queue order, the registry and the recorder, the fault
        and health state, the healing delta and every mid-flight
        customization session), so that a restarted process can
        ``restore()`` it and continue **bit-identically** to an
        uninterrupted run.

        Take snapshots between ``step()`` calls, the only consistent cut.
        With ``path`` the snapshot is written as one .npz, atomically
        (``write_snapshot_file``); without it the in-memory snapshot
        ``{"spec": ..., "arrays": ...}`` is returned.  Either holds numpy
        arrays and plain data only: it restores on any device."""
        arrays: Dict[str, np.ndarray] = {}
        spec = {
            "version": 2,
            "config": {"sample_len": self.cfg.sample_len,
                       "base_hop": self.base_hop,
                       "streaming": self.streaming,
                       "sa_noise_std": float(
                           self._engine_kw["sa_noise_std"]),
                       "vad": self.vcfg is not None},
            "slots_n": self.slots,
            "mult": self._mult,
            "uid": self._uid,
            "base_key": _snap_encode(jaxrand.key_to_numpy(self._base_key),
                                     arrays),
            "state": _snap_encode(self._state, arrays),
            "dstate": _snap_encode(self._dstate, arrays),
            "vstate": _snap_encode(self._vstate, arrays),
            "streams": {sid: _snap_encode(dict(vars(rec)), arrays)
                        for sid, rec in self._streams.items()},
            "queue": [rec.stream_id for rec in self._queue],
            "slot_ids": [None if rec is None else rec.stream_id
                         for rec in self._slots],
            # v2: the whole metrics registry rides along, so every counter
            # (serving, health, customization) round-trips
            "counters": self._metrics.snapshot(),
            "recorder": (self._rec.snapshot()
                         if self._rec is not None else None),
            "cust_on": self._cust_on,
            "heal": _snap_encode(self._heal_delta, arrays),
            "faults": _snap_encode(
                self._faults.snapshot() if self._faults is not None
                else None, arrays),
            "health": _snap_encode(
                self._health.snapshot() if self._health is not None
                else None, arrays),
            "cust": self._snap_sessions(arrays),
        }
        if path is None:
            return {"spec": spec, "arrays": arrays}
        return write_snapshot_file(path, spec, arrays)

    # the back-reference, and the labels' tensor (rebuilt from ``labels``)
    _SESS_SKIP = ("_mgr", "_labels_t")

    def _snap_sessions(self, arrays):
        if self._cust is None:
            return None
        sessions = []
        for sess in self._cust.sessions:
            d = {k: v for k, v in vars(sess).items()
                 if k not in self._SESS_SKIP}
            if d["_calib_keys"] is not None:
                d["_calib_keys"] = {k: jaxrand.key_to_numpy(v)
                                    for k, v in d["_calib_keys"].items()}
            sessions.append(_snap_encode(d, arrays))
        return {"next_sid": self._cust._next_sid, "sessions": sessions}

    def restore(self, snap) -> None:
        """Restore a snapshot (a path or an in-memory snapshot) into THIS
        server, which must be freshly built with the same configuration:
        model, hop, slot bounds, noise std and chip offsets, the decision,
        VAD and admission configs and the same ``faults=`` / ``health=``
        / ``profiles=`` wiring (the snapshot stores serving *state*; the
        configuration is code).  The server may live on another device
        than the one that took the snapshot.  It then continues
        bit-identically to the uninterrupted original, SA-noise fields
        and in-flight enrollment sessions included."""
        spec, arrays = read_snapshot(snap)
        if spec.get("version") not in (1, 2):
            raise ValueError(f"unknown snapshot version: "
                             f"{spec.get('version')!r}")
        c = spec["config"]
        if (c["sample_len"] != self.cfg.sample_len
                or c["base_hop"] != self.base_hop
                or bool(c["streaming"]) != self.streaming
                or bool(c["vad"]) != (self.vcfg is not None)):
            raise ValueError(f"snapshot/server configuration mismatch: "
                             f"snapshot has {c}")
        n = int(spec["slots_n"])
        if not self.min_slots <= n <= self.max_slots:
            raise ValueError(f"snapshot slot count {n} outside this "
                             f"server's [{self.min_slots}, "
                             f"{self.max_slots}]")
        dev = self.device
        self.slots = n
        self._mult = int(spec["mult"])
        self._engine_for(self._mult)              # the engine for this hop
        self._uid = int(spec["uid"])
        self._base_key = jaxrand.key_from_numpy(
            _snap_decode(spec["base_key"], arrays), "cpu")
        # carries and decision state on this server's device; the VAD
        # state stays on the host, where the server runs it
        self._state = _tensors(_snap_decode(spec["state"], arrays), dev)
        self._dstate = _tensors(_snap_decode(spec["dstate"], arrays), dev)
        v = _snap_decode(spec["vstate"], arrays)
        self._vstate = _tensors(v, "cpu") if v is not None else None
        self._streams = {}
        for sid, s_spec in spec["streams"].items():
            self._streams[sid] = _Stream(**_snap_decode(s_spec, arrays))
        self._queue = collections.deque(self._streams[sid]
                                        for sid in spec["queue"])
        self._slots = [None if sid is None else self._streams[sid]
                       for sid in spec["slot_ids"]]
        counters = spec["counters"]
        if spec["version"] >= 2:
            self._metrics.restore(counters)
        else:                       # v1: a per-attribute dict; the setattrs
            for k, val in counters.items():   # write through the registry
                setattr(self, k, val)         # properties
        if spec.get("recorder") is not None and self._rec is not None:
            self._rec.restore(spec["recorder"])
        # the riders are rebuilt at the restored slot count: per-slot rows
        # from each stream's ``custom``, the chip-global row from the heal
        # and the fault state
        self._cust_on = False
        self._slot_delta = None
        self._slot_head_w = None
        self._slot_head_b = None
        self._slot_fills = None
        self._heal_delta = _snap_decode(spec["heal"], arrays)
        f = _snap_decode(spec["faults"], arrays)
        if (f is None) != (self._faults is None):
            raise ValueError("snapshot fault-model mismatch: construct "
                             "the server with the same faults= wiring")
        if f is not None:
            self._faults.restore(f)
            self._faults.pop_dirty()
        h = _snap_decode(spec["health"], arrays)
        if (h is None) != (self._health is None):
            raise ValueError("snapshot health mismatch: construct the "
                             "server with the same health= wiring")
        if h is not None:
            self._health.restore(h)
        if spec["cust_on"]:
            self._enable_customization()
        self._refresh_chip_delta()
        cust = spec["cust"]
        if cust is None:
            self._cust = None
            return
        from repro_torch.serving import customize as cz
        self._cust = cz.CustomizationManager(self)
        self._cust._next_sid = int(cust["next_sid"])
        for s_spec in cust["sessions"]:
            d = _snap_decode(s_spec, arrays)
            sess = cz.CustomizationSession.__new__(cz.CustomizationSession)
            sess._mgr = self._cust
            for k, val in d.items():
                setattr(sess, k, val)
            # the device-side working set; the feature origins' keys and
            # the recorded windows stay on the host, as the session keeps
            # them
            for k in ("features", "_ideal", "_calib_keys", "_new_bias",
                      "_head", "_featsq", "_onehot"):
                setattr(sess, k, _tensors(getattr(sess, k), dev))
            sess._labels_t = (torch.tensor(sess.labels, device=dev)
                              if sess._head is not None else None)
            self._cust.sessions.append(sess)

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
            "mode": "streaming" if self.streaming else "recompute",
            "device": str(self.device),
            "device_label": self.device_label,
            "silence_fill": self.silence_fill,
            "slots": self.slots,
            "slot_range": [self.min_slots, self.max_slots],
            "queue_depth": len(self._queue),
            "rejected_streams": self._rejected,
            "shed": {"events": self._shed_events,
                     "samples": self._shed_samples},
            "steps": self._steps,
            "decisions": self._decisions,
            "base_hop": self.base_hop,
            "hop": self.hop,
            "hop_multiplier": self._mult,
            "hop_retargets": self._hop_retargets,
            "speech_hops": self._speech_hops,
            "gated_hops": self._gated_hops,
            "learn_hops": self._learn_hops,
            "batched_calls": {
                "init": self._init_calls,
                "hop": self._hop_calls,
                "replay": self._replay_calls,
                "gate": self._gate_calls,
            },
            # batched IMC forwards run: one fused-kernel launch per IMC
            # layer each (retarget re-inits and recompute replay hops
            # included)
            "imc_passes": self._imc_passes,
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
                                "sheds": rec.sheds,
                                "wall_s": round(rec.wall_s, 4)}
                for rec in self._streams.values() if not rec.internal
            },
        }
        out["obs"] = {"metrics": len(self._metrics._cells)}
        if self._rec is not None:
            out["obs"]["recorder"] = {"events": len(self._rec),
                                      "capacity": self._rec.capacity,
                                      "dropped": self._rec.dropped()}
        if self._audit is not None:
            out["obs"]["audit"] = self._audit.stats()
        if self._profiles is not None:
            out["profile_swaps"] = self._profile_swaps
        if self._compiled is not None:
            out["compiled"] = {"block": self._compiled.cfg.block,
                               "blocks": self._compiled_blocks,
                               "ticks": self._compiled_ticks}
        if self._cust is not None:
            out["customization"] = self._cust.stats()
        if self._faults is not None:
            out["faults"] = self._faults.stats()
        if self._health is not None:
            out["health"] = self._health.stats()
        if self.vcfg is not None:
            out["gated_energy"] = {
                k: round(v, 4) if isinstance(v, float) else v
                for k, v in energy.gated_energy_summary(
                    offline, streaming, hop_samples=self.hop,
                    duty_cycle=duty if duty is not None else 1.0).items()
            }
        return out
