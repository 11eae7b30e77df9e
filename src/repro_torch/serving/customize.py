"""On-device customization as a serving workload (paper §III, §V-C).

Port of ``repro/serving/customize.py``.  A ``CustomizationSession``
attaches to a live stream of ``StreamServer`` and walks the paper's
pipeline as scheduler-ticked background jobs:

1. **enrollment** — labeled user utterances are submitted into the
   attached stream and ride its normal batched hops; at each utterance's
   completion hop the session captures the GAP feature vector straight
   from the stream's ring (the §V-C SRAM feature buffer), with no extra
   forward pass;
2. **calibration / bias compensation** (§IV-B) — the chip's test mode over
   the recorded utterances, a bounded number of layers per tick
   (``training.kws.calibration_ideal_counts`` /
   ``compensate_layer_bias``, the pieces the offline driver runs);
3. **feature re-extraction** — the compensated biases change the
   features, so the recorded windows replay as *internal streams* through
   the scheduler, in the same batched launches as the inference streams
   (their bias deltas ride the per-slot pre-sign operand);
4. **fine-tuning** (§III) — the quantized last-layer loop (error scaling
   + SGA), a bounded number of epochs per tick.  Every tick runs the
   whole budget of all its training sessions that share a configuration
   in ONE launch of the fused head-training kernel
   (``kernels.sga_update.ops.head_train_batch``: each session row its own
   epochs from its own point of the schedule).  Sessions that draw RGP
   noise, or lie outside the kernel's exactness bound
   (``core.onchip_training.fused_head_route``), run epoch by epoch, the
   optimizer transitions of each round stacked into one launch of the
   ``sga_update`` kernel (``sga_update_batch``, a learning rate per row);
5. **hot swap** — the finished profile (compensated biases + fine-tuned
   head) is written into the attached stream's per-slot rider rows (bias
   delta, FC head, silence fill); other slots are untouched.

**Equivalence contract** (held by the tests against the JAX package and
by ``chip_smoke.py`` on the card): the session's compensated biases and
fine-tuned (w, b) are bit-identical to the offline loop on the same
recorded utterances (``calibrate_and_compensate`` -> ``hw_features`` ->
``quantized_head_finetune``), SA noise included: the calibration read
noise comes from ``calibration_layer_keys(calib_seed)`` in both, and on
a noisy server every captured feature records its stream's noise-field
key and window (``feature_noise_field()``), which the offline
``hw_features(sa_noise_field=...)`` evaluates.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import energy, jaxrand, means
from repro_torch.core.onchip_training import (HeadState, OnChipTrainConfig,
                                              apply_update, epoch_grads,
                                              finetune_init,
                                              fused_head_route,
                                              head_accuracy, head_train_spec,
                                              sga_threshold, train_lut)
from repro_torch.core.quantize import ACT_Q
from repro_torch.core.sa_noise import SANoiseField
from repro_torch.kernels.sga_update import ops as sga_ops
from repro_torch.models import kws
from repro_torch.serving import stream as sv
from repro_torch.training import kws as tr


@dataclasses.dataclass(frozen=True)
class CustomizeConfig:
    """Knobs of one enrollment session.

    ``train`` is the on-chip loop config; the default uses the chip's
    fixed 1.375 error-scaling factor (§V-C).  ``epochs_per_tick`` /
    ``layers_per_tick`` bound the work one scheduler tick may spend on
    this session; ``compensate`` runs the §IV-B test-mode bias
    compensation before fine-tuning (off: fine-tune on the enrollment
    features); ``calib_sa_noise_std``/``calib_seed`` are the test mode's
    read-noise std and key chain seed; ``use_kernel`` routes the tick's
    epochs through the kernels, the fused head training or the batched
    ``sga_update`` (off: ``epoch_grads`` and the plain ``apply_update``,
    bit-identical); ``auto_swap`` hot-swaps the result into the attached
    stream the tick fine-tuning finishes."""

    train: OnChipTrainConfig = OnChipTrainConfig(epochs=200,
                                                 fixed_error_scale=1.375)
    epochs_per_tick: int = 10
    layers_per_tick: int = 2
    compensate: bool = True
    calib_sa_noise_std: float = 1.0
    calib_seed: int = 0
    use_kernel: bool = True
    auto_swap: bool = True

    def __post_init__(self):
        if self.epochs_per_tick < 1 or self.layers_per_tick < 1:
            raise ValueError("epochs_per_tick and layers_per_tick must "
                             "be >= 1")


@dataclasses.dataclass
class CustomizationResult:
    """A finished user profile: full compensated integer biases for the
    IMC layers, the fine-tuned Q1.7 head, and the run's accounting."""

    bias: Dict[str, np.ndarray]
    fc_w: np.ndarray
    fc_b: np.ndarray
    epochs: int
    n_utterances: int
    history: List[dict]
    energy: dict


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def capture_features(ring: torch.Tensor) -> torch.Tensor:
    """One feature capture from a slot's GAP ring (T, D): the quantized
    mean over T, ``jnp.mean`` as compiled (see ``models.kws.gap_fc``)."""
    return ACT_Q.quantize(means.mean(ring, 0))


def result_riders(result: CustomizationResult, hw, cfg: kws.KWSConfig,
                  chip_offsets=None, with_fills: bool = False) -> dict:
    """Translate a result into the scheduler's per-slot riders: integer
    bias deltas against the base chip, the replacement head, and (for
    gated servers) the compensated net's silence-fill columns."""
    hwp, _ = kws.as_hw_params(hw)
    delta = {name: np.asarray(result.bias[name], np.float32)
             - _np(hwp.bias[name])
             for name in cfg.imc_layer_names()}
    out = {"delta": delta,
           "head": (np.asarray(result.fc_w), np.asarray(result.fc_b)),
           "fills": None}
    if with_fills:
        hw_c = refold(result, hw, cfg, pack=False)
        sils = kws.silence_columns(hw_c, cfg, chip_offsets=chip_offsets)
        out["fills"] = tuple(_np(f) for f in sv.silence_fills(cfg, sils))
    return out


def refold(result: CustomizationResult, hw, cfg: kws.KWSConfig,
           pack: bool = True):
    """The customized model as ordinary (Packed)HWParams on the device of
    ``hw``: base binary weights, compensated biases, fine-tuned head —
    what a dedicated server would serve, and what the hot-swapped slot
    must match bit for bit."""
    hwp, _ = kws.as_hw_params(hw)
    dev = kws.hw_device(hwp)
    bias = dict(hwp.bias)
    for name in cfg.imc_layer_names():
        bias[name] = kws.as_tensor(result.bias[name], dev)
    out = hwp._replace(bias=bias, fc_w=kws.as_tensor(result.fc_w, dev),
                       fc_b=kws.as_tensor(result.fc_b, dev))
    return kws.pack_hw_params(out, cfg) if pack else out


class CustomizationSession:
    """One user's enrollment / fine-tuning session (made by
    ``StreamServer.customize``).  Call ``enroll`` for each labeled
    utterance, then ``finish_enrollment()``; the server's ``step()`` loop
    does the rest.  ``phase`` walks enrolling -> calibrating -> extracting
    -> training -> ready -> swapped (compensation off skips calibrating
    and extracting)."""

    def __init__(self, manager: "CustomizationManager", sid: int,
                 stream_id: str, ccfg: CustomizeConfig):
        self._mgr = manager
        self.sid = sid
        self.stream_id = stream_id
        self.ccfg = ccfg
        self.phase = "enrolling"
        self.windows: List[np.ndarray] = []      # recorded utterance windows
        self.labels: List[int] = []
        self.features: List[Optional[torch.Tensor]] = []
        # per-feature noise-field origin: {"key": (2,) uint32, "hop":
        # window index}: which stream, at which window, made the capture
        self.feature_origins: List[Optional[dict]] = []
        self.history: List[dict] = []
        self.result: Optional[CustomizationResult] = None
        self._enroll_done = False
        self._captures: List[dict] = []
        self._total = 0                          # stream sample position
        self._ideal = None                       # calibration state
        self._calib_keys = None
        self._new_bias = None
        self._calib_idx = 0
        self._replays_spawned = False
        self._head: Optional[HeadState] = None   # fine-tune state
        self._featsq = None
        self._onehot = None
        self._labels_t = None
        self._epoch = 0

    # -- enrollment ---------------------------------------------------------

    def enroll(self, label: int, utterance: np.ndarray) -> None:
        """Submit one labeled utterance (exactly one decision window of
        audio) into the attached stream, pre-padded with silence so its
        last sample lands on a hop boundary: the stream window at the
        completion hop IS the utterance."""
        if self.phase != "enrolling":
            raise ValueError(f"session is {self.phase}, not enrolling")
        srv = self._mgr.srv
        window = srv.geom.window
        utterance = np.asarray(utterance, np.float32)
        if utterance.shape != (window,):
            raise ValueError(f"utterance must be one window "
                             f"({window} samples), got {utterance.shape}")
        hop = srv.geom.hop
        pad = (-self._total) % hop
        wav = (np.concatenate([np.zeros((pad,), np.float32), utterance])
               if pad else utterance)
        srv.submit(self.stream_id, wav)
        self._total += pad + window
        self.windows.append(utterance.copy())
        self.labels.append(int(label))
        self.features.append(None)
        self.feature_origins.append(None)
        self._captures.append({"stream": self.stream_id,
                               "target": self._total,
                               "index": len(self.windows) - 1,
                               "kind": "enroll"})

    def finish_enrollment(self) -> None:
        if not self.windows:
            raise ValueError("enroll at least one utterance first")
        self._enroll_done = True

    # -- results ------------------------------------------------------------

    @property
    def done(self) -> bool:
        return self.phase in ("ready", "swapped")

    def refolded(self, pack: bool = True):
        if self.result is None:
            raise ValueError("session not finished")
        return refold(self.result, self._mgr.srv.engine.hw,
                      self._mgr.srv.cfg, pack=pack)

    def feature_noise_field(self, device=None) -> Optional[SANoiseField]:
        """The SA-noise field the feature buffer was captured under: row n
        is feature n's (stream key, window index), on ``device`` (``None``:
        the server's).  Fed to ``training.kws.hw_features(sa_noise_field=
        ...)`` it reproduces the captured features bit for bit.  ``None``
        when the server runs noise-free."""
        srv = self._mgr.srv
        std = srv.engine.sa_noise_std
        if not std:
            return None
        if any(o is None for o in self.feature_origins):
            raise ValueError("feature buffer not fully captured yet "
                             f"(phase {self.phase})")
        dev = srv.device if device is None else device
        return SANoiseField(
            keys=jaxrand.key_from_numpy(np.stack(
                [o["key"] for o in self.feature_origins]), dev),
            hops=torch.tensor([o["hop"] for o in self.feature_origins],
                              dtype=torch.int32, device=dev),
            std=float(std), hop=int(srv.geom.hop))


class CustomizationManager:
    """Per-server registry of sessions and the background-job engine the
    scheduler ticks (captures, calibration chunks, replay spawns, batched
    fine-tune rounds, hot swaps)."""

    def __init__(self, srv):
        if not srv.streaming:
            raise ValueError("customization requires streaming=True (the "
                             "feature captures read the GAP ring)")
        self.srv = srv
        self.sessions: List[CustomizationSession] = []
        self._next_sid = 0

    # -- session lifecycle --------------------------------------------------

    def start(self, stream_id: str,
              ccfg: Optional[CustomizeConfig]) -> CustomizationSession:
        ccfg = ccfg or CustomizeConfig()
        for s in self.sessions:
            if s.stream_id == stream_id and not s.done:
                raise ValueError(f"stream {stream_id} already has an "
                                 f"active session ({s.phase})")
        srv = self.srv
        rec = srv._streams.get(stream_id)
        if rec is None:
            if srv.submit(stream_id, np.zeros((0,), np.float32)) \
                    == "rejected":
                raise RuntimeError(
                    f"cannot open a session for {stream_id}: the "
                    f"admission queue is full (backpressure); retry "
                    f"when a slot frees")
            rec = srv._streams[stream_id]
        rec.force_compute = True           # enrollment hops never gate
        sess = CustomizationSession(self, self._next_sid, stream_id, ccfg)
        sess._total = rec.consumed + len(rec.buf) + sum(
            map(len, rec.pending))
        self._next_sid += 1
        self.sessions.append(sess)
        srv._metrics.inc("customize.sessions")
        if srv._rec is not None:
            srv._rec.record(srv._steps, "session", stream=stream_id,
                            sid=sess.sid, phase="enrolling")
        return sess

    # -- per-tick hooks (called by StreamServer.step) -----------------------

    def on_step(self, srv) -> None:
        """Feature captures: runs right after the batched hop, before
        slots retire, so the GAP ring still holds the completion window's
        activations."""
        for sess in self.sessions:
            for cap in list(sess._captures):
                rec = srv._streams.get(cap["stream"])
                if (rec is None or rec.slot is None or not rec.initialized
                        or rec.consumed < cap["target"]):
                    continue
                if rec.consumed > cap["target"]:
                    raise RuntimeError(
                        f"capture overshoot on {cap['stream']}: consumed "
                        f"{rec.consumed} > target {cap['target']}")
                sess.features[cap["index"]] = capture_features(
                    srv._state.ring[rec.slot])
                # the capture's noise-field coordinates: the stream's key
                # and the completion window's index
                sess.feature_origins[cap["index"]] = {
                    "key": jaxrand.key_to_numpy(srv.stream_key(rec.uid)),
                    "hop": (cap["target"] - srv.geom.window)
                    // srv.geom.hop,
                }
                if cap["kind"] == "enroll":
                    sess.windows[cap["index"]] = rec.recent.copy()
                else:                      # replay stream: single-use
                    srv._drop_internal(cap["stream"])
                sess._captures.remove(cap)

    def tick(self, srv) -> None:
        """Advance every session by a bounded amount of background work."""
        for sess in self.sessions:
            if sess.phase == "enrolling":
                if sess._enroll_done and not sess._captures:
                    if sess.ccfg.compensate:
                        sess.phase = "calibrating"
                    else:
                        self._start_training(sess, base_bias=True)
            elif sess.phase == "calibrating":
                self._calibrate_chunk(sess)
            elif sess.phase == "extracting":
                self._extract(sess)
        self._train_round()
        for sess in self.sessions:
            if sess.phase == "ready" and sess.ccfg.auto_swap:
                self.swap(sess)

    # -- calibration / bias compensation ------------------------------------

    def _calibrate_chunk(self, sess: CustomizationSession) -> None:
        srv, cfg = self.srv, self.srv.cfg
        hwp, _ = kws.as_hw_params(srv.engine.hw)
        if sess._ideal is None:
            # tick 1: the test-mode reference forward over the recorded
            # utterances (collect_counts: the unfused path, no IMC launch)
            sess._ideal = tr.calibration_ideal_counts(
                srv.engine.hw, np.stack(sess.windows), cfg,
                device=srv.device)
            sess._calib_keys = tr.calibration_layer_keys(
                cfg, sess.ccfg.calib_seed, device=srv.device)
            sess._new_bias = {k: v.clone() for k, v in hwp.bias.items()}
            return
        offs = srv.engine.chip_offsets or {}
        names = cfg.imc_layer_names()
        for name in names[sess._calib_idx:
                          sess._calib_idx + sess.ccfg.layers_per_tick]:
            off = offs.get(name)
            if off is None:
                off = torch.zeros((sess._ideal[name].shape[-1],),
                                  device=srv.device)
            sess._new_bias[name] = tr.compensate_layer_bias(
                sess._new_bias[name], sess._ideal[name], off,
                sess._calib_keys[name], sess.ccfg.calib_sa_noise_std)
        sess._calib_idx += sess.ccfg.layers_per_tick
        if sess._calib_idx >= len(names):
            sess._ideal = None             # free the counts log
            sess.features = [None] * len(sess.windows)
            sess.feature_origins = [None] * len(sess.windows)
            sess.phase = "extracting"

    # -- feature re-extraction under the compensated biases ------------------

    def _extract(self, sess: CustomizationSession) -> None:
        srv = self.srv
        if not sess._replays_spawned:
            hwp, _ = kws.as_hw_params(srv.engine.hw)
            delta = {name: sess._new_bias[name] - hwp.bias[name]
                     for name in srv.cfg.imc_layer_names()}
            head = (hwp.fc_w, hwp.fc_b)
            hop, window = srv.geom.hop, srv.geom.window
            for j, win in enumerate(sess.windows):
                sid = f"~cust{sess.sid}u{j}"
                wav = np.concatenate([np.zeros((hop,), np.float32), win])
                srv._submit_internal(sid, wav,
                                     custom={"delta": delta, "head": head,
                                             "fills": None})
                # init consumes [silence hop, win[:-hop]]; one batched hop
                # later the state's window is exactly ``win``
                sess._captures.append({"stream": sid,
                                       "target": window + hop,
                                       "index": j, "kind": "replay"})
            sess._replays_spawned = True
            return
        if not sess._captures:
            self._start_training(sess, base_bias=False)

    # -- fine-tuning ----------------------------------------------------------

    def _start_training(self, sess: CustomizationSession,
                        base_bias: bool) -> None:
        srv = self.srv
        hwp, _ = kws.as_hw_params(srv.engine.hw)
        if base_bias:
            sess._new_bias = {k: v.clone() for k, v in hwp.bias.items()}
        state, featsq, onehot = finetune_init(
            torch.stack(sess.features), sess.labels, hwp.fc_w, hwp.fc_b,
            sess.ccfg.train, num_classes=srv.cfg.num_classes,
            device=srv.device)
        sess._head, sess._featsq, sess._onehot = state, featsq, onehot
        sess._labels_t = torch.tensor(sess.labels, device=srv.device)
        sess._epoch = 0
        sess.phase = "training"

    def _train_round(self) -> None:
        """Run each training session's bounded epoch budget for this tick.
        Kernel sessions on the fused route (``fused_head_route``) run
        their whole budget in ONE ``head_train_batch`` launch per launch
        spec (configuration and head shape), each row from its own epoch,
        the state updated in place.  The others run round by round: in
        every round the optimizer transitions of all kernel sessions
        sharing a weight/accumulator format are stacked into ONE
        ``sga_update`` launch (a learning rate and threshold per row)."""
        active = [s for s in self.sessions if s.phase == "training"]
        if not active:
            return
        budget = {s.sid: min(s.ccfg.epochs_per_tick,
                             s.ccfg.train.epochs - s._epoch)
                  for s in active}
        fused: Dict[tuple, List[CustomizationSession]] = {}
        stepwise = []
        for s in active:
            d, c = s._head.w.shape
            if s.ccfg.use_kernel and fused_head_route(
                    s.ccfg.train, s._featsq.shape[0], d, c):
                key = (head_train_spec(s.ccfg.train), d, c)
                fused.setdefault(key, []).append(s)
            else:
                stepwise.append(s)
        for (spec, _, _), group in fused.items():
            heads = [s._head for s in group]
            sga_ops.head_train_batch(
                [h.w for h in heads], [h.b for h in heads],
                [h.accum_w for h in heads], [h.accum_b for h in heads],
                [s._featsq for s in group], [s._onehot for s in group],
                [s._epoch for s in group], [budget[s.sid] for s in group],
                train_lut(self.srv.device), spec)
            for s in group:
                s._epoch += budget[s.sid]
            self.srv._metrics.inc("customize.epochs",
                                  sum(budget[s.sid] for s in group))
        if stepwise:
            self._step_rounds(stepwise, budget)
        for s in active:
            if budget[s.sid] > 0:
                acc = float(head_accuracy(s._featsq, s._labels_t, s._head.w,
                                          s._head.b, s.ccfg.train))
                s.history.append({"epoch": s._epoch,
                                  "train_accuracy": acc})
            if s._epoch >= s.ccfg.train.epochs:
                self._finish(s)

    def _step_rounds(self, active, budget) -> None:
        """The per-epoch route: ``epoch_grads`` for every session of a
        round, then one ``sga_update`` launch per (weight, accum) format
        group of kernel sessions and ``apply_update`` for the rest."""
        for r in range(max(budget[s.sid] for s in active)):
            batch = [s for s in active if r < budget[s.sid]]
            if not batch:
                break
            grads = [epoch_grads(s._head, s._epoch, s._featsq, s._onehot,
                                 s.ccfg.train) for s in batch]
            # one launch per (weight, accum) format group: the formats set
            # the kernel's grids, so sessions with different formats
            # cannot share rows
            fmt_groups: Dict[tuple, List[int]] = {}
            for i, s in enumerate(batch):
                if (s.ccfg.use_kernel and s.ccfg.train.quantized
                        and s.ccfg.train.sga):
                    fmt = (s.ccfg.train.weight_fmt, s.ccfg.train.accum_fmt)
                    fmt_groups.setdefault(fmt, []).append(i)
            kernel_rows = {i for idx in fmt_groups.values() for i in idx}
            for idx in fmt_groups.values():
                self._kernel_update([batch[i] for i in idx],
                                    [grads[i] for i in idx])
            for i, s in enumerate(batch):
                if i in kernel_rows:
                    continue
                gw, gb, lr, key = grads[i]
                s._head = apply_update(s._head, gw, gb, lr, key,
                                       s.ccfg.train)
            for s in batch:
                s._epoch += 1
            self.srv._metrics.inc("customize.epochs", len(batch))

    def _kernel_update(self, sessions, grads) -> None:
        """One fused ``sga_update`` launch for every session row: flatten
        each session's [fc_w, fc_b] and its SGA banks into one row, apply
        Algorithm 1 + the SGD step + the Q1.7 round/clip elementwise,
        unpack.  Bit-identical to ``apply_update``."""
        tcfg0 = sessions[0].ccfg.train
        rows_w, rows_g, rows_a, lrs, gths = [], [], [], [], []
        for s, (gw, gb, lr, _) in zip(sessions, grads):
            st = s._head
            rows_w.append(torch.cat([st.w.reshape(-1), st.b.reshape(-1)]))
            rows_g.append(torch.cat([gw.reshape(-1), gb.reshape(-1)]))
            rows_a.append(torch.cat([st.accum_w.reshape(-1),
                                     st.accum_b.reshape(-1)]))
            lrs.append(lr)
            gths.append(sga_threshold(lr, s.ccfg.train.weight_fmt))
        fmt_w, fmt_a = tcfg0.weight_fmt, tcfg0.accum_fmt
        nw, na = sga_ops.sga_update_batch(
            torch.stack(rows_w), torch.stack(rows_g), torch.stack(rows_a),
            torch.stack(lrs), torch.stack(gths),
            w_scale=fmt_w.scale, w_max=fmt_w.max_value,
            a_scale=fmt_a.scale)
        for i, (s, (_, _, _, key)) in enumerate(zip(sessions, grads)):
            ws, bs = s._head.w.shape, s._head.b.shape
            n_w, n_b = s._head.w.numel(), s._head.b.numel()
            s._head = HeadState(
                w=nw[i, :n_w].reshape(ws),
                b=nw[i, n_w:n_w + n_b].reshape(bs),
                accum_w=na[i, :n_w].reshape(ws),
                accum_b=na[i, n_w:n_w + n_b].reshape(bs),
                key=key)

    def _finish(self, sess: CustomizationSession) -> None:
        d = int(sess._featsq.shape[1])
        c = self.srv.cfg.num_classes
        e = energy.customization_energy_summary(
            n_utts=len(sess.windows), feat_dim=d, num_classes=c,
            epochs=sess.ccfg.train.epochs)
        sess.result = CustomizationResult(
            bias={k: _np(v) for k, v in sess._new_bias.items()},
            fc_w=_np(sess._head.w), fc_b=_np(sess._head.b),
            epochs=sess._epoch, n_utterances=len(sess.windows),
            history=list(sess.history), energy=e)
        sess.phase = "ready"
        srv = self.srv
        if srv._rec is not None:
            srv._rec.record(srv._steps, "session", stream=sess.stream_id,
                            sid=sess.sid, phase="ready",
                            epochs=sess._epoch)

    # -- hot swap -------------------------------------------------------------

    def swap(self, sess: CustomizationSession) -> None:
        """Write the finished profile into the attached stream's slot
        riders (bias delta + head + silence fill).  Only that slot's rows
        change."""
        if sess.result is None:
            raise ValueError("session not finished")
        srv = self.srv
        rec = srv._streams.get(sess.stream_id)
        riders = result_riders(sess.result, srv.engine.hw, srv.cfg,
                               chip_offsets=srv.engine.chip_offsets,
                               with_fills=srv._fills is not None)
        if rec is not None:
            rec.custom = riders
            rec.force_compute = False      # normal VAD gating resumes
            if rec.slot is not None:
                srv._write_slot_custom(rec.slot, riders)
        sess.phase = "swapped"
        srv._metrics.inc("customize.swaps")
        if srv._rec is not None:
            srv._rec.record(srv._steps, "session", stream=sess.stream_id,
                            sid=sess.sid, phase="swapped")

    # -- accounting -----------------------------------------------------------

    def stats(self) -> dict:
        reg = self.srv._metrics
        return {
            "sessions": [
                {"stream": s.stream_id, "phase": s.phase,
                 "utterances": len(s.windows), "epoch": s._epoch,
                 "train_accuracy": (s.history[-1]["train_accuracy"]
                                    if s.history else None)}
                for s in self.sessions
            ],
            "sessions_started": reg.value("customize.sessions"),
            "epochs_total": reg.value("customize.epochs"),
            "swaps": reg.value("customize.swaps"),
        }
