"""Always-on streaming KWS serving over the folded model.

  stream.py     — hop geometry, per-stream ring state and noise-field
                  key, init/step (+ the multi-hop step and the
                  per-stream bias-delta / head riders), the recompute
                  path over the raw window (``WindowState``,
                  ``window_*``), the SA-noise field in hop geometry, the
                  gated (no-IMC) advance and its constant or retention
                  fills
  vad.py        — log-energy EMA + hysteresis voice-activity detector
  decision.py   — posterior smoothing + hysteresis + refractory triggers
  scheduler.py  — StreamServer: slots, admission queue with rejection,
                  SLO shedding and autoscaling, batched hops, VAD gating
                  + wake replay, dynamic hop, eviction, customization
                  riders, profiles at admission, stats
  customize.py  — on-device customization as a serving workload:
                  enrollment sessions, scheduler-ticked bias compensation
                  + SGA fine-tuning, hot-swapped per-stream profiles
  health.py     — canary health monitoring: divergence localization,
                  the healthy / degraded / quarantined / recovering state
                  machine, online recompensation of a faulted chip
                  (``core.faults``)
  shard.py      — ShardedStreamServer: per-device slot pools behind the
                  placement router (``sharding.placement``), a global
                  uid per stream, the fleet rollup, sharded snapshots,
                  compiled blocks per pool
  compiled.py   — compiled ticks: K steady ticks as one block (the VAD
                  over the block, a host fate simulation, one masked hop
                  and one masked fill per timeline step), replayed as
                  CUDA graphs on a card
"""

from repro_torch.core.faults import FaultConfig, FaultModel
from repro_torch.serving.compiled import CompiledTick, CompiledTickConfig
from repro_torch.serving.customize import (CustomizationResult,
                                           CustomizationSession,
                                           CustomizeConfig)
from repro_torch.serving.decision import DecisionConfig
from repro_torch.serving.health import HealthConfig, HealthMonitor
from repro_torch.serving.scheduler import (AdmissionConfig,
                                           DynamicHopConfig, StreamServer)
from repro_torch.serving.shard import ShardedStreamServer
from repro_torch.serving.stream import (StreamEngine, StreamGeometry,
                                        StreamState, WindowState,
                                        gated_step, gated_window_step,
                                        hop_alignment, hop_sa_noise_fields,
                                        make_stream_geometry,
                                        retention_fills, silence_fills,
                                        stream_init, stream_multi_step,
                                        stream_step, streaming_layer_stats,
                                        window_init, window_multi_step,
                                        window_sa_noise, window_step,
                                        zeros_window_state)
from repro_torch.serving.vad import VADConfig, vad_scan

__all__ = [
    "AdmissionConfig", "CompiledTick", "CompiledTickConfig",
    "CustomizationResult", "CustomizationSession",
    "CustomizeConfig", "DecisionConfig", "DynamicHopConfig",
    "FaultConfig", "FaultModel", "HealthConfig", "HealthMonitor",
    "ShardedStreamServer", "StreamEngine", "StreamGeometry",
    "StreamServer", "StreamState",
    "VADConfig", "WindowState", "gated_step", "gated_window_step",
    "hop_alignment", "hop_sa_noise_fields", "make_stream_geometry",
    "retention_fills", "silence_fills", "stream_init", "stream_multi_step",
    "stream_step", "streaming_layer_stats", "window_init",
    "vad_scan", "window_multi_step", "window_sa_noise", "window_step",
    "zeros_window_state",
]
