"""Always-on streaming KWS serving over the folded model.

  stream.py     — hop geometry, per-stream ring state and noise-field
                  key, init/step (+ the multi-hop step and the
                  per-stream bias-delta / head riders), the SA-noise
                  field in hop geometry, the gated (no-IMC) advance and
                  its constant or retention fills
  vad.py        — log-energy EMA + hysteresis voice-activity detector
  decision.py   — posterior smoothing + hysteresis + refractory triggers
  scheduler.py  — StreamServer: slots, admission queue, batched hops,
                  VAD gating + wake replay, eviction, customization
                  riders, stats
  customize.py  — on-device customization as a serving workload:
                  enrollment sessions, scheduler-ticked bias compensation
                  + SGA fine-tuning, hot-swapped per-stream profiles
"""

from repro_torch.serving.customize import (CustomizationResult,
                                           CustomizationSession,
                                           CustomizeConfig)
from repro_torch.serving.decision import DecisionConfig
from repro_torch.serving.scheduler import StreamServer
from repro_torch.serving.stream import (StreamEngine, StreamGeometry,
                                        StreamState, gated_step,
                                        hop_alignment, hop_sa_noise_fields,
                                        make_stream_geometry,
                                        retention_fills, silence_fills,
                                        stream_init, stream_multi_step,
                                        stream_step, streaming_layer_stats,
                                        window_sa_noise)
from repro_torch.serving.vad import VADConfig

__all__ = [
    "CustomizationResult", "CustomizationSession", "CustomizeConfig",
    "DecisionConfig", "StreamEngine", "StreamGeometry", "StreamServer",
    "StreamState", "VADConfig", "gated_step", "hop_alignment",
    "hop_sa_noise_fields", "make_stream_geometry", "retention_fills",
    "silence_fills", "stream_init", "stream_multi_step", "stream_step",
    "streaming_layer_stats", "window_sa_noise",
]
