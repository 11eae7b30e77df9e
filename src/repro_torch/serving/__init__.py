"""Always-on streaming KWS serving over the folded model.

  stream.py     — hop geometry, per-stream ring state, init/step (+ the
                  multi-hop step and the per-stream bias-delta / head
                  riders) and the gated (no-IMC) advance
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
                                        hop_alignment, make_stream_geometry,
                                        silence_fills, stream_init,
                                        stream_multi_step, stream_step,
                                        streaming_layer_stats)
from repro_torch.serving.vad import VADConfig

__all__ = [
    "CustomizationResult", "CustomizationSession", "CustomizeConfig",
    "DecisionConfig", "StreamEngine", "StreamGeometry", "StreamServer",
    "StreamState", "VADConfig", "gated_step", "hop_alignment",
    "make_stream_geometry", "silence_fills", "stream_init",
    "stream_multi_step", "stream_step", "streaming_layer_stats",
]
