"""Always-on streaming KWS serving over the folded model.

  stream.py     — hop geometry, per-stream ring state, init/step, the
                  multi-hop step and the gated (no-IMC) advance
  vad.py        — log-energy EMA + hysteresis voice-activity detector
  decision.py   — posterior smoothing + hysteresis + refractory triggers
  scheduler.py  — StreamServer: slots, admission queue, batched hops,
                  VAD gating + wake replay, eviction, stats
"""
