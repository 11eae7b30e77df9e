"""Always-on streaming KWS: a few live audio streams through the
multi-stream serving engine (the port of ``examples/stream_kws.py``).

  1. fold an untrained net to the hardware path (the serving mechanics
     are identical to a trained one's; the reference's cached
     ``results/kws_model.pkl`` holds JAX arrays and is not read here),
  2. synthesize a few "microphone" streams: keyword utterances embedded
     in noise at random offsets,
  3. run the slot-based StreamServer with voice-activity gating: every
     step batches all live streams' fresh frames into one fused-kernel
     launch per IMC layer (K1, ``imc_fused``), and hops the VAD classifies
     as silence skip the IMC stack,
  4. print trigger events and the server's throughput, duty-cycle,
     per-decision MAC and energy accounting.

Run:  PYTHONPATH=src python -m repro_torch.examples.stream_kws [--device cpu]
      REPRO_EXAMPLES_SMOKE=1 ... for a seconds-scale smoke run
"""

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core import jaxrand
from repro_torch.data import audio
from repro_torch.examples import device_arg, smoke
from repro_torch.kernels import resolve_device
from repro_torch.models import kws as m
from repro_torch.serving import DecisionConfig, StreamServer, VADConfig

CHUNK = 517           # samples per submit, as a microphone driver feeds


def sizes(smoke_run: bool) -> Tuple[int, int, int, int]:
    """(window, hop, streams, silent tail hops): hop/window = 0.1 / 0.128."""
    return (640, 64, 1, 8) if smoke_run else (2000, 256, 3, 24)


def make_streams(window: int, hop: int, n_streams: int, tail_hops: int
                 ) -> Dict[str, Tuple[np.ndarray, int, int]]:
    """{stream id: (wav, keyword, onset)}: a keyword clip early in a long
    stream of low noise (the silent tail is what the VAD gates)."""
    rng = np.random.default_rng(0)
    (clips, labels), _ = audio.make_gscd_like(train_per_class=1,
                                              test_per_class=1,
                                              length=window)
    streams = {}
    for i in range(n_streams):
        wav = 0.01 * rng.standard_normal(
            window + tail_hops * hop).astype(np.float32)
        j = rng.integers(len(labels))
        at = int(rng.integers(0, 4 * hop))
        wav[at:at + window] += clips[j].astype(np.float32)
        streams[f"mic{i}"] = (wav, int(labels[j]), at)
    return streams


DECISION = DecisionConfig(smooth=4, threshold_on=0.5, threshold_off=0.35,
                          refractory=6)
# the 0.01-amplitude noise floor sits at ~-40 dBFS: well under the on
# threshold, so hops outside the embedded keyword windows are gated
VAD = VADConfig(threshold_on_db=-30.0, threshold_off_db=-36.0,
                wake_margin=2, hang=1)


def folded_net(cfg: m.KWSConfig, device) -> m.PackedHWParams:
    """The untrained net of ``init_params(PRNGKey(0))`` (the reference's
    draw, bit for bit), folded and packed once to serve many."""
    params = m.init_params(jaxrand.PRNGKey(0, device="cpu"), cfg,
                           device=device)
    return m.fold_params(params, m.init_state(cfg, device=device), cfg,
                         pack=True)


def serve(hw, cfg: m.KWSConfig, hop: int, streams, device,
          out: Optional[List[str]] = None, use_kernel: bool = True):
    """Serve ``streams`` through one server (4 slots, VAD on, the kernel
    route unless ``use_kernel`` is false): returns (server, events)."""
    srv = StreamServer(hw, cfg, hop=hop, slots=4, use_kernel=use_kernel,
                       decision=DECISION, vad=VAD, device=device)
    for sid, (wav, kw, at) in streams.items():
        if out is not None:
            out.append(f"   {sid}: keyword {kw} at sample {at}")
        for off in range(0, len(wav), CHUNK):
            srv.submit(sid, wav[off:off + CHUNK])
        srv.finish(sid)
    return srv, srv.drain()


def trigger_line(ev: dict) -> str:
    return (f"   TRIGGER {ev['stream']} hop {ev['hop']}: "
            f"keyword {ev['keyword']} (score {ev['score']:.2f})")


def main(argv=None) -> None:
    dev = resolve_device(device_arg(__doc__.split("\n")[0], argv))
    window, hop, n_streams, tail_hops = sizes(smoke())
    cfg = m.KWSConfig(sample_len=window)
    print("== no cached model (the reference's results/kws_model.pkl holds "
          "JAX arrays); folding an untrained net to demo the serving "
          "path ==")
    hw = folded_net(cfg, dev)
    streams = make_streams(window, hop, n_streams, tail_hops)
    print(f"== serving {len(streams)} streams "
          f"(window={window}, hop={hop}, slots=4) on {dev.type} ==")
    lines: List[str] = []
    srv, events = serve(hw, cfg, hop, streams, dev, lines)
    print("\n".join(lines))
    for ev in events:
        if ev["trigger"]:
            print(trigger_line(ev))
    s = srv.stats()
    print(f"== {s['decisions']} decisions, "
          f"{s['decisions_per_sec']} decisions/s, "
          f"streaming MACs/decision = "
          f"{s['macs_per_decision']['ratio']:.3f}x offline ==")
    g = s["gated_energy"]
    print(f"== VAD duty cycle {s['duty_cycle']:.2f} "
          f"({s['speech_hops']} speech / {s['gated_hops']} gated hops): "
          f"{g['gated_uj_per_decision']:.3f} uJ/decision vs "
          f"{g['ungated_uj_per_decision']:.3f} ungated "
          f"({g['reduction_vs_ungated']:.2f}x) ==")


if __name__ == "__main__":
    main()
