#!/usr/bin/env python3
"""Card check of the PyTorch port (``src/repro_torch``) on an NVIDIA H100.

Run from the root of a checkout, with one CUDA card:

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

1. build the Hopper kernel ``imc_fused`` from ``src/repro_torch/kernels/
   imc_mav/csrc/imc_fused.cu`` (nvcc, sm_90a) and print the card's name and
   power limit;
2. per IMC layer of the paper net at full width (B = 8 streams, a full
   16 000-sample window, and the per-hop tail shapes of hop 1024): the
   kernel against its plain PyTorch version on the card, on random ±1
   inputs without offset, with chip offsets, and with chip offsets plus a
   pre-sign noise operand — bitwise; then the kernel's and the plain
   version's median times (CUDA events) beside the least time the card
   could take;
3. the served path: a net folded from ``init_params`` (seeded
   ``torch.Generator``) serves 8 streams of synthetic keyword audio with
   silent gaps (``repro_torch.data.audio``) through ``StreamServer`` at
   hop 1024, 8 slots, chip offsets and VAD on, about 24 hops each; once
   with ``use_kernel=True`` and once with the plain version.  Events and
   every state leaf must be identical, and the kernel must have launched
   exactly 5 x (init + hop + replay batched calls) times.  Full-window
   logits of the kernel path must equal the plain path's on the card and
   the port's CPU path (which the tests hold bitwise to the JAX package).

The lines before the last carry the card (``nvidia-smi``), the per-layer
times, decisions/s, the launch counts and one JSON object ``{"kernels":
[...]}``; the last line is ``{"ok": true, "device": {...}}``.  In the
kernels line, ``ms``, ``plain_ms`` and ``bound_ms`` are for the work of
one steady-state hop tick (the five IMC layers at the hop-1024 tail
shapes, B = 8): median device time from ``torch.profiler`` (CUDA-event
time per call where the profiler records no device activity), and the
least time the card could take for the same bytes and operations.
``launches`` is the count from the main path's served run.  Without a
CUDA device, or outside a checkout, the script exits non-zero.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HOP, SLOTS, HOPS, B = 1024, 8, 24, 8
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and TF32
# tensor-core operations/s.  ±1 fp32 operands are exact in TF32, so the
# layer's products could run at the TF32 rate.
H100_BYTES_PER_S = 3.35e12
H100_TF32_OPS_PER_S = 495e12
KERNEL_SOURCE = "src/repro_torch/kernels/imc_mav/csrc/imc_fused.cu"
REPLACES = "src/repro/kernels/imc_mav/imc_mav.py:141"


def log(*args):
    print(*args, flush=True)


def cuda_ms(torch, fn, reps=7, iters=20):
    """Median milliseconds per call of ``fn`` over ``reps`` runs of
    ``iters`` back-to-back calls, timed with CUDA events after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def device_ms(torch, fn, reps=7, iters=20):
    """Median device time per call of ``fn``: in each of ``reps`` profiled
    runs of ``iters`` calls, the summed own time of the device activities
    (kernels, copies) that ``torch.profiler`` records, over ``iters``.
    None when the profiler records no device activity (then only the
    CUDA-event times stand)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total_us, _ = device_time(torch, prof)
        per_call.append(total_us / iters / 1e3)
    return statistics.median(per_call) if min(per_call) > 0 else None


def device_time(torch, prof):
    """(total microseconds, {name: (microseconds, count)}) of the device
    activities in a profile; host-side operator rows are skipped so no
    kernel is counted twice."""
    cuda = torch.autograd.DeviceType.CUDA
    total, rows = 0.0, {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != cuda:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        total += us
        rows[e.key] = (us, e.count)
    return total, rows


def layer_work(b, t, c_in, c_out, groups, stride, pool, chip, noise, k=3):
    """(bytes, operations) the fused layer must move and do: each input
    read once, the output written once (fp32), 2 operations per ±1
    product."""
    cpg = c_in // groups
    t_out = (t - k) // stride + 1
    t_pool = t_out // pool
    floats = (b * t * c_in                         # activations in
              + k * cpg * c_out                    # weights
              + (3 if chip else 2) * c_out         # bias, flip, offset
              + b * t_pool * c_out                 # activations out
              + (b * t_out * c_out if noise else 0))
    ops = 2 * b * t_pool * pool * c_out * k * cpg
    return 4 * floats, ops


def bound_ms(nbytes, ops):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_TF32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_build(torch):
    from repro_torch.kernels.imc_mav import ops
    t0 = time.perf_counter()
    ops.library()
    log(f"[build] imc_fused built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    from repro_torch import kernels
    logfile = kernels.library_path("imc_fused", [ops.SOURCE])
    logfile = logfile.with_name(logfile.name + ".log")
    for line in logfile.read_text().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] {line.strip()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)
    return smi


def _layer_inputs(torch, gen, dev, b, t, c_in, c_out, groups, stride):
    """Random ±1 activations and weights, even biases on the word-line
    grid [-64, 64], ±1 flips, chip offsets and a pre-sign noise operand."""
    def pm1(*shape):
        return (torch.randint(0, 2, shape, generator=gen, device=dev)
                .float() * 2 - 1)
    x = pm1(b, t, c_in)
    w = pm1(3, c_in // groups, c_out)
    bias = torch.round(torch.randn(c_out, generator=gen, device=dev) * 8) * 2
    flip = pm1(c_out)
    off = 4.0 * torch.randn(c_out, generator=gen, device=dev)
    t_out = (t - 3) // stride + 1
    noise = torch.randn((b, t_out, c_out), generator=gen, device=dev)
    return x, w, bias.clamp(-64, 64), flip, off, noise


def phase_layers(torch, dev):
    """Kernel vs plain version per IMC layer at the served shapes; times."""
    from repro_torch.kernels.imc_mav import ops, ref
    from repro_torch.models import kws
    from repro_torch.serving import stream as sv

    cfg = kws.PAPER_KWS
    geom = sv.make_stream_geometry(cfg, HOP)
    gen = torch.Generator(device=dev).manual_seed(1234)
    max_err = 0.0
    rows = []
    totals = {"window": [0.0, 0.0, 0, 0], "hop": [0.0, 0.0, 0, 0]}
    for i in range(1, cfg.num_conv_layers):
        c_in, c_out = cfg.channels[i - 1], cfg.channels[i]
        groups, pool, stride = cfg.groups(i), cfg.pools[i], cfg.strides[i]
        lg = geom.layers[i]
        for shape, t in (("window", lg.t_in), ("hop", lg.tail_in)):
            x, w, bias, flip, off, noise = _layer_inputs(
                torch, gen, dev, B, t, c_in, c_out, groups, stride)
            packed = ops.pack_weights(w, groups)
            for case, o, n in (("clean", None, None), ("chip", off, None),
                               ("noise", off, noise)):
                got = ops.fused_conv_mav(x, w, bias, flip, groups=groups,
                                         stride=stride, pool=pool,
                                         chip_offset=o, sa_noise=n,
                                         packed=packed)
                want = ref.fused_conv_mav_ref(x, w, bias, flip,
                                              groups=groups, stride=stride,
                                              pool=pool, chip_offset=o,
                                              sa_noise=n)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                max_err = max(max_err, err)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"conv{i} {shape} {case}: kernel differs from the "
                        f"plain version on {(got != want).sum().item()} "
                        f"of {got.numel()} outputs")
            # time the served configuration: chip offsets, no noise
            kernel = lambda: ops.imc_fused(
                x, packed, bias, flip, off, None, k=3, groups=groups,
                stride=stride, pool=pool)
            plain = lambda: ref.fused_conv_mav_ref(
                x, w, bias, flip, groups=groups, stride=stride, pool=pool,
                chip_offset=off)
            k_call, p_call = cuda_ms(torch, kernel), cuda_ms(torch, plain)
            k_dev, p_dev = device_ms(torch, kernel), device_ms(torch, plain)
            k_ms = k_dev if k_dev is not None else k_call
            p_ms = p_dev if p_dev is not None else p_call
            nbytes, nops = layer_work(B, t, c_in, c_out, groups, stride,
                                      pool, chip=True, noise=False)
            b_ms, b_by = bound_ms(nbytes, nops)
            tot = totals[shape]
            tot[0] += k_ms
            tot[1] += p_ms
            tot[2] += nbytes
            tot[3] += nops
            rows.append(dict(layer=f"conv{i}", shape=shape, B=B, T=t,
                             c_in=c_in, c_out=c_out, groups=groups,
                             kernel_device_ms=k_dev, plain_device_ms=p_dev,
                             kernel_call_ms=k_call, plain_call_ms=p_call,
                             bound_ms=b_ms, bound_by=b_by))
            log(f"[layer] conv{i} {shape:6s} B={B} T={t:5d} "
                f"{c_in:3d}->{c_out:3d} g={groups:2d}: device time kernel "
                f"{k_dev} ms, plain {p_dev} ms; per call (CUDA events) "
                f"kernel {k_call:.4f} ms, plain {p_call:.4f} ms; bound "
                f"{b_ms:.5f} ms ({b_by}); bitwise equal (clean/chip/noise)")
    for shape, (k_ms, p_ms, nbytes, nops) in totals.items():
        b_ms, b_by = bound_ms(nbytes, nops)
        log(f"[layer] five layers, {shape} shapes: kernel {k_ms:.4f} ms, "
            f"plain {p_ms:.4f} ms (device time), bound {b_ms:.5f} ms "
            f"({b_by})")
    return rows, totals, max_err


def _traffic(cfg):
    """8 streams of keyword audio: utterance, 6 silent hops, utterance."""
    import numpy as np
    from repro_torch.data import audio
    utts, _ = audio.make_dataset(seed=0, n_per_class=1, n_speakers=4,
                                 augment=False, length=cfg.sample_len)
    gap = np.random.default_rng(1).uniform(-1e-4, 1e-4, 6 * HOP)
    n = cfg.sample_len + HOPS * HOP
    streams = []
    for s in range(SLOTS):
        x = np.concatenate([utts[s % 10], gap, utts[(s + 3) % 10], gap])
        streams.append(x[:n].astype(np.float32))
    return streams


def _to(tree, dev):
    """A copy of a (named) tuple / dict tree of tensors on ``dev``."""
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_to(v, dev) for v in tree))
    return tree.to(dev)


def phase_served(torch, dev):
    import numpy as np
    from repro_torch.kernels.imc_mav import ops
    from repro_torch.models import kws
    from repro_torch.serving.scheduler import StreamServer
    from repro_torch.serving.vad import VADConfig

    cfg = kws.PAPER_KWS
    gen = torch.Generator().manual_seed(0)
    params = kws.init_params(gen, cfg, device=dev)
    hw = kws.fold_params(params, kws.init_state(cfg, device=dev), cfg,
                         pack=True)
    chip = {name: 4.0 * torch.randn(cfg.channels[i], generator=gen)
            for i, name in enumerate(cfg.imc_layer_names(), start=1)}
    streams = _traffic(cfg)

    def serve(use_kernel, profiled=False):
        from torch.profiler import ProfilerActivity, profile
        srv = StreamServer(hw, cfg, hop=HOP, slots=SLOTS, chip_offsets=chip,
                           use_kernel=use_kernel, vad=VADConfig(),
                           device=dev)
        for s, x in enumerate(streams):
            srv.submit(f"s{s}", x)
            srv.finish(f"s{s}")
        torch.cuda.synchronize()
        prof = None
        ops.COUNTS.reset()                  # the main path's run starts
        t0 = time.perf_counter()
        if profiled:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                events = srv.drain()
                torch.cuda.synchronize()
        else:
            events = srv.drain()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.COUNTS.launches      # ... and ends: read the count
        return dict(srv=srv, events=events, launches=launches, wall=wall,
                    prof=prof, kernel=use_kernel)

    serve(False), serve(True)               # warm-up: first use of each op
    runs = [serve(False), serve(True), serve(True), serve(False)]
    main = runs[1]
    st = main["srv"].stats()
    calls = st["batched_calls"]
    n_calls = calls["init"] + calls["hop"] + calls["replay"]
    for run in runs:
        if run["events"] != runs[0]["events"]:
            raise AssertionError("served events differ between the kernel "
                                 "and the plain version")
        want = 5 * n_calls if run["kernel"] else 0
        if run["launches"] != want:
            raise AssertionError(
                f"imc_fused launched {run['launches']} times in a "
                f"{'kernel' if run['kernel'] else 'plain'} run with "
                f"{n_calls} batched calls (expected {want})")
    leaves = lambda srv: ([srv._state.audio_carry, *srv._state.carries,
                           srv._state.ring, srv._state.hop]
                          + list(srv._dstate) + list(srv._vstate))
    for a, b in zip(leaves(main["srv"]), leaves(runs[0]["srv"])):
        if not torch.equal(a, b):
            raise AssertionError("served state differs between the kernel "
                                 "and the plain version")
    ev_k, launches_k = main["events"], main["launches"]
    dps = {k: [st["decisions"] / r["wall"] for r in runs if r["kernel"] == k]
           for k in (True, False)}
    log(f"[served] main-path run: {st['decisions']} decisions in "
        f"{st['steps']} ticks; hops speech {st['speech_hops']} gated "
        f"{st['gated_hops']}; batched calls {calls}; imc_fused launches "
        f"{launches_k} (= 5 x {n_calls})")
    log(f"[served] wall decisions/s in turns plain, kernel, kernel, plain: "
        f"{[round(st['decisions'] / r['wall'], 1) for r in runs]}; "
        f"server compute-time decisions/s (stats): kernel "
        f"{st['decisions_per_sec']}, plain "
        f"{runs[0]['srv'].stats()['decisions_per_sec']}")
    prof_run = serve(True, profiled=True)
    busy_us, rows = device_time(torch, prof_run["prof"])
    kern_us = sum(us for name, (us, _) in rows.items() if "imc_fused" in name)
    busy = busy_us / 1e6 / prof_run["wall"]
    log(f"[served] profiled kernel run: wall {prof_run['wall'] * 1e3:.1f} "
        f"ms, device busy {busy_us / 1e3:.3f} ms (share {busy:.4f}, idle "
        f"{1 - busy:.4f}), imc_fused {kern_us / 1e3:.3f} ms")
    for name, (us, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"[served]   {us / 1e3:8.3f} ms  n={n:5d}  {name[:80]}")
    if not ev_k or st["gated_hops"] == 0 or len(ev_k) != st["decisions"]:
        raise AssertionError(f"served run did not exercise the path: "
                             f"{len(ev_k)} events, stats {st}")

    # full-window logits: kernel == plain on the card == the port on the CPU
    windows = np.stack([x[:cfg.sample_len] for x in streams])
    chip_dev = {k: v.to(dev) for k, v in chip.items()}
    lk, _ = kws.hw_forward(hw, windows, cfg, chip_offsets=chip_dev,
                           use_kernel=True, device=dev)
    lp, _ = kws.hw_forward(hw, windows, cfg, chip_offsets=chip_dev,
                           use_kernel=False, device=dev)
    hw_cpu = _to(hw, "cpu")
    lc, _ = kws.hw_forward(hw_cpu, windows, cfg, chip_offsets=chip,
                           use_kernel=True, device="cpu")
    if not (torch.equal(lk, lp) and torch.equal(lk.cpu(), lc)):
        raise AssertionError("full-window logits differ between kernel, "
                             "plain version and the CPU path")
    if lk.shape != (B, cfg.num_classes) or not torch.isfinite(lk).all():
        raise AssertionError(f"bad logits {lk}")
    log(f"[served] full-window logits (B={B}) equal on kernel / plain / "
        f"CPU paths; keywords {lk.argmax(-1).tolist()}")
    served = dict(decisions=st["decisions"], ticks=st["steps"],
                  batched_calls=calls, launches=launches_k,
                  wall_dps_kernel=dps[True], wall_dps_plain=dps[False],
                  device_busy_share=busy, imc_fused_device_ms=kern_us / 1e3)
    return served


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    # the port never relies on TF32 (its ±1 and fixed-point products are
    # exact either way); state it and keep it off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    smi = phase_build(torch)
    rows, totals, max_err = phase_layers(torch, dev)
    served = phase_served(torch, dev)
    launches = served["launches"]

    k_ms, p_ms, nbytes, nops = totals["hop"]
    b_ms, b_by = bound_ms(nbytes, nops)
    print(json.dumps({"card": smi, "layers": rows, "served": served}),
          flush=True)
    log(f"[summary] {smi}: imc_fused five layers per hop tick (B={B}): "
        f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.5f} ms "
        f"(device time); {launches} launches on the served path")
    print(json.dumps({"kernels": [{
        "name": "imc_fused", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
