#!/usr/bin/env python3
"""Card check of the PyTorch port (``src/repro_torch``) on an NVIDIA H100.

Run from the root of a checkout, with one CUDA card:

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero and prints no
result line):

1. build the four kernel sources, ``imc_fused`` and ``imc_mav``
   (``src/repro_torch/kernels/imc_mav/csrc/``), ``sga_update``
   (``.../sga_update/csrc/``) and ``int8_matmul`` (``.../int8_matmul/
   csrc/``), one nvcc (sm_90a) for each, started together, and print the
   card's name and power limit;
2. per IMC layer of the paper net at full width, at every shape of
   ``K1_SHAPES`` (B = 8 streams at a full 16 000-sample window and at the
   per-hop tail shapes of hops 1024, 2048 and 4096, and B = 16 at the
   hop-1024 tails): the fused kernel, one launch a call, against its
   plain PyTorch version on the card, on random
   ±1 activations, on ±1 activations with two of the eight streams all
   zero (the carries of free slots) and on activations in {-1, 0, +1};
   each without offset, with chip offsets, and with chip offsets plus a
   pre-sign noise operand — bitwise; then the kernel's and the plain
   version's median device times (with the profiler's device records per
   call) and CUDA-event times per call beside the least time the card
   could take, the kernel's ratio to it, and the host time a call of the
   kernel's wrapper takes.  Then the same bitwise checks, one launch a
   call, at every IMC layer of two nets off the paper's group width,
   ``KWSConfig(channels_per_group=6)`` and the cpg-48 net (``WIDTH_NETS``),
   with each layer's block tile and full-window device time beside its
   bound;
3. the served path: a net folded from ``init_params`` (drawn from a
   ``jaxrand`` key, as the JAX package draws it) serves 8 streams of
   synthetic keyword audio with
   silent gaps (``repro_torch.data.audio``) through ``StreamServer`` at
   hop 1024, 8 slots, chip offsets and VAD on, about 24 hops each; once
   with ``use_kernel=True`` and once with the plain version.  Events and
   every state leaf must be identical, and the kernel must have launched
   exactly 5 x (init + hop + replay batched calls) times.  Full-window
   logits of the kernel path must equal the plain path's on the card and
   the port's CPU path (which the tests hold bitwise to the JAX package);
4. on-chip customization at full width: the same net, chip and VAD at hop
   1024 and 8 slots serve two live keyword streams while three enrollment
   sessions (``StreamServer.customize``, 10 labelled one-window utterances
   each, ``epochs_per_tick`` 10, 7 and 10; the third with the test mode's
   read noise, ``calib_sa_noise_std=1.0``) run bias compensation and 200
   epochs of the quantized head fine-tune, then hot-swap and serve their
   users; once with the kernels and once with the plain versions.
   Results (biases, head, history) and every stream's events must be
   identical; each result must equal the offline loop
   (``calibrate_and_compensate`` -> ``hw_features`` ->
   ``quantized_head_finetune``) on the card and on the CPU;
   ``head_train_rows`` must launch exactly once per training tick (the
   three sessions share one configuration), ``sga_update_rows`` never,
   and ``imc_fused`` 5 x (init + hop + replay batched calls).  A separate
   short run trains one RGP session (``rgp=True``, 40 epochs, no
   compensation): one ``sga_update_rows`` launch per epoch, none fused,
   its head equal to the offline loop on the card and the CPU.  Then the
   SGA kernels against their plain version at B = 1, 2 and 8 rows of the
   head's 5770 elements, with tie cases, bitwise, with their times; the
   flat entry (K3) on whole trees, one launch a tree: ragged leaves
   (1 to 5770 elements, a view at a 4-byte offset) in nested dicts, lists
   and a namedtuple, the paper net's float parameter tree (27 leaves),
   a 70-leaf tree (two launches) and one leaf of 2**26 elements, bitwise,
   a tree on two devices refused; its times at N = 5770, on the 27-leaf
   tree and at 2**26 beside the plain version's and the bytes bound; the
   fused head training against its plain version at B = 1, 2, 3, 8 rows
   of 10 utterances and at (3, 64), (2, 1), with a softmax tie, bitwise,
   with its time at the path's shape; and the error-scaling exponent on
   the card, through torch and through the fused kernel's own
   arithmetic, against the exact one for all 257 values the quantized
   loop can meet;
5. ``imc_mav`` (K5) on the per-group patch shapes of conv1..conv5 at a
   full window (B = 8), on ±1 and on {-1, 0, +1} operands, float32 and
   bfloat16, clean and with a noise operand, and ``int8_matmul`` (K4) at
   512 x 128 x 128 (shifts 0, 4, 7; its tiled plan) and at the FC head's
   8 x 576 x 10 (its split-K plan), bitwise against their plain versions,
   with their planned tiles, times, bounds, the float32 matmul of K5's
   product alone and ``torch._int_mm`` (K4's product alone);
6. the per-group hardware forward at full width (``grouploop_forward``:
   ``conv_mav`` per IMC layer, 41 K5 launches, and the FC through
   ``quantized_fc``, one K4 launch, both counted): clean logits equal to
   the fused ``hw_forward``, the ``sa_key``-noise forward equal on the
   kernel route and the plain route, and each layer's time beside the
   fused layer's;
7. the served path on a noisy chip (SA noise 1.0, chip offsets from
   ``sample_chip_offsets(PRNGKey(0))`` at std 4), with constant and with
   retention fills: kernel and plain routes bitwise equal on events and
   every state leaf, ``imc_fused`` 5 x (batched calls) launches; the noise
   field on the card equal to the CPU's; streamed logits equal to the
   offline ``hw_forward(sa_noise_field=...)``; decisions/s beside the
   noise-free run and the noise field's share of a tick;
8. the front door (``phase_front_door``), each run on the kernel and the
   plain route with identical events, placements and counters and
   ``imc_fused`` launched 5 x ``stats()["imc_passes"]`` times: (a) the
   recompute server (``streaming=False``) against the streaming one on
   the served traffic, events identical with every hop computed (VAD
   forced to speech; also on a short noisy run), decisions/s of each
   over three runs, and with VAD gating K1's device time per recompute
   forward beside the five full-window layers' bound; (b) the dynamic
   hop (x4) on calm-then-loud traffic, the multiplier reaching 4 and
   coming back to 1 (phase 2 holds and times K1 at its hop-2048 and
   hop-4096 tails); (c) admission control from 4 to 16 slots for 20
   streams: rejections, sheds past the latency SLO, growth to 16 and the
   shrink back (phase 2 holds and times K1 at B = 16); (d) a customization
   session's result in a ``ProfileStore``, served through
   ``submit(user_id=)`` exactly as through ``install_custom``;
9. the self-healing chip (``phase_reliability``), each run on the kernel
   and the plain route with identical events (``degraded`` included),
   states, health and fault stats and ``imc_fused`` launched 5 x
   ``stats()["imc_passes"]`` times: (a) a faulted server (stuck columns,
   trim-bit flips) equal to a clean one serving the same integer deltas
   through installed profiles, at SA noise 0 and 1.0; (b) stuck columns
   in conv3 on a monitored server until they are masked, and (c) a
   uniform drift of 40 counts on conv2 until it has healed, with the
   detection tick, transitions, recoveries and modelled recovery energy;
   (d) decisions/s and the device busy share with canaries every 8 ticks
   and without; (e) K1's device time in a tick whose batch carries live
   hops and a canary hop, against the same tick without health;
10. the float learning path (``phase_learning``), with TF32 off: (a)
   ``train_base`` on 120 windows of ``make_gscd_like`` traffic at batch
   60, two epochs (a soft ``tanh`` phase, then a hard surrogate-gradient
   phase on the in-memory bias grid), clean and as the noise-aware
   recovery fine-tune (chip offsets of std 4, SA noise 1.0): losses per
   step, wall per step and the device busy share; then one soft step from
   the initial net and one hard step from the soft-trained net, on the
   card and on the CPU from identical parameters: the losses within rtol
   1e-3, the BN state bitwise, 95% of the parameters within
   1e-4 |p| + 1e-5 (Adam's first step turns a rounding-noise gradient into
   a step of about the learning rate); (b) the trained net's
   ``forward_eval`` features at B = 200 against ``hw_forward`` through K1
   (5 launches) on the unconstrained fold, to 1e-5, and ``evaluate`` equal
   on the card and the CPU; (c) the smallest mean ties: the T = 448 GAP at
   every GAP site (0.4375) and the N = 7 head on both K2 routes
   (``head_train_rows``, and ``epoch_grads`` then ``sga_update_rows``):
   gw[1, 0] 7/128, each kernel bitwise against its plain version and the
   card equal to the CPU;
11. the paper's Tables II-IV pipeline (``phase_pipeline``), as
   ``benchmarks/kws_experiments.py`` runs it with ``fast``, on 400 + 120
   windows of ``make_gscd_like`` and the personal set
   (``make_personal``, accent 0.18): ``train_base`` on the card (24
   epochs, batch 100), every accuracy row through ``evaluate_hw`` with
   K1 (ideal, FC-quantized and BN-constrained folds; two chips of offset
   std 8 and SA noise 1.0, noisy and compensated; a one-epoch noise-aware
   fine-tune), Table IV's five head variants on ``hw_features`` of the
   compensated chip, and the chip report (uJ/decision, power, TOPS/W,
   breakdown): each ``evaluate_hw`` launching K1 5 x its chunks with its
   logits equal to the plain route's, and on 16 windows the card equal to
   the CPU (clean, noisy, compensated biases); accuracies printed, not
   gated;
12. the serving telemetry (``phase_obs``) on phase 3's traffic and on
   phase 9's faulted, canary-monitored run: telemetry fully on (recorder,
   auditor in raise mode, trace) equal to off on events and every state
   leaf; the auditor's count of fused calls equal to K1's launches tick
   by tick; the recorder's tick events equal to the server's counts; the
   trace dump valid JSON (under ``build/``); wall decisions/s off and on
   in alternating pairs, with their spread;
13. crash-safe snapshots (``phase_snapshot``): phase 9's faulted,
   canary-monitored run on the noisy chip snapshotted to a file under
   ``build/`` at tick 10 and played 12 more ticks, against a fresh card
   server restored from the file (events, every state leaf, health and
   fault stats equal; K1's launches equal but for 10 per canary
   expectation the restored monitor recomputes); the same file restored
   into a CPU server for 3 ticks (the card's events, ``score`` within
   1e-6, and its carries bit for bit); four concurrent enrollment
   sessions snapshotted mid-calibration and mid-training, each restore
   reaching every ``CustomizationResult`` bit for bit; the bytes on disk
   and the walls of ``snapshot(path)`` and ``restore(path)`` at 8 live
   slots;
14. the sharded fleet (``phase_sharded``): phase 3's traffic through
   ``ShardedStreamServer(devices=2, slots=4)``, two pools on the card,
   noise-free and on the noisy chip: each stream's events equal one
   8-slot server's, placement balanced, K1 launched once per IMC layer
   and pool per batched call; ``parallel=True`` under the raising launch
   auditor equal to the sequential fleet; a fleet snapshot under
   ``build/`` restored into a fresh fleet equal to the uninterrupted
   one; wall decisions/s of the sequential fleet, the parallel fleet and
   one server in alternating runs, with their spread;
15. compiled ticks (``phase_compiled``): ``StreamServer(compiled=
   CompiledTickConfig(block=8))`` stepped in blocks, each step of a block
   a CUDA graph replay with K1 inside, against the interpreted server on
   (a) phase 3's traffic on a clean chip, (b) the noisy chip, (c) a fault
   drift that changes the chip delta inside every block and stuck columns
   injected at tick 6, (d) two streams with installed customization
   riders: events, every state leaf, per-stream stats and every registry
   cell but the wall time, ``serving.compiled`` and ``imc_passes`` equal,
   most ticks served by blocks, K1 launched 5 x ``imc_passes`` (and from
   the first block of replays on, its kernel records equal to
   ``COUNTS``);
   (e) phase 14's fleet with ``compiled=``, sequential and
   ``parallel=True`` under the raising auditor, each stream's events equal
   one server's; the capture wall per graph, host ms per tick, the device
   busy share of a steady window, and wall decisions/s of compiled
   against interpreted in alternating pairs, and of the compiled fleets
   against one compiled server;
16. the examples and the LM stack's serving path (``phase_examples``): (a)
   the three KWS examples of ``repro_torch.examples`` (``quickstart``,
   ``stream_kws``, ``customize_onchip``) at their full sizes, each with
   its wall time and its K1 and ``head_train_rows`` launches, then each
   example's hardware-path calls at its own shapes through K1 and on the
   plain route, bitwise equal; (b) the reduced qwen2.5-14b, starcoder2-15b,
   internvl2-2b, qwen3-moe-30b-a3b, qwen2-moe-a2.7b, zamba2-1.2b and
   xlstm-125m on the card against the port on the CPU, each server with
   its own ``jaxrand`` draw from ``PRNGKey(0)``, bitwise equal
   (``repro_torch.launch.crosscheck``: prefill and 8 decode steps within
   the family's ``lm_ulps`` bfloat16 ulps, every cache leaf too, the
   server's greedy tokens, and the MoE routing with its forks counted),
   and the reduced seamless-m4t-medium the same way through
   ``make_prefill_step`` / ``make_decode_step``
   (``crosscheck.encdec_card_against_cpu``: the encoder's memory too);
   (c) ``Server("qwen2.5-14b", reduced=False)`` at full width, its 14.77 B
   parameters drawn through ``jaxrand`` on the card (the draw's wall time),
   answering ``main()``'s 4 requests: parameter bytes, peak memory, ms per
   decode step beside the least time the card could take, tokens/s, and
   the teacher-forced decode against ``prefill`` on one 8-token prompt;
   (d) the same for ``Server("qwen3-moe-30b-a3b", reduced=False)`` (48
   layers of 128 experts top-8, 30.53 B parameters), after (c)'s server is
   freed, its ms per decode step beside two bounds (the dense dispatch,
   which reads every expert, and a dispatch that would read only the
   routed ones), the teacher-forced decode against ``prefill``
   reported with the choices the prefill dropped, not gated, and gated:
   decode step 0 against the prefill of its one token (capacity drops
   nothing at S = 1; logits within ``LM_ULPS``, routing equal), and layer
   0's MoE block on 8 tokens against a plain float32 MoE written token by
   token (``_moe_plain``); (e) the recurrent families at full width,
   ``Server("zamba2-1.2b", reduced=False)`` (38 Mamba2 layers at d 2048,
   one shared attention block used before each group of 7) and
   ``Server("xlstm-125m", reduced=False)`` (10 mLSTM and 2 sLSTM blocks at
   d 768), each answering ``main()``'s 4 requests: the draw's wall time,
   parameter bytes, peak memory, ms per decode step beside the least time
   for a step's bytes (the shared block's weights once per use), tokens/s,
   device busy time and launches per step; gated: decode step 0 against
   the 1-token prefill, and an 8-token prompt's full forward against its
   teacher-forced decode, each within the family's ``crosscheck.lm_ulps``
   (16 xLSTM, 6 zamba2: the recurrence carries a rounding flip to every
   later position); (f) the encoder-decoder seamless-m4t-medium at full
   width (12 + 12 layers at d 1024, 0.877 B parameters) through
   ``steps.init_params_for``, ``make_prefill_step`` and
   ``make_decode_step`` (``crosscheck.encdec_generate``; the reference's
   ``Server`` serves decoder LMs only): ``main()``'s 4 requests, each with
   its own 1024 seeded frames: the draw's wall time, peak memory, the
   encode-plus-prefill wall, device time and launches, ms per decode step
   beside its bound (``_encdec_step_bound``), tokens/s, device time and
   launches of a decode step; gated within ``crosscheck.lm_ulps``: the
   prefill's last logits against the decode step on the prompt's last
   token, its K/V against the decode cache, and an 8-token forward
   against its teacher-forced decode;
17. LM training (``phase_train``): (a) the reduced qwen2.5-14b,
   starcoder2-15b, internvl2-2b, zamba2-1.2b, xlstm-125m (these two
   within their families' tolerances) and seamless-m4t-medium: the float32
   and bfloat16 ``jaxrand`` draws on the card bitwise the CPU's, one train
   step on the card against the CPU within the training tolerances of
   ``launch.crosscheck``, and, for qwen2.5-14b and seamless-m4t-medium, a
   12-step ``train_loop`` failing at step 9 and resumed from its
   checkpoint against the straight run (within 1e-4; bit for bit or not,
   and which parameter leaves differ); (b)
   ``train_loop("internvl2-2b", 6, reduced=False, batch=8, seq=64)``:
   parameters and bytes, the draw's wall time, the step-1 loss in (0.5 ln
   V, 2.5 ln V), the parameters moved, ms per step against
   ``train_bound``, tokens/s, device busy time and launches in a profiled
   step, peak memory, and the bytes a checkpoint would hold; (c) the
   reduced qwen3-moe-30b-a3b and qwen2-moe-a2.7b: the draws bitwise the
   CPU's, one train step on the card against the CPU within the training
   tolerances with its routing forks, and ``examples/train_lm.py``'s
   40-step run failing at step 25 and resumed from its step-20
   checkpoint against the straight run (within 1e-4; bit for bit or not);
   (d) ``train_loop("seamless-m4t-medium", 4, reduced=False, batch=8,
   seq=64)`` with 1024 ones frames, as (b) reports it, its bound counting
   the encoder's parameters over the frames (``train_bound``);
18. the LM launch code (``phase_launch``) on a world-1 NCCL process group:
   (a) internvl2-2b's full-width train step on a 1 x 1 (data, model) mesh
   through ``make_train_step(policy=MeshPolicy(mesh))``, parameters and
   Adam's moments as ``DTensor``s, bit for bit the plain step on the same
   parameters and batch, with ms per step, peak memory, launches and the
   collective bytes of each; (b) ``compressed_allreduce_mean`` on NCCL
   over the full-width gradient tree (ms, wire bytes) and on a seeded
   slice bit for bit the same function on gloo on the CPU; (c) the dry run
   over every arch x shape on the 16 x 16 and 2 x 16 x 16 meshes, no
   ``error`` record, each cell's dominant roofline term and the cells
   whose sharded step needs more than one card's memory.

The lines before the last carry the card (``nvidia-smi``), the per-layer
times, decisions/s, the launch counts and one JSON object ``{"kernels":
[...]}``; the last line is ``{"ok": true, "device": {...}}``.  In the
kernels line, ``imc_fused``'s ``ms``, ``plain_ms`` and ``bound_ms`` are
for the work of one steady-state hop tick (the five IMC layers at the
hop-1024 tail shapes, B = 8): median device time from ``torch.profiler`` (CUDA-event
time per call where the profiler records no device activity), and the
least time the card could take for the same bytes and operations.
``launches`` is the count from the main path's served run,
``launches_front_door`` K1's counts on the front door's paths and
``launches_reliability`` those of phase 9's kernel runs,
``launches_pipeline`` phase 11's (its ``evaluate_hw`` and ``hw_features``
calls), ``launches_obs`` phase 12's served run with telemetry on,
``launches_snapshot`` phase 13's restored server's 12 ticks,
``launches_sharded`` phase 14's noise-free fleet run and
``launches_compiled`` phase 15's compiled run of phase 3's traffic on a
clean chip (its replays' launches included) and ``launches_examples``
phase 16's three examples (``head_train_rows`` too); phase 2's
totals at every shape of ``K1_SHAPES`` are under ``layers_totals`` in the
JSON object printed before the summaries.  The
``head_train_rows`` row is one launch at the customization path's shape
(three session rows of 10 utterances, budgets 10, 7, 10) with its
launches in phase 4's run (``launches_sessions4``: phase 13's four
sessions); the ``sga_update_rows`` row counts the RGP
run's launches.  The ``imc_mav`` row is one per-group forward's 41
launches at a full window (its launches counted in phase 6; its
``library_ms`` is the float32 ``torch.matmul`` of the 41 products alone),
the ``int8_matmul`` row the FC head's shape (its ``library_ms`` is
``torch._int_mm`` on the operands zero-padded to 32 x 576 x 16, the
product alone).  Without a CUDA device,
or outside a checkout, the script exits non-zero.

    python3 chip_smoke.py --layers [DIR]

runs phase 2 alone, against the port in the checkout DIR (default: this
one), and prints no result line: run it on an unpacked older commit and
on this one in turns, in one chip call, to compare two versions of K1.

    python3 chip_smoke.py --tiles [DIR]

runs phase 5 alone (K5 and K4: checks, planned tiles, times) against the
port in DIR in the same way, to compare two versions of K5 and K4.

    python3 chip_smoke.py --sga [DIR]

builds the SGA kernels of the port in the checkout DIR (default: this
one) and runs phase 4's K3 times alone (``k3_tree_times``: N = 5770, the
paper net's float parameter tree, 2**26) against that port, and prints
no result line: run it on an unpacked older commit and on this one in
turns, in one chip call, to compare two versions of K3.

    python3 chip_smoke.py --compiled

builds the kernels and runs phase 15 alone (compiled ticks), and prints
no result line.

    python3 chip_smoke.py --examples

builds the kernels and runs phase 16 alone (the examples and the LM
server), and prints no result line.

    python3 chip_smoke.py --train

builds the kernels and runs phase 17 alone (LM training), and prints no
result line.

    python3 chip_smoke.py --launch

builds the kernels and runs phase 18 alone (the launch code), and prints
no result line.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HOP, SLOTS, HOPS, B = 1024, 8, 24, 8
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and tensor-core
# operations/s.  ±1 fp32 operands are exact in TF32, so a ±1 product could
# run at the TF32 rate; K1's operands (x in {-1, 0, +1}, w ±1) are exact
# in int8, and its products run at the int8 rate.
H100_BYTES_PER_S = 3.35e12
H100_TF32_OPS_PER_S = 495e12
H100_FP32_OPS_PER_S = 67e12       # float32 outside the tensor cores
H100_INT8_OPS_PER_S = 1979e12    # int8 tensor-core operations/s
H100_BF16_OPS_PER_S = 989e12     # bfloat16 tensor-core operations/s
KERNEL_SOURCE = "src/repro_torch/kernels/imc_mav/csrc/imc_fused.cu"
REPLACES = "src/repro/kernels/imc_mav/imc_mav.py:141"
SGA_SOURCE = "src/repro_torch/kernels/sga_update/csrc/sga_update.cu"
# head_train_rows takes over K2's launches on the customization path (with
# the epoch around them, src/repro/serving/customize.py::_train_round)
SGA_REPLACES = {"head_train_rows":
                "src/repro/kernels/sga_update/sga_update.py:57",
                "sga_update_rows":
                "src/repro/kernels/sga_update/sga_update.py:57",
                "sga_update": "src/repro/kernels/sga_update/sga_update.py:89"}
MAV_SOURCE = "src/repro_torch/kernels/imc_mav/csrc/imc_mav.cu"
MAV_REPLACES = "src/repro/kernels/imc_mav/imc_mav.py:67"
I8_SOURCE = "src/repro_torch/kernels/int8_matmul/csrc/int8_matmul.cu"
I8_REPLACES = "src/repro/kernels/int8_matmul/int8_matmul.py:34"
K3_BIG = 1 << 26                  # the large flat leaf of the K3 rows
K3_TREE_LEAVES = 70               # a tree over one launch's 64 leaves
# the third session takes the test mode's read noise (calib_sa_noise_std)
N_UTTS, EPOCHS, PER_TICK = 10, 200, (10, 7, 10)
CALIB_NOISE = (0.0, 0.0, 1.0)
SA_STD, OFFSET_STD = 1.0, 4.0     # the noisy chip of the noisy phases


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


def host_ms(torch, fn, reps=7, iters=50):
    """Median host milliseconds per call of ``fn``: the wall time of
    issuing ``iters`` calls back to back, without waiting for the card
    (which keeps up), over ``iters``."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        times.append((time.perf_counter() - t0) / iters * 1e3)
        torch.cuda.synchronize()
    return statistics.median(times)


def device_ms(torch, fn, reps=7, iters=20, records=None, kernel=None):
    """Median device time per call of ``fn``: in each of ``reps`` profiled
    runs of ``iters`` calls, the summed own time of the device activities
    (kernels, copies) that ``torch.profiler`` records, over ``iters``; a
    run in which the profiler recorded no device activity is left out.
    None when no run recorded any (then only the CUDA-event times
    stand).  ``records``, when given, receives each counted run's device
    activities per call (fewer than ``fn`` launches means dropped
    records).  ``kernel``, when given, counts only the activities whose
    name holds it."""
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
        total_us, rows = device_time(torch, prof)
        if kernel is not None:
            rows = {k: v for k, v in rows.items() if kernel in k}
            total_us = sum(us for us, _ in rows.values())
        if total_us > 0:
            per_call.append(total_us / iters / 1e3)
            if records is not None:
                records.append(sum(n for _, n in rows.values()) / iters)
    return statistics.median(per_call) if per_call else None


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
    read once, the output written once, 2 operations per ±1 product.  The
    weights are the kernel's operand, the fold-time int8 B rows (one row
    of whole 32-byte k-steps per tap and output channel); the rest is
    fp32."""
    cpg = c_in // groups
    t_out = (t - k) // stride + 1
    t_pool = t_out // pool
    floats = (b * t * c_in                         # activations in
              + (3 if chip else 2) * c_out         # bias, flip, offset
              + b * t_pool * c_out                 # activations out
              + (b * t_out * c_out if noise else 0))
    weight_bytes = k * c_out * -(-cpg // 32) * 32
    ops = 2 * b * t_pool * pool * c_out * k * cpg
    return 4 * floats + weight_bytes, ops


def bound_ms(nbytes, ops, ops_per_s=H100_TF32_OPS_PER_S):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_build(torch):
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch import kernels
    from repro_torch.kernels.imc_mav import ops
    from repro_torch.kernels.int8_matmul import ops as i8_ops
    from repro_torch.kernels.sga_update import ops as sga_ops
    libs = {"imc_fused": (ops.SOURCE, ops.library),
            "sga_update": (sga_ops.SOURCE, sga_ops.library),
            "imc_mav": (ops.MAV_SOURCE, ops.mav_library),
            "int8_matmul": (i8_ops.SOURCE, i8_ops.library)}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(libs)) as pool:   # one nvcc per source
        futs = [pool.submit(kernels.build_library, name, [src])
                for name, (src, _) in libs.items()]
        for fut in futs:
            fut.result()
    for _, load in libs.values():
        load()
    log(f"[build] {', '.join(libs)} built and loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, (src, _) in libs.items():
        logfile = kernels.library_path(name, [src])
        logfile = logfile.with_name(logfile.name + ".log")
        for line in logfile.read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"[build] {name}: {line.strip()}")
    return card()


def card():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(smi)
    return smi


def _layer_inputs(torch, gen, dev, b, t, c_in, c_out, groups, stride,
                  kind="pm1"):
    """Random activations, ±1 weights, even biases on the word-line grid
    [-64, 64], ±1 flips, chip offsets and a pre-sign noise operand.  The
    activations are ±1 (``pm1``), ±1 with streams 2 and 5 all zero
    (``zero_streams``: the carries of free slots) or each in {-1, 0, +1}
    (``ternary``)."""
    def pm1(*shape):
        return (torch.randint(0, 2, shape, generator=gen, device=dev)
                .float() * 2 - 1)
    if kind == "ternary":
        x = torch.randint(-1, 2, (b, t, c_in), generator=gen,
                          device=dev).float()
    else:
        x = pm1(b, t, c_in)
        if kind == "zero_streams":
            x[2] = 0.0
            x[5] = 0.0
    w = pm1(3, c_in // groups, c_out)
    bias = torch.round(torch.randn(c_out, generator=gen, device=dev) * 8) * 2
    flip = pm1(c_out)
    off = 4.0 * torch.randn(c_out, generator=gen, device=dev)
    t_out = (t - 3) // stride + 1
    noise = torch.randn((b, t_out, c_out), generator=gen, device=dev)
    return x, w, bias.clamp(-64, 64), flip, off, noise


# K1's timed shapes, (name, streams, hop): the full window, the per-hop
# tails of hop 1024 (the steady served tick), of the dynamic hop's widened
# hops 2048 and 4096, and of hop 1024 at the admission run's 16 slots
# (``CROWD_MAX``)
K1_SHAPES = (("window", B, HOP), ("hop", B, HOP), ("hop2048", B, 2 * HOP),
             ("hop4096", B, 4 * HOP), ("hop_b16", 16, HOP))


def phase_layers(torch, dev):
    """Kernel vs plain version per IMC layer at every shape of
    ``K1_SHAPES``, on ±1, zero-stream and ternary activations, bitwise and
    one launch a call; then times, all in this one phase so the shapes
    are timed alike."""
    from repro_torch.kernels.imc_mav import ops, ref
    from repro_torch.models import kws
    from repro_torch.serving import stream as sv

    cfg = kws.PAPER_KWS
    geoms = {hop: sv.make_stream_geometry(cfg, hop)
             for hop in {hop for _, _, hop in K1_SHAPES}}
    gen = torch.Generator(device=dev).manual_seed(1234)
    # an older checkout (``--layers DIR``) may pack fp32 group-major
    # weights and plan no tile
    pack = getattr(ops, "pack_weights_s8", None) or ops.pack_weights
    counts = getattr(ops, "COUNTS", None)
    max_err = 0.0
    rows = []
    totals = {shape: {"B": b, "hop": hop, "ms": 0.0, "plain_ms": 0.0,
                      "call_ms": 0.0, "plain_call_ms": 0.0, "bytes": 0,
                      "ops": 0, "host_ms": 0.0}
              for shape, b, hop in K1_SHAPES}
    for i in range(1, cfg.num_conv_layers):
        c_in, c_out = cfg.channels[i - 1], cfg.channels[i]
        groups, pool, stride = cfg.groups(i), cfg.pools[i], cfg.strides[i]
        for shape, b, hop in K1_SHAPES:
            lg = geoms[hop].layers[i]
            t = lg.t_in if shape == "window" else lg.tail_in
            for kind in ("pm1", "zero_streams", "ternary"):
                x, w, bias, flip, off, noise = _layer_inputs(
                    torch, gen, dev, b, t, c_in, c_out, groups, stride, kind)
                packed = pack(w, groups)
                for case, o, n in (("clean", None, None),
                                   ("chip", off, None),
                                   ("noise", off, noise)):
                    if counts is not None:
                        counts.reset()
                    got = ops.fused_conv_mav(x, w, bias, flip, groups=groups,
                                             stride=stride, pool=pool,
                                             chip_offset=o, sa_noise=n,
                                             packed=packed)
                    launched = counts.launches if counts is not None else 1
                    want = ref.fused_conv_mav_ref(x, w, bias, flip,
                                                  groups=groups,
                                                  stride=stride, pool=pool,
                                                  chip_offset=o, sa_noise=n)
                    torch.cuda.synchronize()
                    max_err = max(max_err, float((got - want).abs().max()))
                    if launched != 1 or not torch.equal(got, want):
                        raise AssertionError(
                            f"conv{i} {shape} B={b} {kind} {case}: "
                            f"{launched} launches, kernel differs from the "
                            f"plain version on "
                            f"{(got != want).sum().item()} of "
                            f"{got.numel()} outputs")
            # time the served configuration through the entry the path
            # calls: chip offsets, no noise (on the last inputs: the
            # kernel's work does not depend on values)
            kernel = lambda: ops.fused_conv_mav(
                x, w, bias, flip, groups=groups, stride=stride, pool=pool,
                chip_offset=off, packed=packed)
            plain = lambda: ref.fused_conv_mav_ref(
                x, w, bias, flip, groups=groups, stride=stride, pool=pool,
                chip_offset=off)
            k_call, p_call = cuda_ms(torch, kernel), cuda_ms(torch, plain)
            records = []
            k_dev = device_ms(torch, kernel, records=records)
            p_dev = device_ms(torch, plain)
            k_host = host_ms(torch, kernel)
            k_ms = k_dev if k_dev is not None else k_call
            p_ms = p_dev if p_dev is not None else p_call
            nbytes, nops = layer_work(b, t, c_in, c_out, groups, stride,
                                      pool, chip=True, noise=False)
            b_ms, b_by = bound_ms(nbytes, nops, H100_INT8_OPS_PER_S)
            tot = totals[shape]
            tot["ms"] += k_ms
            tot["plain_ms"] += p_ms
            tot["call_ms"] += k_call
            tot["plain_call_ms"] += p_call
            tot["bytes"] += nbytes
            tot["ops"] += nops
            tot["host_ms"] += k_host
            t_pool = ((t - 3) // stride + 1) // pool
            tile = (ops.block_tile(b, t_pool, groups, c_out // groups, 3,
                                   stride, pool, dev)[:2]
                    if hasattr(ops, "block_tile") else None)
            rec = statistics.median(records) if records else None
            rows.append(dict(layer=f"conv{i}", shape=shape, B=b, hop=hop,
                             T=t, c_in=c_in, c_out=c_out, groups=groups,
                             tile=tile, kernel_device_ms=k_dev,
                             plain_device_ms=p_dev, kernel_call_ms=k_call,
                             plain_call_ms=p_call, kernel_host_ms=k_host,
                             kernel_records_per_call=rec,
                             bound_ms=b_ms, bound_by=b_by,
                             over_bound=k_ms / b_ms))
            log(f"[layer] conv{i} {shape:7s} B={b:2d} T={t:5d} "
                f"{c_in:3d}->{c_out:3d} g={groups:2d} tile {tile}: device "
                f"time kernel {k_ms:.5f} ms ({rec} profiler records a "
                f"call), bound {b_ms:.5f} ms ({b_by}), {k_ms / b_ms:.2f}x "
                f"the bound; plain {p_dev} ms; per call (CUDA events) "
                f"kernel {k_call:.4f} ms, plain {p_call:.4f} ms; wrapper "
                f"host time {k_host:.4f} ms; bitwise equal, one launch a "
                f"call (pm1/zero streams/ternary x clean/chip/noise)")
    for shape, tot in totals.items():
        b_ms, b_by = bound_ms(tot["bytes"], tot["ops"], H100_INT8_OPS_PER_S)
        tot["bound_ms"], tot["bound_by"] = b_ms, b_by
        log(f"[layer] five layers, {shape} shapes (B={tot['B']}, hop "
            f"{tot['hop']}): kernel {tot['ms']:.5f} ms, plain "
            f"{tot['plain_ms']:.4f} ms (device time), bound {b_ms:.6f} ms "
            f"({b_by}), {tot['ms'] / b_ms:.2f}x the bound; per call (CUDA "
            f"events) kernel {tot['call_ms']:.4f} ms, plain "
            f"{tot['plain_call_ms']:.4f} ms; wrapper host time "
            f"{tot['host_ms']:.4f} ms")
    return rows, totals, max_err


# group widths off the paper net's cpg 24: the nets of cpg 6 and 48
WIDTH_NETS = {
    "cpg6": dict(channels_per_group=6),
    "cpg48": dict(channels=(48, 96, 192, 288, 384, 576),
                  channels_per_group=48),
}


def phase_widths(torch, dev):
    """K1 at every IMC layer of the cpg-6 and cpg-48 nets at full width
    (B = 8, a full window and the hop-1024 tail), on ±1, zero-stream and
    ternary activations, clean / chip / noise: bitwise against the plain
    version, one launch a call; the kernel's device time at the full
    window beside its bound."""
    from repro_torch.kernels.imc_mav import ops, ref
    from repro_torch.models import kws
    from repro_torch.serving import stream as sv

    gen = torch.Generator(device=dev).manual_seed(2024)
    max_err, rows = 0.0, []
    for net, kw in WIDTH_NETS.items():
        cfg = kws.KWSConfig(**kw)
        geom = sv.make_stream_geometry(cfg, HOP)
        for i in range(1, cfg.num_conv_layers):
            c_in, c_out = cfg.channels[i - 1], cfg.channels[i]
            groups, pool, stride = cfg.groups(i), cfg.pools[i], cfg.strides[i]
            lg = geom.layers[i]
            for shape, t in (("window", lg.t_in), ("hop", lg.tail_in)):
                for kind in ("pm1", "zero_streams", "ternary"):
                    x, w, bias, flip, off, noise = _layer_inputs(
                        torch, gen, dev, B, t, c_in, c_out, groups, stride,
                        kind)
                    packed = ops.pack_weights_s8(w, groups)
                    for case, o, n in (("clean", None, None),
                                       ("chip", off, None),
                                       ("noise", off, noise)):
                        ops.COUNTS.reset()
                        got = ops.fused_conv_mav(
                            x, w, bias, flip, groups=groups, stride=stride,
                            pool=pool, chip_offset=o, sa_noise=n,
                            packed=packed)
                        launched = ops.COUNTS.launches
                        want = ref.fused_conv_mav_ref(
                            x, w, bias, flip, groups=groups, stride=stride,
                            pool=pool, chip_offset=o, sa_noise=n)
                        torch.cuda.synchronize()
                        max_err = max(max_err,
                                      float((got - want).abs().max()))
                        if launched != 1 or not torch.equal(got, want):
                            raise AssertionError(
                                f"{net} conv{i} {shape} {kind} {case}: "
                                f"{launched} launches, kernel differs from "
                                f"the plain version on "
                                f"{(got != want).sum().item()} outputs")
                if shape == "window":
                    kernel = lambda: ops.fused_conv_mav(
                        x, w, bias, flip, groups=groups, stride=stride,
                        pool=pool, chip_offset=off, packed=packed)
                    k_ms = device_ms(torch, kernel) or cuda_ms(torch, kernel)
                    b_ms, b_by = bound_ms(*layer_work(
                        B, t, c_in, c_out, groups, stride, pool, chip=True,
                        noise=False), H100_INT8_OPS_PER_S)
                    t_pool = ((t - 3) // stride + 1) // pool
                    tile = ops.block_tile(B, t_pool, groups, c_out // groups,
                                          3, stride, pool, dev,
                                          cpg=c_in // groups)
                    rows.append(dict(net=net, layer=f"conv{i}",
                                     groups=groups, cpg=c_in // groups,
                                     cog=c_out // groups, tile=tile,
                                     window_ms=k_ms, bound_ms=b_ms))
                    log(f"[widths] {net} conv{i} {c_in}->{c_out} g={groups} "
                        f"(cpg {c_in // groups}, cog {c_out // groups}) tile "
                        f"{tile}: bitwise equal at the window and the hop "
                        f"tail (pm1/zero streams/ternary x clean/chip/"
                        f"noise); full window device time {k_ms:.5f} ms, "
                        f"bound {b_ms:.5f} ms ({b_by}), "
                        f"{k_ms / b_ms:.2f}x")
    return dict(rows=rows, max_abs_err=max_err)


def _traffic(cfg, n_streams=SLOTS, gap_hops=6, hops=HOPS):
    """Streams of keyword audio: utterance, ``gap_hops`` silent hops,
    utterance, cut to a window and ``hops`` hops (the served phase's: 8
    streams, 6 silent hops, 24 hops)."""
    import numpy as np
    from repro_torch.data import audio
    utts, _ = audio.make_dataset(seed=0, n_per_class=1, n_speakers=4,
                                 augment=False, length=cfg.sample_len)
    gap = np.random.default_rng(1).uniform(-1e-4, 1e-4, gap_hops * HOP)
    n = cfg.sample_len + hops * HOP
    streams = []
    for s in range(n_streams):
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
    from repro_torch.core import jaxrand
    from repro_torch.kernels.imc_mav import ops
    from repro_torch.models import kws
    from repro_torch.serving.scheduler import StreamServer
    from repro_torch.serving.vad import VADConfig

    cfg = kws.PAPER_KWS
    gen = torch.Generator().manual_seed(0)
    params = kws.init_params(jaxrand.PRNGKey(0, device="cpu"), cfg,
                             device=dev)
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


def sga_cases(torch, gen, dev, lrs, n):
    """B = len(lrs) rows of n: Q1.7 weights and gradients, Q1.15 banks
    from a seeded generator, with tie cases placed in every row."""
    lsb_w, lsb_a = 2.0 ** -7, 2.0 ** -15
    b = len(lrs)
    lr = torch.tensor(lrs, dtype=torch.float32, device=dev)
    g_th = (lsb_w / 2) / lr

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen,
                             device=dev).float()

    w = ints(-128, 128, (b, n)) * lsb_w
    g = (torch.round(torch.randn((b, n), generator=gen, device=dev) * 10)
         * lsb_w).clamp(-1.0, 127 * lsb_w)
    a = ints(-3000, 3001, (b, n)) * lsb_a
    for r in range(b):
        idx = torch.randperm(n, generator=gen, device=dev)[:320].reshape(
            8, 40)
        sign = ints(0, 2, (40,)) * 2 - 1
        th = g_th[r]
        g[r, idx[0]] = th * sign                 # |g| == g_th
        g[r, idx[1]] = th / 2                    # bank lands on g_th
        a[r, idx[1]] = th - th / 2
        a[r, idx[2]] = ints(-200, 200, (40,)) * lsb_a
        g[r, idx[2]] = (lsb_a / 2) * sign        # half a bank LSB
        g[r, idx[3]] = (-lsb_w / 2) / lr[r]      # half a weight LSB
        a[r, idx[3]] = 0.0
        w[r, idx[4]], g[r, idx[4]] = 127 * lsb_w, -0.5   # upper rail
        w[r, idx[5]], g[r, idx[5]] = -1.0, 0.5           # lower rail
        g[r, idx[6]] = 0.0
        a[r, idx[7]] = 0.0
    return w, g, a, lr, g_th


# logits (times -1/16) whose LUT softmax rounds an exact tie (codes sum
# to 1536: two classes at p * 256 = 21.5)
TIE_KS = [0, 15, 1, 10, 11, 6, 8, 15, 13, 11]


def head_cases(torch, gen, dev, ns, d=576, c=10):
    """One session row per entry of ``ns`` (utterances) at the paper head:
    Q1.3.4 features in [-1, 1], one-hot labels, a Q1.7 head, Q1.15 banks;
    row 0's first utterance has zero features and biases that put its
    softmax on a tie."""
    def q7(x):
        return torch.clamp(torch.round(x * 128), -128, 127) / 128

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen,
                             device=dev).float()

    rows = {k: [] for k in ("w", "b", "aw", "ab", "f", "onehot")}
    for r, n in enumerate(ns):
        f = ints(-16, 17, (n, d)) / 16
        b = q7(torch.randn(c, generator=gen, device=dev) * 0.05)
        if r == 0:
            f[0] = 0.0
            b = -torch.tensor(TIE_KS, dtype=torch.float32, device=dev) / 16
        labels = torch.randint(0, c, (n,), generator=gen, device=dev)
        rows["f"].append(f)
        rows["onehot"].append(torch.nn.functional.one_hot(labels, c).float())
        rows["w"].append(q7(torch.randn((d, c), generator=gen, device=dev)
                            / d ** 0.5))
        rows["b"].append(b)
        rows["aw"].append(ints(-3000, 3001, (d, c)) * 2.0 ** -15)
        rows["ab"].append(ints(-3000, 3001, (c,)) * 2.0 ** -15)
    return rows


def head_train_work(ns, budgets, d=576, c=10):
    """(bytes, operations) of a fused head-training launch: per row the
    state and banks read and written once, its features and labels read
    once (and the 256-entry LUT); per epoch the forward and the gradient
    (2 N D C multiply-adds), ~25 operations per element of the update and
    ~20 per logit of the softmax and error."""
    nbytes, ops = 4 * 256, 0
    for n, e in zip(ns, budgets):
        nbytes += 4 * (2 * 2 * (d * c + c) + n * d + n * c)
        ops += e * (4 * n * d * c + 25 * (d * c + c) + 20 * n * c)
    return nbytes, ops


def exact_exponent(k, mode):
    """ceil / floor of log2(1 / (k / 256)) on the float32 value of the
    division, from its binary exponent."""
    import math
    import numpy as np
    if k == 0:
        return 0
    inv = float(np.float32(1.0) / np.float32(k / 256.0))
    mant, ex = math.frexp(inv)                 # inv = mant * 2**ex
    floor = ex - 1
    return floor if (mode == "floor" or mant == 0.5) else ex


def k3_leaves(torch, gen, dev, sizes, lr):
    """Leaves of ``sizes`` elements cut from one ``sga_cases`` row (tie
    cases included), each a fresh allocation: (ws, gs, accs), g_th."""
    w, g, a, _, th = sga_cases(torch, gen, dev, [lr], sum(sizes))
    leaves, off = ([], [], []), 0
    for n in sizes:
        for out, v in zip(leaves, (w, g, a)):
            out.append(v[0, off:off + n].clone())
        off += n
    return leaves, float(th[0])


def k3_check(torch, tree_w, tree_g, tree_a, lr, g_th, launches, what):
    """The flat entry on one tree against the plain version leaf by leaf,
    bitwise, in ``launches`` launches; returns the largest difference."""
    from repro_torch.kernels.sga_update import ops as sga_ops
    from repro_torch.kernels.sga_update.ref import sga_update_ref
    sga_ops.COUNTS_FLAT.reset()
    got_w, got_a = sga_ops.sga_update_tree(tree_w, tree_g, tree_a, lr, g_th)
    n_launch = sga_ops.COUNTS_FLAT.launches
    flat = [sga_ops._flatten(t)[0] for t in (tree_w, tree_g, tree_a,
                                              got_w, got_a)]
    err = 0.0
    for w, g, a, nw, na in zip(*flat):
        pw, pa = sga_update_ref(
            w, g, a, torch.tensor(lr, dtype=torch.float32, device=w.device),
            torch.tensor(g_th, dtype=torch.float32, device=w.device))
        for x, y in ((nw, pw), (na, pa)):
            if x.shape != y.shape or not torch.equal(x, y):
                raise AssertionError(f"sga_update {what}: a leaf of "
                                     f"{w.numel()} differs from the plain "
                                     f"version")
            if x.numel():
                err = max(err, float((x - y).abs().max()))
    if n_launch != launches:
        raise AssertionError(f"sga_update {what}: {n_launch} launches, "
                             f"expected {launches}")
    return err


def k3_tree_checks(torch, gen, dev):
    """The flat entry on whole trees, bitwise, one launch a tree (two for
    ``K3_TREE_LEAVES``); a tree on two devices refused.  Returns the
    largest difference and the paper net's float parameter tree's leaf
    sizes."""
    import collections
    from repro_torch.core import jaxrand
    from repro_torch.kernels.sga_update import ops as sga_ops
    from repro_torch.models import kws
    Pair = collections.namedtuple("Pair", "w b")
    lr = 1 / 16
    # ragged leaves in nested dicts, lists and a namedtuple; the last a
    # view at a 4-byte offset
    (ws, gs, accs), th = k3_leaves(torch, gen, dev, (1, 3, 1023, 1025, 5770,
                                                     4096, 4097, 5771), lr)
    for v in (ws, gs, accs):
        v[-1] = v[-1][1:]

    def ragged(v):
        return {"fc": Pair(v[0], v[1]), "convs": [v[2], {"x": v[3]},
                                                 (v[4], v[5])],
                "z": v[6].reshape(17, 241), "view": v[7]}
    err = k3_check(torch, ragged(ws), ragged(gs), ragged(accs), lr, th, 1,
                   "ragged tree")
    # the paper net's float parameter tree
    params = kws.init_params(jaxrand.PRNGKey(0, device=dev), kws.PAPER_KWS,
                             device=dev)
    leaves, rebuild = sga_ops._flatten(params)
    (ws, gs, accs), th = k3_leaves(torch, gen, dev,
                                   [v.numel() for v in leaves], 0.05)
    shaped = lambda vs: rebuild([v.reshape(p.shape)
                                 for v, p in zip(vs, leaves)])
    err = max(err, k3_check(torch, shaped(ws), shaped(gs), shaped(accs),
                            0.05, th, 1, f"paper tree ({len(leaves)} "
                            f"leaves)"))
    # over one launch's leaves: two launches
    (ws, gs, accs), th = k3_leaves(
        torch, gen, dev, [37 * i + 1 for i in range(K3_TREE_LEAVES)], 1 / 128)
    err = max(err, k3_check(torch, ws, gs, accs, 1 / 128, th, 2,
                            f"{K3_TREE_LEAVES}-leaf tree"))
    # one large leaf
    w, g, a, lr_t, th_t = sga_cases(torch, gen, dev, [0.05], K3_BIG)
    err = max(err, k3_check(torch, [w[0]], [g[0]], [a[0]], 0.05,
                            float(th_t[0]), 1, f"leaf of {K3_BIG}"))
    del w, g, a
    try:
        sga_ops.sga_update_tree({"a": ws[0], "b": ws[1].cpu()},
                                {"a": gs[0], "b": gs[1].cpu()},
                                {"a": accs[0], "b": accs[1].cpu()}, 1 / 128,
                                th)
    except ValueError as e:
        if "more than one device" not in str(e):
            raise
    else:
        raise AssertionError("sga_update_tree took a tree on two devices")
    log(f"[sga] sga_update (K3) bitwise equal to the plain version on a "
        f"ragged tree (1-5770 elements, a view at a 4-byte offset), the "
        f"paper net's {len(leaves)}-leaf tree and a leaf of {K3_BIG}, one "
        f"launch each, and on {K3_TREE_LEAVES} leaves in two; a tree on two "
        f"devices refused")
    return err, [v.numel() for v in leaves]


def k3_device_ms(torch, kern, plain, iters=10):
    """Device milliseconds per call of K3 (every activity named ``sga_``:
    ``sga_tree_kernel``, or an older port's ``sga_update_kernel``) and of
    the plain version (every other device activity), from one profiled run
    of ``iters`` calls of each (a profiler session costs more host time
    than these calls); Nones when the profiler did not record both."""
    from torch.profiler import ProfilerActivity, profile
    kern()
    plain()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            kern()
            plain()
        torch.cuda.synchronize()
    total, rows = device_time(torch, prof)
    k = sum(us for name, (us, _) in rows.items() if "sga_" in name)
    if k <= 0 or total - k <= 0:
        return None, None
    return k / iters / 1e3, (total - k) / iters / 1e3


def held_ms(prof_ms, call_ms, bound):
    """A profiled device time where it is at least ``bound``, the least
    time the card can take; else (no record, or a reading under the bound,
    which no run can reach) the CUDA events' time per call."""
    return prof_ms if prof_ms is not None and prof_ms >= bound else call_ms


def paper_leaf_sizes(torch, dev):
    """Element counts of the paper net's float parameter tree's leaves."""
    from repro_torch.core import jaxrand
    from repro_torch.kernels.sga_update import ops as sga_ops
    from repro_torch.models import kws
    params = kws.init_params(jaxrand.PRNGKey(0, device=dev), kws.PAPER_KWS,
                             device=dev)
    return [v.numel() for v in sga_ops._flatten(params)[0]]


def k3_tree_times(torch, gen, dev, paper, max_err):
    """K3's times at N = 5770, on the paper net's float parameter tree
    (leaf sizes ``paper``) and at ``K3_BIG``, through ``sga_update_tree``
    of the port under test (one launch a tree; one a leaf in a port from
    before the tree entry, ``--sga DIR``): the kernel's and the plain
    version's device times from one profiled run of the two
    (``k3_device_ms``) and their CUDA-event times per call, and the
    launches a call.  The time reported is the profiled one held to the
    bytes bound (``held_ms``: w, g, a in; w, a out: 20 bytes an element),
    but at ``K3_BIG`` the events' time: there a call's launch gap is
    microseconds against ~0.45 ms, and profiled sessions have read from
    0.87 to 1.27 times the bound's rate.  Returns the K3 row, N = 5770's
    figures at its top."""
    from repro_torch.kernels.sga_update import ops as sga_ops
    from repro_torch.kernels.sga_update.ref import sga_update_ref
    out = {}
    for label, sizes, lr in (("n5770", [576 * 10 + 10], 1 / 16),
                             ("paper_tree", paper, 0.05),
                             ("big", [K3_BIG], 0.05)):
        (ws, gs, accs), th = k3_leaves(torch, gen, dev, sizes, lr)
        lr_t = torch.tensor(lr, dtype=torch.float32, device=dev)
        th_t = torch.tensor(th, dtype=torch.float32, device=dev)
        kern = lambda: sga_ops.sga_update_tree(ws, gs, accs, lr, th)
        plain = lambda: [sga_update_ref(w, g, a, lr_t, th_t)
                         for w, g, a in zip(ws, gs, accs)]
        sga_ops.COUNTS_FLAT.reset()
        kern()
        launches = sga_ops.COUNTS_FLAT.launches
        k_call = cuda_ms(torch, kern, reps=5)
        p_call = cuda_ms(torch, plain, reps=3, iters=3)
        k_dev, p_dev = k3_device_ms(torch, kern, plain)
        n = sum(sizes)
        t_bytes, t_ops = 20 * n / H100_BYTES_PER_S * 1e3, \
            12 * n / H100_FP32_OPS_PER_S * 1e3
        bound = max(t_bytes, t_ops)
        out[label] = dict(
            leaves=len(sizes), N=n, launches=launches,
            ms=k_call if label == "big" else held_ms(k_dev, k_call, bound),
            plain_ms=p_call if label == "big"
            else held_ms(p_dev, p_call, bound), device_ms=k_dev,
            plain_device_ms=p_dev, call_ms=k_call, plain_call_ms=p_call,
            bound_ms=bound,
            bound_by="bytes" if t_bytes >= t_ops else "operations")
        r = out[label]
        log(f"[sga] sga_update {label} ({len(sizes)} leaves, N={n}): "
            f"device time kernel {k_dev} ms ({launches} launch(es)), plain "
            f"{p_dev} ms; per call (CUDA events) kernel {k_call:.5f} ms, "
            f"plain {p_call:.4f} ms; bound {bound:.6f} ms "
            f"({r['bound_by']}); held {r['ms']:.5f} ms, at "
            f"{bound / r['ms']:.3f} of the bound")
        del ws, gs, accs
    row = dict(out["n5770"])
    row.update(max_abs_err=max_err, B=1,
               trees={k: v for k, v in out.items() if k != "n5770"})
    return row


def phase_sga_kernels(torch, dev):
    """K2 / K3 against the plain version on the card, bitwise, at B = 1,
    2, 8 rows of the head's width; K2's times at B = 2.  K3 on whole trees
    (``k3_tree_checks``) and its times (``k3_tree_times``).  The fused head
    training against its plain version at B = 1, 2, 3, 8 rows of N = 10
    utterances, at (3, 64) and (2, 1), fixed and dynamic error scaling;
    times at the customization path's B = 3, N = 10, budgets 10, 7, 10.
    The error-scaling exponent on the card for all 257 values."""
    from repro_torch.core import quantize
    from repro_torch.kernels.sga_update import ops as sga_ops
    from repro_torch.kernels.sga_update.ref import sga_update_ref

    t_phase = time.perf_counter()
    n = 576 * 10 + 10
    gen = torch.Generator(device=dev).manual_seed(4321)
    max_err = {"sga_update_rows": 0.0, "sga_update": 0.0}
    all_lrs = [1 / 16, 0.05, 1 / 32, 1 / 128, 0.03, 1 / 64, 0.1, 1 / 8]
    for b in (1, 2, 8):
        w, g, a, lr, g_th = sga_cases(torch, gen, dev, all_lrs[:b], n)
        got = sga_ops.sga_update_batch(w, g, a, lr, g_th)
        want = sga_update_ref(w, g, a, lr[:, None], g_th[:, None])
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            max_err["sga_update_rows"] = max(max_err["sga_update_rows"],
                                              float((x - y).abs().max()))
            if not torch.equal(x, y):
                raise AssertionError(
                    f"sga_update_rows B={b}: kernel differs from the plain "
                    f"version on {(x != y).sum().item()} elements")
        for r in range(b):
            lr_r, th_r = float(lr[r]), float(g_th[r])
            fw, fa = sga_ops.sga_update_flat(w[r], g[r], a[r], lr_r, th_r)
            pw, pa = sga_update_ref(w[r], g[r], a[r], lr[r], g_th[r])
            torch.cuda.synchronize()
            for x, y in ((fw, pw), (fa, pa)):
                max_err["sga_update"] = max(max_err["sga_update"],
                                            float((x - y).abs().max()))
                if not torch.equal(x, y):
                    raise AssertionError(
                        f"sga_update row {r} of B={b}: kernel differs from "
                        f"the plain version")
    log(f"[sga] sga_update_rows and sga_update bitwise equal to the plain "
        f"version at B = 1, 2, 8 x {n} (tie cases included)")
    t0 = time.perf_counter()
    k3_err, paper = k3_tree_checks(torch, gen, dev)
    max_err["sga_update"] = max(max_err["sga_update"], k3_err)
    k3_s = time.perf_counter() - t0

    w, g, a, lr, g_th = sga_cases(torch, gen, dev, [1 / 16, 0.05], n)
    rows = {}
    kernel2 = lambda: sga_ops.sga_update_rows(w, g, a, lr, g_th)
    plain2 = lambda: sga_update_ref(w, g, a, lr[:, None], g_th[:, None])
    for name, kern, plain, b in (("sga_update_rows", kernel2, plain2, 2),):
        k_call, p_call = cuda_ms(torch, kern), cuda_ms(torch, plain)
        k_dev, p_dev = device_ms(torch, kern), device_ms(torch, plain)
        nbytes = 20 * b * n + (8 * b if b > 1 else 0)   # w,g,a in; w,a out
        nops = 12 * b * n
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = nops / H100_FP32_OPS_PER_S * 1e3
        rows[name] = dict(
            ms=k_dev if k_dev is not None else k_call,
            plain_ms=p_dev if p_dev is not None else p_call,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            call_ms=k_call, plain_call_ms=p_call, B=b, N=n,
            max_abs_err=max_err[name])
        log(f"[sga] {name} B={b} N={n}: device time kernel {k_dev} ms, "
            f"plain {p_dev} ms; per call (CUDA events) kernel "
            f"{k_call:.4f} ms, plain {p_call:.4f} ms; bound "
            f"{rows[name]['bound_ms']:.6f} ms ({rows[name]['bound_by']})")
    t0 = time.perf_counter()
    rows["sga_update"] = k3_tree_times(torch, gen, dev, paper,
                                       max_err["sga_update"])
    k3_s += time.perf_counter() - t0
    log(f"[sga] the K3 tree checks and times took {k3_s:.1f} s")

    # the fused head training against its plain version
    from repro_torch.core import onchip_training as ot
    from repro_torch.core.onchip_training import OnChipTrainConfig
    from repro_torch.kernels.sga_update import ref as sga_ref
    lut = ot.train_lut(dev)
    starts8, budgets8 = (0, 13, 35, 190, 7, 99, 41, 3), (10, 7, 10, 10, 1,
                                                         4, 0, 9)
    max_err["head_train_rows"] = 0.0
    cases = [(b, 10) for b in (1, 2, 3, 8)] + [(3, 64), (2, 1)]
    for scaling in (dict(fixed_error_scale=1.375), dict()):
        spec = ot.head_train_spec(OnChipTrainConfig(**scaling))
        for b, n in cases:
            seed = torch.randint(0, 2 ** 30, (1,), generator=gen,
                                 device=dev).item()
            ns = [n] * b
            got, want = (head_cases(torch, torch.Generator(
                device=dev).manual_seed(seed), dev, ns) for _ in range(2))
            args = lambda t: (t["w"], t["b"], t["aw"], t["ab"], t["f"],
                              t["onehot"], list(starts8[:b]),
                              list(budgets8[:b]), lut, spec)
            sga_ops.COUNTS_HEAD.reset()
            sga_ops.head_train_batch(*args(got))
            launched = sga_ops.COUNTS_HEAD.launches
            sga_ref.head_train_rows_ref(*args(want))
            torch.cuda.synchronize()
            for k in ("w", "b", "aw", "ab"):
                for x, y in zip(got[k], want[k]):
                    max_err["head_train_rows"] = max(
                        max_err["head_train_rows"],
                        float((x - y).abs().max()))
                    if launched != 1 or not torch.equal(x, y):
                        raise AssertionError(
                            f"head_train_rows B={b} N={n} {scaling}: "
                            f"{launched} launches, {k} differs from the "
                            f"plain version")
    log(f"[sga] head_train_rows bitwise equal to the plain version at "
        f"(B, N) = {cases}, fixed and dynamic error scaling, one launch "
        f"each (a softmax tie in row 0)")
    spec = ot.head_train_spec(OnChipTrainConfig(fixed_error_scale=1.375))
    ns, budgets = [N_UTTS] * len(PER_TICK), list(PER_TICK)
    t = head_cases(torch, gen, dev, ns)
    head_args = (t["w"], t["b"], t["aw"], t["ab"], t["f"], t["onehot"],
                 [0, 10, 30], budgets, lut, spec)
    kernel_h = lambda: sga_ops.head_train_rows(*head_args)
    plain_h = lambda: sga_ref.head_train_rows_ref(*head_args)
    k_call = cuda_ms(torch, kernel_h)
    p_call = cuda_ms(torch, plain_h, reps=3, iters=2)
    k_dev = device_ms(torch, kernel_h)
    p_dev = device_ms(torch, plain_h, reps=3, iters=2)
    nbytes, nops = head_train_work(ns, budgets)
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = nops / H100_FP32_OPS_PER_S * 1e3
    rows["head_train_rows"] = dict(
        ms=k_dev if k_dev is not None else k_call,
        plain_ms=p_dev if p_dev is not None else p_call,
        bound_ms=max(t_bytes, t_ops),
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        call_ms=k_call, plain_call_ms=p_call, B=len(ns), N=N_UTTS,
        budgets=budgets, max_abs_err=max_err["head_train_rows"])
    log(f"[sga] head_train_rows B={len(ns)} N={N_UTTS} budgets {budgets}: "
        f"device time kernel {k_dev} ms, plain {p_dev} ms; per call (CUDA "
        f"events) kernel {k_call:.4f} ms, plain {p_call:.4f} ms; bound "
        f"{rows['head_train_rows']['bound_ms']:.6f} ms "
        f"({rows['head_train_rows']['bound_by']}: {nbytes} bytes, {nops} "
        f"operations)")

    bad = []
    for mode in ("ceil", "floor"):
        for k in range(257):
            err = torch.zeros((3, 10), device=dev)
            err[1, 4] = -k / 256.0
            got = int(quantize.error_scale_exponent(err, mode))
            if got != exact_exponent(k, mode):
                bad.append((mode, k, got))
    if bad:
        raise AssertionError(f"error-scale exponent differs from the exact "
                             f"one on the card: {bad[:8]}")
    # the fused kernel's own exponent arithmetic (from the quotient's
    # exponent bits) on the same 257 values
    grid = torch.arange(257, device=dev, dtype=torch.float32) / 256.0
    for mode in ("ceil", "floor"):
        got = sga_ops.head_error_exponent(grid, mode).tolist()
        want = [exact_exponent(k, mode) for k in range(257)]
        if got != want:
            raise AssertionError(f"head_train_rows' {mode} exponent differs "
                                 f"from the exact one on the card")
    log("[sga] error-scale exponent on the card equals the exact one on "
        "all 257 values k/256, ceil and floor, through torch and through "
        "head_train_rows' own arithmetic")
    log(f"[sga] the SGA kernel checks and times took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return rows


def _group_shapes(cfg):
    """Per IMC layer of the paper net at a full window: (layer, groups,
    M = B * t_conv, K = k * cpg, N = cog, stride, t_in)."""
    from repro_torch.serving import stream as sv
    geom = sv.make_stream_geometry(cfg, HOP)
    out = []
    for i in range(1, cfg.num_conv_layers):
        g = cfg.groups(i)
        lg = geom.layers[i]
        out.append((i, g, B * lg.t_conv, cfg.kernels[i] * (
            cfg.channels[i - 1] // g), cfg.channels[i] // g, cfg.strides[i],
            lg.t_in))
    return out


def phase_mav_kernels(torch, dev):
    """K5 on the per-group patch shapes of conv1..conv5 at a full window
    (B = 8), float32 and bfloat16, clean and with a noise operand, on ±1
    and on {-1, 0, +1} operands, bitwise against the plain version; its
    times beside the bound and the float32 ``torch.matmul`` of the product
    alone.  K4 at 512 x 128 x 128 (shifts 0, 4, 7) and at the FC head's
    8 x 576 x 10, bitwise; times beside the bound and ``torch._int_mm``
    (the int8 product alone).  Each kernel's planned tile where the port
    reports it (an older checkout, ``--tiles DIR``, may not)."""
    from repro_torch.kernels.imc_mav import ops, ref
    from repro_torch.kernels.int8_matmul import ops as i8_ops
    from repro_torch.kernels.int8_matmul.ref import int8_matmul_ref
    from repro_torch.models import kws

    cfg = kws.PAPER_KWS
    gen = torch.Generator(device=dev).manual_seed(555)

    def pm1(*shape):
        return (torch.randint(0, 2, shape, generator=gen, device=dev)
                .float() * 2 - 1)

    def ternary(*shape):
        return torch.randint(-1, 2, shape, generator=gen, device=dev).float()

    mav = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "matmul_ms": 0.0,
           "max_abs_err": 0.0, "bytes": 0, "ops": 0, "rows": []}
    for i, g, m, k, n, _, _ in _group_shapes(cfg):
        flip = pm1(n)
        bias = torch.round(torch.randn(n, generator=gen, device=dev) * 8) * 2
        noise = torch.randn((m, n), generator=gen, device=dev)
        for kind, make in (("pm1", pm1), ("ternary", ternary)):
            x, w = make(m, k), make(k, n)
            for dtype in (torch.float32, torch.bfloat16):
                for nz in (None, noise):
                    got = ops.mav_matmul(x.to(dtype), w.to(dtype), bias,
                                         flip, nz)
                    want = ref.imc_mav_ref(x.to(dtype), w.to(dtype), bias,
                                           flip, nz)
                    torch.cuda.synchronize()
                    mav["max_abs_err"] = max(mav["max_abs_err"], float(
                        (got.float() - want.float()).abs().max()))
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"imc_mav conv{i} {kind} {dtype} noise="
                            f"{nz is not None}: kernel differs from the "
                            f"plain version on "
                            f"{(got != want).sum().item()} of {got.numel()}")
        x, w = pm1(m, k), pm1(k, n)
        kernel = lambda: ops.imc_mav(x, w, bias, flip)
        plain = lambda: ref.imc_mav_ref(x, w, bias, flip)
        product = lambda: torch.matmul(x, w)
        k_ms = device_ms(torch, kernel) or cuda_ms(torch, kernel)
        p_ms = device_ms(torch, plain) or cuda_ms(torch, plain)
        mm_ms = device_ms(torch, product) or cuda_ms(torch, product)
        k_call = cuda_ms(torch, kernel)
        nbytes = 4 * (m * k + k * n + 2 * n + m * n)
        nops = 2 * m * k * n
        # the kernel's products are int8 (ternary operands are exact)
        b_ms, b_by = bound_ms(nbytes, nops, H100_INT8_OPS_PER_S)
        tile = (ops.mav_tile(m, k, n, dev) if hasattr(ops, "mav_tile")
                else None)
        # a layer is ``g`` launches of this shape
        mav["ms"] += g * k_ms
        mav["plain_ms"] += g * p_ms
        mav["matmul_ms"] += g * mm_ms
        mav["bytes"] += g * nbytes
        mav["ops"] += g * nops
        mav["rows"].append(dict(layer=f"conv{i}", groups=g, M=m, K=k, N=n,
                                tile=tile, kernel_ms=k_ms,
                                kernel_call_ms=k_call, plain_ms=p_ms,
                                matmul_ms=mm_ms, bound_ms=b_ms,
                                bound_by=b_by))
        log(f"[imc_mav] conv{i} per group M={m} K={k} N={n} (x{g} "
            f"launches), tile (rows, column chunks, smem) {tile}: device "
            f"time kernel {k_ms:.5f} ms, plain {p_ms:.5f} ms, float32 "
            f"matmul (product only) {mm_ms:.5f} ms; per call (CUDA events) "
            f"{k_call:.4f} ms; bound {b_ms:.5f} ms ({b_by}); bitwise equal "
            f"(pm1/ternary x f32/bf16 x clean/noise)")
    mav["bound_ms"], mav["bound_by"] = bound_ms(mav["bytes"], mav["ops"],
                                                H100_INT8_OPS_PER_S)
    log(f"[imc_mav] one per-group forward's 41 launches: kernel "
        f"{mav['ms']:.4f} ms, plain {mav['plain_ms']:.4f} ms, float32 "
        f"matmul (product only) {mav['matmul_ms']:.4f} ms, bound "
        f"{mav['bound_ms']:.5f} ms ({mav['bound_by']}) (device time)")

    i8 = {"max_abs_err": 0.0, "rows": []}
    for m, k, n, shifts in ((512, 128, 128, (0, 4, 7)), (8, 576, 10, (7,))):
        x = torch.randint(-128, 128, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        b = torch.randint(-2 ** 16, 2 ** 16, (n,), generator=gen,
                          device=dev, dtype=torch.int32)
        x[0, :] = -128                     # the rails: largest products
        w[:, 0] = -128
        for shift in shifts:
            got = i8_ops.int8_matmul(x, w, b, shift=shift)
            want = int8_matmul_ref(x, w, b, shift=shift)
            torch.cuda.synchronize()
            i8["max_abs_err"] = max(i8["max_abs_err"], float(
                (got.int() - want.int()).abs().max()))
            if not torch.equal(got, want):
                raise AssertionError(f"int8_matmul {m}x{k}x{n} shift "
                                     f"{shift}: kernel differs from the "
                                     f"plain version")
        kernel = lambda: i8_ops.int8_matmul_launch(x, w, b, 7)
        plain = lambda: int8_matmul_ref(x, w, b, 7)
        # torch._int_mm needs M > 16 and K, N multiples of 8: at the head
        # shape it runs on the operands zero-padded to 32 x 576 x 16
        xp = torch.zeros((max(m, 32), k), dtype=torch.int8, device=dev)
        xp[:m] = x
        wp = torch.zeros((k, -(-n // 8) * 8), dtype=torch.int8, device=dev)
        wp[:, :n] = w
        lib = lambda: torch._int_mm(xp, wp)
        k_ms = device_ms(torch, kernel) or cuda_ms(torch, kernel)
        p_ms = device_ms(torch, plain) or cuda_ms(torch, plain)
        l_ms = device_ms(torch, lib) or cuda_ms(torch, lib)
        k_call = cuda_ms(torch, kernel)
        nbytes = m * k + k * n + 4 * n + m * n
        nops = 2 * m * k * n
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = nops / H100_INT8_OPS_PER_S * 1e3
        plan = (("split-K" if i8_ops.split_k(m, k, n) else "tiled")
                if hasattr(i8_ops, "split_k") else None)
        row = dict(M=m, K=k, N=n, plan=plan, ms=k_ms, call_ms=k_call,
                   plain_ms=p_ms, library_ms=l_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations")
        i8["rows"].append(row)
        log(f"[int8] {m}x{k}x{n} plan {plan}, shifts {shifts} bitwise "
            f"equal; device time "
            f"kernel {k_ms:.5f} ms, plain {p_ms:.5f} ms, torch._int_mm "
            f"(product only{', padded' if m < 32 else ''}) {l_ms:.5f} ms; "
            f"per call (CUDA events) {k_call:.4f} ms; bound "
            f"{row['bound_ms']:.6f} ms ({row['bound_by']})")
    return mav, i8


def grouploop_forward(torch, hw, x, cfg, sa_key=None, std=0.0):
    """The per-group hardware forward (the fused layer's baseline, as the
    JAX package's ``benchmarks/run.py::_grouploop_hw_forward`` runs it):
    every IMC layer is ``conv_mav``, one K5 launch per conv group, then
    the digital shuffle and OR-pool; GAP, and the FC twice: as the float
    head of ``hw_forward`` (logits) and through the chip's 8-bit datapath
    ``quantized_fc`` (K4).  With ``sa_key`` each layer draws its noise
    down a ``split`` chain.  Returns (logits, fc codes on the act grid)."""
    from repro_torch.core import jaxrand
    from repro_torch.core.binary import channel_shuffle, or_maxpool
    from repro_torch.kernels.imc_mav import ops
    from repro_torch.kernels.int8_matmul import ops as i8_ops
    from repro_torch.models import kws

    hwp, _ = kws.as_hw_params(hw)
    h = kws.hw_conv_layer(hwp, 0, x[..., None], cfg)
    key = sa_key
    for i in range(1, cfg.num_conv_layers):
        name, g = f"conv{i}", cfg.groups(i)
        sub = None
        if key is not None:
            key, sub = jaxrand.split(key)
        h = ops.conv_mav(h, hwp.w_bin[name], hwp.bias[name], hwp.flip[name],
                         groups=g, stride=cfg.strides[i], sa_key=sub,
                         sa_noise_std=std)
        h = channel_shuffle(h, g)
        if cfg.pools[i] > 1:
            h = or_maxpool(h, cfg.pools[i], axis=1)
    logits, feats = kws.gap_fc(hwp, h)
    return logits, i8_ops.quantized_fc(feats, hwp.fc_w, hwp.fc_b)


def phase_grouploop(torch, dev):
    """The per-group forward at full width (B = 8) through ``conv_mav``:
    41 K5 launches and one K4 launch per forward, counted; clean logits
    equal the fused ``hw_forward``; the ``sa_key``-noise forward equal on
    the kernel route and the plain route (the CPU); per-layer time of the
    per-group path beside the fused layer's (K1)."""
    import numpy as np
    from repro_torch.core import jaxrand
    from repro_torch.core.binary import channel_shuffle, or_maxpool
    from repro_torch.kernels.imc_mav import ops
    from repro_torch.kernels.int8_matmul import ops as i8_ops
    from repro_torch.models import kws

    cfg = kws.PAPER_KWS
    params = kws.init_params(jaxrand.PRNGKey(0, device="cpu"), cfg,
                             device=dev)
    hw = kws.fold_params(params, kws.init_state(cfg, device=dev), cfg,
                         pack=True)
    x = torch.tensor(np.stack([s[:cfg.sample_len] for s in _traffic(cfg)]),
                     device=dev)
    grouploop_forward(torch, hw, x, cfg)           # warm-up
    torch.cuda.synchronize()
    ops.COUNTS_MAV.reset()                         # the path's run starts
    i8_ops.COUNTS.reset()
    t0 = time.perf_counter()
    logits, codes = grouploop_forward(torch, hw, x, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(imc_mav=ops.COUNTS_MAV.launches,      # ... and ends
                    int8_matmul=i8_ops.COUNTS.launches)
    want = sum(cfg.groups(i) for i in range(1, cfg.num_conv_layers))
    if launches != dict(imc_mav=want, int8_matmul=1):
        raise AssertionError(f"per-group forward launched {launches}, "
                             f"expected {want} imc_mav and 1 int8_matmul")
    fused, _ = kws.hw_forward(hw, x, cfg, use_kernel=True, device=dev)
    if not torch.equal(logits, fused):
        raise AssertionError("per-group forward logits differ from the "
                             "fused hw_forward")
    hw_cpu = _to(hw, "cpu")
    key = jaxrand.PRNGKey(17, device=dev)
    lk, ck = grouploop_forward(torch, hw, x, cfg, sa_key=key, std=SA_STD)
    lc, cc = grouploop_forward(torch, hw_cpu, x.cpu(), cfg,
                               sa_key=key.cpu(), std=SA_STD)
    if not (torch.equal(lk.cpu(), lc) and torch.equal(ck.cpu(), cc)):
        raise AssertionError("noisy per-group forward differs between the "
                             "kernel route and the plain route")
    if torch.equal(lk, logits) or not torch.isfinite(lk).all():
        raise AssertionError("the noisy forward drew no noise")
    _, c_plain = grouploop_forward(torch, hw_cpu, x.cpu(), cfg)
    if not torch.equal(codes.cpu(), c_plain):
        raise AssertionError("quantized_fc on the card differs from the "
                             "CPU")
    log(f"[grouploop] per-group forward B={B} full window: {launches}; "
        f"logits equal to the fused hw_forward; sa_key noise (std "
        f"{SA_STD}) equal on the kernel and plain routes; wall "
        f"{wall * 1e3:.2f} ms")

    hwp, _ = kws.as_hw_params(hw)
    h = kws.hw_conv_layer(hwp, 0, x[..., None], cfg)
    rows = []
    for i in range(1, cfg.num_conv_layers):
        name, g = f"conv{i}", cfg.groups(i)
        args = (hwp.w_bin[name], hwp.bias[name], hwp.flip[name])

        def per_group(h=h, g=g, i=i, args=args):
            out = channel_shuffle(ops.conv_mav(h, *args, groups=g,
                                               stride=cfg.strides[i]), g)
            return or_maxpool(out, cfg.pools[i], axis=1) \
                if cfg.pools[i] > 1 else out

        def fused(h=h, g=g, i=i, args=args, name=name):
            return ops.fused_conv_mav(h, *args, groups=g,
                                      stride=cfg.strides[i],
                                      pool=cfg.pools[i],
                                      packed=hw.packed[name])

        if not torch.equal(per_group(), fused()):
            raise AssertionError(f"conv{i}: per-group layer differs from "
                                 f"the fused one")
        pg_call, f_call = cuda_ms(torch, per_group), cuda_ms(torch, fused)
        pg_dev, f_dev = device_ms(torch, per_group), device_ms(torch, fused)
        rows.append(dict(layer=name, groups=g, per_group_call_ms=pg_call,
                         fused_call_ms=f_call, per_group_device_ms=pg_dev,
                         fused_device_ms=f_dev))
        log(f"[grouploop] conv{i} ({g} groups): per-group path per call "
            f"{pg_call:.4f} ms (device {pg_dev} ms), fused K1 per call "
            f"{f_call:.4f} ms (device {f_dev} ms); per-call speedup "
            f"{pg_call / f_call:.1f}x")
        h = fused()
    return dict(launches=launches, wall_ms=wall * 1e3, per_layer=rows)


def _noisy_chip(torch, cfg):
    from repro_torch.core import imc, jaxrand
    chans = {n: cfg.channels[i]
             for i, n in enumerate(cfg.imc_layer_names(), start=1)}
    return imc.sample_chip_offsets(jaxrand.PRNGKey(0, device="cpu"), chans,
                                   imc.IMCNoiseParams(OFFSET_STD, SA_STD))


def phase_noisy_served(torch, dev):
    """The served path on a noisy chip at full width: 8 streams, hop 1024,
    8 slots, VAD on, SA noise 1.0, chip offsets from
    ``sample_chip_offsets(PRNGKey(0))`` at std 4, with constant and with
    retention fills.  Kernel and plain routes bitwise equal on events and
    every state leaf; ``imc_fused`` 5 x (batched calls); the card's noise
    field equal to the CPU's; streamed logits equal to the offline
    ``hw_forward(sa_noise_field=...)``; decisions/s and the noise field's
    share of a tick."""
    import numpy as np
    from repro_torch.core import jaxrand, sa_noise
    from repro_torch.kernels.imc_mav import ops
    from repro_torch.models import kws
    from repro_torch.serving import stream as sv
    from repro_torch.serving.scheduler import StreamServer
    from repro_torch.serving.vad import VADConfig

    cfg = kws.PAPER_KWS
    params = kws.init_params(jaxrand.PRNGKey(0, device="cpu"), cfg,
                             device=dev)
    hw = kws.fold_params(params, kws.init_state(cfg, device=dev), cfg,
                         pack=True)
    chip = _noisy_chip(torch, cfg)
    streams = _traffic(cfg)

    def serve(use_kernel, fill, sa_std=SA_STD, profiled=False):
        from torch.profiler import ProfilerActivity, profile
        srv = StreamServer(hw, cfg, hop=HOP, slots=SLOTS, chip_offsets=chip,
                           sa_noise_std=sa_std, silence_fill=fill, seed=0,
                           use_kernel=use_kernel, vad=VADConfig(),
                           device=dev)
        for s, x in enumerate(streams):
            srv.submit(f"s{s}", x)
            srv.finish(f"s{s}")
        torch.cuda.synchronize()
        prof = None
        ops.COUNTS.reset()                  # the path's run starts
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
        return dict(srv=srv, events=events, launches=ops.COUNTS.launches,
                    wall=wall, prof=prof, kernel=use_kernel)

    def leaves(srv):
        st = srv._state
        return ([st.audio_carry, *st.carries, st.ring, st.hop, st.key]
                + list(srv._dstate) + list(srv._vstate))

    out = {}
    for fill in ("constant", "retention"):
        serve(True, fill), serve(False, fill)          # warm-up
        runs = [serve(False, fill), serve(True, fill), serve(True, fill),
                serve(False, fill)]
        st = runs[1]["srv"].stats()
        calls = st["batched_calls"]
        n_calls = calls["init"] + calls["hop"] + calls["replay"]
        for run in runs:
            if run["events"] != runs[0]["events"]:
                raise AssertionError(f"noisy served events ({fill}) differ "
                                     f"between the kernel and the plain "
                                     f"version")
            want = 5 * n_calls if run["kernel"] else 0
            if run["launches"] != want:
                raise AssertionError(f"imc_fused launched {run['launches']} "
                                     f"times, expected {want}")
            for a, b in zip(leaves(run["srv"]), leaves(runs[0]["srv"])):
                if not torch.equal(a, b):
                    raise AssertionError(f"noisy served state ({fill}) "
                                         f"differs between the routes")
        if not runs[1]["events"] or st["gated_hops"] == 0:
            raise AssertionError(f"noisy run did not exercise the path: {st}")
        dps = [st["decisions"] / r["wall"] for r in runs]
        log(f"[noisy] {fill} fills: {st['decisions']} decisions in "
            f"{st['steps']} ticks, gated hops {st['gated_hops']}, batched "
            f"calls {calls}, imc_fused launches {runs[1]['launches']} (= 5 x "
            f"{n_calls}); events and state equal on both routes; wall "
            f"decisions/s plain, kernel, kernel, plain: "
            f"{[round(v, 1) for v in dps]}")
        out[fill] = dict(decisions=st["decisions"], ticks=st["steps"],
                         launches=runs[1]["launches"], batched_calls=calls,
                         wall_dps_kernel=dps[1:3],
                         wall_dps_plain=[dps[0], dps[3]])
    # the same traffic noise-free, in the same call, for the noise's cost
    quiet = [serve(True, "constant", sa_std=0.0) for _ in range(2)]
    out["noise_free_wall_dps"] = [quiet[0]["srv"].stats()["decisions"]
                                  / q["wall"] for q in quiet]
    prof_run = serve(True, "constant", profiled=True)
    busy_us, rows = device_time(torch, prof_run["prof"])
    busy = busy_us / 1e6 / prof_run["wall"]
    log(f"[noisy] noise-free wall decisions/s (same traffic) "
        f"{[round(v, 1) for v in out['noise_free_wall_dps']]}; profiled "
        f"noisy kernel run: wall {prof_run['wall'] * 1e3:.1f} ms, device "
        f"busy {busy_us / 1e3:.3f} ms (share {busy:.4f}, idle "
        f"{1 - busy:.4f})")
    for name, (us, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:6]:
        log(f"[noisy]   {us / 1e3:8.3f} ms  n={n:6d}  {name[:80]}")

    # the noise field of one served hop tick, alone: its wall per tick
    geom = sv.make_stream_geometry(cfg, HOP)
    keys = jaxrand.fold_in(jaxrand.PRNGKey(0, device=dev),
                           torch.arange(SLOTS, device=dev))
    hops = torch.arange(3, 3 + SLOTS, dtype=torch.int32, device=dev)
    field = lambda: sv.hop_sa_noise_fields(keys, hops, cfg, geom, SA_STD)
    field_call = cuda_ms(torch, field, reps=5, iters=10)
    field_dev = device_ms(torch, field, reps=3, iters=5)
    tick_ms = prof_run["wall"] / prof_run["srv"].stats()["steps"] * 1e3
    on_card = field()
    on_cpu = sv.hop_sa_noise_fields(keys.cpu(), hops.cpu(), cfg, geom,
                                    SA_STD)
    for name in on_cpu:
        if not torch.equal(on_card[name].cpu(), on_cpu[name]):
            raise AssertionError(f"noise field {name} differs between the "
                                 f"card and the CPU")
    win = sa_noise.field_window_noise(sa_noise.SANoiseField(
        keys[:2], hops[:2], SA_STD, HOP), cfg)
    win_cpu = sa_noise.field_window_noise(sa_noise.SANoiseField(
        keys[:2].cpu(), hops[:2].cpu(), SA_STD, HOP), cfg)
    for name in win_cpu:
        if not torch.equal(win[name].cpu(), win_cpu[name]):
            raise AssertionError(f"window noise {name} differs between the "
                                 f"card and the CPU")
    log(f"[noisy] noise field of a hop tick (B={SLOTS}, five layers' tails) "
        f"equal on the card and the CPU, and full windows too; one field "
        f"per call {field_call:.3f} ms (CUDA events), device {field_dev} "
        f"ms, beside a profiled tick of {tick_ms:.3f} ms")

    # streamed logits == the offline forward on the same field
    eng = sv.StreamEngine(hw, cfg, HOP, chip_offsets=chip,
                          sa_noise_std=SA_STD, device=dev)
    audio = torch.tensor(np.stack([s[:cfg.sample_len + 3 * HOP]
                                   for s in streams]), device=dev)
    lg, state = eng.init(audio[:, :cfg.sample_len], keys)
    streamed = [lg]
    for h in range(3):
        lo = cfg.sample_len + h * HOP
        lg, state = eng.step(state, audio[:, lo:lo + HOP])
        streamed.append(lg)
    for t, lg in enumerate(streamed):
        want, _ = kws.hw_forward(
            hw, audio[:, t * HOP:t * HOP + cfg.sample_len], cfg,
            chip_offsets=chip, use_kernel=True, device=dev,
            sa_noise_field=sa_noise.SANoiseField(
                keys, torch.full((SLOTS,), t, device=dev), SA_STD, HOP))
        if not torch.equal(lg, want):
            raise AssertionError(f"streamed window {t} differs from the "
                                 f"offline noisy forward")
    log(f"[noisy] streamed logits of windows 0-3 (B={SLOTS}) equal the "
        f"offline hw_forward(sa_noise_field=...)")
    out.update(device_busy_share=busy, field_call_ms=field_call,
               field_device_ms=field_dev, tick_ms=tick_ms)
    return out


def _session_audio(cfg):
    """Live keyword traffic (utterance, 6 silent hops, utterance, ...),
    enrollment utterances with labels, and post-swap user audio."""
    import numpy as np
    from repro_torch.data import audio
    utts, _ = audio.make_dataset(seed=0, n_per_class=1, n_speakers=4,
                                 augment=False, length=cfg.sample_len)
    enroll, labels = audio.make_dataset(seed=7, n_per_class=2, n_speakers=2,
                                        accent_shift=0.3, augment=False,
                                        length=cfg.sample_len)
    # the third session's user: 10 more utterances of another accent
    more, more_labels = audio.make_dataset(
        seed=8, n_per_class=1, n_speakers=2, accent_shift=-0.3,
        augment=False, length=cfg.sample_len)
    enroll = list(enroll) + list(more)
    labels = list(labels) + list(more_labels)
    gap = np.random.default_rng(2).uniform(-1e-4, 1e-4, 6 * HOP)
    live = []
    for s in range(2):
        parts = []
        for j in range(14):
            parts += [utts[(s + 3 * j) % 10], gap]
        live.append(np.concatenate(parts).astype(np.float32))
    n = len(PER_TICK)
    after = [np.concatenate([utts[(4 + s) % 10], gap, utts[(7 + s) % 10]])
             .astype(np.float32) for s in range(n)]
    return live, list(enroll[:n * N_UTTS]), [int(v) for v in
                                            labels[:n * N_UTTS]], after


def phase_customize(torch, dev):
    """Two enrollment sessions against a live server at full width, with
    the kernels and with the plain versions; the offline loop on the card
    and on the CPU."""
    import numpy as np
    from repro_torch.core import jaxrand
    from repro_torch.core.onchip_training import (OnChipTrainConfig,
                                                  quantized_head_finetune)
    from repro_torch.kernels.imc_mav import ops
    from repro_torch.kernels.sga_update import ops as sga_ops
    from repro_torch.models import kws
    from repro_torch.serving import CustomizeConfig, StreamServer, VADConfig
    from repro_torch.training import kws as tr

    cfg = kws.PAPER_KWS
    gen = torch.Generator().manual_seed(0)
    params = kws.init_params(jaxrand.PRNGKey(0, device="cpu"), cfg,
                             device=dev)
    hw = kws.fold_params(params, kws.init_state(cfg, device=dev), cfg,
                         pack=True)
    chip = {name: 4.0 * torch.randn(cfg.channels[i], generator=gen)
            for i, name in enumerate(cfg.imc_layer_names(), start=1)}
    live, enroll, labels, after = _session_audio(cfg)
    tcfg = OnChipTrainConfig(epochs=EPOCHS, fixed_error_scale=1.375)

    def run(use_kernel, profiled=False):
        from torch.profiler import ProfilerActivity, profile
        if profiled:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            with prof:
                out = run(use_kernel)
            out["prof"] = prof
            return out
        srv = StreamServer(hw, cfg, hop=HOP, slots=SLOTS, chip_offsets=chip,
                           use_kernel=use_kernel, vad=VADConfig(),
                           device=dev)
        for s in range(2):
            srv.submit(f"live{s}", live[s][:cfg.sample_len])
        torch.cuda.synchronize()
        ops.COUNTS.reset()                  # the path's run starts
        sga_ops.COUNTS_ROWS.reset()
        sga_ops.COUNTS_FLAT.reset()
        sga_ops.COUNTS_HEAD.reset()
        t0 = time.perf_counter()
        sessions, opened = [], []
        for k, per_tick in enumerate(PER_TICK):
            opened.append(time.perf_counter())
            sess = srv.customize(f"user{k}", CustomizeConfig(
                train=tcfg, epochs_per_tick=per_tick, compensate=True,
                calib_sa_noise_std=CALIB_NOISE[k], calib_seed=k,
                use_kernel=use_kernel))
            for j in range(N_UTTS):
                sess.enroll(labels[k * N_UTTS + j], enroll[k * N_UTTS + j])
            sess.finish_enrollment()
            sessions.append(sess)
        events, pos, rounds, ticks, train_ticks = [], cfg.sample_len, 0, 0, 0
        swapped, train_wall = [None] * len(PER_TICK), 0.0
        while not all(s.phase == "swapped" for s in sessions):
            if ticks > 2000:
                raise AssertionError(f"sessions stuck: "
                                     f"{[s.phase for s in sessions]}")
            for s in range(2):
                if pos < len(live[s]):
                    srv.submit(f"live{s}", live[s][pos:pos + HOP])
            pos += HOP
            before = [s._epoch for s in sessions]
            t_tick = time.perf_counter()
            events.extend(srv.step())
            torch.cuda.synchronize()
            ticks += 1
            # a round is one epoch of every session training this tick
            n_rounds = max(s._epoch - e for s, e in zip(sessions, before))
            rounds += n_rounds
            if n_rounds:
                train_wall += time.perf_counter() - t_tick
                train_ticks += 1
            for k, s in enumerate(sessions):
                if s.phase == "swapped" and swapped[k] is None:
                    torch.cuda.synchronize()
                    swapped[k] = (time.perf_counter() - opened[k], ticks)
        n_swap = len(events)
        for s in range(2):
            srv.submit(f"live{s}", live[s][pos:])
            srv.finish(f"live{s}")
        for s in range(len(PER_TICK)):
            srv.submit(f"user{s}", after[s])
            srv.finish(f"user{s}")
        events.extend(srv.drain())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(imc=ops.COUNTS.launches,       # ... and ends
                      rows=sga_ops.COUNTS_ROWS.launches,
                      flat=sga_ops.COUNTS_FLAT.launches,
                      head=sga_ops.COUNTS_HEAD.launches)
        return dict(srv=srv, sessions=sessions, events=events,
                    rounds=rounds, ticks=ticks, train_ticks=train_ticks,
                    swapped=swapped, wall=wall,
                    train_wall=train_wall,
                    counts=counts, stats=srv.stats(),
                    after_swap={e["stream"] for e in events[n_swap:]})

    kern = run(True)
    plain = run(False)
    st = kern["stats"]
    calls = st["batched_calls"]
    n_calls = calls["init"] + calls["hop"] + calls["replay"]
    # one fused launch per training tick (one format group), no per-epoch
    # launch
    if (kern["counts"]["head"] != kern["train_ticks"]
            or kern["counts"]["rows"] != 0 or kern["rounds"] < EPOCHS):
        raise AssertionError(f"head_train_rows launched "
                             f"{kern['counts']['head']} times and "
                             f"sga_update_rows {kern['counts']['rows']} in "
                             f"{kern['train_ticks']} training ticks")
    if kern["counts"]["imc"] != 5 * n_calls:
        raise AssertionError(f"imc_fused launched {kern['counts']['imc']} "
                             f"times for {n_calls} batched calls")
    if plain["counts"] != dict(imc=0, rows=0, flat=0, head=0) or \
            plain["rounds"] != kern["rounds"]:
        raise AssertionError(f"plain run: counts {plain['counts']}, rounds "
                             f"{plain['rounds']} (kernel {kern['rounds']})")
    if kern["events"] != plain["events"]:
        raise AssertionError("served events differ between the kernel and "
                             "the plain run")
    if not {f"user{k}" for k in range(len(PER_TICK))} <= kern["after_swap"] \
            or \
            st["learn_hops"] == 0 or st["gated_hops"] == 0:
        raise AssertionError(f"the path was not exercised: {st}")

    def same(r1, r2):
        return (np.array_equal(r1.fc_w, r2.fc_w)
                and np.array_equal(r1.fc_b, r2.fc_b)
                and all(np.array_equal(r1.bias[n], r2.bias[n])
                        for n in cfg.imc_layer_names()))

    hw_cpu = _to(hw, "cpu")
    chip_dev = {k: v.to(dev) for k, v in chip.items()}
    for k, (sk, sp) in enumerate(zip(kern["sessions"], plain["sessions"])):
        rk = sk.result
        if not same(rk, sp.result) or rk.history != sp.result.history:
            raise AssertionError(f"session {k}: kernel and plain results "
                                 f"differ")
        x = np.stack(sk.windows)
        for d, hw_d, offs in ((dev, hw, chip_dev), ("cpu", hw_cpu, chip)):
            hw_c = tr.calibrate_and_compensate(
                hw_d, x, offs, cfg, sa_noise_std=CALIB_NOISE[k], seed=k,
                device=d)
            feats = tr.hw_features(hw_c, x, cfg, chip_offsets=offs,
                                   device=d)
            w, b = quantized_head_finetune(
                feats, sk.labels, hw_c.hw.fc_w, hw_c.hw.fc_b, tcfg,
                device=d)
            off = type(rk)(bias={n: v.cpu().numpy()
                                 for n, v in hw_c.hw.bias.items()},
                           fc_w=w.cpu().numpy(), fc_b=b.cpu().numpy(),
                           epochs=0, n_utterances=0, history=[], energy={})
            if not same(rk, off):
                raise AssertionError(f"session {k}: result differs from the "
                                     f"offline loop on {d}")
        moved = sum(int((rk.bias[n] != hw.hw.bias[n].cpu().numpy()).sum())
                    for n in cfg.imc_layer_names())
        wall_s, ticks = kern["swapped"][k]
        log(f"[customize] session user{k} (epochs_per_tick "
            f"{PER_TICK[k]}, calibration read noise {CALIB_NOISE[k]}): "
            f"customize() to swapped {wall_s:.3f} s over "
            f"{ticks} ticks (plain run {plain['swapped'][k][0]:.3f} s); "
            f"{rk.epochs} epochs; train accuracy "
            f"{rk.history[-1]['train_accuracy']}; {moved} biases "
            f"compensated; equal to the offline loop on the card and the "
            f"CPU and to the plain run")
    log(f"[customize] kernel run: {kern['ticks']} ticks to all swaps, "
        f"{kern['train_ticks']} of them training, {kern['rounds']} training "
        f"rounds; head_train_rows launches {kern['counts']['head']} (one "
        f"per training tick), sga_update_rows launches "
        f"{kern['counts']['rows']}, sga_update launches "
        f"{kern['counts']['flat']}, imc_fused launches "
        f"{kern['counts']['imc']} (= 5 x {n_calls} batched calls {calls}); "
        f"learn hops {st['learn_hops']}; {len(kern['events'])} events "
        f"equal to the plain run's")
    per_round = {name: r["train_wall"] / r["rounds"] * 1e3
                 for name, r in (("kernel", kern), ("plain", plain))}
    log(f"[customize] wall of the whole run: kernel {kern['wall']:.3f} s, "
        f"plain {plain['wall']:.3f} s; wall of the ticks that trained, per "
        f"training round: kernel {per_round['kernel']:.4f} ms, plain "
        f"{per_round['plain']:.4f} ms (tick included: its hops, its "
        f"decisions and the sessions' other work)")
    prof_run = run(True, profiled=True)
    busy_us, prof_rows = device_time(torch, prof_run["prof"])
    sga_us = sum(us for name, (us, _) in prof_rows.items()
                 if "head_train" in name or "sga_update" in name)
    imc_us = sum(us for name, (us, _) in prof_rows.items()
                 if "imc_fused" in name)
    busy = busy_us / 1e6 / prof_run["wall"]
    log(f"[customize] profiled kernel run: wall {prof_run['wall']:.3f} s, "
        f"device busy {busy_us / 1e3:.3f} ms (share {busy:.4f}, idle "
        f"{1 - busy:.4f}); head_train_rows {sga_us / 1e3:.3f} ms in "
        f"{prof_run['counts']['head']} launches, imc_fused "
        f"{imc_us / 1e3:.3f} ms in {prof_run['counts']['imc']} launches")
    for name, (us, n) in sorted(prof_rows.items(),
                                key=lambda kv: -kv[1][0])[:6]:
        log(f"[customize]   {us / 1e3:8.3f} ms  n={n:6d}  {name[:80]}")
    return dict(rounds=kern["rounds"], ticks=kern["ticks"],
                train_ticks=kern["train_ticks"],
                launches_head=kern["counts"]["head"],
                launches_rows=kern["counts"]["rows"],
                launches_flat=kern["counts"]["flat"],
                imc_launches=kern["counts"]["imc"],
                session_wall_s=[sw[0] for sw in kern["swapped"]],
                ms_per_round=per_round["kernel"],
                ms_per_round_plain=per_round["plain"],
                device_busy_share=busy, head_device_ms=sga_us / 1e3,
                session_wall_s_plain=[sw[0] for sw in plain["swapped"]],
                wall_s=kern["wall"], wall_s_plain=plain["wall"])


RGP_EPOCHS, RGP_PER_TICK = 40, 10


def phase_customize_rgp(torch, dev):
    """One RGP session (random gradient prediction: noise drawn through
    ``core.jaxrand`` between the halves of every epoch) on the served net
    and chip at full width, without compensation: it trains epoch by
    epoch, one ``sga_update_rows`` launch per epoch and no fused launch;
    its head equals the offline loop on the card and on the CPU."""
    import numpy as np
    from repro_torch.core import jaxrand
    from repro_torch.core.onchip_training import (OnChipTrainConfig,
                                                  quantized_head_finetune)
    from repro_torch.kernels.sga_update import ops as sga_ops
    from repro_torch.models import kws
    from repro_torch.serving import CustomizeConfig, StreamServer, VADConfig
    from repro_torch.training import kws as tr

    cfg = kws.PAPER_KWS
    gen = torch.Generator().manual_seed(0)
    params = kws.init_params(jaxrand.PRNGKey(0, device="cpu"), cfg,
                             device=dev)
    hw = kws.fold_params(params, kws.init_state(cfg, device=dev), cfg,
                         pack=True)
    chip = {name: 4.0 * torch.randn(cfg.channels[i], generator=gen)
            for i, name in enumerate(cfg.imc_layer_names(), start=1)}
    _, enroll, labels, _ = _session_audio(cfg)
    tcfg = OnChipTrainConfig(epochs=RGP_EPOCHS, fixed_error_scale=1.375,
                             rgp=True, seed=5)
    srv = StreamServer(hw, cfg, hop=HOP, slots=SLOTS, chip_offsets=chip,
                       vad=VADConfig(), device=dev)
    sess = srv.customize("rgp", CustomizeConfig(
        train=tcfg, epochs_per_tick=RGP_PER_TICK, compensate=False))
    for j in range(N_UTTS):
        sess.enroll(labels[j], enroll[j])
    sess.finish_enrollment()
    torch.cuda.synchronize()
    sga_ops.COUNTS_ROWS.reset()              # the RGP run starts
    sga_ops.COUNTS_HEAD.reset()
    t0 = time.perf_counter()
    ticks = 0
    while sess.phase != "swapped":
        if ticks > 500:
            raise AssertionError(f"RGP session stuck in {sess.phase}")
        srv.step()
        ticks += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(rows=sga_ops.COUNTS_ROWS.launches,   # ... and ends
                  head=sga_ops.COUNTS_HEAD.launches)
    if counts != dict(rows=RGP_EPOCHS, head=0):
        raise AssertionError(f"RGP session launched {counts}, expected "
                             f"{RGP_EPOCHS} sga_update_rows and no fused "
                             f"launch")
    res = sess.result
    x = np.stack(sess.windows)
    for d, hw_d, offs in ((dev, hw, {k: v.to(dev) for k, v in chip.items()}),
                          ("cpu", _to(hw, "cpu"), chip)):
        feats = tr.hw_features(hw_d, x, cfg, chip_offsets=offs, device=d)
        w, b = quantized_head_finetune(feats, sess.labels, hw_d.hw.fc_w,
                                       hw_d.hw.fc_b, tcfg, device=d)
        if not (np.array_equal(res.fc_w, w.cpu().numpy())
                and np.array_equal(res.fc_b, b.cpu().numpy())):
            raise AssertionError(f"RGP session differs from the offline "
                                 f"loop on {d}")
    log(f"[rgp] RGP session: {res.epochs} epochs over {ticks} ticks, "
        f"sga_update_rows launches {counts['rows']} (one per epoch), "
        f"head_train_rows launches {counts['head']}; head equal to the "
        f"offline loop on the card and the CPU; wall {wall:.3f} s")
    return dict(launches_rows=counts["rows"], epochs=res.epochs,
                ticks=ticks, wall_s=wall)


# the front door: timed runs per serving mode, the crowd of the admission
# run and its bursty producers (they upload their whole stream at once)
FRONT_RUNS = 3
CROWD, CROWD_MIN, CROWD_MAX, BURSTY = 20, 4, 16, (3, 11)
CROWD_LAG_S = 1.1                 # the admission run's latency SLO
PROFILE_EPOCHS = 40


def phase_front_door(torch, dev, window):
    """StreamServer's front door at full width (``PAPER_KWS``, hop 1024,
    chip offsets of std 4, VAD on), every run on the kernel route and on
    the plain route with identical events, placements and counters, and
    ``imc_fused`` launched 5 x ``stats()["imc_passes"]`` times:

    (a) the recompute path (``streaming=False``) against the streaming
        one on the served traffic at 8 slots: with every hop computed
        (VAD forced to speech) their events are identical, and so on a
        short noisy run (SA noise 1.0, 2 streams, 6 hops); decisions/s of
        each from ``FRONT_RUNS`` runs; with VAD gating the recompute
        server's K1 device time per IMC forward beside the five
        full-window layers' bound and phase 2's time of them
        (``window``, phase 2's full-window totals);
    (b) the dynamic hop (``max_multiplier=4``) on calm-then-loud traffic:
        the multiplier reaches 4 and returns to 1;
    (c) admission at 4 to 16 slots: 20 streams whose producers retry a
        rejected submit every tick and feed a hop a tick (two upload all
        at once): rejections, growth to 16 slots, sheds, and the shrink
        back to 4 once they drain;
    (d) profiles: one customization session on the card stored in a
        ``ProfileStore``; ``submit(user_id=)`` on a server built with
        ``profiles=`` serves exactly like ``install_custom``."""
    import shutil
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import jaxrand
    from repro_torch.checkpoint import ProfileStore
    from repro_torch.core.onchip_training import OnChipTrainConfig
    from repro_torch.kernels.imc_mav import ops
    from repro_torch.models import kws
    from repro_torch.serving import (AdmissionConfig, CustomizeConfig,
                                     DynamicHopConfig, StreamServer,
                                     VADConfig)

    t_phase = time.perf_counter()
    cfg = kws.PAPER_KWS
    params = kws.init_params(jaxrand.PRNGKey(0, device="cpu"), cfg,
                             device=dev)
    hw = kws.fold_params(params, kws.init_state(cfg, device=dev), cfg,
                         pack=True)
    chip = _noisy_chip(torch, cfg)
    keys = ("steps", "decisions", "speech_hops", "gated_hops", "learn_hops",
            "batched_calls", "imc_passes", "slots", "rejected_streams",
            "shed", "hop_retargets", "hop_multiplier")

    def run(feed, use_kernel, profiled=False, **kw):
        srv = StreamServer(hw, cfg, hop=HOP, chip_offsets=chip,
                           use_kernel=use_kernel, device=dev, **kw)
        torch.cuda.synchronize()
        prof = None
        ops.COUNTS.reset()                  # the path's run starts
        t0 = time.perf_counter()
        if profiled:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out = feed(srv)
                torch.cuda.synchronize()
        else:
            out = feed(srv)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = srv.stats()
        out.update(srv=srv, stats=st, launches=ops.COUNTS.launches,
                   wall=wall, prof=prof, kernel=use_kernel,
                   counters={k: st[k] for k in keys},
                   per_stream={sid: {k: v for k, v in p.items()
                                     if k != "wall_s"}
                               for sid, p in st["per_stream"].items()})
        want = 5 * st["imc_passes"] if use_kernel else 0
        if out["launches"] != want:         # ... and ends: read the count
            raise AssertionError(f"imc_fused launched {out['launches']} "
                                 f"times for {st['imc_passes']} IMC "
                                 f"forwards (expected {want})")
        return out

    def same(a, b, what):
        for k in ("events", "places", "trace", "counters", "per_stream"):
            if a.get(k) != b.get(k):
                raise AssertionError(f"{what}: {k} differ between the "
                                     f"runs")

    def served(streams):
        def feed(srv):
            for s, x in enumerate(streams):
                srv.submit(f"s{s}", x)
                srv.finish(f"s{s}")
            return dict(events=srv.drain())
        return feed

    def stepped(streams, cap=2000):
        # step until every stream retired (``drain`` stops at a tick that
        # moves no buffer, which a hop retarget can make)
        def feed(srv):
            for s, x in enumerate(streams):
                srv.submit(f"s{s}", x)
                srv.finish(f"s{s}")
            events, trace = [], []
            while srv.active_streams():
                if len(trace) > cap:
                    raise AssertionError("dynamic-hop run stuck")
                events.extend(srv.step())
                trace.append(srv.hop_multiplier)
            return dict(events=events, trace=trace)
        return feed

    out = {}
    # (a) recompute against streaming
    streams = _traffic(cfg)
    forced = VADConfig(force="speech")
    for streaming in (True, False):                  # warm-up
        run(served(streams), True, slots=SLOTS, vad=forced,
            streaming=streaming)
    timed = {True: [], False: []}
    for _ in range(FRONT_RUNS):
        for streaming in (True, False):
            timed[streaming].append(run(served(streams), True, slots=SLOTS,
                                        vad=forced, streaming=streaming))
    plain = {streaming: run(served(streams), False, slots=SLOTS, vad=forced,
                            streaming=streaming)
             for streaming in (True, False)}
    first = timed[True][0]
    for streaming in (True, False):
        for r in timed[streaming] + [plain[streaming]]:
            if r["events"] != first["events"]:
                raise AssertionError(f"streaming={streaming}: events differ "
                                     f"from the streaming kernel run")
            same(r, timed[streaming][0], f"streaming={streaming}")
    if not first["events"] or first["stats"]["gated_hops"]:
        raise AssertionError(f"forced run did not serve: {first['stats']}")
    dps = {("streaming" if k else "recompute"):
           [r["stats"]["decisions"] / r["wall"] for r in v]
           for k, v in timed.items()}
    rc = timed[False][0]
    per_tick = rc["launches"] / rc["stats"]["steps"]
    log(f"[front] (a) {first['stats']['decisions']} decisions in "
        f"{first['stats']['steps']} ticks (VAD forced to speech): events "
        f"equal on streaming and recompute, kernel and plain; wall "
        f"decisions/s streaming {[round(v, 1) for v in dps['streaming']]}, "
        f"recompute {[round(v, 1) for v in dps['recompute']]}; imc_fused "
        f"launches per tick {per_tick:.2f} in both modes "
        f"({rc['launches']} recompute, {first['launches']} streaming)")
    short = [x[:cfg.sample_len + 6 * HOP] for x in streams[:2]]
    noisy = {(streaming, k): run(served(short), k, slots=2, vad=forced,
                                 streaming=streaming, sa_noise_std=SA_STD,
                                 seed=0)
             for streaming in (True, False) for k in (True, False)}
    base = noisy[(True, True)]
    for key, r in noisy.items():
        if r["events"] != base["events"]:
            raise AssertionError(f"noisy run {key}: events differ")
    gk = run(served(streams), True, profiled=True, slots=SLOTS,
             vad=VADConfig(), streaming=False)
    gp = run(served(streams), False, slots=SLOTS, vad=VADConfig(),
             streaming=False)
    same(gk, gp, "recompute with VAD gating")
    gst = gk["stats"]
    if not gst["gated_hops"] or not gst["batched_calls"]["replay"]:
        raise AssertionError(f"gated recompute run did not gate: {gst}")
    busy_us, rows = device_time(torch, gk["prof"])
    k1_us = sum(us for name, (us, _) in rows.items() if "imc_fused" in name)
    per_pass = k1_us / 1e3 / gst["imc_passes"]
    log(f"[front] (a) noisy (SA {SA_STD}, 2 streams, 6 hops): events equal "
        f"on both modes and routes; recompute with VAD gating: "
        f"{gst['decisions']} decisions, gated hops {gst['gated_hops']}, "
        f"batched calls {gst['batched_calls']}, {gst['imc_passes']} IMC "
        f"forwards, kernel and plain equal; K1 per recompute forward (five "
        f"full-window layers, B={SLOTS}) {per_pass:.5f} ms device time, "
        f"bound {window['bound_ms']:.5f} ms "
        f"({per_pass / window['bound_ms']:.2f}x; phase 2 times these "
        f"launches at {window['ms']:.5f} ms)"
        f"; device busy share {busy_us / 1e6 / gk['wall']:.4f} (profiled)")
    out["recompute"] = dict(
        decisions=first["stats"]["decisions"], ticks=first["stats"]["steps"],
        wall_dps_streaming=dps["streaming"],
        wall_dps_recompute=dps["recompute"],
        launches_recompute=rc["launches"], launches_streaming=first[
            "launches"], launches_per_tick=per_tick,
        gated_launches=gk["launches"], k1_ms_per_forward=per_pass,
        bound_ms=window["bound_ms"], noisy_decisions=len(base["events"]))

    # (b) the dynamic hop
    calm = _traffic(cfg, gap_hops=30, hops=50)
    hop_cfg = DynamicHopConfig(max_multiplier=4, widen_after=3)
    dk = run(stepped(calm), True, slots=SLOTS, vad=VADConfig(),
             dynamic_hop=hop_cfg)
    dp = run(stepped(calm), False, slots=SLOTS, vad=VADConfig(),
             dynamic_hop=hop_cfg)
    same(dk, dp, "dynamic hop")
    trace, dst = dk["trace"], dk["stats"]
    if (4 not in trace or 1 not in trace[trace.index(4):]
            or dst["hop_retargets"] < 2):
        raise AssertionError(f"the hop did not widen to 4 and come back: "
                             f"{trace}")
    log(f"[front] (b) dynamic hop: multiplier per tick {trace}; "
        f"{dst['hop_retargets']} retargets, {dst['decisions']} decisions, "
        f"imc_fused launches {dk['launches']} (= 5 x {dst['imc_passes']} "
        f"IMC forwards, re-inits included); kernel and plain equal")
    out["dynamic_hop"] = dict(trace=trace, retargets=dst["hop_retargets"],
                              launches=dk["launches"])

    # (c) admission, SLO shedding, autoscaling past 8 slots
    crowd = _traffic(cfg, n_streams=CROWD)
    adm = AdmissionConfig(max_queue=4, max_lag_s=CROWD_LAG_S,
                          min_slots=CROWD_MIN,
                          max_slots=CROWD_MAX, scale_up_after=1,
                          scale_down_after=2)

    def admission(srv):
        pos, places, events, trace = {}, [], [], []
        for _ in range(600):
            for s, x in enumerate(crowd):
                sid = f"s{s}"
                if sid not in pos:          # (re)try with its first window
                    places.append(srv.submit(sid, x[:cfg.sample_len]))
                    if places[-1] != "rejected":
                        pos[sid] = cfg.sample_len
                    continue
                if pos[sid] >= len(x):
                    continue
                n = len(x) if s in BURSTY else HOP
                srv.submit(sid, x[pos[sid]:pos[sid] + n])
                pos[sid] += n
                if pos[sid] >= len(x):
                    srv.finish(sid)
            events.extend(srv.step())
            trace.append(srv.slots)
            if (len(pos) == CROWD and not srv.active_streams()
                    and srv.slots == CROWD_MIN):
                return dict(events=events, places=places, trace=trace)
        raise AssertionError(f"admission run did not drain: {trace[-20:]}")

    ak = run(admission, True, slots=CROWD_MIN, vad=VADConfig(),
             admission=adm)
    ap = run(admission, False, slots=CROWD_MIN, vad=VADConfig(),
             admission=adm)
    same(ak, ap, "admission")
    ast, atrace = ak["stats"], ak["trace"]
    if (not ast["rejected_streams"] or max(atrace) != CROWD_MAX
            or not ast["shed"]["events"] or atrace[-1] != CROWD_MIN):
        raise AssertionError(f"admission run: rejected "
                             f"{ast['rejected_streams']}, slots {atrace}, "
                             f"shed {ast['shed']}")
    log(f"[front] (c) admission: {ast['rejected_streams']} rejected "
        f"submits, sheds {ast['shed']}, slots per tick {atrace}; "
        f"{ast['decisions']} decisions, imc_fused launches "
        f"{ak['launches']} for {ast['imc_passes']} batched IMC forwards "
        f"({ak['launches'] / ast['imc_passes']:.0f} a call, B up to "
        f"{CROWD_MAX}); kernel and plain equal")
    out["admission"] = dict(rejected=ast["rejected_streams"],
                            shed=ast["shed"], slots_max=max(atrace),
                            ticks=ast["steps"], launches=ak["launches"],
                            imc_passes=ast["imc_passes"])

    # (d) profiles at admission
    live, enroll, labels, after = _session_audio(cfg)
    srv = StreamServer(hw, cfg, hop=HOP, slots=SLOTS, chip_offsets=chip,
                       vad=VADConfig(), device=dev)
    sess = srv.customize("alice-enroll", CustomizeConfig(
        train=OnChipTrainConfig(epochs=PROFILE_EPOCHS,
                                fixed_error_scale=1.375),
        epochs_per_tick=10))
    for j in range(N_UTTS):
        sess.enroll(labels[j], enroll[j])
    sess.finish_enrollment()
    for _ in range(500):
        if sess.phase == "swapped":
            break
        srv.step()
    if sess.phase != "swapped":
        raise AssertionError(f"profile session stuck in {sess.phase}")
    result = sess.result
    user = [after[0], streams[1]]
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    store_dir = tempfile.mkdtemp(prefix="profiles-",
                                 dir=os.path.join(ROOT, "build"))
    try:
        store = ProfileStore(store_dir)
        store.save("alice", result)

        def serve_user(srv, user_id=None):
            srv.submit("mic", user[0], user_id=user_id)
            srv.submit("other", user[1])
            for sid in ("mic", "other"):
                srv.finish(sid)
            return dict(events=srv.drain())

        def by_user(srv):
            return serve_user(srv, "alice")

        def by_install(srv):
            srv.install_custom("mic", result)
            return serve_user(srv)

        prof_runs = {(name, k): run(feed, k, slots=SLOTS, vad=VADConfig(),
                                    profiles=store if name == "user"
                                    else None)
                     for name, feed in (("user", by_user),
                                        ("install", by_install))
                     for k in (True, False)}
        base = run(serve_user, True, slots=SLOTS, vad=VADConfig())
    finally:
        shutil.rmtree(store_dir, ignore_errors=True)
    ref = prof_runs[("install", True)]
    for key, r in prof_runs.items():
        if r["events"] != ref["events"]:
            raise AssertionError(f"profile run {key}: events differ from "
                                 f"install_custom's")
    mic = lambda evs: [e for e in evs if e["stream"] == "mic"]
    if not mic(ref["events"]) or mic(ref["events"]) == mic(base["events"]):
        raise AssertionError("the stored profile changed nothing")
    log(f"[front] (d) profiles: a {PROFILE_EPOCHS}-epoch session on the "
        f"card, stored and served through submit(user_id=): "
        f"{len(ref['events'])} events equal to install_custom's on the "
        f"kernel and plain routes (and unlike the base model's); "
        f"imc_fused launches {prof_runs[('user', True)]['launches']}")
    out["profiles"] = dict(events=len(ref["events"]),
                           launches=prof_runs[("user", True)]["launches"])
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[front] the front-door phase took {out['wall_s']:.1f} s of wall")
    out["launches"] = {"recompute": rc["launches"],
                       "recompute_gated": gk["launches"],
                       "dynamic_hop": dk["launches"],
                       "admission": ak["launches"],
                       "profiles": prof_runs[("user", True)]["launches"]}
    return out


REL_RUNS = 3
REL_INTERVAL = 8                  # (d): the canary cadence measured
REL_CAP = 160                     # (b), (c): ticks before giving up


def _looped_traffic(cfg, n_streams, hops):
    """``n_streams`` of the served traffic, each looped to a window and
    ``hops`` hops (``_traffic`` cuts at about 27 hops)."""
    import numpy as np
    n = cfg.sample_len + hops * HOP
    return [np.resize(x, n) for x in _traffic(cfg, n_streams=n_streams)]


def phase_reliability(torch, dev):
    """The self-healing chip at full width (``PAPER_KWS``, hop 1024, 8
    slots, chip offsets of std 4, VAD on), every run on the kernel route
    and on the plain route with identical events (``degraded`` included),
    states, health stats and histories, fault stats and counters, and
    ``imc_fused`` launched 5 x ``stats()["imc_passes"]`` times (the
    canary's expected state included):

    (a) faults as riders: a server whose fault model holds stuck columns
        and trim-bit flips serves phase 3's traffic bit for bit as a clean
        server whose 8 streams carry the same integer deltas as installed
        profiles, at SA noise 0 and 1.0 (VAD forced to speech: an
        installed profile also carries its own silence fills, which the
        chip-global fault delta leaves alone);
    (b) stuck columns 2 and 7 of conv3 on a monitored server
        (``HealthConfig(interval=4, layers_per_tick=2)``, 7 live streams
        looped to 150 hops, the eighth slot for the canary), stepped
        until the columns are masked and the chip is healthy again (at
        most ``REL_CAP`` ticks): detection tick, each transition,
        recoveries and ``recovery_energy_uj``;
    (c) a uniform drift of 40 counts on conv2, the same way, until it has
        healed back to healthy through the heal rider (``_heal_delta``);
    (d) decisions/s and the profiled device busy share of phase 3's
        traffic with ``health=HealthConfig(interval=8)`` and without, on 9
        slots (one free for the canary) in both, ``REL_RUNS`` runs each
        in turns, with their spread;
    (e) K1's device time in the first tick whose one batched call (5
        launches, no wake replay) carries live hops and a canary's hop,
        against the same tick of the
        server without health: the captured call replayed under the
        profiler.

    Detection and the launch counts are asserted; the other end states
    are printed (the reference's asserts on them were made at
    ``sample_len=640``)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import jaxrand
    from repro_torch.kernels.imc_mav import ops
    from repro_torch.models import kws
    from repro_torch.serving import (CustomizationResult, FaultConfig,
                                     FaultModel, HealthConfig, StreamServer,
                                     VADConfig)

    t_phase = time.perf_counter()
    cfg = kws.PAPER_KWS
    params = kws.init_params(jaxrand.PRNGKey(0, device="cpu"), cfg,
                             device=dev)
    hw = kws.fold_params(params, kws.init_state(cfg, device=dev), cfg,
                         pack=True)
    chip = _noisy_chip(torch, cfg)
    keys = ("steps", "decisions", "speech_hops", "gated_hops", "learn_hops",
            "batched_calls", "imc_passes", "slots", "faults", "health")

    def run(feed, use_kernel, profiled=False, **kw):
        srv = StreamServer(hw, cfg, hop=HOP, use_kernel=use_kernel,
                           device=dev, **kw)
        torch.cuda.synchronize()
        prof = None
        ops.COUNTS.reset()                  # the path's run starts
        t0 = time.perf_counter()
        if profiled:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out = feed(srv)
                torch.cuda.synchronize()
        else:
            out = feed(srv)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.COUNTS.launches      # ... and ends: read the count
        st = srv.stats()
        want = 5 * st["imc_passes"] if use_kernel else 0
        if launches != want:
            raise AssertionError(f"imc_fused launched {launches} times for "
                                 f"{st['imc_passes']} IMC forwards "
                                 f"(expected {want})")
        st_ = srv._state
        out.update(srv=srv, stats=st, launches=launches, wall=wall,
                   prof=prof, kernel=use_kernel,
                   counters={k: st.get(k) for k in keys},
                   per_stream={sid: {k: v for k, v in p.items()
                                     if k != "wall_s"}
                               for sid, p in st["per_stream"].items()},
                   leaves=[st_.audio_carry, *st_.carries, st_.ring,
                           st_.hop, st_.key, *srv._dstate,
                           *srv._vstate],
                   heal=srv._heal_delta)
        return out

    def same(a, b, what):
        for k in ("events", "trace", "counters", "per_stream"):
            if a.get(k) != b.get(k):
                raise AssertionError(f"{what}: {k} differ between the runs")
        for x, y in zip(a["leaves"], b["leaves"]):
            if not torch.equal(x, y):
                raise AssertionError(f"{what}: state differs between the "
                                     f"runs")
        ha, hb = a["heal"] or {}, b["heal"] or {}
        if sorted(ha) != sorted(hb) or any(
                not np.array_equal(ha[k], hb[k]) for k in ha):
            raise AssertionError(f"{what}: heal deltas differ")

    def routes(feed, what, **kw):
        k, p = run(feed, True, **kw), run(feed, False, **kw)
        same(k, p, what)
        return k

    def served(streams, custom=None, inject=None):
        def feed(srv):
            if inject is not None:
                inject(srv)
            for s, x in enumerate(streams):
                if custom is not None:
                    srv.install_custom(f"s{s}", custom)
                srv.submit(f"s{s}", x)
                srv.finish(f"s{s}")
            return dict(events=srv.drain())
        return feed

    out = {"launches": {}}
    streams = _traffic(cfg)
    forced = VADConfig(force="speech")

    def faulty(fm):
        fm.inject_stuck("conv3", [2, 7])
        fm.inject_stuck("conv2", [0, 5], value=1)
        fm.inject_bit_flips(n=6)

    # (a) faults are riders
    probe = FaultModel.for_config(cfg, FaultConfig(seed=3))
    faulty(probe)
    deltas = probe.deltas()
    hwp, _ = kws.as_hw_params(hw)
    result = CustomizationResult(
        bias={n: hwp.bias[n].cpu().numpy() + deltas[n]
              for n in cfg.imc_layer_names()},
        fc_w=hwp.fc_w.cpu().numpy(), fc_b=hwp.fc_b.cpu().numpy(),
        epochs=1, n_utterances=1, history=[], energy={})
    for std in (0.0, SA_STD):
        kw = dict(slots=SLOTS, chip_offsets=chip, sa_noise_std=std, seed=0,
                  vad=forced)
        fk = routes(served(streams, inject=lambda srv: faulty(srv.faults)),
                    f"faulted (SA {std})",
                    faults=FaultConfig(seed=3), **kw)
        rk = routes(served(streams, custom=result),
                    f"installed deltas (SA {std})", **kw)
        base = run(served(streams), True, **kw)
        if fk["events"] != rk["events"] or not fk["events"]:
            raise AssertionError(f"SA {std}: the faulted server's events "
                                 f"differ from the installed deltas'")
        for x, y in zip(fk["leaves"], rk["leaves"]):
            if not torch.equal(x, y):
                raise AssertionError(f"SA {std}: the faulted server's "
                                     f"state differs from the installed "
                                     f"deltas'")
        moved = sum(a != b for a, b in zip(fk["events"], base["events"]))
        log(f"[reliability] (a) SA {std}: faulted server (stuck conv3 2, 7 "
            f"low, conv2 0, 5 high, 6 trim flips) == clean server with the "
            f"deltas installed on its 8 streams: {len(fk['events'])} "
            f"events and every state leaf, kernel and plain; {moved} "
            f"events differ from the pristine chip's; imc_fused launches "
            f"{fk['launches']} (= 5 x {fk['stats']['imc_passes']})")
        out["launches"][f"riders_sa{std:g}"] = fk["launches"]

    # (b), (c): a monitored chip until it is healthy again
    live = _looped_traffic(cfg, SLOTS - 1, 150)

    def scenario(inject, at, done):
        def feed(srv):
            for s, x in enumerate(live):
                srv.submit(f"s{s}", x)
                srv.finish(f"s{s}")
            events, trace = [], []
            for t in range(REL_CAP):
                if t == at:
                    inject(srv)
                events.extend(srv.step())
                trace.append(srv.health.state)
                if t > at and done(srv):
                    break
            return dict(events=events, trace=trace)
        return feed

    def stuck(srv):
        srv.faults.inject_stuck("conv3", [2, 7])

    def drift(srv):
        srv.faults._drift["conv2"][:] = 40.0
        srv.faults._dirty = True

    def healed_with(masked):
        def done(srv):
            h = srv.health
            return (h.state == "healthy" and h.recoveries >= 1
                    and {n: list(np.where(m)[0]) for n, m in
                         h.masked.items() if m.any()} == masked)
        return done

    res = {}
    for name, inject, masked in (("stuck", stuck, {"conv3": [2, 7]}),
                                 ("drift", drift, {})):
        k = routes(scenario(inject, 4, healed_with(masked)),
                   f"{name} scenario", slots=SLOTS, chip_offsets=chip,
                   vad=VADConfig(), faults=FaultConfig(seed=3),
                   health=HealthConfig(interval=4, layers_per_tick=2))
        h = k["stats"]["health"]
        if h["detected_tick"] is None:
            raise AssertionError(f"{name}: the fault was not detected")
        heal = sorted(k["heal"] or {})
        log(f"[reliability] ({'b' if name == 'stuck' else 'c'}) {name}: "
            f"injected at tick 4, detected at tick {h['detected_tick']}, "
            f"quarantined at {h['quarantined_tick']}; transitions "
            f"{[(e['tick'], e['state']) for e in h['history']]}; "
            f"{h['recoveries']} recoveries, recovery_energy_uj "
            f"{h['recovery_energy_uj']}, masked {h['masked_channels']}, "
            f"heal rider on {heal}; end state {h['state']} after "
            f"{k['stats']['steps']} ticks, {h['canaries']} canaries "
            f"({h['failed_canaries']} failed); "
            f"{sum(e['degraded'] for e in k['events'])} of "
            f"{len(k['events'])} events flagged degraded; imc_fused "
            f"launches {k['launches']} (= 5 x {k['stats']['imc_passes']}); "
            f"kernel and plain equal")
        res[name] = dict(
            detected_tick=h["detected_tick"],
            quarantined_tick=h["quarantined_tick"],
            history=h["history"], recoveries=h["recoveries"],
            recovery_energy_uj=h["recovery_energy_uj"],
            masked=h["masked_channels"], heal_layers=heal,
            state=h["state"], ticks=k["stats"]["steps"],
            launches=k["launches"])
        out["launches"][name] = k["launches"]
    out.update(res)

    # (d) health on and off, phase 3's traffic on 9 slots
    monitored = dict(slots=SLOTS + 1, chip_offsets=chip, vad=VADConfig())
    health = HealthConfig(interval=REL_INTERVAL)
    run(served(streams), True, **monitored)                     # warm-up
    run(served(streams), True, health=health, **monitored)
    timed = {False: [], True: []}
    for _ in range(REL_RUNS):
        for on in (False, True):
            timed[on].append(run(served(streams), True,
                                 health=health if on else None,
                                 **monitored))
    on_plain = run(served(streams), False, health=health, **monitored)
    same(timed[True][0], on_plain, "health on")
    for on in (False, True):
        for r in timed[on][1:]:
            same(r, timed[on][0], f"health {'on' if on else 'off'}")
    dps = {on: [r["stats"]["decisions"] / r["wall"] for r in timed[on]]
           for on in (False, True)}
    busy = {}
    for on in (False, True):
        r = run(served(streams), True, profiled=True,
                health=health if on else None, **monitored)
        busy_us, rows = device_time(torch, r["prof"])
        busy[on] = dict(share=busy_us / 1e6 / r["wall"], wall=r["wall"],
                        k1_ms=sum(us for name, (us, _) in rows.items()
                                  if "imc_fused" in name) / 1e3,
                        launches=r["launches"])
    on0, off0 = timed[True][0]["stats"], timed[False][0]["stats"]
    flagged = [e.pop("degraded") for e in timed[True][0]["events"]]
    if (timed[True][0]["events"] != timed[False][0]["events"]
            or any(flagged) or not on0["health"]["canaries"]):
        raise AssertionError(f"health run: events differ from the "
                             f"unmonitored run's or are flagged degraded "
                             f"({sum(flagged)}); {on0['health']['canaries']} "
                             f"canaries")
    log(f"[reliability] (d) phase 3's traffic on {SLOTS + 1} slots: "
        f"{off0['decisions']} decisions in {off0['steps']} ticks; health "
        f"off: wall decisions/s {[round(v, 1) for v in dps[False]]}, K1 "
        f"launches {timed[False][0]['launches']}; health on (interval "
        f"{REL_INTERVAL}): {[round(v, 1) for v in dps[True]]}, "
        f"{on0['health']['canaries']} canaries, K1 launches "
        f"{timed[True][0]['launches']} (= 5 x {on0['imc_passes']}), state "
        f"{on0['health']['state']}; profiled busy share off "
        f"{busy[False]['share']:.4f} (K1 {busy[False]['k1_ms']:.3f} ms), "
        f"on {busy[True]['share']:.4f} (K1 {busy[True]['k1_ms']:.3f} ms); "
        f"kernel and plain equal")
    out["health_cost"] = dict(
        decisions=off0["decisions"], ticks=off0["steps"],
        wall_dps_off=dps[False], wall_dps_on=dps[True],
        canaries=on0["health"]["canaries"],
        launches_off=timed[False][0]["launches"],
        launches_on=timed[True][0]["launches"],
        busy_share_off=busy[False]["share"],
        busy_share_on=busy[True]["share"],
        k1_ms_off=busy[False]["k1_ms"], k1_ms_on=busy[True]["k1_ms"])
    out["launches"]["health_on"] = timed[True][0]["launches"]

    # (e) the tick whose batch carries a canary's hop
    def captured(on):
        srv = StreamServer(hw, cfg, hop=HOP, use_kernel=True, device=dev,
                           health=health if on else None, **monitored)
        for s, x in enumerate(streams):
            srv.submit(f"s{s}", x)
            srv.finish(f"s{s}")
        eng = srv.engine
        calls = []
        real = eng.step

        def spy(state, audio, *riders):
            calls.append((tuple(x.clone() if torch.is_tensor(x) else
                                tuple(y.clone() for y in x)
                                for x in state), audio.clone(), riders))
            return real(state, audio, *riders)

        eng.step = spy
        return srv, calls

    srv_on, calls_on = captured(True)
    tick = None
    for t in range(REL_CAP):
        p = srv_on.health._pending
        rec = None if p is None else srv_on._streams.get(p["stream"])
        due = rec is not None and rec.initialized
        n0, c0 = ops.COUNTS.launches, len(calls_on)
        hops0 = srv_on.stats()["speech_hops"]
        srv_on.step()
        live_hops = srv_on.stats()["speech_hops"] - hops0
        # the canary's hop and live hops in the tick's one batched call,
        # and no other IMC call (a wake replay) in that tick
        if (due and srv_on.health._pending is None and live_hops
                and ops.COUNTS.launches - n0 == 5
                and len(calls_on) == c0 + 1):
            tick = t
            break
    if tick is None:
        raise AssertionError("no canary hop rode a batch of live hops")
    srv_off, calls_off = captured(False)
    for _ in range(tick + 1):
        srv_off.step()
    state_cls = type(srv_on._state)
    times = {}
    for on, calls in ((True, calls_on), (False, calls_off)):
        srv = srv_on if on else srv_off
        st, audio, riders = calls[-1]
        st = state_cls(*st)
        eng = srv._engines[1]
        step = type(eng).step              # the engine's own, not the spy
        times[on] = device_ms(torch, lambda: step(eng, st, audio, *riders),
                              iters=10, kernel="imc_fused")
    log(f"[reliability] (e) tick {tick}: {live_hops} live hops and a "
        f"canary hop in one batched call (5 imc_fused launches); K1 device "
        f"time {times[True]} ms with the canary, {times[False]} ms the "
        f"same tick without health (B = {SLOTS + 1} both)")
    out["canary_tick"] = dict(tick=tick, live_hops=live_hops,
                              k1_ms_with=times[True],
                              k1_ms_without=times[False])
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"[reliability] the reliability phase took {out['wall_s']:.1f} s "
        f"of wall")
    return out


LEARN_N, LEARN_BATCH, LEARN_EVAL = 120, 60, 200
LEARN_CHECK = 8          # windows of the steps held against the CPU
# a soft epoch (tanh, alpha 2), then a hard surrogate-gradient epoch on the
# in-memory bias grid (alpha -5): two steps each at 120 windows, batch 60
LEARN_SCHEDULE = ((0.5, 2.0), (1.0, -5.0))
LEARN_SHARE = 0.05       # parameters allowed outside 1e-4 |p| + 1e-5


def _params_apart(torch, got, want):
    """(elements of ``got`` outside 1e-4 |want| + 1e-5, elements, largest
    |got - want|) over two parameter trees (``got`` may live elsewhere)."""
    off = total = 0
    worst = 0.0
    for n in want:
        for k in want[n]:
            a, b = got[n][k].cpu(), want[n][k].cpu()
            d = torch.abs(a - b)
            off += int(torch.sum(d > 1e-4 * torch.abs(b) + 1e-5))
            total += b.numel()
            worst = max(worst, float(d.max()))
    return off, total, worst


def _mean_ties(torch, dev):
    """Phase 10 (c): the T = 448 GAP tie at every GAP site and the N = 7
    head tie on both K2 routes, on the card against the plain version,
    the CPU and the reference's values (0.4375, 7/128)."""
    import numpy as np
    from repro_torch.core import onchip_training as ot
    from repro_torch.core.quantize import ACT_Q
    from repro_torch.kernels.sga_update import ops as sga_ops
    from repro_torch.kernels.sga_update import ref as sga_ref
    from repro_torch.models import kws
    from repro_torch.serving import stream as sv
    from repro_torch.serving.customize import capture_features

    rng = np.random.default_rng(0)
    ring = np.where(rng.random((2, 448, 576)) < 0.5, 1.0, -1.0)
    for r in range(2):                  # channel 0: 315 ones, sum 182
        ring[r, :, 0] = -1.0
        ring[r, rng.permutation(448)[:315], 0] = 1.0
    ring = ring.astype(np.float32)
    fc_w = (np.round(rng.normal(size=(576, 10)) * 5) / 128).astype(
        np.float32)
    fc_b = (np.round(rng.normal(size=10) * 5) / 128).astype(np.float32)
    heads = (np.round(rng.normal(size=(2, 576, 10)) * 5) / 128).astype(
        np.float32)
    head_b = (np.round(rng.normal(size=(2, 10)) * 5) / 128).astype(
        np.float32)
    if float(ACT_Q.quantize(torch.tensor(ring[0, :, 0]).sum() / 448)) \
            != 0.375:
        raise AssertionError("the GAP input is not a tie")

    def sites(d):
        t = lambda a: torch.tensor(a, device=d)
        hw = kws.HWParams(w_bin={}, bias={}, flip={}, fc_w=t(fc_w),
                          fc_b=t(fc_b))
        logits, feats = kws.gap_fc(hw, t(ring))
        return dict(feats=feats, logits=logits,
                    ring=sv._ring_logits(hw, t(ring), None, None),
                    heads=sv._ring_logits(hw, t(ring), t(heads), t(head_b)),
                    capture=capture_features(t(ring[0])))

    card, cpu = sites(dev), sites("cpu")
    for k in card:
        if not torch.equal(card[k].cpu(), cpu[k]):
            raise AssertionError(f"GAP tie: {k} differs on the card")
    if not (float(card["feats"][0, 0]) == float(card["capture"][0])
            == 0.4375):
        raise AssertionError("GAP tie: feats[0, 0] is not 0.4375")

    feats = np.array([[1, -0.625], [-1, 0], [0.5, 0], [-0.5, -0.5],
                      [0.25, 0], [0.75, 0], [-0.75, 0]], np.float32)
    labels = np.array([0, 1, 2, 1, 2, 0, 0])
    w0 = np.array([[0.5, -0.25, 0.125], [0, 0, 0]], np.float32)
    b0 = np.array([0, 0.125, -0.125], np.float32)
    tcfg = ot.OnChipTrainConfig()
    spec, out = ot.head_train_spec(tcfg), {}
    for epochs in (1, 30):
        res = {}
        for d in (dev, "cpu"):
            st, fq, oh = ot.finetune_init(feats, labels, w0, b0, tcfg,
                                          device=d)
            # per-epoch route: epoch_grads, then one sga_update_rows
            # launch (the plain version beside it on the card)
            per = [st.w.reshape(-1), st.b, st.accum_w.reshape(-1),
                   st.accum_b]
            gw10 = None
            for e in range(epochs):
                s = ot.HeadState(per[0].reshape(2, 3), per[1],
                                 per[2].reshape(2, 3), per[3], st.key)
                gw, gb, lr, _ = ot.epoch_grads(s, e, fq, oh, tcfg)
                gw10 = float(gw[1, 0]) if e == 0 else gw10
                args = (torch.cat([per[0], per[1]])[None],
                        torch.cat([gw.reshape(-1), gb])[None],
                        torch.cat([per[2], per[3]])[None], lr.reshape(1),
                        ot.sga_threshold(lr).reshape(1))
                nw, na = sga_ops.sga_update_batch(*args)
                if d != "cpu":
                    pw, pa = sga_ref.sga_update_ref(
                        *args[:3], args[3][:, None], args[4][:, None])
                    if not (torch.equal(nw, pw) and torch.equal(na, pa)):
                        raise AssertionError("sga_update_rows differs from "
                                             "its plain version")
                per = [nw[0, :6], nw[0, 6:], na[0, :6], na[0, 6:]]
            # fused route: head_train_rows (kernel on the card) and its
            # plain version on the card
            fused = [v.clone() for v in (st.w, st.b, st.accum_w,
                                         st.accum_b)]
            sga_ops.head_train_batch(*([v] for v in fused), [fq], [oh], [0],
                                     [epochs], ot.train_lut(fq.device), spec)
            if d != "cpu":
                plain = [v.clone() for v in (st.w, st.b, st.accum_w,
                                             st.accum_b)]
                sga_ref.head_train_rows_ref(*([v] for v in plain), [fq],
                                            [oh], [0], [epochs],
                                            ot.train_lut(fq.device), spec)
                if not all(torch.equal(a, b) for a, b in zip(fused, plain)):
                    raise AssertionError("head_train_rows differs from its "
                                         "plain version")
            res[d] = (gw10, [v.cpu() for v in per],
                      [v.cpu().reshape(-1) for v in fused])
        (gw_k, per_k, fused_k), (gw_c, per_c, fused_c) = res[dev], res["cpu"]
        if not gw_k == gw_c == 7 / 128:
            raise AssertionError(f"head tie: gw[1, 0] {gw_k} / {gw_c}")
        for a, b in zip(per_k + fused_k, per_c + fused_c):
            if not torch.equal(a, b):
                raise AssertionError("head tie: the card's head differs "
                                     "from the CPU's")
        for a, b in zip(per_k, fused_k):
            if not torch.equal(a.reshape(-1), b.reshape(-1)):
                raise AssertionError("head tie: the two routes differ")
        if epochs == 1 and float(fused_k[2][3]) != 7 / 128:
            raise AssertionError("head tie: the bank does not hold 7/128")
        out[epochs] = [float(v) for v in fused_k[0]]
    log("[learning] (c) T = 448 GAP tie: feats[0, 0] = 0.4375 through "
        "gap_fc, _ring_logits (shared and per-stream heads) and the capture, "
        "equal on the card and the CPU; N = 7 head tie: gw[1, 0] = 7/128 "
        "on the card and the CPU, the head after 1 and 30 epochs equal on "
        "the per-epoch route (epoch_grads + sga_update_rows), the fused "
        "route (head_train_rows) and the plain versions")
    return dict(gap_feat0=float(card["feats"][0, 0]), head_gw10=7 / 128,
                head_w_after=out)


def phase_learning(torch, dev):
    """Phase 10: the float learning path at full width on the card."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import imc, jaxrand
    from repro_torch.data import audio
    from repro_torch.kernels.imc_mav import ops
    from repro_torch.kernels.sga_update import ops as sga_ops
    from repro_torch.models import kws
    from repro_torch.training import kws as tr

    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32):
        raise AssertionError("TF32 is on: the float path runs in float32")
    t_phase = time.perf_counter()
    cfg = kws.PAPER_KWS
    (xtr, ytr), (xte, yte) = audio.make_gscd_like(
        seed=7, train_per_class=LEARN_N // 10,
        test_per_class=LEARN_EVAL // 10)
    chans = {name: cfg.channels[i]
             for i, name in enumerate(cfg.imc_layer_names(), start=1)}
    chip = imc.sample_chip_offsets(jaxrand.PRNGKey(0, device="cpu"), chans,
                                   imc.IMCNoiseParams(OFFSET_STD, SA_STD))
    init = kws.init_params(jaxrand.PRNGKey(1, device="cpu"), cfg, device=dev)
    log(f"[learning] traffic and the initial net: "
        f"{time.perf_counter() - t_phase:.1f} s")
    out = {}
    trained = None
    for name, offs, std in (("clean", None, 0.0),
                            ("recovery", chip, SA_STD)):
        offs_dev = None if offs is None else _to(offs, dev)

        def card_run(tcfg, x, y, params=None, state=None, hist=None):
            return tr.train_base(x, y, cfg, tcfg, params=params, state=state,
                                 chip_offsets=offs_dev, sa_noise_std=std,
                                 verbose=False, history=hist, device=dev)

        def cpu_run(tcfg, x, y, params=None, state=None, hist=None):
            return tr.train_base(x, y, cfg, tcfg, params=params, state=state,
                                 chip_offsets=offs, sa_noise_std=std,
                                 verbose=False, history=hist, device="cpu")

        # (a) the main run: the whole schedule, once to warm up (first use
        # of each operation on the card), then timed, then profiled
        main = tr.TrainConfig(epochs=2, batch_size=LEARN_BATCH,
                              alpha_schedule=LEARN_SCHEDULE, seed=1)
        card_run(main, xtr, ytr, params=init)
        hist = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state = card_run(main, xtr, ytr, params=init, hist=hist)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [float(h["loss"]) for h in hist]
        if [h["alpha"] for h in hist] != [2.0, 2.0, -5.0, -5.0] \
                or not all(np.isfinite(losses)):
            raise AssertionError(f"{name}: bad training run {hist}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            card_run(main, xtr, ytr, params=init)
            torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
        busy_us, rows = device_time(torch, prof)
        steps = len(hist)
        # one step at a time from identical parameters against the CPU (on
        # LEARN_CHECK full-width windows, which bounds the CPU's time): a
        # soft step from the initial net and a hard step from the card's
        # soft-trained net, at a constant learning rate of 0.01
        agree = {}
        start = (init, None)
        for phase, alpha in (("soft", 2.0), ("hard", -5.0)):
            t_check = time.perf_counter()
            one = tr.TrainConfig(epochs=1, batch_size=LEARN_CHECK,
                                 alpha_schedule=((1.0, alpha),), seed=2,
                                 lr_min=0.01)
            hk, hc = [], []
            xs, ys = xtr[:LEARN_CHECK], ytr[:LEARN_CHECK]
            pk, sk = card_run(one, xs, ys, *start, hist=hk)
            pc, sc = cpu_run(one, xs, ys,
                             *(None if v is None else _to(v, "cpu")
                               for v in start), hist=hc)
            lk, lc = float(hk[0]["loss"]), float(hc[0]["loss"])
            apart, total, worst = _params_apart(torch, pk, pc)
            if abs(lk - lc) > 1e-3 * abs(lc) or apart > LEARN_SHARE * total \
                    or worst > 2 * 0.01:
                raise AssertionError(
                    f"{name} {phase} step: card loss {lk} CPU {lc}, "
                    f"{apart} of {total} parameters apart (max {worst})")
            for a, b in zip(list(sk.mean.values()) + list(sk.var.values()),
                            list(sc.mean.values()) + list(sc.var.values())):
                if not torch.equal(a.cpu(), b):
                    raise AssertionError(f"{name} {phase}: BN state differs")
            agree[phase] = dict(loss_card=lk, loss_cpu=lc,
                                params_apart=apart, params=total,
                                max_abs_diff=worst,
                                seconds=time.perf_counter() - t_check)
            start = (pk, sk)
        busy = busy_us / 1e6 / prof_wall
        out[name] = dict(losses=losses, wall_s=wall,
                         wall_ms_per_step=wall / steps * 1e3,
                         profiled_wall_ms_per_step=prof_wall / steps * 1e3,
                         device_busy_ms=busy_us / 1e3,
                         device_busy_share=busy, steps=agree)
        log(f"[learning] (a) {name}: train_base at PAPER_KWS, {LEARN_N} "
            f"windows, batch {LEARN_BATCH}, alpha {[h['alpha'] for h in hist]}"
            f": losses {[round(v, 4) for v in losses]}; wall "
            f"{wall / steps * 1e3:.1f} ms/step; profiled "
            f"{prof_wall / steps * 1e3:.1f} ms/step, device busy "
            f"{busy_us / 1e3:.1f} ms (share {busy:.4f})")
        for phase, a in agree.items():
            log(f"[learning] (a) {name} {phase} step, card vs CPU from "
                f"identical parameters: loss {a['loss_card']:.6f} / "
                f"{a['loss_cpu']:.6f}; {a['params_apart']} of {a['params']} "
                f"parameters outside 1e-4|p| + 1e-5, max |diff| "
                f"{a['max_abs_diff']:.3g} ({a['seconds']:.1f} s, both "
                f"devices)")
        for k, (us, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:5]:
            log(f"[learning]   {us / 1e3:8.3f} ms  n={n:5d}  {k[:80]}")
        if name == "clean":
            trained = (params, state)

    # (b) the trained net, float path against the unconstrained fold
    # through K1, and evaluate on the card and the CPU
    params, state = trained
    x = kws.as_tensor(xte, dev)
    with torch.no_grad():
        _, f_eval = kws.forward_eval(params, state, x, cfg)
    hw_u = kws.fold_params(params, state, cfg, bn_constraints=False,
                           pack=True)
    ops.COUNTS.reset()
    _, f_hw = kws.hw_forward(hw_u, x, cfg, use_kernel=True, device=dev)
    k1 = ops.COUNTS.launches
    _, f_plain = kws.hw_forward(hw_u, x, cfg, use_kernel=False, device=dev)
    fold_err = float(torch.max(torch.abs(f_hw - f_eval)))
    if k1 != 5 or fold_err > 1e-5 or not torch.equal(f_hw, f_plain):
        raise AssertionError(f"fold: K1 {k1} launches (expected 5), "
                             f"max |hw - eval| {fold_err}, kernel == plain "
                             f"{torch.equal(f_hw, f_plain)}")
    t_eval = time.perf_counter()
    acc_card = tr.evaluate(params, state, xte, yte, cfg, device=dev)
    t_eval, t_cpu = time.perf_counter() - t_eval, time.perf_counter()
    acc_cpu = tr.evaluate(_to(params, "cpu"), _to(state, "cpu"), xte, yte,
                          cfg, device="cpu")
    t_cpu = time.perf_counter() - t_cpu
    if acc_card != acc_cpu:
        raise AssertionError(f"evaluate: card {acc_card}, CPU {acc_cpu}")
    log(f"[learning] (b) the trained net at B = {LEARN_EVAL}: forward_eval "
        f"features against hw_forward through K1 on the unconstrained fold "
        f"max |diff| {fold_err:.3g} (K1 {k1} launches = 5 x 1 forward, "
        f"equal to the plain version); evaluate accuracy card {acc_card} "
        f"({t_eval:.2f} s), CPU {acc_cpu} ({t_cpu:.1f} s)")
    sga_ops.COUNTS_ROWS.reset()
    sga_ops.COUNTS_HEAD.reset()
    t_ties = time.perf_counter()
    ties = _mean_ties(torch, dev)
    log(f"[learning] (c) took {time.perf_counter() - t_ties:.1f} s")
    ties["launches"] = dict(sga_update_rows=sga_ops.COUNTS_ROWS.launches,
                            head_train_rows=sga_ops.COUNTS_HEAD.launches)
    if not (ties["launches"]["sga_update_rows"] == 31
            and ties["launches"]["head_train_rows"] == 2):
        raise AssertionError(f"phase 10 (c) launches {ties['launches']}")
    t_phase = time.perf_counter() - t_phase
    log(f"[learning] phase 10 took {t_phase:.1f} s")
    return dict(runs=out, fold=dict(max_abs_diff=fold_err, k1_launches=k1,
                                    batch=LEARN_EVAL),
                accuracy=dict(card=acc_card, cpu=acc_cpu), ties=ties,
                seconds=t_phase)


# the paper's pipeline (phase 11): benchmarks/kws_experiments.py's fast run
PIPE_PER_CLASS = (40, 12)        # make_gscd_like train / test per class
PIPE_EPOCHS, PIPE_FT_EPOCHS, PIPE_HEAD_EPOCHS = 24, 1, 400
PIPE_CHIPS, PIPE_CALIB, PIPE_CHECK = 2, 150, 16
PIPE_MAV_STD = 8.0                # the experiment's chip: offsets of std 8


def _hw_kw(**kw):
    """The keyword arguments of ``training.kws._hw_batched``, defaults
    filled in as ``evaluate_hw`` fills them."""
    return {"chip_offsets": None, "sa_noise_std": 0.0, "seed": 0,
            "batch": 200, "sa_noise_field": None, **kw}


def phase_pipeline(torch, dev):
    """Phase 11: the paper's Tables II-IV pipeline at full width, as
    ``benchmarks/kws_experiments.py`` runs it with ``fast``: ``train_base``
    on the card (24 epochs of 400 windows at batch 100), then every
    accuracy row through ``evaluate_hw(use_kernel=True)``: the ideal and
    the FC-quantized folds, the BN-constrained packed fold, two chips
    (offsets of std 8 from ``PRNGKey(100 + s)``, SA noise 1.0) noisy and
    compensated (``calibrate_and_compensate(xtr[:150])``), and a
    noise-aware fine-tune of one epoch on chip 0; Table IV's five head
    variants (400 epochs each) on ``hw_features`` of the compensated chip
    0; the chip report.  Gates: each ``evaluate_hw`` launches K1 5 x its
    chunks and its logits through K1 equal the plain route's on the card;
    on ``PIPE_CHECK`` windows the card equals the CPU, clean, noisy and on
    the compensated biases.  The accuracies are printed, not gated: a
    few-epoch net is not the paper's."""
    import numpy as np
    from repro_torch.core import energy, imc, jaxrand
    from repro_torch.core.onchip_training import (OnChipTrainConfig,
                                                  head_accuracy,
                                                  quantized_head_finetune)
    from repro_torch.data import audio
    from repro_torch.kernels.imc_mav import ops
    from repro_torch.models import kws
    from repro_torch.training import kws as tr

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = kws.PAPER_KWS
    (xtr, ytr), (xte, yte) = audio.make_gscd_like(
        train_per_class=PIPE_PER_CLASS[0], test_per_class=PIPE_PER_CLASS[1],
        length=cfg.sample_len)
    (xp_tr, yp_tr), (xp_te, yp_te) = audio.make_personal(
        train_per_class=3, test_per_class=6, length=cfg.sample_len,
        accent_shift=0.18)
    log(f"[pipeline] data: {len(ytr)} / {len(yte)} windows, personal "
        f"{len(yp_tr)} / {len(yp_te)} ({time.perf_counter() - t_phase:.1f} "
        f"s)")
    tcfg = tr.TrainConfig(
        epochs=PIPE_EPOCHS, batch_size=100, lr=3e-3, log_every=48,
        alpha_schedule=((0.3, 2.0), (0.5, 5.0), (0.65, 12.0), (1.0, -8.0)),
        polarize_weight=5e-3)
    hist = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, state = tr.train_base(xtr, ytr, cfg, tcfg, verbose=False,
                                  history=hist, device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    losses = [float(h["loss"]) for h in hist]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train_base: non-finite losses {losses}")
    log(f"[pipeline] train_base: {len(hist)} steps at batch 100 in "
        f"{train_s:.1f} s ({train_s / len(hist) * 1e3:.1f} ms/step); loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}")

    launches = {"evaluate_hw": 0, "hw_features": 0}
    table = {}

    def evaluate(row, hw, x, y, **kw):
        """One accuracy row: ``evaluate_hw`` through K1 (the main path:
        its launches counted, 5 a chunk), then its logits through K1 and
        the plain route, which must be equal."""
        chunks = -(-len(y) // 200)
        n0 = ops.COUNTS.launches
        t0 = time.perf_counter()
        acc = tr.evaluate_hw(hw, x, y, cfg, use_kernel=True, device=dev,
                             **kw)
        wall = time.perf_counter() - t0
        n = ops.COUNTS.launches - n0
        if n != 5 * chunks:
            raise AssertionError(f"{row}: evaluate_hw launched K1 {n} times "
                                 f"for {chunks} chunks")
        launches["evaluate_hw"] += n
        lk = tr._hw_batched(hw, x, cfg, 0, use_kernel=True, device=dev,
                            **_hw_kw(**kw))
        lp = tr._hw_batched(hw, x, cfg, 0, use_kernel=False, device=dev,
                            **_hw_kw(**kw))
        if not torch.equal(lk, lp) or not torch.isfinite(lk).all():
            raise AssertionError(f"{row}: logits through K1 differ from the "
                                 f"plain route's")
        if acc != float(np.mean(np.argmax(lk.cpu().numpy(), -1) == y)):
            raise AssertionError(f"{row}: evaluate_hw's accuracy is not its "
                                 f"logits'")
        table[row] = acc
        log(f"[pipeline] {row}: accuracy {acc:.4f} on {len(y)} windows "
            f"({wall:.2f} s; K1 {n} launches = 5 x {chunks} chunks, logits "
            f"equal to the plain route)")
        return acc

    # Table II and III
    evaluate("ideal", kws.fold_params(params, state, cfg,
                                      bn_constraints=False, fc_quant=False),
             xte, yte)
    evaluate("fc_quantized", kws.fold_params(params, state, cfg,
                                             bn_constraints=False,
                                             fc_quant=True), xte, yte)
    hw = kws.fold_params(params, state, cfg, pack=True)
    evaluate("bn_constraints", hw, xte, yte)
    chans = {name: cfg.channels[i]
             for i, name in enumerate(cfg.imc_layer_names(), start=1)}
    chips = [imc.sample_chip_offsets(
        jaxrand.PRNGKey(100 + s, device="cpu"), chans,
        imc.IMCNoiseParams(mav_offset_std=PIPE_MAV_STD, sa_noise_std=SA_STD))
        for s in range(PIPE_CHIPS)]
    hw_comp0 = None
    for s, offs in enumerate(chips):
        offs_dev = _to(offs, dev)
        evaluate(f"mav_sa_noise_chip{s}", hw, xte, yte,
                 chip_offsets=offs_dev, sa_noise_std=SA_STD, seed=s)
        t0 = time.perf_counter()
        hw_c = tr.calibrate_and_compensate(hw, xtr[:PIPE_CALIB], offs_dev,
                                           cfg, device=dev)
        log(f"[pipeline] calibrate_and_compensate chip {s} on "
            f"{PIPE_CALIB} windows: {time.perf_counter() - t0:.2f} s")
        hw_comp0 = hw_c if hw_comp0 is None else hw_comp0
        evaluate(f"bias_compensation_chip{s}", hw_c, xte, yte,
                 chip_offsets=offs_dev, sa_noise_std=SA_STD, seed=s)
    chip0 = _to(chips[0], dev)
    ft_cfg = tr.TrainConfig(epochs=PIPE_FT_EPOCHS, batch_size=100, lr=1e-3,
                            log_every=999, alpha_schedule=((1.0, -8.0),),
                            polarize_weight=0.0)
    t0 = time.perf_counter()
    p_ft, st_ft = tr.train_base(xtr, ytr, cfg, ft_cfg, params=params,
                                state=state, chip_offsets=chip0,
                                sa_noise_std=SA_STD, verbose=False,
                                device=dev)
    torch.cuda.synchronize()
    ft_s = time.perf_counter() - t0
    hw_ft = tr.calibrate_and_compensate(kws.fold_params(p_ft, st_ft, cfg),
                                        xtr[:PIPE_CALIB], chip0, cfg,
                                        device=dev)
    evaluate("compensation_finetune", hw_ft, xte, yte, chip_offsets=chip0,
             sa_noise_std=SA_STD, seed=0)
    log(f"[pipeline] noise-aware fine-tune: {PIPE_FT_EPOCHS} epoch "
        f"({len(ytr) // 100} steps) in {ft_s:.1f} s")

    # Table IV: the head variants on the compensated chip 0's features
    feats = {}
    for part, x in (("train", xp_tr), ("test", xp_te)):
        n0 = ops.COUNTS.launches
        feats[part] = tr.hw_features(hw_comp0, x, cfg, chip_offsets=chip0,
                                     sa_noise_std=SA_STD, use_kernel=True,
                                     device=dev)
        n = ops.COUNTS.launches - n0
        if n != 5 * -(-len(x) // 200):
            raise AssertionError(f"hw_features ({part}): K1 {n} launches")
        launches["hw_features"] += n
        plain = tr.hw_features(hw_comp0, x, cfg, chip_offsets=chip0,
                               sa_noise_std=SA_STD, use_kernel=False,
                               device=dev)
        if not torch.equal(feats[part], plain):
            raise AssertionError(f"hw_features ({part}): K1 and the plain "
                                 f"route differ")
    evaluate("before_customization", hw_comp0, xp_te, yp_te,
             chip_offsets=chip0, sa_noise_std=SA_STD)
    hwp0, _ = kws.as_hw_params(hw_comp0)
    variants = {
        "baseline_fp": dict(quantized=False),
        "quantized_naive": dict(quantized=True, error_scaling=False,
                                sga=False, rgp=False),
        "error_scaling": dict(quantized=True, error_scaling=True, sga=False,
                              rgp=False),
        "es_sga": dict(quantized=True, error_scaling=True, sga=True,
                       rgp=False),
        "es_sga_rgp": dict(quantized=True, error_scaling=True, sga=True,
                           rgp=True, rgp_lambda=8.0),
    }
    t4 = {}
    t0 = time.perf_counter()
    labels_te = torch.as_tensor(yp_te, device=dev)
    for name, kw in variants.items():
        ocfg = OnChipTrainConfig(epochs=PIPE_HEAD_EPOCHS, **kw)
        w, b = quantized_head_finetune(feats["train"], yp_tr, hwp0.fc_w,
                                       hwp0.fc_b, ocfg, device=dev)
        t4[name] = float(head_accuracy(feats["test"], labels_te, w, b, ocfg))
    head_s = time.perf_counter() - t0
    log(f"[pipeline] Table IV ({PIPE_HEAD_EPOCHS} epochs each, "
        f"{head_s:.1f} s): before {table['before_customization']:.4f}, "
        + ", ".join(f"{k} {v:.4f}" for k, v in t4.items()))

    # the card against the CPU on PIPE_CHECK windows
    t0 = time.perf_counter()
    hw_cpu = _to(hw, "cpu")
    sub = xte[:PIPE_CHECK]
    for what, kd, kc in (("clean", {}, {}),
                         ("noisy", dict(chip_offsets=chip0,
                                        sa_noise_std=SA_STD),
                          dict(chip_offsets=chips[0], sa_noise_std=SA_STD))):
        lk = tr._hw_batched(hw, sub, cfg, 0, use_kernel=True, device=dev,
                            **_hw_kw(**kd))
        lc = tr._hw_batched(hw_cpu, sub, cfg, 0, use_kernel=True,
                            device="cpu", **_hw_kw(**kc))
        if not torch.equal(lk.cpu(), lc):
            raise AssertionError(f"{what} logits: the card and the CPU "
                                 f"differ")
    hc_dev = tr.calibrate_and_compensate(hw, xtr[:PIPE_CHECK], chip0, cfg,
                                         device=dev)
    hc_cpu = tr.calibrate_and_compensate(hw_cpu, xtr[:PIPE_CHECK], chips[0],
                                         cfg, device="cpu")
    for name in cfg.imc_layer_names():
        if not torch.equal(hc_dev.hw.bias[name].cpu(), hc_cpu.hw.bias[name]):
            raise AssertionError(f"compensated {name}: the card and the CPU "
                                 f"differ")
    check_s = time.perf_counter() - t0
    log(f"[pipeline] on {PIPE_CHECK} windows the card equals the CPU: "
        f"clean and noisy logits, compensated biases ({check_s:.1f} s)")

    rep = energy.kws_chip_report(kws.layer_stats(cfg))
    report = dict(uj_per_decision=rep.energy_j_per_decision * 1e6,
                  power_w=rep.power_w, total_ops=rep.total_ops,
                  tops_per_w=rep.tops_per_w, breakdown=rep.breakdown())
    log(f"[pipeline] chip report: {report['uj_per_decision']:.4f} "
        f"uJ/decision, {rep.power_w * 1e6:.2f} uW, {rep.total_ops} ops, "
        f"{rep.tops_per_w:.4f} TOPS/W; dynamic energy by layer "
        + ", ".join(f"{k} {v:.3f}" for k, v in report["breakdown"].items()))
    peak = torch.cuda.max_memory_allocated(dev)
    seconds = time.perf_counter() - t_phase
    log(f"[pipeline] K1 launches: evaluate_hw {launches['evaluate_hw']}, "
        f"hw_features {launches['hw_features']}; peak device memory "
        f"{peak / 2 ** 30:.2f} GiB; phase 11 took {seconds:.1f} s")
    return dict(train=dict(steps=len(hist), seconds=train_s,
                           ms_per_step=train_s / len(hist) * 1e3,
                           losses=[losses[0], losses[-1]]),
                table23=table, table4=t4, chip_report=report,
                launches=launches["evaluate_hw"] + launches["hw_features"],
                launches_by_call=launches, finetune_s=ft_s, head_s=head_s,
                check_s=check_s, max_memory_bytes=peak, seconds=seconds)


OBS_PAIRS = 3                     # off / on pairs of the decisions/s


def phase_obs(torch, dev):
    """Phase 12: telemetry on the served runs.  Phase 3's traffic (8
    slots, chip offsets of std 4, VAD on) and phase 9's faulted,
    canary-monitored run (stuck columns and trim flips, canaries every 8
    ticks, 9 slots) on the kernel route, with telemetry off and fully on
    (``ObsConfig(recorder=4096, audit="raise", trace=True)``): events,
    every state leaf and the health stats identical; the auditor's fused
    calls (in its regions and outside them) equal to K1's launches, tick
    by tick and in all; the recorder's ``tick`` events summing to the
    server's own decisions, gated hops, replays and init waves; the trace
    dump valid JSON.  Then wall decisions/s of phase 3's traffic off and
    on in ``OBS_PAIRS`` alternating pairs, with their spread."""
    import numpy as np
    from repro_torch.core import jaxrand
    from repro_torch.kernels.imc_mav import ops
    from repro_torch.models import kws
    from repro_torch.obs import ObsConfig
    from repro_torch.serving import (FaultConfig, HealthConfig,
                                     StreamServer, VADConfig)

    t_phase = time.perf_counter()
    cfg = kws.PAPER_KWS
    params = kws.init_params(jaxrand.PRNGKey(0, device="cpu"), cfg,
                             device=dev)
    hw = kws.fold_params(params, kws.init_state(cfg, device=dev), cfg,
                         pack=True)
    gen = torch.Generator().manual_seed(0)
    chip = {name: 4.0 * torch.randn(cfg.channels[i], generator=gen)
            for i, name in enumerate(cfg.imc_layer_names(), start=1)}
    streams = _traffic(cfg)
    full = ObsConfig(recorder=4096, audit="raise", trace=True)

    def faulty(srv):
        srv.faults.inject_stuck("conv3", [2, 7])
        srv.faults.inject_stuck("conv2", [0, 5], value=1)
        srv.faults.inject_bit_flips(n=6)

    configs = {
        "served": dict(slots=SLOTS, chip_offsets=chip, vad=VADConfig()),
        "faulted": dict(slots=SLOTS + 1, chip_offsets=_noisy_chip(torch,
                                                                  cfg),
                        vad=VADConfig(), faults=FaultConfig(seed=3),
                        health=HealthConfig(interval=REL_INTERVAL)),
    }

    def run(name, obs):
        srv = StreamServer(hw, cfg, hop=HOP, use_kernel=True, device=dev,
                           obs=obs, **configs[name])
        if srv.faults is not None:
            faulty(srv)
        for s, x in enumerate(streams):
            srv.submit(f"s{s}", x)
            srv.finish(f"s{s}")
        torch.cuda.synchronize()
        ops.COUNTS.reset()                  # the path's run starts
        per_tick, events = [], []
        t0 = time.perf_counter()
        def buffers():
            return (len(srv._queue),
                    [None if r is None else len(r.buf) for r in srv._slots])

        while True:                         # drain(), tick by tick
            n0, before = ops.COUNTS.launches, buffers()
            events.extend(srv.step())
            per_tick.append(ops.COUNTS.launches - n0)
            if buffers() == before:
                break
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st_ = srv._state
        return dict(srv=srv, events=events, wall=wall, per_tick=per_tick,
                    launches=ops.COUNTS.launches, stats=srv.stats(),
                    leaves=[st_.audio_carry, *st_.carries, st_.ring,
                            st_.hop, st_.key, *srv._dstate, *srv._vstate])

    out = {}
    for name in configs:
        run(name, full)                     # warm-up
        off, on = run(name, ObsConfig()), run(name, full)
        if on["events"] != off["events"] or not on["events"]:
            raise AssertionError(f"{name}: events differ with telemetry on")
        for a, b in zip(on["leaves"], off["leaves"]):
            if not torch.equal(a, b):
                raise AssertionError(f"{name}: state differs with "
                                     f"telemetry on")
        if on["launches"] != off["launches"]:
            raise AssertionError(f"{name}: K1 launches differ with "
                                 f"telemetry on")
        srv, st = on["srv"], on["stats"]
        if "health" in st and st["health"] != off["stats"]["health"]:
            raise AssertionError(f"{name}: health differs with telemetry on")
        aud = srv.auditor.stats()
        hist = srv.auditor.history()
        if (aud["violations"]
                or aud["traced_launches"] + aud["outside_regions"]
                != on["launches"]
                or [h["k1_calls"] for h in hist] != on["per_tick"]
                or on["launches"] != 5 * st["imc_passes"]):
            raise AssertionError(
                f"{name}: the auditor's count {aud} does not equal K1's "
                f"{on['launches']} launches ({st['imc_passes']} IMC passes)")
        ticks = srv.recorder.events("tick")
        calls = st["batched_calls"]
        sums = {k: sum(e[k] for e in ticks)
                for k in ("decisions", "gated", "replays", "computed")}
        if (sums["decisions"] != st["decisions"]
                or sums["gated"] != st["gated_hops"]
                or sums["replays"] != calls["replay"]
                or sum(1 for e in ticks if e["init"]) != calls["init"]
                or srv.recorder.dropped()):
            raise AssertionError(f"{name}: tick events {sums} do not match "
                                 f"the server's counts {st}")
        path = os.path.join(ROOT, "build", f"phase12_{name}_trace.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        n_spans = srv.trace.dump(path)
        with open(path) as f:
            doc = json.load(f)
        if len(doc["traceEvents"]) != n_spans + 1:
            raise AssertionError(f"{name}: trace dump holds "
                                 f"{len(doc['traceEvents'])} events")
        kinds = {}
        for e in srv.recorder.events():
            kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
        log(f"[obs] {name}: telemetry on == off ({len(on['events'])} "
            f"events, every state leaf); auditor (raise) calls "
            f"{aud['calls']}, fused calls in regions "
            f"{aud['traced_launches']} + outside {aud['outside_regions']} "
            f"= K1 launches {on['launches']} (= 5 x {st['imc_passes']}), "
            f"0 violations; recorder {kinds}; tick events sum to the "
            f"server's decisions {sums['decisions']}, gated hops "
            f"{sums['gated']}; trace {n_spans} spans, valid JSON")
        out[name] = dict(events=len(on["events"]), launches=on["launches"],
                         audit=aud, recorder=kinds, spans=n_spans)
    dps = {False: [], True: []}
    for _ in range(OBS_PAIRS):
        for obs_on in (False, True):
            r = run("served", full if obs_on else ObsConfig())
            dps[obs_on].append(r["stats"]["decisions"] / r["wall"])
    spread = {k: max(v) / min(v) for k, v in dps.items()}
    ratio = statistics.median(dps[True]) / statistics.median(dps[False])
    log(f"[obs] wall decisions/s of phase 3's traffic in turns off / on: "
        f"off {[round(v, 1) for v in dps[False]]}, on "
        f"{[round(v, 1) for v in dps[True]]}; spread (max / min) off "
        f"{spread[False]:.3f}, on {spread[True]:.3f}; median on / off "
        f"{ratio:.3f}")
    out.update(wall_dps_off=dps[False], wall_dps_on=dps[True],
               spread=spread, median_ratio=ratio,
               launches=out["served"]["launches"],
               seconds=time.perf_counter() - t_phase)
    log(f"[obs] phase 12 took {out['seconds']:.1f} s")
    return out


SNAP_CUT, SNAP_AFTER, SNAP_CPU = 10, 12, 3   # (a), (b): the cut, the ticks
SNAP_REPS = 5                     # (d): walls per median
SNAP_SESSIONS = 4                 # (c): concurrent enrollment sessions


def _leaves_of(srv):
    """A server's state, decision and VAD leaves, as host copies."""
    out = []
    for tree in (srv._state, srv._dstate, srv._vstate):
        for a in tree:
            out.extend(a if isinstance(a, tuple) else (a,))
    return [t.detach().cpu().clone() for t in out]


def _same_leaves(torch, a, b):
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def _same_events_scored(a, b, atol=1e-6):
    """Events equal field for field, ``score`` within ``atol`` (the stated
    tolerance between the card's softmax sums and the CPU's)."""
    strip = lambda evs: [{k: v for k, v in e.items() if k != "score"}
                         for e in evs]
    return strip(a) == strip(b) and all(
        abs(x["score"] - y["score"]) <= atol for x, y in zip(a, b))


def phase_snapshot(torch, dev):
    """Phase 13: crash-safe snapshots on the card, at full width
    (``PAPER_KWS``, hop 1024, VAD on).

    (a) phase 9's faulted, canary-monitored run on a noisy chip (offsets
        of std 4, SA noise 1.0, a drift walk and trim-bit flips, health
        every 8 ticks, 8 slots, 7 live streams of phase 3's traffic):
        ``snapshot(path)`` under ``build/`` at tick ``SNAP_CUT``, then
        ``SNAP_AFTER`` more ticks; a fresh card server restored from the
        file plays the same ticks: events, every state leaf,
        ``health.stats()`` and ``faults.stats()`` equal, and K1's
        launches equal but for 10 per canary expectation the restored
        monitor recomputes (it is not in the snapshot);
    (b) the same file restored into a ``device="cpu"`` server plays
        ``SNAP_CPU`` ticks: the card's events (``score`` within 1e-6) and
        carries, rings, decision and VAD state, bit for bit;
    (c) ``SNAP_SESSIONS`` concurrent enrollment sessions (phase 4's
        shapes: 10 utterances each, compensation on, 200 epochs on the
        fused route) beside two live streams, snapshotted in memory
        mid-calibration and mid-training: each restore into a fresh card
        server reaches every session's ``CustomizationResult`` bit for
        bit, with ``head_train_rows`` launched once per remaining
        training tick;
    (d) at 8 live slots, the snapshot's bytes on disk and the median of
        ``SNAP_REPS`` walls of ``snapshot(path)`` and of ``restore(path)``
        (numbers to read, not gates)."""
    import numpy as np
    from repro_torch.core import jaxrand
    from repro_torch.core.onchip_training import OnChipTrainConfig
    from repro_torch.data import audio
    from repro_torch.kernels.imc_mav import ops
    from repro_torch.kernels.sga_update import ops as sga_ops
    from repro_torch.models import kws
    from repro_torch.serving import (CustomizeConfig, FaultConfig,
                                     HealthConfig, StreamServer, VADConfig)

    t_phase = time.perf_counter()
    cfg = kws.PAPER_KWS
    params = kws.init_params(jaxrand.PRNGKey(0, device="cpu"), cfg,
                             device=dev)
    hw = kws.fold_params(params, kws.init_state(cfg, device=dev), cfg,
                         pack=True)
    hw_cpu = _to(hw, "cpu")
    chip = _noisy_chip(torch, cfg)
    streams = _traffic(cfg)[:SLOTS - 1]       # the eighth slot: canaries
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    out = {}

    # -- (a), (b) ------------------------------------------------------------
    def monitored(hw_d, device):
        srv = StreamServer(hw_d, cfg, hop=HOP, slots=SLOTS, device=device,
                           chip_offsets=chip, sa_noise_std=SA_STD,
                           vad=VADConfig(),
                           faults=FaultConfig(drift_std=0.2, seed=3),
                           health=HealthConfig(interval=REL_INTERVAL))
        return srv

    def count_expectations(mon):
        """Count the monitor's computations of the expected canary state
        (two B = 1 forwards, 10 K1 launches each time)."""
        mon.expectations = 0
        inner = mon._ensure_expected

        def counted():
            mon.expectations += mon._expected is None
            inner()
        mon._ensure_expected = counted

    def play(srv, n, leaves_at=None):
        events, per_tick, leaves = [], [], None
        for t in range(n):
            n0 = ops.COUNTS.launches
            events.append(srv.step())
            per_tick.append(ops.COUNTS.launches - n0)
            if leaves_at == t + 1:
                leaves = _leaves_of(srv)
        torch.cuda.synchronize()
        return events, per_tick, leaves

    srv = monitored(hw, dev)
    for s, x in enumerate(streams):
        srv.submit(f"s{s}", x)
        srv.finish(f"s{s}")
    srv.faults.inject_bit_flips(n=6)
    ops.COUNTS.reset()                      # the path's run starts
    play(srv, SNAP_CUT)
    path = os.path.join(build, "phase13_server.npz")
    srv.snapshot(path)
    passes0 = srv._imc_passes
    count_expectations(srv.health)
    ops.COUNTS.reset()
    ev1, ticks1, leaves3 = play(srv, SNAP_AFTER, leaves_at=SNAP_CPU)
    n1 = ops.COUNTS.launches
    srv2 = monitored(hw, dev)
    srv2.restore(path)
    count_expectations(srv2.health)
    ops.COUNTS.reset()
    ev2, ticks2, _ = play(srv2, SNAP_AFTER)
    n2 = ops.COUNTS.launches                # ... and ends: read the count
    # the expectation is not in the snapshot: the restored monitor makes
    # at most one computation more than the uninterrupted one
    recomputed = srv2.health.expectations - srv.health.expectations
    if ev1 != ev2 or not any(ev1):
        raise AssertionError("snapshot: the restored card server's events "
                             "differ from the uninterrupted one's")
    if not _same_leaves(torch, _leaves_of(srv), _leaves_of(srv2)):
        raise AssertionError("snapshot: a state leaf differs after restore")
    if (srv.health.stats() != srv2.health.stats()
            or srv.faults.stats() != srv2.faults.stats()):
        raise AssertionError("snapshot: health or fault state differs "
                             "after restore")
    if (n1 != 5 * (srv._imc_passes - passes0)
            or n2 != 5 * (srv2._imc_passes - passes0)
            or n2 != n1 + 10 * recomputed or recomputed not in (0, 1)):
        raise AssertionError(f"snapshot: K1 launched {n2} times after the "
                             f"restore and {n1} without it ({recomputed} "
                             f"recomputed canary expectations)")
    size = os.path.getsize(path)
    log(f"[snapshot] (a) faulted, monitored, noisy run cut at tick "
        f"{SNAP_CUT} ({size} bytes under build/): the restored card server "
        f"plays the next {SNAP_AFTER} ticks as the uninterrupted one "
        f"({sum(map(len, ev1))} events, every state leaf, health "
        f"{srv2.health.state}, {srv2.health.stats()['canaries']} canaries, "
        f"faults drift_rms {srv2.faults.stats()['drift_rms']}); K1 "
        f"launches {n2} after the restore, {n1} without it "
        f"(+10 x {recomputed} recomputed canary expectation); per tick "
        f"{ticks2} vs {ticks1}")
    srv_c = StreamServer(hw_cpu, cfg, hop=HOP, slots=SLOTS, device="cpu",
                         chip_offsets=chip, sa_noise_std=SA_STD,
                         vad=VADConfig(),
                         faults=FaultConfig(drift_std=0.2, seed=3),
                         health=HealthConfig(interval=REL_INTERVAL))
    srv_c.restore(path)
    t0 = time.perf_counter()
    ev_c, _, _ = play(srv_c, SNAP_CPU)
    cpu_s = time.perf_counter() - t0
    # the leaves: the stream state, then the decision state's five, then
    # the VAD state's four
    cpu_leaves = _leaves_of(srv_c)
    if not (_same_events_scored(sum(ev1[:SNAP_CPU], []), sum(ev_c, []))
            and _same_leaves(torch, leaves3[:-9], cpu_leaves[:-9])):
        raise AssertionError("snapshot: the CPU server restored from the "
                             "card's file differs from the card")
    # the posteriors within the score's tolerance, the rest exact
    if not all(torch.equal(a, b) if a.dtype != torch.float32
               else bool((a - b).abs().max() <= 1e-6)
               for a, b in zip(leaves3[-9:-4], cpu_leaves[-9:-4])) \
            or not _same_leaves(torch, leaves3[-4:], cpu_leaves[-4:]):
        raise AssertionError("snapshot: decision or VAD state differs on "
                             "the CPU")
    log(f"[snapshot] (b) the card's file restored into a CPU server: "
        f"{SNAP_CPU} ticks ({cpu_s:.2f} s) with the card's events (score "
        f"within 1e-6), carries, rings and VAD state bit for bit")
    out.update(bytes=size, launches_after=n2, launches_uninterrupted=n1,
               recomputed_expectations=recomputed,
               events=sum(map(len, ev1)))

    # -- (c) four sessions mid-flight ----------------------------------------
    gen = torch.Generator().manual_seed(0)
    chip4 = {name: 4.0 * torch.randn(cfg.channels[i], generator=gen)
             for i, name in enumerate(cfg.imc_layer_names(), start=1)}
    live, _, _, _ = _session_audio(cfg)
    enroll, labels = audio.make_dataset(seed=7, n_per_class=4, n_speakers=2,
                                        accent_shift=0.3, augment=False,
                                        length=cfg.sample_len)
    tcfg = OnChipTrainConfig(epochs=EPOCHS, fixed_error_scale=1.375)

    def session_server():
        return StreamServer(hw, cfg, hop=HOP, slots=SLOTS,
                            chip_offsets=chip4, vad=VADConfig(), device=dev)

    def feed(srv, tick):
        for s in range(2):
            a = cfg.sample_len + tick * HOP
            if a < len(live[s]):
                srv.submit(f"live{s}", live[s][a:a + HOP])

    def finish(srv, tick, cuts=None):
        sessions = srv._cust.sessions
        heads, events = [], []
        while not all(s.done for s in sessions):
            if tick > 2000:
                raise AssertionError(f"sessions stuck: "
                                     f"{[s.phase for s in sessions]}")
            feed(srv, tick)
            h0 = sga_ops.COUNTS_HEAD.launches
            events.extend(srv.step())
            heads.append(sga_ops.COUNTS_HEAD.launches - h0)
            tick += 1
            if cuts is not None:
                p = sessions[0]
                if "calibrating" not in cuts and p.phase == "calibrating" \
                        and p._calib_idx > 0:
                    cuts["calibrating"] = (tick, srv.snapshot(), len(heads))
                if "training" not in cuts and p.phase == "training" \
                        and p._epoch > 0:
                    cuts["training"] = (tick, srv.snapshot(), len(heads))
        torch.cuda.synchronize()
        return [s.result for s in sessions], heads, events

    srv = session_server()
    for s in range(2):
        srv.submit(f"live{s}", live[s][:cfg.sample_len])
    for k in range(SNAP_SESSIONS):
        sess = srv.customize(f"user{k}", CustomizeConfig(
            train=tcfg, epochs_per_tick=PER_TICK[0], calib_seed=k,
            calib_sa_noise_std=0.0))
        for j in range(N_UTTS):
            sess.enroll(int(labels[k * N_UTTS + j]),
                        enroll[k * N_UTTS + j])
        sess.finish_enrollment()
    cuts = {}
    sga_ops.COUNTS_HEAD.reset()
    t0 = time.perf_counter()
    want, heads, _ = finish(srv, 0, cuts)
    wall = time.perf_counter() - t0
    if sum(heads) != sum(1 for h in heads if h) or not sum(heads) or \
            sorted(cuts) != ["calibrating", "training"]:
        raise AssertionError(f"sessions: head_train_rows launches {heads}, "
                             f"cuts {sorted(cuts)}")

    def same(r1, r2):
        return (np.array_equal(r1.fc_w, r2.fc_w)
                and np.array_equal(r1.fc_b, r2.fc_b)
                and r1.history == r2.history
                and all(np.array_equal(r1.bias[n], r2.bias[n])
                        for n in cfg.imc_layer_names()))

    restored = {}
    for name, (tick, snap, done) in sorted(cuts.items()):
        srv_r = session_server()
        srv_r.restore(snap)
        sga_ops.COUNTS_HEAD.reset()
        got, heads_r, _ = finish(srv_r, tick)
        if not all(same(a, b) for a, b in zip(want, got)):
            raise AssertionError(f"sessions restored {name}: a result "
                                 f"differs from the uninterrupted run")
        if sum(heads_r) != sum(heads[done:]):
            raise AssertionError(f"sessions restored {name}: "
                                 f"head_train_rows launched {sum(heads_r)} "
                                 f"times for {sum(heads[done:])} remaining "
                                 f"training ticks")
        restored[name] = dict(tick=tick, launches_head=sum(heads_r))
    log(f"[snapshot] (c) {SNAP_SESSIONS} concurrent sessions (10 "
        f"utterances, compensation, {EPOCHS} epochs, fused route): "
        f"uninterrupted {len(heads)} ticks, {wall:.2f} s, head_train_rows "
        f"{sum(heads)} launches; restored mid-calibration (tick "
        f"{restored['calibrating']['tick']}) and mid-training (tick "
        f"{restored['training']['tick']}): every result bit-identical, "
        f"head_train_rows {restored['calibrating']['launches_head']} and "
        f"{restored['training']['launches_head']} launches (= the "
        f"remaining training ticks)")
    out.update(sessions=SNAP_SESSIONS, launches_head=sum(heads),
               restored=restored)

    # -- (d) bytes and walls at 8 live slots ---------------------------------
    def served():
        return StreamServer(hw, cfg, hop=HOP, slots=SLOTS, device=dev,
                            chip_offsets=chip, sa_noise_std=SA_STD,
                            vad=VADConfig())

    srv = served()
    for s, x in enumerate(_traffic(cfg)):
        srv.submit(f"s{s}", x)
    for _ in range(SNAP_CUT):
        srv.step()
    if len(srv.active_streams()) != SLOTS:
        raise AssertionError("snapshot (d): not 8 live slots")
    path = os.path.join(build, "phase13_8slots.npz")
    snap_ms, rest_ms = [], []
    for _ in range(SNAP_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.snapshot(path)
        snap_ms.append((time.perf_counter() - t0) * 1e3)
        fresh = served()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh.restore(path)
        torch.cuda.synchronize()
        rest_ms.append((time.perf_counter() - t0) * 1e3)
    size8 = os.path.getsize(path)
    log(f"[snapshot] (d) 8 live slots: {size8} bytes on disk; "
        f"snapshot(path) median {statistics.median(snap_ms):.2f} ms "
        f"{[round(v, 2) for v in snap_ms]}, restore(path) median "
        f"{statistics.median(rest_ms):.2f} ms "
        f"{[round(v, 2) for v in rest_ms]}")
    out.update(bytes_8_slots=size8, snapshot_ms=snap_ms, restore_ms=rest_ms,
               snapshot_ms_median=statistics.median(snap_ms),
               restore_ms_median=statistics.median(rest_ms),
               seconds=time.perf_counter() - t_phase)
    log(f"[snapshot] phase 13 took {out['seconds']:.1f} s")
    return out


SHARD_POOLS, SHARD_SLOTS, SHARD_RUNS = 2, 4, 3


def phase_sharded(torch, dev):
    """Phase 14: the sharded fleet on the card, at full width.

    (a) phase 3's traffic through ``ShardedStreamServer(devices=2,
        slots=4)`` (two pools on the one card) and through one 8-slot
        server, noise-free and with SA noise 1.0 and chip offsets: each
        stream's decision events bitwise equal, the placement balanced
        (4 and 4), K1 launched 5 x each pool's IMC forwards (once per
        layer per pool and batched call), with the launches per tick;
    (b) the same with ``parallel=True`` (a thread per pool) and
        ``ObsConfig(audit="raise")``: the sequential fleet's events and
        launches, no violation;
    (c) the fleet snapshotted mid-run under ``build/``, restored into a
        fresh fleet and drained: the uninterrupted fleet's events;
    (d) wall decisions/s of the sequential fleet, the parallel fleet and
        the single server in ``SHARD_RUNS`` alternating runs, with their
        spread (a finding, not a claim)."""
    from repro_torch.core import jaxrand
    from repro_torch.kernels.imc_mav import ops
    from repro_torch.models import kws
    from repro_torch.obs import ObsConfig
    from repro_torch.serving import (ShardedStreamServer, StreamServer,
                                     VADConfig)

    t_phase = time.perf_counter()
    cfg = kws.PAPER_KWS
    params = kws.init_params(jaxrand.PRNGKey(0, device="cpu"), cfg,
                             device=dev)
    hw = kws.fold_params(params, kws.init_state(cfg, device=dev), cfg,
                         pack=True)
    streams = _traffic(cfg)
    modes = {"clean": dict(vad=VADConfig()),
             "noisy": dict(vad=VADConfig(), sa_noise_std=SA_STD,
                           chip_offsets=_noisy_chip(torch, cfg))}

    def make(kind, mode, **kw):
        if kind == "single":
            return StreamServer(hw, cfg, hop=HOP, slots=SLOTS, device=dev,
                                **modes[mode], **kw)
        return ShardedStreamServer(hw, cfg, hop=HOP, devices=SHARD_POOLS,
                                   slots=SHARD_SLOTS,
                                   parallel=kind == "parallel",
                                   **modes[mode], **kw)

    def passes(srv):
        pools = getattr(srv, "pools", [srv])
        return sum(p._imc_passes for p in pools)

    def run(kind, mode, cut=None, **kw):
        srv = make(kind, mode, **kw)
        for s, x in enumerate(streams):
            srv.submit(f"s{s}", x)
            srv.finish(f"s{s}")
        torch.cuda.synchronize()
        ops.COUNTS.reset()                  # the path's run starts
        events, per_tick, snap = [], [], None
        t0 = time.perf_counter()
        while srv.active_streams():
            if cut is not None and len(per_tick) == cut:
                snap = srv.snapshot(os.path.join(ROOT, "build",
                                                 "phase14_fleet.npz"))
                n_cut = len(events)
            n0 = ops.COUNTS.launches
            events.extend(srv.step())
            per_tick.append(ops.COUNTS.launches - n0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = ops.COUNTS.launches             # ... and ends: read the count
        if getattr(srv, "close", None):
            srv.close()
        if n != 5 * passes(srv):
            raise AssertionError(f"sharded {kind}/{mode}: K1 launched {n} "
                                 f"times for {passes(srv)} IMC forwards")
        out = dict(srv=srv, events=events, per_tick=per_tick, launches=n,
                   wall=wall)
        if snap is not None:
            out.update(snap=snap, n_cut=n_cut, cut_tick=cut)
        return out

    def per_stream(events):
        out = {}
        for e in events:
            e = {k: v for k, v in e.items() if k != "device"}
            out.setdefault(e.pop("stream"), []).append(e)
        return out

    res = {}
    for mode in modes:
        one = run("single", mode)
        seq = run("sequential", mode, cut=SNAP_CUT)
        par = run("parallel", mode, obs=ObsConfig(audit="raise"))
        sh = seq["srv"]
        if per_stream(seq["events"]) != per_stream(one["events"]) \
                or not one["events"]:
            raise AssertionError(f"sharded {mode}: a stream's events differ "
                                 f"from the single server's")
        places = [sum(1 for s in range(len(streams))
                      if sh.where(f"s{s}") == d) for d in range(SHARD_POOLS)]
        if places != [len(streams) // SHARD_POOLS] * SHARD_POOLS:
            raise AssertionError(f"sharded {mode}: placement {places}")
        if par["events"] != seq["events"] or \
                par["launches"] != seq["launches"]:
            raise AssertionError(f"sharded {mode}: the parallel fleet "
                                 f"differs from the sequential one")
        aud = par["srv"].stats()["audit"]
        if aud["violations"]:
            raise AssertionError(f"sharded {mode}: audit {aud}")
        fleet = make("sequential", mode)
        fleet.restore(seq["snap"])
        tail = fleet.drain()
        if tail != seq["events"][seq["n_cut"]:] or not tail:
            raise AssertionError(f"sharded {mode}: the restored fleet's "
                                 f"events differ from the uninterrupted "
                                 f"fleet's")
        log(f"[sharded] {mode}: pools on {[str(d) for d in sh.devices]}, "
            f"placement {places}; {len(seq['events'])} events, each "
            f"stream's equal to one {SLOTS}-slot server's; K1 launches "
            f"fleet {seq['launches']} (= 5 x {passes(sh)} IMC forwards), "
            f"single server {one['launches']}; per tick fleet "
            f"{seq['per_tick']}, single {one['per_tick']}; parallel=True "
            f"under the raising auditor: the same events and launches, "
            f"{aud['violations']} violations; restored from "
            f"build/phase14_fleet.npz at tick {SNAP_CUT}: the remaining "
            f"{len(tail)} events equal")
        res[mode] = dict(launches=seq["launches"],
                         launches_single=one["launches"], placement=places,
                         events=len(seq["events"]))
    dps = {k: [] for k in ("sequential", "parallel", "single")}
    for _ in range(SHARD_RUNS):
        for kind in dps:
            r = run(kind, "clean")
            dps[kind].append(len(r["events"]) / r["wall"])
    spread = {k: max(v) / min(v) for k, v in dps.items()}
    log(f"[sharded] (d) wall decisions/s in alternating runs: "
        + "; ".join(f"{k} {[round(x, 1) for x in v]} (spread "
                    f"{spread[k]:.3f})" for k, v in dps.items()))
    out = dict(modes=res, wall_dps=dps, spread=spread,
               launches=res["clean"]["launches"],
               seconds=time.perf_counter() - t_phase)
    log(f"[sharded] phase 14 took {out['seconds']:.1f} s")
    return out


COMPILED_BLOCK = 8                # phase 15: ticks per compiled block
COMPILED_PAIRS = 3                # (a), (b): interpreted / compiled pairs
COMPILED_INJECT = 6               # (c): the tick of the fault injection
# counters a block keeps apart from the interpreted tick: the wall time,
# its own block and tick counts, and the IMC forwards (one per timeline
# step that computes, where the interpreted tick counts one per call)
COMPILED_EXCLUDES = ("serving.hop_wall_s", "serving.compiled",
                     "serving.imc_passes")


def phase_compiled(torch, dev):
    """Phase 15: compiled ticks on the card, at full width (``PAPER_KWS``,
    hop 1024, 8 slots, VAD on, ``CompiledTickConfig(block=8)``): each run
    once on a compiled server (``step_block`` until no stream is left; on
    the card every block step is a CUDA graph replay with K1 inside) and
    once on an interpreted one, the two equal on events, every stream,
    decision and VAD state leaf, per-stream stats and every registry cell
    but the wall time, ``serving.compiled`` and ``serving.imc_passes``,
    K1 launched 5 x ``imc_passes`` on both and most ticks served by
    blocks:

    (a) phase 3's traffic on a clean chip, profiled from the first block
        of replays (both graphs captured) to the end, and the interpreted
        run from the same tick: K1's kernel records equal to ``COUNTS``
        and to 5 x the IMC forwards there, and the device busy share;
    (b) the noisy chip (SA noise 1.0, offsets from
        ``sample_chip_offsets(PRNGKey(0))``);
    (c) a fault drift (``FaultConfig(drift_std=0.5)``) whose chip delta
        changes at every tick, so inside every block, and stuck columns
        injected at tick ``COMPILED_INJECT``;
    (d) two streams carrying installed customization riders (bias deltas
        and heads of their own) on the offset chip;
    (e) phase 14's fleet (2 pools x 4 slots on the card) with
        ``compiled=``, in blocks, sequential and ``parallel=True`` under
        the raising launch auditor: each stream's events equal one
        interpreted server's, no violation, K1 = 5 x the pools' IMC
        forwards.

    Reported: the capture wall per graph, the host ms per tick, the
    device busy share, wall decisions/s of compiled against interpreted
    in ``COMPILED_PAIRS`` alternating pairs for (a) and (b) (with and
    without the capture walls), and the compiled fleets against one
    compiled server."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import jaxrand
    from repro_torch.kernels.imc_mav import ops
    from repro_torch.models import kws
    from repro_torch.obs import ObsConfig
    from repro_torch.serving import (CompiledTickConfig, CustomizationResult,
                                     FaultConfig, ShardedStreamServer,
                                     StreamServer, VADConfig)

    t_phase = time.perf_counter()
    cfg = kws.PAPER_KWS
    params = kws.init_params(jaxrand.PRNGKey(0, device="cpu"), cfg,
                             device=dev)
    hw = kws.fold_params(params, kws.init_state(cfg, device=dev), cfg,
                         pack=True)
    streams = _traffic(cfg)
    chip = _noisy_chip(torch, cfg)
    ccfg = CompiledTickConfig(block=COMPILED_BLOCK)
    hwp, _ = kws.as_hw_params(hw)
    rng = np.random.default_rng(15)
    results = [CustomizationResult(
        bias={n: hwp.bias[n].cpu().numpy()
              + 2.0 * rng.integers(-2, 3, hwp.bias[n].shape)
              for n in cfg.imc_layer_names()},
        fc_w=hwp.fc_w.cpu().numpy(),
        fc_b=hwp.fc_b.cpu().numpy()
        + rng.integers(-8, 9, hwp.fc_b.shape) / 128.0,
        epochs=1, n_utterances=1, history=[], energy={}) for _ in range(2)]

    def stuck(srv):
        srv.faults.inject_stuck("conv3", [2, 7])

    cases = {
        "clean": dict(kw=dict(vad=VADConfig())),
        "noisy": dict(kw=dict(vad=VADConfig(), sa_noise_std=SA_STD,
                              chip_offsets=chip)),
        "drift": dict(kw=dict(vad=VADConfig(), chip_offsets=chip,
                              faults=FaultConfig(drift_std=0.5, seed=3)),
                      inject=stuck),
        "riders": dict(kw=dict(vad=VADConfig(), chip_offsets=chip),
                       custom=results),
    }

    def cells(srv):
        return {k: ((v.count, v.total, v.min, v.max)
                    if hasattr(v, "count") else v)
                for k, v in srv._metrics._cells.items()
                if k[0] not in COMPILED_EXCLUDES}

    def graphs_ready(srv):
        """Both graphs captured and a block due: a block of replays."""
        steps = list(srv._compiled._steps.values())
        return (len(steps) == 1 and len(steps[0].graphs) == 2
                and srv._compiled.horizon(COMPILED_BLOCK) > 0)

    def run(case, compiled, window=None):
        """One run of ``case``.  ``window``: profile from the first block
        of replays (compiled) or from tick ``window`` (interpreted) to the
        run's end."""
        c = cases[case]
        srv = StreamServer(hw, cfg, hop=HOP, slots=SLOTS, device=dev,
                           seed=0, compiled=ccfg if compiled else None,
                           **c["kw"])
        for s, res in enumerate(c.get("custom") or ()):
            srv.install_custom(f"s{s}", res)
        for s, x in enumerate(streams):
            srv.submit(f"s{s}", x)
            srv.finish(f"s{s}")
        torch.cuda.synchronize()
        prof = ctx = None
        ops.COUNTS.reset()                  # the path's run starts
        t0 = time.perf_counter()
        events = []
        while srv.active_streams():
            inject = c.get("inject")
            if inject and srv._steps == COMPILED_INJECT:
                inject(srv)
            if window is not None and ctx is None and (
                    graphs_ready(srv) if compiled
                    else srv._steps >= window):
                torch.cuda.synchronize()
                ctx = profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA])
                prof = ctx.__enter__()
                w0, n_w0 = time.perf_counter(), ops.COUNTS.launches
                tick_w0, p_w0 = srv._steps, srv._imc_passes
                continue
            if compiled and inject and srv._steps < COMPILED_INJECT:
                events.extend(srv.step_block(COMPILED_INJECT - srv._steps))
            else:
                events.extend(srv.step_block() if compiled
                              else srv.step())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if ctx is not None:
            ctx.__exit__(None, None, None)
            prof = dict(prof=prof, wall=time.perf_counter() - w0,
                        launches=ops.COUNTS.launches - n_w0, tick=tick_w0,
                        ticks=srv._steps - tick_w0,
                        passes=srv._imc_passes - p_w0)
        if window is not None and ctx is None:
            raise AssertionError(f"compiled {case}: no steady window")
        n = ops.COUNTS.launches             # ... and ends: read the count
        st = srv.stats()
        if n != 5 * st["imc_passes"]:
            raise AssertionError(f"compiled {case}: K1 launched {n} times "
                                 f"for {st['imc_passes']} IMC forwards "
                                 f"(compiled={compiled})")
        capture = ({f"{kind} {list(key)}": s_
                    for key, steps in srv._compiled._steps.items()
                    for kind, s_ in steps.capture_s.items()}
                   if compiled else {})
        return dict(srv=srv, events=events, launches=n, wall=wall, st=st,
                    leaves=_leaves_of(srv), cells=cells(srv),
                    prof=prof, capture=capture,
                    per_stream={sid: {k: v for k, v in p.items()
                                      if k != "wall_s"}
                                for sid, p in st["per_stream"].items()})

    def same(a, b, what):
        if a["events"] != b["events"] or not a["events"]:
            raise AssertionError(f"compiled {what}: events differ")
        if not _same_leaves(torch, a["leaves"], b["leaves"]):
            raise AssertionError(f"compiled {what}: state differs")
        if a["cells"] != b["cells"]:
            diff = {k: (a["cells"].get(k), b["cells"].get(k))
                    for k in set(a["cells"]) | set(b["cells"])
                    if a["cells"].get(k) != b["cells"].get(k)}
            raise AssertionError(f"compiled {what}: counters differ {diff}")
        if a["per_stream"] != b["per_stream"]:
            raise AssertionError(f"compiled {what}: per-stream stats differ")

    out = {"cases": {}}
    run("clean", True), run("clean", False)      # warm-up: first uses
    for case in cases:
        cand = run(case, True)
        ref = run(case, False)
        same(cand, ref, case)
        st = cand["st"]
        ticks = st["compiled"]["ticks"]
        keys = list(cand["srv"]._compiled._steps)
        if (case == "drift" and not any(k[3] for k in keys)) or (
                case in ("drift", "riders") and not all(k[2] for k in keys)):
            raise AssertionError(f"compiled {case}: graphs of keys {keys} "
                                 f"(slots, mult, riders, per-step chip "
                                 f"delta, gated)")
        if ticks * 2 <= st["steps"]:
            raise AssertionError(f"compiled {case}: blocks served {ticks} "
                                 f"of {st['steps']} ticks")
        row = dict(events=len(cand["events"]), steps=st["steps"],
                   compiled=st["compiled"], launches=cand["launches"],
                   launches_interpreted=ref["launches"],
                   imc_passes=st["imc_passes"],
                   imc_passes_interpreted=ref["st"]["imc_passes"],
                   capture_ms={k: v * 1e3
                               for k, v in cand["capture"].items()},
                   host_ms_per_tick=cand["wall"] / st["steps"] * 1e3,
                   host_ms_per_tick_interpreted=(ref["wall"] / st["steps"]
                                                 * 1e3))
        row["graph_keys"] = [list(k) for k in keys]
        log(f"[compiled] ({case}) {row['events']} events in {row['steps']} "
            f"ticks, {ticks} served by {st['compiled']['blocks']} blocks "
            f"(graph keys {keys}); "
            f"events, every state leaf, counters and per-stream stats equal "
            f"to the interpreted server's; K1 {cand['launches']} (= 5 x "
            f"{st['imc_passes']} IMC forwards), interpreted "
            f"{ref['launches']} (= 5 x {ref['st']['imc_passes']}); capture "
            f"wall " + ", ".join(f"{k} {v:.1f} ms"
                                 for k, v in row["capture_ms"].items())
            + f"; host ms per tick {row['host_ms_per_tick']:.3f} "
            f"(interpreted {row['host_ms_per_tick_interpreted']:.3f})")
        if case == "clean":
            # profiled apart: the profiler's own cost stays out of the
            # walls above
            pc = run(case, True, window=0)
            pi = run(case, False, window=pc["prof"]["tick"])
            busy = {}
            for name, r in (("compiled", pc), ("interpreted", pi)):
                w = r["prof"]
                busy_us, rows = device_time(torch, w["prof"])
                records = sum(cnt for k, (_, cnt) in rows.items()
                              if "imc_fused" in k)
                if not records == w["launches"] == 5 * w["passes"] \
                        or not w["passes"]:
                    raise AssertionError(
                        f"compiled {name} window: {records} K1 kernel "
                        f"records, COUNTS {w['launches']}, {w['passes']} "
                        f"IMC forwards")
                busy[name] = dict(busy_ms=busy_us / 1e3,
                                  wall_ms=w["wall"] * 1e3,
                                  share=busy_us / 1e6 / w["wall"],
                                  k1_records=records, passes=w["passes"],
                                  ticks=w["ticks"], from_tick=w["tick"])
            row["busy"] = out["busy"] = busy
            log(f"[compiled] (clean) profiled from the first block of "
                f"replays (tick {busy['compiled']['from_tick']}) to the "
                f"end: " + "; ".join(
                    f"{k}: wall {v['wall_ms']:.2f} ms for {v['ticks']} "
                    f"ticks, device busy {v['busy_ms']:.3f} ms (share "
                    f"{v['share']:.4f}), K1 kernel records "
                    f"{v['k1_records']} = COUNTS = 5 x {v['passes']} IMC "
                    f"forwards" for k, v in busy.items()))
        out["cases"][case] = row

    # decisions/s in alternating pairs, with and without the capture walls
    dps = {}
    for case in ("clean", "noisy"):
        d = {"interpreted": [], "compiled": [], "compiled_no_capture": []}
        for p in range(COMPILED_PAIRS):
            for compiled in ((False, True) if p % 2 == 0 else (True, False)):
                r = run(case, compiled)
                n_dec = r["st"]["decisions"]
                if compiled:
                    d["compiled"].append(n_dec / r["wall"])
                    d["compiled_no_capture"].append(
                        n_dec / (r["wall"] - sum(r["capture"].values())))
                else:
                    d["interpreted"].append(n_dec / r["wall"])
        d["spread"] = {k: max(v) / min(v) for k, v in d.items()}
        d["median_ratio"] = (statistics.median(d["compiled"])
                             / statistics.median(d["interpreted"]))
        dps[case] = d
        log(f"[compiled] ({case}) wall decisions/s in alternating pairs: "
            + "; ".join(f"{k} {[round(x, 1) for x in d[k]]} (spread "
                        f"{d['spread'][k]:.3f})"
                        for k in ("interpreted", "compiled",
                                  "compiled_no_capture"))
            + f"; median compiled / interpreted {d['median_ratio']:.3f}")
    out["wall_dps"] = dps

    # (e) the fleet in blocks
    kw = dict(vad=VADConfig(), seed=0)

    def fleet_run(kind):
        if kind in ("one", "one_compiled"):
            srv = StreamServer(hw, cfg, hop=HOP, slots=SLOTS, device=dev,
                               compiled=ccfg if kind == "one_compiled"
                               else None, **kw)
        else:
            srv = ShardedStreamServer(hw, cfg, hop=HOP, devices=SHARD_POOLS,
                                      slots=SHARD_SLOTS, compiled=ccfg,
                                      parallel=kind == "parallel",
                                      obs=ObsConfig(audit="raise"), **kw)
        for s, x in enumerate(streams):
            srv.submit(f"s{s}", x)
            srv.finish(f"s{s}")
        torch.cuda.synchronize()
        ops.COUNTS.reset()
        t0 = time.perf_counter()
        events = []
        while srv.active_streams():
            events.extend(srv.step_block())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n = ops.COUNTS.launches
        pools = getattr(srv, "pools", [srv])
        if getattr(srv, "close", None):
            srv.close()
        passes = sum(p._imc_passes for p in pools)
        if n != 5 * passes:
            raise AssertionError(f"compiled fleet {kind}: K1 {n} for "
                                 f"{passes} IMC forwards")
        return dict(srv=srv, events=events, wall=wall, launches=n,
                    pools=pools)

    def per_stream(events):
        res = {}
        for e in events:
            e = {k: v for k, v in e.items() if k != "device"}
            res.setdefault(e.pop("stream"), []).append(e)
        return res

    one = fleet_run("one")
    fleets = {k: fleet_run(k) for k in ("sequential", "parallel")}
    for kind, r in fleets.items():
        if per_stream(r["events"]) != per_stream(one["events"]):
            raise AssertionError(f"compiled fleet {kind}: a stream's events "
                                 f"differ from one server's")
        aud = r["srv"].stats()["audit"]
        if aud["violations"] or not all(p._compiled_ticks
                                        for p in r["pools"]):
            raise AssertionError(f"compiled fleet {kind}: audit {aud}")
    fdps = {k: [] for k in ("sequential", "parallel", "one_compiled")}
    for _ in range(COMPILED_PAIRS):
        for kind in fdps:
            r = fleet_run(kind)
            fdps[kind].append(len(r["events"]) / r["wall"])
    fspread = {k: max(v) / min(v) for k, v in fdps.items()}
    out["fleet"] = dict(
        launches={k: r["launches"] for k, r in fleets.items()},
        compiled_ticks={k: [p._compiled_ticks for p in r["pools"]]
                        for k, r in fleets.items()},
        wall_dps=fdps, spread=fspread)
    log(f"[compiled] (e) fleet of {SHARD_POOLS} compiled pools x "
        f"{SHARD_SLOTS} slots in blocks: each stream's events equal one "
        f"interpreted server's, sequential and parallel=True, raising "
        f"auditor clean; K1 {out['fleet']['launches']}; ticks in blocks "
        f"per pool {out['fleet']['compiled_ticks']}; wall decisions/s "
        + "; ".join(f"{k} {[round(x, 1) for x in v]} (spread "
                    f"{fspread[k]:.3f})" for k, v in fdps.items()))
    out["launches"] = out["cases"]["clean"]["launches"]
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[compiled] phase 15 took {out['seconds']:.1f} s")
    return out


# phase 16: the examples and the LM server
EXAMPLES = ("quickstart", "stream_kws", "customize_onchip")
LM_ARCHS = ("qwen2.5-14b", "starcoder2-15b", "internvl2-2b",
            "qwen3-moe-30b-a3b", "qwen2-moe-a2.7b", "zamba2-1.2b",
            "xlstm-125m")
LM_FULL = "qwen2.5-14b"
LM_MOE_FULL = "qwen3-moe-30b-a3b"
LM_RECURRENT_FULL = ("zamba2-1.2b", "xlstm-125m")         # (e)
ENCDEC = "seamless-m4t-medium"                             # (b), (f)
LM_REQUESTS, LM_MAX_NEW, LM_STEPS = 4, 8, 8
# (d): one full-width MoE layer against ``_moe_plain`` (float32, token by
# token).  The port rounds each expert's products, its SiLU chain and each
# of the k adds to bfloat16: 0.9-2.4 ulps of the largest output on the
# CPU at d 512 and 2048 with 128 experts top-8; the down projection of a
# neighbouring expert in place of the chosen one gave 294-352
MOE_PLAIN_ULPS = 8


def _moe_plain(torch, p, mcfg, x, route):
    """The MoE FFN (no shared experts) written plainly in float32 from its
    definition, on the experts ``route`` (``record_routes``' entry of the
    port's call on ``x``) chose: per batch row, tokens in order and each
    token's experts in rank order, an expert's choices past its capacity
    dropped; each kept choice adds its renormalized softmax probability
    times the expert's SwiGLU of the token.  Also checks the choices are
    a top-k of the logits in descending order.  Returns (out, keep)."""
    from repro_torch.models import moe as MOE
    b, s, _ = x.shape
    k, cap = mcfg.top_k, MOE.capacity(mcfg, s)
    logits, idx = route["logits"], route["expert_idx"]
    chosen = torch.gather(logits, -1, idx)
    rest = logits.scatter(-1, idx, float("-inf")).amax(-1)
    if not bool((chosen[..., :-1] >= chosen[..., 1:]).all()
                and (chosen[..., -1] >= rest).all()):
        raise AssertionError("MoE: the chosen experts are not the top k")
    probs = torch.softmax(logits, -1)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    keep = torch.zeros((b, s * k), dtype=torch.bool)
    for bi in range(b):
        used = [0] * mcfg.num_experts
        for t in range(s):
            g = probs[bi, t, idx[bi, t]]
            g = g / g.sum()
            xt = x[bi, t].float()
            for r, e in enumerate(idx[bi, t].tolist()):
                used[e] += 1
                if used[e] > cap:
                    continue
                keep[bi, t * k + r] = True
                h = torch.nn.functional.silu(xt @ p["w_gate"][e].float()) \
                    * (xt @ p["w_up"][e].float())
                out[bi, t] += g[r] * (h @ p["w_down"][e].float())
    return out, keep
def _example_run(torch, dev, name):
    """One example's ``main`` at its full size on the card, its output
    captured: wall seconds and the K1 / K2 launch counts of the run, each
    count set to 0 just before it and read just after, its output and
    what ``main`` returned."""
    import contextlib
    import importlib
    import io
    from repro_torch.kernels.imc_mav import ops
    from repro_torch.kernels.sga_update import ops as sga_ops
    module = importlib.import_module(f"repro_torch.examples.{name}")
    counts = {"imc_fused": ops.COUNTS, "head_train_rows": sga_ops.COUNTS_HEAD,
              "sga_update_rows": sga_ops.COUNTS_ROWS,
              "sga_update": sga_ops.COUNTS_FLAT,
              "imc_mav": ops.COUNTS_MAV}
    os.environ.pop("REPRO_EXAMPLES_SMOKE", None)
    buf = io.StringIO()
    for c in counts.values():
        c.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        ret = module.main(["--device", str(dev)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counts.items()}
    return dict(wall_s=wall, launches=launches, out=buf.getvalue(),
                ret=ret)


def _example_routes(torch, dev, name, ret, triggers):
    """An example's hardware-path calls (``main``'s return) on the card
    through K1 and on the plain route: logits and features bitwise equal
    and finite; for ``stream_kws``, its streams served on both routes give
    the same events, and the TRIGGER lines ``main`` printed are the plain
    route's.  Returns the number of comparisons."""
    from repro_torch.examples import stream_kws
    from repro_torch.training import kws as tr
    if name == "stream_kws":
        from repro_torch.models import kws
        window, hop, n, tail = stream_kws.sizes(False)
        cfg = kws.KWSConfig(sample_len=window)
        hw = stream_kws.folded_net(cfg, dev)
        streams = stream_kws.make_streams(window, hop, n, tail)
        _, ek = stream_kws.serve(hw, cfg, hop, streams, dev)
        _, ep = stream_kws.serve(hw, cfg, hop, streams, dev,
                                 use_kernel=False)
        fields = ("stream", "hop", "keyword", "trigger", "score")
        if [[e[f] for f in fields] for e in ek] != \
                [[e[f] for f in fields] for e in ep] or not ep:
            raise AssertionError("stream_kws: events through K1 differ "
                                 "from the plain route's")
        want = [stream_kws.trigger_line(e) for e in ep if e["trigger"]]
        if triggers != want:
            raise AssertionError(f"stream_kws: printed {triggers}, the "
                                 f"plain route's {want}")
        return len(ep)
    n = 0
    for what, hw, x, kw in ret["calls"]:
        for out_index in (0, 1):                  # logits, features
            k, p = (tr._hw_batched(hw, x, ret["cfg"], out_index,
                                   use_kernel=u, device=dev, **_hw_kw(**kw))
                    for u in (True, False))
            if not torch.equal(k, p) or not torch.isfinite(k).all():
                raise AssertionError(f"{name} ({what}): the outputs "
                                     f"through K1 differ from the plain "
                                     f"route's")
            n += 1
    return n


def _serve_timed(torch, srv, prompts):
    """``srv`` (a full-width ``Server``) on ``prompts`` after a warm-up
    request: walls, each decode step stamped on the host clock (a greedy
    step ends in its argmax on the host, so the gap from one greedy
    step's start to the next's is one step's latency), then a short
    request under the profiler (3 prompt steps and 2 greedy ones): device
    busy time and launches a step."""
    from torch.profiler import ProfilerActivity, profile
    srv.submit_and_run(prompts[:1], max_new=2)          # warm-up
    torch.cuda.synchronize()
    stamps = []                         # the host clock at each step
    decode = srv.decode

    def stamped(params, caches, batch):
        stamps.append(time.perf_counter())
        return decode(params, caches, batch)
    srv.decode = stamped
    t0 = time.perf_counter()
    outs = srv.submit_and_run(prompts, max_new=LM_MAX_NEW)
    wall = time.perf_counter() - t0
    srv.decode = decode
    greedy, i = [], 0
    for p in prompts:
        i += len(p) - 1
        greedy += [stamps[j + 1] - stamps[j]
                   for j in range(i, i + LM_MAX_NEW - 1)]
        i += LM_MAX_NEW
    t_prof = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        srv.submit_and_run([prompts[0][:4]], max_new=2)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t1
    steps_prof = 3 + 2
    dev_us, rows = device_time(torch, prof)
    kernels_n = sum(n for _, n in rows.values())
    n_tokens = sum(len(o) for o in outs)
    return dict(outs=outs, steps=len(stamps), wall_s=wall,
                ms_per_step_wall=wall / len(stamps) * 1e3,
                ms_per_greedy_step=statistics.median(greedy) * 1e3,
                tokens_per_s=n_tokens / wall,
                busy_ms_per_step=(dev_us / 1e3 / steps_prof if kernels_n
                                  else None),
                launches_per_step=kernels_n / steps_prof,
                busy_share=dev_us / 1e6 / prof_wall if kernels_n else None,
                profile_s=time.perf_counter() - t_prof)


def _lm_full(torch, dev, arch=LM_FULL):
    """(c), (d): ``Server(arch, reduced=False)`` on the card: ``main()``'s
    traffic, walls, the device time per step, bytes and the bound, and
    the teacher-forced decode against ``prefill`` on one 8-token prompt
    (for the MoE family reported with the choices the prefill dropped,
    not gated: ``models/lm.py``'s docstring; gated instead: ``prefill``
    of the prompt's first token against the decode step on it, logits
    within ``LM_ULPS`` and the routing equal (capacity 1 drops nothing
    at S = 1), and layer 0's MoE block on the card against
    ``_moe_plain``; and a second bound for a dispatch that reads only
    the routed experts)."""
    import gc
    import numpy as np
    from repro_torch.launch import crosscheck, serve
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.models import moe as MOE
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    moe = serve.get_config(arch).family == "moe"
    t0 = time.perf_counter()
    srv = serve.Server(arch, reduced=False, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    draw_peak = torch.cuda.max_memory_allocated(dev)
    cfg = srv.cfg
    pbytes = LM.param_bytes(srv.params)
    n_params = sum(a.numel() for a in LM.leaves(srv.params))
    prompts = serve.prompts_for(cfg, LM_REQUESTS)
    t = _serve_timed(torch, srv, prompts)
    outs, n_steps, wall, step_ms = (t["outs"], t["steps"], t["wall_s"],
                                    t["ms_per_greedy_step"])
    n_tokens = sum(len(o) for o in outs)
    busy_ms, launches_per_step, busy_share, prof_s = (
        t["busy_ms_per_step"], t["launches_per_step"], t["busy_share"],
        t["profile_s"])
    # the least bytes a step moves: every parameter once but the embedding
    # table (one row of it), the valid K/V read, the new K/V written
    row = cfg.d_model * 2
    emb = srv.params["embed"].numel() * 2
    kv_pos = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * 2
    mean_pos = np.mean([len(p) - 1 + LM_MAX_NEW for p in prompts]) / 2
    step_bytes = pbytes - emb + row + kv_pos * (mean_pos + 1)
    flops = 2 * (n_params - srv.params["embed"].numel())
    bound = max(step_bytes / H100_BYTES_PER_S,
                flops / H100_BF16_OPS_PER_S) * 1e3
    routed = None
    if moe:
        # the dense dispatch runs every expert over its slots; a dispatch
        # that read only the top-k experts of the step's one token
        m = cfg.moe
        idle = cfg.n_layers * 3 * (m.num_experts - m.top_k) * \
            m.d_model * m.d_ff_expert
        routed = float(max((step_bytes - 2 * idle) / H100_BYTES_PER_S,
                           (flops - 2 * idle) / H100_BF16_OPS_PER_S) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    # the teacher-forced decode against prefill at full width
    prompt = np.random.default_rng(2).integers(2, cfg.vocab_size, (1, 8))
    with MOE.record_routes() as routes:
        last, _ = LM.prefill(srv.params, cfg, prompt)
    dropped = sum(int((~r["keep"]).sum()) for r in routes)
    caches = LM.init_cache(cfg, 1, 8, device=dev)
    for t in range(8):
        (logits, caches), r = crosscheck.routed(lambda: LM.decode_step(
            srv.params, cfg, prompt[:, t:t + 1], caches, t))
        if t == 0:
            first, first_routes = logits, r
    tf_ulps = crosscheck.ulps_apart(logits, last)
    moe_gate = {}
    if moe:
        # at S = 1 the prefill's capacity is 1 and drops nothing, as the
        # decode step's: the two must agree
        (one, _), one_routes = crosscheck.routed(
            lambda: LM.prefill(srv.params, cfg, prompt[:, :1]))
        moe_gate["one_token_ulps"] = crosscheck.ulps_apart(first, one)
        moe_gate["one_token_routes_equal"] = len(one_routes) == len(
            first_routes) == cfg.n_layers and all(
            torch.equal(a["expert_idx"], b["expert_idx"])
            and torch.equal(a["keep"], b["keep"])
            for a, b in zip(first_routes, one_routes))
        if not (moe_gate["one_token_ulps"] <= crosscheck.LM_ULPS
                and moe_gate["one_token_routes_equal"]):
            raise AssertionError(f"full width {arch}: decode step 0 against "
                                 f"the 1-token prefill {moe_gate}")
        # layer 0's MoE block against the plain float32 one, 8 tokens
        mp = LM.layer(srv.params["segments"][0], 0)["moe"]
        x = torch.randn((1, 8, cfg.d_model), generator=torch.Generator(
            dev).manual_seed(3), device=dev).bfloat16()
        (mo, _), (route,) = crosscheck.routed(
            lambda: MOE.moe_apply(mp, cfg.moe, x))
        plain, keep = _moe_plain(torch, mp, cfg.moe, x, route)
        moe_gate["layer_ulps"] = crosscheck.ulps_apart(mo.float(), plain)
        moe_gate["layer_dropped"] = int((~keep).sum())
        if not torch.equal(keep, route["keep"].cpu()) or not \
                moe_gate["layer_ulps"] <= MOE_PLAIN_ULPS:
            raise AssertionError(f"full width {arch}: layer 0's MoE block "
                                 f"against the plain one {moe_gate}")
    same_top = int(torch.argmax(logits[0, -1, :cfg.vocab_size])) == int(
        torch.argmax(last[0, -1, :cfg.vocab_size]))
    if not moe and not tf_ulps <= crosscheck.LM_ULPS:
        raise AssertionError(f"full width: teacher-forced decode "
                             f"{tf_ulps:.2f} ulps from prefill")
    if not all(len(o) == LM_MAX_NEW for o in outs):
        raise AssertionError(f"full width: {outs}")
    if not torch.isfinite(logits).all() or not torch.isfinite(last).all():
        raise AssertionError(f"full width {arch}: logits not finite")
    out = dict(arch=arch, params=n_params, param_bytes=pbytes,
               init_s=init_s, draw_peak_bytes=draw_peak, peak_bytes=peak,
               requests=len(outs),
               tokens=outs, steps=n_steps, wall_s=wall,
               ms_per_step_wall=wall / n_steps * 1e3,
               ms_per_greedy_step=step_ms, tokens_per_s=n_tokens / wall,
               busy_ms_per_step=busy_ms, busy_share=busy_share,
               launches_per_step=launches_per_step,
               bound_ms=float(bound), bound_by=("bytes" if step_bytes
                                         / H100_BYTES_PER_S >= flops
                                         / H100_BF16_OPS_PER_S
                                         else "operations"),
               step_bytes=float(step_bytes), teacher_forced_ulps=tf_ulps,
               teacher_forced_same_top=same_top, profile_s=prof_s,
               routed_bound_ms=routed, prefill_dropped=dropped,
               prefill_choices=sum(r["keep"].numel() for r in routes),
               **moe_gate)
    part = "(d)" if moe else "(c)"
    moe_line = "" if not moe else (
        f"; MoE: bound of a routed-only dispatch {routed:.3f} ms, the "
        f"8-token prefill dropped {dropped} of {out['prefill_choices']} "
        f"choices (capacity {MOE.capacity(cfg.moe, 8)}), so the decode is "
        f"not held to it; decode step 0 against the 1-token prefill "
        f"{moe_gate['one_token_ulps']:.2f} ulps, routing equal "
        f"{moe_gate['one_token_routes_equal']}; layer 0's MoE block against "
        f"the plain float32 one {moe_gate['layer_ulps']:.2f} ulps (limit "
        f"{MOE_PLAIN_ULPS}), {moe_gate['layer_dropped']} of "
        f"{cfg.moe.top_k * 8} choices dropped")
    log(f"[examples] {part} {arch} full width ({n_params / 1e9:.3f} B "
        f"parameters, {pbytes / 1e9:.3f} GB bf16, init {init_s:.1f} s): "
        f"{len(outs)} requests, {n_steps} decode steps in {wall:.3f} s, "
        f"{out['ms_per_step_wall']:.3f} ms per step (greedy step median "
        f"{step_ms:.3f} ms), {out['tokens_per_s']:.2f} tokens/s; device "
        f"busy {busy_ms} ms (share {busy_share} under the profiler) and "
        f"{launches_per_step:.0f} launches per step; bound {bound:.3f} ms "
        f"({out['bound_by']}); peak memory {draw_peak / 1e9:.3f} GB after "
        f"the draw (chunks of {L.DRAW_CHUNK}), {peak / 1e9:.3f} GB after "
        f"serving; teacher-forced decode against prefill "
        f"{tf_ulps:.2f} ulps, same top token {same_top}; the profile took "
        f"{prof_s:.1f} s{moe_line}")
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _recurrent_step_bytes(cfg, params, caches, mean_pos):
    """(bytes, FLOPs) of one decode step of a recurrent LM at batch 1:
    every parameter read once but the embedding table (one row of it),
    the zamba2 shared block's weights once per use; every recurrent cache
    leaf read and written once; the shared block's valid K/V read and one
    new position written per use; two FLOPs per weight read."""
    from repro_torch.models import lm as LM
    emb = params["embed"]
    p_bytes = LM.param_bytes(params) - emb.numel() * emb.element_size() \
        + cfg.d_model * emb.element_size()
    p_n = sum(a.numel() for a in LM.leaves(params)) - emb.numel()
    state = 0
    for (kind, count), seg, cache in zip(LM.seg_plan(cfg),
                                         params["segments"], caches):
        if kind == "zamba_group":
            uses = count // cfg.attn_every
            shared = seg["shared_attn"]
            p_bytes += (uses - 1) * LM.param_bytes(shared)
            p_n += (uses - 1) * sum(a.numel() for a in LM.leaves(shared))
            kv = cache["attn"]["k"]
            per_pos = 2 * uses * kv.shape[3] * kv.shape[4] * \
                kv.element_size()
            state += per_pos * (mean_pos + 1)
            cache = cache["mamba"]
        state += 2 * LM.param_bytes(cache)
    return p_bytes + state, 2 * p_n


def _recurrent_core_ms(torch, dev, cfg, params):
    """Device times (``device_ms``) of the recurrent cores at full width
    on a 128-token prompt (one chunk), the speed list's inputs: the GLA
    core alone at one layer's shapes (bfloat16 q, k, v; float32 gates),
    the sLSTM layer's time loop (xLSTM), and the whole ``forward_lm``;
    with the number of GLA and sLSTM layers a forward runs."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.models import xlstm as XL
    t = 128
    gen = torch.Generator(dev).manual_seed(5)
    plan = LM.seg_plan(cfg)
    if cfg.family == "hybrid":
        h, dk, dv = cfg.mamba.n_heads, cfg.mamba.d_state, cfg.mamba.head_dim
    else:
        h, dk = cfg.xlstm.n_heads, cfg.xlstm.head_dim
        dv = dk
    q, k = (torch.randn((1, t, h, dk), generator=gen, device=dev)
            .bfloat16() for _ in range(2))
    v = torch.randn((1, t, h, dv), generator=gen, device=dev).bfloat16()
    log_a = -0.1 * torch.rand((1, t, h), generator=gen, device=dev)
    b = torch.rand((1, t, h), generator=gen, device=dev)
    out = {"gla_ms": device_ms(torch, lambda: L.gated_linear_attention(
        q, k, v, log_a, b), reps=3, iters=5),
        "gla_layers": sum(n for kind, n in plan
                          if kind in ("mamba", "zamba_group", "mlstm")),
        "slstm_layers": sum(n for kind, n in plan if kind == "slstm")}
    x = torch.randn((1, t, cfg.d_model), generator=gen,
                    device=dev).bfloat16()
    if out["slstm_layers"]:
        seg = params["segments"][[kind for kind, _ in plan].index("slstm")]
        out["slstm_ms"] = device_ms(torch, lambda: XL.slstm_apply(
            seg, cfg.xlstm, x), reps=2, iters=1)
    prompt = torch.randint(2, cfg.vocab_size, (1, t), generator=gen,
                           device=dev)
    out["forward_ms"] = device_ms(torch, lambda: LM.forward_lm(
        params, cfg, prompt, train=False), reps=2, iters=1)
    return out


def _layer_launches(torch, dev, cfg, params):
    """Kernel launches of one decode step of each layer kind of a
    recurrent LM at batch 1, the median over profiled runs of 10 calls of
    the profiler's device records per call (``device_ms``): a Mamba2
    layer and a shared-block use (zamba2), an mLSTM and an sLSTM layer
    (xLSTM)."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    from repro_torch.models import xlstm as XL
    h = torch.zeros((1, 1, cfg.d_model), dtype=torch.bfloat16, device=dev)
    caches = LM.init_cache(cfg, 1, 8, device=dev)
    calls = {}
    for (kind, count), seg, cache in zip(LM.seg_plan(cfg),
                                         params["segments"], caches):
        if kind == "zamba_group":
            rope = L.rope_tables(torch.arange(1, device=dev)[None, :],
                                 cfg.head_dim, cfg.rope_theta)
            kv = {k: v[0] for k, v in cache["attn"].items()}
            calls["shared_block"] = lambda seg=seg, kv=kv, rope=rope: \
                LM._attn_block_apply(seg["shared_attn"], cfg, h, cache=kv,
                                     cache_index=0, rope=rope, aux=False)
            seg, cache, kind = seg["mamba"], cache["mamba"], "mamba"
        if kind == "slstm":
            calls[kind] = lambda seg=seg, cache=cache: XL.slstm_step(
                seg, cfg.xlstm, h, cache)
        else:
            calls[kind] = lambda seg=seg, cache=cache, kind=kind: \
                LM._recurrent_step(cfg, kind, LM.layer(seg, 0), h,
                                   LM.layer(cache, 0))
    out = {}
    with L.float32_accumulation():
        for name, fn in calls.items():
            records = []
            device_ms(torch, fn, reps=3, iters=10, records=records)
            out[name] = statistics.median(records) if records else None
    return out


def _lm_recurrent_full(torch, dev, arch):
    """(e): ``Server(arch, reduced=False)`` of a recurrent family on the
    card: the draw's wall time, ``main()``'s traffic timed and profiled
    (``_serve_timed``), bytes and the bound of a step
    (``_recurrent_step_bytes``), peak memory; gated: decode step 0
    against the prefill of its one token, and an 8-token prompt's full
    forward against its teacher-forced decode, each within the family's
    ``crosscheck.lm_ulps`` (the reference's own decode and forward agree
    on these families; the port's part by rounding flips that the
    recurrence carries to later positions)."""
    import gc
    import numpy as np
    from repro_torch.launch import crosscheck, serve
    from repro_torch.models import lm as LM
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    srv = serve.Server(arch, reduced=False, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    draw_peak = torch.cuda.max_memory_allocated(dev)
    cfg = srv.cfg
    pbytes = LM.param_bytes(srv.params)
    n_params = sum(a.numel() for a in LM.leaves(srv.params))
    prompts = serve.prompts_for(cfg, LM_REQUESTS)
    t = _serve_timed(torch, srv, prompts)
    mean_pos = np.mean([len(p) - 1 + LM_MAX_NEW for p in prompts]) / 2
    caches = LM.init_cache(cfg, 1, srv.max_len, device=dev)
    step_bytes, flops = _recurrent_step_bytes(cfg, srv.params, caches,
                                              mean_pos)
    t_bytes = step_bytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_OPS_PER_S * 1e3
    peak = torch.cuda.max_memory_allocated(dev)
    prompt = np.random.default_rng(2).integers(2, cfg.vocab_size, (1, 8))
    full, _ = LM.forward_lm(srv.params, cfg, prompt, train=False)
    one, _ = LM.prefill(srv.params, cfg, prompt[:, :1])
    caches = LM.init_cache(cfg, 1, 8, device=dev)
    steps = []
    for i in range(8):
        logits, caches = LM.decode_step(srv.params, cfg,
                                        prompt[:, i:i + 1], caches, i)
        steps.append(logits[:, 0])
    gate = {"one_token_ulps": crosscheck.ulps_apart(steps[0], one[:, 0]),
            "forward_ulps": crosscheck.ulps_apart(torch.stack(steps, 1),
                                                  full)}
    limit = crosscheck.lm_ulps(cfg)
    for key, v in gate.items():
        if not v <= limit:
            raise AssertionError(f"full width {arch}: {key} {v:.2f} > "
                                 f"{limit}")
    if not all(len(o) == LM_MAX_NEW for o in t["outs"]):
        raise AssertionError(f"full width {arch}: {t['outs']}")
    if not torch.isfinite(full).all():
        raise AssertionError(f"full width {arch}: logits not finite")
    t["tokens"] = t.pop("outs")
    core = _recurrent_core_ms(torch, dev, cfg, srv.params)
    core["launches_per_layer"] = _layer_launches(torch, dev, cfg,
                                                 srv.params)
    out = dict(arch=arch, params=n_params, param_bytes=pbytes,
               init_s=init_s, draw_peak_bytes=draw_peak, peak_bytes=peak,
               requests=len(t["tokens"]), step_bytes=float(step_bytes),
               bound_ms=float(max(t_bytes, t_ops)),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               cache_bytes=LM.param_bytes(caches), **t, **gate, **core)
    log(f"[examples] (e) {arch} full width ({n_params / 1e9:.4f} B "
        f"parameters, {pbytes / 1e9:.4f} GB, draw {init_s:.2f} s): "
        f"{out['requests']} requests, {out['steps']} decode steps in "
        f"{out['wall_s']:.3f} s, {out['ms_per_step_wall']:.3f} ms per step "
        f"(greedy step median {out['ms_per_greedy_step']:.3f} ms), "
        f"{out['tokens_per_s']:.2f} tokens/s; device busy "
        f"{out['busy_ms_per_step']} ms (share {out['busy_share']} under the "
        f"profiler) and {out['launches_per_step']:.0f} launches per step; "
        f"bound {out['bound_ms']:.4f} ms ({out['bound_by']}, "
        f"{step_bytes / 1e9:.4f} GB a step); peak memory "
        f"{draw_peak / 1e9:.3f} GB after the draw, {peak / 1e9:.3f} GB after "
        f"serving; decode step 0 against the 1-token prefill "
        f"{gate['one_token_ulps']:.2f} ulps, the 8-token forward against "
        f"its teacher-forced decode {gate['forward_ulps']:.2f} ulps (limit "
        f"{limit}); the profile took {out['profile_s']:.1f} s; "
        f"on a 128-token prompt (device time): the GLA core "
        f"{core['gla_ms']} ms a call x {core['gla_layers']} layers, the "
        f"sLSTM time loop {core.get('slstm_ms')} ms a layer x "
        f"{core['slstm_layers']}, the whole forward {core['forward_ms']} ms; "
        f"launches of one decode step a layer kind "
        f"{core['launches_per_layer']}")
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _encdec_step_bound(cfg, params, mean_pos):
    """(ms, bound_by, bytes, FLOPs) of one encdec decode step at batch 1
    against a memory of ``cfg.frontend_len`` frames: the decoder's and
    the unembedding's weights read once, one embedding row, each layer's
    read of the memory (its cross-attention K/V recomputed from it, as
    the reference does), the valid self-attention K/V read and the new
    position written; two FLOPs per weight, plus the cross K/V
    projections over every frame and the scores and weighted sums over
    the frames and the cached positions."""
    from repro_torch.models import lm as LM
    d, s_enc, n = cfg.d_model, cfg.frontend_len, cfg.n_layers
    kv_w = cfg.n_kv_heads * cfg.head_dim
    dec = sum(a.numel() for a in LM.leaves(params["decoder"]))
    unembed = params["unembed"].numel()
    kv_pos = n * 2 * kv_w * 2
    nbytes = (2 * (dec + unembed) + 2 * d + n * s_enc * d * 2
              + kv_pos * (mean_pos + 1))
    heads = cfg.n_heads * cfg.head_dim
    flops = (2 * (dec + unembed) + n * s_enc * 2 * (2 * d * kv_w)
             + n * 2 * 2 * heads * (s_enc + mean_pos + 1))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def _encdec_full(torch, dev):
    """(f): seamless-m4t-medium at full width on the card through
    ``steps.init_params_for`` (bfloat16, ``PRNGKey(0)``),
    ``make_prefill_step`` and ``make_decode_step``
    (``crosscheck.encdec_generate``): ``main()``'s 4 requests, each with
    its own 1024 seeded frames, encoded and prefilled, the prompt fed
    teacher-forced into a fresh cache, then 8 greedy tokens.  Timed: the
    draw, each request's encode-plus-prefill (wall, and device time and
    launches under the profiler), each decode step on the host clock,
    a profiled decode step (device time, launches) and its
    cross-attention K/V projections alone (device time); the bound of a
    step (``_encdec_step_bound``); peak memory.  Gated, each within
    ``crosscheck.lm_ulps``: an 8-token prompt's ``forward_encdec``
    against its teacher-forced decode, and per request the prefill's last
    logits against the decode step on the prompt's last token and its
    K/V against the decode cache's first S positions."""
    import gc
    import numpy as np
    from repro_torch.core import jaxrand
    from repro_torch.kernels.imc_mav import ops
    from repro_torch.kernels.int8_matmul import ops as i8_ops
    from repro_torch.kernels.sga_update import ops as sga_ops
    from repro_torch.launch import crosscheck, serve, steps
    from repro_torch.models import encdec as ED
    from repro_torch.models import layers as L
    from repro_torch.models import lm as LM
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    counts = (ops.COUNTS, ops.COUNTS_MAV, i8_ops.COUNTS, sga_ops.COUNTS_HEAD,
              sga_ops.COUNTS_ROWS, sga_ops.COUNTS_FLAT)
    for c in counts:
        c.reset()
    cfg = serve.get_config(ENCDEC)
    t0 = time.perf_counter()
    params = steps.init_params_for(cfg, jaxrand.PRNGKey(0, device="cpu"),
                                   device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    draw_peak = torch.cuda.max_memory_allocated(dev)
    pbytes = LM.param_bytes(params)
    n_params = sum(a.numel() for a in LM.leaves(params))
    prompts = serve.prompts_for(cfg, LM_REQUESTS)
    frames = crosscheck.encdec_frames(cfg, LM_REQUESTS, 3).to(dev)
    prefill, decode = steps.make_prefill_step(cfg), \
        steps.make_decode_step(cfg)
    crosscheck.encdec_generate(params, cfg, prompts[:1], frames[:1],
                               2)                              # warm-up
    torch.cuda.synchronize()
    stamps, prefill_s = [], []

    def timed_prefill(p, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = prefill(p, batch)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t)
        return out

    def stamped(p, caches, batch):
        stamps.append(time.perf_counter())
        return decode(p, caches, batch)
    t0 = time.perf_counter()
    outs, records = crosscheck.encdec_generate(
        params, cfg, prompts, frames, LM_MAX_NEW, prefill=timed_prefill,
        decode=stamped)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    greedy, i = [], 0
    for p in prompts:
        i += len(p) - 1
        greedy += [stamps[j + 1] - stamps[j]
                   for j in range(i, i + LM_MAX_NEW - 1)]
        i += LM_MAX_NEW
    n_tokens = sum(len(o) for o in outs)
    # device time and launches of one encode-plus-prefill and one decode
    # step (request 0's shapes), the median over profiled runs
    rec0, ids0 = records[0], torch.as_tensor(prompts[0], device=dev)[None]
    batch0 = {"frames": frames[:1], "tokens": ids0}
    pre_launches, step_launches = [], []
    pre_ms = device_ms(torch, lambda: prefill(params, batch0), reps=3,
                       iters=2, records=pre_launches)
    cache0 = ED.init_dec_cache(cfg, 1, 128, device=dev)
    sbatch = {"tokens": ids0[:, :1], "memory": rec0["memory"],
              "index": len(prompts[0])}
    step_ms = device_ms(torch, lambda: decode(params, cache0, sbatch),
                        reps=3, iters=10, records=step_launches)
    # what a step spends recomputing the cross-attention K/V from the
    # memory (the reference's ``attention(kv_override=memory)``): the
    # twelve layers' K and V projections of the frames alone
    cross = [LM.layer(params["decoder"], i)["cross_attn"]
             for i in range(cfg.n_layers)]

    def cross_kv():
        with L.float32_accumulation():
            for c in cross:
                L.dense(c["wk"], rec0["memory"])
                L.dense(c["wv"], rec0["memory"])
    cross_kv_ms = device_ms(torch, cross_kv, reps=3, iters=10)
    mean_pos = np.mean([len(p) - 1 + LM_MAX_NEW for p in prompts]) / 2
    bound, bound_by, step_bytes, step_flops = _encdec_step_bound(
        cfg, params, mean_pos)
    # the prefill's least time: two FLOPs per weight per frame (encoder)
    # or token (decoder), the cross K/V over every frame
    enc = sum(a.numel() for a in LM.leaves(params["encoder"]))
    dec = sum(a.numel() for a in LM.leaves(params["decoder"]))
    s0 = len(prompts[0])
    pre_flops = 2 * (enc * cfg.frontend_len + dec * s0
                     + params["unembed"].numel())
    pre_bound = max(pre_flops / H100_BF16_OPS_PER_S,
                    (pbytes - params["embed"].numel() * 2)
                    / H100_BYTES_PER_S) * 1e3
    peak = torch.cuda.max_memory_allocated(dev)
    # gates
    limit = crosscheck.lm_ulps(cfg)
    gate = {"prefill_vs_step_ulps": 0.0, "prefill_kv_vs_cache_ulps": 0.0}
    for p, rec in zip(prompts, records):
        gate["prefill_vs_step_ulps"] = max(
            gate["prefill_vs_step_ulps"], crosscheck.ulps_apart(
                rec["steps"][len(p) - 1], rec["prefill"][0, -1]))
        for k in ("k", "v"):
            gate["prefill_kv_vs_cache_ulps"] = max(
                gate["prefill_kv_vs_cache_ulps"], crosscheck.ulps_apart(
                    rec["cache"][k], rec["kv"][k]))
    prompt = torch.as_tensor(np.random.default_rng(2).integers(
        2, cfg.vocab_size, (1, 8)), device=dev)
    full = ED.forward_encdec(params, cfg, frames[:1], prompt, train=False)
    memory = ED.encode(params, cfg, frames[:1], train=False)
    cache = ED.init_dec_cache(cfg, 1, 8, device=dev)
    tf = []
    for t in range(8):
        logits, cache = decode(params, cache, {
            "tokens": prompt[:, t:t + 1], "memory": memory, "index": t})
        tf.append(logits[:, 0])
    gate["forward_vs_decode_ulps"] = crosscheck.ulps_apart(
        torch.stack(tf, 1), full)
    for key, v in gate.items():
        if not v <= limit:
            raise AssertionError(f"full width {ENCDEC}: {key} {v:.2f} > "
                                 f"{limit}")
    if not all(len(o) == LM_MAX_NEW for o in outs) or not \
            torch.isfinite(full).all():
        raise AssertionError(f"full width {ENCDEC}: {outs}")
    kernel_launches = sum(c.launches for c in counts)
    out = dict(arch=ENCDEC, params=n_params, param_bytes=pbytes,
               init_s=init_s, draw_peak_bytes=draw_peak, peak_bytes=peak,
               requests=len(outs), tokens=outs, steps=len(stamps),
               wall_s=wall, ms_per_step_wall=wall / len(stamps) * 1e3,
               ms_per_greedy_step=statistics.median(greedy) * 1e3,
               tokens_per_s=n_tokens / wall,
               prefill_wall_ms=[v * 1e3 for v in prefill_s],
               prefill_busy_ms=pre_ms,
               prefill_launches=(statistics.median(pre_launches)
                                 if pre_launches else None),
               prefill_bound_ms=pre_bound, busy_ms_per_step=step_ms,
               cross_kv_ms=cross_kv_ms,
               launches_per_step=(statistics.median(step_launches)
                                  if step_launches else None),
               bound_ms=bound, bound_by=bound_by,
               step_bytes=float(step_bytes), step_flops=float(step_flops),
               port_kernel_launches=kernel_launches, **gate)
    log(f"[examples] (f) {ENCDEC} full width ({n_params} parameters, "
        f"{pbytes / 1e9:.4f} GB bf16, draw {init_s:.2f} s): "
        f"{len(outs)} requests of {cfg.frontend_len} frames, encode plus "
        f"prefill {[round(v, 2) for v in out['prefill_wall_ms']]} ms wall, "
        f"{pre_ms} ms device and {out['prefill_launches']} launches "
        f"(bound {pre_bound:.4f} ms); {len(stamps)} decode steps in "
        f"{wall:.3f} s, {out['ms_per_step_wall']:.3f} ms per step (greedy "
        f"step median {out['ms_per_greedy_step']:.3f} ms), "
        f"{out['tokens_per_s']:.2f} tokens/s; a decode step {step_ms} ms "
        f"device (of which the cross-attention K/V recomputed from the "
        f"memory {cross_kv_ms} ms) and {out['launches_per_step']} launches, "
        f"bound "
        f"{bound:.4f} ms ({bound_by}, {step_bytes / 1e9:.4f} GB, "
        f"{step_flops / 1e9:.2f} GFLOP); peak memory "
        f"{draw_peak / 1e9:.3f} GB after the draw, {peak / 1e9:.3f} GB "
        f"after serving; gates (limit {limit} ulps): prefill against the "
        f"step on the prompt's last token "
        f"{gate['prefill_vs_step_ulps']:.2f}, prefill K/V against the "
        f"decode cache {gate['prefill_kv_vs_cache_ulps']:.2f}, the 8-token "
        f"forward against its teacher-forced decode "
        f"{gate['forward_vs_decode_ulps']:.2f}; the port's kernels "
        f"launched {kernel_launches} times on this path (none is on it)")
    del params, records
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_examples(torch, dev):
    """Phase 16: the examples and the LM stack's serving path on the card.

    (a) the three KWS examples (``repro_torch.examples``) at their full,
        non-smoke sizes, each run by its ``main`` with ``--device cuda``:
        its wall time and its launches of K1 (``imc_fused``, every example)
        and of the fused head training (``head_train_rows``, the
        enrollment session of ``customize_onchip``), each count set to 0
        just before the run and read just after; ``customize_onchip``
        asserts its session (K1 and ``head_train_rows``) bit-identical to
        the offline loop on the plain route; then each example's
        hardware-path calls at its own shapes (``quickstart`` at a
        1000-sample window, clean, noisy and compensated; the others at
        2000 with hop-256 tails) through K1 and on the plain route,
        bitwise equal (``_example_routes``);
    (b) the reduced qwen2.5-14b, starcoder2-15b, internvl2-2b (its
        prefix frames too), qwen3-moe-30b-a3b, qwen2-moe-a2.7b,
        zamba2-1.2b and xlstm-125m on the card against the port on the
        CPU with the same parameters (``launch.crosscheck.card_against_cpu``,
        which the card tests run too): prefill's last logits and caches
        and 8 teacher-forced decode steps (every cache leaf) within the
        family's ``lm_ulps``, and the server's greedy tokens on
        ``main()``'s traffic equal (or forked only where the CPU's top-2
        margin is within the tolerance); the MoE routing equal but where
        the CPU's logits nearly tie, each fork counted with its gap;
    (c) ``Server("qwen2.5-14b", reduced=False)``: 48 layers at d 5120,
        14.77 B parameters in bfloat16 on the card, answering ``main()``'s
        4 requests (4-9-token prompts, 8 new tokens each): parameter bytes,
        peak memory, ms per decode step against the least time the card
        could take for a step, tokens/s, device busy time and launches per
        step (``torch.profiler`` over a 5-step request), and the
        teacher-forced decode against ``prefill``'s last logits on one
        8-token prompt;
    (d) the same for ``Server("qwen3-moe-30b-a3b", reduced=False)``: 48
        layers at d 2048 of 128 experts top-8, 30.53 B parameters (61.07 GB
        in bfloat16); its ms per decode step beside the dense dispatch's
        bound and a routed-only one, and its teacher-forced decode against
        ``prefill`` not gated (the 8-token prefill drops choices at
        capacity 1, a decode step drops none); gated: decode step 0
        against the prefill of its one token (logits within ``LM_ULPS``,
        routing equal), and layer 0's MoE block on 8 tokens against
        ``_moe_plain`` within ``MOE_PLAIN_ULPS``, its kept choices
        equal;
    (e) ``Server("zamba2-1.2b", reduced=False)`` (38 Mamba2 layers at d
        2048, 1.17 B parameters, one shared attention block used before
        each group of 7) and ``Server("xlstm-125m", reduced=False)`` (10
        mLSTM and 2 sLSTM blocks at d 768, 0.19 B parameters) answering
        ``main()``'s 4 requests, as (c) reports, the bound from
        ``_recurrent_step_bytes``; gated: decode step 0 against the
        1-token prefill and an 8-token prompt's full forward against its
        teacher-forced decode, each within the family's
        ``crosscheck.lm_ulps``;
    (f) seamless-m4t-medium at full width through the step builders
        (``_encdec_full``); (b) runs its reduced config first."""
    t_phase = time.perf_counter()
    out = {"examples": {}}
    for name in EXAMPLES:
        r = _example_run(torch, dev, name)
        lines = [ln for ln in r["out"].splitlines()
                 if ln.startswith(("==", "   hw", "   noisy", "   comp",
                                   "   before", "   after", "   TRIGGER",
                                   "before", "+ ", "baseline", "quantized",
                                   "enrollment"))]
        for ln in lines:
            log(f"[examples] {name}: {ln.strip()}")
        if r["launches"]["imc_fused"] == 0:
            raise AssertionError(f"{name}: K1 was not launched")
        if name == "customize_onchip":
            if r["launches"]["head_train_rows"] == 0:
                raise AssertionError("customize_onchip: head_train_rows "
                                     "was not launched")
            if "bit-identical to the offline loop" not in r["out"]:
                raise AssertionError("customize_onchip: no session line")
        triggers = [ln for ln in r.pop("out").splitlines()
                    if "TRIGGER" in ln]
        r["triggers"] = len(triggers)
        t0 = time.perf_counter()
        r["route_checks"] = _example_routes(torch, dev, name, r.pop("ret"),
                                            triggers)
        r["route_check_s"] = time.perf_counter() - t0
        out["examples"][name] = r
        log(f"[examples] (a) {name}: {r['wall_s']:.2f} s, launches "
            f"{r['launches']}; through K1 and the plain route bitwise "
            f"equal in {r['route_checks']} comparisons "
            f"({r['route_check_s']:.1f} s)")
    out["a_s"] = time.perf_counter() - t_phase
    from repro_torch.launch import crosscheck
    t0 = time.perf_counter()
    out["reduced"] = {}
    r = out["reduced"][ENCDEC] = crosscheck.encdec_card_against_cpu(
        ENCDEC, dev, steps_n=LM_STEPS, requests=LM_REQUESTS,
        max_new=LM_MAX_NEW)
    log(f"[examples] (b) {ENCDEC} reduced, card against CPU: prefill "
        f"{r['prefill_ulps']:.2f} ulps (K/V {r['prefill_cache_ulps']:.2f}, "
        f"memory {r['memory_ulps']:.2f}), {LM_STEPS} decode steps "
        f"{r['decode_ulps']:.2f} ulps (cache {r['decode_cache_ulps']:.2f}), "
        f"tolerance {crosscheck.lm_ulps(crosscheck.serve.get_config(ENCDEC))}"
        f"; greedy tokens equal: {r['tokens_equal']} {r['forks']}")
    for arch in LM_ARCHS:
        r = out["reduced"][arch] = crosscheck.card_against_cpu(
            arch, dev, steps=LM_STEPS, requests=LM_REQUESTS,
            max_new=LM_MAX_NEW)
        log(f"[examples] (b) {arch} reduced, card against CPU: prefill "
            f"{r['prefill_ulps']:.2f} ulps (caches "
            f"{r['prefill_cache_ulps']:.2f}), {LM_STEPS} decode steps "
            f"{r['decode_ulps']:.2f} ulps (caches "
            f"{r['decode_cache_ulps']:.2f}), tolerance "
            f"{crosscheck.lm_ulps(crosscheck.serve.get_config(arch))}; "
            f"greedy tokens equal: {r['tokens_equal']} {r['forks']}; "
            f"routing forks "
            f"{r.get('route_forks', 'none (dense)')}")
    out["b_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["full"] = _lm_full(torch, dev)
    out["c_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["moe_full"] = _lm_full(torch, dev, LM_MOE_FULL)
    out["d_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["recurrent_full"] = {arch: _lm_recurrent_full(torch, dev, arch)
                             for arch in LM_RECURRENT_FULL}
    out["e_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["encdec_full"] = _encdec_full(torch, dev)
    out["f_s"] = time.perf_counter() - t0
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[examples] phase 16 took {out['seconds']:.1f} s: (a) "
        f"{out['a_s']:.1f} s, (b) {out['b_s']:.1f} s, (c) "
        f"{out['c_s']:.1f} s, (d) {out['d_s']:.1f} s, (e) "
        f"{out['e_s']:.1f} s, (f) {out['f_s']:.1f} s")
    return out


# phase 17: LM training
TRAIN_ARCHS = ("qwen2.5-14b", "starcoder2-15b", "internvl2-2b",
               "zamba2-1.2b", "xlstm-125m", ENCDEC)
TRAIN_FULL = "internvl2-2b"
MOE_ARCHS = ("qwen3-moe-30b-a3b", "qwen2-moe-a2.7b")
MOE_EXAMPLE = dict(steps=40, fail_at=25, ckpt_every=10)   # (c)
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 6, 8, 64
ENCDEC_TRAIN_STEPS = 4                                     # (d)
ADAM_PASSES = 7        # float32 passes of an Adam step: p, g, m, v in; p, m, v out
MOVED_SAMPLE = 4096    # elements of each leaf compared before and after
GEMM_TAGS = ("nvjet", "gemm", "cutlass", "xmma")   # cuBLAS kernel names


def train_bound(n_params, n_dense, tokens, n_framed=0, frames=0):
    """(ms, bound_by, flops, bytes): the least time one training step
    could take on the card, the larger of two times: 6 FLOPs per parameter
    per token (a forward and a backward of every product; ``n_dense``, the
    parameters but the embedding table, whose forward is a gather) over
    the bfloat16 dense peak, and Adam's ``ADAM_PASSES`` float32 passes over
    every leaf over the memory rate.  ``n_framed`` of the ``n_dense``
    parameters act on ``frames`` positions in place of ``tokens`` (the
    encdec family's encoder, and the cross-attention K/V projections that
    read its memory)."""
    flops = 6 * ((n_dense - n_framed) * tokens + n_framed * frames)
    nbytes = ADAM_PASSES * 4 * n_params
    t_ops = flops / H100_BF16_OPS_PER_S * 1e3
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes
            else "bytes", flops, nbytes)


def _train_reduced(torch, dev):
    """(a): the reduced configs, card against CPU: the ``jaxrand`` draw
    (float32 and bfloat16 leaves) bitwise, one train step within the
    training tolerances, and a 12-step ``train_loop`` failing at step 9
    and resumed from its step-8 checkpoint against the straight run."""
    import shutil
    from repro_torch.launch import crosscheck
    out = {}
    for arch in TRAIN_ARCHS:
        r = out[arch] = {"init": crosscheck.init_card_against_cpu(arch, dev),
                         "step": crosscheck.train_step_card_against_cpu(
                             arch, dev)}
        st = r["step"]
        log(f"[train] (a) {arch} reduced: the jaxrand draw on the card "
            f"equals the CPU's ({r['init']['leaves']} leaves, float32 and "
            f"bfloat16); one train step card against CPU: loss "
            f"{st['loss_card']:.6f} / {st['loss_cpu']:.6f} (rtol "
            f"{st['loss_rtol']:.2e}), gradients {st['grad_share']:.2e}, mu "
            f"{st['mu_share']:.2e}, nu {st['nu_share']:.2e} of each leaf's "
            f"largest, parameters bit-equal {st['params_equal']:.4f}")
    root = os.path.join(ROOT, "build", "phase17_resume")
    for arch, key in ((TRAIN_ARCHS[0], "resume"), (ENCDEC, "resume_encdec")):
        shutil.rmtree(root, ignore_errors=True)
        rs = out[key] = crosscheck.resume_against_straight(arch, dev, root)
        shutil.rmtree(root, ignore_errors=True)
        log(f"[train] (a) {arch} reduced, 12 steps straight against a "
            f"failure at step 9 resumed from step 8: final loss "
            f"{rs['straight']:.7f} / {rs['resumed']:.7f} (gap "
            f"{rs['gap']:.2e}, within {crosscheck.RESUME_ATOL}); bit for "
            f"bit: {rs['bitwise']} (leaves that differ: "
            f"{rs['leaves_differ']})")
    return out


def _train_full(torch, dev, arch=TRAIN_FULL, n_steps=TRAIN_STEPS,
                part="(b)"):
    """(b), (d): ``train_loop(arch, n_steps, reduced=False)`` at batch
    ``TRAIN_BATCH`` and seq ``TRAIN_SEQ`` on the card, each step timed
    between two synchronisations by a wrapper of the step it builds, the
    draw timed the same way; then one more step under the profiler.  The
    VLM's tokens a step count its prefix frames; the encdec family's
    count its decoder's tokens, its encoder's frames apart
    (``train_bound``)."""
    import gc
    import math
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.base import get_config
    from repro_torch.data.tokens import TokenPipelineConfig, batch_at_step
    from repro_torch.launch import steps, train
    from repro_torch.optim.optimizers import tree_leaves
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    draw_s, step_s, losses, first = [], [], [], []
    make, init = train.make_train_step, train.init_params_for

    def sample(x):
        return x.detach().flatten()[::max(1, x.numel() // MOVED_SAMPLE)]

    def timed_init(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params = init(*args, **kw)
        torch.cuda.synchronize()
        draw_s.append(time.perf_counter() - t0)
        first.extend(sample(x).clone() for x in tree_leaves(params))
        return params

    def timed_make(cfg, optimizer):
        step = make(cfg, optimizer)

        def timed(params, opt_state, batch):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(params, opt_state, batch)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(float(out[2]["loss"]))
            return out
        return timed
    train.make_train_step, train.init_params_for = timed_make, timed_init
    try:
        t0 = time.perf_counter()
        params, metrics = train.train_loop(
            arch, n_steps, reduced=False, batch=TRAIN_BATCH,
            seq=TRAIN_SEQ, device=dev, log_every=1)
        wall = time.perf_counter() - t0
    finally:
        train.make_train_step, train.init_params_for = make, init
    peak = torch.cuda.max_memory_allocated(dev)
    cfg = get_config(arch)
    leaves = tree_leaves(params)
    n_params = sum(x.numel() for x in leaves)
    n_dense = n_params - params["embed"].numel()
    moved = sum(not torch.equal(sample(x), f) for x, f in zip(leaves, first))
    ln_v = math.log(cfg.vocab_size)
    if not (math.isfinite(losses[0]) and 0.5 * ln_v < losses[0] < 2.5 * ln_v):
        raise AssertionError(f"full width: step-1 loss {losses[0]} outside "
                             f"({0.5 * ln_v:.3f}, {2.5 * ln_v:.3f})")
    if not moved or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"full width: losses {losses}, {moved} leaves "
                             f"moved")
    n_framed = frames = 0
    if cfg.family == "encdec":
        tokens = TRAIN_BATCH * TRAIN_SEQ
        frames = TRAIN_BATCH * cfg.frontend_len
        n_framed = sum(x.numel() for x in tree_leaves(params["encoder"])) \
            + params["ln_enc"]["scale"].numel() + sum(
                params["decoder"]["cross_attn"][w]["w"].numel()
                for w in ("wk", "wv"))
    else:
        tokens = TRAIN_BATCH * (cfg.frontend_len + TRAIN_SEQ)
    ms = statistics.median(step_s[1:]) * 1e3
    bound, bound_by, flops, nbytes = train_bound(n_params, n_dense, tokens,
                                                 n_framed, frames)
    # one more step under the profiler: device busy time and launches
    opt = steps.make_optimizer(cfg, steps=n_steps)
    state = opt.init(params)
    pipe = TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH)
    batch = train.model_batch(cfg, *batch_at_step(pipe, n_steps), dev)
    step = steps.make_train_step(cfg, opt)
    torch.cuda.synchronize()
    t_prof = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        out = step(params, state, batch)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t1
    del out, state
    dev_us, rows = device_time(torch, prof)
    prof_s = time.perf_counter() - t_prof
    launches = sum(n for _, n in rows.values())
    top = sorted(rows.items(), key=lambda kv: -kv[1][0])[:8]
    # cuBLAS's products against everything else (PyTorch's elementwise,
    # reduction, copy and index kernels)
    is_gemm = [any(t in k for t in GEMM_TAGS) for k in rows]
    gemm_ms = sum(us for g, (us, _) in zip(is_gemm, rows.values()) if g)
    gemm_n = sum(n for g, (_, n) in zip(is_gemm, rows.values()) if g)
    res = dict(arch=arch, params=n_params, params_dense=n_dense,
               params_framed=n_framed, frames_per_step=frames,
               state_bytes=4 * n_params * 4, param_bytes=4 * n_params,
               checkpoint_bytes=3 * 4 * n_params + 4, draw_s=draw_s[0],
               losses=losses, final=metrics, leaves=len(leaves),
               leaves_moved=moved, step_s=step_s, ms_per_step=ms,
               tokens_per_step=tokens, tokens_per_s=tokens / ms * 1e3,
               bound_ms=bound, bound_by=bound_by, flops=flops,
               adam_bytes=nbytes, peak_bytes=peak, wall_s=wall,
               busy_ms=dev_us / 1e3 if launches else None,
               busy_share=dev_us / 1e6 / prof_wall if launches else None,
               launches_per_step=launches, profiled_step_ms=prof_wall * 1e3,
               gemm_ms=gemm_ms / 1e3, gemm_launches=gemm_n,
               profile_s=prof_s,
               top_device=[(k, us / 1e3, n) for k, (us, n) in top])
    log(f"[train] {part} {arch} full width: {n_params} parameters "
        f"({n_dense} but the embedding table), {4 * n_params} bytes float32, "
        f"{16 * n_params} bytes with gradients and Adam's moments; the "
        f"jaxrand draw {draw_s[0]:.2f} s; losses {losses}; {moved} of "
        f"{len(leaves)} leaves moved; {ms:.2f} ms per step (median of steps "
        f"2-{n_steps}; all {[round(v * 1e3, 2) for v in step_s]}), "
        f"bound {bound:.3f} ms ({bound_by}: {flops:.3e} FLOPs, Adam "
        f"{nbytes} bytes), {tokens} tokens a step ({frames} frames through "
        f"{n_framed} parameters), "
        f"{res['tokens_per_s']:.0f} tokens/s; device busy "
        f"{res['busy_ms']} ms and {launches} launches in a profiled step "
        f"({prof_wall * 1e3:.1f} ms, the profile {prof_s:.1f} s), of which "
        f"cuBLAS products {gemm_ms / 1e3:.2f} ms in {gemm_n} launches; peak "
        f"memory {peak / 1e9:.3f} GB; a checkpoint would hold "
        f"{res['checkpoint_bytes']} bytes (not written)")
    for k, ms_k, n in res["top_device"]:
        log(f"[train] {part} device time {ms_k:.3f} ms in {n} x {k[:90]}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _train_moe(torch, dev):
    """(c): the reduced MoE archs card against CPU (the draw bitwise, one
    train step within the training tolerances, with its routing forks),
    and ``examples/train_lm.py``'s run straight against a run failing at
    ``MOE_EXAMPLE["fail_at"]`` and resumed from its checkpoint."""
    import contextlib
    import io
    import math
    import shutil
    from repro_torch.examples import train_lm
    from repro_torch.launch import crosscheck
    from repro_torch.optim.optimizers import tree_leaves
    out = {}
    for arch in MOE_ARCHS:
        r = out[arch] = {"init": crosscheck.init_card_against_cpu(arch, dev),
                         "step": crosscheck.train_step_card_against_cpu(
                             arch, dev)}
        st = r["step"]
        log(f"[train] (c) {arch} reduced: the jaxrand draw on the card "
            f"equals the CPU's ({r['init']['leaves']} leaves, float32 and "
            f"bfloat16); one train step card against CPU: loss "
            f"{st['loss_card']:.6f} / {st['loss_cpu']:.6f} (rtol "
            f"{st['loss_rtol']:.2e}), gradients {st['grad_share']:.2e}, mu "
            f"{st['mu_share']:.2e}, nu {st['nu_share']:.2e} of each leaf's "
            f"largest, parameters bit-equal {st['params_equal']:.4f}; "
            f"routing forks {st['route_forks']}")
    root = os.path.join(ROOT, "build", "phase17_train_lm")
    shutil.rmtree(root, ignore_errors=True)
    kw = ["--steps", str(MOE_EXAMPLE["steps"]), "--ckpt-every",
          str(MOE_EXAMPLE["ckpt_every"]), "--device", str(dev)]
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        p_a, straight = train_lm.main(
            kw + ["--ckpt-dir", os.path.join(root, "straight")])
        try:
            train_lm.main(kw + ["--ckpt-dir", os.path.join(root, "failed"),
                                "--fail-at", str(MOE_EXAMPLE["fail_at"])])
        except RuntimeError as e:
            if "simulated node failure" not in str(e):
                raise
        else:
            raise AssertionError("train_lm: no simulated failure")
        p_b, resumed = train_lm.main(
            kw + ["--ckpt-dir", os.path.join(root, "failed")])
    wall = time.perf_counter() - t0
    shutil.rmtree(root, ignore_errors=True)
    text = buf.getvalue()
    resumed_at = MOE_EXAMPLE["fail_at"] // MOE_EXAMPLE["ckpt_every"] * \
        MOE_EXAMPLE["ckpt_every"]
    if f"resumed from step {resumed_at}" not in text:
        raise AssertionError(f"train_lm did not resume from {resumed_at}")
    differ = [i for i, (x, y) in enumerate(zip(tree_leaves(p_a),
                                               tree_leaves(p_b)))
              if not torch.equal(x, y)]
    ex = out["example"] = {
        "straight": straight, "resumed": resumed,
        "gap": abs(straight["loss"] - resumed["loss"]),
        "bitwise": straight == resumed and not differ,
        "leaves_differ": differ, "wall_s": wall,
        "losses": [ln for ln in text.splitlines() if "] step" in ln]}
    if not ex["gap"] < crosscheck.RESUME_ATOL:
        raise AssertionError(f"train_lm: resumed {resumed} against "
                             f"{straight}")
    if not all(math.isfinite(v) for v in straight.values()):
        raise AssertionError(f"train_lm: {straight}")
    log(f"[train] (c) examples/train_lm.py ({MOE_ARCHS[0]} reduced, "
        f"{MOE_EXAMPLE['steps']} steps, batch 8, seq 64): straight "
        f"{straight}, failed at {MOE_EXAMPLE['fail_at']} and resumed from "
        f"step {resumed_at}: {resumed} (gap {ex['gap']:.2e}, within "
        f"{crosscheck.RESUME_ATOL}); bit for bit: {ex['bitwise']} (leaves "
        f"that differ: {differ}); the three runs {wall:.1f} s")
    return out


def phase_train(torch, dev):
    """Phase 17: LM training on the card.

    (a) the reduced qwen2.5-14b, starcoder2-15b, internvl2-2b,
        zamba2-1.2b, xlstm-125m and seamless-m4t-medium: the ``jaxrand``
        parameter draw on the card bitwise the CPU's; one train step
        (``make_train_step``, and ``loss_and_grads``' gradients) on the
        card against the CPU from the same float32 parameters and batch,
        within the tolerances the tests hold the CPU step to the JAX
        package with (``launch.crosscheck``, the recurrent families'
        own); and the reference's fault-tolerance test on the card for
        qwen2.5-14b and seamless-m4t-medium: 12 steps of ``train_loop``
        (batch 4, seq 32) straight against a run failing at step 9 and
        resumed from its step-8 checkpoint, final losses within 1e-4, bit
        for bit or not;
    (b) ``train_loop("internvl2-2b", TRAIN_STEPS, reduced=False, batch=8,
        seq=64)``: 24 layers at d 2048, 1.89 B float32 parameters with
        their gradients and Adam's moments on one card, the VLM's 256
        prefix frames ahead of 64 tokens: the draw's wall time, the
        step-1 loss in (0.5 ln V, 2.5 ln V), the parameters moved, ms per
        step (steps 2-6) against ``train_bound``, tokens/s, device busy
        time and launches in a profiled step, peak memory, and the bytes a
        checkpoint would hold (none is written: 23 GB of npz);
    (c) the reduced qwen3-moe-30b-a3b and qwen2-moe-a2.7b: the draws and
        one train step card against CPU (``launch.crosscheck``, its
        routing-fork rule), and ``examples/train_lm.py`` (40 steps at
        batch 8, seq 64, a checkpoint every 10) straight against a run
        failing at step 25 and resumed from step 20, final losses within
        1e-4, bit for bit or not;
    (d) ``train_loop("seamless-m4t-medium", ENCDEC_TRAIN_STEPS,
        reduced=False, batch=8, seq=64)``: 12 + 12 layers at d 1024, 0.877
        B float32 parameters with Adam, 1024 ones frames into the encoder,
        as (b) reports it; (a) holds its reduced config (seeded frames in
        the card / CPU step) and its resume."""
    t0 = time.perf_counter()
    out = {"reduced": _train_reduced(torch, dev)}
    out["a_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    out["full"] = _train_full(torch, dev)
    out["b_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["moe"] = _train_moe(torch, dev)
    out["c_s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    out["encdec_full"] = _train_full(torch, dev, ENCDEC, ENCDEC_TRAIN_STEPS,
                                     "(d)")
    out["d_s"] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    log(f"[train] phase 17 took {out['seconds']:.1f} s: (a) "
        f"{out['a_s']:.1f} s, (b) {out['b_s']:.1f} s, (c) "
        f"{out['c_s']:.1f} s, (d) {out['d_s']:.1f} s")
    return out


LAUNCH_ARCH = "internvl2-2b"                               # (a), (b)
COMPRESS_SLICE = 1 << 20          # (b): elements held card against CPU
LAUNCH_REPS = 3                   # (b): passes over the gradient tree
LAUNCH_ORDER = ("plain", "sharded", "sharded", "plain")


def _to_host(torch, tree):
    from repro_torch.optim.optimizers import tree_map
    return tree_map(lambda x: x.detach().to("cpu", copy=True), tree)


def _same_trees(torch, got, want):
    """Leaves of ``got`` (``DTensor``s whole) bit for bit ``want``'s,
    compared on ``got``'s device, one leaf at a time."""
    from repro_torch.optim.optimizers import tree_leaves
    g, w = tree_leaves(got), tree_leaves(want)
    whole = lambda a: a.full_tensor() if hasattr(a, "full_tensor") else a
    return len(g) == len(w) and all(
        torch.equal(whole(a), b.to(a.device)) for a, b in zip(g, w))


def _launch_step(torch, dev, cfg):
    """(a): the world-1 sharded train step against the plain step."""
    import gc
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import jaxrand
    from repro_torch.data.tokens import TokenPipelineConfig, batch_at_step
    from repro_torch.launch import analysis, elastic, sharded, steps, train
    from repro_torch.launch import mesh as M
    from repro_torch.launch.mesh_policy import MeshPolicy
    from repro_torch.optim.optimizers import OptState, tree_leaves
    mesh = M.make_debug_mesh(1, 1, device=dev)
    policy = MeshPolicy(mesh)
    t0 = time.perf_counter()
    params = steps.init_params_for(cfg, jaxrand.PRNGKey(0, device="cpu"),
                                   device=dev, dtype=torch.float32)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    opt = steps.make_optimizer(cfg)
    state = opt.init(params)
    pipe = TokenPipelineConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH)
    batch = train.model_batch(cfg, *batch_at_step(pipe, 0), dev)
    specs = policy.param_specs(params)
    # the sharded step's state wraps the plain step's tensors (a 1 x 1
    # mesh's shard is the whole leaf): no second copy on the card
    dparams = elastic.reshard_to(mesh, params, specs)
    dstate = OptState(state.step, elastic.reshard_to(mesh, state.mu, specs),
                      elastic.reshard_to(mesh, state.nu, specs))
    runs = {"plain": (steps.make_train_step(cfg, opt), params, state),
            "sharded": (steps.make_train_step(cfg, opt, policy=policy),
                        dparams, dstate)}
    ms = {k: [] for k in runs}
    peak = {k: [] for k in runs}
    first, same, kept = {}, None, None
    out = runs["plain"][0](params, state, batch)         # warm-up, untimed
    del out
    for k in LAUNCH_ORDER:
        step, p, o = runs[k]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        with analysis.count_collectives() as coll:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = step(p, o, batch)
            torch.cuda.synchronize()
            ms[k].append((time.perf_counter() - t1) * 1e3)
        peak[k].append(torch.cuda.max_memory_allocated(dev))
        if k not in first:
            first[k] = coll
            # the plain step's parameters and metrics stay on the card, its
            # moments go to the host: the sharded step's peak has room for
            # 7.6 GB more, not 22.7
            if k == "plain":
                kept = ([out[0], [out[2]["loss"], out[2]["total"]]],
                        _to_host(torch, [out[1].mu, out[1].nu]))
            else:
                same = (out[1].step == 1 and _same_trees(
                    torch, [out[0], [out[2]["loss"], out[2]["total"]]],
                    kept[0]) and _same_trees(torch, [out[1].mu, out[1].nu],
                                             kept[1]))
                kept = None
        del out
    if not same:
        raise AssertionError("launch (a): the world-1 sharded step is not "
                             "the plain step bit for bit")
    launches = {}
    for k, (step, p, o) in runs.items():
        gc.collect()
        torch.cuda.empty_cache()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            out = step(p, o, batch)
            torch.cuda.synchronize()
        del out
        us, rows = device_time(torch, prof)
        launches[k] = (sum(n for _, n in rows.values()), us / 1e3)
    res = dict(arch=cfg.name, params=sum(x.numel()
                                         for x in tree_leaves(params)),
               draw_s=draw_s, ms=ms, peak_bytes=peak, bitwise=same,
               launches={k: v[0] for k, v in launches.items()},
               busy_ms={k: v[1] for k, v in launches.items()},
               collectives=first["sharded"],
               collectives_plan=sharded.train_plan(policy, cfg, params,
                                                   batch))
    log(f"[launch] (a) {cfg.name} full width ({res['params']} parameters, "
        f"drawn in {draw_s:.2f} s), batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
        f"on a 1 x 1 mesh of a world-1 NCCL group: the sharded train step "
        f"equals the plain step bit for bit (parameters, mu, nu, loss, "
        f"total); ms per step plain {[round(v, 2) for v in ms['plain']]}, "
        f"sharded {[round(v, 2) for v in ms['sharded']]}; peak GB plain "
        f"{[round(v / 1e9, 3) for v in peak['plain']]}, sharded "
        f"{[round(v / 1e9, 3) for v in peak['sharded']]}; launches in a "
        f"profiled step plain {res['launches']['plain']}, sharded "
        f"{res['launches']['sharded']} (device busy "
        f"{res['busy_ms']['plain']:.2f} / {res['busy_ms']['sharded']:.2f} "
        f"ms); collective bytes {res['collectives']['total']:.0f} (plan "
        f"{res['collectives_plan']['total']:.0f})")
    del runs, dparams, dstate, state
    return res, params, batch


def _launch_compress(torch, dev, cfg, params, batch):
    """(b): the int8 compressed mean over the full-width gradient tree on
    NCCL, and on a seeded slice against gloo on the CPU."""
    import torch.distributed as dist
    from repro_torch.core import grad_compress as gcmp
    from repro_torch.launch import analysis, steps
    from repro_torch.optim.optimizers import tree_leaves
    _, grads = steps.loss_and_grads(cfg, params, batch)
    leaves = tree_leaves(grads)
    n = sum(x.numel() for x in leaves)
    wall, coll = [], None
    resid = [torch.zeros_like(g) for g in leaves]         # outside the time
    for _ in range(LAUNCH_REPS + 1):                      # a warm-up first
        with analysis.count_collectives() as c:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for g, r0 in zip(leaves, resid):
                out = gcmp.compressed_allreduce_mean(g, r0)
                del out
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        coll = c
    gen = torch.Generator(device="cpu").manual_seed(18)
    big = max(leaves, key=lambda x: x.numel())
    g = big.flatten()[:COMPRESS_SLICE].cpu()
    r = torch.randn(g.shape, generator=gen) * float(g.abs().max()) * 1e-3
    cpu_group = dist.new_group(ranks=[0], backend="gloo")
    m_card, r_card = gcmp.compressed_allreduce_mean(g.to(dev), r.to(dev))
    m_cpu, r_cpu = gcmp.compressed_allreduce_mean(g, r, group=cpu_group)
    same = torch.equal(m_card.cpu(), m_cpu) and torch.equal(r_card.cpu(),
                                                            r_cpu)
    dist.destroy_process_group(cpu_group)
    if not same:
        raise AssertionError("launch (b): the compressed mean on the card "
                             "is not the CPU's bit for bit")
    wall = wall[1:]
    res = dict(elements=n, leaves=len(leaves), ms=wall,
               wire_bytes=dict(coll), float32_ring_bytes=8 * n,
               slice=COMPRESS_SLICE, bitwise=same)
    log(f"[launch] (b) compressed_allreduce_mean over the {cfg.name} "
        f"gradient tree ({len(leaves)} leaves, {n} elements) on NCCL, "
        f"world 1: ms per pass {[round(v, 2) for v in wall]}; wire bytes "
        f"{coll['total']:.0f} (all-to-all {coll['all-to-all']:.0f}, "
        f"all-gather {coll['all-gather']:.0f}, all-reduce "
        f"{coll['all-reduce']:.0f}) against a float32 ring's {8 * n}; "
        f"{COMPRESS_SLICE} seeded elements on the card equal gloo on the "
        f"CPU bit for bit (mean and residual)")
    del grads, leaves, resid
    return res


def _launch_dryrun(torch):
    """(c): the dry run over every arch x shape on both production
    meshes."""
    import collections
    from repro_torch.configs.base import ARCH_IDS, SHAPES
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    recs = dryrun.run_all(ARCH_IDS, list(SHAPES), [False, True], log=log)
    status = collections.Counter(r["status"] for r in recs)
    if status["error"]:
        raise AssertionError(f"launch (c): dry-run errors: {status}")
    dominant = collections.Counter(r["roofline"]["dominant"] for r in recs
                                   if r["status"] == "ok")
    over = [f"{r['arch']} x {r['shape']}"
            + (" (2x16x16)" if r["multi_pod"] else "") for r in recs
            if r["status"] == "ok" and not r["fits_card"]]
    res = dict(counts=dict(status), dominant=dict(dominant), over_card=over,
               seconds=time.perf_counter() - t0,
               cells=[{k: r.get(k) for k in ("arch", "shape", "multi_pod",
                                             "status")}
                      | ({"dominant": r["roofline"]["dominant"],
                          "bound_s": r["roofline"]["bound_s"],
                          "argument_bytes":
                              r["memory_analysis"]["argument_bytes"],
                          "step_floor_bytes":
                              r["memory_analysis"]["step_floor_bytes"]}
                         if r["status"] == "ok" else {})
                      for r in recs])
    log(f"[launch] (c) dry run: {status['ok']} ok, {status['skip']} skip, "
        f"{status['error']} error over {len(recs)} cells in "
        f"{res['seconds']:.1f} s; dominant terms {dict(dominant)}; "
        f"{len(over)} ok cells whose sharded step needs more than one "
        f"card's memory (the whole parameters, and to train the whole "
        f"gradients, on top of the shards): {over}")
    return res


def phase_launch(torch, dev):
    """Phase 18: the LM launch code on the card.

    (a) a world-1 NCCL process group (``launch.mesh.init_distributed``)
        and a 1 x 1 (data, model) mesh: ``internvl2-2b``'s full-width
        train step through ``make_train_step(policy=MeshPolicy(mesh))``,
        its parameters and Adam's moments as ``DTensor``s wrapping the
        plain step's tensors, against the plain step on the same
        parameters and batch (``TRAIN_BATCH`` x ``TRAIN_SEQ``, 256 prefix
        frames): parameters, moments, loss and total bit for bit; ms per
        step of each (``LAUNCH_ORDER``, after an untimed step), peak memory,
        launches and device time in a profiled step of each, and the
        collective bytes (none on one rank) beside the step's plan;
    (b) ``compressed_allreduce_mean`` on NCCL over the full-width gradient
        tree, leaf by leaf (``LAUNCH_REPS`` passes after an untimed one):
        ms per pass and wire
        bytes by op; then ``COMPRESS_SLICE`` elements of the largest
        gradient with a seeded residual on the card against the same
        function on a gloo group on the CPU, bit for bit;
    (c) the dry run (``launch.dryrun.run_all``) over every arch x shape on
        the 16 x 16 and 2 x 16 x 16 meshes: ok / skip / error counts,
        each cell's dominant roofline term, and the ok cells whose
        ``step_floor_bytes`` exceed one card's memory (reported: the
        layout is coherent, the gather-everything step falls short); an
        error fails the phase.
    The process group is destroyed at the end."""
    import torch.distributed as dist
    from repro_torch.configs.base import get_config
    from repro_torch.launch import mesh as M
    t0 = time.perf_counter()
    M.init_distributed(dev)
    try:
        cfg = get_config(LAUNCH_ARCH)
        step, params, batch = _launch_step(torch, dev, cfg)
        t1 = time.perf_counter()
        compress = _launch_compress(torch, dev, cfg, params, batch)
        del params, batch
        t2 = time.perf_counter()
        dry = _launch_dryrun(torch)
    finally:
        dist.destroy_process_group()
    out = {"step": step, "compress": compress, "dryrun": dry,
           "a_s": t1 - t0, "b_s": t2 - t1,
           "c_s": time.perf_counter() - t2,
           "seconds": time.perf_counter() - t0}
    log(f"[launch] phase 18 took {out['seconds']:.1f} s: (a) "
        f"{out['a_s']:.1f} s, (b) {out['b_s']:.1f} s, (c) "
        f"{out['c_s']:.1f} s")
    return out


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", nargs="?", const=ROOT, default=None,
                    metavar="DIR", help="run phase 2 alone, against the "
                    "port in the checkout DIR (default: this one)")
    ap.add_argument("--tiles", nargs="?", const=ROOT, default=None,
                    metavar="DIR", help="run phase 5 alone (K5, K4), "
                    "against the port in the checkout DIR (default: this "
                    "one)")
    ap.add_argument("--sga", nargs="?", const=ROOT, default=None,
                    metavar="DIR", help="build the SGA kernels and run "
                    "phase 4's K3 times alone, against the port in the "
                    "checkout DIR (default: this one)")
    ap.add_argument("--compiled", action="store_true",
                    help="build the kernels and run phase 15 alone")
    ap.add_argument("--examples", action="store_true",
                    help="build the kernels and run phase 16 alone")
    ap.add_argument("--train", action="store_true",
                    help="build the kernels and run phase 17 alone")
    ap.add_argument("--launch", action="store_true",
                    help="build the kernels and run phase 18 alone")
    args = ap.parse_args()
    if sum((args.layers is not None, args.tiles is not None,
            args.sga is not None, args.compiled, args.examples, args.train,
            args.launch)) > 1:
        ap.error("--layers, --tiles, --sga, --compiled, --examples, --train "
                 "and --launch are separate runs")
    root = os.path.abspath(args.layers or args.tiles or args.sga or ROOT)
    sys.path.insert(0, os.path.join(root, "src"))
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

    if args.layers is not None:
        log(f"[layers] the port at {root}")
        smi = card()
        rows, totals, _ = phase_layers(torch, dev)
        print(json.dumps({"card": smi, "root": root, "layers": rows,
                          "totals": totals}), flush=True)
        return 0
    if args.tiles is not None:
        log(f"[tiles] the port at {root}")
        smi = card()
        mav, i8 = phase_mav_kernels(torch, dev)
        print(json.dumps({"card": smi, "root": root, "imc_mav": mav,
                          "int8_matmul": i8}), flush=True)
        return 0
    if args.sga is not None:
        from repro_torch.kernels.sga_update import ops as sga_ops
        log(f"[sga] the port at {root}")
        sga_ops.library()
        smi = card()
        gen = torch.Generator(device=dev).manual_seed(4321)
        k3 = k3_tree_times(torch, gen, dev, paper_leaf_sizes(torch, dev),
                           None)
        print(json.dumps({"card": smi, "root": root, "sga_update": k3}),
              flush=True)
        return 0
    if args.compiled:
        smi = phase_build(torch)
        compiled = phase_compiled(torch, dev)
        print(json.dumps({"card": smi, "compiled": compiled}), flush=True)
        return 0
    if args.examples:
        smi = phase_build(torch)
        examples = phase_examples(torch, dev)
        print(json.dumps({"card": smi, "examples": examples}), flush=True)
        return 0
    if args.train:
        smi = phase_build(torch)
        trained = phase_train(torch, dev)
        print(json.dumps({"card": smi, "train": trained}), flush=True)
        return 0
    if args.launch:
        smi = phase_build(torch)
        launched = phase_launch(torch, dev)
        print(json.dumps({"card": smi, "launch": launched}), flush=True)
        return 0
    smi = phase_build(torch)
    rows, totals, max_err = phase_layers(torch, dev)
    widths = phase_widths(torch, dev)
    max_err = max(max_err, widths["max_abs_err"])
    served = phase_served(torch, dev)
    launches = served["launches"]
    custom = phase_customize(torch, dev)
    rgp = phase_customize_rgp(torch, dev)
    sga = phase_sga_kernels(torch, dev)
    mav, i8 = phase_mav_kernels(torch, dev)
    group = phase_grouploop(torch, dev)
    noisy = phase_noisy_served(torch, dev)
    front = phase_front_door(torch, dev, totals["window"])
    rel = phase_reliability(torch, dev)
    learning = phase_learning(torch, dev)
    pipeline = phase_pipeline(torch, dev)
    obs = phase_obs(torch, dev)
    snap = phase_snapshot(torch, dev)
    sharded = phase_sharded(torch, dev)
    compiled = phase_compiled(torch, dev)
    examples = phase_examples(torch, dev)
    trained = phase_train(torch, dev)
    launched = phase_launch(torch, dev)

    hop = totals["hop"]
    k_ms, p_ms, b_ms, b_by = (hop["ms"], hop["plain_ms"], hop["bound_ms"],
                              hop["bound_by"])
    print(json.dumps({"card": smi, "layers": rows, "layers_totals": totals,
                      "widths": widths,
                      "served": served, "customize": custom, "rgp": rgp,
                      "sga": sga, "imc_mav": mav,
                      "int8_matmul": i8, "grouploop": group,
                      "noisy": noisy, "front_door": front,
                      "reliability": rel, "learning": learning,
                      "pipeline": pipeline, "obs": obs,
                      "snapshot": snap, "sharded": sharded,
                      "compiled": compiled, "examples": examples,
                      "train": trained, "launch": launched}),
          flush=True)
    win = totals["window"]
    w_ms, wp_ms, wb_ms = win["ms"], win["plain_ms"], win["bound_ms"]
    log(f"[summary] {smi}: imc_fused five layers per hop tick (B={B}): "
        f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.5f} ms "
        f"(device time); at a full window: kernel {w_ms:.4f} ms, plain "
        f"{wp_ms:.4f} ms, bound {wb_ms:.5f} ms; {launches} launches on the "
        f"served path")
    fr = front["recompute"]
    k1_shapes = "; ".join(
        f"{name} (B={t['B']}, hop {t['hop']}) {t['ms']:.5f} ms, CUDA events "
        f"{t['call_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms"
        for name, t in totals.items())
    log(f"[summary] {smi}: front door: decisions/s streaming "
        f"{[round(v, 1) for v in fr['wall_dps_streaming']]}, recompute "
        f"{[round(v, 1) for v in fr['wall_dps_recompute']]}; K1 per "
        f"recompute forward {fr['k1_ms_per_forward']:.5f} ms (bound "
        f"{fr['bound_ms']:.5f}); launches {front['launches']}")
    log(f"[summary] {smi}: K1 five layers per shape (phase 2, device time): "
        f"{k1_shapes}")
    hc, ct = rel["health_cost"], rel["canary_tick"]
    log(f"[summary] {smi}: reliability: stuck detected at tick "
        f"{rel['stuck']['detected_tick']} (injected at 4), end state "
        f"{rel['stuck']['state']}, masked {rel['stuck']['masked']}; drift "
        f"detected at {rel['drift']['detected_tick']}, end state "
        f"{rel['drift']['state']}; decisions/s health off "
        f"{[round(v, 1) for v in hc['wall_dps_off']]}, on (interval "
        f"{REL_INTERVAL}) {[round(v, 1) for v in hc['wall_dps_on']]}; K1 "
        f"in the canary tick {ct['k1_ms_with']} ms, without "
        f"{ct['k1_ms_without']} ms; launches {rel['launches']}")
    t23, rep_ = pipeline["table23"], pipeline["chip_report"]
    log(f"[summary] {smi}: pipeline: train_base {pipeline['train']['steps']} "
        f"steps, {pipeline['train']['ms_per_step']:.1f} ms/step; Table II/III "
        + ", ".join(f"{k} {v:.4f}" for k, v in t23.items())
        + "; Table IV " + ", ".join(f"{k} {v:.4f}" for k, v in
                                    pipeline["table4"].items())
        + f"; chip report {rep_['uj_per_decision']:.3f} uJ/decision, "
        f"{rep_['tops_per_w']:.4f} TOPS/W; K1 {pipeline['launches']} "
        f"launches; peak memory "
        f"{pipeline['max_memory_bytes'] / 2 ** 30:.2f} GiB; "
        f"{pipeline['seconds']:.1f} s")
    log(f"[summary] {smi}: telemetry: wall decisions/s off "
        f"{[round(v, 1) for v in obs['wall_dps_off']]}, on "
        f"{[round(v, 1) for v in obs['wall_dps_on']]} (median on / off "
        f"{obs['median_ratio']:.3f}); K1 {obs['launches']} launches with "
        f"telemetry on, each counted by the auditor")
    log(f"[summary] {smi}: snapshots: {snap['bytes_8_slots']} bytes at 8 "
        f"live slots, snapshot(path) {snap['snapshot_ms_median']:.2f} ms, "
        f"restore(path) {snap['restore_ms_median']:.2f} ms (medians of "
        f"{SNAP_REPS}); K1 {snap['launches_after']} launches after the "
        f"restore ({snap['launches_uninterrupted']} uninterrupted); "
        f"{snap['sessions']} sessions restored mid-flight bit for bit, "
        f"head_train_rows {snap['launches_head']} launches")
    log(f"[summary] {smi}: sharded fleet ({SHARD_POOLS} pools x "
        f"{SHARD_SLOTS} slots on one card): wall decisions/s sequential "
        f"{[round(v, 1) for v in sharded['wall_dps']['sequential']]}, "
        f"parallel {[round(v, 1) for v in sharded['wall_dps']['parallel']]}"
        f", single server "
        f"{[round(v, 1) for v in sharded['wall_dps']['single']]}; K1 "
        f"{sharded['launches']} launches in the clean fleet run")
    cd = compiled["wall_dps"]
    log(f"[summary] {smi}: compiled ticks (block {COMPILED_BLOCK}): wall "
        f"decisions/s clean interpreted "
        f"{[round(v, 1) for v in cd['clean']['interpreted']]}, compiled "
        f"{[round(v, 1) for v in cd['clean']['compiled']]} (median ratio "
        f"{cd['clean']['median_ratio']:.3f}); noisy interpreted "
        f"{[round(v, 1) for v in cd['noisy']['interpreted']]}, compiled "
        f"{[round(v, 1) for v in cd['noisy']['compiled']]} (median ratio "
        f"{cd['noisy']['median_ratio']:.3f}); device busy share "
        f"{compiled['busy']['compiled']['share']:.4f} compiled, "
        f"{compiled['busy']['interpreted']['share']:.4f} interpreted; K1 "
        f"{compiled['launches']} launches in the clean compiled run")
    ex, lm_full = examples["examples"], examples["full"]
    log(f"[summary] {smi}: examples at full size (phase 16): "
        + "; ".join(f"{k} {v['wall_s']:.2f} s, K1 "
                    f"{v['launches']['imc_fused']}, head_train_rows "
                    f"{v['launches']['head_train_rows']}"
                    for k, v in ex.items()))
    log(f"[summary] {smi}: LM server {LM_FULL} full width: "
        f"{lm_full['param_bytes']} parameter bytes, peak "
        f"{lm_full['peak_bytes']} bytes; {lm_full['ms_per_step_wall']:.3f} "
        f"ms per decode step (greedy step median "
        f"{lm_full['ms_per_greedy_step']:.3f} ms, device busy "
        f"{lm_full['busy_ms_per_step']} ms, "
        f"{lm_full['launches_per_step']:.0f} launches), bound "
        f"{lm_full['bound_ms']:.3f} ms; {lm_full['tokens_per_s']:.2f} "
        f"tokens/s; reduced card against CPU (ulps): "
        + ", ".join(f"{a} prefill {r['prefill_ulps']:.2f} decode "
                    f"{r['decode_ulps']:.2f}"
                    for a, r in examples["reduced"].items()))
    tf, tr = trained["full"], trained["reduced"]
    log(f"[summary] {smi}: LM training {TRAIN_FULL} full width: "
        f"{tf['params']} parameters, draw {tf['draw_s']:.2f} s, step-1 loss "
        f"{tf['losses'][0]:.4f}; {tf['ms_per_step']:.2f} ms per step "
        f"(bound {tf['bound_ms']:.3f} ms, {tf['bound_by']}), "
        f"{tf['tokens_per_s']:.0f} tokens/s, device busy {tf['busy_ms']} ms "
        f"and {tf['launches_per_step']} launches a step, peak "
        f"{tf['peak_bytes']} bytes; reduced resume bit for bit: "
        f"{tr['resume']['bitwise']}; full-width LM server draw "
        f"{lm_full['init_s']:.2f} s")
    for arch, rf in examples["recurrent_full"].items():
        log(f"[summary] {smi}: recurrent server {arch} full width: "
            f"{rf['params']} parameters, {rf['param_bytes']} bytes, draw "
            f"{rf['init_s']:.2f} s, peak {rf['peak_bytes']} bytes; "
            f"{rf['ms_per_step_wall']:.3f} ms per decode step (greedy step "
            f"median {rf['ms_per_greedy_step']:.3f} ms, device busy "
            f"{rf['busy_ms_per_step']} ms, {rf['launches_per_step']:.0f} "
            f"launches) beside the bound {rf['bound_ms']:.4f} ms "
            f"({rf['bound_by']}); {rf['tokens_per_s']:.2f} tokens/s; step 0 "
            f"against the 1-token prefill {rf['one_token_ulps']:.2f} ulps, "
            f"forward against decode {rf['forward_ulps']:.2f} ulps")
    ef, et = examples["encdec_full"], trained["encdec_full"]
    er = examples["reduced"][ENCDEC]
    log(f"[summary] {smi}: encoder-decoder {ENCDEC} full width: "
        f"{ef['params']} parameters, {ef['param_bytes']} bytes, draw "
        f"{ef['init_s']:.2f} s, peak {ef['peak_bytes']} bytes; encode plus "
        f"prefill {ef['prefill_busy_ms']} ms device, "
        f"{ef['prefill_launches']} launches; "
        f"{ef['ms_per_step_wall']:.3f} ms per decode step (greedy step "
        f"median {ef['ms_per_greedy_step']:.3f} ms, device busy "
        f"{ef['busy_ms_per_step']} ms, {ef['launches_per_step']} launches) "
        f"beside the bound {ef['bound_ms']:.4f} ms ({ef['bound_by']}); "
        f"{ef['tokens_per_s']:.2f} tokens/s; gates: prefill against the "
        f"step {ef['prefill_vs_step_ulps']:.2f}, K/V against the cache "
        f"{ef['prefill_kv_vs_cache_ulps']:.2f}, forward against decode "
        f"{ef['forward_vs_decode_ulps']:.2f} ulps; reduced card against CPU "
        f"prefill {er['prefill_ulps']:.2f} decode {er['decode_ulps']:.2f} "
        f"memory {er['memory_ulps']:.2f} ulps; training "
        f"{et['ms_per_step']:.2f} ms per step (bound {et['bound_ms']:.3f} "
        f"ms, {et['bound_by']}), {et['tokens_per_s']:.0f} tokens/s, device "
        f"busy {et['busy_ms']} ms and {et['launches_per_step']} launches a "
        f"step, peak {et['peak_bytes']} bytes; reduced resume bit for bit: "
        f"{trained['reduced']['resume_encdec']['bitwise']}")
    mf, tm = examples["moe_full"], trained["moe"]
    log(f"[summary] {smi}: MoE server {LM_MOE_FULL} full width: "
        f"{mf['params']} parameters, {mf['param_bytes']} bytes, draw "
        f"{mf['init_s']:.2f} s, peak {mf['draw_peak_bytes']} bytes after "
        f"the draw, {mf['peak_bytes']} after serving; decode step 0 against "
        f"the 1-token prefill {mf['one_token_ulps']:.2f} ulps, layer 0's "
        f"MoE block against the plain one {mf['layer_ulps']:.2f} ulps; "
        f"{mf['ms_per_step_wall']:.3f} ms per decode step (greedy step "
        f"median {mf['ms_per_greedy_step']:.3f} ms, device busy "
        f"{mf['busy_ms_per_step']} ms, {mf['launches_per_step']:.0f} "
        f"launches) beside bounds {mf['bound_ms']:.3f} ms (dense dispatch) "
        f"and {mf['routed_bound_ms']:.3f} ms (routed only); "
        f"{mf['tokens_per_s']:.2f} tokens/s; prefill dropped "
        f"{mf['prefill_dropped']} of {mf['prefill_choices']} choices; MoE "
        f"training: routing forks "
        + ", ".join(f"{a} {tm[a]['step']['route_forks']}" for a in MOE_ARCHS)
        + f"; train_lm resumed bit for bit: {tm['example']['bitwise']}")
    la, lb, lc = (launched["step"], launched["compress"],
                  launched["dryrun"])
    log(f"[summary] {smi}: launch (phase 18): {LAUNCH_ARCH} full-width "
        f"sharded train step on a world-1 1 x 1 mesh bit for bit the plain "
        f"step: {la['bitwise']}; ms per step plain "
        f"{[round(v, 2) for v in la['ms']['plain']]}, sharded "
        f"{[round(v, 2) for v in la['ms']['sharded']]}; peak GB plain "
        f"{[round(v / 1e9, 3) for v in la['peak_bytes']['plain']]}, sharded "
        f"{[round(v / 1e9, 3) for v in la['peak_bytes']['sharded']]}; "
        f"compressed mean over the gradient tree "
        f"{[round(v, 2) for v in lb['ms']]} ms, "
        f"{lb['wire_bytes']['total']:.0f} wire bytes; dry run "
        f"{lc['counts']}, dominant {lc['dominant']}, "
        f"{len(lc['over_card'])} ok cells over one card's memory")
    r2 = sga["sga_update_rows"]
    log(f"[summary] {smi}: sga_update_rows B=2 x 5770: kernel "
        f"{r2['ms']:.5f} ms, plain {r2['plain_ms']:.5f} ms, bound "
        f"{r2['bound_ms']:.6f} ms (device time); {rgp['launches_rows']} "
        f"launches in the RGP session ({rgp['epochs']} epochs)")
    k3 = sga["sga_update"]
    log(f"[summary] {smi}: sga_update (K3) " + "; ".join(
        f"{label} ({t['leaves']} leaves, N={t['N']}): kernel {t['ms']:.5f} "
        f"ms in {t['launches']} launch(es), plain {t['plain_ms']:.5f} ms, "
        f"bound {t['bound_ms']:.6f} ms"
        for label, t in [("n5770", k3), *k3["trees"].items()])
        + " (device time; CUDA events at 2**26 and where the profile read "
        "under the bound)")
    ht = sga["head_train_rows"]
    log(f"[summary] {smi}: head_train_rows B=3 x N=10, budgets "
        f"{list(PER_TICK)}: kernel {ht['ms']:.5f} ms, plain "
        f"{ht['plain_ms']:.4f} ms, bound {ht['bound_ms']:.6f} ms (device "
        f"time); {custom['launches_head']} launches on the customization "
        f"path ({custom['train_ticks']} training ticks, "
        f"{custom['rounds']} rounds)")
    kernels = [{
        "name": "imc_fused", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "launches_front_door": front["launches"],
        "launches_reliability": rel["launches"],
        "launches_pipeline": pipeline["launches"],
        "launches_obs": obs["launches"],
        "launches_snapshot": snap["launches_after"],
        "launches_sharded": sharded["launches"],
        "launches_compiled": compiled["launches"],
        "launches_examples": sum(v["launches"]["imc_fused"]
                                 for v in ex.values())}]
    for name, n in (("head_train_rows", custom["launches_head"]),
                    ("sga_update_rows", rgp["launches_rows"]),
                    ("sga_update", custom["launches_flat"])):
        row = sga[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SGA_SOURCE,
            "replaces": SGA_REPLACES[name], "launches": n,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None})
    kernels[1]["launches_sessions4"] = snap["launches_head"]
    kernels[1]["launches_examples"] = sum(
        v["launches"]["head_train_rows"] for v in ex.values())
    log(f"[summary] {smi}: imc_mav, one per-group forward's "
        f"{group['launches']['imc_mav']} launches (B={B}): kernel "
        f"{mav['ms']:.4f} ms, plain {mav['plain_ms']:.4f} ms, float32 "
        f"torch.matmul (product only) {mav['matmul_ms']:.4f} ms, bound "
        f"{mav['bound_ms']:.5f} ms (device time)")
    head = i8["rows"][1]
    log(f"[summary] {smi}: int8_matmul at the head shape 8x576x10: kernel "
        f"{head['ms']:.5f} ms, plain {head['plain_ms']:.5f} ms, "
        f"torch._int_mm (padded, product only) {head['library_ms']:.5f} ms, "
        f"bound {head['bound_ms']:.6f} ms (device time)")
    kernels.append({
        "name": "imc_mav", "route": "cuda", "source": MAV_SOURCE,
        "replaces": MAV_REPLACES,
        "launches": group["launches"]["imc_mav"],
        "max_abs_err": mav["max_abs_err"], "ms": mav["ms"],
        "plain_ms": mav["plain_ms"], "bound_ms": mav["bound_ms"],
        "bound_by": mav["bound_by"], "library_ms": mav["matmul_ms"]})
    kernels.append({
        "name": "int8_matmul", "route": "cuda", "source": I8_SOURCE,
        "replaces": I8_REPLACES,
        "launches": group["launches"]["int8_matmul"],
        "max_abs_err": i8["max_abs_err"], "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
