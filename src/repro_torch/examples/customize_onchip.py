"""On-chip customization ablation (the paper's Table IV) on a trained
model, plus the same loop run as a serving workload (an enrollment session
on the StreamServer), asserted bit-identical: the port of
``examples/customize_onchip.py``.

Trains briefly (the reference's cached ``results/kws_model.pkl`` holds JAX
arrays and is not read here).  Shows each technique's contribution:
full-precision baseline vs naive-quantized vs +error-scaling vs +SGA vs
+RGP.  The offline loop takes its features on the plain route, as the
reference's does; the enrollment session serves through the fused IMC
kernel (K1) and trains through the fused head training
(``head_train_rows``), so its bit-identity assert holds the kernels to the
plain route.  ``main`` returns the arguments of the offline loop's
hardware-path calls.

Run:  PYTHONPATH=src python -m repro_torch.examples.customize_onchip \\
          [--device cpu]
      REPRO_EXAMPLES_SMOKE=1 ... for a seconds-scale smoke run
"""

import numpy as np
import torch

from repro_torch.core.onchip_training import (OnChipTrainConfig,
                                              head_accuracy,
                                              quantized_head_finetune)
from repro_torch.data import audio
from repro_torch.examples import device_arg, smoke
from repro_torch.kernels import resolve_device
from repro_torch.models import kws as m
from repro_torch.serving import CustomizeConfig, StreamServer
from repro_torch.training import kws as tr

VARIANTS = {
    "baseline (fp32)": dict(quantized=False),
    "quantized naive": dict(error_scaling=False, sga=False),
    "+ error scaling": dict(error_scaling=True, sga=False),
    "+ SGA": dict(error_scaling=True, sga=True),
    "+ RGP": dict(error_scaling=True, sga=True, rgp=True),
}


def main(argv=None) -> dict:
    dev = resolve_device(device_arg(__doc__.split("\n")[0], argv))
    smoke_run = smoke()
    L = 640 if smoke_run else 2000
    hop = 64 if smoke_run else 256
    epochs = 40 if smoke_run else 600
    cfg = m.KWSConfig(sample_len=L)
    (xtr, ytr), _ = audio.make_gscd_like(
        train_per_class=4 if smoke_run else 24, test_per_class=2, length=L)
    params, state = tr.train_base(
        xtr, ytr, cfg,
        tr.TrainConfig(epochs=2 if smoke_run else 24,
                       batch_size=40 if smoke_run else 80, lr=3e-3),
        verbose=not smoke_run, device=dev)

    # fold once (packed: the fused kernel's operands are precomputed here,
    # not per evaluation call) and reuse the same parameters everywhere
    hw = m.fold_params(params, state, cfg, pack=True)
    (xp_tr, yp_tr), (xp_te, yp_te) = audio.make_personal(
        train_per_class=3, test_per_class=2 if smoke_run else 6, length=L,
        accent_shift=0.18)
    f_tr = tr.hw_features(hw, xp_tr, cfg, device=dev)
    f_te = tr.hw_features(hw, xp_te, cfg, device=dev)
    print(f"before customization: "
          f"{tr.evaluate_hw(hw, xp_te, yp_te, cfg, device=dev):.3f}")
    for name, kw in VARIANTS.items():
        ocfg = OnChipTrainConfig(epochs=epochs, **kw)
        w, b = quantized_head_finetune(f_tr, yp_tr, hw.hw.fc_w, hw.hw.fc_b,
                                       ocfg, device=dev)
        acc = float(head_accuracy(f_te, torch.as_tensor(yp_te), w, b, ocfg))
        print(f"{name:18s}: {acc:.3f}")

    # --- the same loop as a serving workload: an enrollment session -------
    # A few personal utterances enroll through a live stream; the fine-tune
    # runs as scheduler-ticked background jobs.  With compensation off (no
    # chip offsets here) the session must land on exactly the offline
    # loop's head.
    n_enroll = 6 if smoke_run else 10
    utts, labs = xp_tr[:n_enroll], yp_tr[:n_enroll]
    tcfg = OnChipTrainConfig(epochs=epochs, error_scaling=True, sga=True)
    srv = StreamServer(hw, cfg, hop=hop, slots=4, use_kernel=True,
                       device=dev)
    sess = srv.customize("mic0", CustomizeConfig(train=tcfg,
                                                 compensate=False,
                                                 epochs_per_tick=32))
    for wav, lab in zip(utts, labs):
        sess.enroll(int(lab), wav)
    sess.finish_enrollment()
    steps = 0
    while not sess.done:
        srv.step()
        steps += 1
        assert steps < 2000, f"session stuck in phase {sess.phase}"
    f_sub = tr.hw_features(hw, utts, cfg, device=dev)
    w_ref, b_ref = quantized_head_finetune(f_sub, labs, hw.hw.fc_w,
                                           hw.hw.fc_b, tcfg, device=dev)
    assert np.array_equal(np.asarray(sess.result.fc_w),
                          w_ref.cpu().numpy())
    assert np.array_equal(np.asarray(sess.result.fc_b),
                          b_ref.cpu().numpy())
    print(f"enrollment session   : {n_enroll} utterances, {steps} scheduler "
          f"ticks, bit-identical to the offline loop; "
          f"{sess.result.energy['uj_per_finetune_step']:.1f} "
          f"uJ/fine-tune step")
    # the offline loop's hardware-path calls: (what, net, windows, noise)
    return {"cfg": cfg, "calls": [("personal train", hw, xp_tr, {}),
                                  ("personal test", hw, xp_te, {})]}


if __name__ == "__main__":
    main()
