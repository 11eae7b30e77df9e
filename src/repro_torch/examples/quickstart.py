"""Quickstart: the paper's pipeline end to end (the port of
``examples/quickstart.py``).

  1. synthesize a keyword corpus,
  2. train the IMC-aware BNN briefly (annealed binarization),
  3. fold to the hardware path (in-memory BN grid),
  4. inject chip noise -> bias compensation,
  5. customize the classifier head on-chip (error scaling + SGA + RGP).

Every hardware-path accuracy and feature runs through the fused IMC
kernel (K1, ``imc_fused``; its plain version on the CPU), where the
reference takes the plain route; ``main`` returns the arguments of those
calls, so that a caller can hold the two routes equal on them
(``chip_smoke.py`` phase 16 does, on the card).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The reference's quickstart has no smoke mode.  ``REPRO_EXAMPLES_SMOKE=1``
runs this one at a smoke size of its own (a 640-sample window, 40
training windows, 2 epochs, 40 head epochs), for the port's CPU test
only.
"""

import torch

from repro_torch.core import imc, jaxrand
from repro_torch.core.onchip_training import (OnChipTrainConfig,
                                              head_accuracy,
                                              quantized_head_finetune)
from repro_torch.data import audio
from repro_torch.examples import device_arg, smoke
from repro_torch.kernels import resolve_device
from repro_torch.models import kws as m
from repro_torch.training import kws as tr


def sizes(smoke_run: bool) -> dict:
    if smoke_run:
        return dict(L=640, train_per_class=4, test_per_class=2, epochs=2,
                    batch_size=40, n_cal=20, personal_test=2,
                    head_epochs=40)
    return dict(L=1000, train_per_class=16, test_per_class=6, epochs=18,
                batch_size=80, n_cal=100, personal_test=4, head_epochs=400)


def main(argv=None) -> dict:
    dev = resolve_device(device_arg(__doc__.split("\n")[0], argv))
    z = sizes(smoke())
    L = z["L"]
    cfg = m.KWSConfig(sample_len=L)
    hw_kw = dict(use_kernel=True, device=dev)
    (xtr, ytr), (xte, yte) = audio.make_gscd_like(
        train_per_class=z["train_per_class"],
        test_per_class=z["test_per_class"], length=L)
    print("== 1) train (smoke budget) ==")
    tcfg = tr.TrainConfig(epochs=z["epochs"], batch_size=z["batch_size"],
                          lr=3e-3, log_every=z["epochs"],
                          alpha_schedule=((0.35, 2.0), (0.55, 5.0),
                                          (0.7, 12.0), (1.0, -8.0)))
    params, state = tr.train_base(xtr, ytr, cfg, tcfg, device=dev)

    print("== 2) fold to hardware ==")
    hw = m.fold_params(params, state, cfg)
    print("   hw accuracy:", tr.evaluate_hw(hw, xte, yte, cfg, **hw_kw))

    print("== 3) chip noise + compensation ==")
    chans = {f"conv{i}": cfg.channels[i]
             for i in range(1, cfg.num_conv_layers)}
    noise = imc.IMCNoiseParams(mav_offset_std=8.0, sa_noise_std=1.0)
    offs = imc.sample_chip_offsets(jaxrand.PRNGKey(0, device=dev), chans,
                                   noise)
    noisy = dict(chip_offsets=offs, sa_noise_std=1.0)
    print("   noisy   :", tr.evaluate_hw(hw, xte, yte, cfg, **noisy,
                                         **hw_kw))
    hw_c = tr.calibrate_and_compensate(hw, xtr[:z["n_cal"]], offs, cfg,
                                       device=dev)
    print("   compensated:", tr.evaluate_hw(hw_c, xte, yte, cfg, **noisy,
                                            **hw_kw))

    print("== 4) on-chip customization (personal set) ==")
    (xp_tr, yp_tr), (xp_te, yp_te) = audio.make_personal(
        train_per_class=3, test_per_class=z["personal_test"], length=L,
        accent_shift=0.18)
    f_tr = tr.hw_features(hw_c, xp_tr, cfg, **noisy, **hw_kw)
    f_te = tr.hw_features(hw_c, xp_te, cfg, **noisy, **hw_kw)
    print("   before:", tr.evaluate_hw(hw_c, xp_te, yp_te, cfg, **noisy,
                                       **hw_kw))
    ocfg = OnChipTrainConfig(epochs=z["head_epochs"], error_scaling=True,
                             sga=True, rgp=True)
    w, b = quantized_head_finetune(f_tr, yp_tr, hw_c.fc_w, hw_c.fc_b, ocfg,
                                   device=dev)
    print("   after :", float(head_accuracy(
        f_te, torch.as_tensor(yp_te), w, b, ocfg)))
    # the hardware-path calls above: (what, net, windows, noise arguments)
    return {"cfg": cfg, "calls": [
        ("hw accuracy", hw, xte, {}), ("noisy", hw, xte, noisy),
        ("compensated", hw_c, xte, noisy),
        ("personal train", hw_c, xp_tr, noisy),
        ("personal test", hw_c, xp_te, noisy)]}


if __name__ == "__main__":
    main()
