"""Analytical energy model of the KWS accelerator (paper §VI-B) — the chip
report and the parts the streaming server's ``stats()`` and the
customization sessions report.

Own copy of the serving and customization half of ``repro/core/energy.py``
(constants and formulas unchanged): per-event energies fitted to the
paper's anchors (14.3 uJ/decision at 1 MHz, leakage ~61.8 uW, 160k
cycles/decision, 765k cycles per training epoch), the chip report's
power, operations, TOPS/W and dynamic-energy breakdown, the streaming
per-decision report and its side-by-side with the offline (recompute)
one, the duty-cycled VAD-gated summary, the on-chip fine-tuning energy
and the energy of a self-healing recompensation pass.  These are
modelled chip numbers, not measurements of any device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

LEAKAGE_W = 61.8e-6            # static power, whole chip
CYCLES_PER_DECISION = 160_000  # 160 ms @ 1 MHz
CYCLES_PER_TRAIN_EPOCH = 765_000  # 765 ms @ 1 MHz

E_IMC_MAC = 1.3e-15            # one ±1 MAC inside the array
E_DIG_MAC8 = 0.6e-12           # 8-bit digital MAC (L1 sinc PEs, FC)
E_SRAM_RD_BIT = 0.6e-12        # SRAM buffer read, per bit
E_SRAM_WR_BIT = 0.7e-12
E_CTRL_CYCLE = 12.0e-12        # IMC controller + FSM, per cycle
E_LUT_LOOKUP = 0.8e-12         # exp LUT access (training)
E_DIV8 = 1.6e-12               # 8-bit divider op (training)

AREA_MM2 = 1.0
AREA_FRAC = {"imc_macros": 0.70, "digital": 0.19, "buffers": 0.11}
TRAIN_AREA_FRAC = 0.05         # +9187 gates


@dataclasses.dataclass
class LayerEnergy:
    name: str
    kind: str                   # 'digital' | 'imc' | 'fc'
    macs: int
    sram_read_bits: int
    sram_write_bits: int
    ctrl_cycles: int

    @property
    def dynamic_j(self) -> float:
        e_mac = {"digital": E_DIG_MAC8, "imc": E_IMC_MAC,
                 "fc": E_DIG_MAC8}[self.kind]
        return (self.macs * e_mac
                + self.sram_read_bits * E_SRAM_RD_BIT
                + self.sram_write_bits * E_SRAM_WR_BIT
                + self.ctrl_cycles * E_CTRL_CYCLE)


@dataclasses.dataclass
class ChipReport:
    layers: List[LayerEnergy]
    freq_hz: float = 1e6
    # None -> the paper's full-window 160k cycles; the streaming report
    # passes its per-hop cycle count
    cycles_per_decision: Optional[int] = None

    @property
    def dynamic_j_per_decision(self) -> float:
        return sum(layer.dynamic_j for layer in self.layers)

    @property
    def latency_s(self) -> float:
        cycles = (CYCLES_PER_DECISION if self.cycles_per_decision is None
                  else self.cycles_per_decision)
        return cycles / self.freq_hz

    @property
    def energy_j_per_decision(self) -> float:
        return self.dynamic_j_per_decision + LEAKAGE_W * self.latency_s

    @property
    def power_w(self) -> float:
        return self.energy_j_per_decision / self.latency_s

    @property
    def total_ops(self) -> int:
        return sum(2 * layer.macs for layer in self.layers)  # 1 MAC = 2 ops

    @property
    def tops_per_w(self) -> float:
        return (self.total_ops / self.energy_j_per_decision) / 1e12

    def breakdown(self) -> Dict[str, float]:
        """Each layer's share of the dynamic energy per decision."""
        total = self.dynamic_j_per_decision
        return {layer.name: layer.dynamic_j / total
                for layer in self.layers}


def kws_chip_report(layer_stats: List[dict],
                    freq_hz: float = 1e6) -> ChipReport:
    """Report from per-layer op counts ({name, kind, macs, in_bits,
    out_bits, cycles} rows, ``models.kws.layer_stats``)."""
    return ChipReport(layers=[
        LayerEnergy(name=s["name"], kind=s["kind"], macs=s["macs"],
                    sram_read_bits=s.get("in_bits", 0),
                    sram_write_bits=s.get("out_bits", 0),
                    ctrl_cycles=s.get("cycles", 0))
        for s in layer_stats], freq_hz=freq_hz)


def kws_streaming_report(streaming_stats: List[dict],
                         freq_hz: float = 1e6) -> ChipReport:
    """Per-decision report of the frame-incremental path: leakage is
    charged for the summed per-hop cycles, not the full-window 160k."""
    rep = kws_chip_report(streaming_stats, freq_hz)
    rep.cycles_per_decision = max(1, sum(int(s.get("cycles", 0))
                                         for s in streaming_stats))
    return rep


def streaming_energy_summary(offline_stats: List[dict],
                             streaming_stats: List[dict],
                             freq_hz: float = 1e6) -> dict:
    """Offline (recompute) vs streaming energy per decision side by
    side."""
    off = kws_chip_report(offline_stats, freq_hz)
    strm = kws_streaming_report(streaming_stats, freq_hz)
    return {
        "freq_hz": freq_hz,
        "offline_uj_per_decision": off.energy_j_per_decision * 1e6,
        "streaming_uj_per_decision": strm.energy_j_per_decision * 1e6,
        "energy_ratio": (strm.energy_j_per_decision
                         / off.energy_j_per_decision),
        "offline_dynamic_uj": off.dynamic_j_per_decision * 1e6,
        "streaming_dynamic_uj": strm.dynamic_j_per_decision * 1e6,
    }


def vad_stats(hop_samples: int) -> dict:
    """Op counts of the always-on VAD front end per hop (one 8-bit MAC,
    one buffered-sample read and one controller cycle per sample)."""
    return {"name": "vad", "kind": "digital", "macs": int(hop_samples),
            "in_bits": int(hop_samples * 8), "out_bits": 8,
            "cycles": int(hop_samples)}


def gated_energy_summary(offline_stats: List[dict],
                         streaming_stats: List[dict], *,
                         hop_samples: int, duty_cycle: float,
                         freq_hz: float = 1e6) -> dict:
    """Duty-cycled energy of the VAD-gated always-on path: every hop runs
    the VAD; a speech hop also runs the streaming IMC stack; a gated hop
    is charged the VAD's dynamic energy and leakage only."""
    if not 0.0 <= duty_cycle <= 1.0:
        raise ValueError(f"duty_cycle={duty_cycle} must be in [0, 1]")
    off = kws_chip_report(offline_stats, freq_hz)
    strm = kws_streaming_report(streaming_stats, freq_hz)
    v = vad_stats(hop_samples)
    vad_dynamic_j = LayerEnergy(
        name=v["name"], kind=v["kind"], macs=v["macs"],
        sram_read_bits=v["in_bits"], sram_write_bits=v["out_bits"],
        ctrl_cycles=v["cycles"]).dynamic_j
    vad_leak_j = LEAKAGE_W * v["cycles"] / freq_hz
    idle_j = vad_dynamic_j + vad_leak_j
    active_j = strm.energy_j_per_decision + idle_j
    gated_j = duty_cycle * active_j + (1.0 - duty_cycle) * idle_j
    offline_j = off.energy_j_per_decision
    return {
        "freq_hz": freq_hz,
        "duty_cycle": duty_cycle,
        "hop_samples": hop_samples,
        "offline_uj_per_decision": offline_j * 1e6,
        "ungated_uj_per_decision": active_j * 1e6,
        "idle_uj_per_hop": idle_j * 1e6,
        "vad_dynamic_uj": vad_dynamic_j * 1e6,
        "vad_leakage_uj": vad_leak_j * 1e6,
        "gated_uj_per_decision": gated_j * 1e6,
        "reduction_vs_ungated": active_j / gated_j,
        "reduction_vs_offline": offline_j / gated_j,
    }


def training_energy_j(num_epochs: int, freq_hz: float = 1e6,
                      macs_per_epoch: int = 0, lut_ops: int = 0,
                      div_ops: int = 0, sram_bits: int = 0) -> float:
    """Energy of an on-chip customization run (training power ~105uW @1MHz)."""
    t = num_epochs * CYCLES_PER_TRAIN_EPOCH / freq_hz
    dyn = (macs_per_epoch * E_DIG_MAC8 + lut_ops * E_LUT_LOOKUP
           + div_ops * E_DIV8 + sram_bits * (E_SRAM_RD_BIT + E_SRAM_WR_BIT)
           ) * num_epochs
    return dyn + LEAKAGE_W * t


def customization_energy_summary(n_utts: int, feat_dim: int,
                                 num_classes: int, epochs: int,
                                 freq_hz: float = 1e6) -> dict:
    """Analytical energy of one on-chip customization run (§V-C).  One
    fine-tune step is one full-batch epoch over the SRAM feature buffer:
    the 8-bit FC forward, the LUT softmax and 8-bit division, the error and
    gradient passes (~2x the forward MACs), the feature-buffer reads and
    the weight / SGA-bank read-modify-write."""
    macs = n_utts * (feat_dim * num_classes + num_classes) * 3
    lut = n_utts * num_classes
    div = n_utts * num_classes
    sram = (n_utts * feat_dim * 8                      # feature buffer read
            + feat_dim * num_classes * 8 * 2           # weight r/w
            + feat_dim * num_classes * 16)             # SGA bank (16-bit)
    per_step = training_energy_j(1, freq_hz, macs_per_epoch=macs,
                                 lut_ops=lut, div_ops=div, sram_bits=sram)
    total = training_energy_j(epochs, freq_hz, macs_per_epoch=macs,
                              lut_ops=lut, div_ops=div, sram_bits=sram)
    return {
        "freq_hz": freq_hz,
        "n_utterances": n_utts,
        "epochs": epochs,
        "uj_per_finetune_step": per_step * 1e6,
        "total_uj": total * 1e6,
        "seconds_per_step": CYCLES_PER_TRAIN_EPOCH / freq_hz,
    }


def recovery_energy_summary(offline_stats: List[dict], *, n_cal: int,
                            bias_bits: int, freq_hz: float = 1e6) -> dict:
    """Analytical energy of one self-healing recompensation pass
    (``serving.health``): the §IV-B test mode re-runs ``n_cal``
    calibration windows through the full stack with the counts digitized
    (charged as full offline decisions: the test mode has no streaming
    reuse), then re-programs the healed layers' bias words (``bias_bits``
    SRAM writes)."""
    rep = kws_chip_report(offline_stats, freq_hz)
    measure_j = n_cal * rep.energy_j_per_decision
    reprogram_j = bias_bits * E_SRAM_WR_BIT
    return {
        "freq_hz": freq_hz,
        "n_cal_windows": n_cal,
        "bias_bits": bias_bits,
        "measure_uj": measure_j * 1e6,
        "reprogram_uj": reprogram_j * 1e6,
        "total_uj": (measure_j + reprogram_j) * 1e6,
    }
