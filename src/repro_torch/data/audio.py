"""Synthetic keyword-spotting corpus (GSCD stand-in) + personal sets.

Own copy of ``repro/data/audio.py`` (pure NumPy, unchanged), so the port
makes its traffic without importing the JAX package.

The Google Speech Commands dataset and the paper's private 3-speaker personal
set are not available offline, so we synthesize a corpus with the same
statistical *structure* (DESIGN.md §4):

  * 10 keyword classes.  Each class is a distinct spectro-temporal signature
    (2-3 "phoneme" segments; each segment = harmonic stack with class-specific
    formant trajectory + chirp + amplitude modulation).  The binarized sinc
    filter bank front-end of the model is exactly the right inductive bias to
    separate these.
  * Speakers.  A speaker is a (pitch, formant-scale, tempo, breathiness)
    tuple.  Training speakers are drawn around the neutral voice; *personal*
    speakers (the customization target) carry a systematic accent shift —
    formants scaled and tempo skewed — which degrades the base model the same
    way regional accents degrade the paper's (Table IV's premise).
  * Augmentation follows §VI-A3: Gaussian noise with amplitude in
    [0.001, 0.015] and random time shift in [-0.5s, 0.5s].

Everything is deterministic in the seed and pure NumPy (data pipeline stays
off the accelerator, as in any production input pipeline).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

SAMPLE_RATE = 16_000
NUM_CLASSES = 10
KEYWORDS = ("yes", "no", "up", "down", "left", "right", "stop", "go", "on", "off")


@dataclasses.dataclass(frozen=True)
class Speaker:
    pitch: float          # fundamental, Hz
    formant_scale: float  # multiplies all formant frequencies
    tempo: float          # 1.0 = nominal segment durations
    noise_floor: float


def _speaker(rng: np.random.Generator, accent_shift: float = 0.0) -> Speaker:
    """accent_shift = 0: GSCD-like population; > 0: 'personal' accent."""
    return Speaker(
        pitch=float(rng.uniform(95, 240)),
        formant_scale=float(rng.uniform(0.95, 1.05) * (1.0 + accent_shift)),
        tempo=float(rng.uniform(0.92, 1.08) * (1.0 + 0.5 * accent_shift)),
        noise_floor=float(rng.uniform(0.002, 0.006)),
    )


# Class signatures: per segment (formant_1 Hz, formant_2 Hz, chirp factor,
# AM rate Hz).  Spread across the audible band so a 24-filter learned filter
# bank can separate them.
def _class_segments(c: int) -> list:
    # Each class owns a frequency band (multiplicative spacing 1.33 >> the
    # +/-5% speaker formant spread) plus a distinct temporal signature
    # (segment count, AM rate).  A ~0.18 accent shift (personal set) pushes
    # utterances toward the neighbouring band — the distribution shift that
    # customization must fix.
    # Bands live in 1-7 kHz: a binarized 15-tap filter at 16 kHz can only
    # resolve sign-oscillation periods <= its support (~1 kHz and up), so the
    # synthetic corpus puts the discriminative energy where the paper's
    # front-end has resolution.
    base = 1050.0 * (1.23 ** c)                  # 1.05 .. 6.7 kHz
    segs = []
    n_seg = 2 + (c % 2)
    for j in range(n_seg):
        f1 = base * (1.0 + 0.10 * j)
        f2 = min(f1 * 1.55, 7500.0)
        chirp = (-1) ** (c + j) * 0.12
        am = 4.0 + 3.0 * ((c * 3 + j) % 4)
        segs.append((f1, f2, chirp, am))
    return segs


def synthesize_utterance(c: int, spk: Speaker, rng: np.random.Generator,
                         augment: bool = True,
                         length: int = SAMPLE_RATE) -> np.ndarray:
    segs = _class_segments(c)
    # active speech ~55% of the window (scales with reduced smoke lengths)
    dur_samples = int(0.55 * length / spk.tempo)
    seg_len = max(8, min(dur_samples, length) // len(segs))
    sig = np.zeros(length, dtype=np.float64)
    start = max(0, (length - seg_len * len(segs)) // 2)
    t = np.arange(seg_len) / SAMPLE_RATE
    for j, (f1, f2, chirp, am) in enumerate(segs):
        f1 = f1 * spk.formant_scale
        f2 = f2 * spk.formant_scale
        env = np.sin(np.pi * np.arange(seg_len) / seg_len) ** 2
        inst1 = f1 * (1.0 + chirp * t)
        inst2 = f2 * (1.0 - 0.5 * chirp * t)
        ph1 = 2 * np.pi * np.cumsum(inst1) / SAMPLE_RATE
        ph2 = 2 * np.pi * np.cumsum(inst2) / SAMPLE_RATE
        php = 2 * np.pi * spk.pitch * t
        mod = 0.6 + 0.4 * np.cos(2 * np.pi * am * t)
        seg = env * mod * (0.55 * np.sin(ph1) + 0.3 * np.sin(ph2)
                           + 0.15 * np.sin(php))
        s0 = start + j * seg_len
        sig[s0:s0 + seg_len] += seg
    sig += spk.noise_floor * rng.standard_normal(length)

    if augment:                                  # §VI-A3 augmentation
        sig += rng.uniform(0.001, 0.015) * rng.standard_normal(length)
        # paper: +/-0.5s shift on a 1s window; scale to the window so the
        # keyword stays (partially) inside at reduced smoke lengths
        shift = int(rng.uniform(-0.22, 0.22) * length)
        sig = np.roll(sig, shift)
        if shift > 0:
            sig[:shift] = 0.0
        elif shift < 0:
            sig[shift:] = 0.0

    peak = np.max(np.abs(sig)) + 1e-9
    sig = sig / peak * 0.9
    # 8-bit raw audio input (paper §II): quantize onto the int8 grid.
    return np.round(sig * 127.0) / 127.0


def make_dataset(seed: int, n_per_class: int, n_speakers: int,
                 accent_shift: float = 0.0, augment: bool = True,
                 length: int = SAMPLE_RATE) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (audio float32 (N, length) on the int8 grid, labels int32 (N,))."""
    rng = np.random.default_rng(seed)
    speakers = [_speaker(rng, accent_shift) for _ in range(n_speakers)]
    xs, ys = [], []
    for c in range(NUM_CLASSES):
        for i in range(n_per_class):
            spk = speakers[(c * n_per_class + i) % n_speakers]
            xs.append(synthesize_utterance(c, spk, rng, augment, length))
            ys.append(c)
    x = np.stack(xs).astype(np.float32)
    y = np.asarray(ys, dtype=np.int32)
    perm = rng.permutation(len(y))
    return x[perm], y[perm]


def make_gscd_like(seed: int = 0, train_per_class: int = 120,
                   test_per_class: int = 30, length: int = SAMPLE_RATE):
    """The 'original dataset' stand-in (many speakers, no accent shift)."""
    xtr, ytr = make_dataset(seed, train_per_class, n_speakers=40,
                            accent_shift=0.0, augment=True, length=length)
    xte, yte = make_dataset(seed + 1, test_per_class, n_speakers=12,
                            accent_shift=0.0, augment=False, length=length)
    return (xtr, ytr), (xte, yte)


def make_personal(seed: int = 100, train_per_class: int = 3,
                  test_per_class: int = 17, n_people: int = 3,
                  accent_shift: float = 0.22, length: int = SAMPLE_RATE):
    """The personal set (§VI-A2): 3 people, 3 utterances/keyword/person for
    training (90 utterances), the rest for test; systematic accent."""
    rng = np.random.default_rng(seed)
    people = [_speaker(rng, accent_shift) for _ in range(n_people)]
    xtr, ytr, xte, yte = [], [], [], []
    for c in range(NUM_CLASSES):
        for p, spk in enumerate(people):
            for i in range(train_per_class):
                xtr.append(synthesize_utterance(c, spk, rng, False, length))
                ytr.append(c)
            for i in range(test_per_class):
                xte.append(synthesize_utterance(c, spk, rng, False, length))
                yte.append(c)
    to = lambda a, d: np.asarray(a, dtype=d)
    return ((np.stack(xtr).astype(np.float32), to(ytr, np.int32)),
            (np.stack(xte).astype(np.float32), to(yte, np.int32)))
