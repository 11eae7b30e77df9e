"""Inputs of the fused SGA update tests, made with numpy from a seed.

``sga_rows`` builds B rows of the customization path's width (the paper
head's 576 x 10 weights and 10 biases) of Q1.7 weights and gradients and
Q1.15 banks, with tie cases placed on purpose in every row: gradients at
exactly the row's threshold, banks that land on exactly the threshold,
sums half an LSB from both grids (round half to even), weights pushed past
both rails, zero gradients and zero banks.  Shared by the CPU tests
against the JAX package and the card tests, which import no JAX.
"""

import numpy as np

N_HEAD = 576 * 10 + 10
LSB_W, LSB_A = 2.0 ** -7, 2.0 ** -15


def sga_rows(seed, lrs, n=N_HEAD):
    """(w, g, accum, lr, g_th) float32 numpy for len(lrs) rows of n."""
    rng = np.random.default_rng(seed)
    b = len(lrs)
    lr = np.asarray(lrs, np.float32)
    g_th = (np.float32(LSB_W / 2) / lr).astype(np.float32)
    w = (rng.integers(-128, 128, (b, n)) * LSB_W).astype(np.float32)
    g = (np.round(rng.normal(size=(b, n)) * 10) * LSB_W).astype(np.float32)
    g = np.clip(g, -1.0, 127 * LSB_W)
    a = (rng.integers(-3000, 3001, (b, n)) * LSB_A).astype(np.float32)
    for r in range(b):
        th = g_th[r]
        i = iter(rng.permutation(n)[:8 * 40].reshape(8, 40))
        # |g| == g_th: not small, applied as it is
        idx = next(i)
        g[r, idx] = th * np.where(rng.random(40) < 0.5, -1, 1)
        # a bank that lands on exactly g_th: fires
        idx = next(i)
        g[r, idx] = np.float32(th / 2)
        a[r, idx] = np.float32(th - np.float32(th / 2))
        # bank sum half an accumulator LSB off the grid: ties to even
        idx = next(i)
        a[r, idx] = (rng.integers(-200, 200, 40) * LSB_A).astype(np.float32)
        g[r, idx] = np.float32(LSB_A / 2) * np.where(
            rng.random(40) < 0.5, -1, 1)
        # w - lr*g half a weight LSB off the grid: ties to even
        idx = next(i)
        g[r, idx] = np.float32(-LSB_W / 2) / lr[r]
        a[r, idx] = 0.0
        # past the upper and the lower rail
        idx = next(i)
        w[r, idx] = 127 * LSB_W
        g[r, idx] = -0.5
        idx = next(i)
        w[r, idx] = -1.0
        g[r, idx] = 0.5
        # zero gradients on the rails, and exact zero banks
        idx = next(i)
        g[r, idx] = 0.0
        a[r, next(i)] = 0.0
    return w, g, a, lr, g_th


# logits (times -1/16) of an utterance with zero features: the LUT codes
# of the softmax sum to 1536, so classes 4 and 9 sit at p * 256 = 21.5, a
# tie of the 8-bit division's rounding
TIE_KS = [0, 15, 1, 10, 11, 6, 8, 15, 13, 11]


def head_rows(seed, ns, d=576, c=10):
    """One session row per entry of ``ns`` (utterances): features on the
    Q1.3.4 grid in [-1, 1], one-hot labels, a Q1.7 head and Q1.15 banks,
    float32 numpy; row 0's first utterance has zero features and biases
    that put its softmax on a tie (``TIE_KS``)."""
    rng = np.random.default_rng(seed)
    q7 = lambda x: (np.clip(np.round(x * 128), -128, 127) / 128).astype(
        np.float32)
    rows = []
    for r, n in enumerate(ns):
        f = (rng.integers(-16, 17, (n, d)) / 16).astype(np.float32)
        labels = rng.integers(0, c, n)
        w = q7(rng.normal(size=(d, c)) / np.sqrt(d))
        b = q7(rng.normal(size=c) * 0.05)
        if r == 0 and c == len(TIE_KS):
            f[0] = 0.0
            b = (-np.asarray(TIE_KS) / 16).astype(np.float32)
        aw = (rng.integers(-3000, 3001, (d, c)) * LSB_A).astype(np.float32)
        ab = (rng.integers(-3000, 3001, c) * LSB_A).astype(np.float32)
        onehot = np.eye(c, dtype=np.float32)[labels]
        rows.append(dict(f=f, onehot=onehot, w=w, b=b, aw=aw, ab=ab))
    return rows
