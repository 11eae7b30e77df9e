"""The smallest inputs on which a mean rounds differently as an IEEE
quotient and as the reference computes it (a sum times the float32
reciprocal), made with numpy.  Shared by the CPU tests against the JAX
package and the card tests, which import no JAX.

``gap_tie_ring``: the final activations of the paper net at a window
whose last layer is T = 448 long (``sample_len`` 28835-28898).  Channel 0
holds 315 ones and 133 minus ones: its sum 182 over 448 is 0.40625, half
an ACT_Q LSB above 0.375, so the quotient rounds to 0.375 (half to even)
and the reciprocal product, a hair above the tie, to 0.4375.

``head_tie_case``: seven enrollment utterances of a 2-feature, 3-class
head whose gradient column sum at (1, 0) is 728 * 2**-11: 728 / 7 lands
on a half-LSB tie of GRAD_Q, so the quotient gives 6/128 and the
reciprocal product 7/128.
"""

import numpy as np

GAP_T, GAP_D, GAP_ONES = 448, 576, 315
GAP_FEAT0 = 0.4375              # the reference's feats[0, 0]
HEAD_GW10 = 7 / 128             # the reference's gw[1, 0]


def gap_tie_ring(seed=0, batch=1):
    """(batch, 448, 576) float32 ±1; every row's channel 0 holds 315
    ones."""
    rng = np.random.default_rng(seed)
    ring = np.where(rng.random((batch, GAP_T, GAP_D)) < 0.5, 1.0, -1.0)
    for r in range(batch):
        col = -np.ones(GAP_T)
        col[rng.permutation(GAP_T)[:GAP_ONES]] = 1.0
        ring[r, :, 0] = col
    return ring.astype(np.float32)


def gap_head(seed=1, c=10):
    """A Q1.7 FC head (576, c), bias (c,), float32."""
    rng = np.random.default_rng(seed)
    q7 = lambda x: (np.clip(np.round(x * 128), -128, 127) / 128)
    return (q7(rng.normal(size=(GAP_D, c)) / 24).astype(np.float32),
            q7(rng.normal(size=c) * 0.05).astype(np.float32))


def head_tie_case():
    """(features (7, 2), labels (7,), w (2, 3), b (3,)) float32 / int64."""
    feats = np.array([[1, -0.625], [-1, 0], [0.5, 0], [-0.5, -0.5],
                      [0.25, 0], [0.75, 0], [-0.75, 0]], np.float32)
    labels = np.array([0, 1, 2, 1, 2, 0, 0], np.int64)
    w = np.array([[0.5, -0.25, 0.125], [0, 0, 0]], np.float32)
    b = np.array([0, 0.125, -0.125], np.float32)
    return feats, labels, w, b
