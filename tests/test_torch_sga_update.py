"""The port's fused SGA update wrappers (repro_torch.kernels.sga_update)
against the JAX package's, on the CPU, bit for bit.

On the CPU the port's ``sga_update_batch`` (K2, a learning rate and
threshold per row) and ``sga_update_tree`` (K3, scalar operands) run the
plain version; the JAX package's run its Pallas kernels in interpret mode.
The inputs are those of ``tests/test_kernels.py``'s kernel test and, at
the customization path's width (N = 576 * 10 + 10), Q1.7 weights and
gradients and Q1.15 banks with tie cases placed on purpose: gradients at
exactly the threshold, banks that round to exactly the threshold, sums
half an LSB from both grids (round half to even), and weights pushed past
both rails; learning rates on and off powers of two.  The card holds the
kernel against the same plain version (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.onchip_training import sga_threshold as j_threshold
from repro.core.quantize import WEIGHT_Q as J_WEIGHT_Q
from repro.kernels.sga_update import ops as jops
from repro_torch.core.onchip_training import sga_threshold
from repro_torch.kernels.sga_update import ops
from repro_torch.kernels.sga_update.ref import sga_update_ref

from _sga_cases import LSB_W, N_HEAD, sga_rows

def _eq(port, ref):
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


@pytest.mark.parametrize("lrs", [[1 / 16], [1 / 16, 1 / 128],
                                 [1 / 16, 0.05, 1 / 32, 1 / 128, 0.03,
                                  1 / 64, 0.1, 1 / 8]],
                         ids=["B1", "B2", "B8"])
def test_sga_update_batch_matches_reference(lrs):
    w, g, a, lr, g_th = sga_rows(len(lrs), lrs)
    got = ops.sga_update_batch(*(torch.tensor(v) for v in (w, g, a, lr,
                                                           g_th)))
    want = jops.sga_update_batch(*(jnp.asarray(v) for v in (w, g, a, lr,
                                                            g_th)))
    for x, y in zip(got, want):
        _eq(x, y)
    # the tie cases fired, released and clipped
    new_w, new_a = got
    assert (new_a.numpy() == 0).sum() > 40 and (new_w == -1.0).any()
    assert (new_w.numpy() == 127 * LSB_W).any()


def test_thresholds_match_reference():
    lrs = np.asarray([1 / 16, 0.05, 0.03, 1 / 128, 0.1], np.float32)
    for lr in lrs:
        _eq(sga_threshold(torch.tensor(lr)),
            j_threshold(jnp.asarray(lr), J_WEIGHT_Q))


@pytest.mark.parametrize("n", [1000, 1024, 5003, N_HEAD])
@pytest.mark.parametrize("lr,g_th", [(1 / 16, 0.078125), (1 / 128, 0.5),
                                     (0.05, 0.078125)])
def test_sga_update_tree_matches_reference(n, lr, g_th):
    """``tests/test_kernels.py``'s inputs (numpy-made), plus the tie cases
    at the threshold the scalars give."""
    rng = np.random.default_rng(n)
    w = np.asarray(J_WEIGHT_Q.quantize(jnp.asarray(
        rng.uniform(-1, 1, n).astype(np.float32))))
    g = (rng.normal(size=n) * 0.05).astype(np.float32)
    a = rng.uniform(-0.05, 0.05, n).astype(np.float32)
    g[:50] = np.float32(g_th)
    g[50:100] = -np.float32(g_th)
    g[100:150] = np.float32(-LSB_W / 2) / np.float32(lr)
    tree = lambda v: {"fc": {"w": v[:n // 2], "b": v[n // 2:]}}
    got = ops.sga_update_tree(*(tree(torch.tensor(v)) for v in (w, g, a)),
                              lr, g_th)
    want = jops.sga_update_tree(*(tree(jnp.asarray(v)) for v in (w, g, a)),
                                lr, g_th, interpret=True)
    for x, y in zip(got, want):
        for k in ("w", "b"):
            _eq(x["fc"][k], y["fc"][k])


def test_batch_rows_equal_flat_updates():
    """Row r of K2 equals K3 on row r with that row's scalars, and both
    equal the plain version."""
    lrs = [1 / 16, 0.05, 1 / 128]
    w, g, a, lr, g_th = sga_rows(5, lrs, n=777)
    nw, na = ops.sga_update_batch(*(torch.tensor(v) for v in (w, g, a, lr,
                                                              g_th)))
    for r in range(len(lrs)):
        fw, fa = ops.sga_update_tree(torch.tensor(w[r]), torch.tensor(g[r]),
                                     torch.tensor(a[r]), float(lr[r]),
                                     float(g_th[r]))
        assert torch.equal(fw, nw[r]) and torch.equal(fa, na[r])
        pw, pa = sga_update_ref(torch.tensor(w[r]), torch.tensor(g[r]),
                                torch.tensor(a[r]), torch.tensor(lr[r]),
                                torch.tensor(g_th[r]))
        assert torch.equal(pw, nw[r]) and torch.equal(pa, na[r])


def test_cpu_wrappers_never_count_a_launch():
    ops.COUNTS_ROWS.reset()
    ops.COUNTS_FLAT.reset()
    w, g, a, lr, g_th = sga_rows(1, [1 / 16, 1 / 32], n=400)
    ops.sga_update_batch(*(torch.tensor(v) for v in (w, g, a, lr, g_th)))
    ops.sga_update_tree([torch.tensor(w[0])], [torch.tensor(g[0])],
                        [torch.tensor(a[0])], 1 / 16, 0.0625)
    assert ops.COUNTS_ROWS.launches == 0 and ops.COUNTS_FLAT.launches == 0
