"""The port's fused SGA update wrappers (repro_torch.kernels.sga_update)
against the JAX package's, on the CPU, bit for bit.

On the CPU the port's ``sga_update_batch`` (K2, a learning rate and
threshold per row) and ``sga_update_tree`` (K3, scalar operands) run the
plain version; the JAX package's run its Pallas kernels in interpret mode.
The inputs are those of ``tests/test_kernels.py``'s kernel test and, at
the customization path's width (N = 576 * 10 + 10) and on trees of
ragged leaves (1 to 5770 elements), Q1.7 weights and
gradients and Q1.15 banks with tie cases placed on purpose: gradients at
exactly the threshold, banks that round to exactly the threshold, sums
half an LSB from both grids (round half to even), and weights pushed past
both rails; learning rates on and off powers of two.  The card holds the
kernel against the same plain version (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import collections

import jax
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


Pair = collections.namedtuple("Pair", "w b")
RAGGED = (1, 3, 1023, 1025, 5770)


def _ragged(v, lib):
    """Leaves of ``RAGGED`` sizes cut from ``v`` in nested dicts, a list
    and a namedtuple, 1-D, 2-D and (577, 10)."""
    ends = np.cumsum(RAGGED)
    l0, l1, l2, l3, l4 = (lib(v[e - n:e]) for e, n in zip(ends, RAGGED))
    return {"fc": Pair(l0, l1), "convs": [l2, {"x": l3.reshape(1, -1)}],
            "head": l4.reshape(577, 10)}


@pytest.mark.parametrize("lr,g_th", [(1 / 16, 0.078125), (0.05, 0.078125),
                                     (1 / 128, 0.5)])
def test_sga_update_tree_on_ragged_trees_matches_reference(lr, g_th):
    """The tree entry on a tree of ragged leaves (1 to 5770 elements in
    nested dicts, a list and a namedtuple) against the reference's
    ``sga_update_tree``, leaf for leaf, with the tie cases of
    ``test_sga_update_tree_matches_reference`` (gradients at exactly the
    threshold, w - lr g half a weight LSB off the grid) spread over every
    leaf."""
    n = sum(RAGGED)
    rng = np.random.default_rng(31)
    w = np.asarray(J_WEIGHT_Q.quantize(jnp.asarray(
        rng.uniform(-1, 1, n).astype(np.float32))))
    g = (rng.normal(size=n) * 0.05).astype(np.float32)
    a = rng.uniform(-0.05, 0.05, n).astype(np.float32)
    idx = rng.permutation(n)
    g[idx[:300]] = np.float32(g_th)
    g[idx[300:600]] = -np.float32(g_th)
    g[idx[600:900]] = np.float32(-LSB_W / 2) / np.float32(lr)
    g[[0, 1, 3]] = [np.float32(g_th), np.float32(-LSB_W / 2) /
                    np.float32(lr), -np.float32(g_th)]
    got = ops.sga_update_tree(*(_ragged(v, torch.tensor) for v in (w, g, a)),
                              lr, g_th)
    want = jops.sga_update_tree(*(_ragged(v, jnp.asarray)
                                  for v in (w, g, a)), lr, g_th,
                                interpret=True)
    for x, y in zip(got, want):
        assert isinstance(x["fc"], Pair)
        got_leaves = jax.tree_util.tree_leaves(x)   # the same key order
        want_leaves = jax.tree_util.tree_leaves(y)
        assert len(got_leaves) == len(want_leaves) == len(RAGGED)
        for p, r in zip(got_leaves, want_leaves):
            assert tuple(p.shape) == r.shape
            _eq(p, r)


def test_sga_update_tree_refuses_a_tree_on_two_devices():
    """A tree must lie on one device: the wrapper never splits one between
    the kernel and the plain version (a leaf on the meta device stands in
    for a second device here)."""
    tree = {"a": torch.zeros(8), "b": torch.zeros(8, device="meta")}
    with pytest.raises(ValueError, match="more than one device"):
        ops.sga_update_tree(tree, tree, tree, 1 / 16, 0.0625)


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
