"""The port's fault model against the JAX package's, on the CPU:
``jaxrand.randint`` bit for bit against ``jax.random.randint`` (many keys,
the spans fault injection draws and the edge spans), ``FaultModel`` under
one call sequence (deltas, stuck masks, stats, the event log and the
snapshot equal; a model restored from either package's snapshot resumes
the same drift walk) and ``energy.recovery_energy_summary``.  Everything
is compared bitwise.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import numpy as np
import pytest

from repro.core import energy as jenergy
from repro.core import faults as jflt
from repro.models import kws as jkws
from repro_torch.core import energy, jaxrand
from repro_torch.core import faults as flt
from repro_torch.models import kws

L = 640
JCFG = jkws.KWSConfig(sample_len=L)
CFG = kws.KWSConfig(sample_len=L)
N_KEYS = 64


@pytest.mark.parametrize("minval,maxval", [
    (0, 1), (0, 2), (0, 3), (0, 5), (0, 7), (0, 128), (0, 1000),
    (0, 2 ** 31 - 1), (0, 2 ** 16), (0, 2 ** 16 + 1), (-7, 9),
    (-2 ** 31, 2 ** 31 - 1), (5, 5), (9, 2)],
    ids=lambda v: str(v))
@pytest.mark.parametrize("shape", [(), (3, 5)], ids=["scalar", "3x5"])
def test_randint_matches_jax(minval, maxval, shape):
    """``N_KEYS`` keys split from one seed, drawn as a batch; spans past
    2**16 (where the multiplier's square wraps in uint32), spans across
    the sign, and ``maxval <= minval`` (span forced to 1)."""
    keys = jax.random.split(jax.random.PRNGKey(minval & 0xFFFF), N_KEYS)
    want = np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, shape, minval, maxval))(keys))
    got = jaxrand.randint(jaxrand.key_from_numpy(np.asarray(keys), "cpu"),
                          shape, minval, maxval).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(np.int64))


def _models(drift_std=0.3, seed=7):
    return (flt.FaultModel.for_config(CFG, flt.FaultConfig(
                drift_std=drift_std, seed=seed)),
            jflt.FaultModel.for_config(JCFG, jflt.FaultConfig(
                drift_std=drift_std, seed=seed)))


def _campaign(m, ticks=3):
    """One call sequence of every mutation the model has."""
    for _ in range(ticks):
        m.tick()
    m.inject_bit_flips(n=5)
    m.inject_stuck("conv2", [1, 4], value=-1)
    m.inject_stuck("conv5", 7, value=1)
    m.inject_macro_dropout("conv1", start=8, width=4)
    m.inject_bit_flips(n=3, layer="conv4")
    for _ in range(ticks):
        m.tick()


def _assert_same(port, ref):
    dp, dj = port.deltas(), ref.deltas()
    assert list(dp) == list(dj)
    for name in dj:
        assert dp[name].dtype == np.float32
        np.testing.assert_array_equal(dp[name], dj[name], err_msg=name)
    mp, mj = port.stuck_mask(), ref.stuck_mask()
    for name in mj:
        np.testing.assert_array_equal(mp[name], mj[name], err_msg=name)
    assert port.stats() == ref.stats()
    assert port.events == ref.events
    assert port.active == ref.active


def test_fault_model_matches_jax():
    """Same config, same calls: deltas, stuck masks, stats, event logs
    and snapshots equal; ``clear`` returns both to inactive."""
    port, ref = _models()
    _campaign(port)
    _campaign(ref)
    _assert_same(port, ref)
    assert port.pop_dirty() and ref.pop_dirty()
    assert not port.pop_dirty()
    sp, sj = port.snapshot(), ref.snapshot()
    assert (sp["step"], sp["injections"], sp["events"]) == (
        sj["step"], sj["injections"], sj["events"])
    for part in ("drift", "flips", "stuck"):
        for name in sj[part]:
            np.testing.assert_array_equal(sp[part][name], sj[part][name])
            assert sp[part][name].dtype == sj[part][name].dtype
    port.clear()
    ref.clear()
    _assert_same(port, ref)
    assert not port.active


@pytest.mark.parametrize("source", ["port", "jax"])
def test_restored_fault_model_resumes_the_drift_walk(source):
    """A model restored mid-run (from the port's snapshot or the JAX
    package's) continues the walk and the injection counter exactly as
    the uninterrupted JAX model does."""
    port, ref = _models(drift_std=0.2, seed=3)
    _campaign(port, ticks=2)
    _campaign(ref, ticks=2)
    snap = (port if source == "port" else ref).snapshot()
    resumed = flt.FaultModel.for_config(CFG, flt.FaultConfig(drift_std=0.2,
                                                              seed=3))
    resumed.restore(snap)
    assert resumed.pop_dirty()
    for m in (resumed, ref):
        for _ in range(4):
            m.tick()
        m.inject_bit_flips(n=2)
    _assert_same(resumed, ref)


@pytest.mark.parametrize("n_cal,bias_bits", [(1, 0), (2, 8 * 96),
                                             (8, 8 * 1536)])
def test_recovery_energy_summary_matches_jax(n_cal, bias_bits):
    got = energy.recovery_energy_summary(kws.layer_stats(CFG), n_cal=n_cal,
                                         bias_bits=bias_bits)
    want = jenergy.recovery_energy_summary(jkws.layer_stats(JCFG),
                                           n_cal=n_cal, bias_bits=bias_bits)
    assert got == want
