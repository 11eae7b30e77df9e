"""The port's profile store (``repro_torch.checkpoint.profiles``) and
profiles at admission (``StreamServer(profiles=)``,
``submit(user_id=)``, the per-tick staleness sweep) against the JAX
package, on the CPU.

* The store round-trips a result losslessly and keeps its directory
  clean (atomic overwrite, listing, the save counter behind ``latest``,
  deletion, id validation, temporary files never listed).
* The file layout is the JAX package's: a profile written by JAX's
  ``ProfileStore`` loads in the port and gives riders bitwise equal to
  JAX's, and one written by the port loads in JAX bitwise.
* A stored profile restored into a fresh server serves exactly like the
  pre-restart install and like a dedicated server on the refolded net;
  ``submit(user_id=)`` serves exactly like ``install_custom``.
* The staleness sweep re-installs a re-saved profile and resets a
  deleted one tick for tick as JAX's server does, over one shared store
  directory.

Tolerances: arrays, riders, placements and counters bitwise; decision
``score`` within 1e-6 absolute against JAX (softmax and the smoothing sum
round differently in the last ulps between the libraries, as in
``test_torch_server.py``), exact between port servers.  Small config:
``sample_len=640``, ``hop=64``; the net is the port's, carried to JAX as
numpy leaves (``test_torch_noise.jax_hw``).
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.profiles import ProfileStore as JProfileStore
from repro.core import imc as jimc
from repro.models import kws as jkws
from repro.serving import StreamServer as JStreamServer
from repro.serving import VADConfig as JVADConfig
from repro.serving import customize as jcz
from repro_torch.checkpoint import ProfileStore
from repro_torch.core import imc, jaxrand
from repro_torch.models import kws
from repro_torch.serving import StreamServer, VADConfig
from repro_torch.serving import customize as cz
from test_torch_noise import CHANS, jax_hw

L, HOP = 640, 64
JCFG = jkws.KWSConfig(sample_len=L)
CFG = kws.KWSConfig(sample_len=L)
SCORE_ATOL = 1e-6


@pytest.fixture(scope="module")
def nets():
    params = kws.init_params(jaxrand.PRNGKey(5, device="cpu"), CFG,
                             device="cpu")
    hw_t = kws.fold_params(params, kws.init_state(CFG, device="cpu"), CFG,
                           pack=True)
    chip_j = jimc.sample_chip_offsets(jax.random.PRNGKey(0), CHANS,
                                      jimc.IMCNoiseParams(mav_offset_std=4.0))
    chip_t = imc.sample_chip_offsets(jaxrand.PRNGKey(0, "cpu"), CHANS,
                                     imc.IMCNoiseParams(mav_offset_std=4.0))
    return jax_hw(hw_t), hw_t, chip_j, chip_t


def _result(hw_t, bump_layer=None, bump=1, jax_side=False):
    """The base fold's arrays (integer biases as int32, as the JAX
    package's own tests store them) with an optional bias bump on one
    layer and a moved head."""
    hwp = hw_t.hw
    bias = {n: hwp.bias[n].numpy().astype(np.int32)
            for n in CFG.imc_layer_names()}
    if bump_layer is not None:
        bias[bump_layer] = bias[bump_layer] + int(bump)
    fc_w = hwp.fc_w.numpy().copy()
    fc_w[:, 1] += 3 / 128
    kw = dict(bias=bias, fc_w=fc_w, fc_b=hwp.fc_b.numpy(), epochs=7,
              n_utterances=2, history=[{"epoch": 7, "train_accuracy": 0.5}],
              energy={"total_uj": 1.5})
    return (jcz.CustomizationResult if jax_side
            else cz.CustomizationResult)(**kw)


def _same_result(a, b):
    assert sorted(a.bias) == sorted(b.bias)
    for k in a.bias:
        np.testing.assert_array_equal(np.asarray(a.bias[k]),
                                      np.asarray(b.bias[k]), err_msg=k)
    np.testing.assert_array_equal(np.asarray(a.fc_w), np.asarray(b.fc_w))
    np.testing.assert_array_equal(np.asarray(a.fc_b), np.asarray(b.fc_b))
    assert (a.epochs, a.n_utterances, a.history, a.energy) == (
        b.epochs, b.n_utterances, b.history, b.energy)


def test_profile_store_roundtrip_and_hygiene(nets, tmp_path):
    res = _result(nets[1], "conv2", 3)
    store = ProfileStore(str(tmp_path))
    assert store.list() == [] and store.latest() is None
    store.save("alice", res)
    _same_result(store.load("alice"), res)
    store.save("alice", res)                      # overwrite is atomic
    store.save("bob-2", res)
    assert store.list() == ["alice", "bob-2"]
    assert store.latest() == "bob-2"              # by the save counter
    with open(os.path.join(str(tmp_path), ".tmp.profile.xyz.npz"),
              "wb") as f:
        f.write(b"partial")                       # an interrupted save
    os.makedirs(os.path.join(str(tmp_path), "broken"))
    assert store.list() == ["alice", "bob-2"]
    # a second store over the directory continues the save counter
    again = ProfileStore(str(tmp_path))
    again.save("alice", res)
    assert again.latest() == "alice"
    assert store.delete("alice") and not store.exists("alice")
    assert not store.delete("alice") and store.mtime("alice") is None
    with pytest.raises(ValueError):
        store.save("../escape", res)
    with pytest.raises(FileNotFoundError):
        store.load("nobody")


def test_profile_files_cross_packages(nets, tmp_path):
    """One directory, both packages' stores: each loads what the other
    wrote, bitwise, and the port's riders of a JAX-written profile equal
    JAX's riders (bias deltas, head, silence fills)."""
    hw_j, hw_t, chip_j, chip_t = nets
    jstore, store = JProfileStore(str(tmp_path)), ProfileStore(str(tmp_path))
    res_j = _result(hw_t, "conv3", 2, jax_side=True)
    jstore.save("from-jax", res_j)
    got = store.load("from-jax")
    _same_result(got, res_j)
    riders_t = cz.result_riders(got, hw_t, CFG, chip_offsets=chip_t,
                                with_fills=True)
    riders_j = jcz.result_riders(res_j, hw_j, JCFG, chip_offsets=chip_j,
                                 with_fills=True)
    for name in CFG.imc_layer_names():
        np.testing.assert_array_equal(riders_t["delta"][name],
                                      np.asarray(riders_j["delta"][name]))
    for a, b in zip(riders_t["head"], riders_j["head"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(riders_t["fills"], riders_j["fills"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    store.save("from-port", _result(hw_t, "conv1", -2))
    _same_result(jstore.load("from-port"), store.load("from-port"))
    assert store.list() == jstore.list() == ["from-jax", "from-port"]
    assert store.latest() == jstore.latest() == "from-port"


def _serve(srv, wav, sid="u", **submit_kw):
    srv.submit(sid, wav, **submit_kw)
    srv.finish(sid)
    return srv.drain()


@pytest.mark.parametrize("vad", [False, True], ids=["no_vad", "vad"])
def test_restart_and_user_id_serve_like_install_custom(nets, tmp_path, vad):
    """A profile saved, then restored into a fresh server: through
    ``install_custom`` it serves like the pre-restart object and like a
    dedicated server on the refolded net; through ``submit(user_id=)`` on
    a server built with ``profiles=`` it serves the same, as JAX's
    server does."""
    hw_j, hw_t, chip_j, chip_t = nets
    res = _result(hw_t, "conv2", 2)
    store = ProfileStore(str(tmp_path))
    store.save("user", res)
    wav = np.random.default_rng(28).uniform(-1, 1, L + 8 * HOP).astype(
        np.float32)
    wav[L + 2 * HOP:L + 6 * HOP] *= 1e-4
    kw = dict(hop=HOP, slots=2, use_kernel=True, chip_offsets=chip_t,
              seed=29, device="cpu", vad=VADConfig() if vad else None)

    def installed(result):
        srv = StreamServer(hw_t, CFG, **kw)
        srv.install_custom("u", result)
        return _serve(srv, wav)

    ev_pre, ev_post = installed(res), installed(store.load("user"))
    assert ev_pre == ev_post
    refolded = cz.refold(res, hw_t, CFG)
    assert _serve(StreamServer(refolded, CFG, **kw), wav) == ev_post
    by_user = StreamServer(hw_t, CFG, profiles=store, **kw)
    assert _serve(by_user, wav, user_id="user") == ev_post
    assert by_user.stats()["profile_swaps"] == 0
    ref = JStreamServer(hw_j, JCFG, hop=HOP, slots=2, use_kernel=False,
                        chip_offsets=chip_j, seed=29, compiled=None,
                        vad=JVADConfig() if vad else None,
                        profiles=JProfileStore(str(tmp_path)))
    ev_ref = _serve(ref, wav, user_id="user")
    assert [{k: e[k] for k in ("stream", "hop", "keyword", "trigger")}
            for e in ev_ref] == [{k: e[k] for k in ("stream", "hop",
                                                    "keyword", "trigger")}
                                 for e in ev_post]
    np.testing.assert_allclose([e["score"] for e in ev_post],
                               [e["score"] for e in ev_ref], rtol=0,
                               atol=SCORE_ATOL)


def test_staleness_sweep_matches_jax(nets, tmp_path):
    """The reference's auto-install / stale-eviction scenario, with a JAX
    server and the port's reading one store directory: install on
    submit, re-install after a re-save, reset after a delete, a late save
    picked up for a user who had none; riders, swap counts and events
    equal JAX's after every tick."""
    hw_j, hw_t, chip_j, chip_t = nets
    jstore = JProfileStore(str(tmp_path))
    store = ProfileStore(str(tmp_path))
    ref = JStreamServer(hw_j, JCFG, hop=HOP, slots=2, use_kernel=False,
                        chip_offsets=chip_j, profiles=jstore, compiled=None)
    port = StreamServer(hw_t, CFG, hop=HOP, slots=2, use_kernel=True,
                        chip_offsets=chip_t, profiles=store, device="cpu")
    servers = (ref, port)
    rng = np.random.default_rng(0)
    mk = lambda n: rng.standard_normal(n).astype(np.float32)
    events = [[], []]

    def step_both(**expect):
        for j, srv in enumerate(servers):
            events[j].extend(srv.step())
        for sid, bump in expect.items():
            recs = [srv._streams[sid] for srv in servers]
            if bump is None:
                assert all(r.custom is None and r.profile_mtime is None
                           for r in recs), sid
                continue
            for r in recs:
                layer, val = bump
                assert np.all(np.asarray(r.custom["delta"][layer]) == val)
        assert port.stats()["profile_swaps"] == ref.stats()["profile_swaps"]

    store.save("alice", _result(hw_t, "conv2", 1))
    first = mk(L)
    for srv in servers:
        assert srv.submit("mic0", first, user_id="alice") == "slot"
    assert port._streams["mic0"].profile_mtime is not None
    step_both(mic0=("conv2", 1.0))
    jstore.save("alice", _result(hw_t, "conv2", 2, jax_side=True))
    chunk = mk(HOP)
    for srv in servers:
        srv.submit("mic0", chunk)
    step_both(mic0=("conv2", 2.0))
    assert port.stats()["profile_swaps"] == 1
    store.delete("alice")
    step_both(mic0=None)
    assert port.stats()["profile_swaps"] == 2
    second = mk(L)
    for srv in servers:
        srv.submit("mic1", second, user_id="bob")
    assert port._streams["mic1"].custom is None
    store.save("bob", _result(hw_t, "conv3", 1))
    step_both(mic1=("conv3", 1.0))
    tail = mk(3 * HOP)
    for srv in servers:
        for sid in ("mic0", "mic1"):
            srv.submit(sid, tail)
            srv.finish(sid)
    for j, srv in enumerate(servers):
        events[j].extend(srv.drain())
    assert [(e["stream"], e["hop"], e["keyword"]) for e in events[1]] == [
        (e["stream"], e["hop"], e["keyword"]) for e in events[0]]
    np.testing.assert_allclose([e["score"] for e in events[1]],
                               [e["score"] for e in events[0]], rtol=0,
                               atol=SCORE_ATOL)
    bare = StreamServer(hw_t, CFG, hop=HOP, slots=2, device="cpu")
    with pytest.raises(ValueError, match="profile store"):
        bare.submit("x", np.zeros((HOP,), np.float32), user_id="alice")
