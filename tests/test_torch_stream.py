"""The port's frame-incremental streaming path (repro_torch.serving.stream)
against the JAX package's, hop by hop and bit for bit, and against the
port's own ``hw_forward`` per window.

``L, HOP = 640, 64`` as in tests/test_compiled.py.  Audio is made with
numpy on the 8-bit k/127 grid; the folded net and chip offsets are made
by the JAX package and carried across as numpy leaves.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import kws as jkws
from repro.serving import stream as jsv
from repro_torch.models import kws
from repro_torch.serving import stream as sv

L, HOP = 640, 64
JCFG = jkws.KWSConfig(sample_len=L)
CFG = kws.KWSConfig(sample_len=L)
B = 2


@pytest.fixture(scope="module")
def nets():
    params = jkws.init_params(jax.random.PRNGKey(5), JCFG)
    hw_j = jkws.fold_params(params, jkws.init_state(JCFG), JCFG, pack=True)
    hw_t = kws.hw_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, hw_j.hw), CFG, device="cpu")
    return hw_j, hw_t


def _chip(seed):
    rng = np.random.default_rng(seed)
    return {f"conv{i}": (4.0 * rng.normal(size=JCFG.channels[i])).astype(
        np.float32) for i in range(1, JCFG.num_conv_layers)}


def _audio(seed, n):
    rng = np.random.default_rng(seed)
    return (np.round(rng.uniform(-1, 1, (B, n)) * 127) / 127).astype(
        np.float32)


def _leaves(st):
    return [st.audio_carry, *st.carries, st.ring, st.hop]


def _assert_state_equal(st_t, st_j, what):
    np.testing.assert_array_equal(st_t.audio_carry.numpy(),
                                  np.asarray(st_j.audio_carry),
                                  err_msg=f"{what}: audio_carry")
    assert len(st_t.carries) == len(st_j.carries)
    for i, (ct, cj) in enumerate(zip(st_t.carries, st_j.carries)):
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj),
                                      err_msg=f"{what}: carry {i + 1}")
    np.testing.assert_array_equal(st_t.ring.numpy(), np.asarray(st_j.ring),
                                  err_msg=f"{what}: ring")
    np.testing.assert_array_equal(st_t.hop.numpy(), np.asarray(st_j.hop),
                                  err_msg=f"{what}: hop")


@pytest.mark.parametrize("case", ["clean", "chip"])
def test_stream_steps_match_jax(nets, case):
    """init, single hops, a 3-hop multi-step, a gated hop and a hop after
    it: logits, carries, ring and hop counter equal JAX's at every step."""
    hw_j, hw_t = nets
    chip = _chip(9) if case == "chip" else None
    chip_j = None if chip is None else {k: jnp.asarray(v)
                                        for k, v in chip.items()}
    chip_t = None if chip is None else {k: torch.as_tensor(v)
                                        for k, v in chip.items()}
    eng_j = jsv.StreamEngine(hw_j, JCFG, HOP, chip_offsets=chip_j,
                             use_kernel=True)
    eng_t = sv.StreamEngine(hw_t, CFG, HOP, chip_offsets=chip_t,
                            use_kernel=True, device="cpu")
    assert eng_t.geom.layers == tuple(
        sv.LayerGeom(**vars(lg)) for lg in eng_j.geom.layers)
    audio = _audio(11, L + 9 * HOP)

    lj, st_j = eng_j.init(jnp.asarray(audio[:, :L]),
                          jnp.zeros((B, 2), jnp.uint32))
    lt, st_t = eng_t.init(torch.as_tensor(audio[:, :L]))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    _assert_state_equal(st_t, st_j, "init")

    pos = L
    for h in range(4):
        a = audio[:, pos:pos + HOP]
        lj, st_j = eng_j.step(st_j, jnp.asarray(a))
        lt, st_t = eng_t.step(st_t, torch.as_tensor(a))
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj),
                                      err_msg=f"hop {h}")
        _assert_state_equal(st_t, st_j, f"hop {h}")
        pos += HOP

    a = audio[:, pos:pos + 3 * HOP]
    lj, st_j = eng_j.multi_step(st_j, jnp.asarray(a), 3)
    lt, st_t = eng_t.multi_step(st_t, torch.as_tensor(a), 3)
    assert lt.shape == (B, 3, CFG.num_classes)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    _assert_state_equal(st_t, st_j, "multi-step")
    pos += 3 * HOP

    fills_j = jsv.silence_fills(JCFG, jkws.silence_columns(
        hw_j, JCFG, chip_offsets=chip_j))
    fills_t = sv.silence_fills(CFG, kws.silence_columns(
        hw_t, CFG, chip_offsets=chip_t))
    st_j = jsv.gated_step(st_j, JCFG, eng_j.geom, fills_j)
    st_t = sv.gated_step(st_t, CFG, eng_t.geom, fills_t)
    _assert_state_equal(st_t, st_j, "gated")

    a = audio[:, pos:pos + HOP]
    lj, st_j = eng_j.step(st_j, jnp.asarray(a))
    lt, st_t = eng_t.step(st_t, torch.as_tensor(a))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    _assert_state_equal(st_t, st_j, "hop after gate")


@pytest.mark.parametrize("use_kernel", [True, False], ids=["fused", "plain"])
def test_stream_matches_port_hw_forward_per_window(nets, use_kernel):
    """N hops of the port's streaming path equal the port's hw_forward on
    each full window (chip offsets on), and a multi-step equals hops."""
    _, hw_t = nets
    chip = {k: torch.as_tensor(v) for k, v in _chip(4).items()}
    eng = sv.StreamEngine(hw_t, CFG, HOP, chip_offsets=chip,
                          use_kernel=use_kernel, device="cpu")
    audio = torch.as_tensor(_audio(12, L + 6 * HOP))
    logits, state = eng.init(audio[:, :L])
    multi_state = state
    for h in range(7):
        window = audio[:, h * HOP:h * HOP + L]
        want, _ = kws.hw_forward(hw_t, window, CFG, chip_offsets=chip,
                                 use_kernel=use_kernel, device="cpu")
        assert torch.equal(logits, want), f"window {h}"
        if h < 6:
            logits, state = eng.step(state, audio[:, L + h * HOP:
                                                  L + (h + 1) * HOP])
    multi_logits, multi_state = eng.multi_step(multi_state,
                                               audio[:, L:], 6)
    assert torch.equal(multi_logits[:, -1], logits)
    assert all(torch.equal(a, b)
               for a, b in zip(_leaves(multi_state), _leaves(state)))


def test_geometry_rejects_unaligned_hops():
    with pytest.raises(ValueError, match="multiple of 64"):
        sv.make_stream_geometry(CFG, 96)
    with pytest.raises(ValueError, match="smaller than the window"):
        sv.make_stream_geometry(CFG, L)
    assert sv.hop_alignment(kws.PAPER_KWS) == 64
