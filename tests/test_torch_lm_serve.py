"""The port's LM server (``repro_torch.launch.serve``) against the JAX
package's, on the CPU, on the reduced dense and VLM configs.

``Server.submit_and_run`` serves ``main()``'s traffic (4 prompts of 4-9
tokens from ``default_rng(0)``, 8 new tokens each) with the JAX server's
parameters carried in (``lm.params_from_numpy``): a fresh cache per
request, the prompt fed one token at a time, greedy tokens over the real
vocabulary.  The greedy tokens must equal the reference's.  A token may
differ only where the reference's own top-2 margin at that step is below
the logit tolerance of ``tests/test_torch_lm.py`` (2 bfloat16 ulps of the
step's largest logit: XLA's CPU ``rsqrt`` estimate and its sum order flip
a rounding now and then), and then the test shows that margin.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import jax
import numpy as np
import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.core import jaxrand
from repro_torch.examples import serve_lm
from repro_torch.launch import serve
from repro_torch.models import lm as LM

LOGIT_ULPS = 2
ARCHS = ("qwen2.5-14b", "starcoder2-15b", "internvl2-2b")


def _ref_prompts(vocab_size, requests=4):
    """The prompts of the reference's ``main()``, as it draws them."""
    rng = np.random.default_rng(0)
    return [rng.integers(2, vocab_size, size=rng.integers(4, 10))
            for _ in range(requests)]


@pytest.mark.parametrize("arch", ARCHS)
def test_server_tokens_equal_the_reference(arch):
    jsrv = jserve.Server(arch, reduced=True)
    steps = []                                  # the reference's logits
    decode = jsrv.decode

    def recording(params, caches, batch):
        logits, caches = decode(params, caches, batch)
        steps.append(np.asarray(logits[0, -1].astype(np.float32)))
        return logits, caches
    jsrv.decode = recording
    srv = serve.Server(arch, reduced=True, device="cpu")
    assert srv.cfg.name == jsrv.cfg.name
    assert srv.cfg.vocab_size == jsrv.cfg.vocab_size
    srv.params = LM.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jsrv.params), srv.cfg,
        device="cpu")
    prompts = serve.prompts_for(srv.cfg, 4)
    want_prompts = _ref_prompts(jsrv.cfg.vocab_size)
    assert all(np.array_equal(a, b) for a, b in zip(prompts, want_prompts))
    want = jsrv.submit_and_run(want_prompts, max_new=8)
    got = srv.submit_and_run(prompts, max_new=8)
    assert [len(o) for o in got] == [8] * 4
    step = 0
    for r, (g, w, prompt) in enumerate(zip(got, want, prompts)):
        step += len(prompt) - 1                 # the teacher-forced steps
        for j, (a, b) in enumerate(zip(g, w)):
            if a != b:
                logits = steps[step + j][:srv.cfg.vocab_size]
                top2 = np.sort(logits)[-2:]
                ulp = 2.0 ** (np.floor(np.log2(np.abs(logits).max())) - 7)
                assert top2[1] - top2[0] <= LOGIT_ULPS * ulp, \
                    (arch, r, j, a, b, top2)
                break                           # the rest follows the fork
        step += len(w)


def test_server_needs_a_card_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.Server("qwen2.5-14b")
    cfg = serve.get_config("qwen2.5-14b").reduced()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LM.init_lm(jaxrand.PRNGKey(0, device="cpu"), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LM.init_cache(cfg, 1, 8)


def test_full_width_config_is_the_published_one():
    """``Server(arch, reduced=False)`` serves the architecture at its
    published width; built here on the meta device only, so that nothing
    is allocated: qwen2.5-14b holds 14.77 B parameters, 29.5 GB in
    bfloat16."""
    cfg = serve.get_config("qwen2.5-14b")
    params = LM.init_lm(jaxrand.PRNGKey(0, device="cpu"), cfg,
                        device="meta")
    n = sum(a.numel() for a in LM.leaves(params))
    assert 14.7e9 < n < 14.8e9
    assert cfg.vocab_padded == cfg.vocab_size == 152064
    assert LM.param_bytes(params) == 2 * n + 2 * sum(
        a.numel() for a in LM.leaves(params) if a.dtype == torch.float32)


def test_serve_main_and_the_example(capsys):
    serve.main(["--device", "cpu", "--requests", "2", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "[serve] req1:" in out and "tok/s" in out
    serve_lm.main(["internvl2-2b", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[serve] req3:" in out and "32 tokens" in out


def test_crosscheck_of_the_cpu_against_itself():
    """``launch.crosscheck.card_against_cpu``, the check that the card
    tests and ``chip_smoke.py`` run, with the CPU in the card's place: no
    gap anywhere, the same greedy tokens."""
    from repro_torch.launch import crosscheck
    out = crosscheck.card_against_cpu("internvl2-2b", "cpu", steps=4,
                                      requests=2, max_new=3)
    assert out == {"prefill_ulps": 0.0, "prefill_cache_ulps": 0.0,
                   "decode_ulps": 0.0, "decode_cache_ulps": 0.0,
                   "forks": [], "tokens_equal": True}


def test_crosscheck_fork_rule():
    """A greedy fork passes only where the reference's top-2 margin is
    within ``LM_ULPS`` bfloat16 ulps of the step's largest logit."""
    from repro_torch.launch import crosscheck
    prompts = [np.arange(2)]            # one teacher-forced step
    ulp = 2.0 ** -7                     # of a largest logit of 1.0

    def rows(margin_ulps):
        fork = torch.tensor([0.0, 1.0, 1.0 - margin_ulps * ulp, -1.0])
        return [torch.zeros(4), torch.eye(4)[1], fork]
    forks = crosscheck.greedy_forks([[1, 2]], [[1, 1]],
                                    rows(crosscheck.LM_ULPS), prompts, 4)
    assert forks == [dict(request=0, token=1,
                          margin_ulps=float(crosscheck.LM_ULPS))]
    with pytest.raises(AssertionError, match="top-2 margin"):
        crosscheck.greedy_forks([[1, 2]], [[1, 1]],
                                rows(crosscheck.LM_ULPS + 1), prompts, 4)
    assert crosscheck.greedy_forks([[1, 1]], [[1, 1]], rows(8), prompts,
                                   4) == []
