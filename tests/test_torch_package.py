"""Package rules of the PyTorch port (repro_torch).

* It imports neither JAX nor anything of the JAX package ``repro``, and
  neither does the card check script ``chip_smoke.py``.
* Entry points take ``device=None`` meaning CUDA; without a card they
  raise unless the caller passes ``device="cpu"``.
* SA noise serves: each stream's noise field is keyed by
  ``fold_in(PRNGKey(seed), uid)``.
"""

import _torch_threads  # noqa: F401  (first: caps torch's CPU threads)
import ast
import pathlib

import pytest
import torch

from repro_torch import kernels
from repro_torch.core import jaxrand
from repro_torch.models import kws
from repro_torch.serving import stream as sv
from repro_torch.serving.scheduler import StreamServer

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
CFG = kws.KWSConfig(sample_len=640)


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax_or_the_reference(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(ROOT)} imports {mod}"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def hw_cpu():
    params = kws.init_params(jaxrand.PRNGKey(0, device="cpu"), CFG,
                             device="cpu")
    return kws.fold_params(params, kws.init_state(CFG, device="cpu"), CFG,
                           pack=True)


def test_resolve_device_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kernels.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kernels.resolve_device("cuda")
    assert kernels.resolve_device("cpu") == torch.device("cpu")


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, hw_cpu):
    key = jaxrand.PRNGKey(0, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kws.init_params(key, CFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kws.hw_forward(hw_cpu, torch.zeros(1, CFG.sample_len), CFG)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sv.StreamEngine(hw_cpu, CFG, 64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamServer(hw_cpu, CFG, hop=64)
    srv = StreamServer(hw_cpu, CFG, hop=64, device="cpu")
    assert srv.stats()["device"] == "cpu"


def test_parameters_must_live_on_the_serving_device(hw_cpu):
    with pytest.raises(ValueError, match="not on meta"):
        kws.hw_forward(hw_cpu, torch.zeros(1, CFG.sample_len), CFG,
                       device="meta")


def test_sa_noise_is_rejected_until_ported(hw_cpu):
    """SA noise was rejected until the PRNG was ported; now a noisy server
    serves, every stream under its own noise-field key."""
    from repro_torch.core import jaxrand
    srv = StreamServer(hw_cpu, CFG, hop=64, sa_noise_std=0.5, seed=3,
                       device="cpu")
    for sid in ("a", "b"):
        srv.submit(sid, torch.linspace(-1, 1, CFG.sample_len + 64).numpy())
        srv.finish(sid)
    assert len(srv.drain()) == 4
    assert torch.equal(srv.stream_key(1), jaxrand.fold_in(
        jaxrand.PRNGKey(3, "cpu"), 1))


def test_kernel_library_is_content_addressed():
    """The built library lives in the build directory under a name that
    follows the source's content and the compile flags (sm_90a)."""
    from repro_torch.kernels.imc_mav import ops
    path = kernels.library_path("imc_fused", [ops.SOURCE])
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("libimc_fused-") and path.suffix == ".so"
    assert "sm_90a" in " ".join(kernels.NVCC_FLAGS)
