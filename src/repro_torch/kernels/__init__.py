"""Hand-written Hopper kernels of the port, and what their wrappers share.

Each kernel package holds ``ops.py`` (the wrapper the model calls),
``ref.py`` (the plain PyTorch version of the same function) and its CUDA
C++ source under ``csrc/``.  A source is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface the first time a
wrapper launches it, and loaded through ``ctypes`` (``load_library``).
Nothing is built or imported from CUDA when a module is imported, so the
package imports and its CPU tests run on a machine without ``nvcc``.

The build goes to ``build/kernels/`` under the repository root, one
library per source content hash, so a changed source rebuilds and an
unchanged one is reused.

``resolve_device`` is the port's device rule: ``None`` means CUDA, and
without a card only an explicit ``device="cpu"`` runs.  A wrapper picks
the plain version only for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises, and a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Sequence

import torch

BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def resolve_device(device=None) -> torch.device:
    """The port's device rule: ``None`` means ``"cuda"``; a CUDA device
    without a card raises instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the port's kernels")


def library_path(name: str, sources: Sequence[pathlib.Path]) -> pathlib.Path:
    """Where the library built from ``sources`` lives (content-addressed)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_library(name: str, sources: Sequence[pathlib.Path]
                  ) -> pathlib.Path:
    """Compile ``sources`` into a shared library unless it is built.
    Returns its path; the compiler's output is kept beside it as
    ``<lib>.log``.  Raises ``RuntimeError`` with the log if nvcc fails."""
    out = library_path(name, sources)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    out.with_name(out.name + ".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed building {name}:\n{log}")
    os.replace(tmp, out)
    return out


def load_library(name: str, sources: Sequence[pathlib.Path],
                 declare) -> ctypes.CDLL:
    """Build (at first use) and load one kernel library.  ``declare(lib)``
    sets the ``argtypes``/``restype`` of its C functions once."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_library(name, sources)))
            declare(lib)
            _LIBS[name] = lib
        return lib


class LaunchCount:
    """Launches of one kernel since the last ``reset``, in every thread.
    A wrapper adds one where it launches its kernel, and nowhere else
    (``add``, under a lock: the pools of a sharded server may launch from
    threads of their own)."""

    def __init__(self):
        self.launches = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self.launches += n

    def reset(self) -> None:
        with self._lock:
            self.launches = 0


def check_launch(lib: ctypes.CDLL, name: str, status: int) -> None:
    """Raise if a kernel's C entry returned a CUDA error code.  Every
    kernel library exports ``cuda_error_string`` for the message."""
    if status != 0:
        msg = lib.cuda_error_string(status).decode()
        raise RuntimeError(f"{name}: CUDA error {status} ({msg})")
