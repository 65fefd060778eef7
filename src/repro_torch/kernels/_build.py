"""Build and bind the port's CUDA kernels, and count their launches.

Each kernel is one CUDA C++ source under ``csrc/`` with a plain C entry
point. It is compiled by ``nvcc`` for ``sm_90a`` at first use into
``build/repro_torch/`` at the repository root (gitignored) and loaded
with ``ctypes``. The library's name carries a digest of the source and of
the shared headers beside it, so an edited kernel is rebuilt and an
unchanged one is reused. A failed build raises with ``nvcc``'s errors.
The first build is safe under threads: a library builds and binds under
its own lock, so two threads that launch the same kernel first compile it
once, and every temporary file is named by process and thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

__all__ = ["CSRC", "LAUNCHES", "NVCC_FLAGS", "CudaLibrary"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel launches since import (or since a caller reset them), one count
#: per kernel; only a wrapper that launches its kernel increments its own
LAUNCHES = {"spike_timestep": 0, "spike_timestep_fused": 0, "lif_step": 0,
            "poisson_encode": 0}


def _build_dir() -> pathlib.Path:
    # src/repro_torch/kernels/_build.py -> repository root
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc(source: pathlib.Path) -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            f"nvcc not found: the CUDA kernel {source.name} is built at "
            f"first use and needs the CUDA toolkit")
    return nvcc


class CudaLibrary:
    """One kernel source, its build and its ``ctypes`` entry point."""

    def __init__(self, source: pathlib.Path, entry: str, argtypes):
        self.source = pathlib.Path(source)
        self.entry = entry
        self.argtypes = list(argtypes)
        self._lock = threading.Lock()
        self._function = None

    def digest(self) -> str:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            h.update(header.read_bytes())
        return h.hexdigest()[:16]

    def build(self) -> tuple[pathlib.Path, str]:
        """Compile the source unless a build of this exact source exists.
        Returns ``(library path, compiler output)``; the output is empty
        when the cached build was reused."""
        with self._lock:
            return self._build()

    def _build(self) -> tuple[pathlib.Path, str]:
        out = _build_dir() / f"lib{self.source.stem}_{self.digest()}.so"
        if out.exists():
            return out, ""
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(
            f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
        proc = subprocess.run(
            [_nvcc(self.source), *NVCC_FLAGS, "-o", str(tmp),
             str(self.source)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {self.source}:\n{proc.stderr}")
        os.replace(tmp, out)
        return out, proc.stdout + proc.stderr

    @property
    def function(self):
        """The C entry point, building the library first if needed."""
        fn = self._function
        if fn is not None:
            return fn
        with self._lock:
            if self._function is None:
                path, _ = self._build()
                fn = getattr(ctypes.CDLL(str(path)), self.entry)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._function = fn
            return self._function
