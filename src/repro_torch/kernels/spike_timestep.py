"""The event-gated timestep: CUDA kernel wrapper and its plain version.

Twin of :mod:`repro.kernels.spike_timestep` (the Pallas
``spike_timestep_kernel``). The kernel is CUDA C++ for ``sm_90a``
(``csrc/spike_timestep.cu``), built with ``nvcc`` at first use into
``build/repro_torch/`` at the repository root and loaded with ``ctypes``.

Both functions take the padded operands :func:`repro_torch.kernels.ops.
spike_timestep` prepares::

    activity: (B / block_batch, S / 128) int32 gate scalars
    sources:  (B, S) int32 {0,1}
    weights:  (S, P) int32 raw Q16.16
    v:        (B, P) int32

and return ``(v_out, spikes)``, each ``(B, P)`` int32.

:func:`spike_timestep` launches the kernel for CUDA tensors and runs
:func:`spike_timestep_plain` for CPU tensors; there is no fallback from
one to the other. ``LAUNCHES["spike_timestep"]`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

from repro_torch.core.fixedpoint import wrap_int32
from repro_torch.kernels.epilogue import decay_and_fire, validate_decay

__all__ = [
    "BLOCK_SRC",
    "LAUNCHES",
    "NVCC_FLAGS",
    "SOURCE",
    "build",
    "exact_int32_matmul",
    "spike_timestep",
    "spike_timestep_cuda",
    "spike_timestep_plain",
]

BLOCK_SRC = 128  # sources per gate block; the kernel's fixed tile
_TILE_COLS = 128  # neuron columns per CTA
_BLOCK_BATCHES = (1, 8)  # batch-tile heights the kernel is built for

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "spike_timestep.cu"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel launches since import (or since a caller reset it)
LAUNCHES = {"spike_timestep": 0}

_DECAY_SHIFT_SUB, _DECAY_SHIFT, _DECAY_MUL = 0, 1, 2
_SHIFT_CODES = {0.125: (_DECAY_SHIFT_SUB, 3), 0.25: (_DECAY_SHIFT_SUB, 2),
                0.5: (_DECAY_SHIFT_SUB, 1), 0.75: (_DECAY_SHIFT, 2)}
_RESET_CODES = {"zero": 0, "subtract": 1, "hold": 2}


# --------------------------------------------------------------------------
# build and bind
# --------------------------------------------------------------------------
def _build_dir() -> pathlib.Path:
    # src/repro_torch/kernels/spike_timestep.py -> repository root
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the spike_timestep CUDA kernel is built from "
            f"{SOURCE} at first use and needs the CUDA toolkit")
    return nvcc


def build() -> tuple[pathlib.Path, str]:
    """Compile ``csrc/spike_timestep.cu`` unless a build of this exact
    source exists. Returns ``(library path, compiler output)``; the output
    is empty when the cached build was reused."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = _build_dir() / f"libspike_timestep_{digest}.so"
    if out.exists():
        return out, ""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    fn = lib.spike_timestep_launch
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


# --------------------------------------------------------------------------
def _check(activity, sources, weights, v, *, block_batch, decay_kind,
           decay_rate, decay_raw, reset_mode):
    validate_decay(decay_kind, decay_rate, decay_raw)
    if reset_mode not in _RESET_CODES:
        raise ValueError(f"unknown reset mode {reset_mode!r}; expected one "
                         f"of {tuple(_RESET_CODES)}")
    for name, t in (("activity", activity), ("sources", sources),
                    ("weights", weights), ("v", v)):
        if t.dtype != torch.int32 or t.ndim != 2:
            raise ValueError(f"{name} must be a 2-D int32 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != sources.device:
            raise ValueError(f"{name} is on {t.device}, sources on "
                             f"{sources.device}")
    B, S = sources.shape
    P = weights.shape[1]
    if (weights.shape[0] != S or tuple(v.shape) != (B, P)
            or B % block_batch or S % BLOCK_SRC or S == 0 or P % _TILE_COLS
            or tuple(activity.shape) != (B // block_batch, S // BLOCK_SRC)):
        raise ValueError(
            f"shapes must be pre-padded to block multiples: sources "
            f"{tuple(sources.shape)}, weights {tuple(weights.shape)}, v "
            f"{tuple(v.shape)}, activity {tuple(activity.shape)}, "
            f"block_batch {block_batch}")
    return B, S, P


def spike_timestep_cuda(activity, sources, weights, v, *, threshold_raw: int,
                        reset_mode: str, decay_kind: str = "shift",
                        decay_rate: float = 0.0, decay_raw: int = 0,
                        use_f32: bool = False, block_batch: int = 8):
    """Launch the CUDA kernel on the current stream (no synchronisation)."""
    B, S, P = _check(activity, sources, weights, v, block_batch=block_batch,
                     decay_kind=decay_kind, decay_rate=decay_rate,
                     decay_raw=decay_raw, reset_mode=reset_mode)
    if sources.device.type != "cuda":
        raise ValueError(f"spike_timestep_cuda needs CUDA tensors, got "
                         f"{sources.device}")
    if block_batch not in _BLOCK_BATCHES:
        raise ValueError(f"the kernel is built for block_batch in "
                         f"{_BLOCK_BATCHES}, got {block_batch}")
    tensors = (activity, sources, weights, v)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("spike_timestep_cuda needs contiguous tensors")
    if decay_kind == "shift":
        decay_mode, shift = _SHIFT_CODES[decay_rate]
    else:
        decay_mode, shift = _DECAY_MUL, 0
    v_out = torch.empty_like(v)
    spikes = torch.empty_like(v)
    lib = _library()
    with torch.cuda.device(sources.device):
        stream = torch.cuda.current_stream(sources.device).cuda_stream
        err = lib.spike_timestep_launch(
            activity.data_ptr(), sources.data_ptr(), weights.data_ptr(),
            v.data_ptr(), v_out.data_ptr(), spikes.data_ptr(),
            B, S, P, block_batch, int(bool(use_f32)), decay_mode, shift,
            int(decay_raw), int(threshold_raw), _RESET_CODES[reset_mode],
            stream)
    if err != 0:
        raise RuntimeError(f"spike_timestep kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES["spike_timestep"] += 1
    return v_out, spikes


# --------------------------------------------------------------------------
def exact_int32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over int32, wrapped mod 2^32 like JAX's int32 dot.

    On the CPU, torch's int32 matmul wraps the same way. CUDA torch has no
    int32 matmul, so there the product runs in float64 — exact while every
    partial sum stays under 2^53, which holds for int32 operands and a
    {0,1}-valued or count-valued left side over fewer than 2^22 terms — and
    is wrapped to int32 through int64.
    """
    if a.device.type == "cpu":
        return a.to(torch.int32) @ b.to(torch.int32)
    prod = a.to(torch.float64) @ b.to(torch.float64)
    return wrap_int32(prod.to(torch.int64))


def spike_timestep_plain(activity, sources, weights, v, *, threshold_raw: int,
                         reset_mode: str, decay_kind: str = "shift",
                         decay_rate: float = 0.0, decay_raw: int = 0,
                         use_f32: bool = False, block_batch: int = 8):
    """Plain PyTorch version of the kernel, on any device.

    The gate only skips blocks whose sources are all zero, which add
    nothing, so the plain product ignores ``activity`` (its shape is still
    checked): a gate scalar that wrongly reads 0 shows up as a mismatch
    against the kernel. In f32 mode each 128-row block is summed in
    float32 and truncated toward zero before the int32 accumulate, as the
    kernel and the JAX ``use_mxu`` mode do.
    """
    B, S, P = _check(activity, sources, weights, v, block_batch=block_batch,
                     decay_kind=decay_kind, decay_rate=decay_rate,
                     decay_raw=decay_raw, reset_mode=reset_mode)
    if use_f32:
        ns = S // BLOCK_SRC
        s_blocks = sources.reshape(B, ns, BLOCK_SRC).transpose(0, 1)
        w_blocks = weights.reshape(ns, BLOCK_SRC, P)
        partial = torch.bmm(s_blocks.to(torch.float32),
                            w_blocks.to(torch.float32))  # (ns, B, P)
        acc = wrap_int32(partial.to(torch.int32).to(torch.int64).sum(dim=0))
    else:
        acc = exact_int32_matmul(sources, weights)
    return decay_and_fire(v, acc, decay_kind=decay_kind,
                          decay_rate=decay_rate, decay_raw=decay_raw,
                          threshold_raw=threshold_raw, reset_mode=reset_mode)


def spike_timestep(activity, sources, weights, v, **kwargs):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if sources.device.type == "cuda":
        return spike_timestep_cuda(activity, sources, weights, v, **kwargs)
    if sources.device.type == "cpu":
        return spike_timestep_plain(activity, sources, weights, v, **kwargs)
    raise ValueError(f"no spike_timestep for device {sources.device}")
