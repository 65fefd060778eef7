"""The fused LIF update: CUDA kernel wrapper and its plain version.

Twin of :mod:`repro.kernels.lif_step` (the Pallas ``lif_step_kernel``).
The kernel is CUDA C++ for ``sm_90a`` (``csrc/lif_step.cu``), built with
``nvcc`` at first use and loaded with ``ctypes``
(:mod:`repro_torch.kernels._build`). Its plain version is the oracle
:func:`repro_torch.kernels.ref.lif_step_ref`.

:func:`lif_step` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; there is no fallback from one to the other.
``LAUNCHES["lif_step"]`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CSRC, LAUNCHES, CudaLibrary
from repro_torch.kernels.epilogue import validate_decay
from repro_torch.kernels.ref import lif_step_ref
from repro_torch.kernels.spike_timestep import RESET_CODES, decay_codes

__all__ = ["LAUNCHES", "SOURCE", "build", "lif_step", "lif_step_cuda"]

SOURCE = CSRC / "lif_step.cu"
_LIB = CudaLibrary(SOURCE, "lif_step_launch",
                   [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def build():
    """Compile ``csrc/lif_step.cu`` unless a build of this exact source
    exists. Returns ``(library path, compiler output)``."""
    return _LIB.build()


def _check(v, syn, *, decay_rate, threshold_raw, reset_mode):
    validate_decay("shift", decay_rate, 0)
    if reset_mode not in RESET_CODES:
        raise ValueError(f"unknown reset mode {reset_mode!r}; expected one "
                         f"of {tuple(RESET_CODES)}")
    if not -(1 << 31) <= int(threshold_raw) < (1 << 31):
        raise ValueError(f"threshold_raw {threshold_raw} is not an int32")
    for name, t in (("v", v), ("syn", syn)):
        if t.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {t.dtype}")
    if v.shape != syn.shape or v.device != syn.device:
        raise ValueError(f"v {tuple(v.shape)} on {v.device} and syn "
                         f"{tuple(syn.shape)} on {syn.device} differ")


def lif_step_cuda(v, syn, *, decay_rate: float, threshold_raw: int,
                  reset_mode: str):
    """Launch the CUDA kernel on the current stream (no synchronisation).
    Returns ``(v_out, spikes)``, int32, of ``v``'s shape."""
    _check(v, syn, decay_rate=decay_rate, threshold_raw=threshold_raw,
           reset_mode=reset_mode)
    if v.device.type != "cuda":
        raise ValueError(f"lif_step_cuda needs CUDA tensors, got {v.device}")
    v, syn = v.contiguous(), syn.contiguous()
    v_out = torch.empty_like(v)
    spikes = torch.empty_like(v)
    if v.numel() == 0:  # no work, nothing to launch
        return v_out, spikes
    decay_mode, shift = decay_codes("shift", decay_rate)
    launch = _LIB.function
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = launch(v.data_ptr(), syn.data_ptr(), v_out.data_ptr(),
                     spikes.data_ptr(), v.numel(), decay_mode, shift,
                     int(threshold_raw), RESET_CODES[reset_mode], stream)
    if err != 0:
        raise RuntimeError(f"lif_step kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES["lif_step"] += 1
    return v_out, spikes


def lif_step(v, syn, *, decay_rate: float, threshold_raw: int,
             reset_mode: str = "zero"):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    kw = dict(decay_rate=decay_rate, threshold_raw=threshold_raw,
              reset_mode=reset_mode)
    if v.device.type == "cuda":
        return lif_step_cuda(v, syn, **kw)
    if v.device.type == "cpu":
        _check(v, syn, **kw)
        return lif_step_ref(v, syn, **kw)
    raise ValueError(f"no lif_step for device {v.device}")
