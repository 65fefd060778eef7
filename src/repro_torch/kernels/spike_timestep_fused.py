"""The K-step fused timestep: CUDA kernel wrapper and its plain version.

Twin of the Pallas ``spike_timestep_fused_kernel`` in
:mod:`repro.kernels.spike_timestep`. The kernel is CUDA C++ for
``sm_90a`` (``csrc/spike_timestep_fused.cu``), built with ``nvcc`` at
first use into ``build/repro_torch/`` and loaded with ``ctypes``
(:mod:`repro_torch.kernels._build`).

Both functions take the padded operands
:func:`repro_torch.kernels.ops.spike_timestep_fused` prepares::

    activity:   (B / block_batch, n_ext / 128) int32 window-OR gate scalars
    ext_packed: (K, B, n_ext / 32) int32 lanes of bitpacked external spikes
    w_ext:      (n_ext, P) int32 raw Q16.16 external rows
    w_rec:      (P, P) int32 recurrent rows
    v, spikes:  (B, P) int32 carries at window entry
    active:     (K, B) int32 per-(step, example) advance mask

and return ``(v_out, spikes_carry, raster)``: the carries at window exit,
each ``(B, P)``, and the emitted ``(K, B, P)`` raster, all int32.

:func:`spike_timestep_fused` launches the kernel for CUDA tensors and
runs :func:`spike_timestep_fused_plain` for CPU tensors; there is no
fallback from one to the other. ``LAUNCHES["spike_timestep_fused"]``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import bitpack
from repro_torch.kernels._build import CSRC, LAUNCHES, CudaLibrary
from repro_torch.kernels.epilogue import decay_and_fire, validate_decay
from repro_torch.kernels.spike_timestep import (
    BLOCK_SRC,
    RESET_CODES,
    block_product,
    decay_codes,
)

__all__ = [
    "LAUNCHES",
    "SOURCE",
    "build",
    "spike_timestep_fused",
    "spike_timestep_fused_cuda",
    "spike_timestep_fused_plain",
]

_BLOCK_BATCHES = (1, 8)  # batch-tile heights the kernel is built for

SOURCE = CSRC / "spike_timestep_fused.cu"
_LIB = CudaLibrary(SOURCE, "spike_timestep_fused_launch",
                   [ctypes.c_void_p] * 10 + [ctypes.c_int] * 11
                   + [ctypes.c_void_p])


def build():
    """Compile ``csrc/spike_timestep_fused.cu`` unless a build of this
    exact source exists. Returns ``(library path, compiler output)``."""
    return _LIB.build()


def _check(activity, ext_packed, w_ext, w_rec, v, spikes, active, *,
           block_batch, decay_kind, decay_rate, decay_raw, reset_mode):
    validate_decay(decay_kind, decay_rate, decay_raw)
    if reset_mode not in RESET_CODES:
        raise ValueError(f"unknown reset mode {reset_mode!r}; expected one "
                         f"of {tuple(RESET_CODES)}")
    named = (("activity", activity, 2), ("ext_packed", ext_packed, 3),
             ("w_ext", w_ext, 2), ("w_rec", w_rec, 2), ("v", v, 2),
             ("spikes", spikes, 2), ("active", active, 2))
    for name, t, ndim in named:
        if t.dtype != torch.int32 or t.ndim != ndim:
            raise ValueError(f"{name} must be a {ndim}-D int32 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != v.device:
            raise ValueError(f"{name} is on {t.device}, v on {v.device}")
    K, B, lanes = ext_packed.shape
    n_ext, P = w_ext.shape
    if (K < 1 or n_ext != 32 * lanes or n_ext % BLOCK_SRC or n_ext == 0
            or B % block_batch or P % 128 or tuple(w_rec.shape) != (P, P)
            or tuple(v.shape) != (B, P) or tuple(spikes.shape) != (B, P)
            or tuple(active.shape) != (K, B)
            or tuple(activity.shape) != (B // block_batch,
                                         n_ext // BLOCK_SRC)):
        raise ValueError(
            f"shapes must be pre-padded to block multiples: ext_packed "
            f"{tuple(ext_packed.shape)}, w_ext {tuple(w_ext.shape)}, w_rec "
            f"{tuple(w_rec.shape)}, v {tuple(v.shape)}, spikes "
            f"{tuple(spikes.shape)}, active {tuple(active.shape)}, activity "
            f"{tuple(activity.shape)}, block_batch {block_batch}")
    return K, B, n_ext, P


def spike_timestep_fused_cuda(activity, ext_packed, w_ext, w_rec, v, spikes,
                              active, *, threshold_raw: int, reset_mode: str,
                              decay_kind: str = "shift",
                              decay_rate: float = 0.0, decay_raw: int = 0,
                              use_f32: bool = False, block_batch: int = 8):
    """Launch the CUDA kernel on the current stream (no synchronisation)."""
    K, B, n_ext, P = _check(
        activity, ext_packed, w_ext, w_rec, v, spikes, active,
        block_batch=block_batch, decay_kind=decay_kind,
        decay_rate=decay_rate, decay_raw=decay_raw, reset_mode=reset_mode)
    if v.device.type != "cuda":
        raise ValueError(f"spike_timestep_fused_cuda needs CUDA tensors, "
                         f"got {v.device}")
    if block_batch not in _BLOCK_BATCHES:
        raise ValueError(f"the kernel is built for block_batch in "
                         f"{_BLOCK_BATCHES}, got {block_batch}")
    tensors = (activity, ext_packed, w_ext, w_rec, v, spikes, active)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("spike_timestep_fused_cuda needs contiguous tensors")
    decay_mode, shift = decay_codes(decay_kind, decay_rate)
    v_out = torch.empty_like(v)
    spk_out = torch.empty_like(v)
    raster = torch.empty((K, B, P), dtype=torch.int32, device=v.device)
    launch = _LIB.function
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        err = launch(
            *(t.data_ptr() for t in tensors), v_out.data_ptr(),
            spk_out.data_ptr(), raster.data_ptr(), K, B, n_ext, P,
            block_batch, int(bool(use_f32)), decay_mode, shift,
            int(decay_raw), int(threshold_raw), RESET_CODES[reset_mode],
            stream)
    if err != 0:
        raise RuntimeError(f"spike_timestep_fused kernel launch failed with "
                           f"CUDA error {err}")
    LAUNCHES["spike_timestep_fused"] += 1
    return v_out, spk_out, raster


def spike_timestep_fused_plain(activity, ext_packed, w_ext, w_rec, v,
                               spikes, active, *, threshold_raw: int,
                               reset_mode: str, decay_kind: str = "shift",
                               decay_rate: float = 0.0, decay_raw: int = 0,
                               use_f32: bool = False, block_batch: int = 8):
    """Plain PyTorch version of the kernel, on any device: K chained steps.

    The gate only skips blocks that add nothing, so ``activity`` is
    checked for shape and otherwise ignored, as in the single-step plain
    version. Each product is :func:`block_product` (exact, or per-block
    float32 truncated toward zero), the step ends in the shared
    epilogue, and inactive (step, example) pairs keep their carry and
    emit zero spikes.
    """
    K, B, n_ext, P = _check(
        activity, ext_packed, w_ext, w_rec, v, spikes, active,
        block_batch=block_batch, decay_kind=decay_kind,
        decay_rate=decay_rate, decay_raw=decay_raw, reset_mode=reset_mode)
    ext = bitpack.unpack_spikes(ext_packed, n_ext).reshape(K * B, n_ext)
    ext_syn = block_product(ext, w_ext, use_f32=use_f32).reshape(K, B, P)
    raster = torch.empty((K, B, P), dtype=torch.int32, device=v.device)
    for k in range(K):
        syn = ext_syn[k].to(torch.int64) + block_product(
            spikes, w_rec, use_f32=use_f32).to(torch.int64)
        v_new, s_new = decay_and_fire(
            v, syn, decay_kind=decay_kind, decay_rate=decay_rate,
            decay_raw=decay_raw, threshold_raw=threshold_raw,
            reset_mode=reset_mode)
        keep = (active[k] != 0)[:, None]
        v = torch.where(keep, v_new, v)
        spikes = torch.where(keep, s_new, spikes)
        raster[k] = torch.where(keep, s_new, 0)
    return v, spikes, raster


def spike_timestep_fused(activity, ext_packed, w_ext, w_rec, v, spikes,
                         active, **kwargs):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    args = (activity, ext_packed, w_ext, w_rec, v, spikes, active)
    if v.device.type == "cuda":
        return spike_timestep_fused_cuda(*args, **kwargs)
    if v.device.type == "cpu":
        return spike_timestep_fused_plain(*args, **kwargs)
    raise ValueError(f"no spike_timestep_fused for device {v.device}")
