"""Plain-torch oracles for the port's kernels.

Twin of :mod:`repro.kernels.ref`, with the same names and signatures.
Each function is the exact specification its kernel is held to, on
tensors of any device: :func:`lif_step_ref` and
:func:`poisson_encode_ref` are also the plain versions the
``lif_step`` and ``poisson_encode`` wrappers run for CPU tensors, and
``chip_smoke.py`` compares the CUDA kernels with them on the card.

uint32 has no shifts or compares on CPU torch, so the hash runs in int64
holding values in ``[0, 2^32)``; :func:`hash_u32_ref` returns that int64
tensor where the JAX twin returns uint32.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.epilogue import decay_and_fire
from repro_torch.kernels.spike_timestep import exact_int32_matmul

__all__ = [
    "hash_u32_ref",
    "lif_step_ref",
    "poisson_encode_ref",
    "spike_timestep_ref",
]


def lif_step_ref(v, syn, *, decay_rate: float, threshold_raw: int,
                 reset_mode: str):
    """Oracle for kernels.lif_step — fused hardware LIF update.

    v, syn: (..., N) int32. Returns (v_out, spikes) int32.
    """
    return decay_and_fire(torch.as_tensor(v).to(torch.int32),
                          torch.as_tensor(syn).to(torch.int32),
                          decay_kind="shift", decay_rate=decay_rate,
                          decay_raw=0, threshold_raw=threshold_raw,
                          reset_mode=reset_mode)


def spike_timestep_ref(sources, weights, v, *, decay_rate: float,
                       threshold_raw: int, reset_mode: str):
    """Oracle for kernels.spike_timestep — one fused accelerator timestep.

    sources: (B, S) int32 in {0,1}; weights: (S, P) int32 raw Q16.16;
    v: (B, P) int32. Returns (v_out, spikes_out, syn) int32. The product
    is the exact wrapping int32 one on every device
    (:func:`~repro_torch.kernels.spike_timestep.exact_int32_matmul`).
    """
    syn = exact_int32_matmul(torch.as_tensor(sources).to(torch.int32),
                             torch.as_tensor(weights).to(torch.int32))
    v_out, spikes = lif_step_ref(v, syn, decay_rate=decay_rate,
                                 threshold_raw=threshold_raw,
                                 reset_mode=reset_mode)
    return v_out, spikes, syn


# --------------------------------------------------------------------------
# Counter-based hash encoder (murmur3 finalizer): spike(seed, t, b, d) is a
# pure function, so the kernel, this oracle and the JAX kernel agree bit for
# bit. Every value is a uint32 held in int64.
# --------------------------------------------------------------------------

_U32 = 0xFFFFFFFF
_PRIME_T = 0x9E3779B1   # golden-ratio odd constants
_PRIME_B = 0x85EBCA77
_PRIME_D = 0xC2B2AE3D


def _mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2^32`` for int64 ``a`` in ``[0, 2^32)``: the constant
    goes in 16-bit halves, so no product leaves int64."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _as_u32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _U32
    return torch.as_tensor(np.asarray(x, np.int64) & _U32, device=device)


def hash_u32_ref(seed, t, b, d):
    """Mix (seed, timestep, batch, dim) -> uniform uint32 (held in int64).

    ``t``, ``b``, ``d`` broadcast; each is read mod 2^32, and so is
    ``seed``: a negative seed is its int32 bit pattern, as the kernel
    wrappers pass it (the JAX oracle's ``jnp.uint32(seed)`` refuses one).
    """
    device = next((x.device for x in (t, b, d)
                   if isinstance(x, torch.Tensor)), torch.device("cpu"))
    h = (int(seed) & _U32) ^ _mul_u32(_as_u32(t, device), _PRIME_T)
    h = h ^ _mul_u32(_as_u32(b, device), _PRIME_B)
    h = h ^ _mul_u32(_as_u32(d, device), _PRIME_D)
    h = h ^ (h >> 16)
    h = _mul_u32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul_u32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def poisson_encode_ref(seed: int, intensities, num_steps: int):
    """Oracle for kernels.poisson_encode.

    intensities: (B, D), cast to float32 first. Returns (T, B, D) int32
    {0,1}: spike <=> hash(seed,t,b,d) < (uint32) min(x * 2^32,
    4294967040.0f) or x >= 1, with x clipped to [0, 1]. A NaN intensity
    never fires: the JAX oracle carries it through the clip and the
    minimum into ``astype(uint32)``, which gives 0.
    """
    x = torch.as_tensor(intensities).to(torch.float32)
    B, D = x.shape
    dev = x.device
    t = torch.arange(num_steps, dtype=torch.int64, device=dev)[:, None, None]
    b = torch.arange(B, dtype=torch.int64, device=dev)[None, :, None]
    d = torch.arange(D, dtype=torch.int64, device=dev)[None, None, :]
    h = hash_u32_ref(seed, t, b, d)
    x = torch.clamp(x, 0.0, 1.0)
    thr = torch.clamp(x * 4294967296.0, max=4294967040.0).to(torch.int64)
    thr = torch.where(torch.isnan(x), 0, thr)  # before it met the cast
    fire = (h < thr[None]) | (x[None] >= 1.0)
    return fire.to(torch.int32)
