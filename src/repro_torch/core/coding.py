"""Spike encoding / decoding — the SoC's Coding Hardware Unit.

Twin of :mod:`repro.core.coding`. The Poisson encoder draws its uniforms
from :mod:`repro_torch.core.prng`, the port's bit-exact copy of JAX's
threefry, so a key gives the JAX package's spikes, on the CPU and on the
card alike.
"""

from __future__ import annotations

import torch

from repro_torch.core import prng

__all__ = [
    "analog_decode",
    "classify_decode",
    "latency_encode",
    "poisson_encode",
    "rate_decode",
]


def poisson_encode(key, intensities, num_steps: int,
                   dtype=torch.float32) -> torch.Tensor:
    """Poisson (Bernoulli per step) rate coding.

    key: a :mod:`~repro_torch.core.prng` key. intensities: (..., D) floats
    in [0, 1], clipped, in float32; the spikes are computed on their
    device. Returns (T, ..., D) spikes in {0, 1} of ``dtype``; a NaN
    intensity never fires.
    """
    x = torch.clamp(torch.as_tensor(intensities).to(torch.float32), 0.0, 1.0)
    u = prng.uniform(key, (num_steps,) + tuple(x.shape), device=x.device)
    return (u < x[None]).to(dtype)


def latency_encode(intensities, num_steps: int,
                   dtype=torch.float32) -> torch.Tensor:
    """Time-to-first-spike coding: stronger input -> earlier single spike;
    intensity 0 never fires."""
    x = torch.clamp(torch.as_tensor(intensities, dtype=torch.float32),
                    0.0, 1.0)
    t_fire = torch.where(
        x > 0,
        torch.round((1.0 - x) * (num_steps - 1)).to(torch.int32),
        torch.full_like(x, num_steps, dtype=torch.int32),
    )
    t_axis = torch.arange(num_steps, dtype=torch.int32, device=x.device)
    t_axis = t_axis.reshape((num_steps,) + (1,) * x.ndim)
    return (t_axis == t_fire[None]).to(dtype)


def rate_decode(spikes: torch.Tensor) -> torch.Tensor:
    """Sum spikes over the leading time axis -> (..., D) counts."""
    return spikes.sum(dim=0)


def classify_decode(spikes: torch.Tensor) -> torch.Tensor:
    """Spike-count classification: argmax (first maximum) of the counts."""
    return torch.argmax(rate_decode(spikes), dim=-1)


def analog_decode(spikes: torch.Tensor, lo: float = 0.0,
                  hi: float = 1.0) -> torch.Tensor:
    """Reconstruct an analog value from the firing rate."""
    rate = rate_decode(spikes) / spikes.shape[0]
    return lo + rate * (hi - lo)
