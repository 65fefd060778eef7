"""Leaky integrate-and-fire neurons, hardware model (int32 Q16.16).

Twin of :mod:`repro.core.lif` for the serving slice: the LIF parameters,
the single fire/reset definition every datapath shares, the power-on
state and the bit-exact fixed-point step. The surrogate-gradient training
step waits for the training slice.

Reset modes (paper §IV-B): ``hold`` keeps the membrane on a spike,
``zero`` clears it, ``subtract`` removes the threshold.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from repro_torch.core import fixedpoint as fxp

__all__ = [
    "LIFParams",
    "RESET_MODES",
    "fire_reset",
    "lif_init",
    "lif_step_fixed",
]

ResetMode = Literal["hold", "zero", "subtract"]
RESET_MODES: tuple[str, ...] = ("hold", "zero", "subtract")


@dataclasses.dataclass(frozen=True)
class LIFParams:
    """Static LIF configuration."""

    decay_rate: float = 0.25          # fraction of potential removed / step
    threshold: float = 1.0
    reset_mode: ResetMode = "zero"
    fmt: fxp.FixedPointFormat = fxp.Q16_16

    @property
    def beta(self) -> float:
        """Retain factor (snnTorch convention)."""
        return 1.0 - self.decay_rate

    @property
    def threshold_raw(self) -> int:
        return int(round(self.threshold * self.fmt.scale))


def lif_init(shape, *, fixed: bool = False, device="cpu") -> dict:
    dtype = torch.int32 if fixed else torch.float32
    return {"v": torch.zeros(shape, dtype=dtype, device=device)}


def fire_reset(v_new: torch.Tensor, threshold: int, reset_mode: str):
    """Threshold compare (``>=``) and reset on int32 potentials.

    Returns ``(v_out, spikes)``, both int32, spikes in {0, 1}. The
    subtract reset wraps mod 2^32 like the hardware adder.
    """
    spikes = (v_new >= threshold).to(torch.int32)
    if reset_mode == "zero":
        v_out = torch.where(spikes > 0, torch.zeros_like(v_new), v_new)
    elif reset_mode == "subtract":
        v_out = fxp.wrap_int32(v_new.to(torch.int64)
                               - spikes.to(torch.int64) * int(threshold))
    elif reset_mode == "hold":
        v_out = v_new
    else:
        raise ValueError(f"unknown reset mode {reset_mode!r}; "
                         f"expected one of {RESET_MODES}")
    return v_out, spikes


def lif_step_fixed(state: dict, syn_input_raw: torch.Tensor,
                   params: LIFParams):
    """Hardware-model LIF step: shift decay, wrapping integrate, fire."""
    v_decayed = fxp.shift_decay(state["v"], params.decay_rate)
    v_new = fxp.wrap_int32(v_decayed.to(torch.int64)
                           + syn_input_raw.to(torch.int64))
    v_out, spikes = fire_reset(v_new, params.threshold_raw,
                               params.reset_mode)
    return {"v": v_out}, spikes
