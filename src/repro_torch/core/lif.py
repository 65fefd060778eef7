"""Leaky integrate-and-fire neurons, hardware model (int32 Q16.16).

Twin of :mod:`repro.core.lif` for the serving slice: the LIF parameters,
the single fire/reset definition every datapath shares, the power-on
state, the bit-exact fixed-point step, the float32 software-reference
step, and the surrogate-gradient training step (:func:`surrogate_spike`,
an autograd Function, and :func:`lif_step_train`).

Reset modes (paper §IV-B): ``hold`` keeps the membrane on a spike,
``zero`` clears it, ``subtract`` removes the threshold.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np
import torch

from repro_torch.core import fixedpoint as fxp

__all__ = [
    "LIFParams",
    "LIFState",
    "RESET_MODES",
    "fire_reset",
    "lif_init",
    "lif_step_fixed",
    "lif_step_float",
    "lif_step_train",
    "surrogate_spike",
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


class LIFState:
    """Namespace marker; state is a plain dict: {'v': tensor}."""


def lif_init(shape, *, fixed: bool = False, device="cpu") -> dict:
    dtype = torch.int32 if fixed else torch.float32
    return {"v": torch.zeros(shape, dtype=dtype, device=device)}


def fire_reset(v_new: torch.Tensor, threshold, reset_mode: str):
    """Threshold compare (``>=``) and reset.

    On int32 potentials (an int raw ``threshold``) returns ``(v_out,
    spikes)``, both int32, spikes in {0, 1}; the subtract reset wraps mod
    2^32 like the hardware adder. On float32 potentials (the software
    reference, a float ``threshold``) both are float32 and the subtract
    reset is a float subtract, as in the twin.
    """
    floating = v_new.is_floating_point()
    spikes = (v_new >= threshold).to(v_new.dtype if floating
                                     else torch.int32)
    if reset_mode == "zero":
        v_out = torch.where(spikes > 0, torch.zeros_like(v_new), v_new)
    elif reset_mode == "subtract" and floating:
        v_out = v_new - spikes * threshold
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


def lif_step_float(state: dict, syn_input: torch.Tensor, params: LIFParams):
    """Software-reference LIF step (float32): ``v * beta``, then the add,
    then :func:`fire_reset` at the float32 threshold.

    ``beta`` and the threshold are rounded to float32 first, as the twin's
    weakly typed ``v * beta`` and ``jnp.float32(threshold)`` are, so each
    of the two operations is one correctly rounded float32 op.
    Returns ``({'v': v_out}, spikes)``, float32, spikes in {0, 1}.
    """
    beta = float(np.float32(params.beta))
    threshold = float(np.float32(params.threshold))
    v_new = state["v"] * beta + syn_input
    v_out, spikes = fire_reset(v_new, threshold, params.reset_mode)
    return {"v": v_out}, spikes


# --------------------------------------------------------------------------
# Surrogate gradient (training): the fast-sigmoid surrogate of Zenke &
# Ganguli, as the twin's ``jax.custom_vjp``
# --------------------------------------------------------------------------

class _SurrogateSpike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v_minus_thr, slope):
        ctx.save_for_backward(v_minus_thr)
        ctx.slope = float(np.float32(slope))
        return (v_minus_thr >= 0.0).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        denom = 1.0 + ctx.slope * torch.abs(v)
        return g / (denom * denom), None


def surrogate_spike(v_minus_thr: torch.Tensor,
                    slope: float = 25.0) -> torch.Tensor:
    """Heaviside spike ``(v >= 0)`` as float32, with the fast-sigmoid
    surrogate gradient ``g / (1 + slope * |v|)^2``; no gradient for
    ``slope``."""
    return _SurrogateSpike.apply(v_minus_thr, slope)


def lif_step_train(state: dict, syn_input: torch.Tensor, params: LIFParams,
                   slope: float = 25.0):
    """Differentiable LIF step for BPTT surrogate-gradient training.

    ``v * beta + syn``, spike on ``v_new - threshold``, then the reset with
    its gate detached (the twin's ``stop_gradient``): ``zero`` multiplies
    by ``1 - spikes``, ``subtract`` removes ``spikes * threshold``,
    ``hold`` keeps ``v_new``. Returns ``({'v': v_out}, spikes)``.
    """
    beta = float(np.float32(params.beta))
    threshold = float(np.float32(params.threshold))
    v_new = state["v"] * beta + syn_input
    spikes = surrogate_spike(v_new - threshold, slope)
    if params.reset_mode == "zero":
        v_out = v_new * (1.0 - spikes.detach())
    elif params.reset_mode == "subtract":
        v_out = v_new - spikes.detach() * threshold
    elif params.reset_mode == "hold":
        v_out = v_new
    else:
        raise ValueError(f"unknown reset mode {params.reset_mode!r}; "
                         f"expected one of {RESET_MODES}")
    return {"v": v_out}, spikes
