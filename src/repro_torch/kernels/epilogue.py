"""Decay + Potential-Adder epilogue shared by every timestep datapath.

Twin of :mod:`repro.kernels.epilogue`. The plain PyTorch timestep and the
engine's reference backend end a step here; the CUDA kernel
(``csrc/spike_timestep.cu``) repeats the same integer arithmetic in
registers and is held byte-equal to this on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.core.lif import fire_reset

__all__ = ["DECAY_KINDS", "SHIFT_RATES", "decay_and_fire", "validate_decay"]

# "shift": Cerebra-H arithmetic-shift decay, rate in SHIFT_RATES.
# "mul":   Cerebra-S truncating multiply by a raw Q16.16 retain factor.
DECAY_KINDS: tuple[str, ...] = ("shift", "mul")
SHIFT_RATES: tuple[float, ...] = fxp.SHIFT_DECAY_RATES


def validate_decay(decay_kind: str, decay_rate: float, decay_raw: int):
    """Reject a decay configuration before any kernel is launched."""
    if decay_kind == "shift":
        if decay_rate not in SHIFT_RATES:
            raise ValueError(
                f"decay_kind='shift' needs decay_rate in {SHIFT_RATES}, "
                f"got {decay_rate} (did you forget to pass decay_rate?)")
    elif decay_kind == "mul":
        if not 0 <= decay_raw <= (1 << 16):
            raise ValueError(
                f"decay_kind='mul' needs decay_raw in [0, 2^16], got "
                f"{decay_raw} (did you forget to pass decay_raw?)")
    else:
        raise ValueError(f"unknown decay kind {decay_kind!r}; expected one "
                         f"of {DECAY_KINDS}")


def decay_and_fire(v: torch.Tensor, acc: torch.Tensor, *, decay_kind: str,
                   decay_rate: float, decay_raw: int, threshold_raw: int,
                   reset_mode: str):
    """Decay the previous potential, add ``acc`` (wrapping), fire, reset.

    All int32 in and out. Returns ``(v_out, spikes)``.
    """
    if decay_kind == "shift":
        v_decayed = fxp.shift_decay(v, decay_rate)
    elif decay_kind == "mul":
        v_decayed = fxp.fx_mul(v, decay_raw)
    else:
        raise ValueError(f"unknown decay kind {decay_kind!r}; expected one "
                         f"of {DECAY_KINDS}")
    v_new = fxp.wrap_int32(v_decayed.to(torch.int64) + acc.to(torch.int64))
    return fire_reset(v_new, int(threshold_raw), reset_mode)
