"""Fixed-point arithmetic of the Cerebra accelerators, on torch tensors.

Twin of :mod:`repro.core.fixedpoint`. Membrane potentials and weights are
Q16.16 signed int32; adds wrap mod 2^32 like the hardware adders; decay is
an arithmetic right shift (Cerebra-H) or a truncating fixed-point multiply
(Cerebra-S).

Wrapping is done explicitly: every add that may overflow runs in int64
and is folded back to int32 by :func:`wrap_int32`, so the result does not
depend on how a backend treats signed int32 overflow. Right shifts of
signed tensors are arithmetic in torch, as in JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "FixedPointFormat",
    "Q16_16",
    "SHIFT_DECAY_RATES",
    "fx_mul",
    "nearest_shift_decay",
    "np_to_fixed",
    "shift_decay",
    "to_fixed",
    "wrap_int32",
]


@dataclasses.dataclass(frozen=True)
class FixedPointFormat:
    """Signed fixed-point format with ``int_bits`` + ``frac_bits`` + sign."""

    int_bits: int = 15
    frac_bits: int = 16

    @property
    def total_bits(self) -> int:
        return self.int_bits + self.frac_bits + 1

    @property
    def scale(self) -> int:
        return 1 << self.frac_bits

    @property
    def max_value(self) -> float:
        return ((1 << (self.int_bits + self.frac_bits)) - 1) / self.scale

    @property
    def min_value(self) -> float:
        return -(1 << self.int_bits)


Q16_16 = FixedPointFormat(15, 16)

# Cerebra-H decay rates (fraction removed per step) reachable by shifts:
#   0.125 -> V - (V >> 3), 0.25 -> V - (V >> 2), 0.5 -> V - (V >> 1),
#   0.75  -> V >> 2
SHIFT_DECAY_RATES: tuple[float, ...] = (0.125, 0.25, 0.5, 0.75)


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """Fold an integer tensor into int32 two's complement (mod 2^32)."""
    x = x.to(torch.int64)
    return (((x + (1 << 31)) & 0xFFFF_FFFF) - (1 << 31)).to(torch.int32)


def to_fixed(x, fmt: FixedPointFormat = Q16_16, *, saturate: bool = True):
    """Quantize a float tensor to raw int32 fixed point (round half even).

    The float32 input is scaled and clamped in float64 (scaling by 2^16
    is exact either way), so the int32 limit itself stays representable.
    """
    x = torch.as_tensor(x, dtype=torch.float32)
    r = torch.round(x.to(torch.float64) * fmt.scale)
    if saturate:
        lo = -(1 << (fmt.int_bits + fmt.frac_bits))
        hi = (1 << (fmt.int_bits + fmt.frac_bits)) - 1
        r = torch.clamp(r, lo, hi)
    return r.to(torch.int32)


def fx_mul(a: torch.Tensor, b: int, fmt: FixedPointFormat = Q16_16):
    """Fixed-point multiply: floor(a * b / 2^16) on raw int32, wrapped.

    The hi/lo split of the JAX twin: ``a = a_hi * 2^16 + a_lo`` with an
    arithmetic ``a_hi = a >> 16`` and ``0 <= a_lo < 2^16``, so
    ``floor(a*b / 2^16) = a_hi*b + (a_lo*b >> 16)``. The JAX version does
    the low product in uint32; here it runs in int64 (exact, since
    ``a_lo * b < 2^32``) and the final sum wraps to int32.
    Requires ``fmt.frac_bits == 16`` and ``0 <= b <= 2^16``.
    """
    if fmt.frac_bits != 16:
        raise ValueError("fx_mul split-multiply assumes Q*.16")
    b = int(b)
    if not 0 <= b <= (1 << 16):
        raise ValueError(f"fx_mul factor {b} outside [0, 2^16]")
    a64 = torch.as_tensor(a).to(torch.int32).to(torch.int64)
    a_hi = a64 >> 16
    a_lo = a64 & 0xFFFF
    return wrap_int32(a_hi * b + ((a_lo * b) >> 16))


def shift_decay(v: torch.Tensor, rate: float) -> torch.Tensor:
    """Cerebra-H shift-based decay on raw int32 membrane potentials."""
    v = torch.as_tensor(v).to(torch.int32)
    if rate == 0.125:
        k = 3
    elif rate == 0.25:
        k = 2
    elif rate == 0.5:
        k = 1
    elif rate == 0.75:
        return v >> 2
    else:
        raise ValueError(f"unsupported shift decay rate {rate}; "
                         f"hardware supports {SHIFT_DECAY_RATES}")
    v64 = v.to(torch.int64)
    return wrap_int32(v64 - (v64 >> k))


def nearest_shift_decay(rate: float) -> float:
    """Snap a decay rate to the nearest hardware-supported one."""
    return float(min(SHIFT_DECAY_RATES, key=lambda r: abs(r - rate)))


def np_to_fixed(x: np.ndarray, fmt: FixedPointFormat = Q16_16) -> np.ndarray:
    """Numpy quantizer for host-side config compilers (float64 rounding)."""
    r = np.round(np.asarray(x, np.float64) * fmt.scale)
    lo = -(1 << (fmt.int_bits + fmt.frac_bits))
    hi = (1 << (fmt.int_bits + fmt.frac_bits)) - 1
    return np.clip(r, lo, hi).astype(np.int32)
