"""32-sources-per-lane bitpacked spike rasters.

Twin of :mod:`repro.kernels.bitpack`, with the same lane layout: source
``s`` lives in lane ``s // 32`` at bit ``s % 32``. torch has no uint32
arithmetic on the CPU and no popcount, so a lane is stored as the int32
with the same bit pattern (bit 31 is the sign): lanes are built in int64
and folded to int32, and bits are counted with the SWAR popcount. Viewed
as uint32, the lanes are byte-equal to the JAX package's.
"""

from __future__ import annotations

import torch

from repro_torch.core.fixedpoint import wrap_int32

__all__ = [
    "LANE_BITS",
    "block_activity",
    "count_spikes",
    "pack_spikes",
    "packed_lanes",
    "popcount32",
    "unpack_spikes",
]

LANE_BITS = 32  # sources per lane


def packed_lanes(n_sources: int) -> int:
    """Lanes needed for ``n_sources`` (ceil; 0 sources pack to 0 lanes)."""
    return -(-int(n_sources) // LANE_BITS)


def _bit_weights(device) -> torch.Tensor:
    return torch.ones(LANE_BITS, dtype=torch.int64, device=device) << \
        torch.arange(LANE_BITS, dtype=torch.int64, device=device)


def pack_spikes(dense: torch.Tensor) -> torch.Tensor:
    """Pack ``(..., S)`` spikes into ``(..., ceil(S/32))`` int32 lanes.

    Any nonzero packs to a set bit; the ragged tail of the last lane is
    zero, so lane popcounts equal dense spike counts.
    """
    S = dense.shape[-1]
    L = packed_lanes(S)
    bits = (dense != 0).to(torch.int64)
    pad = L * LANE_BITS - S
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    lanes = bits.reshape(*bits.shape[:-1], L, LANE_BITS)
    return wrap_int32((lanes * _bit_weights(dense.device)).sum(dim=-1))


def unpack_spikes(packed: torch.Tensor, n_sources: int) -> torch.Tensor:
    """Unpack ``(..., L)`` lanes to a ``(..., n_sources)`` {0,1} int32
    raster; the exact inverse of :func:`pack_spikes` on binary rasters."""
    L = packed.shape[-1]
    if L < packed_lanes(n_sources):
        raise ValueError(
            f"{L} lanes hold {L * LANE_BITS} sources; {n_sources} requested")
    lanes = packed.to(torch.int64) & 0xFFFF_FFFF
    shifts = torch.arange(LANE_BITS, dtype=torch.int64, device=packed.device)
    bits = (lanes[..., None] >> shifts) & 1
    dense = bits.reshape(*packed.shape[:-1], L * LANE_BITS)
    return dense[..., :n_sources].to(torch.int32)


def popcount32(packed: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit lane (SWAR popcount), as int32."""
    x = packed.to(torch.int64) & 0xFFFF_FFFF
    x = x - ((x >> 1) & 0x5555_5555)
    x = (x & 0x3333_3333) + ((x >> 2) & 0x3333_3333)
    x = (x + (x >> 4)) & 0x0F0F_0F0F
    return (((x * 0x0101_0101) & 0xFFFF_FFFF) >> 24).to(torch.int32)


def count_spikes(packed: torch.Tensor) -> torch.Tensor:
    """Spike count per leading index: popcount summed over the lanes."""
    return popcount32(packed).sum(dim=-1, dtype=torch.int32)


def block_activity(packed: torch.Tensor, block_src: int) -> torch.Tensor:
    """Per-source-block spike counts: ``(..., L) -> (..., L*32/block_src)``.

    Block ``j`` covers sources ``[j*block_src, (j+1)*block_src)``, i.e.
    ``block_src // 32`` whole lanes. These are the event gate's scalars.
    """
    if block_src % LANE_BITS:
        raise ValueError(
            f"block_src must be a multiple of {LANE_BITS}, got {block_src}")
    L = packed.shape[-1]
    lanes_per_block = block_src // LANE_BITS
    if L % lanes_per_block:
        raise ValueError(
            f"{L} lanes do not tile into {lanes_per_block}-lane blocks")
    counts = popcount32(packed)
    blocks = counts.reshape(*packed.shape[:-1], L // lanes_per_block,
                            lanes_per_block)
    return blocks.sum(dim=-1, dtype=torch.int32)
