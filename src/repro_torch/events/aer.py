"""Address-Event Representation: the sparse spike format.

Twin of :mod:`repro.events.aer`. :class:`AERStream` is the wire format of
the spike-packet paths as data: a fixed-capacity tensor of ``(t, slot,
source)`` address tuples plus a count. Same contracts as the twin:

  * **Addresses are sorted** lexicographically by ``(t, slot, source)``,
    the order ``torch.nonzero`` emits, so dense -> AER -> dense is the
    identity whenever capacity suffices.
  * **Fixed capacity, explicit overflow.** ``policy="error"`` refuses a
    lossy conversion; ``policy="drop"`` keeps the EARLIEST ``capacity``
    events and flags :attr:`AERStream.overflowed`.
  * **Binary events.** Any nonzero of a dense raster is one event.

The stream's tensors live on the device of the raster that made it.
``dense_to_aer`` waits for that device (``torch.nonzero`` has a
data-dependent shape), as the twin checks its policy at the host boundary.
Decoding scatters single bits into the port bitpack's int32 lanes
(:func:`aer_to_packed`); viewed as uint32 they are byte-equal to the
twin's lanes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.fixedpoint import wrap_int32
from repro_torch.kernels import bitpack

__all__ = ["AERStream", "dense_to_aer", "aer_to_dense", "aer_to_packed"]


@dataclasses.dataclass(frozen=True)
class AERStream:
    """A fixed-capacity sparse spike stream.

    addrs: ``(capacity, 3)`` int32 ``(t, slot, source)`` per event,
      lexicographically sorted; rows past ``count`` are ``-1`` filler.
    count: ``()`` int32, events actually stored (<= capacity).
    total: ``()`` int32, events in the source raster; ``total > count``
      iff the conversion overflowed (and was allowed to drop).
    shape: static ``(T, B, S)`` dense shape the stream addresses.
    """

    addrs: torch.Tensor
    count: torch.Tensor
    total: torch.Tensor
    shape: tuple[int, int, int]

    @property
    def capacity(self) -> int:
        return int(self.addrs.shape[0])

    @property
    def overflowed(self) -> bool:
        return int(self.total) > int(self.count)

    @property
    def sparsity(self) -> float:
        """Fraction of dense (t, slot, source) sites that carry an event."""
        t, b, s = self.shape
        return float(self.total) / max(t * b * s, 1)

    def __len__(self) -> int:
        return int(self.count)

    def to(self, device) -> "AERStream":
        """This stream with its tensors on ``device`` (``self`` when they
        already live there)."""
        device = torch.device(device)
        if self.addrs.device == device:
            return self
        return AERStream(addrs=self.addrs.to(device),
                         count=self.count.to(device),
                         total=self.total.to(device), shape=self.shape)


def dense_to_aer(dense, capacity: int, *, policy: str = "error") -> AERStream:
    """Convert a dense ``(T, B, S)`` raster to a fixed-capacity AER stream.

    ``policy="error"`` raises :class:`OverflowError` when the raster holds
    more than ``capacity`` events; ``policy="drop"`` keeps the earliest
    ``capacity`` events and marks the stream ``overflowed``.
    """
    if policy not in ("error", "drop"):
        raise ValueError(
            f"unknown overflow policy {policy!r}; expected 'error' or 'drop'"
        )
    if isinstance(dense, np.ndarray):
        dense = torch.from_numpy(np.ascontiguousarray(dense))
    dense = torch.as_tensor(dense)
    if dense.ndim != 3:
        raise ValueError(
            f"dense raster must be (T, B, S), got shape {tuple(dense.shape)}"
        )
    capacity = int(capacity)
    if capacity < 0:
        raise ValueError(f"capacity must be >= 0, got {capacity}")
    dev = dense.device
    # row-major nonzero == (t, slot, source) lexicographic: truncation at
    # `capacity` drops the LATEST events, matching a full hardware FIFO
    idx = torch.nonzero(dense != 0)
    total = int(idx.shape[0])
    count = min(total, capacity)
    addrs = torch.full((capacity, 3), -1, dtype=torch.int32, device=dev)
    addrs[:count] = idx[:count].to(torch.int32)
    stream = AERStream(
        addrs=addrs,
        count=torch.tensor(count, dtype=torch.int32, device=dev),
        total=torch.tensor(total, dtype=torch.int32, device=dev),
        shape=tuple(int(d) for d in dense.shape))
    if policy == "error" and total > count:
        raise OverflowError(
            f"raster holds {total} events but the stream capacity is "
            f"{capacity}; raise capacity or use policy='drop'"
        )
    return stream


def aer_to_packed(stream: AERStream) -> torch.Tensor:
    """Decode an AER stream to the bitpacked ``(T, B, lanes)`` raster
    (:mod:`repro_torch.kernels.bitpack` lane layout, int32 lanes).

    Each event ADDS ``1 << (source % 32)`` into lane ``(t, slot, source //
    32)``, as the twin does, so a hand-built stream with a repeated address
    gives the twin's bytes too. A row scatters nothing when it lies past
    ``count``, has a negative field, or addresses a ``t``, ``slot`` or lane
    past the shape (the twin's ``mode="drop"``): such rows are sent to a
    sentinel element past the raster, with value 0, so no index is out of
    bounds on either device.
    """
    T, B, S = stream.shape
    lanes = bitpack.packed_lanes(S)
    addrs = stream.addrs.to(torch.int64)
    dev = addrs.device
    t, b, src = addrs[:, 0], addrs[:, 1], addrs[:, 2]
    lane = torch.div(src, bitpack.LANE_BITS, rounding_mode="floor")
    valid = ((torch.arange(addrs.shape[0], device=dev)
              < stream.count.to(dev))
             & (addrs >= 0).all(dim=1)
             & (t < T) & (b < B) & (lane < lanes))
    n = T * B * lanes
    flat = torch.where(valid, (t * B + b) * lanes + lane, n)
    val = torch.where(valid, torch.ones_like(src) << (src % bitpack.LANE_BITS),
                      0)
    packed = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    packed.index_add_(0, flat, val)
    return wrap_int32(packed[:n]).reshape(T, B, lanes)


def aer_to_dense(stream: AERStream) -> torch.Tensor:
    """Decode an AER stream back to its dense ``(T, B, S)`` {0,1} int32
    raster: the unpack of :func:`aer_to_packed`. Exact inverse of
    :func:`dense_to_aer` on binary rasters whenever the stream did not
    overflow; after a ``policy="drop"`` overflow it yields the raster of
    the earliest ``capacity`` events."""
    return bitpack.unpack_spikes(aer_to_packed(stream), stream.shape[2])
