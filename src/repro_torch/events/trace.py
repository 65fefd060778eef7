"""Spike/SOP trace recorder — measured event accounting from real rasters.

Twin of :mod:`repro.events.trace` (numpy-only, copied with its imports
rewritten). A trace is a pure pass over the actual spike rasters a run
produced: it counts source events, synaptic operations (each event
weighted by its source's real nonzero fan-out), and the weight-block
traffic the event gate does / would skip. Nothing here runs inside the
engine's loop, so accounting and semantics cannot drift.

Traffic accounting mirrors the kernels' gate: the timestep fetches one
``(block_src, P)`` weight block per (batch tile, source block) whose
activity scalar is nonzero. ``gate="batch-tile"`` tiles the batch by
``tile_batch`` rows; ``gate="per-example"`` is the batch-tile=1 mode.
:func:`fused_block_traffic` models the JAX fused kernel (the whole
recurrent image once per window); the port's CUDA kernel reads fewer
recurrent rows (only those of neurons that spiked), so for the port it is
an upper bound on the recurrent leg, while the external leg is exact.

Rasters are dense numpy arrays or torch tensors. AER streams are not
ported yet (ROADMAP Queue 1 item 6), and ``measured_counts`` waits for
``core/energy.py`` (ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "SpikeTraceReport",
    "block_traffic",
    "fused_block_traffic",
    "trace_run",
]


def _as_dense(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    if isinstance(x, np.ndarray):
        return x
    raise NotImplementedError(
        f"the trace takes dense (T, B, S) numpy arrays or torch tensors, "
        f"got {type(x).__name__}; AER streams are not ported yet (ROADMAP "
        f"Queue 1 item 6)")


def block_traffic(sources, *, block_src: int = 128,
                  tile_batch: int = 8,
                  fuse_steps: int = 1) -> tuple[int, int]:
    """Weight-block fetches the event gate performs on ``sources``.

    Args:
      sources: (T, B, S) source activity (external + boundary spikes).
      block_src: source rows per weight block (kernel ``block_src``).
      tile_batch: batch rows sharing one fetch (1 = per-example gate).
      fuse_steps: timesteps per fused kernel window (K). Gate scalars are
        ORed over each window — a block is fetched once per window iff ANY
        of its K steps spikes on it — and the trailing ragged window pads
        with silence, mirroring the engine's masked remainder.
    Returns:
      ``(touched, total)`` block fetches: gated vs dense for this tiling,
      at one fetch per (window, batch tile, source block).
    """
    src = _as_dense(sources)
    if src.ndim != 3:
        raise ValueError(f"sources must be (T, B, S), got {src.shape}")
    if fuse_steps < 1:
        raise ValueError(f"fuse_steps must be >= 1, got {fuse_steps}")
    T, B, S = src.shape
    nw = -(-T // fuse_steps)
    nb = -(-B // tile_batch)
    ns = -(-S // block_src)
    padded = np.zeros(
        (nw * fuse_steps, nb * tile_batch, ns * block_src), bool)
    padded[:T, :B, :S] = src != 0
    tiles = padded.reshape(nw, fuse_steps, nb, tile_batch, ns, block_src)
    touched = int(tiles.any(axis=(1, 3, 5)).sum())
    return touched, nw * nb * ns


def fused_block_traffic(sources, n_inputs: int, *, block_src: int = 128,
                        tile_batch: int = 8,
                        fuse_steps: int = 1) -> tuple[int, int]:
    """Weight-block fetches of the K-STEP FUSED kernel on ``sources``.

    The fused datapath splits the image at ``n_inputs``: EXTERNAL blocks
    are gated on window-OR activity and DMA'd once per active (window,
    batch tile, block); the RECURRENT image cannot be gated ahead of the
    in-window feedback, so ALL its blocks are fetched once per (window,
    batch tile) and held VMEM-resident. Returns ``(touched, total)``
    where ``total`` is the single-step dense baseline ``T * tiles *
    blocks`` — so ``touched / total`` is directly the fraction of
    per-step dense traffic the fused kernel moves (~1/K at dense
    activity; less when the external gate bites).
    """
    src = _as_dense(sources)
    if src.ndim != 3:
        raise ValueError(f"sources must be (T, B, S), got {src.shape}")
    T, B, S = src.shape
    if not 0 <= n_inputs <= S:
        raise ValueError(f"n_inputs={n_inputs} outside [0, {S}]")
    nw = -(-T // fuse_steps)
    nb = -(-B // tile_batch)
    ns_ext = -(-n_inputs // block_src)
    ns_rec = -(-(S - n_inputs) // block_src)
    ext_touched, _ = block_traffic(
        src[:, :, :n_inputs], block_src=block_src, tile_batch=tile_batch,
        fuse_steps=fuse_steps) if n_inputs else (0, 0)
    rec_touched = nw * nb * ns_rec
    total = T * nb * (ns_ext + ns_rec)
    return ext_touched + rec_touched, total


@dataclasses.dataclass(frozen=True)
class SpikeTraceReport:
    """Measured event totals for one run (any chunking, any backend)."""

    steps: int
    batch: int
    n_sources: int
    n_phys: int
    source_events: int        # source-side spikes (external + boundary)
    output_events: int        # spikes the neuron array emitted
    measured_sops: int        # sum over events of the source's real fanout
    dense_sops: int           # SOPs if every source spiked every step
    blocks: dict              # gate name -> (touched, total) block fetches

    @property
    def source_sparsity(self) -> float:
        return self.source_events / max(
            self.steps * self.batch * self.n_sources, 1)

    @property
    def output_sparsity(self) -> float:
        return self.output_events / max(
            self.steps * self.batch * self.n_phys, 1)

    def traffic_ratio(self, gate: str) -> float:
        """Gated weight-block traffic as a fraction of dense (lower is
        better; 1.0 means the gate skipped nothing)."""
        touched, total = self.blocks[gate]
        return touched / max(total, 1)

    @property
    def sop_ratio(self) -> float:
        """Measured SOPs as a fraction of the dense datapath's SOPs."""
        return self.measured_sops / max(self.dense_sops, 1)

    def summary(self) -> str:
        parts = [
            f"{self.steps} steps x {self.batch} streams: "
            f"{self.source_events} source events "
            f"({100 * self.source_sparsity:.2f}% dense), "
            f"{self.measured_sops} SOPs "
            f"({100 * self.sop_ratio:.2f}% of dense)",
        ]
        for gate, (touched, total) in self.blocks.items():
            parts.append(
                f"{gate} gate: {touched}/{total} weight blocks "
                f"({100 * touched / max(total, 1):.2f}% of dense)")
        return "; ".join(parts)


def trace_run(engine, ext_spikes, spikes, *, block_src: int = 128,
              tile_batch: int = 8) -> SpikeTraceReport:
    """Measure one run's event totals from its real rasters.

    Args:
      engine: a :class:`~repro_torch.core.engine.SpikeEngine` (its weight
        image supplies the per-source fanout the SOP count weights events
        by).
      ext_spikes: (T, B, n_inputs) external raster.
      spikes: (T, B, n_phys) output raster the engine produced for
        ``ext_spikes``.
    Returns:
      A :class:`SpikeTraceReport` with measured SOPs and gated-vs-dense
      weight-block traffic under both the batch-tile and per-example gate.
    """
    from repro_torch.core.engine import sources_raster

    ext = _as_dense(ext_spikes)
    out = _as_dense(spikes)
    if ext.ndim != 3 or out.ndim != 3:
        raise ValueError(
            f"rasters must be (T, B, *), got ext {ext.shape} / "
            f"out {out.shape}"
        )
    if ext.shape[:2] != out.shape[:2]:
        raise ValueError(
            f"ext and output rasters disagree on (T, B): "
            f"{ext.shape[:2]} vs {out.shape[:2]}"
        )
    weights = engine.weights_raw.cpu().numpy()
    fanout = np.count_nonzero(weights, axis=1)  # (S,) real synapses/source
    sources = sources_raster(torch.from_numpy(ext),
                             torch.from_numpy(out)).numpy()  # (T, B, S)
    T, B, S = sources.shape
    events = sources != 0
    return SpikeTraceReport(
        steps=T,
        batch=B,
        n_sources=S,
        n_phys=out.shape[2],
        source_events=int(events.sum()),
        output_events=int((out != 0).sum()),
        measured_sops=int((events * fanout[None, None, :]).sum()),
        dense_sops=int(T * B * fanout.sum()),
        blocks={
            "batch-tile": block_traffic(
                sources, block_src=block_src, tile_batch=tile_batch),
            "per-example": block_traffic(
                sources, block_src=block_src, tile_batch=1),
        },
    )
