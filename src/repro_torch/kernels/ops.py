"""Public wrapper around the timestep kernel.

Twin of :func:`repro.kernels.ops.spike_timestep`: pads the operands to the
kernel's block multiples, builds the per-(batch tile, source block)
activity scalars from bitpacked sources, runs the kernel (CUDA tensors)
or its plain version (CPU tensors), and un-pads.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import bitpack
from repro_torch.kernels import spike_timestep as _ts

__all__ = ["LAUNCHES", "gate_activity", "spike_timestep"]

#: kernel launch counts, ``LAUNCHES["spike_timestep"]`` (the wrapper's own
#: dict; only a kernel launch increments it)
LAUNCHES = _ts.LAUNCHES


def _pad_to(x: torch.Tensor, axis: int, multiple: int) -> torch.Tensor:
    rem = (-x.shape[axis]) % multiple
    if rem == 0:
        return x
    pad = [0, 0] * x.ndim
    pad[2 * (x.ndim - 1 - axis) + 1] = rem  # F.pad lists the last axis first
    return torch.nn.functional.pad(x, pad)


def gate_activity(src_p: torch.Tensor, *, block_batch: int,
                  block_src: int = _ts.BLOCK_SRC) -> torch.Tensor:
    """Gate scalars of padded ``(Bp, Sp)`` sources: spike counts per
    (batch tile of ``block_batch`` rows, ``block_src``-source block),
    popcounted over bitpacked lanes. Shape ``(Bp/block_batch,
    Sp/block_src)`` int32."""
    Bp, Sp = src_p.shape
    per_example = bitpack.block_activity(bitpack.pack_spikes(src_p),
                                         block_src)  # (Bp, ns)
    return per_example.reshape(Bp // block_batch, block_batch, -1).sum(
        dim=1, dtype=torch.int32)


def spike_timestep(sources, weights, v, *, decay_rate: float = 0.0,
                   threshold_raw: int, reset_mode: str = "zero",
                   decay_kind: str = "shift", decay_raw: int = 0,
                   use_f32: bool = False, block_batch: int = 8,
                   block_src: int = _ts.BLOCK_SRC):
    """One fused, event-gated accelerator timestep.

    sources: (B, S) int {0,1} spikes; weights: (S, P) int32 raw Q16.16;
    v: (B, P) int32. Returns ``(v_out, spikes)``, each (B, P) int32.

    ``use_f32=False`` is bit-exact. ``use_f32=True`` sums each 128-source
    block in float32: exact only while every block sum stays under 2^24,
    which :class:`repro_torch.core.engine.SpikeEngine` checks at build.
    ``block_src`` is fixed at the kernel's 128.

    ``weights`` may already carry zero rows and columns up to the block
    multiples (the engine pads its image once, so a step copies no
    weights); ``P`` is taken from ``v``.
    """
    if block_src != _ts.BLOCK_SRC:
        raise ValueError(f"the timestep gates {_ts.BLOCK_SRC}-source "
                         f"blocks, got block_src={block_src}")
    B, S = sources.shape
    P = v.shape[1]
    Sp = S + (-S) % block_src
    Pp = P + (-P) % 128
    if weights.shape[0] not in (S, Sp) or weights.shape[1] not in (P, Pp):
        raise ValueError(f"weights {tuple(weights.shape)} do not fit "
                         f"sources {tuple(sources.shape)} and v "
                         f"{tuple(v.shape)}")
    src_p = _pad_to(_pad_to(sources.to(torch.int32), 0, block_batch), 1,
                    block_src).contiguous()
    w_p = _pad_to(_pad_to(weights, 0, block_src), 1, 128).contiguous()
    v_p = _pad_to(_pad_to(v, 0, block_batch), 1, 128).contiguous()
    activity = gate_activity(src_p, block_batch=block_batch,
                             block_src=block_src)
    v_out, spikes = _ts.spike_timestep(
        activity, src_p, w_p, v_p, threshold_raw=threshold_raw,
        reset_mode=reset_mode, decay_kind=decay_kind, decay_rate=decay_rate,
        decay_raw=decay_raw, use_f32=use_f32, block_batch=block_batch)
    return v_out[:B, :P], spikes[:B, :P]
