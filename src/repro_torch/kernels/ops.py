"""Public wrappers around the port's kernels.

Twin of :mod:`repro.kernels.ops`. For :func:`spike_timestep` and
:func:`spike_timestep_fused`: pad the operands to the kernels' block
multiples, build the per-(batch tile, source block) activity scalars from
bitpacked sources, run the kernel (CUDA tensors) or its plain version
(CPU tensors), and un-pad. :func:`lif_step` and :func:`poisson_encode`
need no padding: their kernels take any shape.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import bitpack
from repro_torch.kernels import lif_step as _lif
from repro_torch.kernels import poisson_encode as _enc
from repro_torch.kernels import spike_timestep as _ts
from repro_torch.kernels import spike_timestep_fused as _tsf
from repro_torch.kernels._build import LAUNCHES

__all__ = [
    "LAUNCHES",
    "GatedSources",
    "ext_gate_activity",
    "fused_weights",
    "gate_activity",
    "gated_sources",
    "lif_step",
    "poisson_encode",
    "spike_timestep",
    "spike_timestep_fused",
    "window_gate_activity",
]

# LAUNCHES: kernel launch counts, one per kernel (``"spike_timestep"``,
# ``"spike_timestep_fused"``, ``"lif_step"``, ``"poisson_encode"``); only a
# kernel launch increments one


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


class GatedSources(NamedTuple):
    """Sources as :func:`spike_timestep` hands them to the kernel: padded
    to the block multiples, with their gate scalars and unpadded size."""

    padded: torch.Tensor    # (Bp, Sp) int32
    activity: torch.Tensor  # (Bp / block_batch, Sp / block_src) int32
    rows: int
    width: int
    block_batch: int


def gated_sources(sources, *, block_batch: int = 8,
                  block_src: int = _ts.BLOCK_SRC) -> GatedSources:
    """Pad ``(B, S)`` sources and build their gate scalars once, for every
    weight slice that reads the same rows (a mesh's neuron shards)."""
    _check_block_src(block_src)
    B, S = sources.shape
    src_p = _pad_to(_pad_to(sources.to(torch.int32), 0, block_batch), 1,
                    block_src).contiguous()
    return GatedSources(src_p, gate_activity(src_p, block_batch=block_batch,
                                             block_src=block_src),
                        B, S, block_batch)


def spike_timestep(sources, weights, v, *, decay_rate: float = 0.0,
                   threshold_raw: int, reset_mode: str = "zero",
                   decay_kind: str = "shift", decay_raw: int = 0,
                   use_f32: bool = False, block_batch: int = 8,
                   block_src: int = _ts.BLOCK_SRC):
    """One fused, event-gated accelerator timestep.

    sources: (B, S) int {0,1} spikes, or a :class:`GatedSources` of them
    built with the same ``block_batch``; weights: (S, P) int32 raw Q16.16;
    v: (B, P) int32. Returns ``(v_out, spikes)``, each (B, P) int32.

    ``use_f32=False`` is bit-exact. ``use_f32=True`` sums each 128-source
    block in float32: exact only while every block sum stays under 2^24,
    which :class:`repro_torch.core.engine.SpikeEngine` checks at build.
    ``block_src`` is fixed at the kernel's 128.

    ``weights`` may already carry zero rows and columns up to the block
    multiples (the engine pads its image once, so a step copies no
    weights); ``P`` is taken from ``v``.
    """
    if not isinstance(sources, GatedSources):
        sources = gated_sources(sources, block_batch=block_batch,
                                block_src=block_src)
    _check_block_src(block_src)
    if sources.block_batch != block_batch:
        raise ValueError(f"sources were gated in tiles of "
                         f"{sources.block_batch} rows, not {block_batch}")
    B, S = sources.rows, sources.width
    P = v.shape[1]
    Sp = S + (-S) % block_src
    Pp = P + (-P) % 128
    if weights.shape[0] not in (S, Sp) or weights.shape[1] not in (P, Pp):
        raise ValueError(f"weights {tuple(weights.shape)} do not fit "
                         f"sources {(B, S)} and v {tuple(v.shape)}")
    w_p = _pad_to(_pad_to(weights, 0, block_src), 1, 128).contiguous()
    v_p = _pad_to(_pad_to(v, 0, block_batch), 1, 128).contiguous()
    v_out, spikes = _ts.spike_timestep(
        sources.activity, sources.padded, w_p, v_p,
        threshold_raw=threshold_raw, reset_mode=reset_mode,
        decay_kind=decay_kind, decay_rate=decay_rate, decay_raw=decay_raw,
        use_f32=use_f32, block_batch=block_batch)
    return v_out[:B, :P], spikes[:B, :P]


# --------------------------------------------------------------------------
def _check_block_src(block_src: int) -> None:
    if block_src != _ts.BLOCK_SRC:
        raise ValueError(f"the kernels gate {_ts.BLOCK_SRC}-source blocks, "
                         f"got block_src={block_src}")


def fused_weights(weights: torch.Tensor, n_inputs: int, *,
                  block_src: int = _ts.BLOCK_SRC):
    """The fused kernel's weight layout of an ``(n_inputs + P, P)`` image:
    ``(w_ext, w_rec)``, external rows padded to ``block_src`` multiples and
    columns to 128, recurrent rows and columns padded together to a square
    ``(Pp, Pp)`` with zeros (pad neurons have no fan-in and no fan-out).
    ``n_inputs == 0`` keeps one silent external block. An engine pads its
    image once and passes the pair to :func:`spike_timestep_fused`."""
    _check_block_src(block_src)
    P = weights.shape[1]
    if weights.shape[0] != n_inputs + P:
        raise ValueError(f"weights {tuple(weights.shape)} are not an "
                         f"(n_inputs + P, P) image for n_inputs={n_inputs}")
    w_ext = _pad_to(_pad_to(weights[:n_inputs], 0, block_src), 1, 128)
    Pp = w_ext.shape[1]
    w_rec = torch.zeros((Pp, Pp), dtype=torch.int32, device=weights.device)
    w_rec[:P, :P] = weights[n_inputs:]
    if n_inputs == 0:
        w_ext = torch.zeros((block_src, Pp), dtype=torch.int32,
                            device=weights.device)
    return w_ext.contiguous(), w_rec


def _fused_pad(ext, spikes_prev, weights, v, active, *, n_inputs,
               block_batch, block_src):
    """Pad every fused-kernel operand to its block multiples.

    Returns the padded operands plus the original ``(B, P)`` for
    un-padding. ``weights`` is the ``(n_inputs + P, P)`` image or the
    ``(w_ext, w_rec)`` pair :func:`fused_weights` made from it.
    """
    K, B, _ = ext.shape
    P = v.shape[1]
    if isinstance(weights, tuple):
        w_ext_p, w_rec_p = weights
    else:
        w_ext_p, w_rec_p = fused_weights(weights, n_inputs,
                                         block_src=block_src)
    ext_p = _pad_to(_pad_to(ext.to(torch.int32), 1, block_batch), 2,
                    block_src)
    if ext_p.shape[2] == 0:  # n_inputs == 0: keep one silent block
        ext_p = torch.zeros((K, ext_p.shape[1], block_src),
                            dtype=torch.int32, device=ext.device)
    v_p = _pad_to(_pad_to(v, 0, block_batch), 1, 128).contiguous()
    spk_p = _pad_to(_pad_to(spikes_prev, 0, block_batch), 1,
                    128).contiguous()
    act_p = _pad_to(active.to(torch.int32), 1, block_batch).contiguous()
    Pp = v_p.shape[1]
    if (tuple(w_rec_p.shape) != (Pp, Pp)
            or tuple(w_ext_p.shape) != (ext_p.shape[2], Pp)):
        raise ValueError(
            f"fused weights w_ext {tuple(w_ext_p.shape)}, w_rec "
            f"{tuple(w_rec_p.shape)} do not fit ext {tuple(ext.shape)} and "
            f"v {tuple(v.shape)}")
    return ext_p, spk_p, w_ext_p, w_rec_p, v_p, act_p, B, P


def window_gate_activity(packed: torch.Tensor, *, block_batch: int,
                         block_src: int = _ts.BLOCK_SRC) -> torch.Tensor:
    """Window-OR gate scalars of packed ``(..., K, Bp, lanes)`` external
    spikes: spike counts per (batch tile of ``block_batch`` rows,
    ``block_src``-source block), summed over the window's K steps, so a
    block is fetched iff ANY step of the window spikes on it for the
    tile. Shape ``(..., Bp / block_batch, lanes * 32 / block_src)``
    int32."""
    Bp = packed.shape[-2]
    per_example = bitpack.block_activity(packed, block_src).sum(dim=-3)
    tiles = per_example.reshape(*per_example.shape[:-2], Bp // block_batch,
                                block_batch, per_example.shape[-1])
    return tiles.sum(dim=-2, dtype=torch.int32)


def spike_timestep_fused(ext, spikes_prev, weights, v, active, *,
                         n_inputs: int, decay_rate: float = 0.0,
                         threshold_raw: int, reset_mode: str = "zero",
                         decay_kind: str = "shift", decay_raw: int = 0,
                         use_f32: bool = False, block_batch: int = 8,
                         block_src: int = _ts.BLOCK_SRC):
    """K fused, event-gated accelerator timesteps in ONE kernel launch.

    ext: (K, B, n_inputs) external spikes for the whole window;
    spikes_prev, v: (B, P) carries at window entry; weights: the
    (n_inputs + P, P) int32 raw Q16.16 image, or its
    :func:`fused_weights` pair; active: (K, B) advance mask. Returns
    ``(v_out, spikes_carry, raster)`` with raster (K, B, P).

    Byte-identical to K chained :func:`spike_timestep` calls under the
    masked-slot contract (inactive (step, example) pairs keep their carry
    and emit zero spikes). External spikes travel bitpacked; each active
    external weight block is fetched once for the whole window. The
    ``use_f32`` 2^24 exactness bound is unchanged by K.
    """
    _check_block_src(block_src)
    (ext_p, spk_p, w_ext_p, w_rec_p, v_p, act_p, B, P) = _fused_pad(
        ext, spikes_prev, weights, v, active, n_inputs=n_inputs,
        block_batch=block_batch, block_src=block_src)
    packed = bitpack.pack_spikes(ext_p).contiguous()  # (K, Bp, lanes)
    activity = window_gate_activity(packed, block_batch=block_batch,
                                    block_src=block_src)
    v_out, spk_carry, raster = _tsf.spike_timestep_fused(
        activity, packed, w_ext_p, w_rec_p, v_p, spk_p, act_p,
        threshold_raw=threshold_raw, reset_mode=reset_mode,
        decay_kind=decay_kind, decay_rate=decay_rate, decay_raw=decay_raw,
        use_f32=use_f32, block_batch=block_batch)
    return v_out[:B, :P], spk_carry[:B, :P], raster[:, :B, :P]


def ext_gate_activity(ext, *, block_batch: int = 8,
                      block_src: int = _ts.BLOCK_SRC,
                      fuse_steps: int = 1) -> torch.Tensor:
    """The external gate scalars the fused datapath acts on (host view).

    ext: (T, B, n_inputs) external raster (numpy or torch). Returns an
    int32 tensor of shape ``(ceil(T / fuse_steps), ceil(B /
    block_batch), n_ext_blocks)``: window-OR spike counts per (window,
    batch tile, external source block), through the same bitpack /
    popcount pipeline the kernel wrapper uses. ``(activity > 0).sum()`` is
    therefore the number of external weight blocks the fused kernel
    fetches, the count :func:`repro_torch.events.trace.block_traffic`
    models.
    """
    K = int(fuse_steps)
    if K < 1:
        raise ValueError(f"fuse_steps must be >= 1, got {fuse_steps}")
    ext = _pad_to(torch.as_tensor(ext).to(torch.int32), 0, K)
    ext_p = _pad_to(_pad_to(ext, 1, block_batch), 2, block_src)
    Tp, Bp, _ = ext_p.shape
    packed = bitpack.pack_spikes(ext_p)
    return window_gate_activity(packed.reshape(Tp // K, K, Bp,
                                               packed.shape[-1]),
                                block_batch=block_batch, block_src=block_src)


# --------------------------------------------------------------------------
def lif_step(v, syn, *, decay_rate: float, threshold_raw: int,
             reset_mode: str = "zero"):
    """Fused LIF update. v, syn: (B, N) int32 -> (v_out, spikes).

    The JAX twin's ``interpret`` knob (Pallas dispatch) has no counterpart:
    the device of ``v`` picks the kernel (CUDA) or the plain version (CPU).
    """
    if v.ndim != 2:
        raise ValueError(f"v must be (B, N), got {tuple(v.shape)}")
    return _lif.lif_step(v, syn, decay_rate=decay_rate,
                         threshold_raw=threshold_raw, reset_mode=reset_mode)


def poisson_encode(seed: int, intensities, num_steps: int) -> torch.Tensor:
    """Hardware rate encoder. intensities: (B, D) -> (T, B, D) int32.

    ``intensities`` (a tensor, or a numpy array taken to the CPU) are cast
    to float32 first; ``seed`` is an int32. The JAX twin's ``interpret``
    (Pallas dispatch) and ``block_batch`` (TPU tiling) knobs have no
    counterpart: the kernel takes any shape, and the device of
    ``intensities`` picks the kernel (CUDA) or the plain version (CPU).
    """
    return _enc.poisson_encode(seed, torch.as_tensor(intensities),
                               num_steps)
