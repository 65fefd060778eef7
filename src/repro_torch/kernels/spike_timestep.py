"""The event-gated timestep: CUDA kernel wrapper and its plain version.

Twin of :mod:`repro.kernels.spike_timestep` (the Pallas
``spike_timestep_kernel``). The kernel is CUDA C++ for ``sm_90a``
(``csrc/spike_timestep.cu``), built with ``nvcc`` at first use into
``build/repro_torch/`` at the repository root and loaded with ``ctypes``
(:mod:`repro_torch.kernels._build`).

Both functions take the padded operands :func:`repro_torch.kernels.ops.
spike_timestep` prepares::

    activity: (B / block_batch, S / 128) int32 gate scalars
    sources:  (B, S) int32 {0,1}
    weights:  (S, P) int32 raw Q16.16
    v:        (B, P) int32

and return ``(v_out, spikes)``, each ``(B, P)`` int32.

:func:`spike_timestep` launches the kernel for CUDA tensors and runs
:func:`spike_timestep_plain` for CPU tensors; there is no fallback from
one to the other. One call is a memset of a ``(B, P)`` uint32 scratch
accumulator, the product launch over (neuron tile, source block, batch
tile) and the epilogue launch (:func:`launch_plan`);
``LAUNCHES["spike_timestep"]`` counts one per call.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.fixedpoint import wrap_int32
from repro_torch.kernels._build import CSRC, LAUNCHES, CudaLibrary
from repro_torch.kernels.epilogue import decay_and_fire, validate_decay

__all__ = [
    "BLOCK_SRC",
    "LAUNCHES",
    "RESET_CODES",
    "SOURCE",
    "block_product",
    "build",
    "decay_codes",
    "exact_int32_matmul",
    "launch_plan",
    "spike_timestep",
    "spike_timestep_cuda",
    "spike_timestep_plain",
]

BLOCK_SRC = 128  # sources per gate block; the kernel's fixed tile
_TILE_COLS = 128  # neuron columns per CTA
_BLOCK_BATCHES = (1, 8)  # batch-tile heights the kernel is built for
_MAX_GRID_YZ = 65535  # CUDA's limit on gridDim.y and gridDim.z
_EPILOGUE_THREADS = 256

SOURCE = CSRC / "spike_timestep.cu"
_LIB = CudaLibrary(SOURCE, "spike_timestep_launch",
                   [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])

_DECAY_SHIFT_SUB, _DECAY_SHIFT, _DECAY_MUL = 0, 1, 2
_SHIFT_CODES = {0.125: (_DECAY_SHIFT_SUB, 3), 0.25: (_DECAY_SHIFT_SUB, 2),
                0.5: (_DECAY_SHIFT_SUB, 1), 0.75: (_DECAY_SHIFT, 2)}
RESET_CODES = {"zero": 0, "subtract": 1, "hold": 2}


def build():
    """Compile ``csrc/spike_timestep.cu`` unless a build of this exact
    source exists. Returns ``(library path, compiler output)``; the output
    is empty when the cached build was reused."""
    return _LIB.build()


def decay_codes(decay_kind: str, decay_rate: float) -> tuple[int, int]:
    """``(decay_mode, shift)`` as the kernels' ``lif.cuh`` reads them."""
    if decay_kind == "shift":
        return _SHIFT_CODES[decay_rate]
    return _DECAY_MUL, 0


def launch_plan(B: int, S: int, P: int, block_batch: int) -> dict:
    """The launches of one kernel call on padded ``(B, S)`` sources and
    ``(S, P)`` weights, as ``csrc/spike_timestep.cu`` issues them.

    ``product_grid`` is (neuron tiles, source blocks, batch tiles), one
    CTA each (those whose gate scalar is 0 exit at once);
    ``epilogue_ctas`` run the LIF epilogue over the ``scratch`` (B, P)
    accumulator. Raises ``ValueError`` on a shape the kernel does not
    take.
    """
    if (min(B, S, P, block_batch) <= 0 or B % block_batch or S % BLOCK_SRC
            or P % _TILE_COLS):
        raise ValueError(f"shapes must be pre-padded to block multiples: "
                         f"B {B}, S {S}, P {P}, block_batch {block_batch}")
    grid = (P // _TILE_COLS, S // BLOCK_SRC, B // block_batch)
    if max(grid[1:]) > _MAX_GRID_YZ or B * P >= 1 << 31:
        raise ValueError(f"the kernel takes at most {_MAX_GRID_YZ} source "
                         f"blocks and batch tiles and B * P < 2^31, got B "
                         f"{B}, S {S}, P {P}, block_batch {block_batch}")
    return {"product_grid": grid,
            "product_ctas": grid[0] * grid[1] * grid[2],
            "epilogue_ctas": -(-B * P // _EPILOGUE_THREADS),
            "scratch": (B, P)}


# --------------------------------------------------------------------------
def _check(activity, sources, weights, v, *, block_batch, decay_kind,
           decay_rate, decay_raw, reset_mode):
    validate_decay(decay_kind, decay_rate, decay_raw)
    if reset_mode not in RESET_CODES:
        raise ValueError(f"unknown reset mode {reset_mode!r}; expected one "
                         f"of {tuple(RESET_CODES)}")
    for name, t in (("activity", activity), ("sources", sources),
                    ("weights", weights), ("v", v)):
        if t.dtype != torch.int32 or t.ndim != 2:
            raise ValueError(f"{name} must be a 2-D int32 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != sources.device:
            raise ValueError(f"{name} is on {t.device}, sources on "
                             f"{sources.device}")
    B, S = sources.shape
    P = weights.shape[1]
    if (weights.shape[0] != S or tuple(v.shape) != (B, P)
            or B % block_batch or S % BLOCK_SRC or S == 0 or P % _TILE_COLS
            or tuple(activity.shape) != (B // block_batch, S // BLOCK_SRC)):
        raise ValueError(
            f"shapes must be pre-padded to block multiples: sources "
            f"{tuple(sources.shape)}, weights {tuple(weights.shape)}, v "
            f"{tuple(v.shape)}, activity {tuple(activity.shape)}, "
            f"block_batch {block_batch}")
    return B, S, P


def spike_timestep_cuda(activity, sources, weights, v, *, threshold_raw: int,
                        reset_mode: str, decay_kind: str = "shift",
                        decay_rate: float = 0.0, decay_raw: int = 0,
                        use_f32: bool = False, block_batch: int = 8):
    """Launch the CUDA kernel on the current stream (no synchronisation)."""
    B, S, P = _check(activity, sources, weights, v, block_batch=block_batch,
                     decay_kind=decay_kind, decay_rate=decay_rate,
                     decay_raw=decay_raw, reset_mode=reset_mode)
    if sources.device.type != "cuda":
        raise ValueError(f"spike_timestep_cuda needs CUDA tensors, got "
                         f"{sources.device}")
    if block_batch not in _BLOCK_BATCHES:
        raise ValueError(f"the kernel is built for block_batch in "
                         f"{_BLOCK_BATCHES}, got {block_batch}")
    tensors = (activity, sources, weights, v)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("spike_timestep_cuda needs contiguous tensors")
    if weights.data_ptr() % 16:
        raise ValueError("spike_timestep_cuda reads weight rows 16 bytes at "
                         "a time: weights must be 16-byte aligned")
    plan = launch_plan(B, S, P, block_batch)
    decay_mode, shift = decay_codes(decay_kind, decay_rate)
    acc = torch.empty(plan["scratch"], dtype=torch.int32,
                      device=sources.device)  # zeroed by the entry point
    v_out = torch.empty_like(v)
    spikes = torch.empty_like(v)
    launch = _LIB.function
    with torch.cuda.device(sources.device):
        stream = torch.cuda.current_stream(sources.device).cuda_stream
        err = launch(
            activity.data_ptr(), sources.data_ptr(), weights.data_ptr(),
            v.data_ptr(), acc.data_ptr(), v_out.data_ptr(),
            spikes.data_ptr(),
            B, S, P, block_batch, int(bool(use_f32)), decay_mode, shift,
            int(decay_raw), int(threshold_raw), RESET_CODES[reset_mode],
            stream)
    if err != 0:
        raise RuntimeError(f"spike_timestep kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES["spike_timestep"] += 1
    return v_out, spikes


# --------------------------------------------------------------------------
def exact_int32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over int32, wrapped mod 2^32 like JAX's int32 dot.

    On the CPU, torch's int32 matmul wraps the same way. CUDA torch has no
    int32 matmul, so there the product runs in float64 — exact while every
    partial sum stays under 2^53, which holds for int32 operands and a
    {0,1}-valued or count-valued left side over fewer than 2^22 terms — and
    is wrapped to int32 through int64.
    """
    if a.device.type == "cpu":
        return a.to(torch.int32) @ b.to(torch.int32)
    prod = a.to(torch.float64) @ b.to(torch.float64)
    return wrap_int32(prod.to(torch.int64))


def block_product(sources: torch.Tensor, weights: torch.Tensor, *,
                  use_f32: bool) -> torch.Tensor:
    """``sources @ weights`` as the kernels accumulate it, int32.

    Exact mode wraps mod 2^32. In f32 mode each 128-row block is summed in
    float32 and truncated toward zero before the wrapping int32
    accumulate, as the kernels and the JAX ``use_mxu`` mode do; ``S`` must
    then be a multiple of 128.
    """
    if not use_f32:
        return exact_int32_matmul(sources, weights)
    B, S = sources.shape
    ns = S // BLOCK_SRC
    s_blocks = sources.reshape(B, ns, BLOCK_SRC).transpose(0, 1)
    w_blocks = weights.reshape(ns, BLOCK_SRC, weights.shape[1])
    partial = torch.bmm(s_blocks.to(torch.float32),
                        w_blocks.to(torch.float32))  # (ns, B, P)
    return wrap_int32(partial.to(torch.int32).to(torch.int64).sum(dim=0))


def spike_timestep_plain(activity, sources, weights, v, *, threshold_raw: int,
                         reset_mode: str, decay_kind: str = "shift",
                         decay_rate: float = 0.0, decay_raw: int = 0,
                         use_f32: bool = False, block_batch: int = 8):
    """Plain PyTorch version of the kernel, on any device.

    The gate only skips blocks whose sources are all zero, which add
    nothing, so the plain product ignores ``activity`` (its shape is still
    checked): a gate scalar that wrongly reads 0 shows up as a mismatch
    against the kernel. In f32 mode each 128-row block is summed in
    float32 and truncated toward zero before the int32 accumulate, as the
    kernel and the JAX ``use_mxu`` mode do.
    """
    _check(activity, sources, weights, v, block_batch=block_batch,
           decay_kind=decay_kind, decay_rate=decay_rate, decay_raw=decay_raw,
           reset_mode=reset_mode)
    acc = block_product(sources, weights, use_f32=use_f32)
    return decay_and_fire(v, acc, decay_kind=decay_kind,
                          decay_rate=decay_rate, decay_raw=decay_raw,
                          threshold_raw=threshold_raw, reset_mode=reset_mode)


def spike_timestep(activity, sources, weights, v, **kwargs):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if sources.device.type == "cuda":
        return spike_timestep_cuda(activity, sources, weights, v, **kwargs)
    if sources.device.type == "cpu":
        return spike_timestep_plain(activity, sources, weights, v, **kwargs)
    raise ValueError(f"no spike_timestep for device {sources.device}")
