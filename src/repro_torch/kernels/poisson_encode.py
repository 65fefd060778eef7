"""The hardware rate encoder: CUDA kernel wrapper and its plain version.

Twin of :mod:`repro.kernels.poisson_encode` (the Pallas
``poisson_encode_kernel``). The kernel is CUDA C++ for ``sm_90a``
(``csrc/poisson_encode.cu``), built with ``nvcc`` at first use and loaded
with ``ctypes`` (:mod:`repro_torch.kernels._build`). Its plain version is
the oracle :func:`repro_torch.kernels.ref.poisson_encode_ref`. The spikes
are a pure function of (seed, t, b, d), a counter hash of its own (the
session's encoder, :mod:`repro_torch.core.coding`, draws threefry
uniforms instead): kernel, plain version and the JAX kernel agree bit for
bit.

:func:`poisson_encode` launches the kernel for CUDA tensors and runs the
plain version for CPU tensors; there is no fallback from one to the
other. ``LAUNCHES["poisson_encode"]`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import CSRC, LAUNCHES, CudaLibrary
from repro_torch.kernels.ref import poisson_encode_ref

__all__ = ["LAUNCHES", "SOURCE", "build", "launch_plan", "poisson_encode",
           "poisson_encode_cuda"]

SOURCE = CSRC / "poisson_encode.cu"
_LIB = CudaLibrary(SOURCE, "poisson_encode_launch",
                   [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                   + [ctypes.c_uint] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])

THREADS = 256          # kThreads of csrc/poisson_encode.cu
PER_THREAD = 4         # positions of the (B*D) plane a thread owns
SM_THREADS = 2048      # resident threads of one Hopper SM
WAVES = 2              # the grid's target, in waves of resident threads
MAX_GRID_Y = 65535


def build():
    """Compile ``csrc/poisson_encode.cu`` unless a build of this exact
    source exists. Returns ``(library path, compiler output)``."""
    return _LIB.build()


def launch_plan(num_steps: int, batch: int, dim: int, n_sm: int) -> dict:
    """The kernel's grid for a (T, B, D) raster on a card of ``n_sm`` SMs.

    Block (x, y) takes 1024 positions of the (B*D) plane, 4 a thread, and
    ``t_per_block`` timesteps; t is split over ``grid[1]`` until the grid
    holds ``WAVES`` waves of resident threads (or one timestep a block).
    ``vector``: whether the plane takes 16-byte loads and stores.
    """
    T, BD = int(num_steps), int(batch) * int(dim)
    if T <= 0 or BD <= 0:
        raise ValueError(f"nothing to launch for T={T}, B*D={BD}")
    if BD >= 1 << 31:
        raise ValueError(f"B*D = {BD} must be < 2^31 (the kernel indexes "
                         f"the plane with int32)")
    quads = -(-BD // PER_THREAD)
    grid_x = -(-quads // THREADS)
    want = -(-WAVES * int(n_sm) * SM_THREADS // (grid_x * THREADS))
    t_per_block = -(-T // max(1, min(T, want, MAX_GRID_Y)))
    grid_y = -(-T // t_per_block)
    return {"grid": (grid_x, grid_y), "threads": THREADS,
            "t_per_block": t_per_block, "vector": BD % PER_THREAD == 0}


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check(seed, intensities, num_steps):
    if not -(1 << 31) <= int(seed) < (1 << 31):
        raise ValueError(f"seed {seed} is not an int32 (the encoder takes "
                         f"it as an int32 bit pattern)")
    if intensities.ndim != 2:
        raise ValueError(f"intensities must be (B, D), got "
                         f"{tuple(intensities.shape)}")
    if int(num_steps) < 0:
        raise ValueError(f"num_steps must be >= 0, got {num_steps}")


def poisson_encode_cuda(seed: int, intensities: torch.Tensor,
                        num_steps: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronisation).
    ``intensities`` (B, D) are cast to float32 first. Returns (T, B, D)
    int32 {0, 1}."""
    _check(seed, intensities, num_steps)
    if intensities.device.type != "cuda":
        raise ValueError(f"poisson_encode_cuda needs a CUDA tensor, got "
                         f"{intensities.device}")
    x = intensities.to(torch.float32).contiguous()
    B, D = x.shape
    T = int(num_steps)
    if T * B * D == 0:  # no work, nothing to launch
        return torch.empty((T, B, D), dtype=torch.int32, device=x.device)
    plan = launch_plan(T, B, D, _sm_count(x.device))
    (grid_x, grid_y), t_per_block = plan["grid"], plan["t_per_block"]
    out = torch.empty((T, B, D), dtype=torch.int32, device=x.device)
    launch = _LIB.function
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = launch(x.data_ptr(), out.data_ptr(), T, B * D, D,
                     int(seed) & 0xFFFFFFFF, grid_x, grid_y, t_per_block,
                     stream)
    if err != 0:
        raise RuntimeError(f"poisson_encode kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES["poisson_encode"] += 1
    return out


def poisson_encode(seed: int, intensities: torch.Tensor,
                   num_steps: int) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU one."""
    if intensities.device.type == "cuda":
        return poisson_encode_cuda(seed, intensities, num_steps)
    if intensities.device.type == "cpu":
        _check(seed, intensities, num_steps)
        return poisson_encode_ref(seed, intensities, int(num_steps))
    raise ValueError(f"no poisson_encode for device {intensities.device}")
