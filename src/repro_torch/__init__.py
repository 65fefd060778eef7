"""PyTorch/CUDA port of the SNAP-V accelerator model.

A second package beside :mod:`repro` (the JAX reference). Module paths
mirror ``repro`` so each ported module has a twin of the same name; the
port imports ``torch`` and ``numpy`` only, never ``jax`` and never
``repro``. Entry points take ``device=`` and default to ``"cuda"``; the
event-gated timestep runs there through a hand-written CUDA kernel
(:mod:`repro_torch.kernels.spike_timestep`).
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
