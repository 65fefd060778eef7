"""Device selection shared by the port's entry points, and the float32
product setting its float paths share."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["ieee_fp32_matmul", "resolve_device"]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device with no card raises.

    Entry points default to ``"cuda"``: a caller that wants the plain
    PyTorch path on the host asks for ``"cpu"`` explicitly, so a missing
    card is an error, never a silent fallback.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA card, and torch sees none; "
            f"pass device='cpu' to run the plain PyTorch path on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}; "
                         f"expected 'cuda' or 'cpu'")
    return dev


@contextlib.contextmanager
def ieee_fp32_matmul():
    """cuBLAS float32 products in full float32 (no TF32) for the body,
    whatever the caller's global setting; the setting is restored after.
    TF32 would round the operands to 10 mantissa bits."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
