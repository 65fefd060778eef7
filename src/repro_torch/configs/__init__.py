"""Architecture registry: ``--arch <id>`` resolves here.

Twin of :mod:`repro.configs`, with all ten of its archs. Each arch module
exports CONFIG (the exact published configuration), REDUCED (a
same-family small config for CPU tests) and ``build(cfg)``.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.shapes import SHAPES, Shape  # noqa: F401

ARCHS: dict[str, str] = {
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "llama4-scout-17b-a16e": "repro_torch.configs.llama4_scout_17b_a16e",
    "gemma3-12b": "repro_torch.configs.gemma3_12b",
    "granite-20b": "repro_torch.configs.granite_20b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
}


def get_arch(arch_id: str):
    """Returns the arch module (CONFIG, REDUCED, build)."""
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(ARCHS)}")
    return importlib.import_module(ARCHS[arch_id])


def list_archs() -> list[str]:
    return list(ARCHS)
