"""Architecture registry: ``--arch <id>`` resolves here.

Twin of :mod:`repro.configs`. Each ported arch module exports CONFIG (the
exact published configuration), REDUCED (a same-family small config for
CPU tests) and ``build(cfg)``. Only the dense attention archs are ported;
every other arch of the twin's registry is named in ``NOT_PORTED`` with
the family it waits for, and ``get_arch`` raises for it.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.shapes import SHAPES, Shape  # noqa: F401

ARCHS: dict[str, str] = {
    "granite-20b": "repro_torch.configs.granite_20b",
    "granite-3-2b": "repro_torch.configs.granite_3_2b",
}

# the twin's archs that wait for ROADMAP Queue 1 item 12a, by the block
# family each needs
NOT_PORTED: dict[str, str] = {
    "mixtral-8x7b": "MoE blocks and sliding-window ring caches",
    "llama4-scout-17b-a16e": "MoE blocks with a shared expert",
    "gemma3-12b": "5:1 local:global windows, q/k norm and split caches",
    "minicpm3-4b": "MLA attention",
    "whisper-large-v3": "the encoder-decoder with cross-attention",
    "qwen2-vl-2b": "M-RoPE and the embeddings frontend",
    "zamba2-1.2b": "Mamba2 blocks with a shared attention block",
    "rwkv6-7b": "RWKV6 blocks",
}


def get_arch(arch_id: str):
    """Returns the arch module (CONFIG, REDUCED, build)."""
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet: it needs "
            f"{NOT_PORTED[arch_id]}, ROADMAP Queue 1 item 12a (other block "
            f"families); ported: {list(ARCHS)}")
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(ARCHS)}")
    return importlib.import_module(ARCHS[arch_id])


def list_archs() -> list[str]:
    return list(ARCHS)
