"""Architecture registry: ``--arch <id>`` resolves here.

Twin of :mod:`repro.configs`. Each ported arch module exports CONFIG (the
exact published configuration), REDUCED (a same-family small config for
CPU tests) and ``build(cfg)``. The attention-family archs are ported;
the rest of the twin's registry is named in ``NOT_PORTED`` with the
family it waits for, and ``get_arch`` raises for it.
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
    "qwen2-vl-2b": "repro_torch.configs.qwen2_vl_2b",
}

# the twin's archs that wait for ROADMAP Queue 1 item 12a-ii, by the block
# family each needs
NOT_PORTED: dict[str, str] = {
    "whisper-large-v3": "the encoder-decoder with cross-attention",
    "zamba2-1.2b": "Mamba2 blocks with a shared attention block",
    "rwkv6-7b": "RWKV6 blocks",
}


def get_arch(arch_id: str):
    """Returns the arch module (CONFIG, REDUCED, build)."""
    if arch_id in NOT_PORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet: it needs "
            f"{NOT_PORTED[arch_id]}, ROADMAP Queue 1 item 12a-ii (the "
            f"non-attention families and whisper); ported: {list(ARCHS)}")
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(ARCHS)}")
    return importlib.import_module(ARCHS[arch_id])


def list_archs() -> list[str]:
    return list(ARCHS)
