"""mixtral-8x7b [moe] — 8 experts top-2, SWA-4096 [arXiv:2401.04088; hf].

Twin of :mod:`repro.configs.mixtral_8x7b`.

32L d_model=4096 32H (GQA kv=8, head_dim 128) d_ff=14336 vocab=32000.
Sliding-window attention makes it sub-quadratic -> long_500k runs with a
4096-slot ring cache. MoE top-2 gating is the closest architectural
analogue of the paper's event-gated weight fetch (DESIGN.md §4).
"""

import dataclasses

from repro_torch.models.common import MoEConfig, TransformerConfig
from repro_torch.models.transformer import DecoderLM

CONFIG = TransformerConfig(
    name="mixtral-8x7b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    sliding_window=4096,
    rope_theta=1e6,
    moe=MoEConfig(n_experts=8, top_k=2),
    subquadratic=True,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, sliding_window=8,
    moe=MoEConfig(n_experts=4, top_k=2),
)


def build(cfg: TransformerConfig | None = None) -> DecoderLM:
    return DecoderLM(cfg or CONFIG)
