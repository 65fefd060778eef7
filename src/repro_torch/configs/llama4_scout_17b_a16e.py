"""llama4-scout-17b-a16e [moe] — 16 experts top-1 + shared expert

Twin of :mod:`repro.configs.llama4_scout_17b_a16e`.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8, head_dim 128) per-expert d_ff=8192
vocab=202048. Full attention -> long_500k SKIPPED (DESIGN.md §4). The
"early fusion" multimodal frontend is out of backbone scope (text tokens
here); MoE top-1 routing again mirrors the paper's gated weight access.
"""

import dataclasses

from repro_torch.models.common import MoEConfig, TransformerConfig
from repro_torch.models.transformer import DecoderLM

CONFIG = TransformerConfig(
    name="llama4-scout-17b-a16e",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    rope_theta=5e5,
    moe=MoEConfig(n_experts=16, top_k=1, shared_expert=True),
    subquadratic=False,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=256,
    moe=MoEConfig(n_experts=4, top_k=1, shared_expert=True),
)


def build(cfg: TransformerConfig | None = None) -> DecoderLM:
    return DecoderLM(cfg or CONFIG)
