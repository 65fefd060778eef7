"""minicpm3-4b [dense] — MLA (multi-head latent attention)

Twin of :mod:`repro.configs.minicpm3_4b`.
[hf:openbmb/MiniCPM3-4B; hf].

62L d_model=2560 40H d_ff=6400 vocab=73448. MLA compresses the KV cache
into a 256-d latent + 32-d rope key per token (the paper's
memory-dominates lens applied to decode). Full attention -> long_500k
SKIPPED. 40 heads are not divisible by the 16-way model axis: attention
weights replicate over 'model' (partitioner divisibility fallback); FFN
carries the TP sharding.
"""

import dataclasses

from repro_torch.models.common import MLAConfig, TransformerConfig
from repro_torch.models.transformer import DecoderLM

CONFIG = TransformerConfig(
    name="minicpm3-4b",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=96,  # nope 64 + rope 32
    d_ff=6400,
    vocab_size=73448,
    rope_theta=1e4,
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, rope_head_dim=32,
                  nope_head_dim=64, v_head_dim=64),
    subquadratic=False,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=24,
    d_ff=128, vocab_size=256,
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
                  nope_head_dim=16, v_head_dim=16),
)


def build(cfg: TransformerConfig | None = None) -> DecoderLM:
    return DecoderLM(cfg or CONFIG)
