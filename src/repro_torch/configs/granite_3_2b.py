"""granite-3-2b [dense] — GQA [hf:ibm-granite/granite-3.0-2b-base; hf].

Twin of :mod:`repro.configs.granite_3_2b`: 40L d_model=2048 32H (GQA
kv=8, head_dim 64) d_ff=8192 vocab=49155. Tied embeddings. Full
attention -> long_500k SKIPPED.
"""

import dataclasses

from repro_torch.models.common import TransformerConfig
from repro_torch.models.transformer import DecoderLM

CONFIG = TransformerConfig(
    name="granite-3-2b",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49155,
    rope_theta=1e4,
    tie_embeddings=True,
    subquadratic=False,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
)


def build(cfg: TransformerConfig | None = None) -> DecoderLM:
    return DecoderLM(cfg or CONFIG)
