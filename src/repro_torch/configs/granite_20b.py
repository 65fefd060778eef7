"""granite-20b [dense] — llama-arch code model, MQA [arXiv:2405.04324; hf].

Twin of :mod:`repro.configs.granite_20b`: 52L d_model=6144 48H (MQA
kv=1, head_dim 128) d_ff=24576 vocab=49152. GELU (non-gated) MLP. Full
attention -> long_500k SKIPPED.
"""

import dataclasses

from repro_torch.models.common import TransformerConfig
from repro_torch.models.transformer import DecoderLM

CONFIG = TransformerConfig(
    name="granite-20b",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    rope_theta=1e5,
    mlp_kind="gelu",
    subquadratic=False,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=256,
)


def build(cfg: TransformerConfig | None = None) -> DecoderLM:
    return DecoderLM(cfg or CONFIG)
