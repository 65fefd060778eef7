"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Twin of :mod:`repro.configs.qwen2_vl_2b`.

28L d_model=1536 12H (GQA kv=2, head_dim 128) d_ff=8960 vocab=151936.
The vision frontend is a stub: input_specs() supplies merged patch+text
embeddings (B, S, d) plus 3D M-RoPE position ids (3, B, S) =
(temporal, height, width). Tied embeddings. Full attention -> long_500k
SKIPPED. 12 heads not divisible by 16 -> attention replicates over
'model'; FFN carries TP.
"""

import dataclasses

from repro_torch.models.common import TransformerConfig
from repro_torch.models.transformer import DecoderLM

CONFIG = TransformerConfig(
    name="qwen2-vl-2b",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    rope_theta=1e6,
    mrope=True,
    frontend="embeddings",
    tie_embeddings=True,
    subquadratic=False,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
)


def build(cfg: TransformerConfig | None = None) -> DecoderLM:
    return DecoderLM(cfg or CONFIG)
