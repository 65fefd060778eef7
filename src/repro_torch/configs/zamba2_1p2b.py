"""zamba2-1.2b [hybrid] — Mamba2 + shared attention blocks
[arXiv:2411.15242; hf].

Twin of :mod:`repro.configs.zamba2_1p2b`: 38 Mamba2 layers (d_model=2048,
d_inner=4096, heads 64x64, ssm_state=64) with ONE weight-shared
attention+MLP block (32H, kv=32, d_ff=8192) invoked every 6 layers
through per-invocation LoRA. Hybrid -> long_500k RUNS (the backbone state
is O(1) in context; only the 6 shared-attention caches grow).
"""

import dataclasses

from repro_torch.models.common import SSMConfig, TransformerConfig
from repro_torch.models.zamba2 import Zamba2LM

CONFIG = TransformerConfig(
    name="zamba2-1.2b",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    block_kind="mamba2",
    shared_attn_every=6,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64),
    tie_embeddings=True,
    subquadratic=True,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=7, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256, shared_attn_every=3,
    ssm=SSMConfig(d_state=8, d_conv=4, expand=2, head_dim=16),
)


def build(cfg: TransformerConfig | None = None) -> Zamba2LM:
    return Zamba2LM(cfg or CONFIG)
