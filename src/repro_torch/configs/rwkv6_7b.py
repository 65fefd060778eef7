"""rwkv6-7b [ssm] — Finch, data-dependent decay [arXiv:2404.05892; hf].

Twin of :mod:`repro.configs.rwkv6_7b`: 32L d_model=4096 (attention-free;
64 heads x 64) d_ff=14336 vocab=65536. Token mixing is an O(1)-state
linear recurrence with learned per-channel decay. long_500k RUNS (decode
state does not grow with context at all).
"""

import dataclasses

from repro_torch.models.common import RWKVConfig, TransformerConfig
from repro_torch.models.transformer import DecoderLM

CONFIG = TransformerConfig(
    name="rwkv6-7b",
    n_layers=32,
    d_model=4096,
    n_heads=64,
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    block_kind="rwkv6",
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, gate_lora=32),
    subquadratic=True,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    rwkv=RWKVConfig(head_dim=16, decay_lora=8, gate_lora=8),
)


def build(cfg: TransformerConfig | None = None) -> DecoderLM:
    return DecoderLM(cfg or CONFIG)
