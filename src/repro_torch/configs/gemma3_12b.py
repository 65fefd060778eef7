"""gemma3-12b [dense] — 5:1 local:global attention, 128k context

Twin of :mod:`repro.configs.gemma3_12b`.
[hf:google/gemma-3 family; unverified].

48L d_model=3840 16H (GQA kv=8, head_dim 256) d_ff=15360 vocab=262144.
Five sliding-window (1024) layers per global layer; qk-norm; geglu;
scaled + tied embeddings. Mostly-local attention -> long_500k RUNS (the
global layers' decode cost is linear in context with a cache; prefill
quadratic cost applies only to every 6th layer).
"""

import dataclasses

from repro_torch.models.common import TransformerConfig
from repro_torch.models.transformer import DecoderLM

CONFIG = TransformerConfig(
    name="gemma3-12b",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    sliding_window=1024,
    global_every=6,
    rope_theta=1e6,
    qk_norm=True,
    mlp_kind="geglu",
    embed_scale=True,
    tie_embeddings=True,
    subquadratic=True,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=6, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, sliding_window=8, global_every=3,
)


def build(cfg: TransformerConfig | None = None) -> DecoderLM:
    return DecoderLM(cfg or CONFIG)
