"""whisper-large-v3 [audio] — enc-dec, conv frontend STUB
[arXiv:2212.04356; unverified].

Twin of :mod:`repro.configs.whisper_large_v3`: 32 encoder + 32 decoder
layers, d_model=1280 20H (MHA kv=20, head_dim 64) d_ff=5120 vocab=51866.
The mel / conv frontend is a stub: the caller supplies precomputed frame
embeddings (B, S_enc, d). Shape mapping: seq_len splits as enc_frames =
seq//2, dec_tokens = seq//2. Full attention -> long_500k SKIPPED.

``build`` keeps the twin's identity test: CONFIG itself gets the 32768-row
decoder position table, any other config (a ``dataclasses.replace`` of
CONFIG included) a 64-row one, its decoder positions wrapping at 64.
"""

import dataclasses

from repro_torch.models.common import TransformerConfig
from repro_torch.models.whisper import WhisperLM

CONFIG = TransformerConfig(
    name="whisper-large-v3",
    n_layers=32,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    attn_bias=True,
    mlp_kind="gelu",
    norm_eps=1e-5,
    subquadratic=False,
)

REDUCED = dataclasses.replace(
    CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
)


def build(cfg: TransformerConfig | None = None) -> WhisperLM:
    cfg = cfg or CONFIG
    return WhisperLM(cfg, max_dec_len=1 << 15 if cfg is CONFIG else 64)
