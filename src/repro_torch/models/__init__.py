"""LM model zoo: shared layers and every family of the twin.

Twin of :mod:`repro.models`: ``common``, ``attention`` (GQA / MQA with
cross-attention, MLA), ``moe``, ``mamba2``, ``rwkv6``, ``transformer``
(the decoder stack over attention, Mamba2 and RWKV6 blocks), ``zamba2``
(the hybrid with one shared attention block) and ``whisper`` (the
encoder-decoder).
"""

from repro_torch.models import (  # noqa: F401
    attention,
    common,
    mamba2,
    moe,
    rwkv6,
    transformer,
    whisper,
    zamba2,
)
