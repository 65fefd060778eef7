"""Assigned input shapes (one set shared by all LM archs).

Twin of :mod:`repro.configs.shapes`. ``train_*`` is the train step's
shape; ``prefill_*`` the serving prefill; ``decode_*`` / ``long_*`` one
new token against a KV cache of seq_len. long_500k requires a
sub-quadratic arch (cfg.subquadratic).
"""

from __future__ import annotations

import dataclasses

__all__ = ["Shape", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4_096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32_768, 128, "decode"),
    "long_500k": Shape("long_500k", 524_288, 1, "decode"),
}
