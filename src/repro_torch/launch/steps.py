"""LMHarness: per-(arch x shape) serving step functions and their shapes.

Twin of the serving half of :mod:`repro.launch.steps`:

  * ``param_shapes()``       — the params on the ``meta`` device (shapes
    and dtypes, nothing drawn or allocated), where the twin uses
    ``eval_shape``;
  * ``batch_shapes`` / ``token_shapes`` / ``cache_shapes`` — ``meta``
    tensors standing in for the step inputs (tokens, ``embeds`` and
    ``mrope_positions`` for the embeddings frontend, or whisper's
    ``enc_embeds`` with its decoder tokens, each half the shape's
    sequence) and the caches (GQA rings, MLA latents, the split layout,
    recurrent states, whisper's self and cross caches), as the twin's
    ``ShapeDtypeStruct``s do;
  * ``make_prefill_step`` — build + fill KV caches;
  * ``make_decode_step``  — one greedy token against the cache (with
    M-RoPE ids of the position, as the twin gives them).

The train step (microbatched accumulation + AdamW, with the harness's
optimizer and microbatch fields) waits for ROADMAP Queue 1 item 12b and
the shardings (with the EP / TP levers) for item 12c: both raise.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import configs
from repro_torch.configs.shapes import Shape
from repro_torch.core import prng

__all__ = ["LMHarness", "SkipCell"]

_META = torch.device("meta")


class SkipCell(Exception):
    """Raised when an (arch x shape) cell is N/A (documented skip)."""


@dataclasses.dataclass
class LMHarness:
    arch_id: str
    cfg: Any = None

    def __post_init__(self):
        mod = configs.get_arch(self.arch_id)
        self.cfg = self.cfg or mod.CONFIG
        self.model = mod.build(self.cfg)
        self.is_whisper = self.arch_id == "whisper-large-v3"

    # ------------------------------------------------------------------
    # shapes (no allocation anywhere)
    # ------------------------------------------------------------------
    def param_shapes(self) -> dict:
        return self.model.init(prng.key(0), device=_META)

    def check_cell(self, shape: Shape) -> None:
        if shape.name == "long_500k" and not self.cfg.subquadratic:
            raise SkipCell(
                f"{self.arch_id} is pure full-attention; long_500k needs a "
                f"sub-quadratic arch")

    def batch_shapes(self, shape: Shape) -> dict:
        """Inputs for train / prefill kinds (decode uses token_shapes)."""
        self.check_cell(shape)
        B, S = shape.global_batch, shape.seq_len
        cfg = self.cfg

        def i32(*dims):
            return torch.empty(dims, dtype=torch.int32, device=_META)

        if self.is_whisper:
            half = S // 2
            return {"enc_embeds": torch.empty((B, half, cfg.d_model),
                                              dtype=cfg.dtype, device=_META),
                    "tokens": i32(B, half), "targets": i32(B, half)}
        if cfg.frontend == "embeddings":
            out = {"embeds": torch.empty((B, S, cfg.d_model),
                                         dtype=cfg.dtype, device=_META),
                   "targets": i32(B, S)}
            if cfg.mrope:
                out["mrope_positions"] = i32(3, B, S)
            return out
        return {"tokens": i32(B, S), "targets": i32(B, S)}

    def cache_shapes(self, shape: Shape) -> dict:
        self.check_cell(shape)
        return self._init_cache(shape, _META)

    def _init_cache(self, shape: Shape, device) -> dict:
        """A fresh cache of ``shape``: whisper's self and cross caches of
        ``seq_len // 2`` each, the others' of ``seq_len``."""
        B, S = shape.global_batch, shape.seq_len
        if self.is_whisper:
            return self.model.init_cache(B, S // 2, S // 2, device=device)
        return self.model.init_cache(B, S, device=device)

    def token_shapes(self, shape: Shape) -> dict:
        """Decode-step inputs (one new token)."""
        B = shape.global_batch
        return {"tokens": torch.empty((B, 1), dtype=torch.int32,
                                      device=_META)}

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------
    def make_train_step(self, shape: Shape, mesh=None):
        raise NotImplementedError(
            "the LM train step is not ported yet: ROADMAP Queue 1 item 12b "
            "(LM training)")

    def make_prefill_step(self, shape: Shape, *, device="cuda"):
        """``prefill(params, batch) -> (last logits, cache)`` with a fresh
        cache of ``shape`` on ``device``."""
        model = self.model

        @torch.inference_mode()
        def prefill(params, batch):
            return model.prefill(params, batch,
                                 self._init_cache(shape, device))

        return prefill

    def make_decode_step(self, shape: Shape):
        """``decode(params, cache, token_in, pos) -> (next token (B, 1)
        int32, cache)``: one greedy token."""
        model = self.model
        cfg = self.cfg

        @torch.inference_mode()
        def decode(params, cache, token_in, pos):
            tin = dict(token_in)
            if cfg.mrope:
                tok = torch.as_tensor(token_in["tokens"])
                tin["mrope_positions"] = torch.full(
                    (3, tok.shape[0], 1), int(pos), dtype=torch.int32,
                    device=tok.device)
            logits, cache = model.decode_step(params, tin, pos, cache)
            next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            return next_tok[:, None], cache

        return decode

    # ------------------------------------------------------------------
    # shardings
    # ------------------------------------------------------------------
    def shardings(self, shape: Shape, mesh, kind: str):
        raise NotImplementedError(
            "LM shardings are not ported yet: ROADMAP Queue 1 item 12c (the "
            "LM partitioner)")
