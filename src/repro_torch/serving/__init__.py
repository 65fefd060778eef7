"""Batched LM serving runtime, and the SNN serving stack's names.

Twin of :mod:`repro.serving`. Two layers for LMs:

  * :class:`BatchServer` — prefill a batch of prompts, then greedy-decode
    to completion, one eager step a token on an explicit device (the
    twin jits one step function);
  * :class:`Scheduler` — groups pending requests into length buckets so
    padding waste stays bounded.

The SNN analogue — stateful spike streams over one SpikeEngine step — is
:mod:`repro_torch.serving.snn`, with the async front door in
:mod:`repro_torch.serving.frontend`; their names are re-exported here, as
the twin re-exports its own.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.serving.connector import (  # re-exported
    CarryConnectorBase,
    CarrySnapshot,
    FileCarryConnector,
    InMemoryCarryConnector,
    migrate_stream,
    rebalance_streams,
)
from repro_torch.serving.frontend import (  # re-exported
    AsyncSpikeFrontend,
    FrontendConfig,
    RequestHandle,
)
from repro_torch.serving.qos import (  # re-exported
    QoSClass,
    QoSPolicy,
    WeightedFairQueue,
)
from repro_torch.serving.snn import (  # re-exported
    ModelStream,
    SlotScheduler,
    SpikeServer,
    StreamStats,
)
from repro_torch.tree import tree_map

__all__ = ["Request", "Completion", "BatchServer", "Scheduler",
           "SpikeServer", "SlotScheduler", "ModelStream", "StreamStats",
           "AsyncSpikeFrontend", "FrontendConfig", "RequestHandle",
           "QoSClass", "QoSPolicy", "WeightedFairQueue",
           "CarryConnectorBase", "CarrySnapshot", "InMemoryCarryConnector",
           "FileCarryConnector", "migrate_stream", "rebalance_streams"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray           # (S,) int32 token ids
    max_new_tokens: int = 32
    eos_id: int | None = None


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: np.ndarray           # (<=max_new,) generated ids
    prompt_len: int
    latency_s: float


class BatchServer:
    """Fixed-slot batched prefill + decode engine for one model on
    ``device`` (default ``"cuda"``; ``"cpu"`` for the host). The params
    are moved there."""

    def __init__(self, model, params, *, max_seq: int, pad_id: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.max_seq = max_seq
        self.pad_id = pad_id

    # -- step bodies (the twin's jitted functions) ------------------------
    @torch.inference_mode()
    def _prefill(self, params, tokens, *, batch: int, seq: int):
        cache = self.model.init_cache(batch, self.max_seq,
                                      device=self.device)
        logits, cache = self.model.prefill(params, {"tokens": tokens}, cache)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], cache

    @torch.inference_mode()
    def _decode_step(self, params, cache, tokens, pos: int):
        logits, cache = self.model.decode_step(params, {"tokens": tokens},
                                               pos, cache)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok[:, None], cache

    # -- public -----------------------------------------------------------
    def serve(self, requests: Sequence[Request]) -> list[Completion]:
        """Greedy-decode a batch of same-bucket requests. Prompts are
        left-padded to the longest; positions run from 0 over the pads,
        and in the recurrent archs the pads enter the state, as in the
        twin (ROADMAP Queue 3 item 9)."""
        t0 = time.perf_counter()
        B = len(requests)
        prompt_lens = [len(r.prompt) for r in requests]
        S = max(prompt_lens)
        toks = np.full((B, S), self.pad_id, np.int32)
        for i, r in enumerate(requests):
            toks[i, S - len(r.prompt):] = r.prompt  # left-pad to align end
        tok, cache = self._prefill(
            self.params, torch.from_numpy(toks).to(self.device), batch=B,
            seq=S)
        max_new = max(r.max_new_tokens for r in requests)
        max_new = min(max_new, self.max_seq - S)
        out = np.zeros((B, max_new), np.int32)
        done = np.zeros(B, bool)
        steps = 0
        for step in range(max_new):
            out[:, step] = tok[:, 0].cpu().numpy()
            for i, r in enumerate(requests):
                if r.eos_id is not None and out[i, step] == r.eos_id:
                    done[i] = True
                if step + 1 >= r.max_new_tokens:
                    done[i] = True
            steps += 1
            if done.all():
                break
            tok, cache = self._decode_step(self.params, cache, tok, S + step)
        dt = time.perf_counter() - t0
        comps = []
        for i, r in enumerate(requests):
            n = min(r.max_new_tokens, steps)
            comps.append(Completion(uid=r.uid, tokens=out[i, :n],
                                    prompt_len=prompt_lens[i], latency_s=dt))
        return comps

    def throughput_stats(self, comps: list[Completion]) -> dict:
        toks = sum(len(c.tokens) for c in comps)
        dt = max(c.latency_s for c in comps)
        return {"generated_tokens": toks, "wall_s": dt,
                "tokens_per_s": toks / max(dt, 1e-9)}


class Scheduler:
    """Length-bucketing admission: batches of <= max_batch, prompts padded
    at most 2x within a bucket (bounded padding waste)."""

    def __init__(self, max_batch: int):
        self.max_batch = max_batch
        self.pending: list[Request] = []

    def submit(self, req: Request) -> None:
        self.pending.append(req)

    def next_batch(self) -> list[Request]:
        if not self.pending:
            return []
        self.pending.sort(key=lambda r: len(r.prompt))
        anchor = len(self.pending[0].prompt)
        batch = [r for r in self.pending
                 if len(r.prompt) <= max(2 * anchor, anchor + 16)]
        batch = batch[: self.max_batch]
        taken = {id(r) for r in batch}
        self.pending = [r for r in self.pending if id(r) not in taken]
        return batch
