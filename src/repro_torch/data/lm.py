"""Synthetic LM token pipeline, numpy only (no corpora, no download).

Twin of :mod:`repro.data.lm` (a copy: the port imports nothing of the
JAX package). Deterministic, learnable token streams for the LM launcher
and tests: a second-order Markov source over a Zipf-distributed vocabulary
(next token = mix(hash(prev, prev2), zipf noise)), so the train loss can
fall by learning the transitions.

``sample(batch, seq_len, step)`` is a pure function of (seed, step,
shard): resumable and shardable with no iterator state, and equal to the
twin's byte for byte.
"""

from __future__ import annotations

import numpy as np

__all__ = ["TokenStream", "lm_batches"]


class TokenStream:
    def __init__(self, vocab_size: int, seed: int = 0,
                 structure: float = 0.8):
        self.vocab_size = int(vocab_size)
        self.seed = seed
        self.structure = structure
        # Zipf weights over vocab (heavy head, long tail)
        ranks = np.arange(1, self.vocab_size + 1, dtype=np.float64)
        w = 1.0 / ranks ** 1.1
        self.probs = (w / w.sum()).astype(np.float64)

    def _hash_next(self, a: np.ndarray, b: np.ndarray) -> np.ndarray:
        h = (a.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
             ^ b.astype(np.uint64) * np.uint64(0xC2B2AE3D27D4EB4F))
        h ^= h >> np.uint64(29)
        h *= np.uint64(0xBF58476D1CE4E5B9)
        h ^= h >> np.uint64(32)
        return (h % np.uint64(self.vocab_size)).astype(np.int64)

    def sample(self, batch: int, seq_len: int, step: int,
               shard_index: int = 0, num_shards: int = 1) -> np.ndarray:
        s = (self.seed * 2_000_003 + step * num_shards + shard_index)
        rng = np.random.default_rng(s)
        toks = np.empty((batch, seq_len + 1), np.int64)
        toks[:, 0] = rng.choice(self.vocab_size, batch, p=self.probs)
        toks[:, 1] = rng.choice(self.vocab_size, batch, p=self.probs)
        for t in range(2, seq_len + 1):
            structured = self._hash_next(toks[:, t - 1], toks[:, t - 2])
            noise = rng.choice(self.vocab_size, batch, p=self.probs)
            use = rng.random(batch) < self.structure
            toks[:, t] = np.where(use, structured, noise)
        return toks


def lm_batches(vocab_size: int, batch: int, seq_len: int, num_steps: int, *,
               seed: int = 0, start_step: int = 0, shard_index: int = 0,
               num_shards: int = 1):
    """Yields (step, tokens (B,S) i32, targets (B,S) i32)."""
    stream = TokenStream(vocab_size, seed)
    for step in range(start_step, num_steps):
        toks = stream.sample(batch, seq_len, step, shard_index, num_shards)
        yield step, toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)
