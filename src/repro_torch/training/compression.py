"""Gradient compression for bandwidth-constrained all-reduce.

Twin of :mod:`repro.training.compression`:

  * top-k sparsification with **error feedback** (the residual is carried
    to the next step, so the compressed SGD converges; Stich et al.);
  * int8 quantization with a per-tensor scale and stochastic rounding.
    Its noise is drawn through the port's threefry (:mod:`repro_torch.
    core.prng`), ``split`` then ``uniform``, so on the same grads and key
    it gives the twin's bytes.

They wrap the gradient tree before the reduction; the reduction then moves
k values + indices (or int8) instead of float32.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import prng
from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["TopKCompressor", "Int8Compressor"]


def _is_sparse(x) -> bool:
    return isinstance(x, dict) and "values" in x


def _is_q(x) -> bool:
    return isinstance(x, dict) and "q" in x


@dataclasses.dataclass(frozen=True)
class TopKCompressor:
    """Keep the k largest-magnitude entries per tensor; residual feedback."""

    fraction: float = 0.01  # keep top 1% by default

    def init_error(self, params):
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)

    def compress(self, grads, error):
        """-> (sparse {values, indices, size} per leaf, new_error)."""
        pairs = []

        def one(g, e):
            g = g.to(torch.float32) + e
            flat = g.reshape(-1)
            k = max(1, int(flat.shape[0] * self.fraction))
            idx = torch.topk(torch.abs(flat), k).indices.to(torch.int32)
            vals = flat[idx.long()]
            new_e = flat.clone()
            new_e[idx.long()] = 0.0
            pairs.append(new_e.reshape(g.shape))
            return {"values": vals, "indices": idx, "size": flat.shape[0]}

        sparse = tree_map(one, grads, error)
        return sparse, unflatten(grads, pairs)

    def decompress(self, sparse, shapes):
        def one(s, shape):
            flat = torch.zeros((s["size"],), dtype=torch.float32,
                               device=s["values"].device)
            flat.index_add_(0, s["indices"].long(), s["values"])
            return flat.reshape(tuple(shape))

        return tree_map(one, sparse, shapes, is_leaf=_is_sparse)

    def wire_bytes(self, sparse) -> int:
        """Bytes this representation puts on the interconnect."""
        return sum(int(leaf["values"].numel()) * 4 * 2  # f32 + i32 index
                   for leaf in leaves(sparse, is_leaf=_is_sparse)
                   if isinstance(leaf, dict))


@dataclasses.dataclass(frozen=True)
class Int8Compressor:
    """Per-tensor absmax int8 quantization with stochastic rounding."""

    def compress(self, grads, key):
        keys = _tree_keys(prng.as_key(key), grads)

        def one(g, k):
            g = g.to(torch.float32)
            scale = torch.clamp_min(torch.max(torch.abs(g)), 1e-12) / 127.0
            scaled = g / scale
            # jax.random.uniform(k, minval=-0.5, maxval=0.5)
            noise = torch.clamp_min(
                prng.uniform(k, tuple(g.shape), g.device) * 1.0 + (-0.5),
                -0.5)
            q = torch.clamp(torch.round(scaled + noise), -127, 127).to(
                torch.int8)
            return {"q": q, "scale": scale}

        return tree_map(one, grads, keys)

    def decompress(self, comp):
        return tree_map(lambda c: c["q"].to(torch.float32) * c["scale"],
                        comp, is_leaf=_is_q)

    def wire_bytes(self, comp) -> int:
        return sum(int(leaf["q"].numel()) + 4
                   for leaf in leaves(comp, is_leaf=_is_q)
                   if isinstance(leaf, dict))


def _tree_keys(key, tree):
    flat = leaves(tree)
    return unflatten(tree, list(prng.split(key, len(flat))))
