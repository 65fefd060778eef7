"""JAX's default PRNG, threefry2x32, bit for bit in plain torch.

The port's own copy of the three pieces of ``jax.random`` the JAX package
uses, as JAX computes them with 64-bit mode off and
``jax_threefry_partitionable`` on:

* :func:`key` — ``jax.random.key(seed)``: the words ``(0, seed mod 2^32)``;
* :func:`split` — the fold-like split: key ``i`` of ``n`` is the threefry
  hash of the counter pair ``(i >> 32, i mod 2^32)``;
* :func:`uniform` — float32 on [0, 1): the hash of each element's flat
  index, its two words xor-ed, the top 23 bits as a mantissa of [1, 2),
  minus 1.

A key is a (2,) int64 tensor holding the two uint32 words. CPU torch has no
uint32 shifts or compares, so every word is a uint32 held in int64 and is
masked after each add and shift (as :func:`repro_torch.kernels.ref.
hash_u32_ref` does); the same integer code then gives the same bits on the
CPU and on the card.
"""

from __future__ import annotations

import math

import torch

__all__ = ["as_key", "key", "split", "threefry2x32", "uniform"]

_U32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA  # the Threefry key-schedule constant


def key(seed: int) -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))``: ``(0, seed mod 2^32)``
    for any Python int, negative or past 32 bits, as JAX gives it."""
    return torch.tensor([0, int(seed) & _U32], dtype=torch.int64)


def _check_key(k) -> torch.Tensor:
    if not (isinstance(k, torch.Tensor) and k.shape == (2,)):
        raise ValueError(f"a key is a (2,) tensor of uint32 words, got "
                         f"{getattr(k, 'shape', type(k).__name__)}")
    return k


def as_key(seed_or_key) -> torch.Tensor:
    """An int seed becomes :func:`key`; a (2,) key passes through."""
    if isinstance(seed_or_key, torch.Tensor) and seed_or_key.ndim == 1:
        return _check_key(seed_or_key)
    return key(int(seed_or_key))


def _words(k: torch.Tensor) -> tuple[int, int]:
    k1, k2 = _check_key(k).tolist()
    return int(k1) & _U32, int(k2) & _U32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _U32) | (x >> (32 - r))


def threefry2x32(k1: int, k2: int, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block (20 rounds) of the key words ``k1``, ``k2``
    over the counter words ``x0``, ``x1`` (int64 holding uint32)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = (x0 + ks[0]) & _U32
    x1 = (x1 + ks[1]) & _U32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _U32
    return x0, x1


def _hash_iota(k: torch.Tensor, shape: tuple, device):
    """Both output words of threefry over the row-major flat index of
    ``shape``, split into its high and low 32 bits."""
    i = torch.arange(math.prod(shape), dtype=torch.int64,
                     device=device).reshape(shape)
    return threefry2x32(*_words(k), i >> 32, i & _U32)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(k, num)``: a (num, 2) tensor of keys on the
    key's device."""
    bits1, bits2 = _hash_iota(k, (int(num),), _check_key(k).device)
    return torch.stack([bits1, bits2], dim=-1)


def uniform(k: torch.Tensor, shape=(), device=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape)``: float32 on [0, 1), on ``device``
    (default: the key's)."""
    device = _check_key(k).device if device is None else device
    bits1, bits2 = _hash_iota(k, tuple(shape), device)
    # 32 random bits, as jax.random.bits; their top 23 as the mantissa
    one_to_two = (((bits1 ^ bits2) >> 9) | 0x3F800000).to(torch.int32)
    return one_to_two.view(torch.float32) - 1.0
