"""JAX's default PRNG, threefry2x32, bit for bit in plain torch.

The port's own copy of the three pieces of ``jax.random`` the JAX package
uses, as JAX computes them with 64-bit mode off and
``jax_threefry_partitionable`` on:

* :func:`key` — ``jax.random.key(seed)``: the words ``(0, seed mod 2^32)``;
* :func:`split` — the fold-like split: key ``i`` of ``n`` is the threefry
  hash of the counter pair ``(i >> 32, i mod 2^32)``;
* :func:`uniform` — float32 on [0, 1): the hash of each element's flat
  index, its two words xor-ed, the top 23 bits as a mantissa of [1, 2),
  minus 1;
* :func:`fold_in` — ``jax.random.fold_in(k, data)``: one threefry call on
  the counter pair ``(0, data mod 2^32)``;
* :func:`normal` — ``jax.random.normal(k, shape)`` in float32:
  ``sqrt(2) * erfinv(u)``, ``u`` uniform on ``(nextafter(-1, 0), 1)``.
  The uniforms are JAX's bits and ``erf_inv`` is XLA's float32
  polynomial, so the normals agree with JAX's to rtol 1e-6, not always
  bit for bit (``log1p``, taken in float64 so that every device gives
  the same bits, differs from XLA's in the last bit now and then).

Each element is hashed on its own flat index, so :func:`uniform` and
:func:`normal` draw a large shape chunk by chunk (``_CHUNK`` indices at a
time) into their output: the same bits, with bounded int64 temporaries.

A key is a (2,) int64 tensor holding the two uint32 words. CPU torch has no
uint32 shifts or compares, so every word is a uint32 held in int64 and is
masked after each add and shift (as :func:`repro_torch.kernels.ref.
hash_u32_ref` does); the same integer code then gives the same bits on the
CPU and on the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["as_key", "fold_in", "key", "normal", "split", "threefry2x32",
           "uniform"]

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


def _hash_iota(k: torch.Tensor, shape: tuple, device, start: int = 0):
    """Both output words of threefry over the row-major flat index of
    ``shape`` (offset by ``start``), split into its high and low 32 bits."""
    i = torch.arange(start, start + math.prod(shape), dtype=torch.int64,
                     device=device).reshape(shape)
    return threefry2x32(*_words(k), i >> 32, i & _U32)


# Flat indices hashed at once by uniform / normal: each element is hashed
# on its own counter (the partitionable threefry), so a large draw is made
# chunk by chunk into its output and no int64 temporary exceeds 128 MiB.
_CHUNK = 1 << 24


def _chunked(fn, shape: tuple, device) -> torch.Tensor:
    """``fn(start, n)`` (float32 values of flat indices ``start ..
    start + n``) over ``shape``, one chunk of at most ``_CHUNK`` at a
    time."""
    if torch.device(device).type == "meta":  # shapes only: nothing drawn
        return torch.empty(shape, dtype=torch.float32, device=device)
    total = math.prod(shape)
    if total <= _CHUNK:
        return fn(0, total).reshape(shape)
    out = torch.empty(total, dtype=torch.float32, device=device)
    for start in range(0, total, _CHUNK):
        n = min(_CHUNK, total - start)
        out[start:start + n] = fn(start, n)
    return out.reshape(shape)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(k, num)``: a (num, 2) tensor of keys on the
    key's device."""
    bits1, bits2 = _hash_iota(k, (int(num),), _check_key(k).device)
    return torch.stack([bits1, bits2], dim=-1)


def fold_in(k: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(k, data)``: a (2,) key on the key's device.
    ``data`` is taken mod 2^32, as JAX's ``uint32`` cast takes it."""
    dev = _check_key(k).device
    x0 = torch.zeros(1, dtype=torch.int64, device=dev)
    x1 = torch.full((1,), int(data) & _U32, dtype=torch.int64, device=dev)
    w0, w1 = threefry2x32(*_words(k), x0, x1)
    return torch.cat([w0, w1])


def uniform(k: torch.Tensor, shape=(), device=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape)``: float32 on [0, 1), on ``device``
    (default: the key's)."""
    device = _check_key(k).device if device is None else device
    return _chunked(lambda start, n: _uniform_flat(k, start, n, device),
                    tuple(shape), device)


def _uniform_flat(k: torch.Tensor, start: int, n: int, device):
    """:func:`uniform`'s values at flat indices ``start .. start + n``."""
    bits1, bits2 = _hash_iota(k, (n,), device, start)
    # 32 random bits, as jax.random.bits; their top 23 as the mantissa
    one_to_two = (((bits1 ^ bits2) >> 9) | 0x3F800000).to(torch.int32)
    return one_to_two.view(torch.float32) - 1.0


# XLA's float32 ErfInv (M. Giles, "Approximating the erfinv function"):
# a degree-8 polynomial in w - 2.5 (w < 5) or sqrt(w) - 3, w = -log1p(-x^2)
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def _erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` polynomial on float32 ``x`` in (-1, 1),
    evaluated with the same float32 ops (no FMA contraction).

    ``log1p`` and ``sqrt`` are taken in float64 and rounded to float32:
    the float32 ones of the host and of the card differ in the last bit
    (CPU torch's float32 ``sqrt`` is not correctly rounded), and in the
    tails, where a normal moves ~3e4 times its argument, that moved a
    drawn weight by up to 7e-5 between the card and one host. Rounded
    from float64, both give the correctly rounded float32 value."""
    f64 = torch.float64
    w = -torch.log1p(-(x * x).to(f64)).to(torch.float32)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5,
                    torch.sqrt(w.to(f64)).to(torch.float32) - 3.0)
    p = None
    for a, b in zip(_ERFINV_W_LT_5, _ERFINV_W_GE_5):
        c = torch.where(lt, torch.tensor(a, dtype=torch.float32,
                                         device=x.device),
                        torch.tensor(b, dtype=torch.float32,
                                     device=x.device))
        p = c if p is None else c + p * w
    return p * x


def normal(k: torch.Tensor, shape=(), device=None) -> torch.Tensor:
    """``jax.random.normal(k, shape)``: float32 standard normals on
    ``device`` (default: the key's).

    JAX's float32 path: uniforms scaled onto ``[lo, 1)`` with ``lo =
    nextafter(-1, 0)`` (``u * (1 - lo) + lo``, each op rounded in float32,
    then ``max(lo, .)``; these are JAX's bits), then ``sqrt(2) *
    erf_inv(u)`` with XLA's polynomial. ``log1p`` (float64, rounded)
    differs from XLA's float32 one in the last bit now and then, so the
    normals agree with JAX's to rtol 1e-6 (2.4e-7 measured; ~95 % of them
    bit for bit), not exactly; on the card and the host they are equal.
    """
    device = _check_key(k).device if device is None else device
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    span = float(np.float32(1.0) - np.float32(lo))
    sqrt2 = float(np.float32(np.sqrt(2.0)))

    def flat(start: int, n: int) -> torch.Tensor:
        u = torch.clamp_min(_uniform_flat(k, start, n, device) * span + lo,
                            lo)
        return _erfinv_f32(u) * sqrt2

    return _chunked(flat, tuple(shape), device)
