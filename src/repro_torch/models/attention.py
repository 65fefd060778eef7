"""Attention blocks: GQA / MQA self-attention with a ring KV cache.

Twin of the GQA half of :mod:`repro.models.attention`, in plain torch with
the twin's arithmetic: float32 scores and softmax, the weights cast to the
query dtype, float32 accumulation of the weighted values. One code path
serves train, prefill and decode:

  * train / prefill: the full (B, S) sequence under a causal (+ window)
    mask; with a cache, the last ``cache_len`` K/V are written into the
    ring;
  * decode: x is (B, 1, d); K/V are written at ``write_pos`` (ring slot
    ``pos % cache_len``) and attention runs over the cache with validity
    masks from the per-slot position ids.

Caches are dicts of tensors; an update returns new tensors and leaves the
caller's cache as it was, as the twin's functional updates do. MLA,
cross-attention, M-RoPE, bf16 scores and the context-parallel path are
not ported yet (ROADMAP Queue 1 items 12a, 12c): ``DecoderLM`` refuses
their configs, and cross-attention inputs raise here.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.models.common import (
    TransformerConfig,
    apply_rope,
    dense_init,
    make_rope,
    rms_norm,
)

__all__ = ["init_gqa", "gqa_forward", "init_gqa_cache", "sdpa"]

_NEG_INF = -2.0 ** 30

# Query-chunk length of the outer loop: bounds the score buffer at
# (B, H, CHUNK, T) float32 instead of (B, H, S, T).
SDPA_CHUNK = 1024


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet: ROADMAP Queue 1 item {item}")


# --------------------------------------------------------------------------
# GQA family
# --------------------------------------------------------------------------

def init_gqa(key, cfg: TransformerConfig, *, bias: bool = False,
             device) -> dict:
    d = cfg.d_model
    hd = cfg.resolved_head_dim
    kq, kk, kv, ko = prng.split(key, 4)
    p = {
        "wq": dense_init(kq, (d, cfg.n_heads * hd), device=device),
        "wk": dense_init(kk, (d, cfg.n_kv_heads * hd), device=device),
        "wv": dense_init(kv, (d, cfg.n_kv_heads * hd), device=device),
        "wo": dense_init(ko, (cfg.n_heads * hd, d), device=device),
    }
    if bias:
        z = lambda n: torch.zeros((n,), dtype=torch.float32, device=device)
        p["bq"] = z(cfg.n_heads * hd)
        p["bv"] = z(cfg.n_kv_heads * hd)
        p["bo"] = z(d)
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.zeros((hd,), device=device)}
        p["k_norm"] = {"scale": torch.zeros((hd,), device=device)}
    return p


def init_gqa_cache(cfg: TransformerConfig, batch: int, cache_len: int,
                   dtype=None, *, device) -> dict:
    hd = cfg.resolved_head_dim
    dtype = dtype or cfg.dtype
    shape = (batch, cache_len, cfg.n_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "slot_pos": torch.full((cache_len,), -1, dtype=torch.int32,
                               device=device),
    }


def _split_heads(x, n_heads, hd):
    B, S = x.shape[0], x.shape[1]
    return x.reshape(B, S, n_heads, hd)


def _sdpa_block(q, k, v, mask, q_group: int):
    """q: (B,S,Hq,hd); k,v: (B,T,Hkv,hd); mask: (B,1,S,T)."""
    B, S, Hq, hd = q.shape
    g = q_group
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, g, hd)
    f32 = torch.float32
    scores = torch.einsum("bskgd,btkd->bkgst", qg.to(f32), k.to(f32))
    # a 0-d device tensor (filled there, no host copy), not a Python
    # scalar: CUDA torch divides by a host scalar as a product with its
    # reciprocal, off by a bit from the twin
    scores = scores / torch.full((), np.sqrt(hd), dtype=f32,
                                 device=q.device)
    scores = scores + mask[:, :, None].to(f32)  # (B,1,1,S,T)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w.to(f32), v.to(f32))
    return out.reshape(B, S, Hq, hd).to(q.dtype)


def sdpa(q, k, v, pos_q, pos_k, *, causal, window, q_group,
         chunk: int = SDPA_CHUNK):
    """Chunked SDPA: masks are built per query chunk, and the score buffer
    is bounded by the chunk size."""
    B, S, Hq, hd = q.shape
    if S <= chunk or S % chunk != 0:
        mask = _full_mask(pos_q, pos_k, causal=causal, window=window)
        return _sdpa_block(q, k, v, mask, q_group)
    outs = []
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        mask = _full_mask(pos_q[:, sl], pos_k, causal=causal, window=window)
        outs.append(_sdpa_block(q[:, sl], k, v, mask, q_group))
    return torch.cat(outs, dim=1)


def _full_mask(positions_q, positions_k, *, causal: bool, window):
    """(B,S),(B,T) -> additive float32 mask (B,1,S,T).

    ``window`` is None (full) or an int, where 0 means full attention (the
    twin's per-layer schedule value)."""
    pq = positions_q[:, None, :, None]  # (B,1,S,1)
    pk = positions_k[:, None, None, :]  # (B,1,1,T)
    ok = pk >= 0  # invalid (unwritten) cache slots carry pos -1
    if causal:
        ok = ok & (pk <= pq)
    if window is not None and int(window) > 0:
        ok = ok & (pk > pq - int(window))
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    neg = torch.full((), _NEG_INF, dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, neg)


def _write(buf, slots, values):
    """``buf.at[:, slots].set(values)``: a new tensor, ``buf`` untouched."""
    return buf.index_copy(1, slots, values.to(buf.dtype))


def gqa_forward(
    p: dict,
    x,
    *,
    cfg: TransformerConfig,
    positions,                 # (B, S) int32 absolute positions of x
    window: int | None = None,
    causal: bool = True,
    cache: dict | None = None,
    write_pos: int | None = None,  # decode slot base (pos of x[:,0])
    mrope_positions=None,
    kv_x=None,
    kv_positions=None,
):
    """Returns (out (B,S,d), new_cache)."""
    if kv_x is not None or kv_positions is not None:
        _not_ported("cross-attention (whisper)", "12a (other block families)")
    hd = cfg.resolved_head_dim
    B, S = x.shape[0], x.shape[1]
    q = x @ p["wq"]
    v = x @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
    if "bv" in p:
        v = v + p["bv"]
    q = _split_heads(q, cfg.n_heads, hd)
    k = _split_heads(x @ p["wk"], cfg.n_kv_heads, hd)
    v = _split_heads(v, cfg.n_kv_heads, hd)

    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"]["scale"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"]["scale"], cfg.norm_eps)

    if not cfg.attn_bias:  # whisper uses learned abs pos, no rope
        cos, sin = make_rope(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    new_cache = cache
    if cache is not None:
        cache_len = cache["k"].shape[1]
        if write_pos is None:
            raise ValueError("cache updates require write_pos")
        dev = x.device
        if S > 1:
            # Prefill: attend over the in-call K/V, then persist only the
            # last cache_len entries into the ring.
            n_keep = min(S, cache_len)
            tail = (int(write_pos) + S - n_keep
                    + torch.arange(n_keep, dtype=torch.int64, device=dev))
            slots = tail % cache_len
            new_cache = {
                "k": _write(cache["k"], slots, k[:, S - n_keep:]),
                "v": _write(cache["v"], slots, v[:, S - n_keep:]),
                "slot_pos": cache["slot_pos"].index_copy(
                    0, slots, tail.to(torch.int32)),
            }
            k_att, v_att = k, v
            pos_k = positions
        else:
            # Decode: write this token's slot, attend over the ring.
            pos = (int(write_pos)
                   + torch.arange(S, dtype=torch.int64, device=dev))
            slots = pos % cache_len
            new_cache = {
                "k": _write(cache["k"], slots, k),
                "v": _write(cache["v"], slots, v),
                "slot_pos": cache["slot_pos"].index_copy(
                    0, slots, pos.to(torch.int32)),
            }
            k_att, v_att = new_cache["k"], new_cache["v"]
            pos_k = new_cache["slot_pos"][None].expand(B, cache_len)
    else:
        k_att, v_att = k, v
        pos_k = positions

    out = sdpa(q, k_att.to(q.dtype), v_att.to(q.dtype), positions, pos_k,
               causal=causal, window=window, q_group=cfg.q_group)
    out = out.reshape(B, S, cfg.n_heads * hd) @ p["wo"]
    if "bo" in p:
        out = out + p["bo"]
    return out.to(x.dtype), new_cache

