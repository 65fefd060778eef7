"""Attention blocks: GQA / MQA (+ SWA, local:global, M-RoPE, cross) and
MLA.

Twin of :mod:`repro.models.attention`, in plain torch with the twin's
arithmetic: float32 scores and softmax (or, with ``attn_scores_bf16``,
bf16 scores and a float32 softmax), the weights cast to the query dtype,
float32 accumulation of the weighted values. One code path serves train,
prefill and decode:

  * train / prefill: the full (B, S) sequence under a causal (+ window)
    mask; with a cache, the last ``cache_len`` K/V are written into the
    ring;
  * decode: x is (B, 1, d); K/V are written at ``write_pos`` (ring slot
    ``pos % cache_len``) and attention runs over the cache with validity
    masks from the per-slot position ids.

MLA (minicpm3) caches only the latent ``ckv`` and the shared rope key
``k_rope`` and expands them per head at every call.

Cross-attention (whisper) takes K and V from ``kv_x``: no rotary, no
causal mask, no cache update. Caches are dicts of tensors; an update
returns new tensors and leaves the caller's cache as it was, as the
twin's functional updates do.

With ``seq_parallel_attn`` (the twin's context-parallel lever) a
cache-free call of S > 1 scores the whole sequence in one block under the
sequence and batch constraints of :mod:`repro_torch.distributed.
partition`, where the twin shards the queries over ``model``.

:func:`gqa_forward_tp` is the rank step's attention across ``model``
ranks (Megatron tensor parallelism): ``wq`` and the K/V heads its query
heads read column-parallel, ``wo`` row-parallel with one all-reduce.
Where ``model`` does not divide the query heads (llama4-scout's 40 on
16 ranks) a rank computes every head its ``wq`` columns touch and keeps
its own columns of the output.
With a cache shard it serves prefill and decode on the partitioner's
layout of the ring; on slots split over ``model`` a decode step combines
the ranks' partial softmaxes by their log-sum-exp (decode context
parallelism).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import ieee_fp32_matmul
from repro_torch.distributed import process_group as pg
from repro_torch.distributed.partition import constrain_batch, constrain_seq
from repro_torch.models.common import (
    TransformerConfig,
    apply_mrope,
    apply_rope,
    dense_init,
    make_rope,
    rms_norm,
)

__all__ = ["init_gqa", "gqa_forward", "gqa_forward_tp", "init_gqa_cache",
           "sdpa",
           "init_mla", "mla_forward", "init_mla_cache"]

_NEG_INF = -2.0 ** 30

# Query-chunk length of the outer loop: bounds the score buffer at
# (B, H, CHUNK, T) float32 instead of (B, H, S, T).
SDPA_CHUNK = 1024


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


def _scalar(value, dtype, device) -> torch.Tensor:
    """A 0-d device tensor (filled there, no host copy), not a Python
    scalar: CUDA torch divides by a host scalar as a product with its
    reciprocal, off by a bit from the twin."""
    return torch.full((), value, dtype=dtype, device=device)


def _sdpa_block(q, k, v, mask, q_group: int, scores_bf16: bool = False):
    """q: (B,S,Hq,hd); k,v: (B,T,Hkv,hd); mask: (B,1,S,T)."""
    B, S, Hq, hd = q.shape
    g = q_group
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, g, hd)
    f32 = torch.float32
    score_t = torch.bfloat16 if scores_bf16 else f32
    with ieee_fp32_matmul():
        scores = torch.einsum("bskgd,btkd->bkgst", qg.to(f32),
                              k.to(f32)).to(score_t)
    # the twin's divisor is sqrt(hd) rounded to the score dtype
    scores = scores / _scalar(float(np.sqrt(hd)), score_t, q.device)
    scores = scores + mask[:, :, None].to(score_t)  # (B,1,1,S,T)
    w = torch.softmax(scores.to(f32), dim=-1).to(q.dtype)
    with ieee_fp32_matmul():
        out = torch.einsum("bkgst,btkd->bskgd", w.to(f32), v.to(f32))
    return out.reshape(B, S, Hq, hd).to(q.dtype)


def sdpa(q, k, v, pos_q, pos_k, *, causal, window, q_group,
         chunk: int = SDPA_CHUNK, scores_bf16: bool = False):
    """Chunked SDPA: masks are built per query chunk, and the score buffer
    is bounded by the chunk size."""
    B, S, Hq, hd = q.shape
    if S <= chunk or S % chunk != 0:
        mask = _full_mask(pos_q, pos_k, causal=causal, window=window)
        return _sdpa_block(q, k, v, mask, q_group, scores_bf16)
    outs = []
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        mask = _full_mask(pos_q[:, sl], pos_k, causal=causal, window=window)
        outs.append(_sdpa_block(q[:, sl], k, v, mask, q_group, scores_bf16))
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
    """Returns (out (B,S,d), new_cache). With ``kv_x`` (B, T, d), K and V
    come from it (cross-attention): no rotary, no causal mask, and the
    cache, if any, is returned as it was. K is never biased (the twin's
    ``init_gqa(bias=True)`` makes ``bq``, ``bv``, ``bo``)."""
    hd = cfg.resolved_head_dim
    B, S = x.shape[0], x.shape[1]
    src = kv_x if kv_x is not None else x
    q = x @ p["wq"]
    v = src @ p["wv"]
    if "bq" in p:
        q = q + p["bq"]
    if "bv" in p:
        v = v + p["bv"]
    q = _split_heads(q, cfg.n_heads, hd)
    k = _split_heads(src @ p["wk"], cfg.n_kv_heads, hd)
    v = _split_heads(v, cfg.n_kv_heads, hd)

    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"]["scale"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"]["scale"], cfg.norm_eps)

    if kv_x is None:  # self-attention: rotary on q and k
        # M-RoPE only where its position ids are given (prefill of the
        # embeddings frontend); 1-D rope otherwise, as at decode
        if cfg.mrope and mrope_positions is not None:
            q = apply_mrope(q, mrope_positions, hd, cfg.rope_theta)
            k = apply_mrope(k, mrope_positions, hd, cfg.rope_theta)
        elif not cfg.attn_bias:  # whisper uses learned abs pos, no rope
            cos, sin = make_rope(positions, hd, cfg.rope_theta)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)

    new_cache = cache
    if cache is not None and kv_x is None:
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
        if kv_positions is not None:
            pos_k = torch.as_tensor(kv_positions, device=x.device)
        elif kv_x is None:
            pos_k = positions
        else:
            T = src.shape[1]
            pos_k = torch.arange(T, dtype=torch.int32,
                                 device=x.device)[None].expand(B, T)

    if cfg.seq_parallel_attn and cache is None and S > 1:
        # context parallelism: the twin shards the queries over `model`
        # and gathers K/V; the whole sequence is one score block
        q = constrain_seq(q, 1)
        mask_src = constrain_seq(positions, 1)
        out = _sdpa_block(
            q, k_att.to(q.dtype), v_att.to(q.dtype),
            _full_mask(mask_src, pos_k, causal=causal and kv_x is None,
                       window=window), cfg.q_group, cfg.attn_scores_bf16)
        out = constrain_batch(out)  # S gathered back before wo
    else:
        out = sdpa(q, k_att.to(q.dtype), v_att.to(q.dtype), positions,
                   pos_k, causal=causal and kv_x is None, window=window,
                   q_group=cfg.q_group, scores_bf16=cfg.attn_scores_bf16)
    out = out.reshape(B, S, cfg.n_heads * hd) @ p["wo"]
    if "bo" in p:
        out = out + p["bo"]
    return out.to(x.dtype), new_cache


def _tp_heads(p, cfg: TransformerConfig, groups):
    """``(hl, lo, tp)``: the query heads ``lo .. lo + hl - 1`` this rank
    computes, and whether ``wq`` is split over ``model`` (else every
    rank computes all of them). Split, rank ``c`` holds the ``C = H hd /
    M`` columns ``c C .. (c+1) C - 1`` of ``wq``, and computes every head
    they touch: ``M`` need not divide ``H`` (llama4-scout's 40 heads on
    16 ranks: 2.5 a rank, 3 computed), and a head that straddles two
    ranks is computed on both. Raises for what the rank step does not
    split (ROADMAP item 12e-ii)."""
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    if p["wq"].shape[1] == H * hd:
        return H, 0, False
    what = ("biases" if "bq" in p else "q/k norms" if cfg.qk_norm
            else "M-RoPE" if cfg.mrope else None)
    if what:
        raise NotImplementedError(f"attention with {what} across ranks: "
                                  f"ROADMAP Queue 1 item 12e-ii")
    C, c = p["wq"].shape[1], groups.index("model")
    lo = c * C // hd
    return -(-(c + 1) * C // hd) - lo, lo, True


def _kv_slice(lo: int, hl: int, g: int) -> tuple[int, int]:
    """The K/V heads ``[kv_lo, kv_hi)`` query heads ``lo .. lo + hl - 1``
    read (``g`` query heads a K/V head)."""
    return lo // g, (lo + hl - 1) // g + 1


def _q_heads(w, x, cfg: TransformerConfig, groups, lo: int, hl: int):
    """``x @ wq`` over query heads ``lo .. lo + hl - 1``, ``(B, S, hl,
    hd)``, from ``w``, this rank's ``wq`` (whole, or its column shard).
    A shard that is not those heads' columns is completed over
    ``model``: a decode step (S == 1) gathers the ranks' products ``x @
    w``, a few rows, and a longer call ``w`` itself, whose gather's
    backward sums the ranks' gradients of a column."""
    hd = cfg.resolved_head_dim
    C, c = w.shape[1], groups.index("model")
    cols = slice(lo * hd, (lo + hl) * hd)
    if C == cfg.n_heads * hd:
        y = x @ w[:, cols]
    elif (c * C, C) == (lo * hd, hl * hd):
        y = x @ w
    elif x.shape[1] == 1:
        y = pg.gather(x @ w, x.ndim - 1, groups, "model")[..., cols]
    else:
        y = x @ pg.gather(w, 1, groups, "model")[:, cols]
    return _split_heads(y, hl, hd)


def _sdpa_heads(q, k, v, pos_q, pos_k, *, lo: int, g: int, window,
                scores_bf16: bool):
    """Causal :func:`sdpa` of query heads ``lo .. lo + hl - 1`` (``q``
    (B, S, hl, hd)) over the K/V heads they read (``k`` / ``v`` (B, T,
    KV_l, hd) from K/V head ``lo // g``; head ``h`` reads ``h // g``).
    One call where every K/V head serves as many of them (a uniform
    group), else one a K/V head: a rank's heads may read their K/V heads
    unevenly (heads 0-2 of ``g`` 2: two read head 0, one head 1)."""
    hl = q.shape[2]
    cuts = [lo] + list(range((lo // g + 1) * g, lo + hl, g)) + [lo + hl]
    runs = list(zip(cuts, cuts[1:]))
    sizes = {b - a for a, b in runs}
    kw = dict(causal=True, window=window, scores_bf16=scores_bf16)
    if len(sizes) == 1:
        return sdpa(q, k, v, pos_q, pos_k, q_group=sizes.pop(), **kw)
    return torch.cat([
        sdpa(q[:, :, a - lo:b - lo], k[:, :, j:j + 1], v[:, :, j:j + 1],
             pos_q, pos_k, q_group=b - a, **kw)
        for j, (a, b) in enumerate(runs)], dim=2)


def _own_columns(out, w, groups, lo: int, hd: int):
    """The columns of ``wq``'s shard ``w`` (this rank's ``C``, ``c C ..
    (c+1) C - 1``) of the attention output ``out`` (B, S, hl, hd) of
    query heads ``lo ..``: the rows of this rank's ``wo``. The slice's
    zero fill and the gather of ``wq`` (or of its product) over
    ``model`` sum the two ranks' shares of a straddling head's
    gradient."""
    B, S = out.shape[0], out.shape[1]
    C = w.shape[1]
    first = groups.index("model") * C - lo * hd
    return out.reshape(B, S, -1)[:, :, first:first + C]


def gqa_forward_tp(p: dict, x, *, cfg: TransformerConfig, positions,
                   window: int | None, groups, cache: dict | None = None,
                   write_pos: int | None = None, layout: str | None = None):
    """Causal self-attention across the ``model`` ranks of ``groups``:
    ``p`` holds this rank's ``model`` shards (``data`` already gathered).
    Rank ``c`` of ``M`` holds ``wq``'s columns ``c C .. (c+1) C - 1``
    (``C = H hd / M``) and ``wo``'s rows of them; it computes the query
    heads those columns touch (:func:`_tp_heads`: ``c H/M .. (c+1) H/M -
    1`` where ``M`` divides ``H``; else a straddling head on both its
    ranks, ``wq`` completed over ``model`` by :func:`_q_heads`) over the
    K/V heads they read, and its own columns of the output meet its
    ``wo`` rows: a partial output, summed by one all-reduce
    (:func:`repro_torch.distributed.process_group.reduce_out`). A K/V
    shard that is not whole heads (MQA, or fewer K/V heads than ranks) is
    gathered, and a replicated one sliced, the gradient summed over the
    ranks that read it. Unsharded weights (``attn_tp`` off, or widths the
    axis does not divide) run the whole block on every rank.

    With ``cache`` (this rank's shard of one layer's ring, ``(B, T_l, KV_l,
    hd)``) and ``write_pos`` (an int) the call is a prefill (S > 1) or a
    decode step (S == 1) on the cache ``layout`` the partitioner chose
    (:func:`repro_torch.distributed.partition.kv_layout`); see
    :func:`_gqa_cached_tp`. Returns (out, new cache shard or None)."""
    if cache is not None:
        return _gqa_cached_tp(p, x, cfg=cfg, positions=positions,
                              window=window, groups=groups, cache=cache,
                              write_pos=int(write_pos), layout=layout)
    hd = cfg.resolved_head_dim
    KV, g = cfg.n_kv_heads, cfg.q_group
    hl, lo, tp = _tp_heads(p, cfg, groups)
    if not tp:
        return gqa_forward(p, x, cfg=cfg, positions=positions, window=window)
    M = groups.size("model")
    kv_lo, kv_hi = _kv_slice(lo, hl, g)

    def kv_weight(w):
        if KV % M == 0 and w.shape[1] == (KV // M) * hd:
            return w                       # whole heads: this rank's own
        if w.shape[1] == KV * hd:          # replicated: read a slice
            w = pg.copy_in(w, groups)
        else:                              # a shard of partial heads
            w = pg.gather(w, 1, groups, "model")
        return w[:, kv_lo * hd:kv_hi * hd]

    x = pg.copy_in(x, groups)
    q = _q_heads(p["wq"], x, cfg, groups, lo, hl)
    k = _split_heads(x @ kv_weight(p["wk"]), kv_hi - kv_lo, hd)
    v = _split_heads(x @ kv_weight(p["wv"]), kv_hi - kv_lo, hd)
    cos, sin = make_rope(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    out = _sdpa_heads(q, k.to(q.dtype), v.to(q.dtype), positions, positions,
                      lo=lo, g=g, window=window,
                      scores_bf16=cfg.attn_scores_bf16)
    out = _own_columns(out, p["wq"], groups, lo, hd) @ p["wo"]
    return pg.reduce_out(out.to(x.dtype), groups), None


def _kv_heads(w, x, cfg: TransformerConfig, groups):
    """``x @ w`` over every K/V head, ``(B, S, KV, hd)``: a whole-head
    shard's outputs gathered over ``model``, a partial-head shard's
    weight gathered first, a replicated weight used as it is."""
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    M = groups.size("model")
    if w.shape[1] == KV * hd:
        y = x @ w
    elif KV % M == 0 and w.shape[1] == (KV // M) * hd:
        y = pg.gather(x @ w, x.ndim - 1, groups, "model")
    else:
        y = x @ pg.gather(w, 1, groups, "model")
    return _split_heads(y, KV, hd)


def _ring_write(cache: dict, k, v, write_pos: int, *, first: int,
                total: int) -> dict:
    """The twin's ring update on a shard holding slots ``first .. first +
    T_l - 1`` of a ring of ``total``: of the ``S`` positions ``write_pos
    ..`` of ``k`` / ``v`` (B, S, ...), the last ``min(S, total)`` go to
    slot ``position % total`` where that slot is this shard's. The slots
    are host integers (``write_pos`` is one), so the writes are slices:
    no index is read from a tensor. A new dict; ``cache`` is untouched."""
    S, Tl = k.shape[1], cache["k"].shape[1]
    n_keep = min(S, total)
    runs = []            # (src, dst, position, length) of each slice
    for i in range(S - n_keep, S):
        p = write_pos + i
        d = p % total - first
        if not 0 <= d < Tl:
            continue
        if runs and runs[-1][0] + runs[-1][3] == i and (
                runs[-1][1] + runs[-1][3] == d):
            runs[-1][3] += 1
        else:
            runs.append([i, d, p, 1])
    if not runs:
        return cache
    new = {key: cache[key].clone() for key in ("k", "v", "slot_pos")}
    for src, dst, p, n in runs:
        new["k"][:, dst:dst + n] = k[:, src:src + n]
        new["v"][:, dst:dst + n] = v[:, src:src + n]
        new["slot_pos"][dst:dst + n] = torch.arange(
            p, p + n, dtype=torch.int32, device=k.device)
    return new


def _cp_decode(q, k, v, pos_q, pos_k, *, window, q_group: int,
               scores_bf16: bool, groups):
    """One decode token's attention over a ring split by slots over
    ``model``: ``q`` (B, 1, H, hd) every query head, ``k`` / ``v`` (B,
    T_l, KV, hd) this rank's slots. Each rank scores its slots (the
    twin's float32 scores, bf16 ones with ``scores_bf16``, the divisor a
    0-d tensor); the softmax is combined over ``model`` by its log-sum-
    exp (the max, then the sum of exponentials all-reduced), the weights
    are cast to the query dtype as the twin casts the softmax, and the
    ranks' weighted values are summed. A rank with no valid slot adds
    nothing: its scores sit at ``_NEG_INF`` under the global max, whose
    exponentials are 0."""
    B, S, Hq, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, q_group, hd)
    f32 = torch.float32
    score_t = torch.bfloat16 if scores_bf16 else f32
    with ieee_fp32_matmul():
        scores = torch.einsum("bskgd,btkd->bkgst", qg.to(f32),
                              k.to(f32)).to(score_t)
    scores = scores / _scalar(float(np.sqrt(hd)), score_t, q.device)
    mask = _full_mask(pos_q, pos_k, causal=True, window=window)
    scores = (scores + mask[:, :, None].to(score_t)).to(f32)
    mx = torch.amax(scores, dim=-1, keepdim=True).contiguous()
    pg.all_reduce_(mx, groups, "model", op="max")
    e = torch.exp(scores - mx)
    den = torch.sum(e, dim=-1, keepdim=True).contiguous()
    pg.all_reduce_(den, groups, "model")
    w = (e / den).to(q.dtype)
    with ieee_fp32_matmul():
        out = torch.einsum("bkgst,btkd->bskgd", w.to(f32),
                           v.to(f32)).contiguous()
    pg.all_reduce_(out, groups, "model")
    return out.reshape(B, S, Hq, hd).to(q.dtype)


def _gqa_cached_tp(p, x, *, cfg: TransformerConfig, positions, window,
                   groups, cache: dict, write_pos: int, layout: str):
    """Prefill or decode across ``model`` ranks on a cache shard, by the
    partitioner's layout of the ring:

      * ``"heads"``: the shard holds this rank's K/V heads, the ones its
        query heads read (the layout needs ``M | KV`` and so ``M | H``),
        so the plain tensor-parallel path runs :func:`gqa_forward` with
        its cache;
      * ``"replicated"``: every rank holds every K/V head of every slot;
        it writes them all and attends with its query heads;
      * ``"seq"``: the shard holds slots ``c T/M .. (c+1) T/M - 1`` of
        every K/V head. A prefill attends with this rank's query heads
        over the in-call K/V, then writes the slots it holds of the last
        ``T`` positions (every K/V head of them: the heads the ranks
        computed gathered, or all of them computed from the gathered
        weight). A decode step writes the token into slot ``pos % T`` on
        the rank that holds it, gathers the ranks' columns of ``x @ wq``
        (every query head), scores every head over each rank's slots and
        combines them over ``model`` (:func:`_cp_decode`).

    The query heads are those :func:`_tp_heads` gives (a head ``model``
    cuts is computed on both of its ranks); this rank's columns of the
    result meet its ``wo`` rows, which stay row-parallel: the partial
    outputs are summed by one all-reduce. Unsharded weights compute every
    head on every rank, and then only a ``"seq"`` ring needs the
    exchange."""
    hd = cfg.resolved_head_dim
    H, g = cfg.n_heads, cfg.q_group
    B, S = x.shape[0], x.shape[1]
    M, c = groups.size("model"), groups.index("model")
    hl, lo, tp = _tp_heads(p, cfg, groups)
    kv_lo, kv_hi = _kv_slice(lo, hl, g)
    if layout == "heads" or (not tp and layout != "seq"):
        # K/V heads over model (KV % M == 0) are whole-head shards of wk,
        # wv and the ring alike: this rank's query heads read its own
        local = cfg if not tp else dataclasses.replace(
            cfg, n_heads=hl, n_kv_heads=kv_hi - kv_lo, head_dim=hd)
        out, new = gqa_forward(p, x, cfg=local, positions=positions,
                               window=window, cache=cache,
                               write_pos=write_pos)
        return (pg.reduce_out(out, groups) if tp else out), new
    every = S == 1 and layout == "seq"     # _cp_decode scores every head
    q_lo = 0 if every else lo              # the first head of q
    q = _q_heads(p["wq"], x, cfg, groups, q_lo, H if every else hl)
    k = _kv_heads(p["wk"], x, cfg, groups)
    v = _kv_heads(p["wv"], x, cfg, groups)
    cos, sin = make_rope(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    Tl = cache["k"].shape[1]
    first, total = (c * Tl, M * Tl) if layout == "seq" else (0, Tl)
    new = _ring_write(cache, k, v, write_pos, first=first, total=total)
    heads = dict(lo=lo, g=g, window=window, scores_bf16=cfg.attn_scores_bf16)
    if S > 1:   # prefill: this rank's heads over the in-call K/V
        out = _sdpa_heads(q, k[:, :, kv_lo:kv_hi].to(q.dtype),
                          v[:, :, kv_lo:kv_hi].to(q.dtype), positions,
                          positions, **heads)
    elif every:
        out = _cp_decode(
            q, new["k"].to(q.dtype), new["v"].to(q.dtype), positions,
            new["slot_pos"][None].expand(B, Tl), window=window, q_group=g,
            scores_bf16=cfg.attn_scores_bf16, groups=groups)
    else:       # replicated ring: this rank's heads over every slot
        out = _sdpa_heads(q, new["k"][:, :, kv_lo:kv_hi].to(q.dtype),
                          new["v"][:, :, kv_lo:kv_hi].to(q.dtype), positions,
                          new["slot_pos"][None].expand(B, Tl), **heads)
    out = (_own_columns(out, p["wq"], groups, q_lo, hd) if tp
           else out.reshape(B, S, H * hd)) @ p["wo"]
    return (pg.reduce_out(out, groups) if tp else out).to(x.dtype), new


# --------------------------------------------------------------------------
# MLA (Multi-head Latent Attention) — minicpm3 family
# --------------------------------------------------------------------------

def init_mla(key, cfg: TransformerConfig, *, device) -> dict:
    m = cfg.mla
    d = cfg.d_model
    H = cfg.n_heads
    k1, k2, k3, k4, k5 = prng.split(key, 5)
    qd = m.nope_head_dim + m.rope_head_dim
    z = lambda n: torch.zeros((n,), device=device)  # noqa: E731
    return {
        "wq_a": dense_init(k1, (d, m.q_lora_rank), device=device),
        "q_a_norm": {"scale": z(m.q_lora_rank)},
        "wq_b": dense_init(k2, (m.q_lora_rank, H * qd), device=device),
        # joint latent: compressed kv + decoupled rope key
        "wkv_a": dense_init(k3, (d, m.kv_lora_rank + m.rope_head_dim),
                            device=device),
        "kv_a_norm": {"scale": z(m.kv_lora_rank)},
        "wkv_b": dense_init(
            k4, (m.kv_lora_rank, H * (m.nope_head_dim + m.v_head_dim)),
            device=device),
        "wo": dense_init(k5, (H * m.v_head_dim, d), device=device),
    }


def init_mla_cache(cfg: TransformerConfig, batch: int, cache_len: int,
                   dtype=None, *, device) -> dict:
    m = cfg.mla
    dtype = dtype or cfg.dtype
    return {
        "ckv": torch.zeros((batch, cache_len, m.kv_lora_rank), dtype=dtype,
                           device=device),
        "k_rope": torch.zeros((batch, cache_len, m.rope_head_dim),
                              dtype=dtype, device=device),
        "slot_pos": torch.full((cache_len,), -1, dtype=torch.int32,
                               device=device),
    }


def mla_forward(
    p: dict,
    x,
    *,
    cfg: TransformerConfig,
    positions,
    cache: dict | None = None,
    write_pos: int | None = None,
    window: int | None = None,
):
    """MLA with a latent cache: only (ckv, k_rope) are cached, and every
    call writes its S tokens at ring slots ``(write_pos + s) % cache_len``
    and attends over the cache. Returns (out (B,S,d), new_cache)."""
    m = cfg.mla
    H = cfg.n_heads
    B, S = x.shape[0], x.shape[1]
    nope = m.nope_head_dim

    q = x @ p["wq_a"]
    q = rms_norm(q, p["q_a_norm"]["scale"], cfg.norm_eps)
    q = (q @ p["wq_b"]).reshape(B, S, H, nope + m.rope_head_dim)
    q_nope, q_rope = q[..., :nope], q[..., nope:]

    kv = x @ p["wkv_a"]  # (B, S, kv_lora + rope)
    ckv = rms_norm(kv[..., :m.kv_lora_rank], p["kv_a_norm"]["scale"],
                   cfg.norm_eps)
    k_rope_in = kv[..., m.kv_lora_rank:]  # (B, S, rope) one shared head

    cos, sin = make_rope(positions, m.rope_head_dim, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope_in[:, :, None, :], cos, sin)[:, :, 0]

    new_cache = cache
    if cache is not None:
        if write_pos is None:
            raise ValueError("cache updates require write_pos")
        cache_len = cache["ckv"].shape[1]
        pos = int(write_pos) + torch.arange(S, dtype=torch.int64,
                                            device=x.device)
        slots = pos % cache_len
        new_cache = {
            "ckv": _write(cache["ckv"], slots, ckv),
            "k_rope": _write(cache["k_rope"], slots, k_rope),
            "slot_pos": cache["slot_pos"].index_copy(
                0, slots, pos.to(torch.int32)),
        }
        ckv_att = new_cache["ckv"].to(x.dtype)
        kr_att = new_cache["k_rope"].to(x.dtype)
        pos_k = new_cache["slot_pos"][None].expand(B, cache_len)
    else:
        ckv_att, kr_att = ckv, k_rope
        pos_k = positions

    # expand the latent -> per-head K_nope and V
    wkv_b = p["wkv_b"].reshape(m.kv_lora_rank, H, nope + m.v_head_dim)
    k_nope = torch.einsum("btc,chd->bthd", ckv_att, wkv_b[..., :nope])
    v = torch.einsum("btc,chd->bthd", ckv_att, wkv_b[..., nope:])

    f32 = torch.float32
    scale = _scalar(float(np.float32(1.0 / np.sqrt(nope + m.rope_head_dim))),
                    f32, x.device)

    def block(qn_c, qr_c, pos_c):
        with ieee_fp32_matmul():
            scores = (torch.einsum("bshd,bthd->bhst", qn_c.to(f32),
                                   k_nope.to(f32))
                      + torch.einsum("bshd,btd->bhst", qr_c.to(f32),
                                     kr_att.to(f32))) * scale
        scores = scores + _full_mask(pos_c, pos_k, causal=True, window=window)
        w = torch.softmax(scores, dim=-1).to(x.dtype)
        with ieee_fp32_matmul():
            out = torch.einsum("bhst,bthd->bshd", w.to(f32), v.to(f32))
        return out.to(x.dtype)

    chunk = SDPA_CHUNK
    if S <= chunk or S % chunk != 0:
        out = block(q_nope, q_rope, positions)
    else:
        out = torch.cat([
            block(q_nope[:, c * chunk:(c + 1) * chunk],
                  q_rope[:, c * chunk:(c + 1) * chunk],
                  positions[:, c * chunk:(c + 1) * chunk])
            for c in range(S // chunk)], dim=1)
    out = out.reshape(B, S, H * m.v_head_dim) @ p["wo"]
    return out.to(x.dtype), new_cache
