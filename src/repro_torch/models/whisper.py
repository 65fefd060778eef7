"""Whisper-large-v3 backbone: encoder-decoder transformer.

Twin of :mod:`repro.models.whisper`. The conv / mel frontend is a stub,
as in the twin: the caller supplies the frame embeddings (B, S_enc, d)
the conv stack would produce. The transformer backbone (32 enc + 32 dec
layers, d=1280, 20 heads, ff=5120, vocab=51866) is whole: biased
projections (no K bias), LayerNorm (not RMS), sinusoidal encoder
positions, learned decoder positions taken mod ``max_dec_len``, GELU
MLPs, tied decoder unembedding.

Serving: the cross-attention K/V are computed once at prefill and
cached; decode carries (self KV cache, cross KV cache), stacked on a
leading L axis. The twin's ``lax.scan`` over layers is a Python loop.
With ``remat=True`` each encoder and decoder layer runs under activation
checkpointing that saves nothing, as the twin's ``jax.checkpoint``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.models import attention as attn
from repro_torch.models.common import (
    TransformerConfig,
    cross_entropy_loss,
    dense_init,
    layer_norm,
)
from repro_torch.models.transformer import (
    _device,
    _expanded,
    _stack_into,
    _stacked,
    _unstacked,
    init_mlp,
    mlp_forward,
    remat as _remat,
)
from repro_torch.tree import tree_map

__all__ = ["WhisperLM"]


def _sinusoid(seq_len: int, d: int) -> np.ndarray:
    """(seq_len, d) float32: sin then cos of the positions, computed in
    float64 and rounded, as the twin computes them."""
    pos = np.arange(seq_len)[:, None]
    dim = np.arange(d // 2)[None, :]
    inv = 1.0 / (10_000 ** (dim / max(d // 2 - 1, 1)))
    ang = pos * inv
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=1).astype(
        np.float32)


def _ln(x, p, eps):
    return layer_norm(x, p["scale"], p["bias"], eps)


def _norm_init(d, device):
    return {"scale": torch.ones((d,), device=device),
            "bias": torch.zeros((d,), device=device)}


@dataclasses.dataclass(frozen=True)
class WhisperLM:
    cfg: TransformerConfig
    max_dec_len: int = 1 << 15

    # ------------------------------------------------------------------
    def init(self, key, *, device="cuda") -> dict:
        """The twin's params for ``key`` on ``device`` (``"meta"`` for the
        shapes): encoder and decoder layers stacked on L; every leaf cast
        to ``cfg.dtype``."""
        cfg = self.cfg
        dev = _device(device)
        cast = lambda t: t.to(cfg.dtype)  # noqa: E731
        ks = prng.split(prng.as_key(key), 6)
        enc_keys = prng.split(ks[0], cfg.n_layers)
        dec_keys = prng.split(ks[1], cfg.n_layers)
        d = cfg.d_model
        return {
            "embed": {"table": cast(dense_init(
                ks[2], (cfg.vocab_size, d), device=dev))},
            "pos_embed": {"table": cast(dense_init(
                ks[3], (self.max_dec_len, d), device=dev) * 0.01)},
            "enc_layers": _stack_into(
                cfg.n_layers, lambda i: self._enc_layer_init(enc_keys[i],
                                                             dev), cast),
            "dec_layers": _stack_into(
                cfg.n_layers, lambda i: self._dec_layer_init(dec_keys[i],
                                                             dev), cast),
            "enc_final_norm": tree_map(cast, _norm_init(d, dev)),
            "final_norm": tree_map(cast, _norm_init(d, dev)),
        }

    def _enc_layer_init(self, key, device) -> dict:
        cfg = self.cfg
        k1, k2 = prng.split(key)
        return {
            "pre_norm": _norm_init(cfg.d_model, device),
            "attn": attn.init_gqa(k1, cfg, bias=True, device=device),
            "pre_mlp_norm": _norm_init(cfg.d_model, device),
            "mlp": init_mlp(k2, cfg, bias=True, device=device),
        }

    def _dec_layer_init(self, key, device) -> dict:
        cfg = self.cfg
        k1, k2, k3 = prng.split(key, 3)
        return {
            "pre_norm": _norm_init(cfg.d_model, device),
            "attn": attn.init_gqa(k1, cfg, bias=True, device=device),
            "pre_xattn_norm": _norm_init(cfg.d_model, device),
            "xattn": attn.init_gqa(k2, cfg, bias=True, device=device),
            "pre_mlp_norm": _norm_init(cfg.d_model, device),
            "mlp": init_mlp(k3, cfg, bias=True, device=device),
        }

    # ------------------------------------------------------------------
    @staticmethod
    def _positions(B, S, device):
        return torch.arange(S, dtype=torch.int32, device=device)[None].expand(
            B, S)

    def encode(self, params, enc_embeds, *, remat: bool = False):
        """enc_embeds: (B, S_enc, d) stub-frontend output -> memory."""
        cfg = self.cfg
        dev = params["embed"]["table"].device
        enc_embeds = torch.as_tensor(enc_embeds, device=dev)
        B, S, d = enc_embeds.shape
        x = enc_embeds.to(cfg.dtype) + torch.from_numpy(
            _sinusoid(S, d)).to(dev)[None].to(cfg.dtype)
        positions = self._positions(B, S, dev)

        def body(x, lp):
            h = _ln(x, lp["pre_norm"], cfg.norm_eps)
            a, _ = attn.gqa_forward(lp["attn"], h, cfg=cfg,
                                    positions=positions, causal=False)
            x = x + a
            h = _ln(x, lp["pre_mlp_norm"], cfg.norm_eps)
            return x + mlp_forward(lp["mlp"], h, cfg)

        if remat:
            body = _remat(body)
        for lp in _unstacked(params["enc_layers"], cfg.n_layers):
            x = body(x, lp)
        return _ln(x, params["enc_final_norm"], cfg.norm_eps)

    def _dec_embed(self, params, tokens, pos0: int):
        table = params["embed"]["table"]
        tokens = torch.as_tensor(tokens, device=table.device)
        S = tokens.shape[1]
        x = table[tokens.to(torch.int64)]
        pos_ids = (int(pos0) + torch.arange(S, device=table.device)
                   ) % self.max_dec_len
        return x + params["pos_embed"]["table"][pos_ids][None]

    def _decoder(self, params, x, positions, memory, cache, write_pos,
                 *, remat: bool = False):
        """The decoder layers: self-attention (on the cache, if given),
        cross-attention on ``memory`` or, without it, on the cached cross
        K/V, the MLP. Returns (tied logits, new cache or None)."""
        cfg = self.cfg
        layers = _unstacked(params["dec_layers"], cfg.n_layers)
        new_self = []
        if remat and cache is None:
            body = _remat(lambda x, lp, memory: self._dec_layer(
                x, lp, positions, memory, None, None, None)[0])
            for lp in layers:
                x = body(x, lp, memory)
        else:
            for i, lp in enumerate(layers):
                self_cache = cross = None
                if cache is not None:
                    self_cache = {k: v[i] for k, v in cache["self"].items()}
                    cross = {k: v[i] for k, v in cache["cross"].items()}
                x, ns = self._dec_layer(x, lp, positions, memory,
                                        self_cache, cross, write_pos)
                new_self.append(ns)
        x = _ln(x, params["final_norm"], cfg.norm_eps)
        logits = x @ params["embed"]["table"].T  # tied
        new_cache = None
        if cache is not None:
            new_cache = {"self": _stacked(new_self, cache["self"]),
                         "cross": cache["cross"]}
        return logits, new_cache

    def _dec_layer(self, x, lp, positions, memory, self_cache, cross,
                   write_pos):
        """One decoder layer: (x, new self cache)."""
        cfg = self.cfg
        h = _ln(x, lp["pre_norm"], cfg.norm_eps)
        a, ns = attn.gqa_forward(lp["attn"], h, cfg=cfg, positions=positions,
                                 cache=self_cache, write_pos=write_pos)
        x = x + a
        h = _ln(x, lp["pre_xattn_norm"], cfg.norm_eps)
        if memory is not None:
            xa, _ = attn.gqa_forward(lp["xattn"], h, cfg=cfg,
                                     positions=positions, kv_x=memory)
        else:  # decode: reuse the cached cross K/V
            xa = self._xattn_cached(lp["xattn"], h, positions, cross)
        x = x + xa
        h = _ln(x, lp["pre_mlp_norm"], cfg.norm_eps)
        return x + mlp_forward(lp["mlp"], h, cfg), ns

    def _xattn_cached(self, p, x, positions, cross):
        """Cross-attention against precomputed (k, v)."""
        cfg = self.cfg
        hd = cfg.resolved_head_dim
        B, S = x.shape[0], x.shape[1]
        q = x @ p["wq"]
        if "bq" in p:
            q = q + p["bq"]
        q = q.reshape(B, S, cfg.n_heads, hd)
        T = cross["k"].shape[1]
        pos_k = self._positions(B, T, x.device)
        out = attn.sdpa(q, cross["k"].to(q.dtype), cross["v"].to(q.dtype),
                        positions, pos_k, causal=False, window=None,
                        q_group=cfg.q_group)
        out = out.reshape(B, S, cfg.n_heads * hd) @ p["wo"]
        if "bo" in p:
            out = out + p["bo"]
        return out

    # ---------------- public API ----------------
    def forward(self, params, batch_in, *, remat: bool = False):
        """Training forward: {'enc_embeds', 'tokens'} -> (logits, aux)."""
        memory = self.encode(params, batch_in["enc_embeds"], remat=remat)
        x = self._dec_embed(params, batch_in["tokens"], 0)
        B, S = x.shape[0], x.shape[1]
        logits, _ = self._decoder(params, x, self._positions(B, S, x.device),
                                  memory, None, None, remat=remat)
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)

    def loss(self, params, batch_in, *, remat: bool = False):
        logits, aux = self.forward(params, batch_in, remat=remat)
        targets = torch.as_tensor(batch_in["targets"], device=logits.device)
        ce, parts = cross_entropy_loss(logits, targets)
        return ce + aux, dict(parts, aux=aux)

    def init_cache(self, batch: int, self_len: int, cross_len: int, *,
                   device="cuda") -> dict:
        """``{"self": GQA caches of self_len, "cross": {"k", "v"} of
        cross_len}``, each stacked on L, on ``device`` (``"meta"`` for
        shapes)."""
        cfg = self.cfg
        dev = _device(device)
        L = cfg.n_layers
        hd = cfg.resolved_head_dim
        self_c = attn.init_gqa_cache(cfg, batch, self_len, device=dev)
        shape = (L, batch, cross_len, cfg.n_kv_heads, hd)
        return {
            "self": _expanded(self_c, (L,)),
            "cross": {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                      "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)},
        }

    def prefill(self, params, batch_in, cache):
        """Encode the audio frames, compute each layer's cross K/V once
        (they replace the cache's ``cross``), and prefill the decoder
        prompt into the self caches. Returns (last-token logits, cache)."""
        cfg = self.cfg
        memory = self.encode(params, batch_in["enc_embeds"])
        hd = cfg.resolved_head_dim
        B, T = memory.shape[0], memory.shape[1]
        ks, vs = [], []
        for i in range(cfg.n_layers):
            xp = tree_map(lambda a: a[i], params["dec_layers"]["xattn"])
            ks.append((memory @ xp["wk"]).reshape(B, T, cfg.n_kv_heads, hd))
            v = memory @ xp["wv"]
            if "bv" in xp:
                v = v + xp["bv"]
            vs.append(v.reshape(B, T, cfg.n_kv_heads, hd))
        cache = {"self": cache["self"],
                 "cross": {"k": torch.stack(ks), "v": torch.stack(vs)}}
        x = self._dec_embed(params, batch_in["tokens"], 0)
        S = x.shape[1]
        logits, new_cache = self._decoder(
            params, x, self._positions(B, S, x.device), None, cache, 0)
        return logits[:, -1:], new_cache

    def decode_step(self, params, token_in, pos, cache):
        """One token (B, 1) at absolute position ``pos`` (an int)."""
        pos = int(pos)
        x = self._dec_embed(params, token_in["tokens"], pos)
        positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                               device=x.device)
        return self._decoder(params, x, positions, None, cache, pos)
