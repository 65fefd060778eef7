"""Decoder-only LM stack: the dense attention family.

Twin of :mod:`repro.models.transformer` for ``block_kind="attn"`` with a
dense MLP (granite-3 GQA, granite-20b MQA). The twin scans one layer body
over stacked params (leading L axis, as ``vmap`` stacks them); here the
same stacked params are walked by a Python loop over L. Three entry
points share the layer body:

  * ``forward``      — teacher-forced logits (train / eval)
  * ``prefill``      — forward + populate the KV caches, last-token logits
  * ``decode_step``  — one token against the stacked caches

MoE, MLA, mamba2, rwkv6, the split cache, the embeddings frontend and
rematerialisation are not ported yet: ``DecoderLM`` raises for them and
names the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.common import (
    TransformerConfig,
    cross_entropy_loss,
    dense_init,
    rms_norm,
)
from repro_torch.tree import tree_map

__all__ = ["DecoderLM", "init_mlp", "mlp_forward"]

_BLOCKS = "12a (other block families)"


def _not_ported(what: str, item: str = _BLOCKS):
    attn._not_ported(what, item)


def _device(device) -> torch.device:
    """``"meta"`` (shapes only) or a device :func:`resolve_device` takes."""
    if str(device) == "meta":
        return torch.device("meta")
    return resolve_device(device)


# --------------------------------------------------------------------------
def init_mlp(key, cfg: TransformerConfig, *, bias: bool = False,
             device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    k1, k2, k3 = prng.split(key, 3)
    if cfg.mlp_kind in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(k1, (d, f), device=device),
            "w_up": dense_init(k2, (d, f), device=device),
            "w_down": dense_init(k3, (f, d), device=device),
        }
    p = {"w_up": dense_init(k1, (d, f), device=device),
         "w_down": dense_init(k2, (f, d), device=device)}
    if bias:
        p["b_up"] = torch.zeros((f,), device=device)
        p["b_down"] = torch.zeros((d,), device=device)
    return p


# The twin's activations as XLA lowers them, op for op in the input dtype
# (each op rounded to it, the constants too): in bfloat16 this gives the
# twin's bytes where F.silu / F.gelu, which round once, differ in ~40 %.

def _const(x, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=x.dtype, device=x.device)


def silu(x):
    """``jax.nn.silu``: ``x * (1 / (1 + exp(-x)))``."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x):
    """``jax.nn.gelu`` (its default tanh approximation): ``x * (0.5 * (1 +
    tanh(sqrt(2 / pi) * (x + 0.044715 * x^3))))``."""
    inner = _const(x, np.sqrt(2 / np.pi)) * (
        x + _const(x, 0.044715) * (x * x * x))
    return x * (0.5 * (1 + torch.tanh(inner)))


def mlp_forward(p: dict, x, cfg: TransformerConfig):
    if cfg.mlp_kind in ("swiglu", "geglu"):
        act = silu if cfg.mlp_kind == "swiglu" else gelu
        h = act(x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
        return h @ p["w_down"].to(x.dtype)
    h = x @ p["w_up"].to(x.dtype)
    if "b_up" in p:
        h = h + p["b_up"]
    h = gelu(h) @ p["w_down"].to(x.dtype)
    if "b_down" in p:
        h = h + p["b_down"]
    return h


# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DecoderLM:
    cfg: TransformerConfig

    def __post_init__(self):
        cfg = self.cfg
        if cfg.block_kind != "attn":
            _not_ported(f"block_kind={cfg.block_kind!r}")
        for field, what in (("moe", "MoE blocks"), ("mla", "MLA attention"),
                            ("mrope", "M-RoPE")):
            if getattr(cfg, field):
                _not_ported(what)
        if cfg.frontend != "tokens":
            _not_ported("the embeddings frontend")
        if cfg.split_cache:
            _not_ported("split_cache")
        if cfg.attn_scores_bf16:
            _not_ported("attn_scores_bf16")
        if cfg.seq_parallel_attn:
            _not_ported("seq_parallel_attn", "12c (the LM partitioner)")

    # ---------------- parameters ----------------
    def init(self, key, *, device="cuda") -> dict:
        """The twin's params for ``key`` on ``device`` (``"meta"`` gives the
        shapes and dtypes without drawing): ``split(key, 3)`` into embed,
        layers and unembed; one key per layer; layers stacked on a leading
        L axis; every leaf cast to ``cfg.dtype`` at the end."""
        cfg = self.cfg
        dev = _device(device)
        k_embed, k_layers, k_out = prng.split(prng.as_key(key), 3)
        cast = lambda t: t.to(cfg.dtype)  # noqa: E731
        params: dict = {
            "embed": {"table": cast(dense_init(
                k_embed, (cfg.padded_vocab, cfg.d_model), device=dev))},
            "final_norm": {"scale": cast(torch.zeros((cfg.d_model,),
                                                     device=dev))},
        }
        # each layer drawn on its own key, written into the stacked leaves
        stacked = None
        for i, k in enumerate(prng.split(k_layers, cfg.n_layers)):
            layer = tree_map(cast, self._layer_init(k, dev))
            if stacked is None:
                stacked = tree_map(lambda t: t.new_empty(
                    (cfg.n_layers,) + tuple(t.shape)), layer)
            tree_map(lambda s, t: s[i].copy_(t), stacked, layer)
        params["layers"] = stacked
        if not cfg.tie_embeddings:
            params["unembed"] = {"table": cast(dense_init(
                k_out, (cfg.d_model, cfg.padded_vocab), device=dev))}
        return params

    def _layer_init(self, key, device) -> dict:
        cfg = self.cfg
        k_attn, k_mlp = prng.split(key)
        zeros = lambda: torch.zeros((cfg.d_model,), device=device)  # noqa
        return {"pre_norm": {"scale": zeros()},
                "pre_mlp_norm": {"scale": zeros()},
                "attn": attn.init_gqa(k_attn, cfg, bias=cfg.attn_bias,
                                      device=device),
                "mlp": init_mlp(k_mlp, cfg, device=device)}

    # ---------------- layer schedule ----------------
    def layer_windows(self) -> np.ndarray:
        """(L,) int32 attention window per layer; 0 = full attention."""
        cfg = self.cfg
        w = np.zeros(cfg.n_layers, np.int32)
        if cfg.sliding_window:
            w[:] = cfg.sliding_window
            if cfg.global_every:
                w[cfg.global_every - 1::cfg.global_every] = 0
        return w

    def cache_len(self, seq_len: int) -> int:
        """Uniform per-layer cache length. Ring-buffer caches shrink to the
        window when every layer is windowed."""
        cfg = self.cfg
        w = self.layer_windows()
        if cfg.sliding_window and (w > 0).all():
            return min(seq_len, int(w.max()))
        return seq_len

    # ---------------- caches ----------------
    def init_cache(self, batch: int, seq_len: int, *, device="cuda") -> dict:
        """Stacked per-layer ring caches: ``k``, ``v`` (L, B, T, Hkv, hd)
        and ``slot_pos`` (L, T), on ``device`` (``"meta"`` for shapes)."""
        dev = _device(device)
        one = attn.init_gqa_cache(self.cfg, batch, self.cache_len(seq_len),
                                  device=dev)
        L = self.cfg.n_layers
        return {k: v[None].expand((L,) + tuple(v.shape)).clone()
                for k, v in one.items()}

    # ---------------- core ----------------
    def _embed(self, params, batch_in):
        cfg = self.cfg
        table = params["embed"]["table"]
        tokens = torch.as_tensor(batch_in["tokens"], device=table.device)
        x = table[tokens.to(torch.int64)]
        if cfg.embed_scale:
            x = x * torch.full((), np.sqrt(cfg.d_model), dtype=cfg.dtype,
                               device=x.device)
        return x

    def _layer_body(self, x, layer_p, window, cache, write_pos, positions):
        """One block; cache may be None. Returns (x, new_cache)."""
        cfg = self.cfg
        h = rms_norm(x, layer_p["pre_norm"]["scale"], cfg.norm_eps)
        a_out, new_cache = attn.gqa_forward(
            layer_p["attn"], h, cfg=cfg, positions=positions, window=window,
            cache=cache, write_pos=write_pos)
        x = x + a_out
        h = rms_norm(x, layer_p["pre_mlp_norm"]["scale"], cfg.norm_eps)
        x = x + mlp_forward(layer_p["mlp"], h, cfg)
        return x, new_cache

    def _run_stack(self, params, x, positions, cache, write_pos, *,
                   remat: bool = False):
        """The twin's ``lax.scan`` over layers as a loop over L."""
        if remat:
            _not_ported("remat (activation checkpointing)",
                        "12b (LM training)")
        windows = self.layer_windows()
        new = []
        for i in range(self.cfg.n_layers):
            layer_p = tree_map(lambda p: p[i], params["layers"])
            layer_cache = (None if cache is None
                           else {k: v[i] for k, v in cache.items()})
            x, c = self._layer_body(x, layer_p, int(windows[i]), layer_cache,
                                    write_pos, positions)
            new.append(c)
        new_cache = (None if cache is None else
                     {k: torch.stack([c[k] for c in new]) for k in cache})
        return x, new_cache, torch.zeros((), dtype=torch.float32,
                                         device=x.device)

    def _positions(self, batch_in, B, S, device):
        positions = batch_in.get("positions")
        if positions is None:
            return torch.arange(S, dtype=torch.int32,
                                device=device)[None].expand(B, S)
        return torch.as_tensor(positions, device=device)

    # ---------------- public entry points ----------------
    def forward(self, params, batch_in, *, remat: bool = False):
        """Teacher-forced logits. batch_in: {'tokens' (B,S), optional
        'positions'}. Returns (logits (B,S,V), aux)."""
        cfg = self.cfg
        x = self._embed(params, batch_in)
        B, S = x.shape[0], x.shape[1]
        positions = self._positions(batch_in, B, S, x.device)
        x, _, aux = self._run_stack(params, x, positions, None, None,
                                    remat=remat)
        x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        return self._unembed(params, x), aux

    def _unembed(self, params, x):
        cfg = self.cfg
        if cfg.tie_embeddings:
            logits = x @ params["embed"]["table"].T
        else:
            logits = x @ params["unembed"]["table"]
        if cfg.padded_vocab != cfg.vocab_size:
            # mask pad columns: softmax / argmax never select them
            pad = torch.arange(logits.shape[-1],
                               device=logits.device) >= cfg.vocab_size
            logits = torch.where(pad, torch.full(
                (), -2.0 ** 20, dtype=logits.dtype, device=logits.device),
                logits)
        return logits

    def loss(self, params, batch_in, *, remat: bool = False):
        logits, aux = self.forward(params, batch_in, remat=remat)
        targets = torch.as_tensor(batch_in["targets"], device=logits.device)
        ce, parts = cross_entropy_loss(logits, targets)
        return ce + aux, dict(parts, aux=aux)

    def prefill(self, params, batch_in, cache):
        """Populate caches; returns (last-token logits (B,1,V), cache)."""
        cfg = self.cfg
        x = self._embed(params, batch_in)
        B, S = x.shape[0], x.shape[1]
        positions = self._positions(batch_in, B, S, x.device)
        x, new_cache, _ = self._run_stack(params, x, positions, cache, 0)
        x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        return self._unembed(params, x[:, -1:]), new_cache

    def decode_step(self, params, token_in, pos, cache):
        """One decode step. token_in: {'tokens' (B,1)}; pos: the absolute
        position (an int). Returns (logits (B,1,V), new_cache)."""
        cfg = self.cfg
        x = self._embed(params, token_in)
        B = x.shape[0]
        pos = int(pos)
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=x.device)
        x, new_cache, _ = self._run_stack(params, x, positions, cache, pos)
        x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        return self._unembed(params, x), new_cache
