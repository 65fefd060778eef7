"""Zamba2 hybrid: Mamba2 backbone + one SHARED attention block.

Twin of :mod:`repro.models.zamba2`. 38 Mamba2 layers; a single
weight-shared (attention + MLP) block is invoked every 6 layers (after
layers 5, 11, 17, 23, 29, 35) with a per-invocation LoRA delta on the
fused Q projection. Simplified as the twin is (no embedding-concat input
to the shared block).

Decode state: 38 Mamba (conv, ssm) states + 6 shared-attention KV caches
(one per invocation); only the attention caches grow with context.

With ``remat=True`` each Mamba scan runs under activation checkpointing
that saves nothing (the twin's ``jax.checkpoint`` of ``mamba_fwd``); the
shared block is not checkpointed, as in the twin.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import prng
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models.common import (
    TransformerConfig,
    cross_entropy_loss,
    dense_init,
    rms_norm,
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

__all__ = ["Zamba2LM"]

LORA_RANK = 64


@dataclasses.dataclass(frozen=True)
class Zamba2LM:
    cfg: TransformerConfig

    @property
    def shared_layers(self) -> tuple[int, ...]:
        k = self.cfg.shared_attn_every or 6
        return tuple(range(k - 1, self.cfg.n_layers, k))

    # ------------------------------------------------------------------
    def init(self, key, *, device="cuda") -> dict:
        """The twin's params for ``key`` on ``device`` (``"meta"`` for the
        shapes): the Mamba layers stacked on L, the one shared block, the
        LoRA pairs stacked over the invocations; every leaf cast to
        ``cfg.dtype``."""
        cfg = self.cfg
        dev = _device(device)
        cast = lambda t: t.to(cfg.dtype)  # noqa: E731
        ks = prng.split(prng.as_key(key), 5)
        d = cfg.d_model
        zeros = lambda n: torch.zeros((n,), device=dev)  # noqa: E731
        layer_keys = prng.split(ks[0], cfg.n_layers)
        lora_keys = prng.split(ks[1], len(self.shared_layers))
        hd = cfg.resolved_head_dim

        def lora(i):
            k1, _ = prng.split(lora_keys[i])
            return {"lora_a": dense_init(k1, (d, LORA_RANK), device=dev),
                    "lora_b": torch.zeros((LORA_RANK, cfg.n_heads * hd),
                                          device=dev)}

        return {
            "embed": {"table": cast(dense_init(
                ks[2], (cfg.vocab_size, d), device=dev))},
            "layers": _stack_into(
                cfg.n_layers,
                lambda i: {"pre_norm": {"scale": zeros(d)},
                           "ssm": m2.init_mamba2(layer_keys[i], cfg,
                                                 device=dev)},
                cast),
            "shared": tree_map(cast, {
                "pre_norm": {"scale": zeros(d)},
                "attn": attn.init_gqa(ks[3], cfg, device=dev),
                "pre_mlp_norm": {"scale": zeros(d)},
                "mlp": init_mlp(ks[4], cfg, device=dev),
            }),
            "lora": _stack_into(len(self.shared_layers), lora, cast),
            "final_norm": {"scale": cast(zeros(d))},
        }

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, seq_len: int, *, device="cuda") -> dict:
        """``{"mamba": (L, ...) conv / ssm states, "attn": (n_inv, ...)
        GQA caches of seq_len}`` on ``device`` (``"meta"`` for shapes)."""
        cfg = self.cfg
        dev = _device(device)
        return {
            "mamba": _expanded(m2.init_mamba2_cache(cfg, batch, device=dev),
                               (cfg.n_layers,)),
            "attn": _expanded(attn.init_gqa_cache(cfg, batch, seq_len,
                                                  device=dev),
                              (len(self.shared_layers),)),
        }

    def _shared_block(self, params, x, inv_idx, positions, cache,
                      write_pos):
        cfg = self.cfg
        lora = tree_map(lambda a: a[inv_idx], params["lora"])
        sp = params["shared"]
        # the LoRA delta on the fused Q projection for this invocation
        wq = sp["attn"]["wq"]
        wq_eff = wq + (lora["lora_a"] @ lora["lora_b"]).to(wq.dtype)
        attn_p = dict(sp["attn"], wq=wq_eff)
        h = rms_norm(x, sp["pre_norm"]["scale"], cfg.norm_eps)
        a, new_cache = attn.gqa_forward(
            attn_p, h, cfg=cfg, positions=positions, cache=cache,
            write_pos=write_pos)
        x = x + a
        h = rms_norm(x, sp["pre_mlp_norm"]["scale"], cfg.norm_eps)
        x = x + mlp_forward(sp["mlp"], h, cfg)
        return x, new_cache

    def _run(self, params, x, positions, cache, write_pos, *,
             remat: bool = False):
        """The Mamba layers in order, the shared block after each of
        ``shared_layers``: the scan (no cache), the step (one token) or
        the scan keeping its final state (prefill)."""
        cfg = self.cfg
        shared_at = set(self.shared_layers)
        new_mamba, new_attn = [], []
        inv = 0

        def mamba_fwd(lp, h):
            out, _ = m2.mamba2_scan(lp, h, cfg=cfg)
            return out

        if remat:
            mamba_fwd = _remat(mamba_fwd)
        layers = _unstacked(params["layers"], cfg.n_layers)
        for li in range(cfg.n_layers):
            lp = layers[li]
            h = rms_norm(x, lp["pre_norm"]["scale"], cfg.norm_eps)
            if cache is None:
                s_out, nc = mamba_fwd(lp["ssm"], h), None
            elif x.shape[1] == 1:
                mc = {k: v[li] for k, v in cache["mamba"].items()}
                s_out, nc = m2.mamba2_step(lp["ssm"], h, mc, cfg=cfg)
            else:
                s_out, nc = m2.mamba2_scan(lp["ssm"], h, cfg=cfg,
                                           return_cache=True)
            x = x + s_out
            new_mamba.append(nc)
            if li in shared_at:
                ac = (None if cache is None else
                      {k: v[inv] for k, v in cache["attn"].items()})
                x, nac = self._shared_block(params, x, inv, positions, ac,
                                            write_pos)
                new_attn.append(nac)
                inv += 1
        new_cache = None
        if cache is not None:
            new_cache = {"mamba": _stacked(new_mamba, cache["mamba"]),
                         "attn": _stacked(new_attn, cache["attn"])}
        return x, new_cache

    def _embed(self, params, tokens):
        table = params["embed"]["table"]
        tokens = torch.as_tensor(tokens, device=table.device)
        return table[tokens.to(torch.int64)]

    # ---------------- public API ----------------
    def forward(self, params, batch_in, *, remat: bool = False):
        """Teacher-forced logits (B, S, V) with tied embeddings, and a zero
        aux loss."""
        cfg = self.cfg
        x = self._embed(params, batch_in["tokens"])
        B, S = x.shape[0], x.shape[1]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
        x, _ = self._run(params, x, positions, None, None, remat=remat)
        x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        logits = x @ params["embed"]["table"].T  # tied
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)

    def loss(self, params, batch_in, *, remat: bool = False):
        logits, aux = self.forward(params, batch_in, remat=remat)
        targets = torch.as_tensor(batch_in["targets"], device=logits.device)
        ce, parts = cross_entropy_loss(logits, targets)
        return ce + aux, dict(parts, aux=aux)

    def prefill(self, params, batch_in, cache):
        """Populate caches; returns (last-token logits (B,1,V), cache)."""
        cfg = self.cfg
        x = self._embed(params, batch_in["tokens"])
        B, S = x.shape[0], x.shape[1]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
        x, new_cache = self._run(params, x, positions, cache, 0)
        x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        return x[:, -1:] @ params["embed"]["table"].T, new_cache

    def decode_step(self, params, token_in, pos, cache):
        """One token (B, 1) at absolute position ``pos`` (an int)."""
        cfg = self.cfg
        x = self._embed(params, token_in["tokens"])
        pos = int(pos)
        positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32,
                               device=x.device)
        x, new_cache = self._run(params, x, positions, cache, pos)
        x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        return x @ params["embed"]["table"].T, new_cache
