"""Decoder-only LM stack parameterized over the families.

Twin of :mod:`repro.models.transformer`: GQA / MQA (granite-3,
granite-20b), MoE with sliding-window rings (mixtral) or a shared expert
(llama4-scout), 5:1 local:global windows with q/k norm, geglu, scaled
tied embeddings and split caches (gemma3), MLA (minicpm3), M-RoPE with
the embeddings frontend (qwen2-vl), RWKV6 (rwkv6-7b, attention-free) and
the Mamba2 backbone (the zamba2 hybrid wrapper lives in ``zamba2.py``,
whisper's encoder-decoder in ``whisper.py``). The twin scans one layer
body over stacked params (leading L axis, as ``vmap`` stacks them); here
the same stacked params are walked by a Python loop over L (and over the
[local x (g-1), global] groups of the split cache). Three entry points
share the layer body:

  * ``forward``      — teacher-forced logits (train / eval)
  * ``prefill``      — forward + populate the caches, last-token logits
  * ``decode_step``  — one token against the stacked caches

With ``remat=True`` each layer body runs under
``torch.utils.checkpoint`` (:func:`remat`), as the twin wraps it in
``jax.checkpoint`` with ``cfg.remat_policy``: ``"nothing"`` recomputes
the whole body in the backward pass, ``"dots"`` keeps the outputs of the
matrix products (a selective-checkpoint policy), ``"attn_out"`` keeps the
attention output (the body split at it, each half checkpointed). With
``moe_ep`` the MoE layers run :func:`repro_torch.models.moe.
moe_forward_ep` over the ambient mesh.

In the rank step (one process a device; :func:`repro_torch.distributed.
partition.current_rank_plan` is set) ``loss`` takes this rank's shards
of the params: each layer gathers its ``embed -> data`` shards over
``data`` just before use (again in the remat recompute, and frees them
after), its gradient is reduce-scattered back to the shard by the
gather's backward, attention and the MLP run Megatron tensor
parallelism over ``model``, the embedding lookup and the cross entropy
are vocab-parallel, and the loss returned is this rank's part of the
microbatch's (:meth:`DecoderLM._loss_rank`). ``prefill`` and
``decode_step`` take this rank's rows and cache shards there: each
layer's attention runs on the partitioner's layout of its ring
(:func:`repro_torch.models.attention.gqa_forward_tp`), a decode step's
MoE routes each rank's rows alone (dropless), and the logits are the
rank's vocab slice, which :meth:`DecoderLM.gather_logits` and
:meth:`DecoderLM.greedy_rank` turn into the whole vocab's logits or the
greedy token.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch.utils import checkpoint as _ckpt

from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.distributed import partition as part
from repro_torch.distributed import process_group as pg
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rk
from repro_torch.models.common import (
    TransformerConfig,
    cross_entropy_loss,
    dense_init,
    gelu,
    rms_norm,
    silu,
)
from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["DecoderLM", "init_mlp", "mlp_forward", "mlp_forward_tp",
           "remat"]

# the products "dots" keeps (``jax.checkpoint_policies.dots_saveable``
# keeps every dot_general); matmul and einsum lower to these
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default]


def remat(fn, policy: str = "nothing"):
    """``fn`` under activation checkpointing, the twin's ``jax.checkpoint``:
    ``"nothing"`` saves only the inputs and recomputes the rest in the
    backward pass; ``"dots"`` also keeps the outputs of the matrix
    products. (``"attn_out"`` needs a named tensor inside a body: the
    blocks split their body at it and checkpoint each half under
    ``"nothing"``.)"""
    if policy == "dots":
        ctx = functools.partial(_ckpt.create_selective_checkpoint_contexts,
                                _DOTS)
        return lambda *a: _ckpt.checkpoint(fn, *a, use_reentrant=False,
                                           context_fn=ctx)
    if policy != "nothing":
        raise ValueError(f"unknown remat policy {policy!r}")
    return lambda *a: _ckpt.checkpoint(fn, *a, use_reentrant=False)


def _unstacked(tree, n: int) -> list:
    """The ``n`` per-layer trees of a tree stacked on a leading axis, as
    views. One ``unbind`` a leaf, so a gradient reaches each stacked leaf
    as one stack of the layers' gradients, not ``n`` full-size adds."""
    parts = [t.unbind(0) for t in leaves(tree)]
    return [unflatten(tree, [p[i] for p in parts]) for i in range(n)]


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


def mlp_forward_tp(p: dict, x, cfg: TransformerConfig, groups):
    """The MLP across ``model`` ranks: ``w_gate`` / ``w_up`` column- and
    ``w_down`` row-parallel (this rank's ``d_ff`` slice), the partial
    outputs summed by one all-reduce; a ``d_ff`` the axis does not
    divide runs whole on every rank."""
    if p["w_down"].shape[0] == cfg.d_ff:
        return mlp_forward(p, x, cfg)
    if "b_down" in p:
        raise NotImplementedError("a biased MLP across ranks (whisper) is "
                                  "ROADMAP Queue 1 item 12e-ii")
    return pg.reduce_out(mlp_forward(p, pg.copy_in(x, groups), cfg),
                         groups)


def _stack_into(n: int, make, cast) -> dict:
    """``n`` trees ``make(i)`` (a layer each, drawn on its own key), cast
    and written into leaves stacked on a new leading axis, one tree alive
    at a time."""
    stacked = None
    for i in range(n):
        tree = tree_map(cast, make(i))
        if stacked is None:
            stacked = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)),
                               tree)
        tree_map(lambda s, t: s[i].copy_(t), stacked, tree)
        del tree
    return stacked


def _cutter(shard):
    """``cut(key, tree)``: ``tree`` (``params[key]``, or one layer of the
    stacked ``params["layers"]``) cut to a rank's shards by ``shard =
    (shardings, rank)``; the tree itself without ``shard``."""
    if shard is None:
        return lambda key, tree: tree
    shardings, rank = shard

    def cut(key, tree):
        sh = shardings[key]
        if key == "layers":
            sh = part.layer_shardings(sh)
        return tree_map(lambda x, s: part.local_shard(x, s, rank).clone(),
                        tree, sh)

    return cut


def _expanded(cache: dict, lead: tuple) -> dict:
    """A fresh cache: each leaf of ``cache`` repeated over ``lead``."""
    return {k: v.expand(lead + tuple(v.shape)).clone()
            for k, v in cache.items()}


def _stacked(caches: list, like: dict) -> dict:
    """Per-layer caches stacked on a new leading axis, keyed as ``like``
    (``like`` itself when there are none)."""
    if not caches:
        return like
    return {k: torch.stack([c[k] for c in caches]) for k in like}


# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DecoderLM:
    cfg: TransformerConfig

    def __post_init__(self):
        cfg = self.cfg
        if cfg.block_kind not in ("attn", "mamba2", "rwkv6"):
            raise ValueError(cfg.block_kind)

    # ---------------- parameters ----------------
    def init(self, key, *, device="cuda", shard=None) -> dict:
        """The twin's params for ``key`` on ``device`` (``"meta"`` gives the
        shapes and dtypes without drawing): ``split(key, 3)`` into embed,
        layers and unembed; one key per layer; layers stacked on a leading
        L axis; every leaf cast to ``cfg.dtype`` at the end.

        With ``shard = (shardings, rank)`` (the params' tree of
        :class:`repro_torch.distributed.partition.Sharding` and a rank of
        its mesh) each leaf is cut to that rank's shard as it is drawn,
        the stacked ones layer by layer: the rank holds its shards and at
        most one full layer (or the embedding table) at a time."""
        cfg = self.cfg
        dev = _device(device)
        k_embed, k_layers, k_out = prng.split(prng.as_key(key), 3)
        cast = lambda t: t.to(cfg.dtype)  # noqa: E731
        cut = _cutter(shard)
        params: dict = {
            "embed": cut("embed", {"table": cast(dense_init(
                k_embed, (cfg.padded_vocab, cfg.d_model), device=dev))}),
            "final_norm": cut("final_norm", {"scale": cast(torch.zeros(
                (cfg.d_model,), device=dev))}),
        }
        layer_keys = prng.split(k_layers, cfg.n_layers)
        params["layers"] = _stack_into(
            cfg.n_layers, lambda i: cut("layers", self._layer_init(
                layer_keys[i], dev)), cast)
        if not cfg.tie_embeddings:
            params["unembed"] = cut("unembed", {"table": cast(dense_init(
                k_out, (cfg.d_model, cfg.padded_vocab), device=dev))})
        return params

    def _layer_init(self, key, device) -> dict:
        cfg = self.cfg
        k_attn, k_mlp = prng.split(key)
        zeros = lambda: torch.zeros((cfg.d_model,), device=device)  # noqa
        layer: dict = {"pre_norm": {"scale": zeros()},
                       "pre_mlp_norm": {"scale": zeros()}}
        if cfg.block_kind == "mamba2":
            layer["ssm"] = m2.init_mamba2(k_attn, cfg, device=device)
            del layer["pre_mlp_norm"]  # mamba2 block has no separate MLP
            return layer
        if cfg.block_kind == "rwkv6":
            layer["rwkv"] = rk.init_rwkv6(k_attn, cfg, device=device)
            layer["ffn"] = rk.init_rwkv6_ffn(k_mlp, cfg, device=device)
            return layer
        if cfg.mla is not None:
            layer["attn"] = attn.init_mla(k_attn, cfg, device=device)
        else:
            layer["attn"] = attn.init_gqa(k_attn, cfg, bias=cfg.attn_bias,
                                          device=device)
        if cfg.moe:
            layer["moe"] = moe_mod.init_moe(k_mlp, cfg, device=device)
        else:
            layer["mlp"] = init_mlp(k_mlp, cfg, device=device)
        return layer

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
    def _split_geometry(self) -> tuple[int, int]:
        """(n_groups, locals_per_group) for the split-cache layout."""
        cfg = self.cfg
        g = cfg.global_every
        if not (cfg.split_cache and cfg.sliding_window and g):
            raise ValueError("split_cache needs sliding_window and "
                             "global_every")
        if cfg.n_layers % g != 0:
            raise ValueError("split_cache needs a regular pattern")
        per = self.layer_windows().reshape(-1, g)
        if not ((per[:, :-1] > 0).all() and (per[:, -1] == 0).all()):
            raise ValueError(
                "split_cache expects [local x (g-1), global] groups")
        return cfg.n_layers // g, g - 1

    def init_cache(self, batch: int, seq_len: int, *, device="cuda") -> dict:
        """Stacked per-layer caches on ``device`` (``"meta"`` for shapes):
        GQA rings ``k``, ``v`` (L, B, T, Hkv, hd) or MLA latents ``ckv``
        (L, B, T, kv_lora), ``k_rope`` (L, B, T, rope), with ``slot_pos``
        (L, T). With ``split_cache``: ``{"local": (G, g-1, ...) rings of
        the window, "global": (G, ...) full caches}``. Mamba2: ``conv``
        (L, B, d_conv-1, conv_dim), float32 ``ssm`` (L, B, nh, hd, ds);
        RWKV6: float32 ``state`` (L, B, nh, hd, hd), ``x_att``, ``x_ffn``
        (L, B, d); neither grows with ``seq_len``."""
        cfg = self.cfg
        dev = _device(device)

        def one(clen: int, lead: tuple) -> dict:
            if cfg.block_kind == "mamba2":
                c = m2.init_mamba2_cache(cfg, batch, device=dev)
            elif cfg.block_kind == "rwkv6":
                c = rk.init_rwkv6_cache(cfg, batch, device=dev)
            elif cfg.mla is not None:
                c = attn.init_mla_cache(cfg, batch, clen, device=dev)
            else:
                c = attn.init_gqa_cache(cfg, batch, clen, device=dev)
            return _expanded(c, lead)

        if (cfg.split_cache and cfg.block_kind == "attn"
                and cfg.sliding_window and cfg.global_every):
            G, nloc = self._split_geometry()
            w = int(cfg.sliding_window)
            return {"local": one(min(seq_len, w), (G, nloc)),
                    "global": one(seq_len, (G,))}
        return one(self.cache_len(seq_len), (cfg.n_layers,))

    # ---------------- core ----------------
    def _embed(self, params, batch_in):
        cfg = self.cfg
        plan = part.current_rank_plan()
        if plan is not None:
            return self._embed_rank(params, batch_in, plan)
        table = params["embed"]["table"]
        if cfg.frontend == "embeddings" and "embeds" in batch_in:
            # the stub modality frontend supplies merged patch / frame
            # embeddings at prefill; decode falls through to the table
            x = torch.as_tensor(batch_in["embeds"],
                                device=table.device).to(cfg.dtype)
        else:
            tokens = torch.as_tensor(batch_in["tokens"], device=table.device)
            x = table[tokens.to(torch.int64)]
        if cfg.embed_scale:
            x = x * torch.full((), np.sqrt(cfg.d_model), dtype=cfg.dtype,
                               device=x.device)
        return x

    def _layer_body(self, x, layer_p, window, cache, write_pos, positions,
                    mrope_positions=None, mesh=None, plan=None):
        """One block; cache may be None. Returns (x, new_cache, aux).
        ``mesh`` is the one ``moe_ep`` routes over and ``plan`` the rank
        step's (both read by the caller, so a recompute in the backward
        pass, which may run on autograd's own thread, sees the
        forward's)."""
        cfg = self.cfg
        if cfg.block_kind == "mamba2":
            return self._mamba2_body(x, layer_p, cache)
        if cfg.block_kind == "rwkv6":
            return self._rwkv6_body(x, layer_p, cache)
        a_out, new_cache = self._attn_half(x, layer_p, window, cache,
                                           write_pos, positions,
                                           mrope_positions, plan)
        x, aux = self._mlp_half(x + a_out, layer_p, cache, mesh, plan)
        return x, (new_cache if cache is not None else None), aux

    def _attn_half(self, x, layer_p, window, cache, write_pos, positions,
                   mrope_positions, plan=None):
        """The attention sublayer's output (the twin's ``"attn_out"``)
        and its new cache. In the rank step the layer's attention shards
        are gathered over ``data`` here, inside the remat region."""
        cfg = self.cfg
        h = rms_norm(x, layer_p["pre_norm"]["scale"], cfg.norm_eps)
        if plan is not None:
            ap = plan.fsdp(layer_p["attn"], plan.layer_shardings()["attn"])
            return attn.gqa_forward_tp(
                ap, h, cfg=cfg, positions=positions, window=window,
                groups=plan.groups, cache=cache, write_pos=write_pos,
                layout=None if cache is None else plan.kv_layout())
        if cfg.mla is not None:
            return attn.mla_forward(
                layer_p["attn"], h, cfg=cfg, positions=positions,
                cache=cache, write_pos=write_pos)
        return attn.gqa_forward(
            layer_p["attn"], h, cfg=cfg, positions=positions,
            window=window, cache=cache, write_pos=write_pos,
            mrope_positions=mrope_positions)

    def _mlp_half(self, x, layer_p, cache, mesh, plan=None):
        """``x`` + the MLP or MoE sublayer, and the MoE aux loss."""
        cfg = self.cfg
        h = rms_norm(x, layer_p["pre_mlp_norm"]["scale"], cfg.norm_eps)
        # decode steps route droplessly (C = T = batch is small);
        # train / prefill keep GShard capacity semantics
        dropless = cache is not None and h.shape[1] == 1
        if plan is not None:
            lsh = plan.layer_shardings()
            if cfg.moe:
                m_out, aux = moe_mod.moe_forward_rank(
                    layer_p["moe"], lsh["moe"], h, cfg, plan=plan,
                    dropless=dropless)
                return x + m_out, aux
            mp = plan.fsdp(layer_p["mlp"], lsh["mlp"])
            return x + mlp_forward_tp(mp, h, cfg, plan.groups), self._zero(x)
        if cfg.moe:
            if cfg.moe_ep:
                m_out, aux = moe_mod.moe_forward_ep(
                    layer_p["moe"], h, cfg, dropless=dropless, mesh=mesh)
            else:
                m_out, aux = moe_mod.moe_forward(layer_p["moe"], h, cfg,
                                                 dropless=dropless)
        else:
            m_out = mlp_forward(layer_p["mlp"], h, cfg)
            aux = self._zero(x)
        return x + m_out, aux

    def _mamba2_body(self, x, layer_p, cache):
        cfg = self.cfg
        h = rms_norm(x, layer_p["pre_norm"]["scale"], cfg.norm_eps)
        if cache is None:
            s_out, new_cache = m2.mamba2_scan(layer_p["ssm"], h, cfg=cfg)
        elif h.shape[1] == 1:
            s_out, new_cache = m2.mamba2_step(layer_p["ssm"], h, cache,
                                              cfg=cfg)
        else:  # prefill: scan, then keep the final state
            s_out, new_cache = m2.mamba2_scan(layer_p["ssm"], h, cfg=cfg,
                                              return_cache=True)
        return x + s_out, new_cache, self._zero(x)

    def _rwkv6_body(self, x, layer_p, cache):
        """Time mix, then channel mix; with a cache, both carry their last
        input token (``x_att``, ``x_ffn``) into the next call."""
        cfg = self.cfg
        h = rms_norm(x, layer_p["pre_norm"]["scale"], cfg.norm_eps)
        if cache is None:
            t_out, new_cache = rk.rwkv6_scan(layer_p["rwkv"], h, cfg=cfg)
        elif h.shape[1] == 1:
            t_out, tm_cache = rk.rwkv6_step(layer_p["rwkv"], h, cache,
                                            cfg=cfg)
            new_cache = dict(cache, **tm_cache)
        else:
            t_out, tm_cache = rk.rwkv6_scan(
                layer_p["rwkv"], h, cfg=cfg, x_prev=cache["x_att"],
                return_cache=True)
            new_cache = dict(cache, **tm_cache)
        x = x + t_out
        h = rms_norm(x, layer_p["pre_mlp_norm"]["scale"], cfg.norm_eps)
        if cache is None:
            f_out = rk.rwkv6_ffn(layer_p["ffn"], h)
        else:
            f_out, _ = rk.rwkv6_ffn_step(layer_p["ffn"], h,
                                         new_cache["x_ffn"])
            new_cache["x_ffn"] = h[:, -1]
        return x + f_out, new_cache, self._zero(x)

    @staticmethod
    def _zero(x) -> torch.Tensor:
        return torch.zeros((), dtype=torch.float32, device=x.device)

    def _run_stack(self, params, x, positions, mrope_positions, cache,
                   write_pos, *, remat: bool = False):
        """The twin's ``lax.scan`` over layers as a loop over L. Returns
        (x, new_cache, the sum of the layers' aux losses)."""
        if cache is not None and "local" in cache:
            return self._run_stack_split(params, x, positions, cache,
                                         write_pos)
        from repro_torch.launch.mesh import current_mesh

        cfg = self.cfg
        mesh = current_mesh() if cfg.moe_ep else None
        plan = part.current_rank_plan()
        windows = self.layer_windows()
        layers = _unstacked(params["layers"], cfg.n_layers)
        new, auxs = [], []
        for i in range(cfg.n_layers):
            layer_cache = (None if cache is None
                           else {k: v[i] for k, v in cache.items()})
            if remat and cache is None:
                x, aux = self._remat_body(x, layers[i], int(windows[i]),
                                          positions, mrope_positions, mesh,
                                          plan)
                c = None
            else:
                x, c, aux = self._layer_body(
                    x, layers[i], int(windows[i]), layer_cache, write_pos,
                    positions, mrope_positions, mesh, plan)
            new.append(c)
            auxs.append(aux)
        new_cache = None if cache is None else _stacked(new, cache)
        return x, new_cache, torch.sum(torch.stack(auxs))

    def _remat_body(self, x, layer_p, window, positions, mrope_positions,
                    mesh, plan=None):
        """One cache-free layer under ``cfg.remat_policy``: (x, aux)."""
        cfg = self.cfg
        if cfg.remat_policy == "attn_out" and cfg.block_kind == "attn":
            a_out, _ = remat(lambda x, lp: self._attn_half(
                x, lp, window, None, None, positions, mrope_positions,
                plan))(x, layer_p)
            return remat(lambda x, lp: self._mlp_half(
                x, lp, None, mesh, plan))(x + a_out, layer_p)
        # "attn_out" names a tensor only attention blocks have: elsewhere
        # it saves nothing, as "nothing"
        policy = "nothing" if cfg.remat_policy == "attn_out" else (
            cfg.remat_policy)

        def body(x, lp):
            x, _, aux = self._layer_body(x, lp, window, None, None,
                                         positions, mrope_positions, mesh,
                                         plan)
            return x, aux

        return remat(body, policy)(x, layer_p)

    def _run_stack_split(self, params, x, positions, cache, write_pos):
        """The split-cache path: over the [local x (g-1), global] layer
        groups, the windowed layers on their ring caches and the global
        layer on its full cache. As in the twin, M-RoPE ids are not passed
        and the aux loss is zero."""
        G, nloc = self._split_geometry()
        w = int(self.cfg.sliding_window)
        layers = _unstacked(params["layers"], self.cfg.n_layers)
        new_local, new_global = [], []
        for gi in range(G):
            locals_ = []
            for j in range(nloc):
                i = gi * (nloc + 1) + j
                x, c, _ = self._layer_body(
                    x, layers[i], w,
                    {k: v[gi, j] for k, v in cache["local"].items()},
                    write_pos, positions, None)
                locals_.append(c)
            new_local.append(_stacked(
                locals_, {k: v[gi] for k, v in cache["local"].items()}))
            i = gi * (nloc + 1) + nloc
            x, c, _ = self._layer_body(
                x, layers[i], 0,
                {k: v[gi] for k, v in cache["global"].items()},
                write_pos, positions, None)
            new_global.append(c)
        new_cache = {"local": _stacked(new_local, cache["local"]),
                     "global": _stacked(new_global, cache["global"])}
        return x, new_cache, torch.zeros((), dtype=torch.float32,
                                         device=x.device)

    def _positions(self, batch_in, B, S, device):
        positions = batch_in.get("positions")
        if positions is None:
            return torch.arange(S, dtype=torch.int32,
                                device=device)[None].expand(B, S)
        return torch.as_tensor(positions, device=device)

    @staticmethod
    def _mrope(batch_in, device):
        m = batch_in.get("mrope_positions")
        return None if m is None else torch.as_tensor(m, device=device)

    # ---------------- public entry points ----------------
    def forward(self, params, batch_in, *, remat: bool = False):
        """Teacher-forced logits. batch_in: {'tokens' (B,S) | 'embeds'
        (B,S,d), optional 'positions', 'mrope_positions' (3,B,S)}.
        Returns (logits (B,S,V), aux)."""
        cfg = self.cfg
        x = self._embed(params, batch_in)
        B, S = x.shape[0], x.shape[1]
        positions = self._positions(batch_in, B, S, x.device)
        x, _, aux = self._run_stack(params, x, positions,
                                    self._mrope(batch_in, x.device), None,
                                    None, remat=remat)
        x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        return self._unembed(params, x), aux

    def _unembed(self, params, x):
        cfg = self.cfg
        plan = part.current_rank_plan()
        if plan is not None:
            return self._unembed_rank(params, x, plan)
        if cfg.tie_embeddings:
            logits = x @ params["embed"]["table"].T
        else:
            logits = x @ params["unembed"]["table"]
        return self._mask_pad(logits, 0)

    def _mask_pad(self, logits, lo: int):
        """``logits`` of vocab ids ``lo ..`` with the pad columns (ids past
        the vocab) masked: softmax / argmax never select them."""
        cfg = self.cfg
        if cfg.padded_vocab == cfg.vocab_size:
            return logits
        pad = torch.arange(lo, lo + logits.shape[-1],
                           device=logits.device) >= cfg.vocab_size
        return torch.where(pad, torch.full(
            (), -2.0 ** 20, dtype=logits.dtype, device=logits.device),
            logits)

    # ---------------- the rank step ----------------
    def _embed_rank(self, params, batch_in, plan):
        """The lookup of this rank's tokens: the table gathered over
        ``data``; over ``model`` vocab-parallel (each rank looks up the
        tokens of its vocab slice, zeros elsewhere, summed by one
        all-reduce)."""
        table = plan.fsdp(params["embed"], plan.shardings["embed"])["table"]
        tokens = torch.as_tensor(batch_in["tokens"],
                                 device=table.device).to(torch.int64)
        if table.shape[0] == self.cfg.padded_vocab:
            return table[tokens]
        vl = table.shape[0]
        local = tokens - plan.groups.index("model") * vl
        mine = (local >= 0) & (local < vl)
        x = torch.where(mine[..., None], table[local.clamp(0, vl - 1)],
                        torch.zeros((), dtype=table.dtype,
                                    device=table.device))
        return pg.reduce_out(x, plan.groups)

    def _head_weight(self, params, plan):
        """``(w, lo)``: this rank's head ``(d, V_l)``, gathered over
        ``data``, and the first vocab id of its slice: over ``model`` the
        slice the partitioner gives the rank (the whole vocab, ``lo`` 0,
        where it is not split)."""
        cfg = self.cfg
        if cfg.tie_embeddings:
            w = plan.fsdp(params["embed"], plan.shardings["embed"])["table"].T
        else:
            w = plan.fsdp(params["unembed"],
                          plan.shardings["unembed"])["table"]
        vl = w.shape[1]
        return w, (plan.groups.index("model") * vl
                   if vl != cfg.padded_vocab else 0)

    def _unembed_rank(self, params, x, plan):
        """This rank's vocab slice of the logits of ``x``, pad columns
        masked (:meth:`_head_weight`)."""
        w, lo = self._head_weight(params, plan)
        return self._mask_pad(x @ w, lo)

    def gather_logits(self, logits, plan):
        """The whole vocab's logits from each rank's slice
        (:meth:`_unembed_rank`): gathered over ``model`` where it splits
        the vocab."""
        if logits.shape[-1] == self.cfg.padded_vocab:
            return logits
        return pg.gather(logits, logits.ndim - 1, plan.groups, "model")

    def greedy_rank(self, logits, plan):
        """The greedy tokens (int32) of ``logits`` (..., V_l), each rank's
        vocab slice: the argmax over the slices, ties to the lowest index
        as ``jnp.argmax`` sends them. Each rank's first maximum and its
        value are gathered over ``model``; the first rank holding the
        largest value wins, and its slice's indices are the lowest."""
        vl = logits.shape[-1]
        if vl == self.cfg.padded_vocab:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        if self.cfg.padded_vocab >= 2 ** 24:
            raise ValueError("vocab ids past 2^24 do not ride a float32")
        groups = plan.groups
        idx = torch.argmax(logits, dim=-1, keepdim=True)
        val = torch.gather(logits, -1, idx).to(torch.float32)
        gidx = (idx + groups.index("model") * vl).to(torch.float32)
        both = pg.gather(torch.stack([val[..., 0], gidx[..., 0]])[None], 0,
                         groups, "model")          # (M, 2, ...)
        best = torch.argmax(both[:, 0], dim=0, keepdim=True)
        return torch.gather(both[:, 1], 0, best)[0].to(torch.int32)

    def _head_rank(self, hp, x, targets, plan):
        """Final norm, logits and the vocab-parallel cross entropy of this
        rank's rows: ``(sum of CE + z_weight sum of logz^2) / N``, ``N``
        the microbatch's tokens over all batch shards (``pod`` x
        ``data``), so their parts sum to the twin's token means. Over
        ``model`` the max and the sum of exponentials are all-reduced,
        never the logits."""
        cfg = self.cfg
        groups = plan.groups
        x = rms_norm(x, hp["final_norm"]["scale"], cfg.norm_eps)
        w, lo = self._head_weight(hp, plan)
        vl = w.shape[1]
        sharded = vl != cfg.padded_vocab
        logits = self._mask_pad(
            (pg.copy_in(x, groups) if sharded else x) @ w, lo)
        lf = logits.to(torch.float32)
        t = targets.to(torch.int64) - lo
        if sharded:
            mx = torch.amax(lf, dim=-1).detach()
            pg.all_reduce_(mx, groups, "model", op="max")
            se = torch.sum(torch.exp(lf - mx[..., None]), dim=-1)
            logz = torch.log(pg.reduce_out(se, groups)) + mx
            mine = (t >= 0) & (t < vl)
            gold = torch.gather(lf, -1, t.clamp(0, vl - 1)[..., None])[..., 0]
            gold = pg.reduce_out(torch.where(mine, gold, torch.zeros(
                (), dtype=lf.dtype, device=lf.device)), groups)
        else:   # the one-device ops: a rank mesh of one is bit-equal
            logz = torch.logsumexp(lf, dim=-1)
            gold = torch.gather(lf, -1, t[..., None])[..., 0]
        if plan.dp == 1:
            return torch.mean(logz - gold) + 1e-4 * torch.mean(logz * logz)
        n = float(targets.numel() * plan.dp)
        return (torch.sum(logz - gold) / n
                + 1e-4 * (torch.sum(logz * logz) / n))

    def _loss_rank(self, params, batch_in, rematerialize, plan):
        """This rank's part of the microbatch's loss: its rows' CE and
        z-loss over the microbatch's token count, plus the aux loss over
        the batch shards' count (each batch shard holds the microbatch's
        aux, or with ``moe_ep`` its data row's, whose mean the twin
        takes), so the parts sum over ``pod`` x ``data`` to the twin's
        loss; every ``model`` rank holds the same part."""
        x = self._embed_rank(params, batch_in, plan)
        B, S = x.shape[0], x.shape[1]
        positions = self._positions(batch_in, B, S, x.device)
        x, _, aux = self._run_stack(params, x, positions, None, None, None,
                                    remat=rematerialize)
        targets = torch.as_tensor(batch_in["targets"], device=x.device)
        hp = {k: params[k] for k in ("embed", "final_norm", "unembed")
              if k in params}

        def head(x, hp):
            return self._head_rank(hp, x, targets, plan)

        own = remat(head)(x, hp) if rematerialize else head(x, hp)
        return own + aux / plan.dp, {"aux": aux}

    def loss(self, params, batch_in, *, remat: bool = False):
        plan = part.current_rank_plan()
        if plan is not None:
            return self._loss_rank(params, batch_in, remat, plan)
        logits, aux = self.forward(params, batch_in, remat=remat)
        targets = torch.as_tensor(batch_in["targets"], device=logits.device)
        ce, parts = cross_entropy_loss(logits, targets)
        return ce + aux, dict(parts, aux=aux)

    def prefill(self, params, batch_in, cache):
        """Populate caches; returns (last-token logits (B,1,V), cache).
        In the rank step the rows, the cache and the returned cache are
        this rank's, and the logits its vocab slice
        (:meth:`_unembed_rank`)."""
        cfg = self.cfg
        x = self._embed(params, batch_in)
        B, S = x.shape[0], x.shape[1]
        positions = self._positions(batch_in, B, S, x.device)
        x, new_cache, _ = self._run_stack(
            params, x, positions, self._mrope(batch_in, x.device), cache, 0)
        x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        return self._unembed(params, x[:, -1:]), new_cache

    def decode_step(self, params, token_in, pos, cache):
        """One decode step. token_in: {'tokens' (B,1) | 'embeds' (B,1,d),
        optional 'mrope_positions' (3,B,1)}; pos: the absolute position
        (an int). Returns (logits (B,1,V), new_cache); in the rank step
        as :meth:`prefill` returns them there."""
        cfg = self.cfg
        x = self._embed(params, token_in)
        B = x.shape[0]
        pos = int(pos)
        positions = torch.full((B, 1), pos, dtype=torch.int32,
                               device=x.device)
        x, new_cache, _ = self._run_stack(
            params, x, positions, self._mrope(token_in, x.device), cache,
            pos)
        x = rms_norm(x, params["final_norm"]["scale"], cfg.norm_eps)
        return self._unembed(params, x), new_cache
