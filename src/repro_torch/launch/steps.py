"""LMHarness: per-(arch x shape) step functions, shapes and shardings.

Twin of :mod:`repro.launch.steps`:

  * ``param_shapes()``       — the params on the ``meta`` device (shapes
    and dtypes, nothing drawn or allocated), where the twin uses
    ``eval_shape``;
  * ``batch_shapes`` / ``token_shapes`` / ``cache_shapes`` — ``meta``
    tensors standing in for the step inputs (tokens, ``embeds`` and
    ``mrope_positions`` for the embeddings frontend, or whisper's
    ``enc_embeds`` with its decoder tokens, each half the shape's
    sequence) and the caches (GQA rings, MLA latents, the split layout,
    recurrent states, whisper's self and cross caches), as the twin's
    ``ShapeDtypeStruct``s do;
  * ``make_train_step``   — microbatched gradient accumulation + AdamW;
  * ``make_prefill_step`` — build + fill KV caches;
  * ``make_decode_step``  — one greedy token against the cache (with
    M-RoPE ids of the position, as the twin gives them);
  * ``shardings``         — the partitioner's in / out shardings of a
    step (with the ``expert_parallel`` / ``attn_tp`` levers).

Microbatching policy, the twin's: the global batch splits so each
data-shard row takes ``micro_rows`` sequences a microbatch (``n_micro =
global_batch / (batch shards x micro_rows)``), microbatches strided
across the shards (:func:`_strided_split`); the gradients of ``loss(...,
remat=True)`` accumulate in float32, are averaged, clipped to global
norm 1 and applied by AdamW. The mesh decides the numbers, not only the
layout: ``n_micro``, the split and, with ``moe_ep``, each data row's
local MoE capacity follow it. A step runs a logical mesh on one device
(:func:`repro_torch.launch.mesh.single_device`), or a rank mesh
(:func:`repro_torch.launch.mesh.make_rank_mesh`, one process a device):

  * each batch shard takes its rows of the strided split (a contiguous
    block of ``B / (n_pod n_data)`` rows at its row-major ``(pod,
    data)`` index, ``n_micro`` microbatches of it);
  * the params, Adam's moments and the float32 gradient accumulator are
    this rank's shards, never whole (replicated over ``pod``): a layer's
    ``data`` shards are gathered inside its remat region and their
    gradient reduce-scattered back by the gather's backward, each
    microbatch; the gradient of a leaf not sharded over ``data`` is
    all-reduced over it once a step, and every leaf's over ``pod``;
  * the loss is the sum over the batch shards of their parts (sums over
    the microbatch's token count, not a mean of means), and the clip's
    norm counts each leaf's shard once among its replicas (on pod 0);
  * it returns this rank's ``params`` and ``opt_state`` and the global
    ``loss`` and ``grad_norm``.

Prefill and decode run on a rank mesh too, for the same families (dense
GQA / MQA and MoE, without ``moe_ep`` or the ``expert_parallel`` lever):

  * they take the global batch (or the decode tokens) and cut this
    rank's rows over ``(pod, data)`` where those axes divide the batch
    (as the twin's input sharding splits it; else every rank holds every
    row);
  * the params are this rank's shards (gathered over ``data`` a layer at
    a time, Megatron TP over ``model``: a rank computes the query heads
    its ``wq`` columns touch, so ``model`` need not divide the heads),
    and so is the cache: each rank allocates only its shard of every
    leaf of ``cache_partition``'s layout
    (:func:`repro_torch.distributed.partition.cache_shards`), the
    slots over ``model`` where they divide (decode context parallelism),
    else the K/V heads, else replicated over ``model``;
  * like the twin's replicated outputs, every rank returns the whole
    batch's last logits (prefill) or next tokens (decode), gathered over
    ``data`` and ``pod``, with its own cache shards.

A mesh may have a ``pod`` axis (``("pod", "data", "model")``): it carries
only the batch, as the twin's rules put only the batch on it. The train
step of the families other than the dense GQA and MoE ones, and their
prefill and decode, are ROADMAP item 12e-ii and raise; query heads that
``model`` does not divide (llama4-scout's 40 on 16 model ranks) run in
all three steps (:func:`repro_torch.models.attention.gqa_forward_tp`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import configs
from repro_torch.configs.shapes import Shape
from repro_torch.core import prng
from repro_torch.distributed import partition as part
from repro_torch.distributed import process_group as pg
from repro_torch.launch.mesh import refuse_ranks, single_device, use_mesh
from repro_torch.training import optimizers
from repro_torch.tree import leaves, unflatten

__all__ = ["LMHarness", "SkipCell"]

_META = torch.device("meta")


class SkipCell(Exception):
    """Raised when an (arch x shape) cell is N/A (documented skip)."""


@dataclasses.dataclass
class LMHarness:
    arch_id: str
    cfg: Any = None
    lr: float = 1e-4
    expert_parallel: bool = False   # MoE lever: experts over model, not ffn
    attn_tp: bool = True            # False replicates the attention weights
    micro_rows: int = 1             # sequences per data shard a microbatch

    def __post_init__(self):
        mod = configs.get_arch(self.arch_id)
        self.cfg = self.cfg or mod.CONFIG
        self.model = mod.build(self.cfg)
        self.is_whisper = self.arch_id == "whisper-large-v3"
        self.opt = optimizers.adamw(self.lr, weight_decay=0.01)

    # ------------------------------------------------------------------
    # shapes (no allocation anywhere)
    # ------------------------------------------------------------------
    def param_shapes(self) -> dict:
        return self.model.init(prng.key(0), device=_META)

    def opt_shapes(self) -> dict:
        return self.opt.init(self.param_shapes_zeros())

    def param_shapes_zeros(self) -> dict:
        # opt.init reads only shapes and dtypes: the meta params do
        return self.param_shapes()

    def check_cell(self, shape: Shape) -> None:
        if shape.name == "long_500k" and not self.cfg.subquadratic:
            raise SkipCell(
                f"{self.arch_id} is pure full-attention; long_500k needs a "
                f"sub-quadratic arch")

    def batch_shapes(self, shape: Shape) -> dict:
        """Inputs for train / prefill kinds (decode uses token_shapes)."""
        self.check_cell(shape)
        B, S = shape.global_batch, shape.seq_len
        cfg = self.cfg

        def i32(*dims):
            return torch.empty(dims, dtype=torch.int32, device=_META)

        if self.is_whisper:
            half = S // 2
            return {"enc_embeds": torch.empty((B, half, cfg.d_model),
                                              dtype=cfg.dtype, device=_META),
                    "tokens": i32(B, half), "targets": i32(B, half)}
        if cfg.frontend == "embeddings":
            out = {"embeds": torch.empty((B, S, cfg.d_model),
                                         dtype=cfg.dtype, device=_META),
                   "targets": i32(B, S)}
            if cfg.mrope:
                out["mrope_positions"] = i32(3, B, S)
            return out
        return {"tokens": i32(B, S), "targets": i32(B, S)}

    def cache_shapes(self, shape: Shape) -> dict:
        self.check_cell(shape)
        return self._init_cache(shape, _META)

    def _init_cache(self, shape: Shape, device) -> dict:
        """A fresh cache of ``shape``: whisper's self and cross caches of
        ``seq_len // 2`` each, the others' of ``seq_len``."""
        B, S = shape.global_batch, shape.seq_len
        if self.is_whisper:
            return self.model.init_cache(B, S // 2, S // 2, device=device)
        return self.model.init_cache(B, S, device=device)

    def token_shapes(self, shape: Shape) -> dict:
        """Decode-step inputs (one new token)."""
        B = shape.global_batch
        return {"tokens": torch.empty((B, 1), dtype=torch.int32,
                                      device=_META)}

    # ------------------------------------------------------------------
    # steps
    # ------------------------------------------------------------------
    def n_microbatches(self, shape: Shape, mesh) -> int:
        rules = self.rules(mesh)
        shard = part._axis_size(mesh, tuple(rules.batch_axes))
        if shape.global_batch % shard != 0:
            return 1
        n = max(1, shape.global_batch // (shard * self.micro_rows))
        while shape.global_batch % (shard * n) != 0 and n > 1:
            n -= 1
        return max(1, n)

    def make_train_step(self, shape: Shape, mesh):
        """``train_step(params, opt_state, batch) -> (params, opt_state,
        {"loss", "grad_norm"})`` on ``mesh``'s device; the batch's leaves
        (numpy or tensors) move there. On a rank mesh the params and the
        state are this rank's shards and the batch is the global one."""
        if mesh.is_ranks:
            return self._make_rank_train_step(shape, mesh)
        device = single_device(mesh)
        n_micro = self.n_microbatches(shape, mesh)
        model, opt = self.model, self.opt
        rules = self.rules(mesh)
        n_shards = part._axis_size(mesh, tuple(rules.batch_axes))

        def train_step(params, opt_state, batch):
            with use_mesh(mesh), part.activation_sharding(
                    rules.batch_axes, shape.global_batch, mesh):
                # microbatch m takes row m of every data shard
                xs = {k: _strided_split(torch.as_tensor(v, device=device),
                                        n_micro, n_shards)
                      for k, v in batch.items()}
                gsum, lsum = _accumulate(model, params, xs, n_micro, device)
                with torch.no_grad():
                    n = torch.full((), float(n_micro), dtype=torch.float32,
                                   device=device)
                    grads = unflatten(params, [g.div_(n) for g in gsum])
                    del gsum
                    grads, gnorm = optimizers.clip_by_global_norm(grads, 1.0)
                    updates, opt_state = opt.update(grads, opt_state,
                                                    params)
                    del grads
                    params = optimizers.apply_updates(params, updates)
            return params, opt_state, {"loss": lsum / n, "grad_norm": gnorm}

        return train_step

    def _refuse_across_ranks(self, mesh, kind: str = "train") -> None:
        """The families and levers the rank steps do not run yet
        (ROADMAP Queue 1 item 12e-ii), in that item's order; ``kind``
        names the step."""
        cfg = self.cfg
        what = None
        if cfg.mla is not None:
            what = "MLA (minicpm3)"
        elif cfg.global_every or cfg.qk_norm or cfg.split_cache:
            what = "gemma3's local:global mix"
        elif cfg.frontend != "tokens" or cfg.mrope:
            what = "qwen2-vl's embeddings frontend"
        elif cfg.block_kind == "mamba2":
            what = "zamba2 (Mamba2)"
        elif cfg.block_kind == "rwkv6":
            what = "rwkv6"
        elif self.is_whisper:
            what = "whisper"
        elif cfg.moe is not None and self.expert_parallel:
            what = "the expert_parallel lever"
        elif cfg.moe is not None and cfg.moe_ep and kind != "train":
            what = "moe_ep"
        if what is not None:
            refuse_ranks(mesh, f"the {kind} step of {what}")

    def _make_rank_train_step(self, shape: Shape, mesh):
        self._refuse_across_ranks(mesh)
        groups = mesh.ranks
        p_shard = part.params_partition(self.param_shapes(), mesh,
                                        self.rules(mesh))
        plan = part.RankPlan(groups, p_shard)
        n_micro = self.n_microbatches(shape, mesh)
        n_dp, row = plan.dp, plan.batch_index
        B = shape.global_batch
        if B % (n_dp * n_micro):
            raise ValueError(f"batch {B} does not split into {n_micro} "
                             f"microbatches on each of {n_dp} batch shards")
        rows = B // n_dp
        device = groups.device
        model, opt = self.model, self.opt
        used = [{a for e in sh.spec for a in part.entry_axes(e)}
                for sh in leaves(p_shard)]
        # a leaf not sharded over data has a partial gradient on each
        # data rank, and every leaf one on each pod (params replicate over
        # pod); a leaf's norm counts on one rank of its replicas
        partial = ["data" not in u for u in used]
        owned = [all(groups.index(a) == 0 for a in groups.axis_names
                     if a not in u) for u in used]

        def world_sum(t):
            return pg.all_reduce_(t, groups, None)

        def train_step(params, opt_state, batch):
            with use_mesh(mesh), part.rank_plan(plan), (
                    part.activation_sharding(plan.batch_axes, B, mesh)):
                xs = {k: _strided_split(torch.as_tensor(v)[
                    row * rows:(row + 1) * rows].to(device), n_micro, 1)
                      for k, v in batch.items()}
                gsum, lsum = _accumulate(model, params, xs, n_micro, device)
                with torch.no_grad():
                    # the loss sums over data and pod as a replicated leaf
                    for acc, part_ in zip(gsum + [lsum], partial + [True]):
                        if part_:
                            pg.all_reduce_(acc, groups, "data")
                        pg.all_reduce_(acc, groups, "pod")
                    n = torch.full((), float(n_micro), dtype=torch.float32,
                                   device=device)
                    grads = unflatten(params, [g.div_(n) for g in gsum])
                    del gsum
                    grads, gnorm = optimizers.clip_by_global_norm(
                        grads, 1.0, owned=owned, all_reduce=world_sum)
                    updates, opt_state = opt.update(grads, opt_state,
                                                    params)
                    del grads
                    params = optimizers.apply_updates(params, updates)
            return params, opt_state, {"loss": lsum / n, "grad_norm": gnorm}

        return train_step

    def make_prefill_step(self, shape: Shape, mesh=None, *, device=None):
        """``prefill(params, batch) -> (last logits, cache)`` with a fresh
        cache of ``shape`` on ``device`` (default: ``mesh``'s device, or
        ``"cuda"`` without a mesh), under ``mesh``'s activation context
        when one is given. On a rank mesh, ``prefill(params, batch,
        cache=None)`` takes this rank's param shards and the global
        batch, and returns the whole batch's last logits and this rank's
        cache shards (fresh ones unless ``cache`` is given)."""
        if mesh is not None and mesh.is_ranks:
            return self._make_rank_serve_step(shape, mesh, "prefill")
        model = self.model
        if device is None:
            device = "cuda" if mesh is None else single_device(mesh)

        @torch.inference_mode()
        def prefill(params, batch):
            cache = self._init_cache(shape, device)
            if mesh is None:
                return model.prefill(params, batch, cache)
            with use_mesh(mesh), part.activation_sharding(
                    self.rules(mesh).batch_axes, shape.global_batch, mesh):
                return model.prefill(params, batch, cache)

        return prefill

    def make_decode_step(self, shape: Shape, mesh=None):
        """``decode(params, cache, token_in, pos) -> (next token (B, 1)
        int32, cache)``: one greedy token. On a rank mesh the params and
        the cache are this rank's shards, ``token_in`` the whole batch's
        and ``pos`` an int (or a tensor, read on the host once); every
        rank returns the whole batch's tokens and its new cache
        shards."""
        if mesh is not None and mesh.is_ranks:
            return self._make_rank_serve_step(shape, mesh, "decode")
        model = self.model
        cfg = self.cfg

        @torch.inference_mode()
        def decode(params, cache, token_in, pos):
            tin = dict(token_in)
            if cfg.mrope:
                tok = torch.as_tensor(token_in["tokens"])
                tin["mrope_positions"] = torch.full(
                    (3, tok.shape[0], 1), int(pos), dtype=torch.int32,
                    device=tok.device)
            logits, cache = model.decode_step(params, tin, pos, cache)
            next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            return next_tok[:, None], cache

        return decode

    def _make_rank_serve_step(self, shape: Shape, mesh, kind: str):
        """The prefill or decode step of ``kind`` on a rank mesh."""
        self._refuse_across_ranks(mesh, kind)
        groups = mesh.ranks
        rules = self.rules(mesh)
        p_shard = part.params_partition(self.param_shapes(), mesh, rules)
        c_shapes = self.cache_shapes(shape)
        c_shard = part.cache_partition(c_shapes, mesh, rules)
        B = shape.global_batch
        # the rows split over the batch axes (pod x data) where the twin's
        # batch sharding splits them (``batch_partition``), else every
        # rank holds them all
        split = bool(part.batch_partition(
            self.token_shapes(shape), mesh, rules)["tokens"].spec)
        plan = part.RankPlan(groups, p_shard, cache=c_shard,
                             rows_split=split)
        n_dp, row = plan.dp, plan.batch_index
        rows = slice(row * (B // n_dp), (row + 1) * (B // n_dp)) if split \
            else slice(None)
        device = groups.device
        model = self.model

        def mine(tree):
            return {k: torch.as_tensor(v)[rows].to(device)
                    for k, v in tree.items()}

        def whole(x):   # this rank's rows -> the whole batch's
            return plan.gather_rows(x) if split else x

        if kind == "prefill":
            @torch.no_grad()
            def prefill(params, batch, cache=None):
                if cache is None:
                    cache = part.cache_shards(c_shapes, c_shard, device)
                with use_mesh(mesh), part.rank_plan(plan):
                    logits, cache = model.prefill(params, mine(batch), cache)
                    logits = whole(model.gather_logits(logits, plan))
                return logits, cache

            return prefill

        @torch.no_grad()
        def decode(params, cache, token_in, pos):
            with use_mesh(mesh), part.rank_plan(plan):
                logits, cache = model.decode_step(params, mine(token_in),
                                                  int(pos), cache)
                tok = whole(model.greedy_rank(logits[:, -1], plan))
            return tok[:, None], cache

        return decode

    # ------------------------------------------------------------------
    # shardings
    # ------------------------------------------------------------------
    def rules(self, mesh) -> part.PartitionRules:
        return part.PartitionRules.default(
            mesh, expert_parallel=self.expert_parallel,
            attn_tp=self.attn_tp)

    def shardings(self, shape: Shape, mesh, kind: str):
        """``(in_shardings, out_shardings, example_args)`` of the step of
        ``kind``: trees of :class:`repro_torch.distributed.partition.
        Sharding` and of ``meta`` tensors, as the twin's for ``jit``."""
        rules = self.rules(mesh)
        replicated = part.Sharding(mesh, ())
        p_shapes = self.param_shapes()
        p_shard = part.params_partition(p_shapes, mesh, rules)
        if kind == "train":
            o_shapes = self.opt.init(p_shapes)
            o_shard = part.opt_partition(o_shapes, p_shard, mesh)
            b_shapes = self.batch_shapes(shape)
            b_shard = part.batch_partition(b_shapes, mesh, rules)
            return ((p_shard, o_shard, b_shard),
                    (p_shard, o_shard, replicated),
                    (p_shapes, o_shapes, b_shapes))
        if kind == "prefill":
            b_shapes = self.batch_shapes(shape)
            b_shard = part.batch_partition(b_shapes, mesh, rules)
            c_shard = part.cache_partition(self.cache_shapes(shape), mesh,
                                           rules)
            return ((p_shard, b_shard), (replicated, c_shard),
                    (p_shapes, b_shapes))
        if kind == "decode":
            c_shapes = self.cache_shapes(shape)
            c_shard = part.cache_partition(c_shapes, mesh, rules)
            t_shapes = self.token_shapes(shape)
            t_shard = part.batch_partition(t_shapes, mesh, rules)
            pos_shape = torch.empty((), dtype=torch.int32, device=_META)
            return ((p_shard, c_shard, t_shard, replicated),
                    (replicated, c_shard),
                    (p_shapes, c_shapes, t_shapes, pos_shape))
        raise ValueError(kind)

    def step_fn(self, shape: Shape, mesh, kind: str):
        if kind == "train":
            return self.make_train_step(shape, mesh)
        if kind == "prefill":
            return self.make_prefill_step(shape, mesh)
        if kind == "decode":
            return self.make_decode_step(shape, mesh)
        raise ValueError(kind)


def _accumulate(model, params, xs, n_micro: int, device):
    """``(gsum, lsum)``: the float32 sums over the microbatches ``xs``
    (each leaf split on its leading axis) of ``loss(remat=True)``'s
    gradient, a list in ``params``' flatten order, and of the loss."""
    flat = leaves(params)
    gsum = [torch.zeros_like(p, dtype=torch.float32) for p in flat]
    lsum = torch.zeros((), dtype=torch.float32, device=device)
    for m in range(n_micro):
        live = [p.detach().requires_grad_() for p in flat]
        loss, _ = model.loss(unflatten(params, live),
                             {k: v[m] for k, v in xs.items()}, remat=True)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        for acc, g in zip(gsum, grads):
            if g is not None:  # an unused leaf's is zero
                acc.add_(g.to(torch.float32))
        lsum = lsum + loss.detach()
        del live, loss, grads
    return gsum, lsum


def _strided_split(x, n_micro: int, n_shards: int):
    """(B, ...) -> (n_micro, B / n_micro, ...) with the microbatches
    strided across the data shards: B = n_shards x n_micro x r, and
    microbatch m holds rows ``s n_micro r + m r + j``. M-RoPE ids (3, B,
    S) split on axis 1. A batch the shards do not divide splits plainly
    (``n_shards`` taken as 1)."""
    batch_axis = 1 if (x.ndim >= 2 and x.shape[0] == 3) else 0
    B = x.shape[batch_axis]
    if B % n_micro != 0:
        raise ValueError(f"batch {B} not divisible by n_micro {n_micro}")
    if B % (n_shards * n_micro) == 0:
        split = (n_shards, n_micro, B // (n_shards * n_micro))
    else:
        split = (1, n_micro, B // n_micro)
    pre = tuple(x.shape[:batch_axis])
    post = tuple(x.shape[batch_axis + 1:])
    y = torch.movedim(x.reshape(pre + split + post), batch_axis + 1, 0)
    return y.reshape((n_micro,) + pre + (split[0] * split[2],) + post)
