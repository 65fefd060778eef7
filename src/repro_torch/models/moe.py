"""Mixture-of-Experts layer with sort-based (gather) dispatch.

Twin of :mod:`repro.models.moe`. Top-k routing in float32, then
capacity-bounded gather dispatch (GShard-style): each (token, expert)
pair is sorted by expert, the first ``C`` pairs of an expert fill its
buffer rows and the rest go to one trash row, the experts run as one
batched product, and a scatter-add combines the kept pairs back in token
order. Only routed experts' rows are computed, so the work tracks the
*active* parameters.

Every size of the dispatch follows from the shapes (``C`` from T, k, E
and the capacity factor), so it issues no host sync: no ``.item()``, no
``nonzero``, no boolean-mask indexing.

``moe_forward_ep`` is the twin's expert-parallel ``shard_map`` written
for one controller: each batch-shard row routes its own tokens under a
local capacity, the all-to-all is a regrouping of the rows' send
buffers, each data row's ``E / n_data`` experts run on what they receive
(the ``model`` axis's partial products summed as one unsplit product),
and the results go home the same way.

:func:`moe_forward_rank` is the rank step's MoE across ranks (one
process a device): :func:`moe_forward` with the rank's own hooks for the
experts and the shared expert. Without ``moe_ep`` it keeps GSPMD's
global semantics: the microbatch is gathered over ``data`` and ``pod``
before routing, so capacity counts every rank's tokens, each batch
shard runs the whole microbatch's dispatch and experts and keeps its
own rows (the redundant work is the batch shards' count over; the shared
expert runs on the rank's own tokens only). With ``moe_ep`` each data
row routes its own tokens, an all-to-all over ``data`` (within a pod)
carries the expert buffers out and the results back, and the experts'
weights reach their row by one all-to-all of their ``embed`` shards. The
experts' ``d_ff`` runs tensor-parallel over ``model`` (one all-reduce).
A decode step routes droplessly, so each rank routes its own rows.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import ieee_fp32_matmul
from repro_torch.distributed import process_group as pg
from repro_torch.distributed.partition import entry_axes
from repro_torch.models.common import (
    MoEConfig,
    TransformerConfig,
    dense_init,
    gelu,
    silu,
)

__all__ = ["init_moe", "moe_forward", "moe_forward_ep", "moe_forward_rank",
           "route", "capacity", "dispatch"]


def init_moe(key, cfg: TransformerConfig, *, device) -> dict:
    m = cfg.moe
    d, f, E = cfg.d_model, cfg.d_ff, m.n_experts
    k1, k2, k3, k4, k5, k6, k7 = prng.split(key, 7)
    p = {
        "router": dense_init(k1, (d, E), device=device),
        "w_gate": dense_init(k2, (E, d, f), in_axis=1, device=device),
        "w_up": dense_init(k3, (E, d, f), in_axis=1, device=device),
        "w_down": dense_init(k4, (E, f, d), in_axis=1, device=device),
    }
    if m.shared_expert:
        p["shared_w_gate"] = dense_init(k5, (d, f), device=device)
        p["shared_w_up"] = dense_init(k6, (d, f), device=device)
        p["shared_w_down"] = dense_init(k7, (f, d), device=device)
    return p


def route(p: dict, xf, m: MoEConfig):
    """Router of ``xf`` (T, d): ``(probs (T, E), gate_vals (T, k),
    gate_idx (T, k))``, all in float32 but the int64 indices.

    The top k come from a stable descending sort, so ties go to the lower
    expert index as ``jax.lax.top_k`` sends them (``torch.topk`` promises
    no order among ties). The gates are renormalised over the k."""
    with ieee_fp32_matmul():
        logits = xf.to(torch.float32) @ p["router"].to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :m.top_k], idx[:, :m.top_k]
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)
    return probs, gate_vals, gate_idx


def capacity(T: int, m: MoEConfig, dropless: bool) -> int:
    """Rows per expert buffer: ``T`` when dropless, else ``ceil(T k / E x
    capacity_factor)``; at least 8, padded to a multiple of 8."""
    C = T if dropless else int(np.ceil(T * m.top_k / m.n_experts
                                       * m.capacity_factor))
    return max(8, -(-C // 8) * 8)


def dispatch(gate_idx, E: int, C: int):
    """The (token, expert) pairs sorted by expert, stably (JAX's
    ``argsort`` is stable, and a pair's rank among its expert's pairs
    decides whether capacity drops it). Returns ``(order, se, st, keep,
    slot)``: the sort order of the flat pairs, their experts and tokens in
    that order, whether each fits its expert's ``C`` rows, and its buffer
    row (``E * C``, the trash row, when dropped)."""
    T, k = gate_idx.shape
    dev = gate_idx.device
    expert_flat = gate_idx.reshape(-1)
    token_flat = torch.arange(T, device=dev).repeat_interleave(k)
    order = torch.argsort(expert_flat, stable=True)
    se = expert_flat[order]
    st = token_flat[order]
    # the first pair of each expert in the sorted list (se is sorted)
    starts = torch.searchsorted(se, torch.arange(E, device=dev))
    pos_in_e = torch.arange(T * k, device=dev) - starts[se]
    keep = pos_in_e < C                                  # capacity drop
    slot = torch.where(keep, se * C + pos_in_e,
                       torch.full_like(se, E * C))       # overflow -> trash
    return order, se, st, keep, slot


def _aux(probs, gate_idx, m: MoEConfig):
    """The load-balance aux loss (Switch): ``E * sum_e f_e * P_e`` over
    the rows of ``probs`` (T, E) and their top-k ``gate_idx``."""
    E, k = m.n_experts, m.top_k
    T, dev = probs.shape[0], probs.device
    me = torch.mean(probs, dim=0)
    ce = torch.zeros((E,), dtype=torch.float32, device=dev).index_add_(
        0, gate_idx.reshape(-1),
        torch.ones((T * k,), dtype=torch.float32, device=dev)) / (T * k)
    return m.router_aux_weight * E * torch.sum(me * ce)


def _experts(p: dict, eb, cfg: TransformerConfig):
    """The experts of ``eb`` (E, rows, d) as one batched product over
    experts: (E, rows, d) in ``eb``'s dtype."""
    if cfg.mlp_kind in ("swiglu", "geglu"):
        act = silu if cfg.mlp_kind == "swiglu" else gelu
        h = act(torch.bmm(eb, p["w_gate"].to(eb.dtype)))
        h = h * torch.bmm(eb, p["w_up"].to(eb.dtype))
    else:
        h = gelu(torch.bmm(eb, p["w_up"].to(eb.dtype)))
    return torch.bmm(h, p["w_down"].to(eb.dtype))


def _shared(p: dict, xf):
    """llama4's always-on shared expert of ``xf`` (T, d)."""
    hs = silu(xf @ p["shared_w_gate"].to(xf.dtype)) * (
        xf @ p["shared_w_up"].to(xf.dtype))
    return hs @ p["shared_w_down"].to(xf.dtype)


def moe_forward(p: dict, x, cfg: TransformerConfig, *,
                dropless: bool = False, experts=_experts, shared=_shared):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar float32).

    ``dropless=True`` sizes the expert buffers to hold every routed token
    (C = T): the decode path, where T = batch is small. Training and
    prefill keep GShard capacity semantics (C = T k / E x capacity_factor).
    ``experts(p, eb, cfg)`` runs the (E, C, d) expert buffers and
    ``shared(p, xf)`` the shared expert of the (T, d) tokens (the rank
    step's own, across ranks).
    """
    m: MoEConfig = cfg.moe
    B, S, d = x.shape
    E = m.n_experts
    T = B * S
    xf = x.reshape(T, d)
    dev = x.device

    probs, gate_vals, gate_idx = route(p, xf, m)
    aux = _aux(probs, gate_idx, m)

    # ---- sort-based capacity dispatch ----
    C = capacity(T, m, dropless)
    order, se, st, keep, slot = dispatch(gate_idx, E, C)
    sw = gate_vals.reshape(-1)[order]

    # gather tokens into expert buffers (E*C+1 rows; the last is trash,
    # where every dropped pair writes the same zeros)
    zero = torch.zeros((), dtype=x.dtype, device=dev)
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=dev)
    buf = buf.index_copy(0, slot, torch.where(keep[:, None], xf[st], zero))
    eb = buf[:E * C].reshape(E, C, d)

    # ---- expert computation (one batched product over experts) ----
    y = experts(p, eb, cfg).reshape(E * C, d)

    # ---- combine back to token order ----
    # index_add_ may add a token's contributions in any order (atomics on
    # the card). Each token has k <= 2 nonzero addends on top of 0, and
    # 0 + a + b rounds to the same value as 0 + b + a, so for top-1 and
    # top-2 the sum cannot depend on the order.
    contrib = torch.where(
        keep[:, None], sw[:, None].to(x.dtype) * y[slot.clamp(0, E * C - 1)],
        zero)
    out = torch.zeros((T, d), dtype=x.dtype, device=dev).index_add_(
        0, st, contrib)

    if m.shared_expert:
        out = out + shared(p, xf)

    return out.reshape(B, S, d), aux


def _ep_eligible(cfg, mesh) -> bool:
    return (mesh is not None and not mesh.empty
            and "data" in mesh.axis_names
            and cfg.moe.n_experts % mesh.shape["data"] == 0
            and cfg.d_ff % max(mesh.shape.get("model", 1), 1) == 0)


def moe_forward_ep(p: dict, x, cfg: TransformerConfig, *,
                   dropless: bool = False, mesh=None):
    """Expert-parallel MoE block over ``mesh`` (default: the ambient one,
    :func:`repro_torch.launch.mesh.current_mesh`). x: (B, S, d), its
    batch split over the mesh's batch axes (``pod`` x ``data``, row-major)
    as the twin's ``shard_map`` splits it. Falls back to
    :func:`moe_forward` with no mesh, or where ``E`` does not divide over
    ``data`` or ``d_ff`` over ``model``.

    Per batch-shard row: the router over its ``T = B_row S`` tokens, a
    local capacity ``C`` (``T`` when dropless), the row's sorted pairs in
    an ``(E C, d)`` send buffer. Within a pod, row ``j`` receives every
    row's buffer for its experts ``j epr .. (j + 1) epr - 1`` (``epr = E /
    n_data``), runs them, and sends each row its results back. The aux
    loss is the mean of the rows' (the twin's ``pmean`` over ``data``),
    pod 0's where there are pods; its gradient there is the mean's over
    the rows of every pod, as the twin's."""
    if mesh is None:
        from repro_torch.launch.mesh import current_mesh
        mesh = current_mesh()
    if not _ep_eligible(cfg, mesh):
        return moe_forward(p, x, cfg, dropless=dropless)
    m: MoEConfig = cfg.moe
    E = m.n_experts
    n_ed = mesh.shape["data"]
    n_pod = mesh.shape.get("pod", 1)
    epr = E // n_ed                       # experts per data row
    B, S, d = x.shape
    if B % (n_pod * n_ed) != 0:
        raise ValueError(f"batch {B} does not split over {n_pod * n_ed} "
                         f"batch-shard rows")
    Bl = B // (n_pod * n_ed)
    T = Bl * S
    dev = x.device
    C = capacity(T, m, dropless)
    zero = torch.zeros((), dtype=x.dtype, device=dev)

    # ---- per row: route, dispatch into its send buffer ----
    rows = []   # (xf, st, sw, keep, slot, aux) a row, pod-major
    sends = []
    for r in range(n_pod * n_ed):
        xf = x[r * Bl:(r + 1) * Bl].reshape(T, d)
        probs, gate_vals, gate_idx = route(p, xf, m)
        aux = _aux(probs, gate_idx, m)
        order, se, st, keep, slot = dispatch(gate_idx, E, C)
        sw = gate_vals.reshape(-1)[order]
        send = torch.zeros((E * C + 1, d), dtype=x.dtype, device=dev)
        send = send.index_copy(0, slot,
                               torch.where(keep[:, None], xf[st], zero))
        sends.append(send[:E * C])
        rows.append((xf, st, sw, keep, slot, aux))

    # ---- the all-to-all out: (pod, src, dst, epr C, d) -> each data
    # row's experts over (src, C) rows: (pod, E, n_ed C, d) ----
    send = torch.stack(sends).reshape(n_pod, n_ed, n_ed, epr, C, d)
    eb = send.permute(0, 2, 3, 1, 4, 5).reshape(n_pod, E, n_ed * C, d)

    # ---- the experts: row j holds experts j epr .. (j + 1) epr - 1,
    # so expert e of the stacked weights meets expert e's rows ----
    y = torch.stack([_experts(p, eb[i], cfg) for i in range(n_pod)])

    # ---- route back: (pod, dst, epr, src, C, d) -> (pod, src, E C, d) ----
    back = (y.reshape(n_pod, n_ed, epr, n_ed, C, d)
            .permute(0, 3, 1, 2, 4, 5).reshape(n_pod * n_ed, E * C, d))

    outs, auxs = [], []
    for r, (xf, st, sw, keep, slot, aux) in enumerate(rows):
        contrib = torch.where(
            keep[:, None],
            sw[:, None].to(x.dtype) * back[r][slot.clamp(0, E * C - 1)],
            zero)
        out = torch.zeros((T, d), dtype=x.dtype, device=dev).index_add_(
            0, st, contrib)
        if m.shared_expert:
            out = out + _shared(p, xf)
        outs.append(out.reshape(Bl, S, d))
        auxs.append(aux)
    aux = torch.mean(torch.stack(auxs[:n_ed]))
    if n_pod > 1:
        # the twin's aux leaves its shard_map replicated but unchecked:
        # its value is pod 0's mean over data, its gradient the mean's
        # over every row of every pod
        every = torch.mean(torch.stack(auxs))
        aux = aux.detach() + (every - every.detach())
    return torch.cat(outs), aux


# --------------------------------------------------------------------------
# Across ranks (the train step, one process a device)
# --------------------------------------------------------------------------

def _experts_tp(p, eb, cfg, groups):
    """:func:`_experts` on this rank's ``d_ff`` slice: the buffer enters
    with :func:`~repro_torch.distributed.process_group.copy_in`, the
    partial products leave summed over ``model``; whole experts on every
    rank where ``d_ff`` is not sharded."""
    if p["w_down"].shape[1] == cfg.d_ff:
        return _experts(p, eb, cfg)
    return pg.reduce_out(_experts(p, pg.copy_in(eb, groups), cfg), groups)


def _shared_tp(p, xf, cfg, groups):
    """:func:`_shared` on this rank's tokens, tensor-parallel over
    ``model`` where its ``d_ff`` is sharded."""
    if p["shared_w_down"].shape[0] == cfg.d_ff:
        return _shared(p, xf)
    return pg.reduce_out(_shared(p, pg.copy_in(xf, groups)), groups)


def moe_forward_rank(p: dict, shardings: dict, x, cfg: TransformerConfig,
                     *, plan, dropless: bool = False):
    """x: this rank's rows (B_local, S, d) -> (out (B_local, S, d), aux).
    ``p`` holds this rank's shards of the layer's MoE params and
    ``shardings`` their :class:`~repro_torch.distributed.partition.
    Sharding` (``plan``: the rank step's). ``aux`` is the microbatch's
    (without ``moe_ep``) or this data row's (with it; on a mesh with a
    pod axis its value is scaled so that pod 0's rows give the twin's
    loss).

    ``dropless`` (a decode step) sizes every expert's buffer to hold all
    of the tokens, so no token's routing depends on another's: the rank
    routes its own rows alone, as it does where every rank holds the
    whole batch (``plan.rows_split`` false)."""
    m: MoEConfig = cfg.moe
    groups = plan.groups
    spec = shardings["w_gate"].spec
    if spec and "model" in entry_axes(spec[0]):
        raise NotImplementedError(
            "the expert_parallel lever (experts over model) across ranks "
            "is ROADMAP Queue 1 item 12e-ii")
    n_ed, n_tp = groups.size("data"), groups.size("model")
    if cfg.moe_ep and m.n_experts % n_ed == 0 and cfg.d_ff % n_tp == 0:
        return _moe_ep_rank(p, shardings, x, cfg, plan)
    p = plan.fsdp(p, shardings)
    if dropless or not plan.rows_split:
        return moe_forward(
            p, x, cfg, dropless=dropless,
            experts=lambda p, eb, cfg: _experts_tp(p, eb, cfg, groups),
            shared=lambda p, xf: _shared_tp(p, xf, cfg, groups))
    Bl, S = x.shape[0], x.shape[1]
    j = plan.batch_index
    lo, Tl = j * Bl * S, Bl * S
    T = plan.dp * Tl

    def shared(p, xf):   # this rank's tokens only, zeros elsewhere
        own = _shared_tp(p, xf[lo:lo + Tl], cfg, groups)
        return torch.nn.functional.pad(own, (0, 0, lo, T - lo - Tl))

    out, aux = moe_forward(
        p, plan.gather_rows(x), cfg, shared=shared,
        experts=lambda p, eb, cfg: _experts_tp(p, eb, cfg, groups))
    return out[j * Bl:(j + 1) * Bl], aux


def _expert_rows(w, sh, groups, n_ed: int, epr: int):
    """This data row's ``epr`` experts of a stacked expert weight (E, ...)
    whose ``embed`` dim may be sharded over ``data``: one all-to-all
    trades the ``embed`` shards of every expert for every ``embed`` shard
    of this row's experts (its backward is the inverse exchange)."""
    dim = next((i for i, e in enumerate(sh.spec)
                if "data" in entry_axes(e)), None)
    j = groups.index("data")
    if dim is None:
        return w[j * epr:(j + 1) * epr]
    recv = pg.all_to_all(w.reshape((n_ed, epr) + tuple(w.shape[1:])),
                         groups, "data")
    # (src, epr, ..., embed shard, ...) -> (epr, ..., src x shard, ...)
    return torch.movedim(recv, 0, dim).flatten(dim, dim + 1)


def _moe_ep_rank(p, shardings, x, cfg, plan):
    """The twin's ``shard_map`` body on this rank: :func:`moe_forward` of
    its data row's own tokens under a local capacity, the expert buffers
    carried to their experts' row by one all-to-all over ``data`` and
    back by another, its ``E / n_data`` experts tensor-parallel over
    ``model``."""
    groups = plan.groups
    n_ed = groups.size("data")
    epr = cfg.moe.n_experts // n_ed
    w = {key: _expert_rows(p[key], shardings[key], groups, n_ed, epr)
         for key in ("w_gate", "w_up", "w_down") if key in p}

    def experts(p, eb, cfg):   # eb: (E, C, d) in expert order
        E, C, d = eb.shape
        recv = pg.all_to_all(eb.reshape(n_ed, epr * C, d), groups, "data")
        eb = (recv.reshape(n_ed, epr, C, d).transpose(0, 1)
              .reshape(epr, n_ed * C, d))
        y = _experts_tp(w, eb, cfg, groups)
        y = (y.reshape(epr, n_ed, C, d).transpose(0, 1)
             .reshape(n_ed, epr * C, d))
        return pg.all_to_all(y, groups, "data").reshape(E, C, d)

    def shared(p, xf):
        sp = {key: p[key] for key in p if key.startswith("shared_")}
        sp = plan.fsdp(sp, {key: shardings[key] for key in sp})
        return _shared_tp(sp, xf, cfg, groups)

    out, aux = moe_forward(p, x, cfg, experts=experts, shared=shared)
    n_pod = groups.size("pod")
    if n_pod > 1:
        # the loss takes aux / (n_pod n_data) from every rank: pod 0's
        # rows give the value (the twin's), every pod's the gradient
        # (see moe_forward_ep)
        scale = n_pod if groups.index("pod") == 0 else 0
        aux = aux.detach() * scale + (aux - aux.detach())
    return out, aux
