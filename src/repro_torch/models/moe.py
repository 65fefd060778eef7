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
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import ieee_fp32_matmul
from repro_torch.models.common import (
    MoEConfig,
    TransformerConfig,
    dense_init,
    gelu,
    silu,
)

__all__ = ["init_moe", "moe_forward", "moe_forward_ep", "route",
           "capacity", "dispatch"]


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


def moe_forward(p: dict, x, cfg: TransformerConfig, *,
                dropless: bool = False):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar float32).

    ``dropless=True`` sizes the expert buffers to hold every routed token
    (C = T): the decode path, where T = batch is small. Training and
    prefill keep GShard capacity semantics (C = T k / E x capacity_factor).
    """
    m: MoEConfig = cfg.moe
    B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    T = B * S
    xf = x.reshape(T, d)
    dev = x.device

    probs, gate_vals, gate_idx = route(p, xf, m)

    # load-balance aux loss (Switch): E * sum_e f_e * P_e
    me = torch.mean(probs, dim=0)
    ce = torch.zeros((E,), dtype=torch.float32, device=dev).index_add_(
        0, gate_idx.reshape(-1),
        torch.ones((T * k,), dtype=torch.float32, device=dev)) / (T * k)
    aux = m.router_aux_weight * E * torch.sum(me * ce)

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
    if cfg.mlp_kind in ("swiglu", "geglu"):
        act = silu if cfg.mlp_kind == "swiglu" else gelu
        h = act(torch.bmm(eb, p["w_gate"].to(x.dtype)))
        h = h * torch.bmm(eb, p["w_up"].to(x.dtype))
    else:
        h = gelu(torch.bmm(eb, p["w_up"].to(x.dtype)))
    y = torch.bmm(h, p["w_down"].to(x.dtype)).reshape(E * C, d)

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
        hs = silu(xf @ p["shared_w_gate"].to(x.dtype)) * (
            xf @ p["shared_w_up"].to(x.dtype))
        out = out + hs @ p["shared_w_down"].to(x.dtype)

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
    pod 0's where there are pods."""
    if mesh is None:
        from repro_torch.launch.mesh import current_mesh
        mesh = current_mesh()
    if not _ep_eligible(cfg, mesh):
        return moe_forward(p, x, cfg, dropless=dropless)
    m: MoEConfig = cfg.moe
    E, k = m.n_experts, m.top_k
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
        me = torch.mean(probs, dim=0)
        ce = torch.zeros((E,), dtype=torch.float32, device=dev).index_add_(
            0, gate_idx.reshape(-1),
            torch.ones((T * k,), dtype=torch.float32, device=dev)) / (T * k)
        aux = m.router_aux_weight * E * torch.sum(me * ce)
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
    def experts(eb):
        if cfg.mlp_kind in ("swiglu", "geglu"):
            act = silu if cfg.mlp_kind == "swiglu" else gelu
            h = act(torch.bmm(eb, p["w_gate"].to(x.dtype)))
            h = h * torch.bmm(eb, p["w_up"].to(x.dtype))
        else:
            h = gelu(torch.bmm(eb, p["w_up"].to(x.dtype)))
        return torch.bmm(h, p["w_down"].to(x.dtype))

    y = torch.stack([experts(eb[i]) for i in range(n_pod)])

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
            hs = silu(xf @ p["shared_w_gate"].to(x.dtype)) * (
                xf @ p["shared_w_up"].to(x.dtype))
            out = out + hs @ p["shared_w_down"].to(x.dtype)
        outs.append(out.reshape(Bl, S, d))
        auxs.append(aux)
    aux = torch.mean(torch.stack(auxs[:n_ed]))
    return torch.cat(outs), aux
