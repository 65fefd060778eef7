"""Prefill and decode across ranks on the cards: ``chip_smoke.py``'s phase 17.

    python scripts/torch_lm_serve_ranks_calls.py [--world N] [--out FILE]

Starts ``N`` NCCL ranks, one process a card (default: ``min(4, visible
cards)``), on ``tcp://localhost:<free port>``, watches them and ends them
all when one fails (exit nonzero). Each rank runs, on the meshes its
world allows (4: ``(2, 2)``, ``(4, 1)`` and ``(1, 4)`` of ``("data",
"model")`` and ``(2, 2, 1)`` and ``(2, 1, 2)`` of ``("pod", "data",
"model")``; 2: ``(2, 1)`` and ``(1, 2)``; 1: ``(1, 1)`` and ``(1, 1,
1)``):

* granite-3-2b (2 layers), granite-20b (2 layers: MQA, GELU) and
  mixtral-8x7b (2 layers: MoE, window 4096) at full width in float32:
  ``LMHarness.make_prefill_step`` of B 4 x S 512 on the rank mesh, then 8
  ``make_decode_step`` steps teacher-forced on the greedy tokens of the
  one-card run, which rank 0 makes first on the logical mesh of the same
  shape and sends to every rank. Rank 0 holds the ranks to it: the
  prefill's logits and the rank-gathered cache within 1e-5 of each
  tensor's scale (``|got - want| <= 1e-5 (|want| + max |want|)``, as
  phase 15 holds Adam's moments: cuBLAS sums a float32 product in
  another order for another row count, so a rank's rows differ from the
  whole batch's in the last bits), ``slot_pos`` equal, the tokens equal
  wherever the one-card top-2 margin exceeds 1e-4; on one rank all of it
  bit for bit. Beside it, for the dense archs, the one-card prefill of
  the batch's first ``B / 2`` rows against its whole batch's: that
  spread alone;
* with 4 ranks, the same for query heads ``model`` does not divide
  (``PARTIAL``, the CPU tests' cuts at REDUCED width): llama4-scout at
  10 query and 2 K/V heads on ``(1, 4)`` and at 5 and 1 on ``(2, 2)``,
  granite-3-2b at ``(10, 2)`` and ``(10, 5)`` on ``(1, 4)``, on a ring
  of ``S + 8`` slots (over ``model``) and of ``S + 9`` (replicated);
* with 4 ranks, llama4-scout at its own widths (d_model 5120, head_dim
  128, d_ff 8192, 16 experts and the shared one, vocab 202048) with 10
  query and 2 K/V heads on ``(1, 4)``: each rank's ``wq`` / ``wk`` /
  ``wo`` shard is the ``(5120, 320)`` / ``(5120, 64)`` / ``(320, 5120)``
  a rank of ``(16, 16)`` holds, 2 of 48 layers, float32 (6.4 B params).
  ``SCOUT_B`` prompts of ``SCOUT_S`` tokens, then ``SCOUT_DEC`` decode
  steps teacher-forced on the one-card run's tokens, held to it as
  above, with the attention split over ``model`` and again under
  ``attn_tp=False`` (the attention weights replicated: the twin's lever
  for heads ``model`` does not divide). Per variant each decode step's
  wall and CUDA-event ms and NCCL calls and bytes by kind, rank 0's
  busy ms in one more decode step under ``torch.profiler`` and its NCCL
  part; the launcher then runs the dry-run of each variant's decode
  cell, whose calls and bytes must equal every measured step's;
* with 4 ranks, mixtral-8x7b whole (32 layers, 46.7 B params, bf16; no
  one card holds it) on ``(2, 2)``: the params drawn sharded, 8 prompts of
  512 tokens prefilled, then 32 greedy decode steps. Per rank the memory
  peak of the sharded init and of the serving, and the param shard
  bytes; the prefill's wall time; each decode step's wall and CUDA-event
  ms and NCCL calls and bytes by kind (``process_group.CALLS`` /
  ``BYTES``); tokens/s; rank 0's busy ms in one more decode step under
  ``torch.profiler``, and the part of it in NCCL's kernels; every token
  in the vocabulary and every logit finite. Then, once the ranks have
  ended, the launcher runs the dry-run of that decode cell
  (``repro_torch.launch.dryrun``: rank 0's step on fake CUDA tensors
  under the fake process group), whose collective calls and bytes by
  kind must equal every measured decode step's, and sets its
  live-storage peak beside the ranks' serving peaks.

Rank 0 writes the results as JSON to ``--out`` (default
``chiprun_out/lm_serve_ranks.json``); the launcher prints them as its
last line. Needs CUDA cards.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

CUT_B, CUT_S, CUT_DEC = 4, 512, 8      # the float32 cases
CUT_LAYERS = 2
WHOLE_ARCH = "mixtral-8x7b"
WHOLE_B, WHOLE_S, WHOLE_DEC = 8, 512, 32
TOL = 1e-5                  # logits and cache, of each tensor's scale
MARGIN = 1e-4               # tokens compared where the top-2 margin exceeds
MESHES = {4: [(2, 2), (4, 1), (1, 4), (2, 2, 1), (2, 1, 2)],
          2: [(2, 1), (1, 2)], 1: [(1, 1), (1, 1, 1)]}
# four ranks: query heads model does not divide, REDUCED width, float32
# (arch, (n_heads, n_kv_heads), mesh, ring slots past CUT_S + CUT_DEC)
PARTIAL = [("llama4-scout-17b-a16e", (10, 2), (1, 4), 0),
           ("llama4-scout-17b-a16e", (10, 2), (1, 4), 1),
           ("llama4-scout-17b-a16e", (5, 1), (2, 2), 0),
           ("granite-3-2b", (10, 2), (1, 4), 0),
           ("granite-3-2b", (10, 5), (1, 4), 0),
           ("granite-3-2b", (10, 5), (1, 4), 1)]
SCOUT = "llama4-scout-17b-a16e"       # at its own widths, on (1, 4)
SCOUT_HEADS, SCOUT_MESH = (10, 2), (1, 4)
SCOUT_B, SCOUT_S, SCOUT_DEC = 4, 512, 16
TIMEOUT_S = 1000


def percentile(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def margins(torch, logits):
    """The top-2 margin of each row of ``logits`` (B, V)."""
    top = torch.topk(logits.float(), 2, dim=-1).values
    return (top[:, 0] - top[:, 1])


def scaled_err(a, b) -> float:
    """``|a - b| / (TOL (|b| + max |b|))`` at its largest (<= 1 holds)."""
    a, b = a.double(), b.double()
    return float(((a - b).abs() / (TOL * (b.abs() + b.abs().max())
                                   + 1e-300)).max())


def one_card(torch, h, shape, dev, mesh_shape, batch, n_dec=CUT_DEC):
    """The reference on rank 0: the one-card logical mesh of the same
    shape, prefill then ``n_dec`` greedy decode steps through the
    model's own decode step (its logits give the margins). Returns the
    prefill's logits, the greedy tokens (B, n_dec + 1), their margins, the
    final cache and the largest difference of a prefill of the batch's
    first half from the whole batch's logits (dense archs: with MoE the
    half batch routes under another capacity)."""
    from repro_torch.configs.shapes import Shape
    from repro_torch.core import prng
    from repro_torch.launch.mesh import use_mesh
    from torch_lm_ranks_calls import logical_mesh

    lmesh = logical_mesh(mesh_shape, dev)
    params = h.model.init(prng.key(1), device=dev)
    B, S = batch["tokens"].shape
    logits, cache = h.make_prefill_step(
        Shape("serve", shape.seq_len, B, "prefill"), lmesh)(params, batch)
    spread = None   # MoE capacity counts the whole batch: no spread
    if h.cfg.moe is None:
        half, _ = h.make_prefill_step(
            Shape("serve", shape.seq_len, B // 2, "prefill"), lmesh)(
                params, {k: v[:B // 2] for k, v in batch.items()})
        spread = float((half - logits[:B // 2]).abs().max())
        del half
    toks, margs = [], []
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    with torch.inference_mode(), use_mesh(lmesh):
        for i in range(n_dec):
            toks.append(tok)
            step_logits, cache = h.model.decode_step(
                params, {"tokens": tok[:, None]}, S + i, cache)
            margs.append(margins(torch, step_logits[:, -1]))
            tok = torch.argmax(step_logits[:, -1], dim=-1).to(torch.int32)
    toks.append(tok)
    del params
    return (logits, torch.stack(toks, 1), torch.stack(margs, 1), cache,
            spread)


def cut_harness(torch, arch, heads=None, width="CONFIG", **kw):
    """The harness of a float32 cut: ``arch``'s CONFIG at ``CUT_LAYERS``
    layers, or its REDUCED config; ``heads`` sets ``(n_heads,
    n_kv_heads)``."""
    from repro_torch import configs
    from repro_torch.launch.steps import LMHarness

    change = dict(n_layers=CUT_LAYERS) if width == "CONFIG" else {}
    if heads is not None:
        change.update(n_heads=heads[0], n_kv_heads=heads[1])
    cfg = dataclasses.replace(getattr(configs.get_arch(arch), width),
                              dtype=torch.float32, **change)
    return LMHarness(arch, cfg=cfg, **kw)


def f32_case(np, torch, groups, h, what, *, B=CUT_B, S=CUT_S,
             n_dec=CUT_DEC, slots=0, ref=None, timed=False):
    """One float32 cut's prefill and ``n_dec`` decode steps on the rank
    mesh (a ring of ``S + n_dec + slots`` slots), against the one-card
    logical mesh of the same shape on rank 0 (``ref``: a reference of the
    same params, shape and tokens made before, else made here). With
    ``timed`` each decode step's wall and CUDA-event ms and NCCL calls
    and bytes, and rank 0's busy ms in one more step under
    ``torch.profiler``. Returns the record and, on rank 0, the
    reference. ``seconds``: the case's time on this rank (rank 0's with
    the reference)."""
    import torch.distributed as dist

    from repro_torch.configs.shapes import Shape
    from repro_torch.core import prng
    from repro_torch.data import lm
    from repro_torch.distributed import partition as part
    from repro_torch.distributed import process_group as pg
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.tree import leaves

    t_case = time.perf_counter()
    mesh = make_rank_mesh(groups)
    dev = groups.device
    T = S + n_dec + slots
    shape = Shape("serve", T, B, "decode")
    toks = torch.from_numpy(lm.TokenStream(h.cfg.vocab_size, seed=1).sample(
        B, S, 0).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    # rank 0's one-card run first; its greedy tokens go to every rank
    forced = torch.zeros((B, n_dec + 1), dtype=torch.int32, device=dev)
    if groups.rank == 0:
        if ref is None:
            ref = one_card(torch, h, shape, dev, groups.sizes,
                           {k: v.to(dev) for k, v in batch.items()}, n_dec)
        forced.copy_(ref[1])
    dist.broadcast(forced, src=0)
    torch.cuda.empty_cache()
    p_shard = part.params_partition(h.param_shapes(), mesh, h.rules(mesh))
    c_shard = part.cache_partition(h.cache_shapes(shape), mesh,
                                   h.rules(mesh))
    params = h.model.init(prng.key(1), device=dev,
                          shard=(p_shard, groups.rank))
    torch.cuda.synchronize()
    pg.reset_bytes()
    t0 = time.perf_counter()
    logits, cache = h.make_prefill_step(
        Shape("serve", T, B, "prefill"), mesh)(params, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_calls = dict(pg.CALLS)
    decode = h.make_decode_step(shape, mesh)
    got, walls, steps = [], [], []
    for i in range(n_dec):
        pg.reset_bytes()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        tok, cache = decode(params, cache, {"tokens": forced[:, i:i + 1]},
                            S + i)
        end.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        steps.append({"event_ms": start.elapsed_time(end),
                      "nccl_calls": dict(pg.CALLS),
                      "nccl_bytes": dict(pg.BYTES)})
        got.append(tok[:, 0])
    got = torch.stack(got, 1)
    out = {"what": what, "arch": h.arch_id, "mesh": list(groups.sizes),
           "layout": part.kv_layout(part.layer_shardings(c_shard)["k"]),
           "prefill_ms": prefill_ms, "decode_ms": walls,
           "prefill_calls": prefill_calls}
    if timed:
        # one more decode step under torch.profiler: the card's busy
        # time, and the share of it in NCCL's kernels
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            decode(params, cache, {"tokens": forced[:, n_dec - 1:n_dec]},
                   S + n_dec - 1)
            torch.cuda.synchronize()
        events = prof.key_averages()
        events_ms = [st["event_ms"] for st in steps]
        out.update(
            steps=steps, batch=B, prompt=S, attn_tp=h.attn_tp,
            decode_wall_ms_p50=percentile(walls, 0.5),
            decode_wall_ms_p95=percentile(walls, 0.95),
            decode_event_ms_p50=percentile(events_ms, 0.5),
            decode_event_ms_p95=percentile(events_ms, 0.95),
            busy_ms=sum(getattr(e, "device_time_total", 0)
                        for e in events) / 1e3,
            nccl_busy_ms=sum(getattr(e, "device_time_total", 0)
                             for e in events
                             if "nccl" in e.key.lower()) / 1e3,
            params=sum(t.numel() for t in leaves(h.param_shapes())),
            param_shard_bytes=sum(t.numel() * t.element_size()
                                  for t in leaves(params)))
    full = pg.gather_tree(cache, c_shard, groups)
    del params, cache
    torch.cuda.empty_cache()
    if groups.rank != 0:
        out["seconds"] = time.perf_counter() - t_case
        return out, None
    r_logits, r_toks, r_marg, r_cache, spread = ref
    want = r_toks[:, 1:]
    sure = r_marg > MARGIN
    logit_err = float((logits - r_logits).abs().max())
    logit_scaled = scaled_err(logits, r_logits)
    cache_err, cache_scaled, cache_top = {}, {}, {}
    bit = torch.equal(logits, r_logits)
    slot_pos_equal = torch.equal(full["slot_pos"].to(dev),
                                 r_cache["slot_pos"])
    for key in ("k", "v", "slot_pos"):
        a, b = full[key].to(dev), r_cache[key]
        bit = bit and torch.equal(a, b)
        if key != "slot_pos":
            cache_err[key] = float((a - b).abs().max())
            cache_scaled[key] = scaled_err(a, b)
            cache_top[key] = float(b.abs().max())
    out.update(
        logits_max_abs_err=logit_err, logits_max_abs=float(
            r_logits.abs().max()), logits_scaled_err=logit_scaled,
        logits_ok=logit_scaled <= 1.0, one_card_half_batch_err=spread,
        cache_max_abs_err=cache_err, cache_max_abs=cache_top,
        cache_scaled_err=cache_scaled,
        cache_ok=bool(slot_pos_equal and max(cache_scaled.values()) <= 1.0),
        tokens_compared=int(sure.sum()), tokens_total=int(sure.numel()),
        tokens_ok=bool(torch.equal(got[sure], want[sure])),
        tokens_equal_all=bool(torch.equal(got, want)),
        min_margin=float(r_marg.min()),
        bit_equal=bool(bit and torch.equal(got, want)),
        seconds=time.perf_counter() - t_case)
    del full
    torch.cuda.empty_cache()
    return out, ref


def scout_cases(np, torch, groups) -> list:
    """llama4-scout at its own widths, 10 query and 2 K/V heads, on the
    ``(1, 4)`` rank mesh: the attention split over ``model`` (2.5 query
    heads a rank, 3 computed), then under ``attn_tp=False``, both held
    to one one-card reference."""
    ref, out = None, []
    for attn_tp in (True, False):
        h = cut_harness(torch, SCOUT, SCOUT_HEADS, attn_tp=attn_tp)
        rec, ref = f32_case(
            np, torch, groups, h, f"{SCOUT} f32 at its widths, "
            f"{CUT_LAYERS} layers, 10 query / 2 K/V heads, attn_tp "
            f"{attn_tp}", B=SCOUT_B, S=SCOUT_S, n_dec=SCOUT_DEC, ref=ref,
            timed=True)
        out.append(rec)
    del ref
    torch.cuda.empty_cache()
    return out


def whole_case(np, torch, groups) -> dict:
    """mixtral-8x7b whole, bf16, on the (2, 2) rank mesh: 8 prompts of
    512 tokens, then ``WHOLE_DEC`` greedy decode steps."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.configs.shapes import Shape
    from repro_torch.core import prng
    from repro_torch.data import lm
    from repro_torch.distributed import partition as part
    from repro_torch.distributed import process_group as pg
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.launch.steps import LMHarness
    from repro_torch.tree import leaves

    mesh = make_rank_mesh(groups)
    dev = groups.device
    cfg = configs.get_arch(WHOLE_ARCH).CONFIG
    h = LMHarness(WHOLE_ARCH, cfg=cfg)
    T = WHOLE_S + WHOLE_DEC
    shape = Shape("serve_whole", T, WHOLE_B, "decode")
    p_shard = part.params_partition(h.param_shapes(), mesh, h.rules(mesh))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = h.model.init(prng.key(0), device=dev,
                          shard=(p_shard, groups.rank))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    toks = torch.from_numpy(lm.TokenStream(cfg.vocab_size, seed=0).sample(
        WHOLE_B, WHOLE_S, 0).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    pg.reset_bytes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = h.make_prefill_step(
        Shape("serve_whole", T, WHOLE_B, "prefill"), mesh)(params, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill = {"calls": dict(pg.CALLS), "bytes": dict(pg.BYTES)}
    finite = bool(torch.isfinite(logits).all())
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    decode = h.make_decode_step(shape, mesh)
    steps, out_toks = [], [tok]
    for i in range(WHOLE_DEC):
        pg.reset_bytes()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        tok, cache = decode(params, cache, {"tokens": tok}, WHOLE_S + i)
        end.record()
        torch.cuda.synchronize()
        steps.append({"wall_ms": (time.perf_counter() - t0) * 1e3,
                      "event_ms": start.elapsed_time(end),
                      "nccl_calls": dict(pg.CALLS),
                      "nccl_bytes": dict(pg.BYTES)})
        out_toks.append(tok)
    out_toks = torch.cat(out_toks, 1)
    in_vocab = bool(((out_toks >= 0) & (out_toks < cfg.vocab_size)).all())
    peak = torch.cuda.max_memory_allocated(dev)
    # one more decode step under torch.profiler: the card's busy time,
    # and the share of it in NCCL's kernels
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        decode(params, cache, {"tokens": tok}, WHOLE_S + WHOLE_DEC - 1)
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy_ms = sum(getattr(e, "device_time_total", 0) for e in events) / 1e3
    nccl_ms = sum(getattr(e, "device_time_total", 0) for e in events
                  if "nccl" in e.key.lower()) / 1e3
    local_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    cache_bytes = sum(t.numel() * t.element_size() for t in leaves(cache))
    gathered = {}
    for key, value in (("peak_bytes", peak), ("init_peak_bytes", init_peak),
                       ("param_shard_bytes", local_bytes),
                       ("cache_shard_bytes", cache_bytes)):
        gathered[key] = [None] * groups.world
        dist.all_gather_object(gathered[key], value)
    walls = [s["wall_ms"] for s in steps]
    events_ms = [s["event_ms"] for s in steps]
    n_new = WHOLE_B * WHOLE_DEC
    return {"arch": WHOLE_ARCH, "mesh": list(groups.sizes),
            "params": sum(t.numel() for t in leaves(h.param_shapes())),
            "batch": WHOLE_B, "prompt": WHOLE_S, "new": WHOLE_DEC,
            "init_s": init_s, "prefill_ms": prefill_ms, "prefill": prefill,
            "steps": steps,
            "decode_wall_ms_p50": percentile(walls, 0.5),
            "decode_wall_ms_p95": percentile(walls, 0.95),
            "decode_event_ms_p50": percentile(events_ms, 0.5),
            "decode_event_ms_p95": percentile(events_ms, 0.95),
            "decode_tokens_per_s": n_new / (sum(walls) / 1e3),
            "tokens_per_s": n_new / ((sum(walls) + prefill_ms) / 1e3),
            "busy_ms": busy_ms, "nccl_busy_ms": nccl_ms,
            "logits_finite": finite, "tokens_in_vocab": in_vocab,
            "tokens": out_toks[:2].tolist(), **gathered}


def dryrun_decode(arch, shape, mesh, steps, *, cfg=None,
                  variant=None) -> dict:
    """The dry-run of a decode cell (``repro_torch.launch.dryrun``: rank
    0's step on fake CUDA tensors under the fake process group): its
    collective calls and bytes by kind must equal each measured decode
    step's (``steps``)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    rec = dryrun.run_cell(arch, shape, mesh=mesh, cfg=cfg, variant=variant,
                          device="cuda", verbose=False)
    if rec["status"] != "ok":
        raise SystemExit(f"the dry-run of the {arch} decode cell: {rec}")
    col = rec["collectives"]
    calls = {k.replace("-", "_"): v for k, v in col["counts"].items()}
    nbytes = {k.replace("-", "_"): v
              for k, v in col["buffer_bytes_by_kind"].items()}
    for i, step in enumerate(steps):
        if step["nccl_calls"] != calls or step["nccl_bytes"] != nbytes:
            raise SystemExit(
                f"{arch} {variant or ''} decode step {i}: the ranks counted "
                f"{step['nccl_calls']} calls, {step['nccl_bytes']} bytes; "
                f"the dry-run {calls}, {nbytes}")
    return {"calls": calls, "bytes": nbytes, "memory": rec["memory"],
            "cost": rec["cost"], "roofline": rec["roofline"],
            "seconds": time.perf_counter() - t0}


def dryrun_whole(whole) -> dict:
    """The dry-run of ``whole_case``'s decode cell on ``(2, 2)``, held to
    every measured decode step; its peak goes beside the ranks' serving
    peaks."""
    from repro_torch.configs.shapes import Shape

    d = dryrun_decode(WHOLE_ARCH, Shape(
        "serve_whole", WHOLE_S + WHOLE_DEC, WHOLE_B, "decode"), (2, 2),
        whole["steps"])
    d["peak_over_measured"] = [d["memory"]["total_bytes"] / b
                               for b in whole["peak_bytes"]]
    return d


def dryrun_scout(torch, scout) -> list:
    """The dry-run of each of ``scout_cases``' decode cells (the split
    attention and ``attn_tp=False``), held to its measured steps."""
    from repro_torch.configs.shapes import Shape

    cfg = cut_harness(torch, SCOUT, SCOUT_HEADS).cfg
    return [dryrun_decode(
        SCOUT, Shape("serve", SCOUT_S + SCOUT_DEC, SCOUT_B, "decode"),
        SCOUT_MESH, rec["steps"], cfg=cfg,
        variant=None if rec["attn_tp"] else "attn_tp=false")
        for rec in scout]


def rank_main(args) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.distributed import process_group as pg
    from torch_lm_ranks_calls import axis_names

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = args.world
    dev = torch.device("cuda", args.rank)
    meshes = MESHES[world]
    groups = {meshes[0]: pg.init_ranks(
        axis_names(meshes[0]), meshes[0], rank=args.rank,
        init_method=args.init_method, device=dev, timeout_s=TIMEOUT_S)}
    for m in meshes[1:]:
        groups[m] = pg.mesh_groups(axis_names(m), m, dev,
                                   timeout_s=TIMEOUT_S)
    cases, scout = [], []
    t0 = time.perf_counter()
    try:
        for m in meshes:
            for arch, what in (
                    ("granite-3-2b", "granite-3-2b f32 2-layer cut"),
                    ("granite-20b", "granite-20b f32 2-layer cut (MQA)"),
                    ("mixtral-8x7b", "mixtral-8x7b f32 2-layer cut (MoE, "
                     "window 4096)")):
                cases.append(f32_case(np, torch, groups[m],
                                      cut_harness(torch, arch), what)[0])
        for arch, (H, KV), m, slots in (PARTIAL if world == 4 else []):
            cases.append(f32_case(
                np, torch, groups[m],
                cut_harness(torch, arch, (H, KV), width="REDUCED"),
                f"{arch} f32 REDUCED, {H} query / {KV} K/V heads",
                slots=slots)[0])
        if world == 4:
            scout = scout_cases(np, torch, groups[SCOUT_MESH])
        whole = (whole_case(np, torch, groups[(2, 2)]) if world == 4
                 else None)
    finally:
        pg.shutdown()
    if args.rank == 0:
        res = {"world": world, "meshes": [list(m) for m in meshes],
               "cases": cases, "scout": scout, "whole": whole,
               "seconds": time.perf_counter() - t0,
               "card": torch.cuda.get_device_name(0)}
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(res))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "lm_serve_ranks.json"))
    ap.add_argument("--rank", type=int, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--init-method", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        rank_main(args)
        return
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs CUDA cards")
    world = args.world or min(4, torch.cuda.device_count())
    if world not in MESHES or world > torch.cuda.device_count():
        raise SystemExit(f"--world {world}: 1, 2 or 4, at most the "
                         f"{torch.cuda.device_count()} visible cards")
    if os.path.exists(args.out):
        os.remove(args.out)
    sys.path.insert(0, str(ROOT / "scripts"))
    from torch_lm_ranks_calls import launch

    rc = launch(world, args.out, script=__file__, timeout_s=TIMEOUT_S)
    if rc:
        raise SystemExit(f"a rank failed (exit {rc}); all {world} ended")
    res = json.loads(pathlib.Path(args.out).read_text())
    if res["whole"] is not None:
        res["dryrun"] = dryrun_whole(res["whole"])
        res["scout_dryrun"] = dryrun_scout(torch, res["scout"])
        pathlib.Path(args.out).write_text(json.dumps(res))
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
