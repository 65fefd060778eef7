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


def one_card(torch, h, shape, dev, mesh_shape, batch):
    """The reference on rank 0: the one-card logical mesh of the same
    shape, prefill then ``CUT_DEC`` greedy decode steps through the
    model's own decode step (its logits give the margins). Returns the
    prefill's logits, the greedy tokens (B, CUT_DEC), their margins, the
    final cache and the largest difference of a prefill of the batch's
    first half from the whole batch's logits (dense archs: with MoE the
    half batch routes under another capacity)."""
    from repro_torch.configs.shapes import Shape
    from repro_torch.core import prng
    from repro_torch.launch.mesh import use_mesh
    from torch_lm_ranks_calls import logical_mesh

    lmesh = logical_mesh(mesh_shape, dev)
    params = h.model.init(prng.key(1), device=dev)
    logits, cache = h.make_prefill_step(
        Shape("serve", shape.seq_len, CUT_B, "prefill"), lmesh)(params,
                                                                 batch)
    spread = None   # MoE capacity counts the whole batch: no spread
    if h.cfg.moe is None:
        half, _ = h.make_prefill_step(
            Shape("serve", shape.seq_len, CUT_B // 2, "prefill"), lmesh)(
                params, {k: v[:CUT_B // 2] for k, v in batch.items()})
        spread = float((half - logits[:CUT_B // 2]).abs().max())
        del half
    toks, margs = [], []
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    with torch.inference_mode(), use_mesh(lmesh):
        for i in range(CUT_DEC):
            toks.append(tok)
            step_logits, cache = h.model.decode_step(
                params, {"tokens": tok[:, None]}, CUT_S + i, cache)
            margs.append(margins(torch, step_logits[:, -1]))
            tok = torch.argmax(step_logits[:, -1], dim=-1).to(torch.int32)
    toks.append(tok)
    del params
    return (logits, torch.stack(toks, 1), torch.stack(margs, 1), cache,
            spread)


def f32_case(np, torch, groups, arch, what) -> dict:
    """One float32 cut's prefill and decode steps on the rank mesh,
    against the one-card logical mesh of the same shape on rank 0."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.configs.shapes import Shape
    from repro_torch.core import prng
    from repro_torch.data import lm
    from repro_torch.distributed import partition as part
    from repro_torch.distributed import process_group as pg
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.launch.steps import LMHarness

    mesh = make_rank_mesh(groups)
    dev = groups.device
    cfg = dataclasses.replace(configs.get_arch(arch).CONFIG,
                              dtype=torch.float32, n_layers=CUT_LAYERS)
    h = LMHarness(arch, cfg=cfg)
    T = CUT_S + CUT_DEC
    shape = Shape("serve", T, CUT_B, "decode")
    toks = torch.from_numpy(lm.TokenStream(cfg.vocab_size, seed=1).sample(
        CUT_B, CUT_S, 0).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    # rank 0's one-card run first; its greedy tokens go to every rank
    forced = torch.zeros((CUT_B, CUT_DEC + 1), dtype=torch.int32,
                         device=dev)
    ref = None
    if groups.rank == 0:
        ref = one_card(torch, h, shape, dev, groups.sizes,
                       {k: v.to(dev) for k, v in batch.items()})
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
        Shape("serve", T, CUT_B, "prefill"), mesh)(params, batch)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    prefill_calls = dict(pg.CALLS)
    decode = h.make_decode_step(shape, mesh)
    got, walls = [], []
    for i in range(CUT_DEC):
        t0 = time.perf_counter()
        tok, cache = decode(params, cache, {"tokens": forced[:, i:i + 1]},
                            CUT_S + i)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        got.append(tok[:, 0])
    got = torch.stack(got, 1)
    full = pg.gather_tree(cache, c_shard, groups)
    del params, cache
    torch.cuda.empty_cache()
    out = {"what": what, "arch": arch, "mesh": list(groups.sizes),
           "layout": part.kv_layout(part.layer_shardings(c_shard)["k"]),
           "prefill_ms": prefill_ms, "decode_ms": walls,
           "prefill_calls": prefill_calls}
    if groups.rank != 0:
        return out
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
        bit_equal=bool(bit and torch.equal(got, want)))
    del ref, full
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


def dryrun_whole(whole) -> dict:
    """The dry-run of ``whole_case``'s decode cell on ``(2, 2)``: its
    collective calls and bytes by kind must equal each measured decode
    step's; its peak goes beside the ranks' serving peaks."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    rec = dryrun.run_cell(
        WHOLE_ARCH, Shape("serve_whole", WHOLE_S + WHOLE_DEC, WHOLE_B,
                          "decode"), mesh=(2, 2), device="cuda",
        verbose=False)
    if rec["status"] != "ok":
        raise SystemExit(f"the dry-run of the whole decode cell: {rec}")
    col = rec["collectives"]
    calls = {k.replace("-", "_"): v for k, v in col["counts"].items()}
    nbytes = {k.replace("-", "_"): v
              for k, v in col["buffer_bytes_by_kind"].items()}
    for i, step in enumerate(whole["steps"]):
        if step["nccl_calls"] != calls or step["nccl_bytes"] != nbytes:
            raise SystemExit(
                f"decode step {i}: the ranks counted {step['nccl_calls']} "
                f"calls, {step['nccl_bytes']} bytes; the dry-run {calls}, "
                f"{nbytes}")
    return {"calls": calls, "bytes": nbytes, "memory": rec["memory"],
            "cost": rec["cost"], "roofline": rec["roofline"],
            "peak_over_measured": [rec["memory"]["total_bytes"] / b
                                   for b in whole["peak_bytes"]],
            "seconds": time.perf_counter() - t0}


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
    cases = []
    t0 = time.perf_counter()
    try:
        for m in meshes:
            for arch, what in (
                    ("granite-3-2b", "granite-3-2b f32 2-layer cut"),
                    ("granite-20b", "granite-20b f32 2-layer cut (MQA)"),
                    ("mixtral-8x7b", "mixtral-8x7b f32 2-layer cut (MoE, "
                     "window 4096)")):
                cases.append(f32_case(np, torch, groups[m], arch, what))
        whole = (whole_case(np, torch, groups[(2, 2)]) if world == 4
                 else None)
    finally:
        pg.shutdown()
    if args.rank == 0:
        res = {"world": world, "meshes": [list(m) for m in meshes],
               "cases": cases, "whole": whole,
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
        pathlib.Path(args.out).write_text(json.dumps(res))
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
