"""The LM train step across ranks on the cards: ``chip_smoke.py``'s phase 15.

    python scripts/torch_lm_ranks_calls.py [--world N] [--out FILE]

Starts ``N`` NCCL ranks, one process a card (default: ``min(4, visible
cards)``), on ``tcp://localhost:<free port>``, watches them and ends them
all when one fails (exit nonzero). Each rank runs, on the meshes its
world allows (4: ``(2, 2)`` and ``(4, 1)`` of ``("data", "model")`` and
``(2, 2, 1)`` and ``(2, 1, 2)`` of ``("pod", "data", "model")``; 2: ``(2,
1)`` and ``(1, 2)``; 1: ``(1, 1)`` and ``(1, 1, 1)``):

* granite-3-2b at full width cut to 2 layers and a mixtral-8x7b MoE
  layer (``moe_ep`` on) at full width, float32, one train step of
  ``LMHarness.make_train_step`` on the rank mesh; rank 0 gathers the new
  params and Adam's moments and holds them to the one-card logical step
  of the same mesh at the CPU tests' tolerances (on one rank: bit for
  bit);
* with 4 ranks, the same for query heads ``model`` does not divide
  (``PARTIAL``, the CPU tests' cuts at REDUCED width): llama4-scout at
  10 query and 2 K/V heads on ``(1, 4)`` and at 5 and 1 on ``(2, 2)``
  (``moe_ep`` off and on) and ``(2, 1, 2)``, 2.5 query heads and half a
  K/V head a rank as its 40 and 8 on 16 model ranks; granite-3-2b at
  ``(10, 2)`` and ``(10, 5)`` on ``(1, 4)``;
* with 4 ranks, granite-3-2b whole in bf16 on ``(4, 1)`` and on ``(2,
  2, 1)`` (the batch over ``(pod, data)``, every gradient leaf summed
  over ``pod``): B 8 x S 512,
  ``micro_rows`` 2, 4 steps and a fifth on the first batch (its loss
  must be below the first step's); per step the wall and CUDA-event ms,
  the NCCL bytes by kind (``process_group.BYTES``), per rank the memory
  peak of the sharded init and of the steps; rank 0's busy ms in a sixth
  step under ``torch.profiler``, the part of it in NCCL's kernels and
  that part by kernel (the all-reduces apart: on ``(2, 2, 1)`` nearly
  all of their bytes are the pod sum); then, once the ranks have ended, the
  launcher runs the dry-run of each cell (``repro_torch.launch.dryrun``:
  rank 0's step on fake CUDA tensors under the fake process group),
  whose collective calls and bytes by kind must equal every measured
  step's, and sets its live-storage peak beside the ranks' peaks.

Rank 0 writes the results as JSON to ``--out`` (default
``chiprun_out/lm_ranks.json``); the launcher prints them as its last
line. Needs CUDA cards.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]

CUT_B, CUT_S = 8, 64        # the float32 cases' batch and sequence
WHOLE_S, WHOLE_B = 512, 8   # granite-3-2b whole: phase 14's shape
WHOLE_MICRO_ROWS, WHOLE_STEPS = 2, 4
LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4
MESHES = {4: [(2, 2), (4, 1), (2, 2, 1), (2, 1, 2)], 2: [(2, 1), (1, 2)],
          1: [(1, 1), (1, 1, 1)]}
WHOLE_MESHES = [(4, 1), (2, 2, 1)]     # granite-3-2b whole, four ranks
# four ranks: query heads model does not divide, REDUCED width, float32
# (arch, (n_heads, n_kv_heads), moe_ep, mesh)
PARTIAL = [("llama4-scout-17b-a16e", (10, 2), False, (1, 4)),
           ("llama4-scout-17b-a16e", (5, 1), False, (2, 2)),
           ("llama4-scout-17b-a16e", (5, 1), True, (2, 2)),
           ("llama4-scout-17b-a16e", (5, 1), False, (2, 1, 2)),
           ("granite-3-2b", (10, 2), False, (1, 4)),
           ("granite-3-2b", (10, 5), False, (1, 4))]
TIMEOUT_S = 900


def launch(world: int, out: str, script: str = __file__,
           timeout_s: float = TIMEOUT_S) -> int:
    """Start the ranks of ``script`` (this file, or another script with
    the same ``--world`` / ``--out`` / ``--rank`` / ``--init-method``
    arguments); the first failure's exit code ends them all."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.distributed.process_group import free_port

    init = f"tcp://localhost:{free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               TORCH_NCCL_ASYNC_ERROR_HANDLING="1")
    procs = [subprocess.Popen(
        [sys.executable, script, "--world", str(world), "--out", out,
         "--rank", str(r), "--init-method", init], env=env)
        for r in range(world)]
    t0, failed = time.monotonic(), 0
    try:
        while any(p.poll() is None for p in procs):
            failed = next((p.returncode for p in procs
                           if p.returncode not in (None, 0)), 0)
            if failed or time.monotonic() - t0 > timeout_s:
                failed = failed or 124
                break
            time.sleep(0.1)
        failed = failed or next((p.returncode for p in procs
                                 if p.returncode), 0)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    return failed


def axis_names(mesh) -> tuple:
    """``("data", "model")``, or with a leading ``"pod"`` on three sizes."""
    return ("pod", "data", "model")[-len(mesh):]


def logical_mesh(sizes, dev):
    """The one-card logical mesh of a rank mesh's shape (the reference)."""
    from repro_torch.launch.mesh import LMMesh

    n = 1
    for size in sizes:
        n *= size
    return LMMesh(axis_names(sizes), tuple(sizes), (dev,) * n)


def cfg_of(configs, torch, arch, **change):
    return dataclasses.replace(configs.get_arch(arch).CONFIG,
                               dtype=torch.float32, **change)


CHUNK = 1 << 25             # elements a float64 check takes at once


def _chunks(*ts):
    flat = [t.reshape(-1) for t in ts]
    for i in range(0, flat[0].numel(), CHUNK):
        yield [f[i:i + CHUNK].double() for f in flat]


def worst_close(got, want) -> float:
    """``|got - want| / (GRAD_RTOL (|want| + max |want|))`` at its
    largest, in float64 on the card (``grads_close`` holds it <= 1)."""
    top = float(want.abs().max())
    return max(float(((g - w).abs() / (GRAD_RTOL * (w.abs() + top)
                                       + 1e-30)).max())
               for g, w in _chunks(got, want))


def worst_first_step(torch, got, want, m, lr) -> float:
    """A new param's distance from the reference over Adam's first-step
    bound of the gradient tolerance (``first_step_close``), at its
    largest, in float64 on the card."""
    g_top = float(m.abs().max()) / 0.1
    worst = 0.0
    for a, b, mm in _chunks(got, want, m):
        g = mm.abs() / 0.1
        delta = GRAD_RTOL * (g + g_top)
        bound = lr * torch.clamp_max(1e-8 * delta / (
            torch.clamp_min(g - delta, 0.0) + 1e-8) ** 2, 2.0) + (
                2.0 ** -23 * (1 + b.abs()))
        worst = max(worst, float(((a - b).abs() / bound).max()))
    return worst


def f32_case(np, torch, groups, arch, cfg, what) -> dict:
    """One float32 train step on the rank mesh; on rank 0 against the
    one-card logical mesh of the same shape (the ranks' results gathered
    to the host, then held to the reference leaf by leaf on the card)."""
    from repro_torch.configs.shapes import Shape
    from repro_torch.core import prng
    from repro_torch.data import lm
    from repro_torch.distributed import process_group as pg
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.launch.steps import LMHarness
    from repro_torch.tree import leaves

    mesh = make_rank_mesh(groups)
    dev = groups.device
    h = LMHarness(arch, cfg=cfg)
    shape = Shape("ranks", CUT_S, CUT_B, "train")
    (p_shard, _, _), _, _ = h.shardings(shape, mesh, "train")
    toks = torch.from_numpy(lm.TokenStream(cfg.vocab_size, seed=1).sample(
        CUT_B, CUT_S, 0).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    t0 = time.perf_counter()
    params = h.model.init(prng.key(1), device=dev,
                          shard=(p_shard, groups.rank))
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = h.make_train_step(shape, mesh)
    pg.reset_bytes()
    t0 = time.perf_counter()
    new, opt, met = step(params, h.opt.init(params), batch)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    nccl = dict(pg.BYTES)
    t0 = time.perf_counter()
    got = pg.gather_tree({"new": new, "m": opt["m"], "v": opt["v"]},
                         {"new": p_shard, "m": p_shard, "v": p_shard},
                         groups)
    gather_s = time.perf_counter() - t0
    loss, gnorm = float(met["loss"]), float(met["grad_norm"])
    del params, new, opt
    torch.cuda.empty_cache()
    out = {"what": what, "mesh": list(groups.sizes), "loss": loss,
           "grad_norm": gnorm, "wall_ms": wall, "nccl_bytes": nccl,
           "init_s": init_s, "gather_s": gather_s}
    if groups.rank != 0:
        return out
    # the reference: the one-card logical mesh of the same shape
    t0 = time.perf_counter()
    full = h.model.init(prng.key(1), device=dev)
    lmesh = logical_mesh(groups.sizes, dev)
    rnew, ropt, rmet = h.make_train_step(shape, lmesh)(
        full, h.opt.init(full), batch)
    del full
    rloss, rnorm = float(rmet["loss"]), float(rmet["grad_norm"])
    ref_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    worst = {"m": 0.0, "v": 0.0, "new": 0.0}
    equal = loss == rloss and gnorm == rnorm
    for have, want, m_want in zip(
            zip(leaves(got["new"]), leaves(got["m"]), leaves(got["v"])),
            zip(leaves(rnew), leaves(ropt["m"]), leaves(ropt["v"])),
            leaves(ropt["m"])):
        have = [t.to(dev) for t in have]
        equal = equal and all(torch.equal(a, b)
                              for a, b in zip(have, want))
        worst["new"] = max(worst["new"], worst_first_step(
            torch, have[0], want[0], m_want, h.lr))
        worst["m"] = max(worst["m"], worst_close(have[1], want[1]))
        worst["v"] = max(worst["v"], worst_close(have[2], want[2]))
        del have
    del rnew, ropt, got
    torch.cuda.empty_cache()
    out.update(ref_loss=rloss, ref_grad_norm=rnorm,
               loss_rel=abs(loss / rloss - 1), norm_rel=abs(gnorm / rnorm - 1),
               m_worst=worst["m"], v_worst=worst["v"],
               new_worst=worst["new"], bit_equal=bool(equal), ref_s=ref_s,
               compare_s=time.perf_counter() - t0)
    return out


def whole_case(np, torch, groups) -> dict:
    """granite-3-2b whole, bf16, on a four-rank mesh (``WHOLE_MESHES``)."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.configs.shapes import Shape
    from repro_torch.core import prng
    from repro_torch.data import lm
    from repro_torch.distributed import process_group as pg
    from repro_torch.launch.mesh import make_rank_mesh
    from repro_torch.launch.steps import LMHarness
    from repro_torch.tree import leaves

    mesh = make_rank_mesh(groups)
    dev = groups.device
    cfg = configs.get_arch("granite-3-2b").CONFIG
    h = LMHarness("granite-3-2b", cfg=cfg, micro_rows=WHOLE_MICRO_ROWS)
    shape = Shape("ranks_whole", WHOLE_S, WHOLE_B, "train")
    (p_shard, _, _), _, _ = h.shardings(shape, mesh, "train")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = h.model.init(prng.key(0), device=dev,
                          shard=(p_shard, groups.rank))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    opt_state = h.opt.init(params)
    step = h.make_train_step(shape, mesh)
    stream = lm.TokenStream(cfg.vocab_size, seed=0)
    steps = []
    for i in list(range(WHOLE_STEPS)) + [0]:
        toks = torch.from_numpy(stream.sample(WHOLE_B, WHOLE_S, i).astype(
            np.int32))
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        pg.reset_bytes()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        params, opt_state, met = step(params, opt_state, batch)
        end.record()
        torch.cuda.synchronize()
        steps.append({"loss": float(met["loss"]),
                      "grad_norm": float(met["grad_norm"]),
                      "wall_ms": (time.perf_counter() - t0) * 1e3,
                      "event_ms": start.elapsed_time(end),
                      "nccl_bytes": dict(pg.BYTES),
                      "nccl_calls": dict(pg.CALLS),
                      "nccl_axis_bytes": dict(pg.AXIS_BYTES)})
    peak = torch.cuda.max_memory_allocated(dev)
    # one more step under torch.profiler: the card's busy time, and the
    # share of it in NCCL's kernels
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        params, opt_state, _ = step(params, opt_state, batch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy_ms = sum(getattr(e, "device_time_total", 0) for e in events) / 1e3
    nccl = {e.key: getattr(e, "device_time_total", 0) / 1e3
            for e in events if "nccl" in e.key.lower()}
    nccl_ms = sum(nccl.values())
    local_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    peaks = [None] * groups.world
    dist.all_gather_object(peaks, peak)
    held = [None] * groups.world
    dist.all_gather_object(held, local_bytes)
    init_peaks = [None] * groups.world
    dist.all_gather_object(init_peaks, init_peak)
    del params, opt_state, step
    torch.cuda.empty_cache()
    return {"mesh": list(groups.sizes),
            "params": sum(t.numel() for t in leaves(h.param_shapes())),
            "n_micro": h.n_microbatches(shape, mesh), "init_s": init_s,
            "steps": steps[:WHOLE_STEPS],
            "first_batch_after": steps[-1]["loss"],
            "busy_ms": busy_ms, "nccl_busy_ms": nccl_ms,
            "nccl_ms_by_kernel": nccl,
            "peak_bytes": peaks, "param_shard_bytes": held,
            "init_peak_bytes": init_peaks}


def dryrun_whole(whole) -> dict:
    """The dry-run of ``whole_case``'s cell on its mesh: its collective
    calls and bytes by kind (``process_group``'s convention) must equal
    each measured step's; its peak goes beside the ranks'."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    rec = dryrun.run_cell(
        "granite-3-2b", Shape("ranks_whole", WHOLE_S, WHOLE_B, "train"),
        mesh=tuple(whole["mesh"]), variant=f"micro_rows={WHOLE_MICRO_ROWS}",
        device="cuda", verbose=False)
    if rec["status"] != "ok":
        raise SystemExit(f"the dry-run of the whole cell: {rec}")
    col = rec["collectives"]
    calls = {k.replace("-", "_"): v for k, v in col["counts"].items()}
    nbytes = {k.replace("-", "_"): v
              for k, v in col["buffer_bytes_by_kind"].items()}
    for i, step in enumerate(whole["steps"]):
        if step["nccl_calls"] != calls or step["nccl_bytes"] != nbytes:
            raise SystemExit(
                f"{whole['mesh']} step {i}: the ranks counted "
                f"{step['nccl_calls']} calls, "
                f"{step['nccl_bytes']} bytes; the dry-run {calls}, {nbytes}")
    return {"calls": calls, "bytes": nbytes, "memory": rec["memory"],
            "cost": rec["cost"], "roofline": rec["roofline"],
            "peak_over_measured": [rec["memory"]["total_bytes"] / b
                                   for b in whole["peak_bytes"]],
            "seconds": time.perf_counter() - t0}


def rank_main(args) -> None:
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.distributed import process_group as pg

    def case(*args):
        """``f32_case`` with its seconds on this rank (rank 0's include
        the one-card reference)."""
        t1 = time.perf_counter()
        rec = f32_case(np, torch, *args)
        rec["seconds"] = time.perf_counter() - t1
        return rec

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = args.world
    dev = torch.device("cuda", args.rank)
    meshes = MESHES[world]
    partial = PARTIAL if world == 4 else []
    groups = {meshes[0]: pg.init_ranks(
        axis_names(meshes[0]), meshes[0], rank=args.rank,
        init_method=args.init_method, device=dev, timeout_s=TIMEOUT_S)}
    for m in meshes[1:] + [c[3] for c in partial]:
        if m not in groups:
            groups[m] = pg.mesh_groups(axis_names(m), m, dev,
                                       timeout_s=TIMEOUT_S)
    cases = []
    t0 = time.perf_counter()
    try:
        for m in meshes:
            g = groups[m]
            cases.append(case(g, "granite-3-2b", cfg_of(
                configs, torch, "granite-3-2b", n_layers=2),
                "granite-3-2b f32 2-layer cut"))
            cases.append(case(g, "mixtral-8x7b", cfg_of(
                configs, torch, "mixtral-8x7b", n_layers=1, moe_ep=True),
                "mixtral-8x7b f32 MoE layer, moe_ep"))
        for arch, (H, KV), ep, m in partial:
            cfg = dataclasses.replace(
                configs.get_arch(arch).REDUCED, dtype=torch.float32,
                n_heads=H, n_kv_heads=KV, moe_ep=ep)
            cases.append(case(
                groups[m], arch, cfg, f"{arch} f32 REDUCED, "
                f"{H} query / {KV} K/V heads" + (", moe_ep" if ep else "")))
        wholes = ([whole_case(np, torch, groups[m]) for m in WHOLE_MESHES]
                  if world == 4 else [None, None])
    finally:
        pg.shutdown()
    if args.rank == 0:
        res = {"world": world, "meshes": [list(m) for m in meshes],
               "cases": cases, "whole": wholes[0],
               "whole_pod": wholes[1],
               "seconds": time.perf_counter() - t0,
               "card": torch.cuda.get_device_name(0)}
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(res))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" /
                                         "lm_ranks.json"))
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
    rc = launch(world, args.out)
    if rc:
        raise SystemExit(f"a rank failed (exit {rc}); all {world} ended")
    res = json.loads(pathlib.Path(args.out).read_text())
    if res["whole"] is not None:
        res["dryrun"] = dryrun_whole(res["whole"])
        res["dryrun_pod"] = dryrun_whole(res["whole_pod"])
        pathlib.Path(args.out).write_text(json.dumps(res))
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
