"""Dry-run: one rank's step of every (arch x shape x mesh) cell, costed
on fake tensors.

Twin of :mod:`repro.launch.dryrun`. Run it as a module:

    python -m repro_torch.launch.dryrun [--arch A|all] [--shape S|all]
        [--mesh single|multi|both] [--expert-parallel] [--variant K=V,...]
        [--device cuda|cpu] [--out results/dryrun_torch.json]

The twin lowers and compiles GSPMD's per-device program of a step on 512
placeholder devices. The port's per-device program is the rank step
(:meth:`repro_torch.launch.steps.LMHarness.make_train_step`,
``make_prefill_step`` or ``make_decode_step`` on a rank mesh), and every
rank runs the same program on its own shards, so rank 0 stands for every
device, as GSPMD's one program does. For each cell
:func:`run_cell`

  1. joins the ``"fake"`` process group as rank 0 of the mesh's size
     (:func:`repro_torch.distributed.process_group.init_fake`):
     collectives return at once and move nothing;
  2. builds the axis groups (:func:`repro_torch.distributed.
     process_group.mesh_groups`) and the rank mesh over them;
  3. builds the step and the partitioner's shardings, outside the fake
     mode (the param shapes draw a key on the host);
  4. makes rank 0's shards of the params and of the optimizer state
     (train) or of the cache (decode; a prefill makes its own), by
     ``partition.shard_shape``, and the global batch or decode tokens,
     as fake tensors on ``--device`` (``cuda`` by default: fake CUDA
     tensors, which touch no card; the tests pass ``cpu``), and a
     decode step's position, an int: the last of the shape's context;
  5. runs one step under :func:`repro_torch.op_analysis.analyze_step`:
     flops, bytes, collectives and the live-storage peak;
  6. leaves the group.

It records the twin's fields (the memory peak, per-device flops and
bytes, collective bytes by kind, the roofline terms on the H100's
constants, :mod:`repro_torch.roofline`), with ``analyze_s`` in place of
``lower_s`` / ``compile_s`` (``groups_s`` of it builds the axis groups:
every rank's subgroup of every axis line, 320 of them on ``(2, 16,
16)``); prefill and decode cells record them
with ``n_micro`` 1. A cell's status is ``ok`` (it ran),
``skip`` (the twin's documented skip: long_500k on a full-attention
arch), ``not_ported`` (the rank step raises ROADMAP item 12e-ii's
refusal: the families other than dense GQA and MoE; query heads the
``model`` axis does not divide run, llama4-scout's 40 on 16) or
``fail``
(anything else: a bug, and the run exits 1). Records append to the
``--out`` file, which ``repro_torch.benchmarks.roofline`` reads.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, Shape
from repro_torch.distributed import partition as part
from repro_torch.distributed import process_group as pg
from repro_torch.launch.mesh import make_production_mesh, make_rank_mesh
from repro_torch.launch.steps import LMHarness, SkipCell
from repro_torch.op_analysis import analyze_step
from repro_torch.roofline import roofline_terms
from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["main", "run_cell"]

STATUSES = ("ok", "skip", "not_ported", "fail")
NOT_PORTED = "12e-ii"      # the ROADMAP item the rank step's refusals name


def _parse_variant(arch_id: str, variant: str | None, cfg=None):
    """``(cfg, harness_kw)`` of a §Perf variant, the twin's parsing:
    ``attn_tp`` and ``micro_rows`` go to the harness, every other key
    replaces a field of the config (``cfg``, or the arch's CONFIG)."""
    harness_kw, overrides = {}, {}
    for item in (variant or "").split(","):
        if not item:
            continue
        k, _, v = item.partition("=")
        val = (v == "" or v.lower() == "true") if v.lower() in (
            "", "true", "false") else (int(v) if v.isdigit() else v)
        if k in ("attn_tp", "micro_rows"):
            harness_kw[k] = val
        else:
            overrides[k] = val
    if overrides:
        cfg = dataclasses.replace(cfg or configs.get_arch(arch_id).CONFIG,
                                  **overrides)
    return cfg, harness_kw


def _rank_inputs(shape, shardings, like, device):
    """Rank 0's arguments of ``shape``'s step, as empty tensors: its
    shards of the params and of the optimizer state (train) or of the
    cache (decode), and the global batch or tokens (the rank step cuts
    its own rows); a decode step's position is an int, the last of the
    shape's context."""
    def shards(tree, sh):
        return unflatten(tree, [
            torch.empty(part.shard_shape(s, t.shape), dtype=t.dtype,
                        device=device)
            for t, s in zip(leaves(tree), leaves(sh))])

    def whole(tree):
        return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device=device), tree)

    if shape.kind == "train":
        (p_sh, o_sh, _), (p_like, o_like, b_like) = shardings, like
        return shards(p_like, p_sh), shards(o_like, o_sh), whole(b_like)
    if shape.kind == "prefill":
        (p_sh, _), (p_like, b_like) = shardings, like
        return shards(p_like, p_sh), whole(b_like)
    (p_sh, c_sh, _, _), (p_like, c_like, t_like, _) = shardings, like
    return (shards(p_like, p_sh), shards(c_like, c_sh), whole(t_like),
            shape.seq_len - 1)


def run_cell(arch_id: str, shape, *, multi_pod: bool = False,
             mesh: tuple | None = None, expert_parallel: bool = False,
             variant: str | None = None, cfg=None, device="cuda",
             verbose: bool = True) -> dict:
    """The record of one cell. ``shape`` is a name of ``SHAPES`` or a
    :class:`Shape`; ``mesh`` a ``(data, model)`` or ``(pod, data, model)``
    size in place of the production mesh; ``cfg`` a config in place of
    the arch's CONFIG (``variant`` overrides apply on top)."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    if mesh is None:
        lm = make_production_mesh(multi_pod=multi_pod)
        names, sizes = lm.axis_names, lm.sizes
        label = "multi_pod_2x16x16" if multi_pod else "single_pod_16x16"
    else:
        sizes = tuple(int(s) for s in mesh)
        names = ("pod", "data", "model")[-len(sizes):]
        label = "ranks_" + "x".join(map(str, sizes))
    n_chips = int(np.prod(sizes))
    cfg, harness_kw = _parse_variant(arch_id, variant, cfg)
    harness = LMHarness(arch_id, cfg=cfg, expert_parallel=expert_parallel,
                        **harness_kw)
    rec = {
        "arch": arch_id,
        "shape": shape.name,
        "mesh": label,
        "chips": n_chips,
        "kind": shape.kind,
        "expert_parallel": expert_parallel,
        "variant": variant,
        "status": "ok",
    }
    try:
        harness.check_cell(shape)
    except SkipCell as e:
        rec["status"] = "skip"
        rec["reason"] = str(e)
        return rec
    t0 = time.time()
    try:
        pg.init_fake(n_chips)
        try:
            t_groups = time.time()
            rmesh = make_rank_mesh(pg.mesh_groups(names, sizes, device))
            rec["groups_s"] = round(time.time() - t_groups, 3)
            step = harness.step_fn(shape, rmesh, shape.kind)
            in_sh, _, like = harness.shardings(shape, rmesh, shape.kind)
            with FakeTensorMode():
                args = _rank_inputs(shape, in_sh, like, device)
                _, cost = analyze_step(step, *args)
        finally:
            pg.shutdown()
        t_analyze = time.time() - t0
        n_micro = (harness.n_microbatches(shape, rmesh)
                   if shape.kind == "train" else 1)
        terms = roofline_terms(
            flops_per_device=cost.flops,
            bytes_per_device=cost.bytes_accessed,
            collective_bytes_per_device=cost.total_collective_bytes,
            cfg=harness.cfg, shape=shape, n_chips=n_chips, n_micro=n_micro)
        rec.update({
            "analyze_s": round(t_analyze, 1),
            "n_micro": n_micro,
            "memory": {
                "argument_bytes": cost.argument_bytes,
                "output_bytes": cost.output_bytes,
                "temp_bytes": cost.temp_bytes,
                "total_bytes": cost.total_bytes,
            },
            "cost": {
                "flops_per_device": cost.flops,
                "bytes_per_device": cost.bytes_accessed,
                "dot_flops": cost.dot_flops,
            },
            "collectives": {**cost.as_dict(),
                            "buffer_bytes_by_kind": dict(cost.buffer_bytes)},
            "roofline": terms,
        })
        if verbose:
            mem_gb = cost.total_bytes / 2**30
            print(f"  ok  mem={mem_gb:6.2f} GiB/dev  "
                  f"compute={terms['compute_s']:.3e}s "
                  f"memory={terms['memory_s']:.3e}s "
                  f"collective={terms['collective_s']:.3e}s "
                  f"dominant={terms['dominant']} "
                  f"(analyze {t_analyze:.0f}s)", flush=True)
    except Exception as e:
        if isinstance(e, NotImplementedError) and NOT_PORTED in str(e):
            rec["status"] = "not_ported"
            rec["reason"] = str(e)
            if verbose:
                print(f"  not_ported {str(e)[:200]}", flush=True)
            return rec
        # anything else is a bug in the system
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        if verbose:
            print(f"  FAIL {type(e).__name__}: {str(e)[:200]}", flush=True)
    return rec


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all'")
    ap.add_argument("--shape", default="all",
                    help="shape name or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--expert-parallel", action="store_true")
    ap.add_argument("--variant", default=None,
                    help="comma-separated TransformerConfig overrides for "
                         "§Perf variants, e.g. 'micro_rows=16'")
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device: cuda (default; no card "
                         "is touched) or cpu")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    args = ap.parse_args(argv)

    archs = configs.list_archs() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    records = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            records = json.load(f)

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = (arch, shape, mp, args.expert_parallel, args.variant)
                print(f"[dryrun] {arch} x {shape} x "
                      f"{'multi' if mp else 'single'}"
                      f"{' EP' if args.expert_parallel else ''}"
                      f"{' [' + args.variant + ']' if args.variant else ''}",
                      flush=True)
                rec = run_cell(arch, shape, multi_pod=mp,
                               expert_parallel=args.expert_parallel,
                               variant=args.variant, device=args.device)
                records = [r for r in records
                           if (r["arch"], r["shape"],
                               r["mesh"].startswith("multi"),
                               r.get("expert_parallel", False),
                               r.get("variant")) != key]
                records.append(rec)
                with open(args.out, "w") as f:
                    json.dump(records, f, indent=1)
    counts = {s: sum(r["status"] == s for r in records) for s in STATUSES}
    print(f"[dryrun] done: {counts['ok']} ok, {counts['skip']} skip, "
          f"{counts['not_ported']} not_ported, {counts['fail']} fail "
          f"-> {args.out}")
    if counts["fail"]:
        raise SystemExit(1)
    return records


if __name__ == "__main__":
    main()
