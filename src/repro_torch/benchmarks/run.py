"""Benchmark orchestrator — one section per paper table/figure.

Twin of ``benchmarks/run.py``:

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--fast] [--full-grid] [--device cpu]

Emits ``name,us_per_call,derived`` CSV lines per benchmark plus the
formatted tables. Sections (default: all six):

  table_iv   — HW-vs-SW accuracy grid (paper Table IV)
  table_v    — power breakdown on an MNIST workload (paper Table V)
  table_iii  — systems comparison (paper Table III)
  speedup    — Cerebra-S vs Cerebra-H cycles + wall time (paper §VII-B)
  kernels    — the port's kernel bench (``benchmarks/kernel_bench``)
  roofline   — the LM dry-run's roofline table (``benchmarks/roofline``,
               reading ``results/dryrun_torch.json``)
"""

from __future__ import annotations

import argparse
import time

def _section(title: str) -> None:
    print(f"\n===== {title} =====", flush=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="reduced training budgets (CI-sized)")
    ap.add_argument("--full-grid", action="store_true",
                    help="run the paper's full 80-experiment Table IV grid")
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of sections")
    ap.add_argument("--backend", default=None,
                    help="SpikeEngine backend for the kernels/speedup "
                         "sections (reference | cuda | cuda-f32)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    only = set(args.only.split(",")) if args.only else None
    t0 = time.time()

    def want(name: str) -> bool:
        return only is None or name in only

    backend_args = ["--backend", args.backend] if args.backend else []
    device_args = ["--device", args.device]
    out = {}

    if want("kernels"):
        _section("kernels")
        from repro_torch.benchmarks import kernel_bench
        out["kernels"] = kernel_bench.main(backend_args + device_args)

    if want("table_v"):
        _section("table_v (power breakdown)")
        from repro_torch.benchmarks import table_v_power
        out["table_v"] = table_v_power.main(
            (["--steps", "50"] if args.fast else []) + device_args)

    if want("table_iii"):
        _section("table_iii (systems comparison)")
        from repro_torch.benchmarks import table_iii_comparison
        out["table_iii"] = table_iii_comparison.main([])

    if want("speedup"):
        _section("speedup (Cerebra-S vs Cerebra-H)")
        from repro_torch.benchmarks import speedup_s_vs_h
        out["speedup"] = speedup_s_vs_h.main(
            (["--steps", "25"] if args.fast else []) + backend_args
            + device_args)

    if want("table_iv"):
        _section("table_iv (accuracy grid)")
        from repro_torch.benchmarks import table_iv_accuracy
        grid_args = []
        if args.full_grid:
            grid_args.append("--full")
        if args.fast:
            grid_args += ["--train-steps", "60", "--eval-n", "256"]
        out["table_iv"] = table_iv_accuracy.main(grid_args + device_args)

    if want("roofline"):
        _section("roofline (from dry-run artifacts)")
        from repro_torch.benchmarks import roofline
        out["roofline"] = roofline.main([])

    print(f"\n[benchmarks] done in {time.time() - t0:.0f}s", flush=True)
    return out


if __name__ == "__main__":
    main()
