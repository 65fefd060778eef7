"""§Roofline report — reads results/dryrun_torch.json, prints the table.

Twin of ``benchmarks/roofline.py``, on the port's dry-run
(:mod:`repro_torch.launch.dryrun`, H100 constants of
:mod:`repro_torch.roofline`). One row per (arch x shape x mesh): the
three roofline terms, the dominant bottleneck, MODEL_FLOPS / traced
FLOPs, the memory peak. A cell the rank step does not run yet
(``not_ported``, ROADMAP item 12e-ii) shows as the twin shows a skip,
with its reason.
"""

from __future__ import annotations

import argparse
import json
import os
from collections import Counter

_NO_TERMS = {"skip": "SKIP", "not_ported": "NOT_PORTED"}


def fmt_row(r: dict) -> str:
    if r["status"] in _NO_TERMS:
        return (f"{r['arch']},{r['shape']},{r['mesh']},"
                f"{_NO_TERMS[r['status']]},,,,,,,\"{r['reason'][:60]}\"")
    if r["status"] == "fail":
        return f"{r['arch']},{r['shape']},{r['mesh']},FAIL,,,,,,,"
    t = r["roofline"]
    mem_gb = r["memory"]["total_bytes"] / 2**30
    return (f"{r['arch']},{r['shape']},{r['mesh']},ok,"
            f"{t['compute_s']:.3e},{t['memory_s']:.3e},"
            f"{t['collective_s']:.3e},{t['dominant']},"
            f"{t['useful_flops_ratio']:.3f},{t['roofline_fraction']:.3f},"
            f"{mem_gb:.2f}")


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default="results/dryrun_torch.json")
    ap.add_argument("--mesh", default="all",
                    help="single_pod_16x16 | multi_pod_2x16x16 | all")
    args = ap.parse_args(argv)

    if not os.path.exists(args.results):
        print(f"# no dry-run results at {args.results}; run "
              f"`python -m repro_torch.launch.dryrun` first")
        return []
    with open(args.results) as f:
        recs = json.load(f)
    if args.mesh != "all":
        recs = [r for r in recs if r["mesh"] == args.mesh]
    recs.sort(key=lambda r: (r["arch"], r["shape"], r["mesh"]))

    print("arch,shape,mesh,status,compute_s,memory_s,collective_s,"
          "dominant,useful_flops_ratio,roofline_fraction,mem_gib_per_dev")
    for r in recs:
        print(fmt_row(r))

    ok = [r for r in recs if r["status"] == "ok"]
    doms = Counter(r["roofline"]["dominant"] for r in ok)
    print(f"# {len(ok)} ok cells; dominant terms: {dict(doms)}")
    worst = sorted(ok, key=lambda r: r["roofline"]["roofline_fraction"])[:5]
    print("# worst roofline fractions: "
          + "; ".join(f"{r['arch']}/{r['shape']}/{r['mesh'].split('_')[0]}"
                      f"={r['roofline']['roofline_fraction']:.3f}"
                      for r in worst))

    # §Perf variants (``dryrun --variant``, same file): baseline vs variant
    base = {(r["arch"], r["shape"], r["mesh"]): r for r in ok
            if not r.get("variant")}
    variants = [r for r in ok if r.get("variant")
                and (r["arch"], r["shape"], r["mesh"]) in base]
    if variants:
        print("\n# §Perf variants (baseline -> variant)")
        print("arch,shape,mesh,variant,bound_before_s,bound_after_s,"
              "delta_pct,gib_before,gib_after")
    for r in variants:
        b = base[(r["arch"], r["shape"], r["mesh"])]
        b0 = b["roofline"]["bound_s"]
        b1 = r["roofline"]["bound_s"]
        print(f"{r['arch']},{r['shape']},{r['mesh']},{r['variant']},"
              f"{b0:.3e},{b1:.3e},{100 * (b1 - b0) / b0:+.1f}%,"
              f"{b['memory']['total_bytes'] / 2**30:.1f},"
              f"{r['memory']['total_bytes'] / 2**30:.1f}")
    return recs


if __name__ == "__main__":
    main()
