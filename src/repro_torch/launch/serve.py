"""LM serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Twin of :mod:`repro.launch.serve`: brings up a BatchServer over the arch
registry and drives synthetic request traffic through the scheduler
(length-bucketed admission, batched prefill, fixed-slot greedy decode),
printing the twin's ``[serve]`` lines: tokens/s per batch and aggregate.
Runs on ``--device`` (default ``cuda``; ``cpu`` for the host).

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-12b --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b --full

Like the twin, it serves token-frontend archs only: qwen2-vl-2b (the
embeddings frontend) exits with the twin's message, and is driven through
``LMHarness``'s prefill and decode steps instead.

``main`` returns a summary (each batch's prompt lengths, tokens, tokens/s
and latency; the totals; the server, for callers that time its steps).
``request_plan`` and ``run`` are its traffic and its loop, for callers
that build their own server (a depth-cut model, say).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import configs
from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.launch.steps import LMHarness
from repro_torch.serving import BatchServer, Request, Scheduler


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b",
                    choices=configs.list_archs())
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=96)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    mod = configs.get_arch(args.arch)
    cfg = mod.CONFIG if args.full else mod.REDUCED
    if cfg.frontend != "tokens" or args.arch == "whisper-large-v3":
        raise SystemExit(f"{args.arch} needs a modality frontend; serve "
                         f"demo supports token-frontend archs")
    h = LMHarness(args.arch, cfg=cfg)
    t0 = time.perf_counter()
    params = h.model.init(prng.key(0), device=dev)
    init_s = time.perf_counter() - t0
    server = BatchServer(h.model, params, max_seq=args.max_seq, device=dev)
    out = run(server, request_plan(cfg.vocab_size, args.requests,
                                   args.max_seq, args.max_new),
              args.max_batch)
    return dict(out, init_s=init_s, server=server)


def request_plan(vocab_size: int, n: int, max_seq: int,
                 max_new: int) -> list[Request]:
    """The launcher's synthetic traffic: ``n`` requests, prompts of 4 ..
    ``max_seq - max_new - 2`` random tokens from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    reqs = []
    for uid in range(n):
        plen = int(rng.integers(4, max_seq - max_new - 1))
        prompt = rng.integers(1, vocab_size, plen).astype(np.int32)
        reqs.append(Request(uid=uid, prompt=prompt, max_new_tokens=max_new))
    return reqs


def run(server: BatchServer, requests: list[Request],
        max_batch: int) -> dict:
    """Serve ``requests`` through a ``Scheduler`` of ``max_batch``,
    printing the twin's ``[serve]`` lines; returns each batch's prompt
    lengths, tokens, latency and tokens/s, and the totals."""
    sched = Scheduler(max_batch=max_batch)
    for r in requests:
        sched.submit(r)
    total_tokens, batches, summary = 0, 0, []
    t0 = time.perf_counter()
    while True:
        batch = sched.next_batch()
        if not batch:
            break
        comps = server.serve(batch)
        stats = server.throughput_stats(comps)
        batches += 1
        total_tokens += stats["generated_tokens"]
        summary.append({"uids": [c.uid for c in comps],
                        "prompt_lens": [c.prompt_len for c in comps],
                        "tokens": [c.tokens for c in comps],
                        "latency_s": stats["wall_s"],
                        "tokens_per_s": stats["tokens_per_s"]})
        print(f"[serve] batch {batches}: {len(batch)} reqs "
              f"prompt_lens={[c.prompt_len for c in comps]} "
              f"-> {stats['generated_tokens']} toks "
              f"@ {stats['tokens_per_s']:.1f} tok/s")
    dt = time.perf_counter() - t0
    print(f"[serve] {len(requests)} requests, {total_tokens} tokens in "
          f"{dt:.1f}s ({total_tokens / dt:.1f} tok/s aggregate)")
    return {"batches": summary, "total_tokens": total_tokens, "wall_s": dt,
            "tokens_per_s": total_tokens / dt}

if __name__ == "__main__":
    main()
