"""LM training on the card, piece by piece: ``--what phase14 | full | decode``.

* ``phase14``: ``chip_smoke.py``'s phase 14 alone (granite-3-2b trained
  whole, the float32 cut card vs host, ``moe_forward_ep`` at mixtral's
  width, the launcher's restart), printing its lines and its result.
* ``full``: ``python -m repro_torch.launch.train --arch granite-3-2b
  --full --steps 4 --log-every 1`` in this process, then the seconds of
  the run and the memory peak.
* ``decode``: one granite-3-2b B 4 bf16 decode step at position 48 of a
  96-slot cache, through ``LMHarness``'s prefill and decode steps of the
  ``repro_torch`` found under ``--src``: the first, second and third
  quartile of 41 synchronised walls (ms). Two trees are compared on one
  card by running it for each in turn (parent, change, ...), e.g. with
  the parent unpacked by ``git archive`` into ``build/parent``::

      python scripts/torch_lm_train_calls.py --what decode --src build/parent/src
      python scripts/torch_lm_train_calls.py --what decode

Needs a CUDA card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def decode_walls(np, torch) -> list:
    from repro_torch.configs.shapes import Shape
    from repro_torch.core import prng
    from repro_torch.launch.steps import LMHarness

    h = LMHarness("granite-3-2b")
    params = h.model.init(prng.key(0), device="cuda")
    shape = Shape("d", 96, 4, "decode")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, 49155, (4, 48)).astype(np.int32)).cuda()
    _, cache = h.make_prefill_step(shape, device="cuda")(
        params, {"tokens": toks})
    decode = h.make_decode_step(shape)
    tok = toks[:, -1:]
    for _ in range(3):
        decode(params, cache, {"tokens": tok}, 48)
    torch.cuda.synchronize()
    walls = []
    for _ in range(41):
        t = time.perf_counter()
        decode(params, cache, {"tokens": tok}, 48)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    return sorted(walls)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--what", choices=("phase14", "full", "decode"),
                    required=True)
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory whose repro_torch runs")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(pathlib.Path(args.src).resolve()), str(ROOT)]
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this script runs on the card")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    if args.what == "phase14":
        import chip_smoke

        torch.backends.cuda.matmul.allow_tf32 = False
        card = chip_smoke.phase_environment(torch)
        print(chip_smoke.phase_lm_train(np, torch, card), flush=True)
    elif args.what == "full":
        from repro_torch.launch import train

        t0 = time.perf_counter()
        train.main(["--arch", "granite-3-2b", "--full", "--steps", "4",
                    "--log-every", "1"])
        torch.cuda.synchronize()
        print(f"launch.train --full: 4 steps in "
              f"{time.perf_counter() - t0:.1f} s; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
    else:
        w = decode_walls(np, torch)
        print(f"{args.src} granite-3-2b B 4 decode step wall ms: q1 "
              f"{w[10]:.2f} median {w[20]:.2f} q3 {w[30]:.2f}", flush=True)


if __name__ == "__main__":
    main()
