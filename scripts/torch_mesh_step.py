"""Time one mesh step of the served slice for the port under ``--src``.

Runs ``chip_smoke.py``'s phase-8 timing (``phase_mesh_times``: one step of
the 8-slot slice unsharded and on 2 x 2 and 2 x 4 meshes of card 0, five
interleaved rounds of 50 steps, then a ``torch.profiler`` breakdown of the
host's work a step) against the ``repro_torch`` package found under
``--src``. Two commits are compared on one card by running it in one
session for each tree in turn (parent, change, change, parent), e.g. with
the parent unpacked by ``git archive`` into ``build/parent``::

    python scripts/torch_mesh_step.py --src build/parent/src --label parent
    python scripts/torch_mesh_step.py --label change

Prints one JSON line: the card, the package timed, and per shape the
rounds' wall and busy µs and the host breakdown. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--label", default="", help="a name for the JSON line")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(pathlib.Path(args.src).resolve()), str(ROOT)]
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this script times the card")
    import chip_smoke
    import repro_torch
    from repro_torch.configs import snap_v_snn as cfg
    from repro_torch.core.network import feedforward
    from repro_torch.core.session import AcceleratorSession

    card = chip_smoke.phase_environment(torch)
    times, host = chip_smoke.phase_mesh_times(np, torch, AcceleratorSession,
                                              feedforward, cfg)
    print(json.dumps({
        "label": args.label, "card": card,
        "package": str(pathlib.Path(repro_torch.__file__).parent),
        "steps": {what: {"wall_us": [w for _, w, _ in rounds],
                         "busy_us": [b for _, _, b in rounds],
                         "host": host[what]}
                  for what, rounds in times.items()}}), flush=True)


if __name__ == "__main__":
    main()
