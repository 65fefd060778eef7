"""Paper Table IV — HW-vs-SW accuracy across hidden sizes x timestep grids.

Twin of ``benchmarks/table_iv_accuracy.py``. The paper's full grid is 5
hidden sizes x 4 train-T x 4 infer-T = 80 experiments. The default runs
the width sweep with (train_T, infer_T) = (25, 25), one experiment per
width, and ``--full`` runs the whole 80. Each cell trains on the card
(plain torch) and runs ``evaluate_dual``, whose hardware half launches the
``spike_timestep`` kernel once a timestep (backend ``cuda``, where the
twin's ``evaluate_dual`` defaults to ``reference``; every backend gives
the same bytes).

Reports software acc, hardware acc, deviation (the paper's headline:
-2.62 % average, shrinking with width). Without the IDX files under
``MNIST_DIR`` or ``data/mnist`` the digits are the procedural ones.

    PYTHONPATH=src python -m repro_torch.benchmarks.table_iv_accuracy [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.benchmarks.common import emit
from repro_torch.core.lif import LIFParams
from repro_torch.data import mnist
from repro_torch.device import resolve_device
from repro_torch.snn.model import SNNModelConfig
from repro_torch.snn.train import TrainConfig, evaluate_dual, train

HIDDEN_SIZES = (16, 32, 64, 128, 256)
T_GRID = (25, 50, 75, 100)


def cell_config(hidden: int, train_T: int, train_steps: int,
                seed: int = 0) -> TrainConfig:
    return TrainConfig(
        model=SNNModelConfig(layer_sizes=(784, hidden, 10),
                             params=LIFParams(decay_rate=0.1)),
        num_steps_time=train_T, lr=3e-3, batch_size=96,
        train_steps=train_steps, seed=seed)


def evaluate_cell(params, cfg: TrainConfig, infer_T: int, *, eval_n: int,
                  seed: int = 0, backend: str = "cuda",
                  device="cuda") -> dict:
    """``evaluate_dual`` of trained ``params`` on ``eval_n`` test digits
    (seed + 1), as one row of the table (``hw_counts`` kept beside it)."""
    x, y = mnist.load_or_generate("test", eval_n, seed=seed + 1)
    res = evaluate_dual(params, cfg.model, x, y, num_steps_time=infer_T,
                        backend=backend, device=device)
    return {
        "hidden": cfg.model.layer_sizes[1], "train_T": cfg.num_steps_time,
        "infer_T": infer_T,
        "software_acc": res["software_acc"],
        "hardware_acc": res["hardware_acc"],
        "deviation_pct": res["deviation_pct"],
        "agreement": res["agreement"],
        "hw_counts": res["hw_counts"],
    }


def run_cell(hidden: int, train_T: int, infer_T: int, *,
             train_steps: int, eval_n: int, seed: int = 0,
             device="cuda") -> dict:
    """Train one cell and evaluate it: the row of :func:`evaluate_cell`,
    with the trained ``params`` kept beside it (so a caller can hold the
    hardware half against another backend)."""
    dev = resolve_device(device)
    cfg = cell_config(hidden, train_T, train_steps, seed)
    data = mnist.batches("train", cfg.batch_size, cfg.train_steps, seed=seed)
    params, _, _ = train(cfg, data, log_every=0, device=dev)
    row = evaluate_cell(params, cfg, infer_T, eval_n=eval_n, seed=seed,
                        device=dev)
    return dict(row, params=params)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="run the paper's full 80-experiment grid")
    ap.add_argument("--train-steps", type=int, default=150)
    ap.add_argument("--eval-n", type=int, default=512)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    grid = ([(h, tt, it) for h in HIDDEN_SIZES for tt in T_GRID
             for it in T_GRID] if args.full
            else [(h, 25, 25) for h in HIDDEN_SIZES])

    rows, by_hidden = [], {}
    for h, tt, it in grid:
        r = run_cell(h, tt, it, train_steps=args.train_steps,
                     eval_n=args.eval_n, device=dev)
        rows.append(r)
        by_hidden.setdefault(h, []).append(r)
        emit(f"table_iv/h{h}_T{tt}x{it}", None,
             f"sw={r['software_acc']:.4f} hw={r['hardware_acc']:.4f} "
             f"dev={r['deviation_pct']:+.2f}pp agree={r['agreement']:.3f}")

    print()
    print("hidden,software_acc,hardware_acc,diff_pp,n_exp")
    devs = []
    for h in sorted(by_hidden):
        rs = by_hidden[h]
        sw = np.mean([r["software_acc"] for r in rs]) * 100
        hw = np.mean([r["hardware_acc"] for r in rs]) * 100
        print(f"{h},{sw:.2f},{hw:.2f},{hw - sw:+.2f},{len(rs)}")
        devs.append(hw - sw)
    print(f"overall_avg_deviation_pp,{np.mean(devs):+.2f}")
    print("paper_reference: -2.62pp avg; -5.72 @16 -> -0.63 @256")
    return rows


if __name__ == "__main__":
    main()
