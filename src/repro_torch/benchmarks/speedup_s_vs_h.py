"""Paper §VII-B — Cerebra-S vs Cerebra-H speedup on the same workload.

Twin of ``benchmarks/speedup_s_vs_h.py``. The paper reports f_max 10.17
MHz (S) -> 96.24 MHz (H), a 9.46x clock improvement, PLUS the
architectural cycle reduction from parallel cluster groups + hierarchical
NoC. The same logical network runs through both cycle-accurate cost
models (on the card through the ``spike_timestep`` kernel: backend
``cuda`` by default, where the twin defaults to ``reference``; every
backend gives the same cycles), reporting cycles/timestep and wall time
at the synthesized clocks — the total speedup = clock x cycle gain.

    PYTHONPATH=src python -m repro_torch.benchmarks.speedup_s_vs_h [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.benchmarks.common import emit
from repro_torch.benchmarks.table_v_power import model_config
from repro_torch.core import cerebra_h, cerebra_s, coding, prng, timing
from repro_torch.core.engine import BACKENDS
from repro_torch.data import mnist
from repro_torch.device import resolve_device
from repro_torch.snn.model import init_params, to_snnetwork


def report(params, cfg, spikes, *, backend: str = "cuda",
           device="cuda") -> dict:
    """Both generations on the same ``spikes``. Returns {'report',
    'cycles_s', 'cycles_h'} (per-step cycle arrays, (T, B), on the
    host)."""
    dev = resolve_device(device)
    net = to_snnetwork(params, cfg)
    outS = cerebra_s.run(cerebra_s.compile_network(net), spikes.to(dev),
                         backend=backend, device=dev)
    outH = cerebra_h.run(cerebra_h.compile_network(net), spikes.to(dev),
                         backend=backend, device=dev)
    cs = outS["cycles"].cpu().numpy()
    ch = outH["cycles"].cpu().numpy()
    # per-image mean cycles per timestep
    cyc_s = np.asarray(cs, np.float64).mean()
    cyc_h = np.asarray(ch, np.float64).mean()
    rep = timing.speedup_report(cs.mean(axis=1), ch.mean(axis=1))

    emit("speedup/cycles_per_step_S", None, f"{cyc_s:.1f}")
    emit("speedup/cycles_per_step_H", None, f"{cyc_h:.1f}")
    emit("speedup/cycle_speedup", None, f"{rep.cycle_speedup:.2f}x")
    emit("speedup/clock_speedup", None,
         f"{rep.clock_speedup:.2f}x (paper: 9.46x)")
    emit("speedup/total_speedup", None, f"{rep.total_speedup:.2f}x")
    emit("speedup/time_per_inference_S_us", None,
         f"{rep.time_s_us / 1.0:.1f}")
    emit("speedup/time_per_inference_H_us", None,
         f"{rep.time_h_us / 1.0:.1f}")
    return {"report": rep, "cycles_s": cs, "cycles_h": ch}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--backend", choices=BACKENDS, default="cuda",
                    help="SpikeEngine backend for both generations")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = model_config(args.hidden)
    params = init_params(prng.key(0), cfg, device=dev)
    x, _ = mnist.load_or_generate("test", args.batch, seed=0)
    spikes = coding.poisson_encode(prng.key(1), torch.from_numpy(x).to(dev),
                                   args.steps, dtype=torch.int32)
    return report(params, cfg, spikes, backend=args.backend, device=dev)


if __name__ == "__main__":
    main()
