"""Paper Table V — component-level power breakdown on an MNIST workload.

Twin of ``benchmarks/table_v_power.py``. Runs the bit-exact Cerebra-H
model on rate-coded procedural-MNIST inference (on the card through the
``spike_timestep`` kernel, backend ``cuda`` by default), collects true
event counts (SOPs, SRAM row fetches, NoC packets, cycles), and evaluates
the calibrated energy model. The headline: the weight-memory subsystem
dominates total power (~96 %) while the compute path runs at 1.05
pJ/SOP.

``--measured-sop`` sources the event counts from the spike-trace recorder
(``events.trace.measured_counts``), counted from the real rasters, and
prints both accountings side by side. The measured SOPs price each event
by its float-nonzero synapses (``program.fanout``), as the twin does, so
synapses whose weight quantizes to 0 still count (ROADMAP Queue 3 fault
7, mirrored on purpose).

    PYTHONPATH=src python -m repro_torch.benchmarks.table_v_power [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.benchmarks.common import emit
from repro_torch.core import cerebra_h, coding, energy, prng
from repro_torch.core.engine import BACKENDS
from repro_torch.core.lif import LIFParams
from repro_torch.data import mnist
from repro_torch.device import resolve_device
from repro_torch.events import trace
from repro_torch.snn.model import SNNModelConfig, init_params, to_snnetwork

_COUNTS = ("spikes", "cycles", "sops", "row_fetches")


def model_config(hidden: int) -> SNNModelConfig:
    """The twin's 784-hidden-10 net with a 0.25 decay."""
    return SNNModelConfig(layer_sizes=(784, hidden, 10),
                          params=LIFParams(decay_rate=0.25))


def report(params, cfg: SNNModelConfig, spikes, *, measured_sop: bool,
           backend: str = "cuda", device="cuda") -> dict:
    """The table for trained or drawn ``params`` on the (T, B, 784) int32
    ``spikes``: the run, its counts (measured ones with
    ``measured_sop``) and the energy model's rows. Returns {'mw', 'uj',
    'counts', 'analytic', 'deltas'}."""
    dev = resolve_device(device)
    net = to_snnetwork(params, cfg)
    prog = cerebra_h.compile_network(net)
    out = cerebra_h.run(prog, spikes.to(dev), backend=backend, device=dev)
    out = {k: out[k].cpu() for k in _COUNTS}
    counts = analytic = energy.counts_from_run(out)
    deltas = {}
    if measured_sop:
        counts = trace.measured_counts(prog, spikes, out["spikes"])
        for field in ("sops", "row_fetches"):
            m, a = getattr(counts, field), getattr(analytic, field)
            deltas[field] = delta = 100 * (m - a) / max(a, 1.0)
            emit(f"table_v/{field}_measured_vs_analytic", None,
                 f"measured {m:.3e} vs analytic {a:.3e} "
                 f"({delta:+.2f}% delta)")
        rep = trace.trace_run(cerebra_h.make_engine(prog, backend,
                                                    device=dev),
                              spikes, out["spikes"])
        emit("table_v/gated_weight_traffic", None,
             f"per-example gate {100 * rep.traffic_ratio('per-example'):.1f}%"
             f" of dense blocks (batch-tile "
             f"{100 * rep.traffic_ratio('batch-tile'):.1f}%), source "
             f"sparsity {100 * rep.source_sparsity:.2f}%")

    model = energy.EnergyModel.calibrated()
    mw = model.breakdown_mw(counts)
    uj = model.energy_uj(counts)

    emit("table_v/sops", None, f"{counts.sops:.3e}")
    emit("table_v/row_fetches", None, f"{counts.row_fetches:.3e}")
    emit("table_v/cycles", None, f"{counts.cycles:.3e}")
    print()
    print("subsystem,power_mw,pct,paper_mw")
    paper = energy.TABLE_V
    for k in ("weight_memory_mw", "neuron_clusters_mw", "spike_paths_mw",
              "data_control_paths_mw"):
        print(f"{k},{mw[k]:.2f},{100 * mw[k] / mw['total_mw']:.2f},"
              f"{paper[k]:.2f}")
    print(f"total,{mw['total_mw']:.2f},100.00,{paper['total_mw']:.2f}")
    print(f"weight_memory_dominance_pct,{mw['weight_memory_pct']:.2f},"
          f",95.97")
    print(f"compute_pj_per_sop,{mw['compute_pj_per_sop']:.2f},,1.05")
    print(f"system_pj_per_sop,{uj['pj_per_sop_system']:.1f},,")
    return {"mw": mw, "uj": uj, "counts": counts, "analytic": analytic,
            "deltas": deltas}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--measured-sop", action="store_true",
                    help="use event counts measured from the real rasters "
                         "(events.trace) for the energy rows, and print "
                         "them next to the analytic cost-model counts")
    ap.add_argument("--backend", choices=BACKENDS, default="cuda",
                    help="SpikeEngine backend of the Cerebra-H run (the "
                         "kernel backend cuda by default)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = model_config(args.hidden)
    params = init_params(prng.key(0), cfg, device=dev)
    x, _ = mnist.load_or_generate("test", args.batch, seed=0)
    spikes = coding.poisson_encode(prng.key(1), torch.from_numpy(x).to(dev),
                                   args.steps, dtype=torch.int32)
    return report(params, cfg, spikes, measured_sop=args.measured_sop,
                  backend=args.backend, device=dev)


if __name__ == "__main__":
    main()
