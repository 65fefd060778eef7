"""Paper Table III — Cerebra-H vs representative neuromorphic systems.

Twin of ``benchmarks/table_iii_comparison.py``. Literature rows are
constants from the paper; the SNAP-V row is *derived from the port's
models* (energy model + timing model), so any change to the reproduction
shows up here. As the paper notes, the comparison is not normalized for
technology node or memory style — context, not ranking.

    PYTHONPATH=src python -m repro_torch.benchmarks.table_iii_comparison
"""

from __future__ import annotations

from repro_torch.core import energy, timing

LITERATURE = [
    # name, tech, area_mm2, neurons, freq_mhz, power_w, pj_per_sop
    ("ODIN", "28nm FD-SOI", 0.086, 256, "75-100", None, 12.7),
    ("OpenSpike", "130nm", 33.3, 1024, 40, 0.225, None),
    ("TrueNorth", "28nm CMOS", 430, 1_000_000, 0.001, 0.065, 26.0),
    ("Loihi1", "14nm FinFET", 60, 131_000, None, None, 23.6),
    ("Loihi2", "Intel4", 31, 1_000_000, 1000, 1.55, 10.8),
    ("DYNAPs", "180nm CMOS", 43.79, 1024, None, None, 26.0),
    ("SpiNNaker", "130nm", 102, 250_000, 200, 1.0, 1500.0),
    ("4096-Neuron", "10nm FinFET", 1.72, 4096, "105-506", None, 3.8),
]


def main(argv=None) -> list[tuple]:
    model = energy.EnergyModel.calibrated()
    ref = model.reference_rates
    counts = energy.WorkloadCounts(
        sops=ref["sops_per_s"], row_fetches=ref["rows_per_s"],
        spike_packets=ref["packets_per_s"],
        cycles=model.freq_mhz * 1e6)
    mw = model.breakdown_mw(counts)

    rows = [("SNAP-V(this-work)", "45nm CMOS", energy.AREA_MM2, 1024,
             timing.FREQ_H_MHZ, mw["total_mw"] / 1e3, model.e_sop_pj)]
    rows += LITERATURE

    print("design,tech,area_mm2,neurons,freq_mhz,power_w,pj_per_sop")
    for name, tech, area, n, f, p, e in rows:
        print(f"{name},{tech},{area},{n},{f if f is not None else ''},"
              f"{'' if p is None else p},{'' if e is None else e}")
    # derived sanity notes
    ours = rows[0]
    competitive = [r for r in LITERATURE if r[6] is not None
                   and r[6] < ours[6]]
    print(f"# SNAP-V pJ/SOP={ours[6]} — lower than "
          f"{sum(1 for r in LITERATURE if (r[6] or 0) > ours[6])}"
          f"/{len(LITERATURE)} published rows (paper claim: most "
          f"competitive at its 1024-neuron scale)")
    assert not competitive, "calibration drifted: 1.05 pJ/SOP must lead"
    return rows


if __name__ == "__main__":
    main()
