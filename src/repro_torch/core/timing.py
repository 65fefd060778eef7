"""Timing model: cycles -> wall time at the synthesized clock frequencies.

Twin of :mod:`repro.core.timing` (numpy only, copied). Cycle arrays are
read through ``np.asarray``: host (CPU) tensors or numpy.

Paper §V / §VII-B: Cerebra-S f_max = 10.17 MHz (long combinational bus +
multiplier path); Cerebra-H f_max = 96.24 MHz (critical path 10.3904 ns),
a 9.46x clock improvement. Combined with the per-timestep cycle counts from
the two cost models this yields end-to-end latency and the S-vs-H speedup
benchmark.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["CRITICAL_PATH_H_NS", "FREQ_H_MHZ", "FREQ_S_MHZ", "TimingReport",
           "speedup_report", "wall_time_us"]

FREQ_S_MHZ = 10.17
FREQ_H_MHZ = 96.24
CRITICAL_PATH_H_NS = 10.3904


@dataclasses.dataclass(frozen=True)
class TimingReport:
    cycles_s: float
    cycles_h: float
    time_s_us: float
    time_h_us: float
    cycle_speedup: float
    clock_speedup: float
    total_speedup: float


def wall_time_us(cycles: float, freq_mhz: float) -> float:
    return float(cycles) / freq_mhz  # cycles / (MHz) == microseconds


def speedup_report(cycles_s, cycles_h) -> TimingReport:
    """cycles_*: per-step cycle arrays or totals from the cost models."""
    cs = float(np.sum(np.asarray(cycles_s, dtype=np.float64)))
    ch = float(np.sum(np.asarray(cycles_h, dtype=np.float64)))
    ts = wall_time_us(cs, FREQ_S_MHZ)
    th = wall_time_us(ch, FREQ_H_MHZ)
    return TimingReport(
        cycles_s=cs,
        cycles_h=ch,
        time_s_us=ts,
        time_h_us=th,
        cycle_speedup=cs / max(ch, 1e-12),
        clock_speedup=FREQ_H_MHZ / FREQ_S_MHZ,
        total_speedup=ts / max(th, 1e-12),
    )
