"""Analytic power/energy model calibrated to the paper's Table V.

Twin of :mod:`repro.core.energy` (numpy only, copied). Results of the
port's runs are read through ``np.asarray``: host (CPU) tensors.

The paper measures (45 nm CMOS OpenNand, Synopsys PrimePower, MNIST
workload @ 96.24 MHz):

    Weight Memory              479.95 mW   (95.97 %)
    Neuron Clusters             17.00 mW   ( 3.40 %)
    Spike Packet Paths           2.44 mW   ( 0.49 %)
    Data/Control Packet Paths    0.72 mW   ( 0.14 %)
    Total                      500.10 mW
    Compute-path energy          1.05 pJ/SOP
    Area                        25.74 mm^2

We decompose each subsystem into static power + per-event energy and solve
the per-event constants so that the model reproduces Table V exactly at the
paper's reference operating point. The reference activity rates are derived
from the paper's own numbers:

  * neuron compute: P_nc = 17.00 mW at 1.05 pJ/SOP
        => SOP rate S_ref = 16.19 GSOP/s  (168.2 SOPs/cycle @96.24 MHz —
           66 % of the architectural max of 256 SOPs/cycle, a plausible
           MNIST duty cycle)
  * SRAM row rate R_ref = S_ref / 32 (one row delivers 32 weights)
  * spike packet rate K_ref = R_ref (one packet per row fetch)

Static/dynamic splits for the SRAM macros and NoC are stated assumptions
(OpenRAM 45 nm leakage-dominated; see DESIGN.md changed-assumptions).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["E_SOP_PJ", "SOPS_PER_ROW", "TABLE_V", "EnergyModel",
           "WorkloadCounts", "counts_from_registry", "counts_from_run"]

# paper constants ----------------------------------------------------------
TABLE_V = {
    "weight_memory_mw": 479.95,
    "neuron_clusters_mw": 17.00,
    "spike_paths_mw": 2.44,
    "data_control_paths_mw": 0.72,
    "total_mw": 500.10,
}
E_SOP_PJ = 1.05
FREQ_H_MHZ = 96.24
AREA_MM2 = 25.74
SOPS_PER_ROW = 32  # one SRAM row carries a full cluster-wide weight vector


@dataclasses.dataclass
class WorkloadCounts:
    """Event counts over an inference window (from the cost model)."""

    sops: float            # synaptic operations
    row_fetches: float     # SRAM row reads
    spike_packets: float   # NoC spike-path packets
    cycles: float          # total accelerator cycles


@dataclasses.dataclass(frozen=True)
class EnergyModel:
    freq_mhz: float = FREQ_H_MHZ
    e_sop_pj: float = E_SOP_PJ
    e_row_pj: float = 180.0        # per 1024-bit row read (assumption)
    e_packet_pj: float = 2.9       # per spike packet hop (assumption)
    p_mem_static_mw: float = 0.0   # solved by `calibrated`
    p_neuron_static_mw: float = 0.0
    p_spike_static_mw: float = 0.0
    p_ctrl_static_mw: float = TABLE_V["data_control_paths_mw"]

    # ------------------------------------------------------------------
    @classmethod
    def calibrated(cls) -> "EnergyModel":
        """Solve static terms so Table V is reproduced at the ref point."""
        f = FREQ_H_MHZ * 1e6
        s_ref = TABLE_V["neuron_clusters_mw"] * 1e-3 / (E_SOP_PJ * 1e-12)
        r_ref = s_ref / SOPS_PER_ROW
        k_ref = r_ref
        e_row = 180.0
        e_pkt = 2.9
        p_mem_static = TABLE_V["weight_memory_mw"] - r_ref * e_row * 1e-9
        p_spk_static = TABLE_V["spike_paths_mw"] - k_ref * e_pkt * 1e-9
        # neuron clusters: fully activity-proportional at 1.05 pJ/SOP
        del f
        return cls(
            e_row_pj=e_row,
            e_packet_pj=e_pkt,
            p_mem_static_mw=p_mem_static,
            p_neuron_static_mw=0.0,
            p_spike_static_mw=max(p_spk_static, 0.0),
        )

    # ------------------------------------------------------------------
    @property
    def reference_rates(self) -> dict:
        s_ref = TABLE_V["neuron_clusters_mw"] * 1e-3 / (self.e_sop_pj * 1e-12)
        return {
            "sops_per_s": s_ref,
            "rows_per_s": s_ref / SOPS_PER_ROW,
            "packets_per_s": s_ref / SOPS_PER_ROW,
            "sops_per_cycle": s_ref / (self.freq_mhz * 1e6),
        }

    def breakdown_mw(self, counts: WorkloadCounts) -> dict:
        """Average power over the workload window, per subsystem (mW)."""
        t_s = counts.cycles / (self.freq_mhz * 1e6)
        t_s = max(t_s, 1e-30)
        dyn = lambda n, e_pj: n * e_pj * 1e-12 / t_s * 1e3  # -> mW
        mem = self.p_mem_static_mw + dyn(counts.row_fetches, self.e_row_pj)
        neu = self.p_neuron_static_mw + dyn(counts.sops, self.e_sop_pj)
        spk = self.p_spike_static_mw + dyn(counts.spike_packets,
                                           self.e_packet_pj)
        ctl = self.p_ctrl_static_mw
        total = mem + neu + spk + ctl
        return {
            "weight_memory_mw": mem,
            "neuron_clusters_mw": neu,
            "spike_paths_mw": spk,
            "data_control_paths_mw": ctl,
            "total_mw": total,
            "weight_memory_pct": 100 * mem / total,
            "compute_pj_per_sop": self.e_sop_pj,
        }

    def energy_uj(self, counts: WorkloadCounts) -> dict:
        """Total energy over the window (microjoules), per subsystem."""
        t_s = counts.cycles / (self.freq_mhz * 1e6)
        static_uj = (
            (self.p_mem_static_mw + self.p_neuron_static_mw
             + self.p_spike_static_mw + self.p_ctrl_static_mw)
            * 1e-3 * t_s * 1e6
        )
        dyn_uj = (
            counts.sops * self.e_sop_pj
            + counts.row_fetches * self.e_row_pj
            + counts.spike_packets * self.e_packet_pj
        ) * 1e-12 * 1e6
        return {
            "static_uj": static_uj,
            "dynamic_uj": dyn_uj,
            "total_uj": static_uj + dyn_uj,
            "pj_per_sop_compute": self.e_sop_pj,
            "pj_per_sop_system": (static_uj + dyn_uj) * 1e6 / max(counts.sops, 1),
        }


def counts_from_run(results: dict) -> WorkloadCounts:
    """Build WorkloadCounts from a cerebra_h.run() result dict.

    The batch axis is a software construct: one physical accelerator runs
    the B inferences sequentially, so cycles (and events) SUM over batch.
    """
    return WorkloadCounts(
        sops=float(np.sum(np.asarray(results["sops"]))),
        row_fetches=float(np.sum(np.asarray(results.get("row_fetches", 0)))),
        spike_packets=float(np.sum(np.asarray(results.get("row_fetches", 0)))),
        cycles=float(np.sum(np.asarray(results["cycles"]))),
    )


def counts_from_registry(registry, *, cycles: float | None = None
                         ) -> WorkloadCounts:
    """Build WorkloadCounts from a live instrumented server's registry.

    An instrumented :class:`~repro_torch.serving.snn.SpikeServer` (built
    with ``metrics=``) maintains measured ``snn_server_sops_total`` /
    ``snn_server_row_fetches_total`` counters with ``events.trace`` semantics, so the analytic model can
    price a LIVE serving process the same way it prices an offline run.
    One spike packet per row fetch, as in :func:`counts_from_run`.

    ``cycles`` defaults to the reference-duty estimate: the calibrated
    model's SOPs/cycle at the paper's Table-V operating point, i.e. the
    live workload is priced as if the accelerator sustained the paper's
    MNIST duty cycle. Pass explicit cycles to price a different duty.
    """
    sops = float(registry.counter("snn_server_sops_total").value)
    rows = float(registry.counter("snn_server_row_fetches_total").value)
    if cycles is None:
        per_cycle = EnergyModel.calibrated().reference_rates["sops_per_cycle"]
        cycles = sops / per_cycle
    return WorkloadCounts(sops=sops, row_fetches=rows, spike_packets=rows,
                          cycles=float(cycles))
