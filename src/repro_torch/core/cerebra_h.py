"""Cerebra-H — the clustered, hierarchical-NoC accelerator (paper §V).

Twin of :mod:`repro.core.cerebra_h`: the compile step (placement,
capacity check, Q16.16 quantization into the blocked SRAM image) and the
cycle / SOP / row-fetch cost model, applied as a pure pass over a spike
raster. The functional timestep runs on
:class:`~repro_torch.core.engine.SpikeEngine`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.core.engine import DecaySpec, SpikeEngine, sources_raster
from repro_torch.core.lif import LIFParams
from repro_torch.core.mapping import (
    ClusterGeometry,
    Placement,
    check_capacity,
    communication_profile,
    place_contiguous,
)
from repro_torch.core.network import SNNetwork
from repro_torch.kernels.spike_timestep import exact_int32_matmul

__all__ = [
    "CerebraHConfig",
    "CerebraHProgram",
    "compile_network",
    "cost_model",
    "make_engine",
    "run",
]


@dataclasses.dataclass(frozen=True)
class CerebraHConfig:
    geometry: ClusterGeometry = dataclasses.field(default_factory=ClusterGeometry)
    fmt: fxp.FixedPointFormat = fxp.Q16_16
    row_mode: str = "external_broadcast"
    # NoC micro-timing (paper Table II + §V-D)
    spike_pipeline_depth: int = 2
    l2_hop_cycles: int = 2
    sync_overhead_cycles: int = 4  # timestep-boundary completion handshake


@dataclasses.dataclass
class CerebraHProgram:
    config: CerebraHConfig
    params: LIFParams
    placement: Placement
    n_inputs: int
    n_neurons: int
    # blocked SRAM image: (n_sources, n_clusters, neurons_per_cluster)
    # int32, a host (CPU) tensor; engines copy it to their device
    weights_raw: torch.Tensor
    # (n_sources, n_clusters) bool: a row exists for (source, dst cluster)
    row_exists: np.ndarray
    fanout: np.ndarray            # per-source nonzero synapse count
    output_map: np.ndarray        # physical slots of output neurons, ordered
    decay_rate: float             # snapped to a hardware-supported rate
    capacity_report: dict
    comm_profile: dict
    # per-program engine cache: {(backend, device): SpikeEngine}
    _engines: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def n_sources(self) -> int:
        return self.n_inputs + self.config.geometry.n_physical


def compile_network(net: SNNetwork, config: CerebraHConfig | None = None,
                    placement: Placement | None = None) -> CerebraHProgram:
    """Place, check capacity, quantize and block a logical network."""
    config = config or CerebraHConfig()
    geom = config.geometry
    net.validate()
    placement = placement or place_contiguous(net, geom)
    capacity = check_capacity(net, placement, config.row_mode)
    comm = communication_profile(net, placement)

    n_phys = geom.n_physical
    n_in = net.n_inputs
    W = np.zeros((n_in + n_phys, n_phys), np.float32)
    phys = placement.neuron_to_physical
    W[:n_in, phys] = net.weights[:n_in]
    W[n_in + phys[:, None], phys[None, :]] = net.weights[n_in:]
    w_raw = fxp.np_to_fixed(W, config.fmt)
    blocked = w_raw.reshape(n_in + n_phys, geom.n_clusters,
                            geom.neurons_per_cluster)
    row_exists = (blocked != 0).any(axis=-1)
    # deployment-time snapping of the trained decay to a hardware rate
    decay_rate = fxp.nearest_shift_decay(net.params.decay_rate)

    lo, hi = net.output_slice
    return CerebraHProgram(
        config=config,
        params=net.params,
        placement=placement,
        n_inputs=n_in,
        n_neurons=net.n_neurons,
        weights_raw=torch.from_numpy(np.ascontiguousarray(blocked)),
        row_exists=np.asarray(row_exists),
        fanout=np.count_nonzero(W, axis=1),
        output_map=phys[lo:hi],
        decay_rate=decay_rate,
        capacity_report=capacity,
        comm_profile=comm,
    )


def make_engine(program: CerebraHProgram, backend: str = "reference", *,
                device="cuda") -> SpikeEngine:
    """The program's SpikeEngine for ``backend`` on ``device`` (built once,
    then cached). The blocked image flattens to the engine's (S, P)."""
    key = (backend, str(torch.device(device)))
    engine = program._engines.get(key)
    if engine is None:
        Wb = program.weights_raw
        engine = SpikeEngine(
            Wb.reshape(Wb.shape[0], -1),
            program.n_inputs,
            decay=DecaySpec.shift(program.decay_rate),
            threshold_raw=program.params.threshold_raw,
            reset_mode=program.params.reset_mode,
            backend=backend,
            device=device,
        )
        program._engines[key] = engine
    return engine


def cost_model(program: CerebraHProgram, ext_spikes, spikes) -> dict:
    """Cycle / SOP / row-fetch accounting from a spike raster.

    ext_spikes: (T, B, n_inputs); spikes: (T, B, n_physical), tensors on
    one device. Returns ``{'cycles', 'sops', 'row_fetches'}``, each (T, B)
    int32 on that device. The same vectorized pass as the JAX twin.
    """
    cfg = program.config
    geom = cfg.geometry
    spikes = torch.as_tensor(spikes)
    dev = spikes.device
    sources = sources_raster(torch.as_tensor(ext_spikes).to(dev), spikes)
    T, B, S = sources.shape

    row_exists = torch.as_tensor(program.row_exists.astype(np.int32),
                                 device=dev)                      # (S, C)
    rows_active = exact_int32_matmul(
        sources.reshape(T * B, S), row_exists).reshape(T, B, -1)  # (T,B,C)
    rows_per_group = rows_active.reshape(
        T, B, geom.n_groups, geom.clusters_per_group).sum(-1)
    group_cycles = rows_per_group.amax(dim=-1)  # (T, B) parallel groups

    pkt_per_neuron = row_exists[program.n_inputs:].sum(-1)  # (P,)
    prev = sources[:, :, program.n_inputs:]
    pkts_by_cluster = (prev * pkt_per_neuron[None, None, :]).reshape(
        T, B, geom.n_clusters, geom.neurons_per_cluster).sum(-1)
    l1_cycles = pkts_by_cluster.reshape(
        T, B, geom.n_l1_routers, geom.clusters_per_l1).sum(-1).amax(-1)
    noc_cycles = l1_cycles + cfg.spike_pipeline_depth + cfg.l2_hop_cycles

    cycles = torch.maximum(group_cycles, noc_cycles) + cfg.sync_overhead_cycles
    fanout = torch.as_tensor(program.fanout.astype(np.int32), device=dev)
    sops = (sources * fanout[None, None, :]).sum(-1)
    row_fetches = rows_active.sum(-1)
    return {"cycles": cycles.to(torch.int32), "sops": sops.to(torch.int32),
            "row_fetches": row_fetches.to(torch.int32)}


def run(program: CerebraHProgram, ext_spikes, backend: str = "reference", *,
        device="cuda") -> dict:
    """Run inference on ``(T, B, n_inputs)`` {0,1} spikes. Returns the
    raster (physical layout), logical output counts, and per-step
    cycles / SOPs / SRAM row fetches."""
    engine = make_engine(program, backend, device=device)
    out = engine.run(ext_spikes)
    spikes = out["spikes"]
    cost = cost_model(program, ext_spikes, spikes)
    out_map = torch.as_tensor(program.output_map, device=spikes.device)
    out_counts = spikes[:, :, out_map].sum(dim=0, dtype=torch.int32)
    return {
        "spikes": spikes,
        "output_counts": out_counts,
        "cycles": cost["cycles"],
        "sops": cost["sops"],
        "row_fetches": cost["row_fetches"],
    }
