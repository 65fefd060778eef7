"""Cerebra-S — the bus-based baseline accelerator (paper §IV).

Twin of :mod:`repro.core.cerebra_s`: the compile step and the cycle /
SOP cost model.

Hardware semantics being modeled:
  * 1024 physical neurons on a flat tagged bus; adjacency matrix in a
    central SRAM.
  * At each timestep boundary, spikes from the array + external stimulus
    are captured; for every spiking source the interconnect walks its
    outgoing synapses and emits ONE weighted event PER CLOCK CYCLE on the
    shared bus; each neuron snoops and accumulates matching events.
  * Neurons: accumulator (wrapping int32 add), potential-decay unit
    (fixed-point MULTIPLY by a decay factor — Cerebra-S kept the
    multiplier), potential adder (threshold compare + reset).

The serial bus walk is functionally a spike-vector x adjacency-matrix
product: the timestep runs on the shared
:class:`~repro_torch.core.engine.SpikeEngine` with ``DecaySpec.mul``, so
the ``cuda`` and ``cuda-f32`` backends run both timestep kernels' multiply
decay. The cost model keeps the serial event count as a pure pass over
the spike raster: cycles(t) = sum of the fanouts of the sources spiking
at t.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.core.engine import DecaySpec, SpikeEngine, sources_raster
from repro_torch.core.lif import LIFParams
from repro_torch.core.network import SNNetwork

__all__ = [
    "CerebraSConfig",
    "CerebraSProgram",
    "compile_network",
    "make_engine",
    "cost_model",
    "run",
]

MAX_FREQ_MHZ = 10.17  # paper §V: Cerebra-S critical path


@dataclasses.dataclass(frozen=True)
class CerebraSConfig:
    n_physical_neurons: int = 1024
    fmt: fxp.FixedPointFormat = fxp.Q16_16
    # Central SRAM capacity: full adjacency over the physical array plus
    # external sources; the paper gives no explicit row budget for S, so the
    # limit is the square adjacency over physical neurons + stimuli.
    max_external_sources: int = 1024


@dataclasses.dataclass
class CerebraSProgram:
    """A network compiled (placed + quantized) for Cerebra-S."""

    config: CerebraSConfig
    params: LIFParams
    n_inputs: int
    n_neurons: int                 # logical neurons in use
    # (n_sources, n_physical) int32 SRAM image, a host (CPU) tensor;
    # engines copy it to their device
    weights_raw: torch.Tensor
    fanout: np.ndarray             # (n_sources,) int — bus events per spike
    output_slice: tuple[int, int]
    decay_raw: int                 # fixed-point retain factor for the PDU
    # per-program engine cache: {(backend, device): SpikeEngine}
    _engines: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def n_sources(self) -> int:
        return self.n_inputs + self.config.n_physical_neurons


def compile_network(
    net: SNNetwork, config: CerebraSConfig | None = None
) -> CerebraSProgram:
    """Quantize + place a logical network onto the Cerebra-S array.

    Logical neuron i -> physical neuron i (the paper's one-to-one
    initialization mapping); unused physical neurons get zero fan-in and
    never spike.
    """
    config = config or CerebraSConfig()
    net.validate()
    if net.n_neurons > config.n_physical_neurons:
        raise ValueError(
            f"network has {net.n_neurons} neurons > "
            f"{config.n_physical_neurons} physical neurons"
        )
    if net.n_inputs > config.max_external_sources:
        raise ValueError(
            f"{net.n_inputs} external sources exceed SRAM budget "
            f"{config.max_external_sources}"
        )
    n_phys = config.n_physical_neurons
    W = np.zeros((net.n_inputs + n_phys, n_phys), np.float32)
    W[: net.n_inputs, : net.n_neurons] = net.weights[: net.n_inputs]
    W[net.n_inputs : net.n_inputs + net.n_neurons, : net.n_neurons] = (
        net.weights[net.n_inputs :]
    )
    w_raw = fxp.np_to_fixed(W, config.fmt)
    # Cerebra-S keeps the fixed-point multiplier: the retain factor itself is
    # quantized to Q16.16 but otherwise arbitrary.
    decay_raw = int(round(net.params.beta * config.fmt.scale))
    return CerebraSProgram(
        config=config,
        params=net.params,
        n_inputs=net.n_inputs,
        n_neurons=net.n_neurons,
        weights_raw=torch.from_numpy(w_raw),
        fanout=np.count_nonzero(W, axis=1),
        output_slice=net.output_slice,
        decay_raw=decay_raw,
    )


def make_engine(program: CerebraSProgram, backend: str = "reference", *,
                device="cuda") -> SpikeEngine:
    """The program's SpikeEngine for ``backend`` on ``device`` (built once,
    then cached).

    Cerebra-S kept the fixed-point multiplier, so the engine decays with
    ``DecaySpec.mul`` — the truncating Q16.16 multiply — instead of the
    H generation's shift decay.
    """
    key = (backend, str(torch.device(device)))
    engine = program._engines.get(key)
    if engine is None:
        engine = SpikeEngine(
            program.weights_raw,
            program.n_inputs,
            decay=DecaySpec.mul(program.decay_raw),
            threshold_raw=program.params.threshold_raw,
            reset_mode=program.params.reset_mode,
            backend=backend,
            device=device,
        )
        program._engines[key] = engine
    return engine


def cost_model(program: CerebraSProgram, ext_spikes, spikes) -> dict:
    """Pure cycle/SOP accounting from a spike raster (no functional state).

    Bus cost: the interconnect walks one outgoing synapse per clock, so
    cycles(t) = sum over spiking sources of their fanout, and every bus
    event is exactly one synaptic operation.

    Args:
      ext_spikes: (T, B, n_inputs) external stimulus in {0,1}.
      spikes: (T, B, n_physical) raster produced by the engine.
    Returns:
      {'cycles': (T, B) int32, 'sops': (T, B) int32}, on the device of
      ``spikes``.
    """
    spikes = torch.as_tensor(spikes)
    dev = spikes.device
    sources = sources_raster(torch.as_tensor(ext_spikes).to(dev), spikes)
    fanout = torch.as_tensor(program.fanout.astype(np.int32), device=dev)
    cycles = (sources * fanout[None, None, :]).sum(-1).to(torch.int32)
    return {"cycles": cycles, "sops": cycles}


def run(program: CerebraSProgram, ext_spikes, backend: str = "reference", *,
        device="cuda") -> dict:
    """Run inference over a spike train.

    Args:
      program: compiled network.
      ext_spikes: (T, B, n_inputs) in {0,1} (any int/float dtype).
      backend: SpikeEngine backend ("reference" | "cuda" | "cuda-f32").
      device: where the engine runs (default ``"cuda"``; ``"cpu"`` for
        the plain path on the host).
    Returns:
      dict with:
        'spikes': (T, B, n_physical) int32 spike raster,
        'output_counts': (B, n_out) spike counts over the output slice,
        'cycles': (T, B) bus cycles per timestep,
        'sops': (T, B) synaptic ops per timestep.
    """
    engine = make_engine(program, backend, device=device)
    if isinstance(ext_spikes, np.ndarray):
        ext_spikes = torch.from_numpy(np.ascontiguousarray(ext_spikes))
    out = engine.run(ext_spikes)
    spikes = out["spikes"]
    cost = cost_model(program, ext_spikes, spikes)
    lo, hi = program.output_slice
    return {
        "spikes": spikes,
        "output_counts": spikes[:, :, lo:hi].sum(dim=0, dtype=torch.int32),
        "cycles": cost["cycles"],
        "sops": cost["sops"],
    }
