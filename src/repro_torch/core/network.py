"""Logical SNN description — the object the mapping compiler consumes.

A numpy-only copy of :mod:`repro.core.network` (the port imports nothing
from the JAX package).

A logical network is hardware-agnostic: ``n_inputs`` external stimulus
sources plus ``n_neurons`` LIF neurons, connected by a dense adjacency
matrix ``W`` of shape (n_inputs + n_neurons, n_neurons): ``W[s, d]`` is the
synaptic weight from source ``s`` (external input if s < n_inputs, else
neuron s - n_inputs) to destination neuron ``d``. Zero entries are absent
synapses — exactly the paper's "neuron placement graph" adjacency-matrix
representation.

Feed-forward classifiers (the paper's MNIST networks) are built with
:func:`feedforward`; arbitrary recurrent graphs (the paper's robotic/PID
use cases) with the constructor directly.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.lif import LIFParams

__all__ = ["SNNetwork", "feedforward"]


@dataclasses.dataclass
class SNNetwork:
    """Logical spiking network.

    Attributes:
      n_inputs: number of external stimulus sources.
      n_neurons: number of LIF neurons.
      weights: (n_inputs + n_neurons, n_neurons) float adjacency matrix.
      params: per-network LIF parameters (the paper configures decay /
        threshold / reset per accelerator deployment; per-neuron overrides
        are carried in ``neuron_params`` when present).
      layer_slices: optional list of (start, end) neuron-index ranges per
        layer — used by the mapping compiler for locality-aware placement
        and by the decoder to find the output population.
      output_slice: (start, end) neuron-index range of the output layer.
    """

    n_inputs: int
    n_neurons: int
    weights: np.ndarray
    params: LIFParams = dataclasses.field(default_factory=LIFParams)
    layer_slices: tuple[tuple[int, int], ...] = ()
    output_slice: tuple[int, int] | None = None

    def __post_init__(self):
        w = np.asarray(self.weights, np.float32)
        expect = (self.n_inputs + self.n_neurons, self.n_neurons)
        if w.shape != expect:
            raise ValueError(f"weights shape {w.shape} != {expect}")
        self.weights = w
        if self.output_slice is None:
            if self.layer_slices:
                self.output_slice = self.layer_slices[-1]
            else:
                self.output_slice = (0, self.n_neurons)

    @property
    def n_sources(self) -> int:
        return self.n_inputs + self.n_neurons

    @property
    def n_synapses(self) -> int:
        return int(np.count_nonzero(self.weights))

    def fanout(self) -> np.ndarray:
        """Per-source count of outgoing synapses (bus events per spike)."""
        return np.count_nonzero(self.weights, axis=1)

    def validate(self) -> None:
        if not np.all(np.isfinite(self.weights)):
            raise ValueError("non-finite synaptic weights")


def feedforward(
    layer_weights: Sequence[np.ndarray],
    params: LIFParams | None = None,
) -> SNNetwork:
    """Build a feed-forward SNN from dense layer weight matrices.

    ``layer_weights[i]`` has shape (fan_in_i, fan_out_i); fan_in of layer 0
    is the external input dimension. Hidden/output neurons are numbered
    contiguously layer by layer — the paper's MNIST nets (784 -> H -> 10)
    are ``feedforward([W1 (784,H), W2 (H,10)])``.
    """
    params = params or LIFParams()
    sizes = [int(w.shape[0]) for w in layer_weights] + [
        int(layer_weights[-1].shape[1])
    ]
    for i, w in enumerate(layer_weights):
        if w.shape != (sizes[i], sizes[i + 1]):
            raise ValueError(
                f"layer {i} weight shape {w.shape} != {(sizes[i], sizes[i+1])}"
            )
    n_inputs = sizes[0]
    n_neurons = int(sum(sizes[1:]))
    W = np.zeros((n_inputs + n_neurons, n_neurons), np.float32)
    layer_slices = []
    dst_off = 0
    src_off = 0  # source index of the presynaptic population
    for i, w in enumerate(layer_weights):
        fan_in, fan_out = w.shape
        dst = slice(dst_off, dst_off + fan_out)
        src = slice(src_off, src_off + fan_in)
        W[src, dst] = np.asarray(w, np.float32)
        layer_slices.append((dst_off, dst_off + fan_out))
        # next layer's sources are this layer's neurons (offset by n_inputs)
        src_off = n_inputs + dst_off
        dst_off += fan_out
    return SNNetwork(
        n_inputs=n_inputs,
        n_neurons=n_neurons,
        weights=W,
        params=params,
        layer_slices=tuple(layer_slices),
        output_slice=layer_slices[-1],
    )
