"""Carry state across from the JAX package, given as numpy arrays.

The port imports nothing from :mod:`repro`; these functions take the
fields of the JAX package's objects (networks, compiled programs,
carries) as numpy arrays and plain values and build the port's objects,
so both packages can compute on identical state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import cerebra_h
from repro_torch.core.fixedpoint import FixedPointFormat, nearest_shift_decay
from repro_torch.core.lif import LIFParams
from repro_torch.core.mapping import (
    ClusterGeometry,
    Placement,
    check_capacity,
    communication_profile,
)
from repro_torch.core.network import SNNetwork

__all__ = ["carry", "geometry", "lif_params", "network", "program"]


def lif_params(*, decay_rate: float, threshold: float, reset_mode: str,
               int_bits: int = 15, frac_bits: int = 16) -> LIFParams:
    """A ``LIFParams`` from the JAX one's fields."""
    return LIFParams(decay_rate=float(decay_rate), threshold=float(threshold),
                     reset_mode=str(reset_mode),
                     fmt=FixedPointFormat(int(int_bits), int(frac_bits)))


def geometry(**fields) -> ClusterGeometry:
    """A ``ClusterGeometry`` from the JAX one's fields (all ints)."""
    return ClusterGeometry(**{k: int(v) for k, v in fields.items()})


def network(*, n_inputs: int, n_neurons: int, weights: np.ndarray,
            params: LIFParams, layer_slices=(),
            output_slice=None) -> SNNetwork:
    """An ``SNNetwork`` from a JAX network's weights, params and slices."""
    return SNNetwork(
        n_inputs=int(n_inputs), n_neurons=int(n_neurons),
        weights=np.array(weights, np.float32, copy=True), params=params,
        layer_slices=tuple((int(a), int(b)) for a, b in layer_slices),
        output_slice=(None if output_slice is None
                      else (int(output_slice[0]), int(output_slice[1]))))


def program(*, net: SNNetwork, weights_raw: np.ndarray,
            row_exists: np.ndarray, fanout: np.ndarray,
            output_map: np.ndarray, neuron_to_physical: np.ndarray,
            config: cerebra_h.CerebraHConfig | None = None
            ) -> cerebra_h.CerebraHProgram:
    """A compiled program from a JAX program's arrays.

    ``weights_raw`` is the blocked ``(n_sources, n_clusters, n)`` int32
    SRAM image; ``net`` (already converted) supplies the LIF parameters
    and the capacity / communication reports, recomputed by the port's
    mapping compiler for ``neuron_to_physical``.
    """
    config = config or cerebra_h.CerebraHConfig()
    placement = Placement(config.geometry,
                          np.asarray(neuron_to_physical, np.int64))
    return cerebra_h.CerebraHProgram(
        config=config,
        params=net.params,
        placement=placement,
        n_inputs=net.n_inputs,
        n_neurons=net.n_neurons,
        weights_raw=torch.from_numpy(
            np.array(weights_raw, np.int32, copy=True)),
        row_exists=np.array(row_exists, bool, copy=True),
        fanout=np.array(fanout, copy=True),
        output_map=np.array(output_map, copy=True),
        decay_rate=nearest_shift_decay(net.params.decay_rate),
        capacity_report=check_capacity(net, placement, config.row_mode),
        comm_profile=communication_profile(net, placement),
    )


def carry(*, v: np.ndarray, spikes: np.ndarray, device="cpu") -> dict:
    """An engine carry ``{'v', 'spikes'}`` (int32 tensors on ``device``)."""
    return {
        "v": torch.from_numpy(np.array(v, np.int32, copy=True)).to(device),
        "spikes": torch.from_numpy(
            np.array(spikes, np.int32, copy=True)).to(device),
    }
