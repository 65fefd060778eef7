"""Carry state across from the JAX package, given as numpy arrays.

The port imports nothing from :mod:`repro`; these functions take the
fields of the JAX package's objects (networks, compiled programs,
carries) as numpy arrays and plain values and build the port's objects,
so both packages can compute on identical state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint import _host, _restore
from repro_torch.distributed.partition import assemble, local_shard
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
from repro_torch.events.aer import AERStream
from repro_torch.tree import leaves, tree_map, unflatten

__all__ = ["adam_state", "aer_stream", "carry", "geometry", "lif_params",
           "lm_params", "lm_params_of_ranks", "lm_rank_params", "network",
           "program", "snn_params"]


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


def aer_stream(*, addrs: np.ndarray, count, total, shape,
               device="cpu") -> AERStream:
    """An ``AERStream`` from a JAX stream's arrays and static shape, its
    tensors on ``device``. Rows are carried as they are (filler, rows past
    ``count`` and rows past the shape included), so both packages decode
    the same stream."""
    return AERStream(
        addrs=torch.from_numpy(np.array(addrs, np.int32, copy=True)
                               ).reshape(-1, 3).to(device),
        count=torch.tensor(int(count), dtype=torch.int32, device=device),
        total=torch.tensor(int(total), dtype=torch.int32, device=device),
        shape=tuple(int(d) for d in shape))


def snn_params(weights, device="cpu") -> list[torch.Tensor]:
    """A spiking MLP's params (the JAX package's list of ``(fan_in,
    fan_out)`` arrays, as numpy) as float32 tensors on ``device``."""
    return [torch.from_numpy(np.array(w, np.float32, copy=True)).to(device)
            for w in weights]


def adam_state(state, device="cpu") -> dict:
    """An optimizer state of the JAX package (``{"step", "m", "v"}`` or
    ``{"step", "mu"}``, its leaves as numpy) as the port's: the same tree,
    each leaf a tensor of its dtype on ``device`` (``step`` a 0-d
    int32)."""
    return tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), state)


def lm_params(tree, device="cpu") -> dict:
    """An LM param tree of the JAX package (nested dicts, its leaves as
    numpy, bfloat16 included; the layers stacked on a leading L axis) as
    the port's: the same tree, each leaf a tensor of its dtype on
    ``device``. Leaves go through the checkpoint's codec, which restores
    the dtypes numpy lacks from a same-width integer view."""
    return tree_map(lambda a: _restore(*_host(a)).to(device), tree)


def lm_rank_params(tree, shardings, rank: int, device="cpu") -> dict:
    """The per-rank form of :func:`lm_params`: rank ``rank``'s shards of
    a numpy LM tree (JAX's layout) under ``shardings`` (the same tree of
    :class:`repro_torch.distributed.partition.Sharding`, their mesh the
    ranks'), each a tensor of its dtype on ``device``."""
    return tree_map(lambda a, sh: _restore(*_host(np.ascontiguousarray(
        local_shard(np.asarray(a), sh, rank)))).to(device),
        tree, shardings)


def lm_params_of_ranks(trees, shardings) -> dict:
    """The inverse of :func:`lm_rank_params`: ``trees[r]``, rank ``r``'s
    shards, put together into the full tree (host tensors; numpy where
    the shards are numpy)."""
    flat = [leaves(t) for t in trees]
    out = []
    for i, sh in enumerate(leaves(shardings)):
        parts = [x.detach().cpu() if isinstance(x, torch.Tensor) else x
                 for x in (f[i] for f in flat)]
        out.append(assemble(parts, sh))
    return unflatten(trees[0], out)
