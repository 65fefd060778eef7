"""Trainable spiking MLP — the software models of the paper's Table IV.

Twin of :mod:`repro.snn.model`. Feed-forward LIF networks (784 -> H ->
10) trained with surrogate-gradient BPTT (fast-sigmoid) on rate-coded
inputs. No biases: the Cerebra neurons integrate weighted spikes only, so
a bias-free network deploys 1:1 onto the accelerator.

The twin's forward is plain ``jnp`` under ``lax.scan``; here it is plain
torch in a Python loop over T (autograd keeps every step's graph), with
``spk @ W`` as ``torch.matmul`` in full float32: TF32 stays off on the
card, as in :mod:`repro_torch.core.software`.

``to_snnetwork`` converts trained params into the logical network the
mapping compiler consumes: the software model and the deployed hardware
model are the same weights.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.lif import LIFParams, lif_step_train
from repro_torch.core.network import SNNetwork, feedforward
from repro_torch.device import ieee_fp32_matmul, resolve_device

__all__ = ["SNNModelConfig", "init_params", "forward", "to_snnetwork"]


@dataclasses.dataclass(frozen=True)
class SNNModelConfig:
    layer_sizes: tuple[int, ...] = (784, 128, 10)
    params: LIFParams = dataclasses.field(
        default_factory=lambda: LIFParams(
            decay_rate=0.1, threshold=1.0, reset_mode="zero"))
    surrogate_slope: float = 25.0
    weight_clip: float = 1.0  # keeps Q16.16 and cuda-f32 exactness bounds


def init_params(key, config: SNNModelConfig, *,
                device="cuda") -> list[torch.Tensor]:
    """One ``(fan_in, fan_out)`` float32 matrix per layer on ``device``:
    ``normal(k_i) * (1 / sqrt(fan_in)) * 3`` with ``k_i`` the split of
    ``key``, as the twin draws them (the normals to rtol 1e-6, see
    :func:`repro_torch.core.prng.normal`)."""
    dev = resolve_device(device)
    sizes = config.layer_sizes
    keys = prng.split(prng.as_key(key), len(sizes) - 1)
    ws = []
    for k, (fan_in, fan_out) in zip(keys, zip(sizes[:-1], sizes[1:])):
        std = float(np.float32(1.0 / np.sqrt(fan_in)))
        ws.append(prng.normal(k, (fan_in, fan_out), dev) * std * 3.0)
    return ws


def forward(params: Sequence[torch.Tensor], spikes: torch.Tensor,
            config: SNNModelConfig) -> dict:
    """Run the spiking MLP over a spike train.

    spikes: (T, B, D_in) float {0,1} on the params' device. Returns a dict
    with the output spike counts (B, n_out), the output spikes
    (T, B, n_out) and the total hidden spike count over all hidden layers
    and steps (a scalar, for the rate regularizer).
    """
    lif = config.params
    B = spikes.shape[1]
    vs = [torch.zeros((B, w.shape[1]), dtype=torch.float32,
                      device=w.device) for w in params]
    out_spikes, hidden_counts = [], []
    with ieee_fp32_matmul():
        for x_t in spikes:
            spk = x_t
            layer_spikes = []
            for i, w in enumerate(params):
                state, spk = lif_step_train({"v": vs[i]}, spk @ w, lif,
                                            config.surrogate_slope)
                vs[i] = state["v"]
                layer_spikes.append(spk)
            hidden_counts.append(sum(s.sum() for s in layer_spikes[:-1]))
            out_spikes.append(layer_spikes[-1])
    out = torch.stack(out_spikes)
    return {
        "output_counts": out.sum(dim=0),                    # (B, n_out)
        "output_spikes": out,                               # (T, B, n_out)
        "hidden_spike_total": torch.stack(
            [torch.as_tensor(c, dtype=torch.float32, device=out.device)
             for c in hidden_counts]).sum(),
    }


def to_snnetwork(params: Sequence, config: SNNModelConfig) -> SNNetwork:
    """Freeze trained params (tensors or arrays) into the logical network
    for deployment: clipped to ``weight_clip``, then ``feedforward``."""
    ws = [np.clip(_host(w), -config.weight_clip, config.weight_clip)
          for w in params]
    return feedforward(ws, config.params)


def _host(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    return np.asarray(w, np.float32)
