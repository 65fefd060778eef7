"""Float software-reference inference — the paper's snnTorch baseline role.

Twin of :mod:`repro.core.software`: runs a logical
:class:`~repro_torch.core.network.SNNetwork` in float32 with the exact
trained decay (not snapped to hardware rates) and unquantized weights. The
accuracy-deviation experiments (paper Table IV) compare it against the
bit-exact Cerebra-H hardware model on identical spike trains.

The JAX package computes ``sources @ W`` outside any Pallas kernel, so the
port computes it with ``torch.matmul``. Float sums depend on their order
(XLA, oneDNN and cuBLAS each choose their own), so this path agrees with
its twin to a tolerance, not byte for byte, except on weights whose sums
are exact in float32 in any order.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lif import lif_step_float
from repro_torch.core.network import SNNetwork
from repro_torch.device import ieee_fp32_matmul, resolve_device

__all__ = ["run_software"]


def run_software(net: SNNetwork, ext_spikes, *, device="cuda") -> dict:
    """Float32 inference. ext_spikes: (T, B, n_inputs) in {0,1}.

    Runs on ``device`` (default ``"cuda"``; raises without a card, pass
    ``"cpu"`` for the host). The product ``sources @ W`` is computed in
    full float32 even where ``torch.backends.cuda.matmul.allow_tf32`` is
    set: TF32 would round the weights to 10 mantissa bits.

    Returns {'spikes': (T, B, N) float32, 'output_counts': (B, n_out)
    float32}, on ``device``.
    """
    dev = resolve_device(device)
    W = torch.from_numpy(np.ascontiguousarray(net.weights, np.float32)).to(dev)
    if isinstance(ext_spikes, np.ndarray):
        ext_spikes = torch.from_numpy(np.ascontiguousarray(ext_spikes))
    ext = torch.as_tensor(ext_spikes).to(device=dev, dtype=torch.float32)
    T, B = ext.shape[0], ext.shape[1]
    N = net.n_neurons
    v = torch.zeros((B, N), dtype=torch.float32, device=dev)
    prev = torch.zeros((B, N), dtype=torch.float32, device=dev)
    spikes = torch.empty((T, B, N), dtype=torch.float32, device=dev)
    with ieee_fp32_matmul():
        for t in range(T):
            sources = torch.cat([ext[t], prev], dim=-1)  # (B, n_in + N)
            syn = sources @ W
            state, prev = lif_step_float({"v": v}, syn, net.params)
            v = state["v"]
            spikes[t] = prev
    lo, hi = net.output_slice
    return {
        "spikes": spikes,
        "output_counts": spikes[:, :, lo:hi].sum(dim=0),
    }
