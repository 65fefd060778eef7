"""Roofline accounting on the NVIDIA H100.

Twin of :mod:`repro.roofline`. Terms per (arch, shape, mesh), from the
dry-run's op trace of one rank's step (:mod:`repro_torch.launch.dryrun`,
:mod:`repro_torch.op_analysis`):

    compute_s    = flops_per_device / PEAK_FLOPS
    memory_s     = bytes_per_device / HBM_BW
    collective_s = collective_wire_bytes_per_device / LINK_BW

The op trace reports PER-DEVICE (one rank's) flops and bytes; the
collective bytes are the result bytes of each collective the rank
issues, all-reduce weighted 2x (ring reduce-scatter + all-gather), as
the twin weights them. The twin reads collectives from post-SPMD HLO
text (``collective_bytes_from_hlo``); the port has no HLO, and
:func:`repro_torch.op_analysis.analyze_step` counts them from the c10d
ops the step dispatches instead.

``LINK_BW`` is NVLink 4 within one node of eight cards. A 256-card mesh
such as the production ``(16, 16)`` spans 32 nodes, and its collectives
over ``data`` cross the network between nodes, which is slower than
NVLink (InfiniBand NDR: 50 GB/s a direction a card), so ``collective_s``
is a lower bound there.

MODEL_FLOPS sanity term: 6*N*D for dense training (3 matmul passes),
2*N*D for inference-prefill, 2*N_active per token for decode; the ratio
MODEL_FLOPS / traced FLOPs exposes remat and dispatch overhead (< 1
means the step does extra or redundant work, e.g. recompute; ~0.75 with
remat of every layer).
"""

from __future__ import annotations

__all__ = ["HBM_BW", "LINK_BW", "PEAK_FLOPS", "model_flops",
           "roofline_terms"]

# H100 SXM5 80GB (700 W) constants, per card, from NVIDIA's H100 data sheet
PEAK_FLOPS = 989e12        # bf16 tensor-core dense (1979e12 with sparsity)
HBM_BW = 3.35e12           # bytes/s, HBM3
LINK_BW = 450e9            # bytes/s, NVLink 4 (900 GB/s both directions)


def model_flops(cfg, shape, n_chips: int) -> float:
    """Useful-work FLOPs for the whole step, by the 6ND/2ND convention."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def roofline_terms(*, flops_per_device: float, bytes_per_device: float,
                   collective_bytes_per_device: float, cfg, shape,
                   n_chips: int, n_micro: int = 1) -> dict:
    compute_s = flops_per_device / PEAK_FLOPS
    memory_s = bytes_per_device / HBM_BW
    collective_s = collective_bytes_per_device / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dominant = max(terms, key=terms.get).replace("_s", "")
    mf = model_flops(cfg, shape, n_chips)
    mf_per_device = mf / n_chips
    return {
        **terms,
        "dominant": dominant,
        "model_flops_total": mf,
        "model_flops_per_device": mf_per_device,
        "useful_flops_ratio": (mf_per_device / flops_per_device
                               if flops_per_device else 0.0),
        "bound_s": max(terms.values()),
        # fraction of the roofline-limited time doing useful math
        "roofline_fraction": (
            (mf_per_device / PEAK_FLOPS) / max(terms.values())
            if max(terms.values()) > 0 else 0.0),
    }
