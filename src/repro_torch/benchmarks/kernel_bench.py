"""Kernel micro-benchmarks of the port at the paper's 1024-neuron scale:
``python -m repro_torch.benchmarks.kernel_bench``.

Twin of ``benchmarks/kernel_bench.py``. Every section draws its inputs
from ``np.random.default_rng(0)`` in the same order as the JAX bench, so
both benches see the same rasters and their accounting records (weight
blocks touched, SOPs, the fused-traffic cross-check) are equal. Record
names keep the JAX bench's pattern with the port's backend names
(``engine/timestep_cuda_d1``, ...), so the backend marks the device.

``--device`` (default ``cuda``, which raises without a card) runs every
engine and kernel there; ``--device cpu`` runs the kernels' plain
versions on the host. Sections:

* the engine-scan time per backend (always);
* ``--streaming``: the ``SpikeServer`` slot-batch path vs the one-shot
  scan, and a partially occupied slot batch;
* ``--sparsity S1,S2,...``: gated-vs-dense weight-block traffic and SOPs
  per gate from real rasters, engine time per backend x gate, and the
  serving occupancy regime;
* ``--fuse-steps K1,K2,...``: the K-step fused window's traffic per K,
  cross-checked between the trace's window-OR model and the gate scalars
  the fused kernel acts on (a disagreement raises), and engine time per
  backend x K;
* the kernel block: ``ops.spike_timestep`` (record
  ``kernel/spike_timestep_fused``: the step with its LIF epilogue fused)
  against ``ref.spike_timestep_ref``, the active source blocks, and
  ``ops.lif_step`` and ``ops.poisson_encode`` (always).

``--json PATH`` writes schema-v2 records with the card's name and power
limit in the metadata. The JAX bench's ``--async``, ``--qos``,
``--migrate``, ``--obs-overhead``, ``--devices N > 1`` and ``--mesh``
need modules that are not ported yet; each raises ``SystemExit`` naming
its ROADMAP item.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.benchmarks import common
from repro_torch.benchmarks.common import emit, time_call
from repro_torch.core.engine import (BACKENDS, GATES, DecaySpec, SpikeEngine,
                                     sources_raster)
from repro_torch.device import resolve_device
from repro_torch.events import trace
from repro_torch.kernels import ops, ref
from repro_torch.serving.snn import SpikeServer

N_IN, P = 784, 1024

# flags of the JAX bench whose modules are not ported yet
_UNPORTED = {
    "async_mode": ("--async", "the async front door, ROADMAP Queue 1 "
                              "item 8"),
    "qos": ("--qos", "the QoS front door, ROADMAP Queue 1 item 8"),
    "migrate": ("--migrate", "the carry connector, ROADMAP Queue 1 item 7"),
    "obs_overhead": ("--obs-overhead", "observability, ROADMAP Queue 1 "
                                       "item 8"),
    "mesh": ("--mesh", "the mesh, ROADMAP Queue 1 item 9"),
}


def _randint(rng, lo, hi, shape, device) -> torch.Tensor:
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int32)
                            ).to(device)


def _weights(rng, device) -> torch.Tensor:
    """The (n_in + P, P) image every engine section draws first."""
    return _randint(rng, -2**13, 2**13, (N_IN + P, P), device)


def _spikes(raster: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(raster.astype(np.int32)).to(device)


def _engine(W, *, device, **kw) -> SpikeEngine:
    return SpikeEngine(W, N_IN, decay=DecaySpec.shift(0.25),
                       threshold_raw=1 << 16, reset_mode="zero",
                       device=device, **kw)


def bench_engine_backends(backends, *, batch: int, activity: float,
                          steps: int = 4, device) -> None:
    """Per-backend engine-scan throughput at the 1024-neuron scale."""
    rng = np.random.default_rng(0)
    W = _weights(rng, device)
    ext = _spikes(rng.random((steps, batch, N_IN)) < activity, device)
    for backend in backends:
        engine = _engine(W, backend=backend, device=device)
        t_run = time_call(lambda e=engine: e.run(ext)["spikes"])
        emit(f"engine/timestep_{backend}_d1", t_run / steps,
             f"us/timestep B={batch} S={N_IN + P} P={P} "
             f"activity={activity} T={steps} devices=1",
             kind="engine_scan", backend=backend, gate=engine.gate,
             batch=batch, activity=activity, devices=1, per_timestep=True)


def bench_streaming(backends, *, n_slots: int, activity: float,
                    chunk_steps: int = 8, rounds: int = 3, device) -> None:
    """The serving axis: masked slot-batch chunk step (SpikeServer.feed)
    vs the one-shot batch scan on the same raster, plus the cost of a
    partially occupied slot batch."""
    rng = np.random.default_rng(0)
    W = _weights(rng, device)
    T = chunk_steps * rounds
    rasters = [(rng.random((T, N_IN)) < activity).astype(np.int32)
               for _ in range(n_slots)]
    batch = _spikes(np.stack(rasters, axis=1), device)  # (T, n_slots, n_in)
    for backend in backends:
        engine = _engine(W, backend=backend, device=device)
        t_batch = time_call(lambda e=engine: e.run(batch)["spikes"])
        emit(f"streaming/batch_scan_{backend}_d1", t_batch / T,
             f"us/timestep B={n_slots} T={T} devices=1 (one-shot run)",
             kind="streaming_batch_scan", backend=backend, gate=engine.gate,
             batch=n_slots, activity=activity, devices=1, per_timestep=True)
        for occupancy in (1.0, 0.25):
            n_live = max(1, int(round(occupancy * n_slots)))

            def serve(e=engine, n_live=n_live):
                srv = SpikeServer(e, n_slots=n_slots,
                                  chunk_steps=chunk_steps, device=device)
                uids = [srv.attach() for _ in range(n_live)]
                for t0 in range(0, T, chunk_steps):
                    srv.feed({u: rasters[i][t0:t0 + chunk_steps]
                              for i, u in enumerate(uids)})
                return srv.total_steps

            t_srv = time_call(serve)
            emit(f"streaming/feed_{backend}_occ{occupancy:g}_d1", t_srv / T,
                 f"us/timestep {n_live}/{n_slots} slots live, "
                 f"chunk={chunk_steps} devices=1 "
                 f"(masked step, per-chunk host hop)",
                 kind="streaming_feed", backend=backend, gate=engine.gate,
                 batch=n_slots, occupancy=occupancy, activity=activity,
                 devices=1, per_timestep=True)


def bench_event_gating(backends, sparsities, *, batch: int,
                       n_slots: int = 8, steps: int = 4, device) -> None:
    """The sparsity axis: event-gated vs dense work, from real rasters
    (traffic and SOPs via ``events.trace``), the engine time per backend
    x gate, and the serving occupancy regime (idle slots)."""
    rng = np.random.default_rng(0)
    W = _weights(rng, device)
    ref_engine = _engine(W, device=device)
    for sparsity in sparsities:
        ext = _spikes(rng.random((steps, batch, N_IN)) < sparsity, device)
        rep = trace.trace_run(ref_engine, ext, ref_engine.run(ext)["spikes"])
        for gate in GATES:
            touched, total = rep.blocks[gate]
            emit(f"gating/traffic_{gate}_s{sparsity:g}", None,
                 f"{touched}/{total} weight blocks "
                 f"({100 * rep.traffic_ratio(gate):.1f}% of dense), "
                 f"SOPs {100 * rep.sop_ratio:.1f}% of dense, B={batch}",
                 kind="event_gating", gate=gate, sparsity=sparsity,
                 batch=batch, blocks_touched=touched, blocks_total=total,
                 traffic_ratio=round(rep.traffic_ratio(gate), 4),
                 measured_sops=rep.measured_sops,
                 dense_sops=rep.dense_sops,
                 sop_ratio=round(rep.sop_ratio, 4))
        for backend in backends:
            # the reference product ignores the gate: one row there
            for gate in (GATES if backend != "reference"
                         else ("batch-tile",)):
                engine = _engine(W, backend=backend, gate=gate,
                                 device=device)
                t = time_call(lambda e=engine: e.run(ext)["spikes"])
                emit(f"gating/timestep_{backend}_{gate}_s{sparsity:g}",
                     t / steps,
                     f"us/timestep B={batch} sparsity={sparsity} "
                     f"gate={gate}",
                     kind="event_gating_time", backend=backend, gate=gate,
                     sparsity=sparsity, batch=batch, per_timestep=True)
        for occupancy in (1.0, 0.25, 0.125):
            n_live = max(1, int(round(occupancy * n_slots)))
            slot_ext = np.zeros((steps, n_slots, N_IN), np.int32)
            slot_ext[:, :n_live] = np.asarray(
                rng.random((steps, n_live, N_IN)) < sparsity, np.int32)
            slot_ext = _spikes(slot_ext, device)
            srep = trace.trace_run(ref_engine, slot_ext,
                                   ref_engine.run(slot_ext)["spikes"])
            for gate in GATES:
                touched, total = srep.blocks[gate]
                emit(f"gating/serving_{gate}_occ{occupancy:g}"
                     f"_s{sparsity:g}", None,
                     f"{n_live}/{n_slots} slots live: {touched}/{total} "
                     f"weight blocks "
                     f"({100 * srep.traffic_ratio(gate):.1f}% of dense)",
                     kind="event_gating_serving", gate=gate,
                     occupancy=occupancy, sparsity=sparsity,
                     n_slots=n_slots, blocks_touched=touched,
                     blocks_total=total,
                     traffic_ratio=round(srep.traffic_ratio(gate), 4))


def bench_fuse_steps(backends, fuse_list, sparsities, *, batch: int,
                     n_slots: int = 8, steps: int = 8, device) -> None:
    """The K-step fusion axis: per-step weight traffic shrinking ~1/K.

    Per sparsity: the fused window's traffic per K from the
    ``events.trace`` window-OR model, CROSS-CHECKED against the gate
    scalars the fused kernel acts on (``ops.ext_gate_activity``; a
    disagreement raises), engine time per backend x K (the reference
    backend has no fused path: timed once at K = 1), and fused
    per-example traffic on a slot batch with idle slots.
    """
    rng = np.random.default_rng(0)
    W = _weights(rng, device)
    ref_engine = _engine(W, device=device)
    for sparsity in sparsities:
        ext = _spikes(rng.random((steps, batch, N_IN)) < sparsity, device)
        sources = sources_raster(ext, ref_engine.run(ext)["spikes"])
        for K in fuse_list:
            touched, total = trace.fused_block_traffic(
                sources, N_IN, fuse_steps=K)
            ext_trace = trace.block_traffic(ext, fuse_steps=K)[0]
            ext_kernel = int(
                (ops.ext_gate_activity(ext, fuse_steps=K) > 0).sum())
            if ext_kernel != ext_trace:
                raise AssertionError(
                    f"fused traffic counters disagree at K={K}: kernel "
                    f"gate scalars say {ext_kernel} ext-block fetches, "
                    f"trace window-OR says {ext_trace}")
            emit(f"fusion/traffic_K{K}_s{sparsity:g}", None,
                 f"{touched}/{total} weight blocks "
                 f"({100 * touched / max(total, 1):.1f}% of per-step "
                 f"dense), {ext_kernel} gated ext DMAs "
                 f"(counter-checked), B={batch} T={steps}",
                 kind="fusion_traffic", fuse_steps=K, sparsity=sparsity,
                 batch=batch, blocks_touched=touched, blocks_total=total,
                 traffic_ratio=round(touched / max(total, 1), 4),
                 ext_gate_dmas=ext_kernel, counter_consistent=True)
        for backend in backends:
            for K in (fuse_list if backend != "reference" else [1]):
                engine = _engine(W, backend=backend, fuse_steps=K,
                                 device=device)
                t = time_call(lambda e=engine: e.run(ext)["spikes"])
                emit(f"fusion/timestep_{backend}_K{K}_s{sparsity:g}",
                     t / steps,
                     f"us/timestep B={batch} sparsity={sparsity} K={K} "
                     f"gate={engine.gate}",
                     kind="fusion_time", backend=backend, fuse_steps=K,
                     gate=engine.gate, sparsity=sparsity, batch=batch,
                     per_timestep=True)
        for occupancy in (1.0, 0.25):
            n_live = max(1, int(round(occupancy * n_slots)))
            slot_ext = np.zeros((steps, n_slots, N_IN), np.int32)
            slot_ext[:, :n_live] = np.asarray(
                rng.random((steps, n_live, N_IN)) < sparsity, np.int32)
            slot_ext = _spikes(slot_ext, device)
            slot_src = sources_raster(
                slot_ext, ref_engine.run(slot_ext)["spikes"])
            for K in fuse_list:
                touched, total = trace.fused_block_traffic(
                    slot_src, N_IN, fuse_steps=K, tile_batch=1)
                emit(f"fusion/serving_K{K}_occ{occupancy:g}"
                     f"_s{sparsity:g}", None,
                     f"{n_live}/{n_slots} slots live: {touched}/{total} "
                     f"weight blocks "
                     f"({100 * touched / max(total, 1):.1f}% of per-step "
                     f"dense)",
                     kind="fusion_serving", fuse_steps=K,
                     gate="per-example", occupancy=occupancy,
                     sparsity=sparsity, n_slots=n_slots,
                     blocks_touched=touched, blocks_total=total,
                     traffic_ratio=round(touched / max(total, 1), 4))


def bench_kernels(*, batch: int, activity: float, device) -> None:
    """The kernel block: the gated step with its LIF epilogue against its
    oracle, the active source blocks, the LIF update and the encoder."""
    rng = np.random.default_rng(0)
    B, S = batch, N_IN + P
    src = _spikes(rng.random((B, S)) < activity, device)
    W = _randint(rng, -2**14, 2**14, (S, P), device)
    v = _randint(rng, -2**18, 2**18, (B, P), device)

    t_fused = time_call(lambda: ops.spike_timestep(
        src, W, v, decay_rate=0.25, threshold_raw=1 << 16))
    t_ref = time_call(lambda: ref.spike_timestep_ref(
        src, W, v, decay_rate=0.25, threshold_raw=1 << 16,
        reset_mode="zero"))
    emit("kernel/spike_timestep_fused", t_fused,
         f"B={B} S={S} P={P} activity={activity}",
         kind="kernel", batch=B, activity=activity, devices=1)
    emit("kernel/spike_timestep_ref", t_ref, "plain-torch oracle",
         kind="kernel", batch=B, activity=activity, devices=1)

    # event-gating accounting: active source blocks out of total
    blk = 128
    nblk = -(-S // blk)
    padded = np.zeros((B, nblk * blk), np.int32)
    padded[:, :S] = src.cpu().numpy()
    active_blocks = int(
        (padded.reshape(B, nblk, blk).sum(axis=(0, 2)) > 0).sum())
    emit("kernel/active_source_blocks", None,
         f"{active_blocks}/{nblk} touched -> "
         f"{100 * (1 - active_blocks / nblk):.0f}% weight traffic skipped",
         kind="accounting", active_blocks=active_blocks, total_blocks=nblk)

    # LIF + encoder micro-latencies
    vv = _randint(rng, -2**20, 2**20, (B, P), device)
    syn = _randint(rng, -2**16, 2**16, (B, P), device)
    t_lif = time_call(lambda: ops.lif_step(vv, syn, decay_rate=0.25,
                                           threshold_raw=1 << 16))
    emit("kernel/lif_step", t_lif, f"B={B} N={P}",
         kind="kernel", batch=B, devices=1)
    x = torch.from_numpy(rng.random((B, N_IN)).astype(np.float32)).to(device)
    t_enc = time_call(lambda: ops.poisson_encode(0, x, 25))
    emit("kernel/poisson_encode", t_enc, f"B={B} D={N_IN} T=25",
         kind="kernel", batch=B, devices=1)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engines and kernels: 'cuda' "
                         "(the default; raises without a card) or 'cpu' "
                         "(the kernels' plain versions)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--activity", type=float, default=0.05,
                    help="fraction of sources spiking (paper: sparse)")
    ap.add_argument("--backend", choices=list(BACKENDS) + ["all"],
                    default="all",
                    help="SpikeEngine backend(s) to benchmark")
    ap.add_argument("--streaming", action="store_true",
                    help="also benchmark the SpikeServer slot-batch path "
                         "(masked chunk step vs one-shot batch scan)")
    ap.add_argument("--sparsity", default=None, metavar="S1,S2,...",
                    help="comma list of source-activity levels for the "
                         "event-gating sweep (e.g. 0.02,0.05,0.2)")
    ap.add_argument("--fuse-steps", default=None, metavar="K1,K2,...",
                    help="comma list of K values for the K-step fusion "
                         "sweep, with the trace window-OR count "
                         "cross-checked against the kernel's gate scalars "
                         "(e.g. 1,4,8)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write machine-readable results (schema-v2 "
                         "records, the card named in the metadata)")
    # the JAX bench's modes whose modules are not ported yet: each raises
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="not ported yet (ROADMAP Queue 1 item 8)")
    ap.add_argument("--qos", action="store_true",
                    help="not ported yet (ROADMAP Queue 1 item 8)")
    ap.add_argument("--migrate", action="store_true",
                    help="not ported yet (ROADMAP Queue 1 item 7)")
    ap.add_argument("--obs-overhead", action="store_true",
                    help="not ported yet (ROADMAP Queue 1 item 8)")
    ap.add_argument("--devices", type=int, default=1,
                    help="N > 1 is not ported yet (ROADMAP Queue 1 item 9)")
    ap.add_argument("--mesh", default=None, metavar="KNxKB",
                    help="not ported yet (ROADMAP Queue 1 item 9)")
    return ap


def _parse_list(text: str, kind, flag: str) -> list:
    try:
        return [kind(s) for s in text.split(",") if s]
    except ValueError:
        raise SystemExit(f"{flag} must be comma-separated "
                         f"{kind.__name__}s, got {text!r}")


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    for attr, (flag, what) in _UNPORTED.items():
        if getattr(args, attr):
            raise SystemExit(f"{flag} needs {what}, which is not ported to "
                             f"repro_torch yet")
    if args.devices != 1:
        raise SystemExit("--devices N > 1 needs the mesh, ROADMAP Queue 1 "
                         "item 9, which is not ported to repro_torch yet")
    device = resolve_device(args.device)
    backends = list(BACKENDS) if args.backend == "all" else [args.backend]
    if args.json:
        common.start_recording()

    sparsities = None
    if args.sparsity:
        sparsities = _parse_list(args.sparsity, float, "--sparsity")
        bench_event_gating(backends, sparsities, batch=args.batch,
                           n_slots=max(args.batch, 8), device=device)
    if args.fuse_steps:
        fuse_list = _parse_list(args.fuse_steps, int, "--fuse-steps")
        if not fuse_list or any(k < 1 for k in fuse_list):
            raise SystemExit(
                f"--fuse-steps values must be >= 1, got {args.fuse_steps!r}")
        bench_fuse_steps(backends, fuse_list,
                         sparsities if sparsities else [args.activity],
                         batch=args.batch, n_slots=max(args.batch, 8),
                         device=device)
    bench_engine_backends(backends, batch=args.batch,
                          activity=args.activity, device=device)
    if args.streaming:
        bench_streaming(backends, n_slots=args.batch,
                        activity=args.activity, device=device)
    bench_kernels(batch=args.batch, activity=args.activity, device=device)

    if args.json:
        common.write_json(
            args.json, device=device, bench="kernel_bench",
            args={"device": str(device), "batch": args.batch,
                  "activity": args.activity, "backend": args.backend,
                  "streaming": args.streaming, "sparsity": args.sparsity,
                  "fuse_steps": args.fuse_steps})


if __name__ == "__main__":
    main()
