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
* ``--async``: the ``AsyncSpikeFrontend`` request queue on a virtual
  clock (one unit per pump round) at under- and overload, per
  backpressure policy: outcome counts, queue depth, queue-wait and
  service percentiles in rounds;
* ``--qos``: one adversarial burst-over-background plan through FIFO,
  WFQ and preemptive QoS admission, per-class p99 in rounds (the
  isolation claim is enforced on the reference backend);
* ``--migrate``: carry snapshot latency, in-memory and file-backed
  detach -> attach round trips and the blob size, against the feed
  quantum a slot runs in that time;
* ``--obs-overhead``: the same feed loop bare and with a metrics
  registry and a span tracer on, paired per chunk (the 5 % budget is
  enforced on the reference backend);
* the kernel block: ``ops.spike_timestep`` (record
  ``kernel/spike_timestep_fused``: the step with its LIF epilogue fused)
  against ``ref.spike_timestep_ref``, the active source blocks, and
  ``ops.lif_step`` and ``ops.poisson_encode`` (always).

``--devices N`` (optionally with ``--mesh KNxKB``) adds the scale-out
axis: the engine-scan and streaming sections also run on a
``MeshSpikeEngine`` over N logical devices (``ensure_host_devices``: host
entries on the CPU, the visible cards round-robin on ``cuda``), as
``engine/timestep_*_d{N}``, ``streaming/batch_scan_*_d{N}`` and
``streaming/feed_*_d{N}``.

``--json PATH`` writes schema-v2 records with the card's name and power
limit in the metadata.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from repro_torch.benchmarks import common
from repro_torch.benchmarks.common import emit, time_call
from repro_torch.core.engine import (BACKENDS, GATES, DecaySpec, SpikeEngine,
                                     sources_raster)
from repro_torch.device import resolve_device
from repro_torch.distributed.spike_mesh import (ensure_host_devices,
                                                make_spike_mesh,
                                                parse_mesh_spec)
from repro_torch.events import trace
from repro_torch.kernels import ops, ref
from repro_torch.obs import MetricsRegistry, SpanTracer
from repro_torch.serving.connector import (FileCarryConnector,
                                           InMemoryCarryConnector)
from repro_torch.serving.frontend import AsyncSpikeFrontend
from repro_torch.serving.qos import QoSClass, QoSPolicy
from repro_torch.serving.snn import SpikeServer

N_IN, P = 784, 1024


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
                          steps: int = 4, device, mesh=None) -> None:
    """Per-backend engine-scan throughput at the 1024-neuron scale, on one
    device or on ``mesh``."""
    devices = 1 if mesh is None else mesh.size
    rng = np.random.default_rng(0)
    W = _weights(rng, device)
    ext = _spikes(rng.random((steps, batch, N_IN)) < activity, device)
    for backend in backends:
        engine = _engine(W, backend=backend, device=device)
        if mesh is not None:
            engine = engine.to_mesh(mesh)
        t_run = time_call(lambda e=engine: e.run(ext)["spikes"])
        emit(f"engine/timestep_{backend}_d{devices}", t_run / steps,
             f"us/timestep B={batch} S={N_IN + P} P={P} "
             f"activity={activity} T={steps} devices={devices}",
             kind="engine_scan", backend=backend, gate=engine.gate,
             batch=batch, activity=activity, devices=devices,
             per_timestep=True)


def bench_streaming(backends, *, n_slots: int, activity: float,
                    chunk_steps: int = 8, rounds: int = 3, device,
                    mesh=None) -> None:
    """The serving axis: masked slot-batch chunk step (SpikeServer.feed)
    vs the one-shot batch scan on the same raster, plus the cost of a
    partially occupied slot batch; on one device or on ``mesh``."""
    devices = 1 if mesh is None else mesh.size
    rng = np.random.default_rng(0)
    W = _weights(rng, device)
    T = chunk_steps * rounds
    rasters = [(rng.random((T, N_IN)) < activity).astype(np.int32)
               for _ in range(n_slots)]
    batch = _spikes(np.stack(rasters, axis=1), device)  # (T, n_slots, n_in)
    for backend in backends:
        engine = _engine(W, backend=backend, device=device)
        if mesh is not None:
            engine = engine.to_mesh(mesh)
        t_batch = time_call(lambda e=engine: e.run(batch)["spikes"])
        emit(f"streaming/batch_scan_{backend}_d{devices}", t_batch / T,
             f"us/timestep B={n_slots} T={T} devices={devices} "
             f"(one-shot run)",
             kind="streaming_batch_scan", backend=backend, gate=engine.gate,
             batch=n_slots, activity=activity, devices=devices,
             per_timestep=True)
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
            emit(f"streaming/feed_{backend}_occ{occupancy:g}_d{devices}",
                 t_srv / T,
                 f"us/timestep {n_live}/{n_slots} slots live, "
                 f"chunk={chunk_steps} devices={devices} "
                 f"(masked step, per-chunk host hop)",
                 kind="streaming_feed", backend=backend, gate=engine.gate,
                 batch=n_slots, occupancy=occupancy, activity=activity,
                 devices=devices, per_timestep=True)


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


def bench_async_frontend(backends, *, n_slots: int = 8,
                         chunk_steps: int = 8, n_requests: int = 24,
                         T: int = 32, activity: float = 0.05,
                         queue_capacity: int = 6, device) -> None:
    """The async front-door axis on a VIRTUAL clock (1 unit per pump
    round): requests arrive open-loop at ``load`` x the slot service rate
    (``n_slots * chunk_steps / T`` streams per round); underload keeps
    the queue shallow, overload grows it until backpressure or a
    deadline sheds load. Wall time gives the served steps/s beside the
    outcome counts and queue-wait / service percentiles (in rounds)."""
    rng = np.random.default_rng(0)
    W = _weights(rng, device)
    rasters = [(rng.random((T, N_IN)) < activity).astype(np.int32)
               for _ in range(n_requests)]
    service_rate = n_slots * chunk_steps / T  # streams retired per round
    regimes = [(0.5, "reject", None), (2.0, "reject", None),
               (2.0, "drop-oldest", None), (2.0, "reject", 3.0)]
    for backend in backends:
        engine = _engine(W, backend=backend, device=device)
        for load, policy, deadline_rounds in regimes:
            server = SpikeServer(engine, n_slots=n_slots,
                                 chunk_steps=chunk_steps, device=device)
            t_virtual = [0.0]
            fe = AsyncSpikeFrontend(
                server, queue_capacity=queue_capacity, backpressure=policy,
                deadline_ms=(None if deadline_rounds is None
                             else deadline_rounds * 1e3),
                clock=lambda t=t_virtual: t[0])
            arrive_at = [i / (load * service_rate)
                         for i in range(n_requests)]
            i = 0
            t0 = time.perf_counter()
            while i < n_requests or not fe.idle:
                while i < n_requests and arrive_at[i] <= t_virtual[0]:
                    fe.submit(rasters[i])
                    i += 1
                fe.pump()
                t_virtual[0] += 1.0
            wall = time.perf_counter() - t0
            m = fe.metrics()
            c = m["counts"]
            dl = ("" if deadline_rounds is None
                  else f"_dl{deadline_rounds:g}")
            emit(f"async/frontend_{backend}_load{load:g}_{policy}{dl}",
                 wall * 1e6 / max(server.total_steps, 1),
                 f"{c.get('done', 0)}/{n_requests} done, "
                 f"{c.get('rejected', 0)} rej, {c.get('dropped', 0)} drop, "
                 f"{c.get('expired', 0)} exp, queue depth max "
                 f"{m['queue_depth']['max']}/{queue_capacity}, "
                 f"offered {load:g}x service rate",
                 kind="async_frontend", backend=backend, load_factor=load,
                 policy=policy, deadline_rounds=deadline_rounds,
                 n_requests=n_requests, n_slots=n_slots,
                 queue_capacity=queue_capacity,
                 done=c.get("done", 0), rejected=c.get("rejected", 0),
                 dropped=c.get("dropped", 0), expired=c.get("expired", 0),
                 queue_depth_max=m["queue_depth"]["max"],
                 queue_wait_p50_rounds=m["queue_wait"]["p50"],
                 queue_wait_p95_rounds=m["queue_wait"]["p95"],
                 service_p50_rounds=m["service"]["p50"],
                 per_timestep=True)


def bench_qos_frontend(backends, *, n_slots: int = 4, chunk_steps: int = 8,
                       T: int = 32, n_bg: int = 16, n_hi: int = 8,
                       activity: float = 0.05, device) -> None:
    """Per-class latency isolation on a virtual clock: a background class
    arrives at 2x the slot service rate while a burst class lands all at
    once at round 6, through FIFO, WFQ (burst class in a higher stratum,
    4x weight) and WFQ with preemption. The claim, high-priority p99
    strictly below FIFO's at the same load, is ENFORCED on the reference
    backend."""
    rng = np.random.default_rng(0)
    W = _weights(rng, device)
    rasters = [(rng.random((T, N_IN)) < activity).astype(np.int32)
               for _ in range(n_bg + n_hi)]
    plan = sorted([(0.5 * i, "bg", rasters[i]) for i in range(n_bg)]
                  + [(6.0, "hi", rasters[n_bg + i])
                     for i in range(n_hi)], key=lambda e: e[0])
    classes = {"hi": QoSClass(priority=1, weight=4),
               "bg": QoSClass(priority=0, weight=1)}
    scenarios = [("fifo", None), ("wfq", QoSPolicy(classes=classes)),
                 ("preempt", QoSPolicy(classes=classes, preempt=True))]
    for backend in backends:
        engine = _engine(W, backend=backend, device=device)
        fifo_hi_p99 = None
        for scenario, policy in scenarios:
            server = SpikeServer(engine, n_slots=n_slots,
                                 chunk_steps=chunk_steps, device=device)
            t_virtual = [0.0]
            fe = AsyncSpikeFrontend(
                server, queue_capacity=n_bg + n_hi + 1,
                clock=lambda t=t_virtual: t[0], qos=policy,
                connector=(InMemoryCarryConnector()
                           if policy is not None and policy.preempt
                           else None))
            i = 0
            t0 = time.perf_counter()
            while i < len(plan) or not fe.idle:
                while i < len(plan) and plan[i][0] <= t_virtual[0]:
                    fe.submit(plan[i][2], tenant=plan[i][1])
                    i += 1
                fe.pump()
                t_virtual[0] += 1.0
            wall = time.perf_counter() - t0
            m = fe.metrics()
            hi, bg = m["by_class"]["hi"], m["by_class"]["bg"]
            hi_p99, bg_p99 = hi["total"]["p99"], bg["total"]["p99"]
            if scenario == "fifo":
                fifo_hi_p99 = hi_p99
            emit(f"qos/frontend_{backend}_{scenario}",
                 wall * 1e6 / max(server.total_steps, 1),
                 f"hi p99 {hi_p99:g} rounds vs bg {bg_p99:g} (fifo hi "
                 f"{fifo_hi_p99:g}); {m['counts']['done']}/{len(plan)} "
                 f"done, {m['counts']['evicted']} preempted",
                 kind="qos_frontend", backend=backend, scenario=scenario,
                 n_requests=len(plan), n_slots=n_slots,
                 chunk_steps=chunk_steps,
                 hi_p99_rounds=hi_p99, bg_p99_rounds=bg_p99,
                 hi_p50_rounds=hi["total"]["p50"],
                 bg_p50_rounds=bg["total"]["p50"],
                 fifo_hi_p99_rounds=fifo_hi_p99,
                 done=m["counts"]["done"],
                 evicted=m["counts"]["evicted"],
                 parked=m["counts"]["parked"],
                 per_timestep=True)
            if (backend == "reference" and scenario != "fifo"
                    and not hi_p99 < fifo_hi_p99):
                raise SystemExit(
                    f"QoS isolation claim failed: {scenario} hi-class "
                    f"p99 {hi_p99:g} rounds is not strictly below the "
                    f"FIFO baseline {fifo_hi_p99:g} at the same offered "
                    f"load")


def bench_migration(backends, *, n_slots: int = 8, chunk_steps: int = 8,
                    activity: float = 0.05, device) -> None:
    """The price of a stream-state move beside the work it displaces:
    snapshot latency (one device-to-host copy of the carry rows), an
    in-memory and a file-backed detach -> attach round trip, and the
    serialized blob size, against the ``chunk_steps`` feed quantum."""
    rng = np.random.default_rng(0)
    W = _weights(rng, device)
    chunk = (rng.random((chunk_steps, N_IN)) < activity).astype(np.int32)
    for backend in backends:
        engine = _engine(W, backend=backend, device=device)
        server = SpikeServer(engine, n_slots=n_slots,
                             chunk_steps=chunk_steps, device=device)
        uids = [server.attach(f"s{i}") for i in range(n_slots - 1)]
        server.feed({uid: chunk for uid in uids})  # warm carries
        uid = uids[0]
        t_feed = time_call(
            lambda: server.feed({u: chunk for u in uids})[uid]["spikes"])
        snap = server.snapshot_stream(uid)
        blob_bytes = len(snap.to_bytes())
        t_snap = time_call(lambda: server.snapshot_stream(uid).to_bytes())

        def roundtrip(conn):
            server.detach_stream(uid, conn)
            server.attach_stream(conn, uid)
            return server.carry["v"]

        t_mem = time_call(lambda: roundtrip(InMemoryCarryConnector()))
        with tempfile.TemporaryDirectory() as d:
            disk = FileCarryConnector(d)
            t_disk = time_call(lambda: roundtrip(disk))
        emit(f"migration/roundtrip_{backend}", t_mem,
             f"snapshot {t_snap:.0f} us, mem move {t_mem:.0f} us, file "
             f"move {t_disk:.0f} us, blob {blob_bytes} B vs "
             f"{chunk_steps}-step feed quantum {t_feed:.0f} us",
             kind="migration", backend=backend, n_slots=n_slots,
             snapshot_us=round(t_snap, 2), roundtrip_mem_us=round(t_mem, 2),
             roundtrip_file_us=round(t_disk, 2), blob_bytes=blob_bytes,
             feed_quantum_us=round(t_feed, 2),
             migration_vs_quantum=round(t_mem / max(t_feed, 1e-9), 4))


def bench_obs_overhead(backends, *, n_slots: int = 8, chunk_steps: int = 8,
                       rounds: int = 6, activity: float = 0.05,
                       budget: float = 0.05, device) -> None:
    """Telemetry must be ~free: the SAME feed loop bare and instrumented
    (metrics registry + span tracer), timed back to back per chunk with
    alternating order; the estimate is the median paired difference over
    the median bare chunk, the floor of three trials. Beyond ``budget``
    on the reference backend is a ``SystemExit``."""
    rng = np.random.default_rng(0)
    W = _weights(rng, device)
    T = chunk_steps * rounds
    rasters = [(rng.random((T, N_IN)) < activity).astype(np.int32)
               for _ in range(n_slots)]
    for backend in backends:
        engine = _engine(W, backend=backend, device=device)

        def make_server(telemetry: bool):
            srv = SpikeServer(
                engine, n_slots=n_slots, chunk_steps=chunk_steps,
                device=device,
                metrics=MetricsRegistry() if telemetry else None,
                tracer=SpanTracer() if telemetry else None)
            return srv, [srv.attach() for _ in range(n_slots)]

        def chunk_at(uids, t0):
            return {u: rasters[i][t0:t0 + chunk_steps]
                    for i, u in enumerate(uids)}

        def timed(server, chunks):
            t = time.perf_counter()
            server.feed(chunks)
            return time.perf_counter() - t

        bare, bare_uids = make_server(False)
        inst, inst_uids = make_server(True)
        for t0 in range(0, T, chunk_steps):  # warmup
            bare.feed(chunk_at(bare_uids, t0))
            inst.feed(chunk_at(inst_uids, t0))
        estimates = []  # (overhead, median bare, median diff) per trial
        for _ in range(3):
            bare_s, diffs = [], []
            for it in range(7):
                for t0 in range(0, T, chunk_steps):
                    cb = chunk_at(bare_uids, t0)
                    ci = chunk_at(inst_uids, t0)
                    if (it + t0 // chunk_steps) % 2:
                        ti = timed(inst, ci)
                        tb = timed(bare, cb)
                    else:
                        tb = timed(bare, cb)
                        ti = timed(inst, ci)
                    bare_s.append(tb)
                    diffs.append(ti - tb)
            bare_s.sort()
            diffs.sort()
            med_bare = bare_s[len(bare_s) // 2]
            med_diff = diffs[len(diffs) // 2]
            estimates.append((med_diff / med_bare, med_bare, med_diff))
        overhead, med_bare, med_diff = min(estimates)
        t_bare = med_bare * rounds * 1e6  # per feed loop
        t_obs = (med_bare + med_diff) * rounds * 1e6
        emit(f"obs/overhead_{backend}", t_obs / T,
             f"instrumented {t_obs / T:.1f} vs bare {t_bare / T:.1f} "
             f"us/timestep ({100 * overhead:+.2f}% with metrics+tracer on, "
             f"{n_slots} slots x {chunk_steps}-step chunks)",
             kind="obs_overhead", backend=backend, batch=n_slots,
             activity=activity,
             bare_us_per_step=round(t_bare / T, 3),
             instrumented_us_per_step=round(t_obs / T, 3),
             overhead_frac=round(overhead, 4),
             per_timestep=True)
        if backend == "reference" and overhead > budget:
            raise SystemExit(
                f"observability overhead {overhead:.1%} exceeds the "
                f"{budget:.0%} budget on the reference backend "
                f"(instrumented {t_obs / T:.1f} vs bare {t_bare / T:.1f} "
                f"us/timestep)")


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
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="also benchmark the AsyncSpikeFrontend request "
                         "queue per backpressure policy x offered load "
                         "(under/overload on a virtual clock)")
    ap.add_argument("--qos", action="store_true",
                    help="also benchmark FIFO vs WFQ vs preemptive QoS "
                         "admission on one burst-over-background plan "
                         "(isolation claim enforced on the reference "
                         "backend)")
    ap.add_argument("--migrate", action="store_true",
                    help="also benchmark stream-state migration: snapshot "
                         "latency, in-memory and file round trips, blob "
                         "size vs the feed quantum")
    ap.add_argument("--obs-overhead", action="store_true",
                    help="also benchmark the telemetry cost: the feed loop "
                         "bare vs instrumented (5%% budget enforced on the "
                         "reference backend)")
    ap.add_argument("--devices", type=int, default=1,
                    help="also run the engine/streaming benches on a mesh "
                         "over N logical devices (host entries with "
                         "--device cpu; the visible cards round-robin on "
                         "cuda)")
    ap.add_argument("--mesh", default=None, metavar="KNxKB",
                    help="neuron x batch mesh split for --devices "
                         "(default: 2 x N/2 when N allows)")
    return ap


def _parse_list(text: str, kind, flag: str) -> list:
    try:
        return [kind(s) for s in text.split(",") if s]
    except ValueError:
        raise SystemExit(f"{flag} must be comma-separated "
                         f"{kind.__name__}s, got {text!r}")


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if args.mesh and args.devices <= 1:
        raise SystemExit("--mesh requires --devices N (N > 1); without it "
                         "the sharded benches would silently not run")
    device = resolve_device(args.device)
    backends = list(BACKENDS) if args.backend == "all" else [args.backend]
    if args.json:
        common.start_recording()

    mesh = None
    if args.devices > 1:
        try:
            kn, kb = parse_mesh_spec(args.devices, args.mesh)
        except ValueError as e:
            raise SystemExit(str(e))
        mesh = make_spike_mesh(neuron=kn, batch=kb,
                               devices=ensure_host_devices(args.devices,
                                                           device))
        print(f"[bench] mesh axis: {kn} neuron shards x {kb} batch shards "
              f"({args.devices} devices on "
              f"{len(mesh.physical_devices)} physical)", flush=True)

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
    if mesh is not None:
        bench_engine_backends(backends, batch=args.batch,
                              activity=args.activity, device=device,
                              mesh=mesh)
    if args.streaming:
        bench_streaming(backends, n_slots=args.batch,
                        activity=args.activity, device=device)
        if mesh is not None:
            bench_streaming(backends, n_slots=args.batch,
                            activity=args.activity, device=device, mesh=mesh)
    if args.async_mode:
        bench_async_frontend(backends, activity=args.activity,
                             device=device)
    if args.qos:
        bench_qos_frontend(backends, activity=args.activity, device=device)
    if args.migrate:
        bench_migration(backends, activity=args.activity, device=device)
    if args.obs_overhead:
        bench_obs_overhead(backends, activity=args.activity, device=device)
    bench_kernels(batch=args.batch, activity=args.activity, device=device)

    if args.json:
        common.write_json(
            args.json, device=device, bench="kernel_bench",
            args={"device": str(device), "batch": args.batch,
                  "activity": args.activity, "backend": args.backend,
                  "streaming": args.streaming, "async": args.async_mode,
                  "qos": args.qos, "sparsity": args.sparsity,
                  "fuse_steps": args.fuse_steps, "migrate": args.migrate,
                  "obs_overhead": args.obs_overhead,
                  "devices": args.devices, "mesh": args.mesh})


if __name__ == "__main__":
    main()
