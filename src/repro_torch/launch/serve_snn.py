"""Streaming SNN serving launcher: ``python -m repro_torch.launch.serve_snn``.

Twin of :mod:`repro.launch.serve_snn`: brings up an
:class:`~repro_torch.core.session.AcceleratorSession` on ``--device``
(default ``cuda``), deploys co-resident random SNNs, and drives synthetic
Poisson request traffic through the streaming server. In the sync mode
streams arrive per chunk-round, wait FIFO for a batch slot, push their
stimulus in fixed-size chunks through one slot-batch step, and detach;
``--drain N`` hot-deploys one more model after N rounds (a rolling
redeploy through the carry connector). ``--async`` drives the same plan
open-loop through the :class:`~repro_torch.serving.frontend.
AsyncSpikeFrontend` request queue, with backpressure, deadlines (spilled
to the connector and resumed once), multi-tenant QoS with optional
preemption, a burst tenant and SLO objectives.

Every run is instrumented: a metrics registry and a span tracer ride the
session into the server, frontend and connector; ``--metrics``,
``--trace``, ``--flight``, ``--profile`` and ``--json-summary`` export
them. The summary also reports the kernel launches of the run
(``--fuse-steps K`` serves K-step fused windows, one fused kernel launch
each).

``--devices N`` (with optional ``--mesh KNxKB``) runs the fused server
mesh-sharded (``AcceleratorSession(mesh=...)``) over N logical devices
from ``ensure_host_devices(N, --device)``: N host entries on the CPU, the
visible cards round-robin on ``cuda`` (shards share a card when N exceeds
the card count; the summary says how many physical devices back the N
shards). Outputs are byte-identical. A :class:`ShardLoadWatch` attributes
each chunk dispatch's time to the batch shards by their live-slot load;
persistently flagged shards get a slot-rebalance suggestion, and their
streams are migrated once onto donor shards (``rebalance_streams``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.bench_schema import SCHEMA_VERSION
from repro_torch.core import coding, prng
from repro_torch.core.energy import EnergyModel, counts_from_registry
from repro_torch.core.engine import BACKENDS, GATES, sources_raster
from repro_torch.core.lif import LIFParams
from repro_torch.core.network import SNNetwork
from repro_torch.core.session import AcceleratorSession
from repro_torch.distributed.spike_mesh import (ensure_host_devices,
                                                make_spike_mesh,
                                                parse_mesh_spec)
from repro_torch.distributed.straggler import (StragglerDetector,
                                               observe_from_registry,
                                               rebalance_shards)
from repro_torch.events.trace import block_traffic
from repro_torch.kernels import ops
from repro_torch.obs import (FlightRecorder, MetricsRegistry, SLObjective,
                             SLOWatchdog, SpanTracer, set_registry)
from repro_torch.obs.tracing import profile_trace
from repro_torch.serving.connector import (FileCarryConnector,
                                           rebalance_streams)
from repro_torch.serving.frontend import BACKPRESSURE, FrontendConfig
from repro_torch.serving.qos import QoSClass, QoSPolicy


def make_net(rng, n_in: int, n_neurons: int, *, density: float = 0.25,
             out: int = 10) -> SNNetwork:
    """Small random recurrent SNN with an output population."""
    W = ((rng.random((n_in + n_neurons, n_neurons)) < density)
         * rng.normal(0.0, 0.5, (n_in + n_neurons, n_neurons)))
    return SNNetwork(
        n_inputs=n_in, n_neurons=n_neurons,
        weights=W.astype(np.float32),
        params=LIFParams(decay_rate=0.25, threshold=1.0, reset_mode="zero"),
        output_slice=(n_neurons - out, n_neurons))


class ShardLoadWatch:
    """Straggler watch over the serving loop's synchronous dispatches.

    A single-controller mesh step yields ONE host-observed wall time per
    chunk. What IS observable per batch shard is its live-slot load, so
    each dispatch's time is attributed to shards proportionally to the
    live slots they own (slots map to batch shards contiguously,
    ``slot // slots_per_shard``). A shard that persistently carries more
    live streams than the fleet, which FIFO slot reuse can produce,
    accumulates strikes and earns a ``rebalance_shards`` suggestion.
    """

    # a shard earns a rebalance suggestion only when flagged in at least
    # this fraction of dispatches (and at least twice): a transient
    # 3-chunk imbalance at admission time should not brand the whole run
    PERSISTENT_FRACTION = 0.1

    def __init__(self, n_shards: int, n_slots: int, registry=None,
                 tracer=None):
        self.n_shards = int(n_shards)
        self.n_slots = int(n_slots)
        padded = -(-n_slots // n_shards) * n_shards
        self.slots_per_shard = padded // n_shards
        self.detector = StragglerDetector(num_hosts=n_shards,
                                          warmup_steps=3, patience=3)
        #: optional MetricsRegistry: each dispatch publishes the
        #: attributed per-shard times as ``snn_shard_step_seconds`` gauges
        #: and the detector steps THROUGH the registry, so the exported
        #: timings are exactly what the flags were computed from
        self.registry = registry
        #: optional SpanTracer: each dispatch records one ``shard_step``
        #: span (per-shard attributed times and their flags), the record
        #: ``obs.timeline.mesh_lanes`` folds
        self.tracer = tracer
        self.flag_counts = np.zeros(n_shards, np.int64)
        self.chunk_times: list[float] = []

    def observe(self, dt: float, live_slots) -> None:
        self.chunk_times.append(dt)
        load = np.zeros(self.n_shards)
        for slot in live_slots:
            load[slot // self.slots_per_shard] += 1
        mean = load.mean()
        attributed = dt * load / mean if mean > 0 else np.full(
            self.n_shards, dt)
        if self.registry is not None:
            fam = self.registry.gauge("snn_shard_step_seconds")
            for shard, t in enumerate(attributed):
                fam.labels(shard=shard).set(float(t))
            flags = observe_from_registry(self.detector, self.registry,
                                          tracer=self.tracer)
        else:
            flags = self.detector.observe(attributed)
            if self.tracer is not None:
                self.tracer.event("shard_step", None,
                                  times=[float(t) for t in attributed],
                                  flags=[int(f) for f in flags])
        self.flag_counts += flags

    def persistent_flags(self) -> np.ndarray:
        """Shards flagged persistently enough to act on (bool mask)."""
        return self.flag_counts >= max(
            2, int(self.PERSISTENT_FRACTION * max(len(self.chunk_times), 1)))

    def report(self) -> dict | None:
        """Structured straggler-watch summary (None before any dispatch)."""
        if not self.chunk_times:
            return None
        ct = np.asarray(self.chunk_times) * 1e3
        rep = {
            "dispatches": len(ct),
            "n_shards": self.n_shards,
            "dispatch_ms": {"p50": float(np.percentile(ct, 50)),
                            "p95": float(np.percentile(ct, 95))},
        }
        if self.n_shards > 1:
            persistent = self.persistent_flags()
            rep.update({
                "attributed_mean_s": float(self.detector.stats["mean"]
                                           .mean()),
                "flag_counts": self.flag_counts.tolist(),
                "persistent": np.where(persistent)[0].tolist(),
                "all_flagged": bool(persistent.all()),
                "suggested_slot_split": rebalance_shards(
                    self.n_slots, persistent).tolist(),
            })
        return rep


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=24,
                    help="total streams to serve")
    ap.add_argument("--n-slots", type=int, default=8,
                    help="batch slots (concurrent streams)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="timesteps pushed per feed() call")
    ap.add_argument("--steps-per-stream", type=int, default=48,
                    help="inference timesteps each stream requests")
    ap.add_argument("--arrival-rate", type=float, default=4.0,
                    help="Poisson arrivals per chunk-round (sync mode) or "
                         "per SECOND, open-loop (--async)")
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="drive traffic through the AsyncSpikeFrontend "
                         "request queue instead of the synchronous loop")
    ap.add_argument("--backpressure", choices=list(BACKPRESSURE),
                    default="reject",
                    help="frontend policy when the request queue is full "
                         "(--async only)")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-request deadline (--async only): queued "
                         "requests past it are refused, running ones are "
                         "spilled to the connector and resumed once")
    ap.add_argument("--queue-capacity", type=int, default=32,
                    help="bounded frontend request queue (--async only)")
    ap.add_argument("--qos", default=None, metavar="SPEC",
                    help="multi-tenant QoS admission (--async only): a "
                         "comma list of NAME=PRIO:WEIGHT[:QUOTA[:RATE"
                         "[:BURST]]] tenant classes; requests are assigned "
                         "tenants round-robin over the classes")
    ap.add_argument("--qos-preempt", action="store_true",
                    help="SLO-aware eviction (--qos only): a queued request "
                         "whose class outranks a running stream parks the "
                         "lowest-priority running stream in the connector")
    ap.add_argument("--burst", default=None, metavar="NAME",
                    help="the NAME tenant's requests arrive as one dense "
                         "burst at --burst-at, spaced by --burst-rate "
                         "(--async only)")
    ap.add_argument("--burst-rate", type=float, default=None,
                    help="arrivals per second inside the burst "
                         "(default: 10x --arrival-rate)")
    ap.add_argument("--burst-at", type=float, default=None,
                    help="burst start time in seconds (default: 25%% "
                         "into the background arrival span)")
    ap.add_argument("--slo-p99-ms", type=float, default=None,
                    help="SLO objective (--async only): p99 total latency "
                         "under this many ms on the rolling window")
    ap.add_argument("--slo-miss-ratio", type=float, default=None,
                    help="SLO objective (--async only): deadline misses / "
                         "(misses + dones) under this ratio")
    ap.add_argument("--slo-queue-depth", type=int, default=None,
                    help="SLO objective (--async only): admission queue at "
                         "or under this depth")
    ap.add_argument("--slo-window-s", type=float, default=60.0,
                    help="rolling window (seconds) of the --slo-* "
                         "objectives")
    ap.add_argument("--flight", default=None, metavar="FILE",
                    help="arm a bounded flight recorder: dumps a "
                         "post-mortem JSON to FILE on a crash or an --slo-* "
                         "breach")
    ap.add_argument("--backend", choices=list(BACKENDS), default="reference")
    ap.add_argument("--gate", choices=list(GATES), default=None,
                    help="event-gate granularity of the serving engine "
                         "(per-example = the batch-tile=1 serving mode)")
    ap.add_argument("--fuse-steps", type=int, default=1,
                    help="K timesteps per fused kernel window on the "
                         "serving engine (kernel backends; outputs "
                         "byte-identical for any K)")
    ap.add_argument("--models", type=int, default=2,
                    help="co-resident models sharing the fused engine")
    ap.add_argument("--devices", type=int, default=1,
                    help="shard the fused server over N logical devices "
                         "(host entries with --device cpu; the visible "
                         "cards round-robin on cuda, shards sharing a card "
                         "beyond the card count)")
    ap.add_argument("--mesh", default=None, metavar="KNxKB",
                    help="neuron x batch mesh split for --devices "
                         "(default: 2 x N/2 when N allows)")
    ap.add_argument("--connector", default=None, metavar="DIR",
                    help="root a FILE-backed carry connector at DIR "
                         "(default: in-memory): redeploy drains and async "
                         "spills park carries there")
    ap.add_argument("--drain", type=int, default=None, metavar="ROUND",
                    help="rolling redeploy drill (sync mode): after ROUND "
                         "chunk-rounds, hot-deploy one extra model; live "
                         "streams are drained to the connector and "
                         "restored into the new fused server")
    ap.add_argument("--metrics", default=None, metavar="FILE|-",
                    help="write the run's Prometheus text exposition to "
                         "FILE, or '-' for stdout")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="export the stream-lifecycle span log as JSONL")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a torch.profiler trace (CPU and CUDA) of "
                         "the serving loop into DIR, with lifecycle spans "
                         "as record_function ranges")
    ap.add_argument("--json-summary", nargs="?", const="-", default=None,
                    metavar="FILE",
                    help="also emit the structured run summary as one JSON "
                         "object, to stdout or to FILE")
    ap.add_argument("--n-inputs", type=int, default=24)
    ap.add_argument("--n-neurons", type=int, default=48)
    ap.add_argument("--intensity", type=float, default=0.25,
                    help="stimulus intensity scale (Poisson spike rate "
                         "cap); event workloads live well below 1.0")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine and its carries "
                         "('cuda' needs a card; 'cpu' runs the plain path)")
    return ap


def _parse_qos(spec: str, *, preempt: bool = False) -> QoSPolicy:
    """``NAME=PRIO:WEIGHT[:QUOTA[:RATE[:BURST]]],...`` -> QoSPolicy."""
    classes = {}
    for entry in spec.split(","):
        entry = entry.strip()
        name, eq, rest = entry.partition("=")
        parts = rest.split(":")
        if not name or not eq or len(parts) < 2 or len(parts) > 5:
            raise SystemExit(
                f"--qos entry {entry!r} is not "
                f"NAME=PRIO:WEIGHT[:QUOTA[:RATE[:BURST]]]")
        try:
            classes[name.strip()] = QoSClass(
                priority=int(parts[0]),
                weight=int(parts[1]),
                max_slots=(int(parts[2])
                           if len(parts) > 2 and parts[2] else None),
                rate_per_s=(float(parts[3])
                            if len(parts) > 3 and parts[3] else None),
                burst=(int(parts[4])
                       if len(parts) > 4 and parts[4] else 1),
            )
        except ValueError as e:
            raise SystemExit(f"--qos entry {entry!r}: {e}")
    return QoSPolicy(classes=classes, preempt=preempt)


def _assign_tenants(args, qos: QoSPolicy | None, n: int) -> list[str]:
    """Round-robin tenant labels over the QoS classes, or over {burst
    tenant, "default"} when only --burst shapes the traffic."""
    if qos is not None and qos.classes:
        names = list(qos.classes)
    elif args.burst:
        names = [args.burst, "default"]
    else:
        return ["default"] * n
    return [names[i % len(names)] for i in range(n)]


def _request_plan(args, names, rng) -> list:
    """Stream i -> (uid, model, Poisson-encoded (T, n_inputs) stimulus),
    encoded on the host with the i-th key split off ``prng.key(--seed)``,
    as the JAX launcher splits ``jax.random.key(--seed)``: the same seed
    gives the JAX launcher's stimuli."""
    key = prng.key(args.seed)
    requests = []
    for uid in range(args.streams):
        key, k = prng.split(key)
        intensity = (args.intensity
                     * rng.random((1, args.n_inputs)).astype(np.float32))
        spikes = coding.poisson_encode(k, intensity, args.steps_per_stream,
                                       dtype=torch.int32)[:, 0].numpy()
        requests.append((uid, names[uid % len(names)], spikes))
    return requests


def _fmt_lat(stats: dict) -> str:
    """'mean X ms, p50 Y ms, p95 Z ms' from a latency_percentiles dict."""
    if stats["mean"] is None:
        return "n/a (no samples)"
    return (f"mean {stats['mean'] * 1e3:.1f} ms, "
            f"p50 {stats['p50'] * 1e3:.1f} ms, "
            f"p95 {stats['p95'] * 1e3:.1f} ms")


# ---------------------------------------------------------------------
# Run summary: ONE structured dict, rendered by ONE formatter; the
# "[serve-snn] ..." lines and --json-summary are two views of it.
# ---------------------------------------------------------------------
def _server_report(registry: MetricsRegistry) -> dict:
    """The instrumented SpikeServer's measured-work counters."""
    c = registry.counter
    ev = c("snn_server_source_events_total")
    return {
        "chunks": int(c("snn_server_chunks_total").value),
        "steps": int(c("snn_server_steps_total").value),
        "spikes": int(c("snn_server_spikes_total").value),
        "source_events": {
            "external": int(ev.labels(kind="external").value),
            "recurrent": int(ev.labels(kind="recurrent").value),
        },
        "sops": int(c("snn_server_sops_total").value),
        "row_fetches": int(c("snn_server_row_fetches_total").value),
        "weight_blocks": {
            "fetched": int(c("snn_server_weight_blocks_fetched_total")
                           .value),
            "dense": int(c("snn_server_weight_blocks_dense_total").value),
        },
    }


def _energy_report(registry: MetricsRegistry) -> dict | None:
    """Price the live run with the Table-V-calibrated model (None until
    the server has measured any SOPs)."""
    counts = counts_from_registry(registry)
    if counts.sops == 0:
        return None
    model = EnergyModel.calibrated()
    return {
        "sops": counts.sops,
        "row_fetches": counts.row_fetches,
        "cycles_ref_duty": counts.cycles,
        "breakdown_mw": model.breakdown_mw(counts),
        "energy_uj": model.energy_uj(counts),
    }


def _render_summary(s: dict) -> list[str]:
    """The human-readable lines for a run-summary dict."""
    lines = []
    if s["mode"] == "async":
        fe, c = s["frontend"], s["frontend"]["counts"]
        lines.append(
            f"[serve-snn] async front door: {s['requests']} requests "
            f"offered open-loop at {s['offered_rate_per_s']:.1f}/s "
            f"(policy={s['policy']}, queue capacity {s['queue_capacity']}, "
            f"deadline {s['deadline_ms']} ms), served in "
            f"{s['wall_s']:.2f}s over {fe['rounds']} pump rounds")
        lines.append(
            f"[serve-snn] outcomes: {c['done']} done, {c['rejected']} "
            f"rejected, {c['dropped']} dropped, {c['expired']} expired "
            f"({c['expired_queued']} queued / {c['expired_running']} "
            f"mid-stream), {c['cancelled']} cancelled; {s['steps']} "
            f"stream-timesteps -> {s['steps_per_s']:.0f} steps/s")
        if c["parked"]:
            lines.append(
                f"[serve-snn] spill-on-evict: {c['parked']} mid-stream "
                f"evictions ({c['evicted']} QoS preemptions) parked "
                f"their carry in the connector, {c['resumed']} resumed "
                f"bit-clean")
        lines.append(
            f"[serve-snn] queue depth: max {fe['queue_depth']['max']}, "
            f"mean {fe['queue_depth']['mean']:.1f} "
            f"(capacity {s['queue_capacity']})")
        lines.append(f"[serve-snn] queue-wait: {_fmt_lat(fe['queue_wait'])}")
        lines.append(f"[serve-snn] service:    {_fmt_lat(fe['service'])}")
        lines.append(f"[serve-snn] total:      {_fmt_lat(fe['total'])}")
        if s.get("qos"):
            q = s["qos"]
            lines.append(
                f"[serve-snn] qos: {len(q['classes'])} tenant classes "
                f"(quantum {q['quantum']}, preempt "
                f"{'on' if q['preempt'] else 'off'})"
                + (f"; burst tenant {s['burst']['tenant']!r}: "
                   f"{s['burst']['requests']} requests at "
                   f"{s['burst']['rate_per_s']:.1f}/s from "
                   f"t={s['burst']['at_s']:.2f}s" if s.get("burst")
                   else ""))
        by_cls = fe.get("by_class") or {}
        if not s.get("qos") and len(by_cls) < 2:
            by_cls = {}
        for cls in sorted(by_cls):
            d = by_cls[cls]
            cc, tot = d["counts"], d["total"]
            lat = ("total n/a (no samples)" if tot["p50"] is None else
                   f"total p50 {tot['p50'] * 1e3:.1f} ms, "
                   f"p95 {tot['p95'] * 1e3:.1f} ms, "
                   f"p99 {tot['p99'] * 1e3:.1f} ms")
            lines.append(
                f"[serve-snn] class {cls}: {cc['done']} done, "
                f"{cc['rejected'] + cc['dropped']} shed, "
                f"{cc['expired']} expired, {cc['evicted']} preempted; "
                f"{lat}")
        if s.get("slo"):
            parts = [f"{o['name']} burn {o['burn_rate']:.2f}"
                     + (" BREACHING" if o["breached"] else "")
                     for o in s["slo"]["objectives"]]
            lines.append(f"[serve-snn] SLO: {'; '.join(parts)} "
                         f"(breach onsets {s['slo']['breaches']})")
    else:
        lines.append(
            f"[serve-snn] {s['streams_done']} streams, {s['steps']} "
            f"stream-timesteps in {s['wall_s']:.2f}s over {s['rounds']} "
            f"rounds -> {s['steps_per_s']:.0f} steps/s")
        lat = s["stream_latency_ms"]
        if lat is not None:
            lines.append(
                f"[serve-snn] per-stream latency: mean {lat['mean']:.1f} "
                f"ms, p50 {lat['p50']:.1f} ms, p95 {lat['p95']:.1f} ms "
                f"(queueing under {s['n_slots']} slots)")
        lines.extend(_render_straggler(s["straggler"], s["n_slots"]))
        sp, eg = s["sparsity"], s["event_gate"]
        lines.append(
            f"[serve-snn] stream spike sparsity: input mean "
            f"{sp['input_mean_pct']:.2f}% (p50 {sp['input_p50_pct']:.2f}%), "
            f"output mean {sp['output_mean_pct']:.2f}%")
        lines.append(
            f"[serve-snn] event gate on served rasters: per-example "
            f"{eg['gated']}/{eg['dense']} weight blocks "
            f"({100 * eg['gated'] / eg['dense']:.1f}% of dense -> "
            f"{eg['dense'] / max(eg['gated'], 1):.1f}x traffic reduction; "
            f"batch-tile OR fetches "
            f"{100 * eg['tiled'] / eg['tiled_dense']:.1f}% of its dense)"
            + (f" [serving gate: {eg['serving_gate']}]"
               if eg["serving_gate"] else ""))
    lines.append(
        f"[serve-snn] fuse_steps={s['fuse_steps']}: "
        f"{s['launches']['spike_timestep_fused']} fused window launches, "
        f"{s['launches']['spike_timestep']} single-step launches "
        f"(device {s['device']}, backend {s['backend']})")
    en = s.get("energy")
    if en is not None:
        bk, uj = en["breakdown_mw"], en["energy_uj"]
        lines.append(
            f"[serve-snn] live energy (Table-V reference duty): "
            f"{en['sops']:.0f} measured SOPs, {en['row_fetches']:.0f} row "
            f"fetches -> {uj['total_uj']:.1f} uJ at {bk['total_mw']:.0f} mW "
            f"avg ({bk['weight_memory_pct']:.1f}% weight memory)")
    return lines


def _render_straggler(rep: dict | None, n_slots: int) -> list[str]:
    if rep is None:
        return []
    d = rep["dispatch_ms"]
    if rep["n_shards"] <= 1:
        # unsharded run: no shards to attribute or rebalance
        return [
            f"[serve-snn] {rep['dispatches']} chunk dispatches: "
            f"p50 {d['p50']:.1f} ms, p95 {d['p95']:.1f} ms"
        ]
    lines = [
        f"[serve-snn] straggler watch over {rep['dispatches']} chunk "
        f"dispatches x {rep['n_shards']} batch shards: load-attributed "
        f"step time mean {rep['attributed_mean_s']:.4f}s "
        f"(dispatch p50 {d['p50']:.1f} ms, p95 {d['p95']:.1f} ms), "
        f"per-shard flag counts {rep['flag_counts']}"
    ]
    if rep["persistent"] and not rep["all_flagged"]:
        lines.append(
            f"[serve-snn] persistently overloaded shard(s) "
            f"{rep['persistent']} -> suggested slot rebalance "
            f"{rep['suggested_slot_split']} (of {n_slots} slots)")
    elif rep["all_flagged"]:
        lines.append(
            "[serve-snn] all shards flagged together (fleet-wide "
            "step-time stretch, not a per-shard straggler); slot "
            f"split unchanged {rep['suggested_slot_split']}")
    else:
        lines.append(
            "[serve-snn] no persistently overloaded shards; slot "
            f"split stays uniform {rep['suggested_slot_split']}")
    return lines


def _git_commit() -> str | None:
    """The repo's HEAD commit (None outside a git checkout)."""
    try:
        r = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5, cwd=pathlib.Path(__file__).resolve().parent)
        return r.stdout.strip() if r.returncode == 0 else None
    except Exception:
        return None


def _summary_meta(args) -> dict:
    """Provenance block: the git commit, the bench schema version, and the
    run's values on the cross-bench axes."""
    return {
        "git_commit": _git_commit(),
        "bench_schema": SCHEMA_VERSION,
        "axes": {
            "backend": args.backend,
            "gate": args.gate,
            "batch": args.n_slots,
            "devices": args.devices,
            "fuse_steps": args.fuse_steps,
        },
    }


def emit_summary(args, summary: dict, metrics: MetricsRegistry,
                 tracer: SpanTracer) -> None:
    """Render the structured summary, then honour --json-summary /
    --metrics / --trace."""
    summary.setdefault("meta", _summary_meta(args))
    for line in _render_summary(summary):
        print(line)
    if args.json_summary is not None:
        text = json.dumps(summary, indent=2, sort_keys=True, default=float)
        if args.json_summary == "-":
            print(text)
        else:
            with open(args.json_summary, "w") as f:
                f.write(text + "\n")
    if args.metrics is not None:
        text = metrics.to_prometheus()
        if args.metrics == "-":
            sys.stdout.write(text)
        else:
            with open(args.metrics, "w") as f:
                f.write(text)
    if args.trace is not None:
        n = tracer.export_jsonl(args.trace)
        print(f"[serve-snn] wrote {n} lifecycle spans to {args.trace}")


def run_async(args, server, views, requests, rng, metrics,
              recorder=None) -> dict:
    """Open-loop async serving: requests are submitted at precomputed
    Poisson arrival TIMES (``--arrival-rate`` per second) whether or not
    the pump has kept up, so overload shows as queue depth, shedding and
    expiry. A parked request (deadline spill) is resumed once, then shed.
    Always terminates: every round retires, admits or expires work."""
    fe = next(iter(views.values())).frontend
    if any(v.frontend is not fe for v in views.values()):
        raise RuntimeError("co-resident views must share one frontend")
    if args.devices > 1 or args.gate:
        print("[serve-snn] note: the straggler watch and event-sparsity "
              "summaries are sync-mode only; the async run reports the "
              "front-door metrics below (the engine itself is still "
              "sharded/gated as requested)")
    tenants = _assign_tenants(args, fe.qos, len(requests))
    arrive_at = np.cumsum(rng.exponential(1.0 / args.arrival_rate,
                                          len(requests)))
    burst_plan = None
    if args.burst:
        burst_idx = [i for i, t in enumerate(tenants) if t == args.burst]
        if not burst_idx:
            raise SystemExit(
                f"--burst {args.burst!r} matches no tenant (classes: "
                f"{sorted(set(tenants))})")
        at = (args.burst_at if args.burst_at is not None
              else 0.25 * float(arrive_at[-1]))
        rate = (args.burst_rate if args.burst_rate is not None
                else 10.0 * args.arrival_rate)
        for j, i in enumerate(burst_idx):
            arrive_at[i] = at + j / rate
        burst_plan = {"tenant": args.burst, "at_s": at,
                      "rate_per_s": rate, "requests": len(burst_idx)}
    order = np.argsort(arrive_at, kind="stable")
    plan = [(float(arrive_at[k]), requests[k][1], requests[k][2],
             tenants[k]) for k in order]
    handles: list = []
    resumed: set = set()
    i = 0
    t0 = time.perf_counter()
    while i < len(plan) or not fe.idle or any(
            h.state == "parked" for h in handles):
        now = time.perf_counter() - t0
        while i < len(plan) and plan[i][0] <= now:
            _, name, spikes, tenant = plan[i]
            handles.append(views[name].submit(spikes, tenant=tenant))
            i += 1
        for h in handles:
            if h.state == "parked":
                if h.rid in resumed or not fe.resume(
                        h, deadline_ms=args.deadline_ms):
                    h.cancel()
                else:
                    resumed.add(h.rid)
        if fe.idle:
            if i < len(plan):
                time.sleep(min(0.05, max(
                    0.0, plan[i][0] - (time.perf_counter() - t0))))
            continue
        fe.pump()
        if recorder is not None:
            recorder.note_metrics(metrics)
    wall = time.perf_counter() - t0

    steps = server.total_steps
    return {
        "mode": "async",
        "requests": len(requests),
        "offered_rate_per_s": len(requests) / plan[-1][0],
        "policy": args.backpressure,
        "queue_capacity": fe.queue_capacity,
        "deadline_ms": args.deadline_ms,
        "qos": None if fe.qos is None else {
            "classes": {name: dataclasses.asdict(spec)
                        for name, spec in fe.qos.classes.items()},
            "quantum": fe.qos.quantum,
            "preempt": fe.qos.preempt,
        },
        "burst": burst_plan,
        "wall_s": wall,
        "steps": int(steps),
        "steps_per_s": steps / wall,
        "frontend": fe.metrics(),
        "slo": None if fe.slo is None else fe.slo.report(),
        "server": _server_report(metrics),
        "energy": _energy_report(metrics),
    }


def _check_args(args) -> None:
    if args.arrival_rate <= 0:
        raise SystemExit("--arrival-rate must be > 0 (arrivals per "
                         "chunk-round in sync mode, per second with "
                         "--async; the arrival plan cannot make progress "
                         "at rate 0)")
    if args.mesh and args.devices <= 1:
        raise SystemExit("--mesh requires --devices N (N > 1); without it "
                         "the server would silently run unsharded")
    if args.drain is not None and args.async_mode:
        raise SystemExit("--drain is a sync-mode drill (the async frontend "
                         "is rebuilt by the redeploy; resubmit instead)")
    if args.drain is not None and args.drain < 1:
        raise SystemExit("--drain must be >= 1 (chunk-rounds before the "
                         "hot redeploy)")
    slo_flags = (args.slo_p99_ms, args.slo_miss_ratio, args.slo_queue_depth)
    if any(v is not None for v in slo_flags) and not args.async_mode:
        raise SystemExit("--slo-* objectives are --async only (the "
                         "frontend pump feeds the watchdog; the sync loop "
                         "has no request deadlines or admission queue)")
    if ((args.qos or args.qos_preempt or args.burst
         or args.burst_rate is not None or args.burst_at is not None)
            and not args.async_mode):
        raise SystemExit("--qos/--qos-preempt/--burst* shape the async "
                         "admission queue; they require --async (the "
                         "sync loop has no front door to arbitrate)")
    if args.qos_preempt and not args.qos:
        raise SystemExit("--qos-preempt needs a --qos policy: preemption "
                         "is ranked by the tenant classes it declares")
    if ((args.burst_rate is not None or args.burst_at is not None)
            and not args.burst):
        raise SystemExit("--burst-rate/--burst-at shape the --burst "
                         "tenant's arrival train; name it with --burst")


def _slo(args, metrics, recorder) -> SLOWatchdog | None:
    objectives = []
    if args.slo_p99_ms is not None:
        objectives.append(SLObjective("latency_p99", "latency_p99",
                                      args.slo_p99_ms / 1e3,
                                      window_s=args.slo_window_s))
    if args.slo_miss_ratio is not None:
        objectives.append(SLObjective("miss_ratio", "miss_ratio",
                                      args.slo_miss_ratio,
                                      window_s=args.slo_window_s))
    if args.slo_queue_depth is not None:
        objectives.append(SLObjective("queue_depth", "queue_depth",
                                      float(args.slo_queue_depth),
                                      window_s=args.slo_window_s))
    if not objectives:
        return None
    return SLOWatchdog(
        objectives, registry=metrics,
        on_breach=(recorder.on_breach,) if recorder is not None else ())


def main(argv=None) -> dict:
    """Run the serving loop; prints the summary and returns it."""
    args = build_parser().parse_args(argv)
    _check_args(args)
    qos_policy = (None if args.qos is None
                  else _parse_qos(args.qos, preempt=args.qos_preempt))
    if (args.burst and qos_policy is not None
            and args.burst not in qos_policy.classes):
        raise SystemExit(f"--burst {args.burst!r} is not a --qos class "
                         f"({sorted(qos_policy.classes)}); the burst "
                         f"tenant must be one the policy ranks")

    mesh = None
    if args.devices > 1:
        devices = ensure_host_devices(args.devices, args.device)
        try:
            kn, kb = parse_mesh_spec(args.devices, args.mesh)
        except ValueError as e:
            raise SystemExit(str(e))
        mesh = make_spike_mesh(neuron=kn, batch=kb, devices=devices)

    rng = np.random.default_rng(args.seed)
    connector = (None if args.connector is None
                 else FileCarryConnector(args.connector))
    # one registry + tracer for the whole run, threaded by the session
    # through the server, frontend and connector it builds
    metrics = MetricsRegistry()
    recorder = None if args.flight is None else FlightRecorder(
        path=args.flight)
    tracer = SpanTracer(annotate=args.profile is not None, sink=recorder)
    set_registry(metrics)
    slo = _slo(args, metrics, recorder)
    sess = AcceleratorSession(backend=args.backend, device=args.device,
                              mesh=mesh, fuse_steps=args.fuse_steps,
                              connector=connector, metrics=metrics,
                              tracer=tracer)
    names = [f"snn{i}" for i in range(args.models)]
    for name in names:
        sess.deploy(name, make_net(rng, args.n_inputs, args.n_neurons))
    # serve AFTER all deploys: deploying invalidates the fused layout
    frontend_cfg = None
    if args.async_mode:
        frontend_cfg = FrontendConfig(
            queue_capacity=args.queue_capacity,
            backpressure=args.backpressure,
            deadline_ms=args.deadline_ms,
            # with a deadline, spill mid-stream expiries to the session
            # connector and resume each once instead of restarting
            spill=args.deadline_ms is not None,
            slo=slo, qos=qos_policy)
    views = {name: sess.serve(name, n_slots=args.n_slots,
                              chunk_steps=args.chunk, gate=args.gate,
                              frontend=frontend_cfg)
             for name in names}
    server = next(iter(views.values())).server
    n_shards = 1 if mesh is None else int(mesh.shape["batch"])
    mesh_info = None if mesh is None else {
        "neuron": int(mesh.shape["neuron"]),
        "batch": int(mesh.shape["batch"]), "shards": mesh.size,
        "physical_devices": [str(d) for d in mesh.physical_devices]}
    mesh_note = "" if mesh is None else (
        f", mesh {mesh_info['neuron']}x{mesh_info['batch']} (neuron x "
        f"batch) over {mesh.size} devices backed by "
        f"{len(mesh.physical_devices)} physical "
        f"({', '.join(mesh_info['physical_devices'])})")
    print(f"[serve-snn] {args.models} co-resident model(s) on one fused "
          f"engine ({server.engine.n_sources} sources x "
          f"{server.engine.n_phys} neurons), backend={args.backend}, "
          f"gate={server.engine.gate}, fuse_steps={args.fuse_steps}, "
          f"device={server.device}, {args.n_slots} slots x {args.chunk}-step "
          f"chunks{mesh_note}")
    watch = ShardLoadWatch(n_shards, args.n_slots, registry=metrics,
                           tracer=tracer)
    requests = _request_plan(args, names, rng)
    crash_net = (recorder.armed() if recorder is not None
                 else contextlib.nullcontext())
    launches0 = dict(ops.LAUNCHES)
    base = {"device": str(server.device), "backend": args.backend,
            "gate": server.engine.gate, "fuse_steps": args.fuse_steps,
            "mesh": mesh_info}

    if args.async_mode:
        with crash_net, profile_trace(args.profile):
            summary = run_async(args, server, views, requests, rng, metrics,
                                recorder=recorder)
        summary.update(base, launches={
            k: n - launches0[k] for k, n in ops.LAUNCHES.items()})
        emit_summary(args, summary, metrics, tracer)
        return summary

    # Poisson arrivals: number of new requests per chunk-round
    arrivals: list[list] = []
    i = 0
    while i < len(requests):
        n = int(rng.poisson(args.arrival_rate))
        arrivals.append(requests[i:i + n])
        i += n

    live: dict = {}           # uid -> [name, spikes, cursor]
    out_chunks: dict = {uid: [] for uid, _, _ in requests}
    t_arrive: dict = {}
    t_done: dict = {}
    rebalanced = False
    steps_base = 0            # stream-timesteps served by drained servers
    round_i = 0
    t0 = time.perf_counter()
    with crash_net, profile_trace(args.profile):
        while arrivals or live or server.scheduler.waiting:
            now = time.perf_counter()
            if (args.drain is not None and round_i >= args.drain
                    and "hotswap" not in sess.models):
                # rolling redeploy: a NEW model lands mid-run; deploy()
                # drains live streams to the connector and the re-serve
                # restores them, their rasters continuing byte-identically
                n_live = len(server.scheduler.active)
                steps_base += server.total_steps  # the old server's work
                sess.deploy("hotswap",
                            make_net(rng, args.n_inputs, args.n_neurons))
                views = {name: sess.serve(name, n_slots=args.n_slots,
                                          chunk_steps=args.chunk,
                                          gate=args.gate)
                         for name in names}
                server = next(iter(views.values())).server
                print(f"[serve-snn] --drain: hot-deployed 1 extra model "
                      f"after round {round_i}; {n_live} live stream(s) "
                      f"migrated mid-flight through the "
                      f"{'file' if args.connector else 'in-memory'} "
                      f"connector")
            if arrivals:
                for uid, name, spikes in arrivals.pop(0):
                    views[name].attach(uid)
                    live[uid] = [name, spikes, 0]
                    t_arrive[uid] = now
            # ONE batched dispatch per round across models
            done = []
            fused_inputs = {}
            live_slots = []
            for uid, (name, spikes, cur) in live.items():
                slot = server.slot_of(uid)
                if slot is None:
                    continue  # still waiting for a slot
                live_slots.append(slot)
                n = min(args.chunk, len(spikes) - cur)
                fused_inputs[uid] = views[name].embed(spikes[cur:cur + n])
                live[uid][2] = cur + n
                if cur + n >= len(spikes):
                    done.append(uid)
            if fused_inputs:
                t_chunk = time.perf_counter()
                res = server.feed(fused_inputs)
                watch.observe(time.perf_counter() - t_chunk, live_slots)
                for uid, r in res.items():
                    out_chunks[uid].append(r["spikes"])
            if n_shards > 1 and not rebalanced:
                flags = watch.persistent_flags()
                if flags.any() and not flags.all():
                    moves = rebalance_streams(
                        server, flags, slots_per_shard=watch.slots_per_shard)
                    if moves:
                        rebalanced = True
                        print(f"[serve-snn] straggler rebalance: migrated "
                              f"{len(moves)} live stream(s) off flagged "
                              f"shard(s) {np.where(flags)[0].tolist()} onto "
                              f"donor-shard slots {moves} (uid, from, to); "
                              f"carries moved bit-for-bit")
            for uid in done:
                views[live.pop(uid)[0]].detach(uid, reason="done")
                t_done[uid] = time.perf_counter()
            round_i += 1
            if recorder is not None:
                recorder.note_metrics(metrics)
    wall = time.perf_counter() - t0

    lats = np.asarray([t_done[u] - t_arrive[u] for u in t_done])
    steps = steps_base + server.total_steps
    # event accounting over the served streams: spike sparsity, and the
    # weight-block traffic the event gate fetches on these rasters,
    # per-example (batch-tile=1) vs the batch-tile OR
    in_sp = np.asarray([spikes.mean() for _, _, spikes in requests])
    ext_stack = np.stack([views[name].embed(spikes)
                          for _, name, spikes in requests], axis=1)
    out_stack = np.stack([np.concatenate(out_chunks[uid], axis=0)
                          for uid, _, _ in requests], axis=1)
    out_sp = out_stack.mean(axis=(0, 2))
    sources = sources_raster(torch.from_numpy(ext_stack),
                             torch.from_numpy(out_stack)).numpy()
    gated, dense = block_traffic(sources, tile_batch=1)
    tiled, tiled_dense = block_traffic(sources, tile_batch=8)
    summary = {
        "mode": "sync",
        **base,
        "launches": {k: n - launches0[k] for k, n in ops.LAUNCHES.items()},
        "streams_done": len(t_done),
        "steps": int(steps),
        "wall_s": wall,
        "rounds": round_i,
        "steps_per_s": steps / wall,
        "n_slots": args.n_slots,
        "stream_latency_ms": None if not len(lats) else {
            "mean": float(lats.mean() * 1e3),
            "p50": float(np.percentile(lats, 50) * 1e3),
            "p95": float(np.percentile(lats, 95) * 1e3),
        },
        "straggler": watch.report(),
        "sparsity": {
            "input_mean_pct": float(100 * in_sp.mean()),
            "input_p50_pct": float(100 * np.percentile(in_sp, 50)),
            "output_mean_pct": float(100 * out_sp.mean()),
        },
        "event_gate": {
            "gated": int(gated), "dense": int(dense),
            "tiled": int(tiled), "tiled_dense": int(tiled_dense),
            "serving_gate": args.gate,
        },
        "server": _server_report(metrics),
        "energy": _energy_report(metrics),
    }
    emit_summary(args, summary, metrics, tracer)
    return summary


if __name__ == "__main__":
    main()
