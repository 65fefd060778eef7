"""Observability layer: metrics registry + stream-lifecycle tracing.

The serving stack's telemetry lives here, in two halves:

- :mod:`repro_torch.obs.metrics` — a process-wide but injectable
  :class:`MetricsRegistry` of counters, gauges, and fixed-bucket
  histograms with label sets, exportable as Prometheus text exposition
  or a JSON snapshot. ``METRIC_SPECS`` is the canonical catalogue of
  every metric the serving stack emits.
- :mod:`repro_torch.obs.tracing` — a :class:`SpanTracer` recording typed
  stream-lifecycle spans (queued → admitted → chunk_step×N →
  parked/migrated/redeployed → retired) with JSONL export and optional
  ``torch.profiler`` trace annotations.

On top of the raw record sits the analysis tier:

- :mod:`repro_torch.obs.timeline` — per-stream lifecycle timelines
  reconstructed from span streams, with a closed-state-machine auditor
  (:func:`reconstruct`) and per-device mesh-lane breakdowns.
- :mod:`repro_torch.obs.slo` — declarative SLO objectives
  (:class:`SLObjective`) evaluated as rolling burn-rate windows by an
  :class:`SLOWatchdog` the frontend pump feeds.
- :mod:`repro_torch.obs.flight` — a bounded :class:`FlightRecorder` ring of
  the last-N spans + metric deltas, dumping a post-mortem JSON on crash
  or SLO breach.

The hard contract of this package: observability READS the datapath and
never changes it. Every instrument hook is a pure host-side read of
values the serving layer already computes; the byte-identity suites
(async==sync, migration, fused steps) run with telemetry enabled to
prove it.

Twin of :mod:`repro.obs` (the same code, numpy and the standard library
only; the port imports nothing of the JAX package).
"""

from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import (
    METRIC_SPECS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    set_registry,
)
from repro_torch.obs.slo import SLObjective, SLOStatus, SLOWatchdog
from repro_torch.obs.timeline import (
    LifecycleViolation,
    StreamTimeline,
    TimelineReport,
    mesh_lanes,
    reconstruct,
    verify_shard_lanes,
)
from repro_torch.obs.tracing import Span, SpanTracer

__all__ = [
    "METRIC_SPECS",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "LifecycleViolation",
    "MetricsRegistry",
    "SLObjective",
    "SLOStatus",
    "SLOWatchdog",
    "Span",
    "SpanTracer",
    "StreamTimeline",
    "TimelineReport",
    "get_registry",
    "mesh_lanes",
    "reconstruct",
    "set_registry",
    "verify_shard_lanes",
]
