"""Metrics registry: counters, gauges, fixed-bucket histograms, exporters.

One :class:`MetricsRegistry` instance carries every instrument the
serving stack emits. The registry is process-wide by convention
(:func:`get_registry` / :func:`set_registry`) but explicitly injectable:
every instrumented component takes ``metrics=None`` (no instrumentation,
zero added work on the datapath) or a registry instance, and the clock
is injectable for deterministic tests — exactly like the async
frontend's.

``METRIC_SPECS`` is the canonical catalogue of metric names. It is the
single source of truth three consumers share:

- the registry pre-registers every spec, so the Prometheus exposition
  contains every documented metric name even before traffic arrives
  (the CI smoke asserts this);
- ``docs/observability.md`` documents the same table, and
  ``scripts/check_docs.py`` lints the two against each other both ways;
- the live energy bridge (:func:`repro_torch.core.energy.counts_from_registry`)
  reads the measured-SOP counters by these names.

Exporters: :meth:`MetricsRegistry.to_prometheus` (text exposition
format: ``# HELP`` / ``# TYPE`` lines, cumulative ``le`` buckets,
``_sum`` / ``_count``) and :meth:`MetricsRegistry.snapshot` (a plain
JSON-able dict).

Histograms keep their fixed buckets AND a bounded rolling window of raw
samples, so callers that used to compute exact percentiles from their
own deques (the frontend's ``metrics()``) report unchanged values.

Twin of :mod:`repro.obs.metrics` (the same code, numpy and the standard
library only; the port imports nothing of the JAX package).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "LATENCY_BUCKETS",
    "BYTES_BUCKETS",
    "METRIC_SPECS",
    "MetricSpec",
    "MetricsRegistry",
    "get_registry",
    "set_registry",
]

# Fixed bucket ladders (upper bounds, seconds / bytes). Chosen once here
# so every latency histogram in the stack is cross-comparable.
LATENCY_BUCKETS: tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2,
    5e-2, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)
BYTES_BUCKETS: tuple[float, ...] = (
    256.0, 1024.0, 4096.0, 16384.0, 65536.0, 262144.0,
    1048576.0, 4194304.0, 16777216.0,
)

# Rolling raw-sample window per histogram child — matches the async
# frontend's accounting window so its exact percentiles are unchanged.
SAMPLE_WINDOW = 100_000


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One catalogued metric: name, kind, help text, label names."""

    name: str
    kind: str  # "counter" | "gauge" | "histogram"
    help: str
    labels: tuple[str, ...] = ()
    buckets: tuple[float, ...] = LATENCY_BUCKETS


def _specs(*specs: MetricSpec) -> dict[str, MetricSpec]:
    return {s.name: s for s in specs}


# The canonical metric catalogue. docs/observability.md tables these
# names; scripts/check_docs.py lints the doc against this dict (and
# vice versa); the CI observability smoke asserts every name appears in
# a live exposition.
METRIC_SPECS: dict[str, MetricSpec] = _specs(
    # -- SpikeServer: datapath-adjacent counters ----------------------
    MetricSpec("snn_server_chunk_latency_seconds", "histogram",
               "Wall-clock latency of one SpikeServer.feed chunk step "
               "(one compiled masked step_chunk dispatch)."),
    MetricSpec("snn_server_slots_occupied", "gauge",
               "Slots currently bound to attached streams."),
    MetricSpec("snn_server_slots_total", "gauge",
               "Configured slot count of the server (n_slots)."),
    MetricSpec("snn_server_steps_total", "counter",
               "Active (slot, timestep) pairs consumed — masked-out "
               "slot steps are not counted."),
    MetricSpec("snn_server_chunks_total", "counter",
               "step_chunk dispatches issued by SpikeServer.feed."),
    MetricSpec("snn_server_spikes_total", "counter",
               "Output spikes emitted across all streams."),
    MetricSpec("snn_server_source_events_total", "counter",
               "Nonzero source events entering the accumulate, split "
               "external inputs vs recurrent (previous-step) spikes.",
               labels=("kind",)),
    MetricSpec("snn_server_sops_total", "counter",
               "Measured synaptic operations: each source event counts "
               "its row's nonzero fanout (trace.py semantics)."),
    MetricSpec("snn_server_row_fetches_total", "counter",
               "Weight-row fetches: nonzero SOPS_PER_ROW-wide row "
               "segments touched per source event (energy-model unit)."),
    MetricSpec("snn_server_weight_blocks_fetched_total", "counter",
               "128-source weight blocks fetched under the per-example "
               "event gate (tile_batch=1) across active steps."),
    MetricSpec("snn_server_weight_blocks_dense_total", "counter",
               "128-source weight blocks an ungated dense fetch would "
               "have moved across the same active steps."),
    # -- AsyncSpikeFrontend: request lifecycle ------------------------
    MetricSpec("snn_frontend_requests_total", "counter",
               "Requests by terminal-or-transition outcome: submitted, "
               "done, rejected, dropped, cancelled, expired, "
               "expired_queued, expired_running, parked, resumed, "
               "evicted.",
               labels=("outcome",)),
    MetricSpec("snn_frontend_class_outcomes_total", "counter",
               "Same outcomes split per tenant class (the QoS class / "
               "view name a request was submitted under).",
               labels=("stream_class", "outcome")),
    MetricSpec("snn_frontend_queue_depth", "gauge",
               "Requests waiting in the admission queue right now."),
    MetricSpec("snn_frontend_class_queue_depth", "gauge",
               "Per-tenant-class admission queue depth (QoS frontends "
               "only; every policy-declared class reports, zeros "
               "included).", labels=("stream_class",)),
    MetricSpec("snn_frontend_rounds_total", "counter",
               "pump() rounds executed."),
    MetricSpec("snn_frontend_queue_wait_seconds", "histogram",
               "Submit-to-admission wait per request class.",
               labels=("stream_class",)),
    MetricSpec("snn_frontend_service_seconds", "histogram",
               "Admission-to-retire service time per request class.",
               labels=("stream_class",)),
    MetricSpec("snn_frontend_total_seconds", "histogram",
               "Submit-to-retire total latency per request class.",
               labels=("stream_class",)),
    # -- Carry connector: snapshot / restore / migrate ----------------
    MetricSpec("snn_connector_ops_total", "counter",
               "Connector operations by kind: snapshot, restore, "
               "migrate.", labels=("op",)),
    MetricSpec("snn_connector_bytes_total", "counter",
               "Serialized CarrySnapshot bytes moved, by op "
               "(snapshot=written, restore=read).", labels=("op",)),
    MetricSpec("snn_connector_op_seconds", "histogram",
               "Latency of connector operations, by op.",
               labels=("op",)),
    # -- Mesh / straggler ---------------------------------------------
    MetricSpec("snn_shard_step_seconds", "gauge",
               "Most recent per-shard dispatch time attributed by the "
               "shard load watch.", labels=("shard",)),
    MetricSpec("snn_shard_straggler_flagged", "gauge",
               "1 while the straggler detector flags the shard, else 0.",
               labels=("shard",)),
    # -- Session lifecycle --------------------------------------------
    MetricSpec("snn_session_deploys_total", "counter",
               "AcceleratorSession.deploy calls (includes redeploys)."),
    MetricSpec("snn_session_redeploys_total", "counter",
               "Deploys that drained live streams through the "
               "connector (rolling redeploys)."),
    # -- SLO watchdog --------------------------------------------------
    MetricSpec("snn_slo_burn_rate", "gauge",
               "Most recent burn rate per SLO objective: observed value "
               "over threshold on the rolling window (> 1 = breaching).",
               labels=("objective",)),
    MetricSpec("snn_slo_breaches_total", "counter",
               "Breach onsets per SLO objective (counted on the "
               "transition into breach, not per evaluation).",
               labels=("objective",)),
)


# ---------------------------------------------------------------------
# Instruments. A *family* owns the metric name and its children, one
# child per label-value tuple; unlabeled metrics use the single
# default child, and the family proxies its methods for convenience.
# ---------------------------------------------------------------------
class _Child:
    __slots__ = ("labels",)

    def __init__(self, labels: tuple[tuple[str, str], ...]):
        self.labels = labels


class Counter(_Child):
    """Monotonically increasing count."""

    __slots__ = ("value",)

    def __init__(self, labels=()):
        super().__init__(labels)
        self.value = 0

    def inc(self, amount: float = 1) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0: {amount}")
        self.value += amount


class Gauge(_Child):
    """Point-in-time value that can go up and down."""

    __slots__ = ("value",)

    def __init__(self, labels=()):
        super().__init__(labels)
        self.value = 0

    def set(self, value: float) -> None:
        self.value = value

    def inc(self, amount: float = 1) -> None:
        self.value += amount

    def dec(self, amount: float = 1) -> None:
        self.value -= amount


class Histogram(_Child):
    """Fixed-bucket histogram plus a rolling raw-sample window.

    The buckets serve the Prometheus exposition (cumulative ``le``
    counts); the bounded ``samples`` deque serves exact percentile
    reporting (the frontend's ``metrics()`` contract predates the
    registry and reports exact p50/p95 over its window — re-hosting it
    here must not change those numbers).
    """

    __slots__ = ("buckets", "bucket_counts", "sum", "count", "samples")

    def __init__(self, labels=(), buckets=LATENCY_BUCKETS):
        super().__init__(labels)
        self.buckets = tuple(buckets)
        self.bucket_counts = [0] * (len(self.buckets) + 1)  # +Inf last
        self.sum = 0.0
        self.count = 0
        self.samples = collections.deque(maxlen=SAMPLE_WINDOW)

    def observe(self, value: float) -> None:
        for i, ub in enumerate(self.buckets):
            if value <= ub:
                self.bucket_counts[i] += 1
                break
        else:
            self.bucket_counts[-1] += 1
        self.sum += value
        self.count += 1
        self.samples.append(value)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """All children of one metric name, keyed by label values."""

    def __init__(self, spec: MetricSpec):
        self.spec = spec
        self._children: dict[tuple, _Child] = {}
        if not spec.labels:
            self._default = self._make(())
            self._children[()] = self._default
        else:
            self._default = None

    def _make(self, key: tuple) -> _Child:
        labels = tuple(zip(self.spec.labels, key))
        if self.spec.kind == "histogram":
            return Histogram(labels, self.spec.buckets)
        return _KINDS[self.spec.kind](labels)

    def labels(self, *values, **kv):
        """The child for these label values (created on first use)."""
        if kv:
            if set(kv) != set(self.spec.labels):
                raise ValueError(
                    f"{self.spec.name} takes labels {self.spec.labels}, "
                    f"got {sorted(kv)}"
                )
            values = tuple(str(kv[name]) for name in self.spec.labels)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.spec.labels):
            raise ValueError(
                f"{self.spec.name} takes labels {self.spec.labels}, "
                f"got {values}"
            )
        child = self._children.get(values)
        if child is None:
            child = self._children[values] = self._make(values)
        return child

    @property
    def children(self):
        return dict(self._children)

    # Unlabeled convenience: family proxies the single default child.
    def _require_default(self) -> _Child:
        if self._default is None:
            raise ValueError(
                f"{self.spec.name} is labeled {self.spec.labels}; "
                f"use .labels(...)"
            )
        return self._default

    def inc(self, amount: float = 1):
        self._require_default().inc(amount)

    def dec(self, amount: float = 1):
        self._require_default().dec(amount)

    def set(self, value: float):
        self._require_default().set(value)

    def observe(self, value: float):
        self._require_default().observe(value)

    @property
    def value(self):
        return self._require_default().value


# ---------------------------------------------------------------------
class MetricsRegistry:
    """Every instrument in the process, behind one injectable object.

    Args:
      clock: monotonic-seconds callable used by :meth:`timer`; inject a
        fake for deterministic tests (the frontend shares this clock so
        its latency accounting and the registry's agree).
      specs: metric catalogue to pre-register; defaults to the full
        ``METRIC_SPECS`` so exports always contain every documented
        name. Ad-hoc metrics can still be registered via
        :meth:`register`.
    """

    def __init__(self, clock=time.perf_counter, *,
                 specs: dict[str, MetricSpec] | None = None):
        self.clock = clock
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}
        for spec in (METRIC_SPECS if specs is None else specs).values():
            self.register(spec)

    # -- registration / lookup ---------------------------------------
    def register(self, spec: MetricSpec) -> _Family:
        with self._lock:
            have = self._families.get(spec.name)
            if have is not None:
                if have.spec != spec:
                    raise ValueError(
                        f"metric {spec.name!r} re-registered with a "
                        f"different spec"
                    )
                return have
            if spec.kind not in _KINDS:
                raise ValueError(f"unknown metric kind {spec.kind!r}")
            fam = self._families[spec.name] = _Family(spec)
            return fam

    def _get(self, name: str, kind: str) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            raise KeyError(f"unregistered metric {name!r}")
        if fam.spec.kind != kind:
            raise TypeError(
                f"{name} is a {fam.spec.kind}, not a {kind}"
            )
        return fam

    def counter(self, name: str) -> _Family:
        return self._get(name, "counter")

    def gauge(self, name: str) -> _Family:
        return self._get(name, "gauge")

    def histogram(self, name: str) -> _Family:
        return self._get(name, "histogram")

    def timer(self, name: str, **labels):
        """Context manager observing elapsed clock time into ``name``."""
        return _Timer(self, name, labels)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(sorted(self._families))

    # -- exporters ----------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able dump: {name: {type, help, samples: [...]}}.

        Histogram samples carry buckets/sum/count; counter and gauge
        samples carry a scalar ``value``. Labels ride each sample.
        """
        out = {}
        with self._lock:
            for name in sorted(self._families):
                fam = self._families[name]
                samples = []
                for key in sorted(fam.children):
                    child = fam.children[key]
                    entry = {"labels": dict(child.labels)}
                    if isinstance(child, Histogram):
                        entry["buckets"] = dict(
                            zip(map(_fmt_le, child.buckets),
                                child.bucket_counts[:-1])
                        )
                        entry["buckets"]["+Inf"] = child.bucket_counts[-1]
                        entry["sum"] = child.sum
                        entry["count"] = child.count
                    else:
                        entry["value"] = child.value
                    samples.append(entry)
                out[name] = {
                    "type": fam.spec.kind,
                    "help": fam.spec.help,
                    "samples": samples,
                }
        return out

    def to_prometheus(self) -> str:
        """Text exposition format, one HELP/TYPE block per family.

        Every registered family appears (the CI smoke greps for each
        documented name); labeled families with no traffic yet expose
        just their HELP/TYPE lines, Prometheus-style.
        """
        lines = []
        with self._lock:
            for name in sorted(self._families):
                fam = self._families[name]
                lines.append(
                    f"# HELP {name} {_escape_help(fam.spec.help)}")
                lines.append(f"# TYPE {name} {fam.spec.kind}")
                for key in sorted(fam.children):
                    child = fam.children[key]
                    if isinstance(child, Histogram):
                        cum = 0
                        for ub, n in zip(child.buckets,
                                         child.bucket_counts):
                            cum += n
                            lbl = _labelstr(child.labels
                                            + (("le", _fmt_le(ub)),))
                            lines.append(f"{name}_bucket{lbl} {cum}")
                        cum += child.bucket_counts[-1]
                        lbl = _labelstr(child.labels + (("le", "+Inf"),))
                        lines.append(f"{name}_bucket{lbl} {cum}")
                        base = _labelstr(child.labels)
                        lines.append(f"{name}_sum{base} {_fmt(child.sum)}")
                        lines.append(f"{name}_count{base} {child.count}")
                    else:
                        lbl = _labelstr(child.labels)
                        lines.append(f"{name}{lbl} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"


class _Timer:
    def __init__(self, registry: MetricsRegistry, name: str, labels):
        self._registry = registry
        self._name = name
        self._labels = labels
        self._t0 = None

    def __enter__(self):
        self._t0 = self._registry.clock()
        return self

    def __exit__(self, *exc):
        hist = self._registry.histogram(self._name)
        child = hist.labels(**self._labels) if self._labels else hist
        child.observe(self._registry.clock() - self._t0)
        return False


def _fmt(v) -> str:
    if isinstance(v, float) and v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v) if isinstance(v, float) else str(v)


def _fmt_le(ub: float) -> str:
    return _fmt(float(ub))


def _escape(v: str) -> str:
    """Label-VALUE escaping per the text exposition format: backslash,
    newline, and double-quote (in that order — escaping backslash first
    keeps the others' escapes intact)."""
    return (v.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _escape_help(v: str) -> str:
    """HELP-line escaping: the exposition format escapes backslash and
    newline there (quotes stay literal — HELP text is not quoted)."""
    return v.replace("\\", r"\\").replace("\n", r"\n")


def _labelstr(labels: tuple[tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(str(v))}"' for k, v in labels)
    return "{" + inner + "}"


# ---------------------------------------------------------------------
# Process-wide default. Components never reach for this implicitly —
# instrumentation is always injected — but launchers and tools want one
# shared place to export from.
# ---------------------------------------------------------------------
_global_registry: MetricsRegistry | None = None
_global_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide registry (created on first use)."""
    global _global_registry
    with _global_lock:
        if _global_registry is None:
            _global_registry = MetricsRegistry()
        return _global_registry


def set_registry(registry: MetricsRegistry | None) -> MetricsRegistry | None:
    """Swap the process-wide registry; returns the previous one."""
    global _global_registry
    with _global_lock:
        prev, _global_registry = _global_registry, registry
        return prev
