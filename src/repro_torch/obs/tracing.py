"""Stream-lifecycle tracing: typed spans, JSONL export, profiler hooks.

A :class:`SpanTracer` records what happened to each request/stream as a
sequence of typed spans::

    queued -> admitted(slot) -> chunk_step x N
           -> parked | migrated | redeployed | resumed ...
           -> retired(outcome)

Span kinds are catalogued in ``SPAN_KINDS`` (docs/observability.md
tables the same schema). Spans are either *events* (a point in time,
``t1 == t0``) or *durations* (opened as a context manager). Every span
carries the stream/request uid it belongs to (or ``None`` for
process-level spans like session deploys) plus free-form attributes.

Export is JSONL — one span per line, stable keys — so traces stream to
a file during a run and load with one ``json.loads`` per line.

When built with ``annotate=True``, duration spans also wrap their body
in a ``torch.profiler.record_function``, so kernel time shows up under
named lifecycle spans in a profiler trace captured via
:func:`profile_trace` (the ``serve_snn --profile DIR`` path).

Twin of :mod:`repro.obs.tracing`: the same span vocabulary, records and
JSONL export; only the profiler hooks are PyTorch's.

Like the metrics registry, the tracer is injectable and clocked by an
injectable callable; components take ``tracer=None`` (no tracing, no
work) by default. Tracing reads the datapath and never changes it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import threading
import time

__all__ = ["SPAN_KINDS", "Span", "SpanTracer", "profile_trace"]

# The lifecycle vocabulary. Tracers accept only these kinds, so a typo
# in an instrumentation site fails loudly instead of minting a new
# span type the docs don't know about.
SPAN_KINDS: tuple[str, ...] = (
    "queued",      # request entered the admission queue
    "admitted",    # bound to a slot (attrs: slot; resumed=True if from park)
    "chunk_step",  # one masked step_chunk dispatch (attrs: steps, slots)
    "parked",      # spilled to the connector mid-flight
    "resumed",     # re-admitted from a parked snapshot
    "migrated",    # carry moved between servers/slots via the connector
    "redeployed",  # drained + restored across a session redeploy
    "retired",     # terminal (attrs: outcome = done|cancelled|expired|...)
    "deploy",      # session (re)deploy of compiled programs
    "snapshot",    # connector snapshot write (attrs: nbytes)
    "restore",     # connector snapshot read (attrs: nbytes)
    "shard_step",  # one sharded dispatch (attrs: per-shard times, flags)
)


@dataclasses.dataclass
class Span:
    """One recorded span. ``t1 == t0`` for instantaneous events."""

    kind: str
    uid: int | str | None
    t0: float
    t1: float
    attrs: dict

    @property
    def duration(self) -> float:
        return self.t1 - self.t0

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "uid": self.uid,
            "t0": self.t0,
            "t1": self.t1,
            "dur": self.t1 - self.t0,
            "attrs": self.attrs,
        }


class SpanTracer:
    """Record typed lifecycle spans; export as JSONL.

    Args:
      clock: monotonic-seconds callable (injectable for determinism).
      annotate: also wrap duration spans in
        ``torch.profiler.record_function``, so a captured profiler trace
        nests kernel time under lifecycle spans. Off by default —
        annotation costs a little per span.
      sink: optional open text file; when set, each completed span is
        written through immediately (one JSON line) as well as kept in
        memory. Lets ``--trace FILE`` stream during long runs.
    """

    def __init__(self, clock=time.perf_counter, *,
                 annotate: bool = False, sink=None):
        self.clock = clock
        self.annotate = annotate
        self._sink = sink
        self._lock = threading.Lock()
        self._spans: list[Span] = []

    # -- recording ----------------------------------------------------
    def _record(self, span: Span) -> Span:
        with self._lock:
            self._spans.append(span)
            if self._sink is not None:
                self._sink.write(json.dumps(span.to_dict()) + "\n")
        return span

    def event(self, kind: str, uid=None, **attrs) -> Span:
        """An instantaneous lifecycle event (t1 == t0)."""
        self._check(kind)
        now = self.clock()
        return self._record(Span(kind, uid, now, now, attrs))

    @contextlib.contextmanager
    def span(self, kind: str, uid=None, **attrs):
        """A duration span around the ``with`` body.

        Attributes added to the yielded dict inside the body are kept
        (e.g. ``s["steps"] = n`` once known).
        """
        self._check(kind)
        t0 = self.clock()
        ann = self._annotation(kind, uid)
        try:
            if ann is not None:
                with ann:
                    yield attrs
            else:
                yield attrs
        finally:
            self._record(Span(kind, uid, t0, self.clock(), attrs))

    def _check(self, kind: str) -> None:
        if kind not in SPAN_KINDS:
            raise ValueError(
                f"unknown span kind {kind!r}; expected one of {SPAN_KINDS}"
            )

    def _annotation(self, kind: str, uid):
        if not self.annotate:
            return None
        import torch

        name = kind if uid is None else f"{kind}:{uid}"
        return torch.profiler.record_function(name)

    # -- reading / export ---------------------------------------------
    @property
    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def spans_for(self, uid) -> list[Span]:
        return [s for s in self.spans if s.uid == uid]

    def to_dicts(self) -> list[dict]:
        return [s.to_dict() for s in self.spans]

    def export_jsonl(self, path) -> int:
        """Write every span as one JSON line; returns the span count.

        ``path`` may be a filesystem path or an open text file.
        """
        spans = self.to_dicts()
        if hasattr(path, "write"):
            for d in spans:
                path.write(json.dumps(d) + "\n")
        else:
            with open(path, "w") as fh:
                for d in spans:
                    fh.write(json.dumps(d) + "\n")
        return len(spans)


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """``torch.profiler`` capture of CPU and CUDA activity around a block,
    written as a Chrome trace into ``log_dir`` (no-op when it is None).

    The ``serve_snn --profile DIR`` path: combined with a tracer built
    with ``annotate=True``, the captured trace nests device/kernel time
    under the lifecycle span names.
    """
    if log_dir is None:
        yield
        return
    import os

    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
