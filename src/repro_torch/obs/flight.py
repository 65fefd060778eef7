"""Flight recorder: a bounded ring of recent spans + metric deltas.

A long-running serving process cannot keep (or ship) its whole span log,
but the moments before a crash or an SLO breach are exactly the ones
worth keeping. :class:`FlightRecorder` holds the **last N** lifecycle
spans and metric deltas in fixed-size rings and, on demand, dumps one
post-mortem JSON document — reason, recent spans, recent metric deltas,
and a partial-timeline summary — to a file.

Wiring (all optional, all read-only):

- As a tracer **sink**: ``SpanTracer(sink=recorder)`` streams every
  completed span through :meth:`write` (the same one-JSON-line protocol
  a file sink gets), so the ring always holds the freshest spans with no
  second recording path.
- On the metrics side, :meth:`note_metrics` diffs a registry's scalar
  samples (counters + gauges) against the previous call and appends the
  nonzero deltas — call it once per pump/serve round.
- As an :class:`SLOWatchdog` breach hook: ``on_breach=recorder.on_breach``
  dumps one post-mortem per breach onset.
- As a crash net: ``with recorder.armed("post_mortem.json"):`` dumps on
  any exception escaping the block, then re-raises it.

The dump's ``timeline`` block reuses :mod:`repro_torch.obs.timeline` with
``allow_inflight=True`` — a ring is a window, not a whole run, so
streams still queued/running at the window's edge are expected, not
leaks; reconstruction violations are *reported* in the dump rather than
raised (a post-mortem must never mask the original failure).

Twin of :mod:`repro.obs.flight` (the same code, numpy and the standard
library only; the port imports nothing of the JAX package).
"""

from __future__ import annotations

import collections
import contextlib
import json
import time

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Bounded last-N recorder of spans and metric deltas.

    Args:
      capacity: ring size for each of the span and delta rings.
      clock: injectable monotonic-seconds callable (stamps deltas and
        dumps).
      path: default dump path for :meth:`dump` / :meth:`on_breach` /
        :meth:`armed` when the call site does not name one.
    """

    def __init__(self, capacity: int = 512, *, clock=time.perf_counter,
                 path=None):
        if capacity <= 0:
            raise ValueError(
                f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self.clock = clock
        self.path = path
        self._spans: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._deltas: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._last_scalars: dict = {}
        self.n_dumps = 0

    # -- span intake (SpanTracer sink protocol) -----------------------
    def write(self, line: str) -> None:
        """Accept one completed span as its JSON line (the tracer's
        sink protocol), keeping only the last ``capacity`` spans."""
        self._spans.append(json.loads(line))

    @property
    def spans(self) -> list[dict]:
        return list(self._spans)

    # -- metric intake ------------------------------------------------
    def note_metrics(self, registry) -> int:
        """Record the scalar (counter/gauge) deltas since the previous
        call; returns how many series moved. Histograms are skipped —
        their stories are told by the latency spans already in the
        ring."""
        scalars: dict = {}
        for name, fam in registry.snapshot().items():
            if fam["type"] == "histogram":
                continue
            for sample in fam["samples"]:
                key = (name,) + tuple(sorted(sample["labels"].items()))
                scalars[key] = sample["value"]
        now = self.clock()
        moved = 0
        for key, value in scalars.items():
            prev = self._last_scalars.get(key)
            if prev is None or value != prev:
                name, *labels = key
                self._deltas.append({
                    "t": now, "metric": name,
                    "labels": dict(labels),
                    "value": value,
                    "delta": None if prev is None else value - prev,
                })
                moved += 1
        self._last_scalars = scalars
        return moved

    @property
    def deltas(self) -> list[dict]:
        return list(self._deltas)

    # -- post-mortem --------------------------------------------------
    def snapshot(self, *, reason: str, extra: dict | None = None) -> dict:
        """The post-mortem document (what :meth:`dump` writes)."""
        from repro_torch.obs.timeline import reconstruct

        report = reconstruct(list(self._spans), validate=False,
                             allow_inflight=True)
        doc = {
            "reason": reason,
            "t": self.clock(),
            "capacity": self.capacity,
            "spans": list(self._spans),
            "metric_deltas": list(self._deltas),
            "timeline": report.to_dict(),
        }
        if extra:
            doc["extra"] = extra
        return doc

    def dump(self, path=None, *, reason: str,
             extra: dict | None = None) -> dict:
        """Write the post-mortem JSON to ``path`` (or the default);
        returns the document. With no path at all, the document is still
        built and returned — callers can route it themselves."""
        doc = self.snapshot(reason=reason, extra=extra)
        path = self.path if path is None else path
        if path is not None:
            with open(path, "w") as fh:
                json.dump(doc, fh, indent=2, default=str)
        self.n_dumps += 1
        return doc

    # -- hooks --------------------------------------------------------
    def on_breach(self, status) -> None:
        """``SLOWatchdog`` breach hook: one dump per breach onset."""
        self.dump(reason=f"slo-breach:{status.objective.name}",
                  extra=status.to_dict())

    @contextlib.contextmanager
    def armed(self, path=None):
        """Dump a post-mortem if an exception escapes the block, then
        re-raise it — the crash net around a serving loop."""
        try:
            yield self
        except BaseException as e:
            self.dump(path, reason=f"crash:{type(e).__name__}",
                      extra={"error": str(e)})
            raise
