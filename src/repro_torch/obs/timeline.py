"""Per-stream lifecycle timelines + auditor over ``SpanTracer`` output.

The tracer records *what happened*; this module turns that record
into *verdicts*. :func:`reconstruct` replays a span stream (an in-memory
:class:`~repro_torch.obs.tracing.SpanTracer`, a list of spans/dicts, or a
``--trace`` JSONL file) through the closed lifecycle state machine::

    new ── queued ──> queued ── admitted ──> running ── retired ──> retired
              ^                  │   ^  │
              │    parked        v   │  └── migrated / chunk_step*
              └── resumed ──── parked ── retired

and emits one :class:`StreamTimeline` per ``(domain, uid)`` with exact
wait / service / park time splits plus admission / park / migration /
redeploy / chunk counts. The same replay is a correctness auditor: an
illegal transition, activity after retirement, a retire-without-admit,
a ``chunk_step`` naming a non-running stream, or a leaked stream (the
trace ends with it queued or running) is a :class:`LifecycleViolation`
hard error — so every suite that records a trace doubles as a
lifecycle audit.

Two uid namespaces share one tracer: the async frontend spans its
*request* ids (``attrs["domain"] == "request"``) while the server spans
its *stream* uids (no domain attr, the default ``"stream"``). Timelines
are keyed by ``(domain, uid)`` so rid 0 and stream uid 0 never alias.

Terminal states: ``retired`` is the only fully-closed end state, but a
trace may legally end with streams ``parked`` — their state lives on in
a connector (spill, rolling redeploy, checkpoint), which is the point
of parking. A request refused at the queue door (``outcome ==
"rejected"``) retires without ever being queued; every other
retire-from-nothing is the retire-without-admit error.

Mesh lanes: ``shard_step`` spans (recorded by the shard load watch /
``observe_from_registry``) carry the per-shard attributed times and
straggler flags of each dispatch; :func:`mesh_lanes` folds them into a
per-device barrier breakdown and :func:`verify_shard_lanes` replays the
times through a fresh pure ``StragglerDetector`` and demands exact flag
agreement with what was recorded live.

Read-only like the rest of ``repro_torch.obs``: reconstruction consumes spans
after the fact and never touches the datapath.

Twin of :mod:`repro.obs.timeline` (the same code, numpy and the standard
library only; the port imports nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

__all__ = [
    "AUX_KINDS",
    "LIFECYCLE_KINDS",
    "LifecycleViolation",
    "StreamTimeline",
    "TimelineReport",
    "load_jsonl",
    "mesh_lanes",
    "reconstruct",
    "verify_shard_lanes",
]

# Kinds that drive a stream's state machine, vs auxiliary spans that
# describe the process (dispatches, deploys, connector IO) and never
# create or mutate a stream.
LIFECYCLE_KINDS = frozenset({
    "queued", "admitted", "parked", "resumed", "migrated", "redeployed",
    "retired",
})
AUX_KINDS = frozenset({
    "chunk_step", "deploy", "snapshot", "restore", "shard_step",
})

# (state, kind) -> next state. Anything absent is an illegal
# transition, except the two documented special cases handled in
# reconstruct(): admitted-while-running with resumed=True (a restore
# over a live incarnation — crash recovery), and retired-from-new with
# outcome="rejected" (refused at the queue door).
_TRANSITIONS = {
    ("new", "queued"): "queued",
    ("queued", "queued"): "queued",      # re-queued (redeploy / resume)
    ("parked", "queued"): "queued",
    ("new", "admitted"): "running",
    ("queued", "admitted"): "running",
    ("parked", "admitted"): "running",   # restored from a carry
    ("running", "parked"): "parked",     # spill / migrate / drain
    ("queued", "parked"): "parked",      # parked before a slot arrived
    ("parked", "resumed"): "queued",
    ("queued", "resumed"): "queued",     # marker next to the re-queue
    ("running", "migrated"): "running",
    ("running", "redeployed"): "parked",
    ("queued", "retired"): "retired",
    ("running", "retired"): "retired",
    ("parked", "retired"): "retired",    # e.g. cancel-while-parked
}

_TIME_BUCKET = {"queued": "wait_s", "running": "service_s",
                "parked": "park_s"}


class LifecycleViolation(ValueError):
    """A span stream that no legal stream lifecycle can produce."""


def _freeze(x):
    """Hashable uid: JSONL round-trips tuples as lists."""
    return tuple(_freeze(v) for v in x) if isinstance(x, list) else x


def load_jsonl(path) -> list[dict]:
    """Load a ``--trace`` file (one span dict per line)."""
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _as_dicts(source) -> list[dict]:
    """Normalize any span source to a list of span dicts, in record
    order (the tracer appends under its lock, so list order — not
    timestamp sorting — is the authoritative event order; fake clocks
    legitimately produce ties)."""
    if isinstance(source, (str, Path)):
        return load_jsonl(source)
    if hasattr(source, "to_dicts"):          # SpanTracer
        return source.to_dicts()
    out = []
    for s in source:
        out.append(s.to_dict() if hasattr(s, "to_dict") else dict(s))
    return out


@dataclasses.dataclass
class StreamTimeline:
    """One stream's reconstructed lifecycle and time breakdown."""

    domain: str
    uid: object
    state: str = "new"            # final state after replay
    outcome: str | None = None    # retired outcome, when retired
    wait_s: float = 0.0           # time spent queued
    service_s: float = 0.0        # time spent running (slot-bound)
    park_s: float = 0.0           # time spent parked in a connector
    chunk_s: float = 0.0          # summed duration of chunks it ran in
    n_chunks: int = 0
    n_admissions: int = 0
    n_parks: int = 0
    n_migrations: int = 0
    n_redeploys: int = 0
    t_first: float = 0.0
    t_last: float = 0.0
    kinds: list = dataclasses.field(default_factory=list)
    _since: float = dataclasses.field(default=0.0, repr=False)

    @property
    def total_s(self) -> float:
        return self.t_last - self.t_first

    def to_dict(self) -> dict:
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self) if f.name != "_since"}
        d["total_s"] = self.total_s
        return d


@dataclasses.dataclass
class TimelineReport:
    """Every stream's timeline plus the violations the replay found."""

    streams: dict                 # {(domain, uid): StreamTimeline}
    violations: list
    n_spans: int
    n_chunk_steps: int

    def stream(self, uid, domain: str = "stream") -> StreamTimeline:
        return self.streams[(domain, _freeze(uid))]

    def by_state(self) -> dict:
        out: dict = {}
        for st in self.streams.values():
            out[st.state] = out.get(st.state, 0) + 1
        return out

    def to_dict(self) -> dict:
        return {
            "n_spans": self.n_spans,
            "n_chunk_steps": self.n_chunk_steps,
            "n_streams": len(self.streams),
            "by_state": self.by_state(),
            "violations": list(self.violations),
            "streams": [st.to_dict() for st in self.streams.values()],
        }


def reconstruct(source, *, validate: bool = True,
                allow_inflight: bool = False) -> TimelineReport:
    """Replay a span stream into per-stream timelines; audit it.

    Args:
      source: a ``SpanTracer``, a list of ``Span``/dicts, or a JSONL
        trace path.
      validate: raise :class:`LifecycleViolation` (all violations, one
        per line) instead of returning a report that carries them.
      allow_inflight: skip the leak check — for mid-run snapshots
        (the flight recorder's ring is a window, not a whole run), a
        stream still queued/running at the end of the window is not a
        leak.
    """
    spans = _as_dicts(source)
    streams: dict = {}
    violations: list[str] = []
    n_chunks = 0

    def _chunk_audit(i, d, attrs):
        uids = attrs.get("uids")
        if uids is None:
            return
        dur = d["t1"] - d["t0"]
        for u in uids:
            st = streams.get(("stream", _freeze(u)))
            if st is None or st.state != "running":
                violations.append(
                    f"chunk_step #{i} names stream uid {u!r} which is "
                    f"{'unknown' if st is None else st.state!r}, not "
                    f"running")
            else:
                st.n_chunks += 1
                st.chunk_s += dur

    for i, d in enumerate(spans):
        kind = d["kind"]
        attrs = d.get("attrs") or {}
        if kind == "chunk_step":
            n_chunks += 1
            _chunk_audit(i, d, attrs)
            continue
        if kind not in LIFECYCLE_KINDS:
            continue
        domain = attrs.get("domain", "stream")
        key = (domain, _freeze(d.get("uid")))
        t = d["t1"]
        st = streams.get(key)
        if st is None:
            st = StreamTimeline(domain=domain, uid=key[1],
                                t_first=t, t_last=t, _since=t)
            streams[key] = st
        where = f"{domain}:{st.uid!r} (span #{i})"

        old = st.state
        if old == "retired":
            violations.append(f"{where}: {kind!r} after retirement")
            continue
        if (kind, old) == ("admitted", "running") and attrs.get("resumed"):
            # crash-recovery restore over a live incarnation: the old
            # incarnation's spans stop, the restored one takes over.
            new = "running"
        elif (kind, old) == ("retired", "new"):
            if attrs.get("outcome") == "rejected":
                new = "retired"  # refused at the queue door
            else:
                violations.append(
                    f"{where}: retired (outcome="
                    f"{attrs.get('outcome')!r}) without ever being "
                    f"queued or admitted")
                new = "retired"
        else:
            new = _TRANSITIONS.get((old, kind))
            if new is None:
                violations.append(
                    f"{where}: illegal {kind!r} in state {old!r}")
                continue

        bucket = _TIME_BUCKET.get(old)
        if bucket is not None:
            setattr(st, bucket, getattr(st, bucket) + (t - st._since))
        st._since = t
        st.state = new
        st.t_last = t
        st.kinds.append(kind)
        if kind == "admitted":
            st.n_admissions += 1
        elif kind == "parked":
            st.n_parks += 1
        elif kind == "migrated":
            st.n_migrations += 1
        elif kind == "redeployed":
            st.n_redeploys += 1
        elif kind == "retired":
            st.outcome = attrs.get("outcome")

    if not allow_inflight:
        for (domain, uid), st in streams.items():
            if st.state in ("queued", "running"):
                violations.append(
                    f"{domain}:{uid!r}: leaked — trace ends with the "
                    f"stream {st.state!r} (never retired or parked)")

    report = TimelineReport(streams=streams, violations=violations,
                            n_spans=len(spans), n_chunk_steps=n_chunks)
    if validate and violations:
        raise LifecycleViolation(
            f"{len(violations)} lifecycle violation(s):\n"
            + "\n".join(violations))
    return report


# ---------------------------------------------------------------------
# mesh lanes: per-shard barrier breakdown from shard_step spans
# ---------------------------------------------------------------------

def _shard_spans(source) -> list[dict]:
    return [d for d in _as_dicts(source) if d["kind"] == "shard_step"]


def mesh_lanes(source) -> dict:
    """Fold ``shard_step`` spans into a per-device barrier breakdown.

    Each ``shard_step`` span records one sharded dispatch: the load
    watch's per-shard attributed times and the straggler flags that
    dispatch produced. The result is one lane per shard with its full
    time series, flag series, and total flagged-dispatch count.
    """
    spans = _shard_spans(source)
    if not spans:
        return {"n_dispatches": 0, "n_shards": 0, "lanes": []}
    n_shards = len(spans[0]["attrs"]["times"])
    lanes = [{"shard": i, "times": [], "flags": [], "flagged": 0}
             for i in range(n_shards)]
    for d in spans:
        attrs = d["attrs"]
        for i, (t, f) in enumerate(zip(attrs["times"], attrs["flags"])):
            lanes[i]["times"].append(float(t))
            lanes[i]["flags"].append(int(f))
            lanes[i]["flagged"] += int(f)
    return {"n_dispatches": len(spans), "n_shards": n_shards,
            "lanes": lanes}


def verify_shard_lanes(source, detector) -> int:
    """Replay recorded per-shard times through a fresh detector and
    demand *exact* flag agreement with what was recorded live.

    ``detector`` must be a new ``StragglerDetector`` configured like the
    one that ran live (same warmup/patience/thresholds) — the recorded
    flags came through the registry-transported
    ``observe_from_registry`` path, which is pinned to agree with the
    pure ``observe`` on the same vector, so a mismatch here means the
    live path and the pure path diverged. Returns the number of
    dispatches checked; raises :class:`LifecycleViolation` on the first
    disagreement.
    """
    spans = _shard_spans(source)
    for i, d in enumerate(spans):
        attrs = d["attrs"]
        flags = [int(bool(f)) for f in detector.observe(attrs["times"])]
        recorded = [int(bool(f)) for f in attrs["flags"]]
        if flags != recorded:
            raise LifecycleViolation(
                f"shard_step #{i}: replayed straggler flags {flags} "
                f"disagree with recorded flags {recorded}")
    return len(spans)
