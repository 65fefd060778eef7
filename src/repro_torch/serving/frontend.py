"""Async serving front door — admission queue decoupled from the step loop.

SNAP-V splits management from compute: the RISC-V SpikeCore admits and
sequences work while the Cerebra array only ever executes timesteps. The
streaming layer (:mod:`repro_torch.serving.snn`) reproduced the compute half —
one masked chunk step serving resident streams — but its callers
still coupled *admission* to *stepping*: a request could only arrive when
the serving loop was between ``feed`` calls. This module is the management
half: a bounded request queue in front of the server, drained into free
:class:`~repro_torch.serving.snn.SlotScheduler` slots between chunk steps by a
pump loop — the same decoupling vLLM-style continuous batching uses for
LLM serving (requests arrive on their own clock; the engine loop admits
whatever is waiting whenever a slot frees up).

The pieces:

  * :class:`AsyncSpikeFrontend` — owns the bounded queue
    (:meth:`~AsyncSpikeFrontend.submit` / :meth:`~AsyncSpikeFrontend.cancel`
    / per-request deadlines / an explicit backpressure policy) and the
    :meth:`~AsyncSpikeFrontend.pump` round that expires, admits, feeds one
    chunk, and retires — recording queue-wait vs service vs total latency
    per request.
  * :class:`RequestHandle` — what ``submit`` returns: ``poll()`` the
    request's state without blocking, ``result()`` when it is done.
  * :class:`FrontendConfig` — the knob bundle ``session.serve(...,
    frontend=)`` takes to hang a shared frontend off co-resident
    :class:`~repro_torch.serving.snn.ModelStream` views.

Exactness contract (pinned against the JAX twin by
tests/test_torch_frontend.py): the frontend never touches the numerical
path — every request's spikes go through the SAME masked chunk step
``SpikeServer.feed`` uses, and a slot is always power-on clean at
admission (eviction zeroes it). Given the same realized admission order,
async-served rasters are therefore byte-identical to direct synchronous
``feed`` of each request's full raster, for every backend x reset mode x
gate x mesh. Admission order and slot assignment are themselves
deterministic functions of the submit / cancel / pump sequence (FIFO
queue, FIFO slot reuse) — a property test pins this.

Backpressure policies (queue full at ``submit``):

  * ``"reject"``  — the NEW request is refused (state ``"rejected"``; the
    handle comes back so the caller can see it). Load shedding at the
    door; the open-loop launcher's default.
  * ``"block"``   — ``submit`` pumps the loop until a queue place frees
    up (the closed-loop degradation: the submitting client waits).
  * ``"drop-oldest"`` — the OLDEST queued request is dropped (state
    ``"dropped"``) to make room; freshest-data semantics for sensor-like
    traffic where a stale stimulus is worthless.

Admission is FIFO by default. Built with ``qos=`` (a
:class:`repro_torch.serving.qos.QoSPolicy`) the single deque becomes per-tenant
queues under strict priority + weighted fair queueing, with slot quotas,
token-bucket rate limits on the same injectable clock, and (with
``preempt``) SLO-aware eviction that parks the lowest-priority running
stream through the connector. QoS off is byte-identical to the FIFO
path; QoS on keeps admission order and slot assignment a pure function
of the op sequence (pinned by tests/test_torch_qos.py).

Nothing here runs on the card; the frontend is pure host-side bookkeeping
around the engine's chunk step (clock injectable for deterministic
deadline tests).

Twin of :mod:`repro.serving.frontend` (the same code, numpy and the
standard library only; the port imports nothing of the JAX package).
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time

import numpy as np

from repro_torch.serving.qos import QoSPolicy, WeightedFairQueue, choose_victim

__all__ = [
    "BACKPRESSURE",
    "AsyncSpikeFrontend",
    "FrontendConfig",
    "RequestHandle",
    "latency_percentiles",
]

BACKPRESSURE: tuple[str, ...] = ("reject", "block", "drop-oldest")

# terminal request states (a handle in one of these never changes again).
# "parked" is deliberately NOT terminal: a spilled request's carry sits in
# the connector and resume() re-queues it (cancel() evicts it for good).
_TERMINAL = frozenset({"done", "cancelled", "expired", "rejected", "dropped"})

# rolling-window size of the latency / queue-depth sample buffers: big
# enough that percentiles describe hours of traffic, bounded so a
# long-running front door cannot grow without limit
_METRICS_WINDOW = 100_000

# per-process frontend ids, namespacing spill keys in a shared connector
_FRONTEND_IDS = itertools.count()

# every outcome key `metrics()["counts"]` documents. The dict ALWAYS
# carries all of them (zeros included): an empty or all-expired run
# returns the same shape as a busy one, so dashboards and tests index
# keys without existence checks.
OUTCOME_KEYS: tuple[str, ...] = (
    "submitted", "done", "rejected", "dropped", "cancelled",
    "expired", "expired_queued", "expired_running", "parked", "resumed",
    "evicted",
)


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Knobs for a frontend hung off ``session.serve(..., frontend=)``.

    ``queue_capacity`` bounds the admission queue (backpressure engages
    beyond it); ``backpressure`` picks the policy from
    :data:`BACKPRESSURE`; ``deadline_ms`` is the default per-request
    deadline (None = no deadline) measured on ``clock`` — requests past
    it are expired by the pump whether queued or mid-stream.
    """

    queue_capacity: int = 32
    backpressure: str = "reject"
    deadline_ms: float | None = None
    #: park mid-stream deadline evictions in the session's carry
    #: connector (state ``"parked"``) instead of zeroing them, so
    #: ``resume()`` continues the stream bit-clean (spill-on-evict).
    spill: bool = False
    #: optional ``repro_torch.obs.slo.SLOWatchdog`` the pump feeds (latencies
    #: on retire, misses on expiry, queue depth per round) and checks
    #: once per round. Excluded from the shared-frontend conflict check:
    #: a watchdog observes, it does not shape admission.
    slo: object | None = None
    #: optional :class:`repro_torch.serving.qos.QoSPolicy` — multi-tenant
    #: admission (priority classes, WFQ, quotas, rate limits, optional
    #: preemptive eviction). None keeps the plain FIFO path, which is
    #: byte-identical to a frontend built before QoS existed. Part of
    #: the shared-frontend conflict check: co-resident views must agree
    #: on the policy shaping their shared queue.
    qos: QoSPolicy | None = None


@dataclasses.dataclass
class _Request:
    """Internal per-request record (callers see :class:`RequestHandle`)."""

    rid: int
    chunk: np.ndarray              # dense (T, n_inputs) external spikes
    view: object | None            # ModelStream for embed/decode, or None
    deadline: float | None         # absolute clock value, or None
    submitted_at: float
    tenant: str = "default"        # QoS class / latency-histogram label
    events_capacity: int | None = None
    events_policy: str = "error"
    state: str = "queued"
    uid: object = None             # server stream uid once admitted
    cursor: int = 0                # timesteps fed so far
    parked_key: object = None      # connector key while spilled/parked
    pieces: list = dataclasses.field(default_factory=list)
    admitted_at: float | None = None
    finished_at: float | None = None
    result_cache: dict | None = None   # built once terminal, then reused

    @property
    def steps_total(self) -> int:
        return int(self.chunk.shape[0])


class RequestHandle:
    """Caller-side view of one submitted request.

    ``poll()`` never blocks; ``result()`` returns the decoded output once
    the request is terminal (None while it is still queued/running, and
    for requests that never ran). ``cancel()`` routes back through the
    frontend.
    """

    def __init__(self, frontend: "AsyncSpikeFrontend", req: _Request):
        self._frontend = frontend
        self._req = req

    @property
    def rid(self) -> int:
        """Frontend-assigned request id (submission order)."""
        return self._req.rid

    @property
    def state(self) -> str:
        return self._req.state

    @property
    def done(self) -> bool:
        return self._req.state in _TERMINAL

    def poll(self) -> dict:
        """Non-blocking status: state, progress, and queue position."""
        return self._frontend._poll(self._req)

    def result(self) -> dict | None:
        """The request's output once terminal (see
        :meth:`AsyncSpikeFrontend.submit` for the shape); None while
        pending or when the request never consumed a timestep."""
        return self._frontend._result(self._req)

    def timing(self) -> dict:
        """{'queue_wait', 'service', 'total'} in seconds (None where the
        request never reached that stage)."""
        return self._frontend._timing(self._req)

    def cancel(self) -> bool:
        return self._frontend.cancel(self)


def latency_percentiles(xs) -> dict:
    """mean/p50/p95/p99/max summary (seconds in, seconds out) of a
    latency sample list; empty input yields an all-None dict."""
    if not len(xs):
        return {"mean": None, "p50": None, "p95": None, "p99": None,
                "max": None}
    a = np.asarray(xs, np.float64)
    return {
        "mean": float(a.mean()),
        "p50": float(np.percentile(a, 50)),
        "p95": float(np.percentile(a, 95)),
        "p99": float(np.percentile(a, 99)),
        "max": float(a.max()),
    }


class AsyncSpikeFrontend:
    """Bounded admission queue + pump loop over one :class:`SpikeServer`.

    The frontend NEVER steps the engine on its own clock: all compute
    happens inside :meth:`pump`, which between two chunk steps (a) expires
    requests past their deadline — queued ones are refused, mid-stream
    ones are evicted with their slot carry zeroed exactly like any
    eviction, (b) drains the queue head-first into free scheduler slots,
    (c) feeds ONE ``chunk_steps`` service quantum for every running
    stream in a single batched ``SpikeServer.feed`` dispatch, and
    (d) retires finished streams, freeing their slots for the next
    round's admission. ``submit`` only enqueues (or applies backpressure);
    it is safe to call from another thread than the pump loop.

    Exactness: requests ride the same masked chunk step ``feed`` uses, so
    for the same realized admission order the per-request rasters are
    byte-identical to synchronous ``feed`` — the queue changes WHEN work
    runs, never what it computes.
    """

    def __init__(self, server, *, queue_capacity: int = 32,
                 backpressure: str = "reject",
                 deadline_ms: float | None = None,
                 clock=time.perf_counter, connector=None,
                 metrics=None, tracer=None, slo=None, qos=None):
        if queue_capacity <= 0:
            raise ValueError(
                f"queue_capacity must be positive, got {queue_capacity}")
        if backpressure not in BACKPRESSURE:
            raise ValueError(
                f"unknown backpressure policy {backpressure!r}; expected "
                f"one of {BACKPRESSURE}")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms must be positive, got {deadline_ms}")
        if qos is not None and not isinstance(qos, QoSPolicy):
            raise TypeError(
                f"qos must be a QoSPolicy or None, got "
                f"{type(qos).__name__}")
        if qos is not None and qos.preempt and connector is None:
            raise ValueError(
                "QoSPolicy(preempt=True) needs a connector: preemptive "
                "eviction PARKS the victim's carry (never drops it), so "
                "the frontend must have somewhere to spill")
        self.server = server
        self.queue_capacity = int(queue_capacity)
        self.backpressure = backpressure
        self.default_deadline_ms = deadline_ms
        self.clock = clock
        #: spill-on-evict target (a CarryConnectorBase): with one set,
        #: mid-stream deadline expiry PARKS the stream's carry instead of
        #: zeroing it, and resume() continues it bit-clean. Keys are
        #: namespaced per frontend so several front doors (and the
        #: session's redeploy drain) can share one connector.
        self.connector = connector
        #: optional telemetry (a MetricsRegistry / SpanTracer). Outcome
        #: counts, queue depth, and latency histograms mirror into the
        #: registry — exportable while the run is live — without changing
        #: one value `metrics()` reports. Pure host-side accounting.
        self.registry = metrics
        self.tracer = tracer
        #: optional SLO watchdog (repro_torch.obs.slo.SLOWatchdog): the pump
        #: feeds it total latencies, deadline outcomes, and queue depth,
        #: and runs one burn-rate evaluation per round. Observational
        #: only — a breach fires the watchdog's callbacks (e.g. a
        #: flight-recorder dump), never touches admission.
        self.slo = slo
        #: optional QoSPolicy: admission policy for the queue below.
        #: None = plain FIFO (byte-identical to the pre-QoS frontend).
        self.qos = qos
        self._spill_ns = f"spill-{next(_FRONTEND_IDS)}"
        self._lock = threading.RLock()
        self._rid = itertools.count()
        # QoS swaps the single FIFO deque for per-tenant queues under
        # strict priority + DRR; both expose the same deque surface
        # (len / iter / append / remove / index), only the admission
        # pop differs (see pump step 2).
        self._queue = (WeightedFairQueue(qos) if qos is not None
                       else collections.deque())
        self._running: dict = {}      # server uid -> _Request
        # accounting — the sample buffers are bounded (rolling window of
        # the most recent entries) so a long-running front door cannot
        # leak memory; counts are plain integers and stay exact forever.
        self.counts = collections.Counter()      # terminal-state counters
        w = _METRICS_WINDOW
        self.queue_wait = collections.deque(maxlen=w)  # submit->grant (s)
        self.service = collections.deque(maxlen=w)     # grant->done (s)
        self.total = collections.deque(maxlen=w)       # submit->done (s)
        self.depth_samples = collections.deque(maxlen=w)  # depth per pump
        self.rounds = 0
        # per-class mirrors of the same accounting, zero-filled for
        # every policy-declared class in metrics()["by_class"]
        self.class_counts: dict[str, collections.Counter] = {}
        self._class_lat: dict[str, dict[str, collections.deque]] = {}
        # background pump thread (start()/stop()); _work wakes the loop
        # out of its idle wait as soon as a submit/resume lands
        self._pump_thread = None
        self._stop_evt: threading.Event | None = None
        self._work_evt: threading.Event | None = None
        # the exception that ended the pump thread, raised again by stop():
        # a kernel that fails to build or launch on that thread must not
        # vanish with it
        self._pump_error: BaseException | None = None

    # -- queries -----------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        """Requests currently waiting for admission."""
        with self._lock:
            return len(self._queue)

    @property
    def n_running(self) -> int:
        with self._lock:
            return len(self._running)

    @property
    def idle(self) -> bool:
        """True when no request is queued or running."""
        with self._lock:
            return not self._queue and not self._running

    # -- telemetry ---------------------------------------------------------
    # Mirrors of the plain-dict accounting into the injected registry /
    # tracer. All no-ops when telemetry is off; never touch the server.
    def _count(self, outcome: str, req: _Request | None = None,
               n: int = 1) -> None:
        self.counts[outcome] += n
        if req is not None:
            self.class_counts.setdefault(
                self._class_of(req), collections.Counter())[outcome] += n
        if self.registry is not None:
            self.registry.counter("snn_frontend_requests_total").labels(
                outcome=outcome).inc(n)
            if req is not None:
                self.registry.counter(
                    "snn_frontend_class_outcomes_total").labels(
                    stream_class=self._class_of(req),
                    outcome=outcome).inc(n)

    def _obs_depth(self) -> None:
        if self.registry is not None:
            self.registry.gauge("snn_frontend_queue_depth").set(
                len(self._queue))
            if self.qos is not None:
                gauge = self.registry.gauge(
                    "snn_frontend_class_queue_depth")
                for cls, depth in self._queue.depth_by_class().items():
                    gauge.labels(stream_class=cls).set(depth)

    @staticmethod
    def _class_of(req: _Request) -> str:
        """Per-class accounting label: the tenant given at submit, else
        the view (model) name, else "default" (set once at submission)."""
        return req.tenant

    def _lat(self, key: str, req: _Request, seconds: float) -> None:
        """One latency sample: the global window, the per-class window,
        and (when a registry is wired) the labelled histogram."""
        getattr(self, key).append(seconds)
        per = self._class_lat.setdefault(
            self._class_of(req),
            {k: collections.deque(maxlen=_METRICS_WINDOW)
             for k in ("queue_wait", "service", "total")})
        per[key].append(seconds)
        self._obs_latency(f"snn_frontend_{key}_seconds", req, seconds)

    def _obs_latency(self, name: str, req: _Request,
                     seconds: float) -> None:
        if self.registry is not None:
            self.registry.histogram(name).labels(
                stream_class=self._class_of(req)).observe(seconds)

    def _obs_event(self, kind: str, req: _Request, **attrs) -> None:
        """Record a request-lifecycle event. Request ids and server
        stream uids are independent namespaces sharing one tracer, so
        every request span carries ``domain="request"`` — timeline
        reconstruction keys on (domain, uid) and never aliases rid 0
        with stream uid 0."""
        if self.tracer is not None:
            self.tracer.event(kind, req.rid, domain="request", **attrs)

    def _obs_retired(self, req: _Request, outcome: str) -> None:
        self._obs_event("retired", req, outcome=outcome,
                        steps_done=req.cursor)

    # -- submission --------------------------------------------------------
    def submit(self, chunk, *, view=None, deadline_ms: float | None = None,
               tenant: str | None = None,
               events_capacity: int | None = None,
               events_policy: str = "error") -> RequestHandle:
        """Enqueue a request: the full ``(T, n_inputs)`` external spike
        raster one stream wants served.

        Args:
          chunk: (T, n_inputs) {0,1} spikes — model-local when ``view`` is
            a :class:`~repro_torch.serving.snn.ModelStream` (embedded into the
            fused layout at feed time), server-wide otherwise. T >= 1.
          view: optional ModelStream; its cluster range also decodes the
            output (``session.serve(..., frontend=)`` routes through
            here).
          deadline_ms: overrides the frontend default; measured from
            submission on the frontend clock. A request past its deadline
            is EXPIRED by the pump — refused if still queued, evicted
            mid-stream (slot carry zeroed, partial raster kept).
          tenant: QoS class name (defaults to the view name, else
            "default") — routes the request to its per-tenant queue
            under a QoS policy and labels its per-class metrics either
            way.
          events_capacity/events_policy: when set, the result also
            carries ``'events'`` — the output raster AER-encoded at this
            capacity (see :meth:`SpikeServer.feed_events`).

        Returns a :class:`RequestHandle`. Under backpressure (queue at
        capacity) the policy decides: ``"reject"`` hands back an
        already-terminal handle in state ``"rejected"``; ``"block"``
        pumps until a place frees; ``"drop-oldest"`` drops the oldest
        queued request and admits this one. ``result()`` of a finished
        request: ``{'spikes': (T', n_phys) int32, 'counts'}`` (T' < T
        with ``'partial': True`` when expired/cancelled mid-stream), the
        view-decoded fields for view requests, plus ``'events'`` when
        requested.
        """
        chunk = np.asarray(chunk, np.int32)
        n_in = (view.n_inputs if view is not None
                else self.server.engine.n_inputs)
        if chunk.ndim != 2 or chunk.shape[1] != n_in:
            raise ValueError(
                f"request chunk must be (T, {n_in}), got {chunk.shape}")
        if chunk.shape[0] == 0:
            raise ValueError("request chunk must hold at least 1 timestep")
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        if tenant is None:
            tenant = view.name if view is not None else "default"
        with self._lock:
            now = self.clock()
            req = _Request(
                rid=next(self._rid), chunk=chunk, view=view,
                deadline=(None if deadline_ms is None
                          else now + deadline_ms / 1e3),
                submitted_at=now,
                tenant=str(tenant),
                events_capacity=events_capacity,
                events_policy=events_policy,
            )
            self._count("submitted", req)
            self._obs_event("queued", req, steps=req.steps_total,
                            stream_class=self._class_of(req))
            if not self._make_room():
                req.state = "rejected"
                self._count("rejected", req)
                self._obs_retired(req, "rejected")
                return RequestHandle(self, req)
            self._queue.append(req)
            self._obs_depth()
            if self._work_evt is not None:
                self._work_evt.set()
            return RequestHandle(self, req)

    def submit_events(self, stream, **kwargs) -> RequestHandle:
        """AER-native :meth:`submit`: a ``(T, 1, n_inputs)`` AER stream in
        (decoded through the same shared contract as
        :meth:`SpikeServer.feed_events`), same handle back. Pass
        ``events_capacity`` to get the output as AER too."""
        from repro_torch.serving.snn import decode_aer_chunk

        view = kwargs.get("view")
        n_in = (view.n_inputs if view is not None
                else self.server.engine.n_inputs)
        return self.submit(
            decode_aer_chunk(stream, n_in, "AER request"), **kwargs)

    def cancel(self, handle: RequestHandle) -> bool:
        """Withdraw a request. Queued: removed without ever touching the
        server. Running: evicted mid-stream — the slot carry is zeroed
        (detach semantics) and the partial raster is kept. Parked (or
        queued-for-resume): the spilled carry is evicted from the
        connector; the server is never touched — it holds no state for a
        parked stream. Terminal: returns False (too late)."""
        req = handle._req
        with self._lock:
            if req.state == "queued":
                self._queue.remove(req)
                if req.parked_key is not None:
                    self.connector.evict(req.parked_key)
                    req.parked_key = None
                req.state = "cancelled"
                self._count("cancelled", req)
                self._obs_retired(req, "cancelled")
                self._obs_depth()
                return True
            if req.state == "parked":
                self.connector.evict(req.parked_key)
                req.parked_key = None
                req.state = "cancelled"
                req.finished_at = self.clock()
                self._count("cancelled", req)
                self._obs_retired(req, "cancelled")
                return True
            if req.state == "running":
                self.server.detach(req.uid, reason="cancelled")
                del self._running[req.uid]
                if self.qos is not None:
                    self._queue.note_released(req)
                req.state = "cancelled"
                req.finished_at = self.clock()
                self._count("cancelled", req)
                self._obs_retired(req, "cancelled")
                return True
            return False

    def resume(self, handle: RequestHandle,
               deadline_ms: float | None = None) -> bool:
        """Re-queue a PARKED request: on admission its spilled carry is
        restored into a free slot and the stream continues exactly where
        it left off — the concatenated raster is byte-identical to a
        never-spilled run. ``deadline_ms`` arms a fresh deadline from now
        (None = no deadline this time). Under backpressure the frontend's
        policy applies; ``"reject"`` leaves the request parked and
        returns False."""
        req = handle._req
        with self._lock:
            if req.state != "parked":
                return False
            if not self._make_room():
                return False
            now = self.clock()
            req.deadline = (None if deadline_ms is None
                            else now + deadline_ms / 1e3)
            req.state = "queued"
            self._queue.append(req)
            self._obs_event("queued", req, steps=req.steps_total,
                            stream_class=self._class_of(req),
                            resumed=True)
            self._obs_depth()
            if self._work_evt is not None:
                self._work_evt.set()
            return True

    def _make_room(self) -> bool:
        """Apply the backpressure policy until the queue has a place;
        False = policy says refuse (caller keeps the request out)."""
        if len(self._queue) < self.queue_capacity:
            return True
        if self.backpressure == "reject":
            return False
        if self.backpressure == "drop-oldest":
            # under QoS the shed victim is the lowest-priority class's
            # oldest request, not the global head — load shedding should
            # cost the least important tenant first
            oldest = (self._queue.drop_victim() if self.qos is not None
                      else self._queue.popleft())
            if oldest.parked_key is not None:
                # a resumed-but-not-yet-admitted request falls back to
                # "parked": its carry is still in the connector and a
                # later resume() may try again — shedding the queue
                # place must not lose the stream's state
                oldest.state = "parked"
                self._obs_event("parked", oldest)
            else:
                oldest.state = "dropped"
                self._obs_retired(oldest, "dropped")
            self._count("dropped", oldest)
            return True
        while len(self._queue) >= self.queue_capacity:  # "block"
            progress = self.pump()
            if not any(progress[k] for k in
                       ("admitted", "retired", "expired", "steps")):
                raise RuntimeError(
                    "blocked submit cannot make progress: queue full and "
                    "a pump round moved nothing (no free slots and no "
                    "stream advancing)")
        return True

    # -- the pump ----------------------------------------------------------
    def pump(self) -> dict:
        """One admission + service round (call between chunk steps).

        Order within the round: expire (queued refusals + mid-stream
        evictions) -> admit queue head into every free slot -> ONE
        batched ``feed`` of a ``chunk_steps`` quantum for all running
        streams -> retire finished streams. Returns the round summary
        ``{'admitted', 'retired', 'expired', 'steps', 'queue_depth'}``.
        """
        with self._lock:
            now = self.clock()
            summary = {"admitted": 0, "retired": 0, "expired": 0,
                       "evicted": 0, "steps": 0}
            # 1. deadline expiry — queued requests are refused outright
            # (a resumed one falls back to "parked": its carry is still
            # in the connector and a later resume() may try again)
            for req in [r for r in self._queue
                        if r.deadline is not None and now > r.deadline]:
                self._queue.remove(req)
                if req.parked_key is not None:
                    req.state = "parked"
                    self._obs_event("parked", req)
                else:
                    req.state = "expired"
                    self._count("expired_queued", req)
                    self._obs_retired(req, "expired")
                self._count("expired", req)
                if self.slo is not None:
                    self.slo.record_miss()
                summary["expired"] += 1
            # ... mid-stream streams are evicted like any other eviction:
            # detach zeroes the slot carry, so the next occupant powers
            # up clean.
            # With a connector, the eviction SPILLS instead: the carry is
            # parked under a frontend-namespaced key and the request goes
            # to state "parked" — resume() continues it bit-clean.
            for uid, req in [(u, r) for u, r in self._running.items()
                             if r.deadline is not None
                             and now > r.deadline]:
                del self._running[uid]
                if self.qos is not None:
                    self._queue.note_released(req)
                if self.connector is not None:
                    req.parked_key = (self._spill_ns, req.rid)
                    snap = self.server.snapshot_stream(uid)
                    self.server.detach(uid, reason="parked")
                    self.connector.insert(req.parked_key, snap)
                    req.uid = None
                    req.state = "parked"
                    self._count("parked", req)
                    self._obs_event("parked", req, steps_done=req.cursor)
                else:
                    self.server.detach(uid, reason="expired")
                    req.state = "expired"
                    req.finished_at = now
                    self._count("expired", req)
                    self._count("expired_running", req)
                    self._obs_retired(req, "expired")
                if self.slo is not None:
                    self.slo.record_miss()
                summary["expired"] += 1
            # 1b. SLO-aware preemption (QoS preempt only): every slot
            # busy while an eligible queued request strictly outranks a
            # running stream -> shed the lowest-priority running stream
            # (newest first within it). The victim's carry is PARKED
            # through the connector — never dropped — and it re-queues
            # at the head of its class, continuing bit-clean once
            # pressure clears. One eviction per round: takeover is
            # gradual and the victim sequence stays a pure function of
            # the op sequence.
            if (self.qos is not None and self.qos.preempt
                    and self._queue
                    and self.server.scheduler.free_slots == 0):
                top = self._queue.top_eligible_priority(now)
                victim = (choose_victim(self.qos, self._running.values(),
                                        below=top)
                          if top is not None else None)
                if victim is not None:
                    uid = victim.uid
                    del self._running[uid]
                    self._queue.note_released(victim)
                    victim.parked_key = (self._spill_ns, victim.rid)
                    snap = self.server.snapshot_stream(uid)
                    self.server.detach(uid, reason="parked")
                    self.connector.insert(victim.parked_key, snap)
                    victim.uid = None
                    self._count("evicted", victim)
                    self._count("parked", victim)
                    self._obs_event("parked", victim,
                                    steps_done=victim.cursor,
                                    preempted=True)
                    victim.state = "queued"
                    self._queue.appendleft(victim)
                    self._obs_event("queued", victim,
                                    steps=victim.steps_total,
                                    stream_class=self._class_of(victim),
                                    resumed=True)
                    summary["evicted"] += 1
            # 2. continuous-batching admission: queue head -> free slots
            # (a resumed request re-attaches FROM its parked carry — the
            # only admission that does not power up from zero). Under
            # QoS the "head" is whatever the policy grants next: strict
            # priority, then DRR inside the stratum, quota and token
            # gated — None when every queued class is blocked.
            while self._queue and self.server.scheduler.free_slots > 0:
                if self.qos is not None:
                    req = self._queue.pop_admissible(now)
                    if req is None:
                        break
                else:
                    req = self._queue.popleft()
                resumed = req.parked_key is not None
                if resumed:
                    snap = self.connector.select(req.parked_key)
                    req.uid = self.server.attach_stream(snap)
                    self.connector.evict(req.parked_key)
                    req.parked_key = None
                    self._count("resumed", req)
                    self._obs_event("resumed", req, server_uid=req.uid)
                else:
                    req.uid = self.server.attach()
                self._obs_event("admitted", req,
                                slot=self.server.slot_of(req.uid),
                                server_uid=req.uid, resumed=resumed)
                req.admitted_at = now
                req.state = "running"
                self._running[req.uid] = req
                self._lat("queue_wait", req, now - req.submitted_at)
                summary["admitted"] += 1
            # 3. one service quantum for every running stream, batched
            inputs = {}
            for uid, req in self._running.items():
                piece = req.chunk[req.cursor:
                                  req.cursor + self.server.chunk_steps]
                inputs[uid] = (req.view.embed(piece)
                               if req.view is not None else piece)
            if inputs:
                out = self.server.feed(inputs)
                for uid, res in out.items():
                    req = self._running[uid]
                    req.pieces.append(res["spikes"])
                    req.cursor += res["spikes"].shape[0]
                    summary["steps"] += res["spikes"].shape[0]
            # 4. retire finished streams (slots free for the next round)
            now = self.clock()
            for uid in [u for u, r in self._running.items()
                        if r.cursor >= r.steps_total]:
                req = self._running.pop(uid)
                if self.qos is not None:
                    self._queue.note_released(req)
                self.server.detach(uid, reason="done")
                req.state = "done"
                req.finished_at = now
                self._count("done", req)
                self._lat("service", req, now - req.admitted_at)
                self._lat("total", req, now - req.submitted_at)
                self._obs_retired(req, "done")
                if self.slo is not None:
                    self.slo.record_done(now - req.submitted_at)
                summary["retired"] += 1
            self.rounds += 1
            self.depth_samples.append(len(self._queue))
            if self.registry is not None:
                self.registry.counter("snn_frontend_rounds_total").inc()
                self._obs_depth()
            if self.slo is not None:
                self.slo.record_queue_depth(len(self._queue))
                self.slo.check(now)
            summary["queue_depth"] = len(self._queue)
            return summary

    # -- background pump thread --------------------------------------------
    def start(self, poll_interval_s: float = 0.001) -> None:
        """Run the pump loop on a daemon thread: the real multi-threaded
        front door. Submitters on any thread call :meth:`submit` as usual —
        the queue, counters, and server access all serialize on the
        frontend lock, and each submit wakes the loop out of its idle
        wait. Rounds interleave with submissions on the thread
        scheduler's clock, so threaded runs trade the *replayable* op
        sequence for liveness — accounting invariants (no lost or
        duplicated handles, exact outcome counts) still hold, pinned by
        the stress test in tests/test_torch_qos.py.

        A round that raises ends the thread; :meth:`stop` raises the same
        exception."""
        with self._lock:
            if self._pump_thread is not None:
                raise RuntimeError("pump thread already running")
            self._pump_error = None
            self._stop_evt = threading.Event()
            self._work_evt = threading.Event()
            self._pump_thread = threading.Thread(
                target=self._pump_loop, args=(poll_interval_s,),
                name=f"frontend-pump-{self._spill_ns}", daemon=True)
        self._pump_thread.start()

    def _pump_loop(self, poll_interval_s: float) -> None:
        try:
            while not self._stop_evt.is_set():
                if self.idle:
                    self._work_evt.wait(poll_interval_s)
                    self._work_evt.clear()
                    continue
                self.pump()
        except BaseException as e:  # noqa: BLE001 - re-raised by stop()
            self._pump_error = e

    def stop(self, drain: bool = True,
             timeout_s: float | None = 30.0) -> None:
        """Stop the background pump. ``drain=True`` (default) waits
        until the frontend is idle first so no accepted request is left
        behind; the thread itself is then joined. If a pump round raised
        on the thread, that exception is raised here."""
        thread = self._pump_thread
        if thread is None:
            return
        if drain:
            deadline = (None if timeout_s is None
                        else time.monotonic() + timeout_s)
            while not self.idle and thread.is_alive():
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        "frontend did not drain before stop() timeout")
                time.sleep(0.001)
        self._stop_evt.set()
        self._work_evt.set()
        thread.join(timeout_s)
        if thread.is_alive():
            raise TimeoutError("pump thread did not stop")
        self._pump_thread = None
        self._work_evt = None
        self._stop_evt = None
        if self._pump_error is not None:
            err, self._pump_error = self._pump_error, None
            raise RuntimeError(
                "the frontend's pump thread failed") from err

    def drain(self, max_rounds: int | None = None) -> dict:
        """Pump until idle (or ``max_rounds``); returns :meth:`metrics`.
        Terminates for any finite workload: every round either advances a
        running stream, admits, or expires — progress is monotone."""
        while not self.idle:
            if max_rounds is not None and max_rounds <= 0:
                break
            if max_rounds is not None:
                max_rounds -= 1
            self.pump()
        return self.metrics()

    # -- accounting --------------------------------------------------------
    def metrics(self) -> dict:
        """Front-door accounting: terminal-state counts, queue-wait /
        service / total latency percentiles (seconds), and queue-depth
        stats over the pump rounds so far.

        Shape contract: ``counts`` carries EVERY key in
        :data:`OUTCOME_KEYS` (zero when nothing reached that outcome) and
        every other key is always present — an empty or all-expired run
        returns the same structure as a busy one, so callers index
        without existence checks. Percentile fields are None (not
        missing) when no sample exists. ``by_class`` applies the same
        contract per tenant class: every class a QoS policy declares OR
        traffic has touched appears with the full zero-filled
        ``counts`` and all-None-able latency percentiles (an empty
        QoS-less run yields ``{}``)."""
        with self._lock:
            depth = np.asarray(self.depth_samples or [0])
            counts = {k: int(self.counts.get(k, 0)) for k in OUTCOME_KEYS}
            # ad-hoc outcomes (none today) must never be silently dropped
            counts.update({k: int(v) for k, v in self.counts.items()
                           if k not in counts})
            classes = set(self.class_counts) | set(self._class_lat)
            if self.qos is not None:
                classes |= set(self.qos.classes)
            by_class = {}
            for cls in sorted(classes):
                cc = self.class_counts.get(cls, {})
                lat = self._class_lat.get(cls, {})
                by_class[cls] = {
                    "counts": {k: int(cc.get(k, 0))
                               for k in OUTCOME_KEYS},
                    "queue_wait": latency_percentiles(
                        lat.get("queue_wait", ())),
                    "service": latency_percentiles(
                        lat.get("service", ())),
                    "total": latency_percentiles(lat.get("total", ())),
                }
            return {
                "counts": counts,
                "by_class": by_class,
                "queue_wait": latency_percentiles(self.queue_wait),
                "service": latency_percentiles(self.service),
                "total": latency_percentiles(self.total),
                "queue_depth": {"max": int(depth.max()),
                                "mean": float(depth.mean())},
                "rounds": self.rounds,
            }

    # -- handle internals --------------------------------------------------
    def _poll(self, req: _Request) -> dict:
        with self._lock:
            st = {"state": req.state, "steps_done": req.cursor,
                  "steps_total": req.steps_total}
            if req.state == "queued":
                st["queue_position"] = self._queue.index(req)
            return st

    def _result(self, req: _Request) -> dict | None:
        with self._lock:
            if req.state not in _TERMINAL or not req.pieces:
                return None
            if req.result_cache is not None:
                return req.result_cache
            raster = np.concatenate(req.pieces, axis=0)
            if req.view is not None:
                res = req.view.decode(raster)
            else:
                res = {"spikes": raster, "counts": raster.sum(axis=0)}
            if req.cursor < req.steps_total:
                res["partial"] = True
            if req.events_capacity is not None:
                from repro_torch.events.aer import dense_to_aer
                res["events"] = dense_to_aer(
                    res["spikes"][:, None, :], req.events_capacity,
                    policy=req.events_policy)
            req.result_cache = res
            return res

    def _timing(self, req: _Request) -> dict:
        with self._lock:
            qw = sv = tot = None
            if req.admitted_at is not None:
                qw = req.admitted_at - req.submitted_at
            if req.finished_at is not None and req.admitted_at is not None:
                sv = req.finished_at - req.admitted_at
                tot = req.finished_at - req.submitted_at
            return {"queue_wait": qw, "service": sv, "total": tot}
