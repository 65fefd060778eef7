"""Multi-tenant QoS admission policy for the async front door.

SNAP-V's management core exists so many small SNN workloads can share
one accelerator; a FIFO
:class:`~repro_torch.serving.frontend.AsyncSpikeFrontend` gives them a
front door, but admits strictly in arrival order — one bursty tenant
starves everyone behind it. This module is the admission *policy* layer
the frontend consults when built with ``qos=``:

  * :class:`QoSClass` — one tenant class: ``priority`` (strict strata,
    higher admits first), ``weight`` (fair share inside a stratum),
    ``max_slots`` (concurrent-slot quota), ``rate_per_s`` + ``burst``
    (token bucket on the frontend's injectable clock).
  * :class:`QoSPolicy` — the frozen bundle of classes plus the DRR
    ``quantum`` and the ``preempt`` switch (SLO-aware eviction: shed the
    lowest-priority running stream, parking its carry through the
    carry connector rather than dropping it).
  * :class:`WeightedFairQueue` — per-class FIFO queues scheduled by
    deficit round-robin inside the highest eligible priority stratum.
    Deficits are measured in *timesteps* (a request's cost is its
    ``steps_total``), so weights fair-share actual service demand the
    way classic DRR fair-shares bytes.
  * :func:`choose_victim` — the deterministic preemption rule: lowest
    priority first, newest request (highest rid) within it.

Determinism contract (pinned against the JAX twin by
tests/test_torch_qos.py): every decision here — which class admits,
which request within it, which running stream is shed — is a pure
function of the submit / cancel / pump op sequence and the injected
clock values. No wall time, no randomness, no iteration over unordered
containers. QoS never touches the numerical path: it reorders WHEN
requests run, never what they compute (the frontend's exactness contract
carries over unchanged).

Twin of :mod:`repro.serving.qos` (the same code, numpy and the standard
library only; the port imports nothing of the JAX package).
"""

from __future__ import annotations

import collections
import dataclasses

__all__ = [
    "QoSClass",
    "QoSPolicy",
    "WeightedFairQueue",
    "choose_victim",
]


@dataclasses.dataclass(frozen=True)
class QoSClass:
    """Admission parameters for one tenant class.

    ``priority`` ranks strata (strictly higher admits first whenever it
    has eligible work); ``weight`` scales the DRR quantum inside a
    stratum (a weight-4 class is granted 4x the timestep deficit of a
    weight-1 peer per scheduling visit); ``max_slots`` caps the class's
    concurrently running streams (None = unlimited); ``rate_per_s`` +
    ``burst`` arm a token bucket on the frontend clock — each admission
    consumes one token, tokens refill at ``rate_per_s`` up to ``burst``
    (None rate = unlimited). A class blocked by quota or tokens yields
    its turn; lower strata may use the slot (work conservation).
    """

    priority: int = 0
    weight: int = 1
    max_slots: int | None = None
    rate_per_s: float | None = None
    burst: int = 1

    def __post_init__(self):
        if self.weight < 1:
            raise ValueError(f"weight must be >= 1, got {self.weight}")
        if self.max_slots is not None and self.max_slots < 1:
            raise ValueError(
                f"max_slots must be >= 1 or None, got {self.max_slots}")
        if self.rate_per_s is not None and self.rate_per_s <= 0:
            raise ValueError(
                f"rate_per_s must be positive or None, got "
                f"{self.rate_per_s}")
        if self.burst < 1:
            raise ValueError(f"burst must be >= 1, got {self.burst}")


@dataclasses.dataclass(frozen=True)
class QoSPolicy:
    """The knob bundle ``AsyncSpikeFrontend(qos=...)`` /
    ``FrontendConfig(qos=...)`` take.

    ``classes`` maps tenant name -> :class:`QoSClass`; a request's
    tenant (``submit(..., tenant=)``, defaulting to its view name) not
    in the map gets ``default``. ``quantum`` is the DRR base grant in
    timesteps per scheduling visit (multiplied by the class weight).
    ``preempt`` enables SLO-aware eviction: under overload, a queued
    request whose class strictly outranks a running stream sheds the
    lowest-priority running stream — its carry is parked through the
    frontend's connector (required when ``preempt`` is set) and the
    victim re-queues at the head of its class, continuing bit-clean
    once pressure clears.
    """

    classes: dict[str, QoSClass] = dataclasses.field(default_factory=dict)
    default: QoSClass = dataclasses.field(default_factory=QoSClass)
    quantum: int = 8
    preempt: bool = False

    def __post_init__(self):
        if self.quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {self.quantum}")
        for name, spec in self.classes.items():
            if not isinstance(spec, QoSClass):
                raise TypeError(
                    f"class {name!r} must be a QoSClass, got "
                    f"{type(spec).__name__}")

    def spec_of(self, tenant: str) -> QoSClass:
        return self.classes.get(tenant, self.default)


class WeightedFairQueue:
    """Per-class FIFO queues under strict priority + deficit round-robin.

    Drop-in for the frontend's single ``deque`` (``len`` / ``bool`` /
    iteration / ``append`` / ``appendleft`` / ``remove`` / ``index``
    all work), plus the scheduling verbs the pump uses:

      * :meth:`pop_admissible` — the next request the policy grants a
        slot (or None when every queued class is blocked by quota or
        tokens). Consumes one token and charges the class deficit.
      * :meth:`top_eligible_priority` — the highest stratum that could
        admit right now (the preemption trigger).
      * :meth:`drop_victim` — backpressure shedding: the oldest request
        of the lowest-priority non-empty class.
      * :meth:`note_released` — a running stream of the class finished /
        was evicted (quota bookkeeping).

    Iteration (and therefore ``index``, the handle's queue_position)
    runs priority-descending, then class first-seen order, then FIFO
    within the class — the order the scheduler itself favors.
    """

    def __init__(self, policy: QoSPolicy):
        self.policy = policy
        self._queues: dict[str, collections.deque] = {}
        self._order: list[str] = []            # first-seen ring order
        self._deficit: dict[str, float] = {}
        self._tokens: dict[str, float] = {}
        self._token_at: dict[str, float | None] = {}
        self.running = collections.Counter()   # class -> running streams
        # per-priority DRR cursor: the class currently holding the
        # grant, and whether its quantum for this visit is still owed
        self._drr: dict[int, dict] = {}
        # classes named by the policy exist from the start so quotas /
        # buckets / zero-filled gauges do not depend on traffic order
        for name in policy.classes:
            self._register(name)

    # -- class registry ----------------------------------------------------
    def _register(self, cls: str) -> None:
        if cls not in self._queues:
            self._queues[cls] = collections.deque()
            self._order.append(cls)
            self._deficit[cls] = 0.0
            self._tokens[cls] = float(self.policy.spec_of(cls).burst)
            self._token_at[cls] = None

    @property
    def classes(self) -> tuple[str, ...]:
        """Every class seen so far (policy-declared first)."""
        return tuple(self._order)

    def depth_by_class(self) -> dict[str, int]:
        return {c: len(self._queues[c]) for c in self._order}

    # -- deque-compatible surface -----------------------------------------
    def __len__(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def __iter__(self):
        for cls in sorted(
                self._order,
                key=lambda c: (-self.policy.spec_of(c).priority,
                               self._order.index(c))):
            yield from self._queues[cls]

    def append(self, req) -> None:
        self._register(req.tenant)
        self._queues[req.tenant].append(req)

    def appendleft(self, req) -> None:
        """Head-of-class re-queue (preempted victims continue first)."""
        self._register(req.tenant)
        self._queues[req.tenant].appendleft(req)

    def remove(self, req) -> None:
        self._queues[req.tenant].remove(req)

    def index(self, req) -> int:
        for i, r in enumerate(self):
            if r is req:
                return i
        raise ValueError("request is not queued")

    # -- eligibility -------------------------------------------------------
    def _refill(self, cls: str, now: float) -> None:
        spec = self.policy.spec_of(cls)
        if spec.rate_per_s is None:
            return
        last = self._token_at[cls]
        if last is None:
            self._token_at[cls] = now
            return
        if now > last:
            self._tokens[cls] = min(
                float(spec.burst),
                self._tokens[cls] + (now - last) * spec.rate_per_s)
            self._token_at[cls] = now

    def _eligible(self, cls: str, now: float) -> bool:
        """May this class admit its head right now? (non-empty queue,
        quota headroom, and a whole token in the bucket)"""
        if not self._queues[cls]:
            return False
        spec = self.policy.spec_of(cls)
        if spec.max_slots is not None and self.running[cls] >= spec.max_slots:
            return False
        if spec.rate_per_s is not None:
            self._refill(cls, now)
            if self._tokens[cls] < 1.0:
                return False
        return True

    def top_eligible_priority(self, now: float) -> int | None:
        """Highest priority that could admit a request right now, or
        None when every queued class is blocked (quota / tokens)."""
        prios = [self.policy.spec_of(c).priority
                 for c in self._order if self._eligible(c, now)]
        return max(prios) if prios else None

    # -- scheduling --------------------------------------------------------
    def pop_admissible(self, now: float):
        """The next request the policy admits, or None.

        Strict priority picks the highest stratum with an eligible
        class; deficit round-robin arbitrates inside it: the cursor
        class is granted ``quantum * weight`` timesteps per visit and
        serves FIFO while its deficit covers the head's ``steps_total``;
        exhausted (or blocked) classes pass the grant on. An emptied
        class forfeits its leftover deficit (classic DRR anti-hoarding).
        Serving consumes one token and counts the stream as running.
        """
        top = self.top_eligible_priority(now)
        if top is None:
            return None
        ring = [c for c in self._order
                if self.policy.spec_of(c).priority == top]
        cur = self._drr.setdefault(top, {"at": None, "grant": True})
        if cur["at"] not in ring:
            cur["at"], cur["grant"] = ring[0], True
        i = ring.index(cur["at"])
        # each full lap grants every eligible class one quantum, so the
        # largest head cost bounds the laps needed before someone serves
        max_cost = max(self._queues[c][0].steps_total
                       for c in ring if self._eligible(c, now))
        budget = len(ring) * (2 + max_cost // self.policy.quantum)
        for _ in range(budget + 1):
            cls = ring[i]
            spec = self.policy.spec_of(cls)
            if self._eligible(cls, now):
                if cur["grant"]:
                    self._deficit[cls] += float(
                        self.policy.quantum * spec.weight)
                    cur["grant"] = False
                head = self._queues[cls][0]
                if self._deficit[cls] >= head.steps_total:
                    self._queues[cls].popleft()
                    self._deficit[cls] -= float(head.steps_total)
                    if not self._queues[cls]:
                        self._deficit[cls] = 0.0
                    if spec.rate_per_s is not None:
                        self._tokens[cls] -= 1.0
                    self.running[cls] += 1
                    cur["at"] = cls           # keep serving while deficit lasts
                    return head
            elif not self._queues[cls]:
                self._deficit[cls] = 0.0
            i = (i + 1) % len(ring)
            cur["at"], cur["grant"] = ring[i], True
        return None     # unreachable: the budget covers the worst case

    def note_admitted(self, req) -> None:
        """Count a stream admitted OUTSIDE pop_admissible (not used by
        the pump today; kept so external pump loops keep quotas honest)."""
        self._register(req.tenant)
        self.running[req.tenant] += 1

    def note_released(self, req) -> None:
        """A running stream of this class retired / expired / was
        cancelled or preempted — give its quota unit back."""
        self.running[req.tenant] -= 1

    def drop_victim(self):
        """Backpressure shedding (``drop-oldest`` under QoS): among the
        non-empty classes of the LOWEST priority, drop the oldest
        request (smallest rid) — the least important, stalest work."""
        heads = [self._queues[c][0] for c in self._order
                 if self._queues[c]]
        if not heads:
            raise IndexError("drop_victim on an empty queue")
        low = min(self.policy.spec_of(h.tenant).priority for h in heads)
        victim = min((h for h in heads
                      if self.policy.spec_of(h.tenant).priority == low),
                     key=lambda h: h.rid)
        self._queues[victim.tenant].popleft()
        return victim


def choose_victim(policy: QoSPolicy, running, *, below: int):
    """The preemption rule: among running requests whose class priority
    is strictly below ``below``, shed the lowest-priority one; ties
    break to the NEWEST (highest rid) so long-running streams keep
    their sunk service. Returns None when nothing outranked runs."""
    victims = [r for r in running
               if policy.spec_of(r.tenant).priority < below]
    if not victims:
        return None
    return min(victims,
               key=lambda r: (policy.spec_of(r.tenant).priority, -r.rid))
