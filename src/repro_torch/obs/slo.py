"""Declarative SLO objectives evaluated as rolling burn-rate windows.

An :class:`SLObjective` states a promise about the serving front door —
"p99 total latency under 80 ms", "deadline-miss ratio under 2%",
"admission queue never deeper than 16" — and an :class:`SLOWatchdog`
holds a set of them against live traffic. The frontend's pump feeds the
watchdog (total latencies on retire, misses on deadline expiry, queue
depth each round) and calls :meth:`SLOWatchdog.check` once per round;
the watchdog prunes its rolling windows on the injectable clock,
computes each objective's **burn rate** — observed value over threshold,
the classic error-budget-consumption number, > 1 while breaching — and
fires ``on_breach`` callbacks on the *transition into* breach (one dump
per incident, not one per evaluation).

Like everything in ``repro_torch.obs``, the watchdog is observational: it
never touches admission, and with a registry attached it mirrors burn
rates into the ``snn_slo_burn_rate`` gauges and breach onsets into
``snn_slo_breaches_total``.

Objective kinds:

- ``"latency_p99"`` — p99 of recorded total latencies (seconds) in the
  window vs a seconds threshold.
- ``"miss_ratio"`` — deadline misses / (misses + dones) in the window vs
  a ratio threshold. Every deadline expiry counts as a miss, whether the
  request was refused while queued, evicted mid-stream, or spilled to a
  connector: the deadline was missed either way.
- ``"queue_depth"`` — max recorded queue depth in the window vs a depth
  ceiling.

Twin of :mod:`repro.obs.slo` (the same code, numpy and the standard
library only; the port imports nothing of the JAX package).
"""

from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np

__all__ = ["SLObjective", "SLOStatus", "SLOWatchdog"]

_KINDS = ("latency_p99", "miss_ratio", "queue_depth")


@dataclasses.dataclass(frozen=True)
class SLObjective:
    """One declarative objective: a kind, a threshold, a window."""

    name: str
    kind: str            # one of _KINDS
    threshold: float     # seconds / ratio / depth, by kind
    window_s: float = 60.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown SLO kind {self.kind!r}; expected one of "
                f"{_KINDS}")
        if self.threshold <= 0:
            raise ValueError(
                f"SLO threshold must be positive, got {self.threshold}")
        if self.window_s <= 0:
            raise ValueError(
                f"SLO window_s must be positive, got {self.window_s}")


@dataclasses.dataclass
class SLOStatus:
    """One objective's state at one evaluation."""

    objective: SLObjective
    value: float | None   # observed value on the window (None: no data)
    burn_rate: float      # value / threshold (0.0 with no data)
    breached: bool
    n_samples: int

    def to_dict(self) -> dict:
        return {
            "name": self.objective.name,
            "kind": self.objective.kind,
            "threshold": self.objective.threshold,
            "window_s": self.objective.window_s,
            "value": self.value,
            "burn_rate": self.burn_rate,
            "breached": self.breached,
            "n_samples": self.n_samples,
        }


class SLOWatchdog:
    """Hold SLO objectives against a live run; evaluate burn rates.

    Args:
      objectives: the :class:`SLObjective` set to watch.
      clock: injectable monotonic-seconds callable (virtual in tests).
      registry: optional ``MetricsRegistry`` — burn rates mirror into
        ``snn_slo_burn_rate{objective=...}``, breach onsets count in
        ``snn_slo_breaches_total{objective=...}``.
      on_breach: callables fired with the :class:`SLOStatus` on each
        transition into breach (e.g. a flight recorder's dump hook).
    """

    def __init__(self, objectives, *, clock=time.perf_counter,
                 registry=None, on_breach=()):
        objectives = list(objectives)
        names = [o.name for o in objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate objective names: {names}")
        self.objectives = objectives
        self.clock = clock
        self.registry = registry
        self.on_breach = list(on_breach if not callable(on_breach)
                              else [on_breach])
        # rolling (t, value) samples per signal; pruned to the longest
        # objective window at each check. Misses and dones are events
        # (value unused); latencies and depths carry their value.
        self._samples: dict[str, collections.deque] = {
            "latency": collections.deque(),
            "miss": collections.deque(),
            "done": collections.deque(),
            "depth": collections.deque(),
        }
        self._breached: dict[str, bool] = {o.name: False
                                           for o in objectives}
        self._breach_counts: dict[str, int] = {o.name: 0
                                               for o in objectives}

    # -- recording (the frontend pump's feed points) ------------------
    def record_done(self, total_seconds: float) -> None:
        """A request retired in time; its submit-to-retire latency."""
        now = self.clock()
        self._samples["latency"].append((now, float(total_seconds)))
        self._samples["done"].append((now, 1.0))

    def record_miss(self) -> None:
        """A deadline was missed (refusal, eviction, or spill)."""
        self._samples["miss"].append((self.clock(), 1.0))

    def record_queue_depth(self, depth: int) -> None:
        self._samples["depth"].append((self.clock(), float(depth)))

    # -- evaluation ---------------------------------------------------
    def _window(self, signal: str, now: float,
                window_s: float) -> list[float]:
        return [v for t, v in self._samples[signal]
                if t >= now - window_s]

    def _prune(self, now: float) -> None:
        horizon = max((o.window_s for o in self.objectives), default=0.0)
        for dq in self._samples.values():
            while dq and dq[0][0] < now - horizon:
                dq.popleft()

    def _evaluate(self, obj: SLObjective, now: float) -> SLOStatus:
        if obj.kind == "latency_p99":
            xs = self._window("latency", now, obj.window_s)
            value = (float(np.percentile(np.asarray(xs), 99))
                     if xs else None)
            n = len(xs)
        elif obj.kind == "miss_ratio":
            misses = len(self._window("miss", now, obj.window_s))
            dones = len(self._window("done", now, obj.window_s))
            n = misses + dones
            value = misses / n if n else None
        else:  # queue_depth
            xs = self._window("depth", now, obj.window_s)
            value = float(max(xs)) if xs else None
            n = len(xs)
        burn = (value / obj.threshold) if value is not None else 0.0
        return SLOStatus(objective=obj, value=value, burn_rate=burn,
                         breached=burn > 1.0, n_samples=n)

    def check(self, now: float | None = None) -> list[SLOStatus]:
        """Evaluate every objective on its rolling window.

        Updates the registry mirrors, fires ``on_breach`` on each
        objective's transition into breach, and returns the statuses.
        """
        now = self.clock() if now is None else now
        self._prune(now)
        statuses = [self._evaluate(o, now) for o in self.objectives]
        for status in statuses:
            name = status.objective.name
            if self.registry is not None:
                self.registry.gauge("snn_slo_burn_rate").labels(
                    objective=name).set(status.burn_rate)
            if status.breached and not self._breached[name]:
                self._breach_counts[name] += 1
                if self.registry is not None:
                    self.registry.counter(
                        "snn_slo_breaches_total").labels(
                        objective=name).inc()
                for cb in self.on_breach:
                    cb(status)
            self._breached[name] = status.breached
        return statuses

    # -- reporting ----------------------------------------------------
    def report(self, now: float | None = None) -> dict:
        """Structured summary: one entry per objective plus breach
        totals — the ``slo`` block of the serve_snn summary. Pure read:
        neither registry mirrors nor breach callbacks fire (report()
        reads, check() acts)."""
        now = self.clock() if now is None else now
        self._prune(now)
        return {
            "objectives": [self._evaluate(o, now).to_dict()
                           for o in self.objectives],
            "breaches": dict(self._breach_counts),
        }
