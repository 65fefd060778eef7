"""Straggler detection & mitigation hooks.

At pod scale, a single slow host (thermal throttling, ECC retry storms,
network flaps) stretches every synchronous step. The detector keeps an
EWMA + variance of per-host step times and flags hosts whose time exceeds
``mean + threshold_sigma * std`` for ``patience`` consecutive steps.

Mitigations are pluggable callbacks; built in:
  * ``rebalance``: shrink the flagged host's data shard (returns a new
    shard-size vector; the stateless data pipeline makes re-sharding a
    pure re-parameterization — no data movement),
  * ``evict``: mark the host for exclusion at the next checkpoint restart
    (elastic scale-down; checkpoints are mesh-agnostic so restart on N-1
    hosts is a load with a different mesh).

The logic is pure and unit-tested with synthetic timings; the wall-clock
plumbing lives in training.loop.

Twin of :mod:`repro.distributed.straggler` (the same code, numpy and the
standard library only; the port imports nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["StragglerDetector", "donor_shards", "observe_from_registry",
           "rebalance_shards"]


@dataclasses.dataclass
class StragglerDetector:
    num_hosts: int
    alpha: float = 0.1              # EWMA coefficient
    threshold_sigma: float = 3.0
    patience: int = 5
    warmup_steps: int = 10

    def __post_init__(self):
        self._mean = np.zeros(self.num_hosts)
        self._var = np.zeros(self.num_hosts)
        self._strikes = np.zeros(self.num_hosts, np.int64)
        self._steps = 0

    def observe(self, step_times: np.ndarray) -> np.ndarray:
        """Feed per-host step times; returns bool mask of flagged hosts."""
        t = np.asarray(step_times, np.float64)
        if t.shape != (self.num_hosts,):
            raise ValueError(f"expected ({self.num_hosts},), got {t.shape}")
        self._steps += 1
        if self._steps == 1:
            self._mean[:] = t
        delta = t - self._mean
        self._mean += self.alpha * delta
        self._var = (1 - self.alpha) * (self._var + self.alpha * delta**2)
        if self._steps <= self.warmup_steps:
            return np.zeros(self.num_hosts, bool)
        fleet_mean = self._mean.mean()
        fleet_std = max(np.sqrt(self._var.mean()), 1e-9)
        slow = t > fleet_mean + self.threshold_sigma * fleet_std
        self._strikes = np.where(slow, self._strikes + 1, 0)
        return self._strikes >= self.patience

    @property
    def stats(self) -> dict:
        return {
            "mean": self._mean.copy(),
            "std": np.sqrt(self._var),
            "strikes": self._strikes.copy(),
        }


def observe_from_registry(detector: StragglerDetector, registry,
                          *, metric: str = "snn_shard_step_seconds",
                          tracer=None) -> np.ndarray:
    """One detector step driven by the registry's per-shard gauges.

    Reads the most recent ``metric`` gauge value for every shard label
    ``0..num_hosts-1`` (an instrumented dispatch loop — serve_snn's
    ShardLoadWatch — sets them each round), feeds the vector to
    :meth:`StragglerDetector.observe`, and mirrors the resulting flags
    back into the ``snn_shard_straggler_flagged`` gauges so the flags are
    exportable alongside the timings. Returns the bool flag mask —
    identical to calling ``observe`` on the same vector directly (pinned
    by tests/test_torch_obs.py).

    With a ``tracer``, each call also records one ``shard_step`` span
    carrying the per-shard time vector and the flags it produced — the
    mesh-lane record ``repro_torch.obs.timeline.mesh_lanes`` folds into a
    per-device barrier breakdown, and
    ``repro_torch.obs.timeline.verify_shard_lanes`` replays through a fresh
    detector to pin that this registry-transported path and the pure
    ``observe`` agree exactly."""
    fam = registry.gauge(metric)
    times = np.asarray(
        [fam.labels(shard=s).value for s in range(detector.num_hosts)],
        np.float64)
    flags = detector.observe(times)
    flag_fam = registry.gauge("snn_shard_straggler_flagged")
    for shard, f in enumerate(flags):
        flag_fam.labels(shard=shard).set(int(f))
    if tracer is not None:
        tracer.event("shard_step", None,
                     times=[float(t) for t in times],
                     flags=[int(f) for f in flags])
    return flags


def donor_shards(flagged: np.ndarray) -> np.ndarray:
    """The detector's donor list: indices of UNflagged hosts/shards, the
    candidates to receive migrated work. Serving-side live migration
    (``repro_torch.serving.connector.rebalance_streams``) walks streams off
    flagged batch shards onto these."""
    flagged = np.asarray(flagged, bool)
    return np.where(~flagged)[0]


def rebalance_shards(batch_size: int, flagged: np.ndarray,
                     relief: float = 0.5) -> np.ndarray:
    """Shrink flagged hosts' shards by ``relief``, redistribute to the rest.

    Returns per-host shard sizes summing to batch_size.
    """
    n = len(flagged)
    base = batch_size // n
    sizes = np.full(n, base, np.int64)
    sizes[: batch_size - base * n] += 1  # distribute remainder
    if not flagged.any() or flagged.all():
        return sizes
    taken = 0
    for i in np.where(flagged)[0]:
        cut = int(sizes[i] * relief)
        sizes[i] -= cut
        taken += cut
    healthy = np.where(~flagged)[0]
    for j, i in enumerate(healthy):
        sizes[i] += taken // len(healthy) + (1 if j < taken % len(healthy)
                                             else 0)
    assert sizes.sum() == batch_size
    return sizes
