"""The port's multi-tenant QoS admission (``repro_torch.serving.qos``) and
its use by the async front door, against the JAX package's.

The scripted op runner of ``test_torch_frontend.py`` runs both packages'
frontends under one QoS policy (strict priority, weighted fair queueing,
slot quotas, token buckets, preemption that parks the victim's carry in
the connector) on one injected clock: admission order, eviction victims,
states, output bytes, metrics, Prometheus text and timelines must be
equal, and every completed request byte-identical to a never-preempted
run.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_frontend import (BACKENDS, Pkg,  # noqa: E402
                                 _session_nets, assert_drives_equal,
                                 drive, one_shot, rasters, weights)

from repro.serving import qos as jqos  # noqa: E402
from repro_torch.core.session import AcceleratorSession as TSession  # noqa: E402
from repro_torch.serving import frontend as tfront  # noqa: E402
from repro_torch.serving import qos as tqos  # noqa: E402

TWO_CLASS = {"classes": {"hi": {"priority": 1, "weight": 4},
                         "bg": {"priority": 0, "weight": 1}}}


def _mix(seed: int) -> dict:
    """A deterministic priority / weight / quota / rate mix from seed."""
    r = np.random.default_rng(seed)
    classes = {}
    for name in ("hi", "mid", "bg"):
        classes[name] = {
            "priority": int(r.integers(0, 3)),
            "weight": int(r.integers(1, 5)),
            "max_slots": (None if r.random() < 0.5
                          else int(r.integers(1, 3))),
            "rate_per_s": (None if r.random() < 0.5
                           else float(r.integers(1, 4)) / 2.0),
            "burst": int(r.integers(1, 3)),
        }
    return {"classes": classes, "quantum": int(r.integers(1, 9)),
            "preempt": bool(r.random() < 0.5)}


def _tenant_ops(seed, n=10, cancels=2):
    r = np.random.default_rng(seed)
    tenants = r.choice(["hi", "mid", "bg"], size=n)
    cancel_at = set(r.integers(0, n, size=cancels).tolist())
    ops = []
    for i in range(n):
        ops.append(("submit", i, {"tenant": str(tenants[i])}))
        if i in cancel_at:
            ops.append(("cancel", i))
    return ops + [("drain", 1.0)], tuple(int(t) for t in
                                         r.integers(1, 9, size=n))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("seed", [0, 3, 5, 11])
def test_policy_mix_matches_jax(seed, backend):
    ops, lengths = _tenant_ops(seed)
    qos = _mix(seed)
    got = assert_drives_equal(backend, ops, lengths=lengths, n_slots=2,
                              chunk=3, capacity=4, qos=qos, spill=True)
    assert set(got["metrics"]["by_class"]) == {"hi", "mid", "bg"}


@pytest.mark.parametrize("backpressure", ["reject", "drop-oldest"])
def test_drop_and_reject_under_qos_match_jax(backpressure):
    ops, lengths = _tenant_ops(5, n=8, cancels=1)
    assert_drives_equal("cuda", ops, lengths=lengths, n_slots=1, chunk=2,
                        capacity=2, qos=_mix(5), spill=True,
                        backpressure=backpressure)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("preempt", [False, True])
def test_burst_over_background_matches_jax(backend, preempt):
    """A background class trickles in; a burst of the high class lands
    at once mid-run; with preemption the running background streams are
    parked through the connector and resume bit-clean."""
    ops = [("submit", i, {"tenant": "bg"}) for i in range(4)]
    ops += [("pump", 1.0), ("pump", 1.0)]
    ops += [("submit", i, {"tenant": "hi"}) for i in range(4, 7)]
    ops += [("submit", 7, {"tenant": "bg", "deadline_ms": 30_000.0}),
            ("drain", 1.0)]
    qos = dict(TWO_CLASS, preempt=preempt)
    lengths = (12, 10, 8, 9, 4, 5, 3, 6)
    got = assert_drives_equal(backend, ops, lengths=lengths, n_slots=2,
                              chunk=2, capacity=8, qos=qos)
    counts = got["metrics"]["counts"]
    assert counts["done"] == len(lengths)
    assert (counts["evicted"] > 0) == preempt
    raw = rasters(1, lengths)
    for i, res in enumerate(got["results"]):
        assert res["spikes"] == one_shot(raw[i]).tobytes()
    hi = got["metrics"]["by_class"]["hi"]["total"]
    assert hi["p99"] is not None


def test_qos_isolation_beats_fifo_for_the_burst():
    """The bench's claim on the plain clock: the high class's p99 under
    QoS is strictly below its p99 behind a FIFO queue."""
    ops = [("submit", i, {"tenant": "bg"}) for i in range(6)]
    ops += [("pump", 1.0)] * 3
    ops += [("submit", i, {"tenant": "hi"}) for i in range(6, 9)]
    ops += [("drain", 1.0)]
    kw = dict(lengths=(8,) * 9, n_slots=2, chunk=4, capacity=16)
    fifo = drive(Pkg(True, "cuda"), ops, **kw)
    for preempt in (False, True):
        q = drive(Pkg(True, "cuda"), ops, qos=dict(TWO_CLASS,
                                                   preempt=preempt), **kw)
        assert (q["metrics"]["by_class"]["hi"]["total"]["p99"]
                < fifo["metrics"]["by_class"]["hi"]["total"]["p99"])


# --------------------------------------------------------------------------
# the policy layer itself
# --------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    ("cls", {"weight": 0}), ("cls", {"rate_per_s": 0.0}),
    ("cls", {"burst": 0}), ("cls", {"max_slots": 0}),
    ("policy", {"quantum": 0}), ("policy", {"classes": {"x": object()}})])
def test_policy_validation_matches_jax(bad):
    where, kw = bad
    errs = []
    for mod in (jqos, tqos):
        ctor = mod.QoSClass if where == "cls" else mod.QoSPolicy
        with pytest.raises((ValueError, TypeError)) as e:
            ctor(**kw)
        errs.append((type(e.value).__name__, str(e.value)))
    assert errs[1] == errs[0]


@dataclasses.dataclass
class R:
    rid: int
    tenant: str
    steps: int = 4

    @property
    def steps_total(self):
        return self.steps


def _queue_trace(mod):
    policy = mod.QoSPolicy(
        classes={"hi": mod.QoSClass(priority=1, weight=2),
                 "mid": mod.QoSClass(priority=1, max_slots=1),
                 "bg": mod.QoSClass(rate_per_s=1.0, burst=1)},
        quantum=3)
    q = mod.WeightedFairQueue(policy)
    reqs = [R(i, t, s) for i, (t, s) in enumerate(
        [("bg", 4), ("hi", 2), ("mid", 5), ("bg", 1), ("hi", 6),
         ("mid", 3), ("other", 2)])]
    for x in reqs:
        q.append(x)
    out = [list(x.rid for x in q), q.depth_by_class(),
           q.index(reqs[3]), q.drop_victim().rid]
    q.appendleft(reqs[0])
    now, held = 0.0, []
    while q:
        got = q.pop_admissible(now)
        out.append((now, None if got is None else got.rid,
                    q.top_eligible_priority(now), dict(q.running)))
        # each admission holds its slot until the next one lands
        if got is not None:
            for x in held:
                q.note_released(x)
            held = [got]
        now += 0.5
        assert now < 50
    running = [R(i, t) for i, t in enumerate(["bg", "hi", "bg", "mid"])]
    out.append([None if v is None else v.rid for v in (
        mod.choose_victim(policy, running, below=p) for p in (0, 1, 2))])
    return out


def test_weighted_fair_queue_matches_jax():
    assert _queue_trace(tqos) == _queue_trace(jqos)


def test_session_frontend_qos_conflict():
    (_, net), _ = _session_nets(3)
    s = TSession(device="cpu")
    s.deploy("a", net)

    def policy():
        return tqos.QoSPolicy(classes={"a": tqos.QoSClass(priority=1)},
                              preempt=True)

    cfg = tfront.FrontendConfig(queue_capacity=8, qos=policy())
    va = s.serve("a", n_slots=2, chunk_steps=3, frontend=cfg)
    assert va.frontend.qos == policy()
    assert va.frontend.connector is s.connector   # preemption parks there
    same = tfront.FrontendConfig(queue_capacity=8, qos=policy())
    assert s.serve("a", n_slots=2, chunk_steps=3,
                   frontend=same).frontend is va.frontend
    with pytest.raises(ValueError, match="one request queue"):
        s.serve("a", n_slots=2, chunk_steps=3,
                frontend=tfront.FrontendConfig(queue_capacity=8))


@pytest.mark.parametrize("use_qos", [False, True])
def test_threaded_submit_against_pump_loop(use_qos):
    """Submitter threads against the background pump: every handle ends
    terminal, no rid is lost or duplicated, the outcome counters
    balance."""
    import threading

    pkg = Pkg(True, "cuda")
    policy = pkg.policy({"classes": {"t0": {"priority": 1, "weight": 2},
                                     "t1": {}, "t2": {}}}) if use_qos \
        else None
    server = pkg.server(pkg.engine(weights(4)), n_slots=2, chunk_steps=2)
    fe = tfront.AsyncSpikeFrontend(server, queue_capacity=64, qos=policy)
    out = [[] for _ in range(3)]

    def submitter(tid):
        r = np.random.default_rng(200 + tid)
        for _ in range(6):
            out[tid].append(fe.submit(
                (r.random((3, 10)) < 0.3).astype(np.int32),
                tenant=f"t{tid}"))

    fe.start(poll_interval_s=0.0005)
    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    fe.stop(drain=True)
    handles = [h for per in out for h in per]
    assert len({h.rid for h in handles}) == 18
    assert all(h.done for h in handles)
    c = fe.metrics()["counts"]
    assert c["submitted"] == 18 == c["done"] + c["rejected"]
    assert fe.queue_depth == 0 and fe.n_running == 0


def test_clock_drives_the_token_bucket():
    """Admissions of a rate-limited class are spaced by the injected
    clock, as in the JAX package."""
    qos = {"classes": {"bg": {"rate_per_s": 0.5, "burst": 1}}}
    ops = [("submit", i, {"tenant": "bg"}) for i in range(4)]
    ops += [("drain", 1.0)]
    got = assert_drives_equal("cuda", ops, lengths=(1, 1, 1, 1),
                              n_slots=4, chunk=1, capacity=4, qos=qos)
    admitted = [r[0]["admitted"] for r in got["rounds"]
                if isinstance(r[0], dict)]
    assert sum(admitted) == 4 and max(admitted) == 1
