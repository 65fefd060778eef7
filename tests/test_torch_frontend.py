"""The port's async front door (``repro_torch.serving.frontend``) against
the JAX package's.

One scripted op sequence (submits with deadlines and tenants, cancels,
pumps on an injected virtual clock, resumes) drives a frontend of each
package over the same numpy weights and rasters on the CPU. The two must
give the same admission order and slot assignment per round, the same
request states and output bytes, the same ``metrics()``, the same
Prometheus text and JSON snapshot of their registries, and the same
reconstructed lifecycle timeline. The port runs on its "reference" and
"cuda" backends (the kernels' plain versions here), the JAX package on
"reference". :func:`drive` is shared with ``test_torch_qos.py``.
"""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.obs as jobs  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core.lif import LIFParams as JLIF  # noqa: E402
from repro.core.network import SNNetwork as JNet  # noqa: E402
from repro.core.session import AcceleratorSession as JSession  # noqa: E402
from repro.events import aer as jaer  # noqa: E402
from repro.serving import connector as jconn  # noqa: E402
from repro.serving import frontend as jfront  # noqa: E402
from repro.serving import qos as jqos  # noqa: E402
from repro.serving.snn import SpikeServer as JServer  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.lif import LIFParams as TLIF  # noqa: E402
from repro_torch.core.network import SNNetwork as TNet  # noqa: E402
from repro_torch.core.session import AcceleratorSession as TSession  # noqa: E402
from repro_torch.events import aer as taer  # noqa: E402
from repro_torch.serving import connector as tconn  # noqa: E402
from repro_torch.serving import frontend as tfront  # noqa: E402
from repro_torch.serving import qos as tqos  # noqa: E402
from repro_torch.serving.snn import SpikeServer as TServer  # noqa: E402

THRESH = 1 << 16
N_IN, P = 10, 16
BACKENDS = ("reference", "cuda")


class Clock:
    """Deterministic clock: advances only when told to."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


class Pkg:
    """One package's classes, so one op runner drives both."""

    def __init__(self, port: bool, backend: str = "reference"):
        self.port = port
        self.backend = backend
        self.obs = tobs if port else jobs
        self.conn = tconn if port else jconn
        self.front = tfront if port else jfront
        self.qos = tqos if port else jqos

    def engine(self, W, n_in=N_IN, reset="subtract", gate="batch-tile"):
        if self.port:
            return teng.SpikeEngine(
                W, n_in, decay=teng.DecaySpec.shift(0.25),
                threshold_raw=THRESH, reset_mode=reset,
                backend=self.backend, gate=gate, device="cpu")
        return jeng.SpikeEngine(
            jnp.asarray(W), n_in, decay=jeng.DecaySpec.shift(0.25),
            threshold_raw=THRESH, reset_mode=reset, gate=gate)

    def server(self, engine, **kw):
        if self.port:
            return TServer(engine, device="cpu", **kw)
        return JServer(engine, **kw)

    def policy(self, spec):
        """{"classes": {name: QoSClass kwargs}, **QoSPolicy kwargs}."""
        if spec is None:
            return None
        spec = dict(spec)
        classes = {name: self.qos.QoSClass(**kw)
                   for name, kw in spec.pop("classes").items()}
        return self.qos.QoSPolicy(classes=classes, **spec)


def weights(seed, n_in=N_IN, p=P, wmax=1 << 13):
    rng = np.random.default_rng(seed)
    return ((rng.random((n_in + p, p)) < 0.4)
            * rng.integers(-wmax, wmax, (n_in + p, p))).astype(np.int32)


def rasters(seed, lengths, n_in=N_IN, p=0.35):
    rng = np.random.default_rng(seed)
    return [(rng.random((T, n_in)) < p).astype(np.int32) for T in lengths]


def _key(uid):
    """A span's uid with a spill key's per-process namespace dropped: each
    package numbers its own frontends ("spill-N"), so the N depends on
    how many frontends the process built before this one."""
    if isinstance(uid, tuple) and str(uid[0]).startswith("spill-"):
        return ("spill",) + uid[1:]
    return uid


def drive(pkg: Pkg, ops, *, lengths, n_slots=2, chunk=3, capacity=4,
          backpressure="reject", deadline_ms=None, spill=False, qos=None,
          seed=0, max_rounds=400):
    """Run ``ops`` on a fresh instrumented frontend of ``pkg``; returns
    every observable it produced, as plain data.

    ops: ("submit", i, kwargs) | ("cancel", i) | ("pump", dt) |
    ("resume", i, deadline_ms) | ("drain", dt) — drain pumps until idle,
    advancing the clock by dt a round and giving each parked request one
    resume (a second park cancels it)."""
    clock = Clock()
    metrics = pkg.obs.MetricsRegistry(clock=clock)
    tracer = pkg.obs.SpanTracer(clock=clock)
    server = pkg.server(pkg.engine(weights(seed)), n_slots=n_slots,
                        chunk_steps=chunk, metrics=metrics, tracer=tracer)
    policy = pkg.policy(qos)
    connector = None
    if spill or (policy is not None and policy.preempt):
        connector = pkg.conn.InMemoryCarryConnector().instrument(
            metrics, tracer)
    fe = pkg.front.AsyncSpikeFrontend(
        server, queue_capacity=capacity, backpressure=backpressure,
        deadline_ms=deadline_ms, clock=clock, connector=connector,
        metrics=metrics, tracer=tracer, qos=policy)
    raw = rasters(seed + 1, lengths)
    handles, rounds, resumed = [], [], set()
    rid_of_uid = {}

    def pump():
        summary = fe.pump()
        for h in handles:
            if h._req.uid is not None:
                rid_of_uid.setdefault(h._req.uid, h.rid)
        rounds.append((summary, sorted(
            (rid_of_uid[u], s) for u, s in server.scheduler.active.items()),
            [h.state for h in handles]))

    for op in ops:
        if op[0] == "submit":
            handles.append(fe.submit(raw[op[1]], **op[2]))
        elif op[0] == "cancel":
            rounds.append(("cancel", op[1], handles[op[1]].cancel()))
        elif op[0] == "resume":
            rounds.append(("resume", op[1],
                           fe.resume(handles[op[1]], deadline_ms=op[2])))
        elif op[0] == "pump":
            clock.t += op[1]
            pump()
        elif op[0] == "drain":
            n = 0
            while not fe.idle or any(h.state == "parked" for h in handles):
                for h in handles:
                    if h.state == "parked":
                        if h.rid in resumed or not fe.resume(h):
                            h.cancel()
                        resumed.add(h.rid)
                clock.t += op[1]
                if not fe.idle:
                    pump()
                n += 1
                assert n < max_rounds, "scenario did not converge"
    results = []
    for h in handles:
        res = h.result()
        results.append(None if res is None else {
            k: (v.tobytes() if isinstance(v, np.ndarray) else v)
            for k, v in res.items() if k != "events"})
    return {
        "rounds": rounds,
        "states": [h.state for h in handles],
        "polls": [h.poll() for h in handles],
        "timing": [h.timing() for h in handles],
        "results": results,
        "metrics": fe.metrics(),
        "prometheus": metrics.to_prometheus(),
        "snapshot": metrics.snapshot(),
        "timeline": pkg.obs.reconstruct(tracer).to_dict(),
        "spans": [(s.kind, _key(s.uid), s.t0, s.t1) for s in tracer.spans],
        "steps": server.total_steps,
    }


def assert_drives_equal(backend, ops, **kw):
    want = drive(Pkg(False), ops, **kw)
    got = drive(Pkg(True, backend), ops, **kw)
    for key in want:
        assert got[key] == want[key], key
    return got


def one_shot(raster, seed=0, reset="subtract"):
    je = Pkg(False).engine(weights(seed), reset=reset)
    return np.asarray(je.run(raster[:, None, :])["spikes"])[:, 0]


# --------------------------------------------------------------------------
# scripted op sequences: both packages give the same observables
# --------------------------------------------------------------------------

def _submits(n, **kw):
    return [("submit", i, dict(kw)) for i in range(n)]


SCENARIOS = {
    "fifo-reject": dict(
        ops=_submits(7) + [("cancel", 1), ("pump", 1.0), ("cancel", 0),
                           ("drain", 1.0)],
        lengths=(7, 4, 1, 9, 5, 3, 6), capacity=4),
    "fifo-drop-oldest": dict(
        ops=_submits(4) + [("pump", 1.0)] + [
            ("submit", i, {}) for i in range(4, 8)] + [("drain", 1.0)],
        lengths=(5, 3, 7, 2, 6, 4, 8, 1), capacity=3,
        backpressure="drop-oldest"),
    "fifo-block": dict(
        ops=_submits(6) + [("drain", 0.5)], lengths=(4, 6, 2, 5, 3, 7),
        capacity=2, backpressure="block"),
    "deadlines-expire": dict(
        ops=[("submit", i, {"deadline_ms": 2500.0 if i % 2 else None})
             for i in range(6)] + [("drain", 1.0)],
        lengths=(9, 8, 7, 3, 6, 5), capacity=6),
    "spill-resume": dict(
        ops=[("submit", i, {"deadline_ms": 2000.0 if i < 2 else None})
             for i in range(5)] + [
            ("pump", 1.1), ("pump", 1.1), ("pump", 1.1), ("resume", 0, 4000.0),
            ("resume", 1, None), ("cancel", 3), ("drain", 1.1)],
        lengths=(9, 7, 8, 3, 6), n_slots=2, chunk=2, capacity=6,
        spill=True),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scripted_frontend_matches_jax(name, backend):
    got = assert_drives_equal(backend, **SCENARIOS[name])
    assert got["metrics"]["counts"]["submitted"] == len(
        [o for o in SCENARIOS[name]["ops"] if o[0] == "submit"])
    if name == "spill-resume":
        assert got["metrics"]["counts"]["parked"] > 0
        assert got["metrics"]["counts"]["resumed"] > 0


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("reset", ["zero", "subtract", "hold"])
def test_async_results_equal_one_shot_runs(backend, reset):
    lengths = (7, 4, 1, 9, 5)
    pkg = Pkg(True, backend)
    engine = pkg.engine(weights(3), reset=reset)
    server = pkg.server(engine, n_slots=2, chunk_steps=3)
    fe = tfront.AsyncSpikeFrontend(server, queue_capacity=len(lengths))
    raw = rasters(4, lengths)
    handles = [fe.submit(r) for r in raw]
    assert fe.drain()["counts"]["done"] == len(raw)
    for h, r in zip(handles, raw):
        got = h.result()["spikes"]
        assert got.dtype == np.int32 and "partial" not in h.result()
        assert np.array_equal(got, one_shot(r, seed=3, reset=reset))


def test_spilled_streams_finish_byte_identical():
    got = drive(Pkg(True, "cuda"), **SCENARIOS["spill-resume"])
    raw = rasters(1, SCENARIOS["spill-resume"]["lengths"])
    for i, (state, res) in enumerate(zip(got["states"], got["results"])):
        if state == "done":
            assert res["spikes"] == one_shot(raw[i]).tobytes()
    assert got["states"].count("done") >= 3


# --------------------------------------------------------------------------
# AER requests, session wiring, validation
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_submit_events_matches_jax(backend):
    raster = rasters(5, (6,))[0]
    outs = []
    for pkg, aer in ((Pkg(False), jaer), (Pkg(True, backend), taer)):
        server = pkg.server(pkg.engine(weights(6)), n_slots=2,
                            chunk_steps=3)
        fe = pkg.front.AsyncSpikeFrontend(server)
        stream = aer.dense_to_aer(raster[:, None, :],
                                  capacity=int(raster.sum()))
        h = fe.submit_events(stream, events_capacity=256)
        fe.drain()
        res = h.result()
        outs.append((np.asarray(res["spikes"]),
                     np.asarray(aer.aer_to_dense(res["events"]))[:, 0]))
    assert np.array_equal(outs[1][0], outs[0][0])
    assert np.array_equal(outs[1][1], outs[0][1])
    assert np.array_equal(outs[1][0], one_shot(raster, seed=6))


def _session_nets(seed):
    rng = np.random.default_rng(seed)
    out = []
    for n_in, n in ((6, 12), (5, 10)):
        W = ((rng.random((n_in + n, n)) < 0.4)
             * rng.normal(0.0, 0.5, (n_in + n, n))).astype(np.float32)
        out.append([cls(n_inputs=n_in, n_neurons=n, weights=W,
                        params=lif(decay_rate=0.25, threshold=1.0,
                                   reset_mode="zero"),
                        output_slice=(n - 4, n))
                    for cls, lif in ((JNet, JLIF), (TNet, TLIF))])
    return out


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("K", [1, 4])
def test_session_serve_frontend_matches_jax(backend, K):
    nets = _session_nets(7)
    clocks = (Clock(), Clock())
    sessions = []
    for port, clock in zip((False, True), clocks):
        pkg = Pkg(port, backend)
        if port:
            s = TSession(backend=backend, fuse_steps=K, device="cpu",
                         metrics=pkg.obs.MetricsRegistry(clock=clock),
                         tracer=pkg.obs.SpanTracer(clock=clock))
        else:
            s = JSession(metrics=pkg.obs.MetricsRegistry(clock=clock),
                         tracer=pkg.obs.SpanTracer(clock=clock))
        for name, pair in zip("ab", nets):
            s.deploy(name, pair[int(port)])
        sessions.append((pkg, s))
    rng = np.random.default_rng(8)
    plan = [("a" if i % 3 else "b", T)
            for i, T in enumerate((8, 7, 3, 5, 6, 2, 4))]
    plan = [(v, (rng.random((T, 6 if v == "a" else 5)) < 0.4).astype(
        np.int32)) for v, T in plan]
    outs = []
    for (pkg, s), clock in zip(sessions, clocks):
        cfg = pkg.front.FrontendConfig(queue_capacity=8, spill=True)
        views = {v: s.serve(v, n_slots=2, chunk_steps=3, frontend=cfg)
                 for v in "ab"}
        fe = views["a"].frontend
        assert fe is views["b"].frontend is not None
        fe.clock = clock      # the session builds it on the wall clock
        assert s.serve("a", n_slots=2, chunk_steps=3).frontend is fe
        with pytest.raises(ValueError, match="one request queue"):
            s.serve("a", n_slots=2, chunk_steps=3,
                    frontend=pkg.front.FrontendConfig(queue_capacity=9))
        # the first two park mid-stream at their deadline and resume
        hs = [views[v].submit(x, deadline_ms=1500.0 if i < 2 else None)
              for i, (v, x) in enumerate(plan)]
        while not fe.idle or any(h.state == "parked" for h in hs):
            for h in hs:
                if h.state == "parked":
                    fe.resume(h)
            clock.t += 1.0
            fe.pump()
        outs.append(([h.state for h in hs],
                     [None if h.result() is None else
                      (h.result()["spikes"].tobytes(),
                       h.result()["output_counts"].tolist(),
                       h.result()["predictions"]) for h in hs],
                     fe.metrics(), s.metrics.to_prometheus(),
                     jobs.reconstruct(s.tracer).to_dict() if not pkg.port
                     else tobs.reconstruct(s.tracer).to_dict()))
    for a, b in zip(*outs):
        assert b == a
    assert outs[1][0].count("done") == len(plan)
    assert outs[1][2]["counts"]["parked"] > 0


def test_model_stream_submit_requires_frontend():
    (_, net), _ = _session_nets(9)
    s = TSession(device="cpu")
    s.deploy("m", net)
    view = s.serve("m")
    with pytest.raises(RuntimeError, match="no async frontend"):
        view.submit(np.zeros((3, view.n_inputs), np.int32))
    with pytest.raises(RuntimeError, match="no async frontend"):
        view.submit_events(taer.dense_to_aer(
            np.zeros((3, 1, view.n_inputs), np.int32), 4))


@pytest.mark.parametrize("kwargs", [
    dict(queue_capacity=0), dict(backpressure="shed"),
    dict(deadline_ms=0.0), dict(qos="fifo"),
    dict(qos={"classes": {"a": {}}, "preempt": True})])
def test_constructor_validation_matches_jax(kwargs):
    errs = []
    for pkg in (Pkg(False), Pkg(True)):
        kw = dict(kwargs)
        if isinstance(kw.get("qos"), dict):
            kw["qos"] = pkg.policy(kw["qos"])
        server = pkg.server(pkg.engine(weights(10)), n_slots=1,
                            chunk_steps=2)
        with pytest.raises((ValueError, TypeError)) as e:
            pkg.front.AsyncSpikeFrontend(server, **kw)
        errs.append((type(e.value), str(e.value)))
    assert errs[1][0].__name__ == errs[0][0].__name__
    assert errs[1][1] == errs[0][1]


@pytest.mark.parametrize("xs", [[], [0.5], [1.0, 2.0, 3.0],
                                list(np.linspace(0, 1, 101))])
def test_latency_percentiles_match_jax(xs):
    assert tfront.latency_percentiles(xs) == jfront.latency_percentiles(xs)


def test_metrics_shape_on_empty_and_rejected_runs():
    got = drive(Pkg(True), [], lengths=())
    want = drive(Pkg(False), [], lengths=())
    assert got["metrics"] == want["metrics"]
    assert got["metrics"]["counts"] == {k: 0 for k in tfront.OUTCOME_KEYS}
    assert tfront.OUTCOME_KEYS == jfront.OUTCOME_KEYS
    assert tfront.BACKPRESSURE == jfront.BACKPRESSURE
    assert_drives_equal("cuda", _submits(3) + [("drain", 1.0)],
                        lengths=(2, 2, 2), capacity=1)


# --------------------------------------------------------------------------
# the pump thread
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_pump_thread_serves_byte_identical(backend):
    pkg = Pkg(True, backend)
    server = pkg.server(pkg.engine(weights(11)), n_slots=2, chunk_steps=3)
    fe = tfront.AsyncSpikeFrontend(server, queue_capacity=16)
    raw = rasters(12, (5, 8, 3, 6, 2, 7))
    fe.start(poll_interval_s=0.0005)
    handles = [fe.submit(r) for r in raw]
    fe.stop(drain=True)
    assert fe._pump_thread is None and fe.idle
    for h, r in zip(handles, raw):
        assert h.state == "done"
        assert np.array_equal(h.result()["spikes"], one_shot(r, seed=11))
    with pytest.raises(RuntimeError, match="already running"):
        fe.start()
        fe.start()
    fe.stop()
    fe.stop()           # no thread: a no-op


def test_pump_thread_failure_surfaces_in_stop():
    """A round that raises on the pump thread (a kernel that fails to
    build or launch there) must come back to the caller of stop()."""
    pkg = Pkg(True, "cuda")
    server = pkg.server(pkg.engine(weights(13)), n_slots=2, chunk_steps=3)

    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    server.engine.step_chunk = broken
    fe = tfront.AsyncSpikeFrontend(server, queue_capacity=4)
    fe.start(poll_interval_s=0.0005)
    fe.submit(rasters(14, (4,))[0])
    with pytest.raises(RuntimeError, match="pump thread failed") as e:
        fe.stop(drain=True, timeout_s=10.0)
    assert "kernel launch failed" in str(e.value.__cause__)
    assert fe._pump_thread is None
    fe.stop()           # the error was reported once


def test_threaded_submitters_lose_no_request():
    pkg = Pkg(True, "cuda")
    registry = tobs.MetricsRegistry()
    server = pkg.server(pkg.engine(weights(15)), n_slots=2, chunk_steps=2)
    fe = tfront.AsyncSpikeFrontend(server, queue_capacity=64,
                                   metrics=registry)
    n_threads, per_thread = 4, 5
    out = [[] for _ in range(n_threads)]
    barrier = threading.Barrier(n_threads)

    def submitter(tid):
        r = np.random.default_rng(100 + tid)
        barrier.wait()
        for _ in range(per_thread):
            out[tid].append(fe.submit(
                (r.random((3, N_IN)) < 0.3).astype(np.int32),
                tenant=f"t{tid}"))

    fe.start(poll_interval_s=0.0005)
    threads = [threading.Thread(target=submitter, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    fe.stop(drain=True)
    handles = [h for per in out for h in per]
    assert len({h.rid for h in handles}) == n_threads * per_thread
    assert all(h.state == "done" for h in handles)
    assert fe.metrics()["counts"]["done"] == n_threads * per_thread
    assert registry.snapshot()["snn_frontend_queue_depth"]["samples"][0][
        "value"] == 0
