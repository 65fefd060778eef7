"""The port's observability layer (``repro_torch.obs``) and the metrics /
tracer hooks of its server, connector and session, against the JAX
package's.

The catalogue of metrics must be the JAX package's (so
``docs/observability.md`` documents both); the same ops on a registry,
tracer, SLO watchdog or flight recorder must export the same text; and
an instrumented port server must count exactly what the JAX server
counts, and what ``events.trace`` measures offline on the served rasters.
"""

import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_frontend import (BACKENDS, Clock, Pkg,  # noqa: E402
                                 _session_nets, rasters, weights)

import repro.obs as jobs  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro.core.energy import counts_from_registry as j_counts  # noqa: E402
from repro.core.session import AcceleratorSession as JSession  # noqa: E402
from repro.distributed import straggler as jstrag  # noqa: E402
from repro.serving import connector as jconn  # noqa: E402
from repro_torch.core.energy import counts_from_registry as t_counts  # noqa: E402
from repro_torch.core.session import AcceleratorSession as TSession  # noqa: E402
from repro_torch.distributed import straggler as tstrag  # noqa: E402
from repro_torch.events import trace as ttrace  # noqa: E402
from repro_torch.serving import connector as tconn  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent


# --------------------------------------------------------------------------
# the catalogue and the plain instruments
# --------------------------------------------------------------------------

def test_metric_specs_equal_the_jax_catalogue():
    assert list(tobs.METRIC_SPECS) == list(jobs.METRIC_SPECS)
    for name, spec in jobs.METRIC_SPECS.items():
        got = tobs.METRIC_SPECS[name]
        assert (got.name, got.kind, tuple(got.labels), got.help) == (
            spec.name, spec.kind, tuple(spec.labels), spec.help), name
        assert tuple(getattr(got, "buckets", ()) or ()) == tuple(
            getattr(spec, "buckets", ()) or ()), name
    from repro.obs.tracing import SPAN_KINDS as J_KINDS
    from repro_torch.obs.tracing import SPAN_KINDS as T_KINDS

    assert T_KINDS == J_KINDS


def test_observability_doc_documents_the_port_catalogue():
    sys.path.insert(0, str(REPO / "scripts"))
    import check_docs

    doc = (REPO / "docs" / "observability.md").read_text()
    assert check_docs.check_metrics(doc, set(tobs.METRIC_SPECS)) == []


def _registry_ops(obs):
    clock = Clock()
    reg = obs.MetricsRegistry(clock=clock)
    reg.counter("snn_server_chunks_total").inc(3)
    reg.counter("snn_frontend_requests_total").labels(outcome="done").inc(2)
    reg.counter("snn_frontend_requests_total").labels(
        outcome='we"ird\\va\nl').inc()
    reg.gauge("snn_frontend_queue_depth").set(5)
    reg.gauge("snn_frontend_queue_depth").dec(2)
    h = reg.histogram("snn_server_chunk_latency_seconds")
    for v in (0.0, 1e-4, 0.001, 0.0025, 0.3, 7.0, 1e3):
        h.observe(v)
    with reg.timer("snn_connector_op_seconds", op="migrate"):
        clock.t += 0.004
    errs = []
    for call in (lambda: reg.counter("snn_server_chunks_total").inc(-1),
                 lambda: reg.gauge("snn_server_chunks_total"),
                 lambda: reg.counter("snn_nope_total"),
                 lambda: reg.counter("snn_frontend_requests_total").labels(
                     color="red")):
        try:
            call()
        except Exception as e:  # noqa: BLE001 - compared across packages
            errs.append((type(e).__name__, str(e)))
    return reg.to_prometheus(), reg.snapshot(), errs, reg.names


def test_registry_ops_export_as_in_jax():
    got, want = _registry_ops(tobs), _registry_ops(jobs)
    assert got == want
    assert len(got[2]) == 4


def test_tracer_records_and_exports_as_in_jax(tmp_path):
    out = []
    for obs in (jobs, tobs):
        clock = Clock()
        tr = obs.SpanTracer(clock=clock)
        tr.event("queued", 0, steps=4)
        with tr.span("deploy", None, models=1) as attrs:
            clock.t += 0.5
            attrs["parked_streams"] = 2
        tr.event("retired", "s", outcome="done")
        with pytest.raises(ValueError) as e:
            tr.event("teleported", 0)
        path = tmp_path / f"{obs.__name__}.jsonl"
        assert tr.export_jsonl(str(path)) == 3
        out.append((path.read_text(), str(e.value),
                    [s.to_dict() for s in tr.spans_for("s")]))
    assert out[1] == out[0]


def test_annotated_spans_and_profile_trace_use_torch_profiler(tmp_path):
    from repro_torch.obs.tracing import profile_trace

    tr = tobs.SpanTracer(annotate=True)
    with profile_trace(str(tmp_path / "prof")):
        with tr.span("deploy", "m"):
            torch.ones(8).sum()
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert "deploy:m" in names
    with profile_trace(None):    # no directory: no capture, no file
        pass


def _slo_and_flight(obs, tmp_path):
    clock = Clock()
    reg = obs.MetricsRegistry(clock=clock)
    rec = obs.FlightRecorder(capacity=4, clock=clock,
                             path=str(tmp_path / f"{obs.__name__}.json"))
    tr = obs.SpanTracer(clock=clock, sink=rec)
    slo = obs.SLOWatchdog(
        [obs.SLObjective("latency_p99", "latency_p99", 0.05, window_s=5.0),
         obs.SLObjective("miss_ratio", "miss_ratio", 0.2, window_s=5.0),
         obs.SLObjective("queue_depth", "queue_depth", 3.0, window_s=5.0)],
        clock=clock, registry=reg, on_breach=(rec.on_breach,))
    statuses = []
    for i in range(12):
        clock.t += 0.7
        slo.record_done(0.01 * (i % 5))
        if i % 4 == 3:
            slo.record_miss()
        slo.record_queue_depth(i % 6)
        tr.event("queued", i)
        reg.counter("snn_server_chunks_total").inc()
        rec.note_metrics(reg)
        statuses.append([s.to_dict() for s in slo.check()])
    return (statuses, slo.report(), reg.to_prometheus(), rec.spans,
            rec.deltas, rec.n_dumps, json.loads(
                (tmp_path / f"{obs.__name__}.json").read_text()))


def test_slo_watchdog_and_flight_recorder_match_jax(tmp_path):
    got = _slo_and_flight(tobs, tmp_path)
    want = _slo_and_flight(jobs, tmp_path)
    assert got == want
    assert got[5] > 0        # a breach dumped the ring


def test_observe_from_registry_matches_jax():
    rng = np.random.default_rng(0)
    times = 1.0 + 0.01 * rng.standard_normal((40, 4))
    times[20:, 2] *= 3.0
    outs = []
    for obs, mod in ((jobs, jstrag), (tobs, tstrag)):
        reg = obs.MetricsRegistry()
        tr = obs.SpanTracer(clock=Clock())
        det = mod.StragglerDetector(num_hosts=4, warmup_steps=5, patience=3)
        flags = []
        for t in times:
            for shard, dt in enumerate(t):
                reg.gauge("snn_shard_step_seconds").labels(
                    shard=shard).set(float(dt))
            flags.append(mod.observe_from_registry(det, reg,
                                                   tracer=tr).tolist())
        outs.append((flags, reg.to_prometheus(), tr.to_dicts(),
                     obs.mesh_lanes(tr),
                     obs.verify_shard_lanes(tr, mod.StragglerDetector(
                         num_hosts=4, warmup_steps=5, patience=3))))
    assert outs[1] == outs[0]
    assert any(any(f) for f in outs[1][0])


# --------------------------------------------------------------------------
# the instrumented server: JAX's counters, and the offline measurement
# --------------------------------------------------------------------------

def _served(pkg, W, chunks, *, n_slots, chunk, plan):
    clock = Clock()
    reg = pkg.obs.MetricsRegistry(clock=clock)
    tr = pkg.obs.SpanTracer(clock=clock)
    server = pkg.server(pkg.engine(W), n_slots=n_slots, chunk_steps=chunk,
                        metrics=reg, tracer=tr)
    uids = [server.attach(f"s{i}") for i in range(len(chunks))]
    outs = {u: [] for u in uids}
    for lo, hi, who in plan:
        res = server.feed({uids[i]: chunks[i][lo:hi] for i in who})
        for u, r in res.items():
            outs[u].append(np.asarray(r["spikes"]))
    for u in uids:
        server.detach(u, reason="done")
    return reg, tr, {u: np.concatenate(o) for u, o in outs.items()}


PLANS = {
    "full": (3, 4, [(0, 8, (0, 1, 2)), (8, 16, (0, 1, 2))]),
    "ragged": (4, 3, [(0, 5, (0,)), (0, 7, (1, 2)), (5, 11, (0, 2)),
                      (7, 9, (1,)), (11, 16, (0, 1, 2))]),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_server_counters_equal_jax_and_the_offline_trace(backend, plan):
    n_slots, chunk, steps = PLANS[plan]
    W = weights(30)
    chunks = rasters(31, (16, 16, 16))
    jreg, jtr, jout = _served(Pkg(False), W, chunks, n_slots=n_slots,
                              chunk=chunk, plan=steps)
    treg, ttr, tout = _served(Pkg(True, backend), W, chunks,
                              n_slots=n_slots, chunk=chunk, plan=steps)
    assert treg.to_prometheus() == jreg.to_prometheus()
    assert ttr.to_dicts() == jtr.to_dicts()
    assert tobs.reconstruct(ttr).to_dict() == jobs.reconstruct(
        jtr).to_dict()
    for u in tout:
        assert np.array_equal(tout[u], jout[u])
    if plan == "full":
        # every stream ran every step: the streams are batch lanes
        engine = Pkg(True, backend).engine(W)
        ext = np.stack(chunks, axis=1)
        out = np.stack([tout[u] for u in sorted(tout)], axis=1)
        rep = ttrace.trace_run(engine, ext, out)
        c = treg.counter
        assert c("snn_server_sops_total").value == rep.measured_sops
        ev = c("snn_server_source_events_total")
        assert (ev.labels(kind="external").value
                + ev.labels(kind="recurrent").value) == rep.source_events
        fetched, total = rep.blocks["per-example"]
        assert c("snn_server_weight_blocks_fetched_total").value == fetched
        assert c("snn_server_weight_blocks_dense_total").value == total


@pytest.mark.parametrize("backend", BACKENDS)
def test_closed_loop_counters_equal_jax(backend):
    W = weights(32)
    regs = []
    for pkg in (Pkg(False), Pkg(True, backend)):
        reg = pkg.obs.MetricsRegistry(clock=Clock())
        server = pkg.server(pkg.engine(W), n_slots=2, chunk_steps=4,
                            metrics=reg)
        uid = server.attach()
        server.feed({uid: rasters(33, (5,))[0]})
        server.run_closed_loop(
            uid, lambda s: (np.roll(s[:10], 1) + 1) % 2, 9,
            np.ones(10, np.int32))
        regs.append(reg.to_prometheus())
    assert regs[1] == regs[0]


def _session_flow(port, backend, nets, tmp_path):
    """A served session through deploy, traffic, a migration, a rolling
    redeploy and a checkpoint, fully instrumented."""
    pkg = Pkg(port, backend)
    clock = Clock()
    reg = pkg.obs.MetricsRegistry(clock=clock)
    tr = pkg.obs.SpanTracer(clock=clock)
    kw = dict(metrics=reg, tracer=tr)
    s = (TSession(backend=backend, device="cpu", **kw) if port
         else JSession(**kw))
    (jA, tA), (jB, tB) = nets
    s.deploy("A", tA if port else jA)
    v = s.serve("A", n_slots=3, chunk_steps=4)
    rng = np.random.default_rng(34)
    ext = {u: (rng.random((14, 6)) < 0.4).astype(np.int32)
           for u in ("p", "q")}
    served = {u: [] for u in ext}
    for u in ext:
        v.attach(u)
    for lo, hi in ((0, 5), (5, 9)):
        for u, r in v.feed_many({u: x[lo:hi]
                                 for u, x in ext.items()}).items():
            served[u].append(r["spikes"])
    conn = pkg.conn
    conn.migrate_stream(v.server, "p", slot=2)
    s.deploy("B", tB if port else jB)
    v = s.serve("A", n_slots=3, chunk_steps=4)
    for u, r in v.feed_many({u: x[9:] for u, x in ext.items()}).items():
        served[u].append(r["spikes"])
    v.server.checkpoint_streams(
        conn.FileCarryConnector(str(tmp_path / ("t" if port else "j")))
        .instrument(reg, tr))
    for u in ext:
        v.detach(u, reason="done")
    return s, reg, tr, ext, {u: np.concatenate(o) for u, o in
                             served.items()}


@pytest.mark.parametrize("backend", BACKENDS)
def test_session_flow_counters_spans_and_energy_equal_jax(backend,
                                                          tmp_path):
    nets = _session_nets(35)
    js, jreg, jtr, _, jout = _session_flow(False, backend, nets, tmp_path)
    ts, treg, ttr, ext, tout = _session_flow(True, backend, nets, tmp_path)
    assert treg.to_prometheus() == jreg.to_prometheus()
    assert ttr.to_dicts() == jtr.to_dicts()
    report = tobs.reconstruct(ttr)           # raises on any violation
    assert report.to_dict() == jobs.reconstruct(jtr).to_dict()
    assert treg.counter("snn_session_redeploys_total").value == 1
    ops = treg.counter("snn_connector_ops_total")
    assert ops.labels(op="migrate").value == 1
    assert ops.labels(op="snapshot").value == 4   # 2 parked + 2 checkpoint
    assert dataclasses.astuple(t_counts(treg)) == dataclasses.astuple(
        j_counts(jreg))
    # the server counts what events.trace measures on the served rasters
    prog = ts.models["A"].program
    want = ttrace.measured_counts(
        prog, np.stack([ext[u] for u in ("p", "q")], axis=1),
        np.stack([tout[u] for u in ("p", "q")], axis=1))
    got = t_counts(treg)
    assert (got.sops, got.row_fetches) == (want.sops, want.row_fetches)
    for u in tout:
        assert np.array_equal(tout[u], np.asarray(jout[u]))


def test_instrumented_connector_counts_as_in_jax(tmp_path):
    W = weights(36)
    outs = []
    for pkg, mod in ((Pkg(False), jconn), (Pkg(True, "cuda"), tconn)):
        clock = Clock()
        reg = pkg.obs.MetricsRegistry(clock=clock)
        tr = pkg.obs.SpanTracer(clock=clock)
        server = pkg.server(pkg.engine(W), n_slots=2, chunk_steps=4)
        uid = server.attach("x")
        server.feed({uid: rasters(37, (6,))[0]})
        for conn in (mod.InMemoryCarryConnector(),
                     mod.FileCarryConnector(str(tmp_path / str(len(outs))))):
            conn.instrument(reg, tr)
            server.detach_stream(uid, conn)
            clock.t += 1.0
            server.attach_stream(conn, uid)
        outs.append((reg.to_prometheus(), tr.to_dicts()))
    assert outs[1] == outs[0]
