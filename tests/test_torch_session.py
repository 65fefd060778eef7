"""The serving slice as a whole: the port's compile step, session and
streaming server against the JAX package's, on identical numpy state.

Networks are built once from seeded numpy weights and carried into the
port with :mod:`repro_torch.convert`; both packages are fed the same numpy
chunks, or the same seed, which the port's threefry
(:mod:`repro_torch.core.prng`) turns into the JAX package's spikes.
"""

import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_lm_train import one_torch_thread  # noqa: E402,F401

from repro.configs import snap_v_snn as jcfg  # noqa: E402
from repro.core import cerebra_h as jch  # noqa: E402
from repro.core.cerebra_h import CerebraHConfig as JConfig  # noqa: E402
from repro.core.lif import LIFParams as JLIF  # noqa: E402
from repro.core.mapping import ClusterGeometry as JGeom  # noqa: E402
from repro.core.network import feedforward as jfeedforward  # noqa: E402
from repro.core.session import AcceleratorSession as JSession  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import snap_v_snn as tcfg  # noqa: E402
from repro_torch.core import cerebra_h as tch  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.engine import BACKEND_TABLE  # noqa: E402
from repro_torch.core.session import AcceleratorSession as TSession  # noqa: E402
from repro_torch.launch import serve_snn as tserve  # noqa: E402

SMALL = dict(n_clusters=8, neurons_per_cluster=32, clusters_per_group=4,
             rows_per_group=2048, clusters_per_l1=4)  # P = 256


def _jax_net(seed, sizes, decay_rate=0.25, scale=0.6):
    rng = np.random.default_rng(seed)
    ws = [rng.normal(0.0, scale / np.sqrt(a), (a, b)).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    return jfeedforward(ws, JLIF(decay_rate=decay_rate))


def _to_port(jnet):
    p = jnet.params
    return convert.network(
        n_inputs=jnet.n_inputs, n_neurons=jnet.n_neurons,
        weights=np.asarray(jnet.weights),
        params=convert.lif_params(decay_rate=p.decay_rate,
                                  threshold=p.threshold,
                                  reset_mode=p.reset_mode,
                                  int_bits=p.fmt.int_bits,
                                  frac_bits=p.fmt.frac_bits),
        layer_slices=jnet.layer_slices, output_slice=jnet.output_slice)


def _configs(geom):
    return (JConfig(geometry=JGeom(**geom)),
            tch.CerebraHConfig(geometry=convert.geometry(**geom)))


def _sessions(nets, geom, backend):
    """The JAX session on the twin backend and the port's on ``backend``."""
    jcfg_, tcfg_ = _configs(geom)
    js = JSession(jcfg_, backend=BACKEND_TABLE[backend][0])
    ts = TSession(tcfg_, backend=backend, device="cpu")
    for name, jnet in nets.items():
        js.deploy(name, jnet)
        ts.deploy(name, _to_port(jnet))
    return js, ts


def _two_models():
    return {"A": _jax_net(1, (30, 50, 10)), "B": _jax_net(2, (20, 40, 6))}


def test_convert_then_compile_is_byte_equal():
    jnet = _jax_net(3, (40, 70, 10))
    jcfg_, tcfg_ = _configs(SMALL)
    jp = jch.compile_network(jnet, jcfg_)
    tp = tch.compile_network(_to_port(jnet), tcfg_)
    assert tp.weights_raw.dtype == torch.int32
    assert np.array_equal(np.asarray(jp.weights_raw), tp.weights_raw.numpy())
    assert np.array_equal(jp.row_exists, tp.row_exists)
    assert np.array_equal(jp.fanout, tp.fanout)
    assert np.array_equal(jp.output_map, tp.output_map)
    assert jp.decay_rate == tp.decay_rate
    assert np.array_equal(jp.capacity_report["rows_per_group"],
                          tp.capacity_report["rows_per_group"])
    # a program carried across from the JAX arrays runs identically
    cp = convert.program(
        net=_to_port(jnet), weights_raw=np.asarray(jp.weights_raw),
        row_exists=jp.row_exists, fanout=jp.fanout,
        output_map=jp.output_map,
        neuron_to_physical=jp.placement.neuron_to_physical, config=tcfg_)
    ext = (np.random.default_rng(4).random((12, 3, 40)) < 0.3).astype(
        np.int32)
    jo = jch.run(jp, ext)
    for prog in (tp, cp):
        to = tch.run(prog, ext, device="cpu")
        for k in ("spikes", "output_counts", "cycles", "sops",
                  "row_fetches"):
            assert np.array_equal(np.asarray(jo[k]), to[k].numpy()), k


def _placers():
    """(name, JAX placer, port placer) for the three placements."""
    from repro.core import mapping as jmap
    from repro_torch.core import mapping as tmap

    return [("contiguous", jmap.place_contiguous, tmap.place_contiguous),
            ("greedy", jmap.place_greedy, tmap.place_greedy),
            ("random 0", lambda n, g: jmap.place_random(n, g, 0),
             lambda n, g: tmap.place_random(n, g, 0)),
            ("random 7", lambda n, g: jmap.place_random(n, g, 7),
             lambda n, g: tmap.place_random(n, g, 7))]


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_placements_match_jax(seed):
    """``tests/test_mapping.py:54-99`` in both packages: the same slots
    byte for byte from each placer, on random recurrent nets and a
    layered one; row usage and the communication profile equal; the
    oversized net refused alike."""
    from repro.core import mapping as jmap
    from repro_torch.core import mapping as tmap

    from conftest import make_random_net

    rng = np.random.default_rng(seed)
    nets = [make_random_net(rng, n_in=10, n_neurons=40, density=0.3),
            make_random_net(rng, n_in=8, n_neurons=256, density=0.15),
            _jax_net(seed, (30, 50, 20, 10))]
    jg, tg = JGeom(), tch.CerebraHConfig().geometry
    for jnet in nets:
        tnet = _to_port(jnet)
        for name, jplace, tplace in _placers():
            jp, tp = jplace(jnet, jg), tplace(tnet, tg)
            assert tp.neuron_to_physical.dtype == np.int64, name
            assert np.array_equal(jp.neuron_to_physical,
                                  tp.neuron_to_physical), name
            for mode in ("strict", "external_broadcast"):
                assert np.array_equal(jmap.row_usage(jnet, jp, mode),
                                      tmap.row_usage(tnet, tp, mode)), name
            jc = jmap.communication_profile(jnet, jp)
            tc = tmap.communication_profile(tnet, tp)
            for k in ("local_edges", "l1_edges", "l2_edges"):
                assert jc[k] == tc[k], (name, k)
    big = _to_port(make_random_net(rng, n_in=4, n_neurons=2000))
    for _, _, tplace in _placers():
        with pytest.raises(ValueError, match="physical"):
            tplace(big, tg)


@pytest.mark.parametrize("placer", ["greedy", "random 0", "random 7"])
def test_compile_with_placement_serves_like_jax(placer):
    """``compile_network(..., placement=)`` with each placer: the SRAM
    image, output map and the served rasters, counts, cycles and SOPs
    byte-equal to JAX's."""
    jnet = _jax_net(5, (40, 70, 10))
    tnet = _to_port(jnet)
    jcfg_, tcfg_ = _configs(SMALL)
    (_, jplace, tplace), = [p for p in _placers() if p[0] == placer]
    jp = jch.compile_network(jnet, jcfg_,
                             placement=jplace(jnet, jcfg_.geometry))
    tp = tch.compile_network(tnet, tcfg_,
                             placement=tplace(tnet, tcfg_.geometry))
    assert np.array_equal(np.asarray(jp.weights_raw), tp.weights_raw.numpy())
    assert np.array_equal(jp.output_map, tp.output_map)
    ext = (np.random.default_rng(6).random((12, 3, 40)) < 0.3).astype(
        np.int32)
    jo = jch.run(jp, ext)
    for backend in ("reference", "cuda"):
        to = tch.run(tp, ext, backend=backend, device="cpu")
        for k in ("spikes", "output_counts", "cycles", "sops",
                  "row_fetches"):
            assert np.array_equal(np.asarray(jo[k]), to[k].numpy()), (
                backend, k)


def test_cerebra_h_max_freq_matches_jax():
    assert tch.MAX_FREQ_MHZ == jch.MAX_FREQ_MHZ == 96.24


@pytest.mark.parametrize("backend", list(BACKEND_TABLE))
def test_fused_engine_run_and_cost_model_match_jax(backend):
    nets = _two_models()
    js, ts = _sessions(nets, SMALL, backend)
    jm = list(js.models.values())
    tm = list(ts.models.values())
    je, te = js._fused_engine(jm), ts._fused_engine(tm)
    assert np.array_equal(np.asarray(je.weights_raw),
                          te.weights_raw.numpy())
    ext = (np.random.default_rng(5).random((10, 3, 50)) < 0.3).astype(
        np.int32)
    jr, tr = je.run(ext)["spikes"], te.run(ext)["spikes"]
    assert np.array_equal(np.asarray(jr), tr.numpy())
    assert int(tr.sum()) > 0
    for jmod, tmod, lo in ((jm[0], tm[0], 0), (jm[1], tm[1], 30)):
        own = ext[:, :, lo:lo + jmod.program.n_inputs]
        jc = jch.cost_model(jmod.program, own, np.asarray(jr))
        tc = tch.cost_model(tmod.program, own, tr)
        for k in ("cycles", "sops", "row_fetches"):
            assert np.array_equal(np.asarray(jc[k]), tc[k].numpy()), k


def _churn(ts_views, js_views, plan):
    """Drive both packages' views through one attach / feed / detach plan
    and compare every decoded chunk."""
    n_checked = 0
    for op, name, uid, chunk in plan:
        if op == "attach":
            js_views[name].attach(uid)
            ts_views[name].attach(uid)
            assert js_views[name].slot_of(uid) == ts_views[name].slot_of(uid)
        elif op == "detach":
            js_views[name].detach(uid)
            ts_views[name].detach(uid)
        else:
            jo = js_views[name].feed_many(chunk)
            to = ts_views[name].feed_many(chunk)
            for u in chunk:
                assert np.array_equal(jo[u]["spikes"], to[u]["spikes"])
                assert np.array_equal(jo[u]["output_counts"],
                                      to[u]["output_counts"])
                assert jo[u]["predictions"] == to[u]["predictions"]
                n_checked += int(to[u]["spikes"].sum())
    return n_checked


def _plan(n_inputs: dict, seed: int):
    """Attach 6 streams over 4 slots (two wait), feed ragged chunks,
    detach mid-way so waiters are admitted into zeroed slots."""
    rng = np.random.default_rng(seed)

    def chunk(name, T):
        return (rng.random((T, n_inputs[name])) < 0.3).astype(np.int32)

    names = ["A", "B", "A", "B", "A", "B"]
    plan = [("attach", names[u], u, None) for u in range(4)]
    plan += [("feed", "A", None, {0: chunk("A", 11), 2: chunk("A", 5)}),
             ("feed", "B", None, {1: chunk("B", 8), 3: chunk("B", 3)}),
             ("attach", "A", 4, None), ("attach", "B", 5, None),
             ("detach", "A", 0, None),
             ("feed", "A", None, {4: chunk("A", 9), 2: chunk("A", 1)}),
             ("detach", "B", 1, None),
             ("feed", "B", None, {5: chunk("B", 13), 3: chunk("B", 0)}),
             ("feed", "A", None, {2: chunk("A", 7)})]
    return plan


@pytest.mark.parametrize("backend", list(BACKEND_TABLE))
@pytest.mark.parametrize("gate", ["batch-tile", "per-example"])
def test_two_models_served_with_churn_match_jax(backend, gate):
    nets = _two_models()
    js, ts = _sessions(nets, SMALL, backend)
    jv = {n: js.serve(n, n_slots=4, chunk_steps=4, gate=gate) for n in nets}
    tv = {n: ts.serve(n, n_slots=4, chunk_steps=4, gate=gate) for n in nets}
    assert tv["A"].server is tv["B"].server
    assert tv["A"].server.engine.gate == gate
    plan = _plan({"A": 30, "B": 20}, seed=6)
    assert _churn(tv, jv, plan) > 0
    for n in nets:  # carries stayed byte-equal too
        jc = jv[n].server.carry
        tc = tv[n].server.carry
        assert np.array_equal(np.asarray(jc["v"]), tc["v"].numpy())
    assert tv["A"].server.total_steps == jv["A"].server.total_steps


def test_default_geometry_slice_on_reference():
    """The slice's own configuration: two 784-256-10 MNIST nets under the
    paper's LIF on the full 32 x 32 Cerebra-H array."""
    def mnist(seed):
        rng = np.random.default_rng(seed)
        sizes = jcfg.model_config(256).layer_sizes
        assert tuple(sizes) == tcfg.layer_sizes(256)
        ws = [rng.normal(0.0, 1.0 / np.sqrt(a), (a, b)).astype(np.float32)
              for a, b in zip(sizes[:-1], sizes[1:])]
        return jfeedforward(ws, jcfg.LIF)

    nets = {"m0": mnist(7), "m1": mnist(8)}
    js = JSession(jcfg.ACCELERATOR)
    ts = TSession(tcfg.ACCELERATOR, device="cpu")
    for name, jnet in nets.items():
        js.deploy(name, jnet)
        ts.deploy(name, _to_port(jnet))
    assert ts.utilization() == js.utilization()
    assert ts.models["m1"].cluster_range == (12, 24)
    jv = {n: js.serve(n, n_slots=8, chunk_steps=8) for n in nets}
    tv = {n: ts.serve(n, n_slots=8, chunk_steps=8) for n in nets}
    assert tv["m0"].server.engine.n_sources == 2 * 784 + 1024
    rng = np.random.default_rng(9)
    plan = [("attach", "m0", 0, None), ("attach", "m1", 1, None),
            ("attach", "m0", 2, None)]
    plan += [("feed", n, None, {u: (rng.random((10, 784)) < 0.2).astype(
        np.int32)}) for n, u in (("m0", 0), ("m1", 1), ("m0", 2))]
    assert _churn(tv, jv, plan) > 0


def test_port_session_run_all_matches_solo_and_is_seeded():
    nets = _two_models()
    _, ts = _sessions(nets, SMALL, "cuda")
    xs = {"A": np.random.default_rng(1).random((3, 30)).astype(np.float32),
          "B": np.random.default_rng(2).random((3, 20)).astype(np.float32)}
    both = ts.run_all(xs, 12, seed=5)
    solo = ts.run("B", xs["B"], 12, seed=5)
    for k in ("spikes", "output_counts", "cycles", "sops", "row_fetches",
              "predictions"):
        assert torch.equal(both["B"][k], solo[k]), k
    again = ts.run("B", xs["B"], 12, seed=5)
    assert torch.equal(again["spikes"], solo["spikes"])


def test_deploy_with_live_streams_and_frontend_raise():
    """A deploy with a live stream is a rolling redeploy (the carry parks
    in the session connector and the next serve restores it), and a
    frontend whose config conflicts with the group's raises."""
    from repro_torch.serving.frontend import FrontendConfig

    nets = _two_models()
    _, ts = _sessions({"A": nets["A"]}, SMALL, "reference")
    view = ts.serve("A", n_slots=2, frontend=FrontendConfig())
    view.attach("u")
    with pytest.raises(ValueError, match="one request queue"):
        ts.serve("A", n_slots=2, frontend=FrontendConfig(queue_capacity=3))
    ts.deploy("B", _to_port(nets["B"]))
    assert len(ts.connector) == 1
    with pytest.raises(RuntimeError, match="stale"):
        view.attach("v")
    view = ts.serve("A", n_slots=2)
    assert view.slot_of("u") == 0 and len(ts.connector) == 0
    assert view.frontend is None      # the queue died with its server


def test_closed_loop_matches_jax():
    nets = _two_models()
    js, ts = _sessions(nets, SMALL, "reference")
    jv, tv = js.serve("B", n_slots=2), ts.serve("B", n_slots=2)
    jv.attach(0), tv.attach(0)

    def controller(spikes):  # next input: a fixed function of the output
        return (np.roll(spikes[:20], 3) + (spikes.sum() % 2)) % 2

    ext0 = np.ones(20, np.int32)
    jo = jv.run_closed_loop(0, controller, 9, ext0)
    to = tv.run_closed_loop(0, controller, 9, ext0)
    assert np.array_equal(jo["spikes"], to["spikes"])
    assert jo["predictions"] == to["predictions"]


def test_serve_snn_main_runs_on_cpu(capsys):
    summary = tserve.main([
        "--device", "cpu", "--backend", "cuda", "--streams", "5",
        "--steps-per-stream", "10", "--n-inputs", "12", "--n-neurons", "20",
        "--n-slots", "2", "--chunk", "4", "--gate", "per-example",
        "--fuse-steps", "3"])
    out = capsys.readouterr().out
    assert summary["streams_done"] == 5
    assert summary["steps"] == 5 * 10
    assert "steps/s" in out and "per-stream latency" in out
    assert "chunk dispatches" in out
    assert summary["fuse_steps"] == 3
    assert summary["launches"] == {"spike_timestep": 0,
                                   "spike_timestep_fused": 0,
                                   "lif_step": 0,
                                   "poisson_encode": 0}  # CPU: plain
    assert "fuse_steps=3: 0 fused window launches" in out


def _summaries(tmp_path, argv):
    """The JAX launcher's and the port's --json-summary for one argv."""
    from repro.launch import serve_snn as jserve

    jserve.main([*argv, "--json-summary", str(tmp_path / "j.json")])
    tserve.main(["--device", "cpu", *argv, "--json-summary",
                 str(tmp_path / "t.json")])
    return (json.loads((tmp_path / "j.json").read_text()),
            json.loads((tmp_path / "t.json").read_text()))


SERVE_ARGV = ["--streams", "7", "--steps-per-stream", "12", "--n-inputs",
              "16", "--n-neurons", "24", "--n-slots", "3", "--chunk", "4"]


@pytest.mark.parametrize("extra", [[], ["--drain", "2"],
                                   ["--gate", "per-example", "--drain", "1"]])
def test_serve_snn_sync_summary_matches_jax(tmp_path, extra):
    want, got = _summaries(tmp_path, SERVE_ARGV + extra)
    for key in ("mode", "streams_done", "steps", "rounds", "n_slots",
                "sparsity", "event_gate", "server", "energy"):
        assert got[key] == want[key], key
    assert got["meta"]["axes"] == want["meta"]["axes"]
    assert got["meta"]["bench_schema"] == want["meta"]["bench_schema"]
    assert got["server"]["steps"] == got["steps"] == 7 * 12
    assert got["launches"]["spike_timestep"] == 0   # CPU: plain versions


def test_serve_snn_async_summary_matches_jax(tmp_path):
    argv = SERVE_ARGV + [
        "--async", "--arrival-rate", "200", "--queue-capacity", "64",
        "--qos", "hi=2:4,bg=0:1:2", "--qos-preempt", "--burst", "hi",
        "--burst-rate", "1000"]
    want, got = _summaries(tmp_path, argv)
    for key in ("mode", "requests", "offered_rate_per_s", "policy",
                "queue_capacity", "deadline_ms", "qos", "burst"):
        assert got[key] == want[key], key
    c, jc = got["frontend"]["counts"], want["frontend"]["counts"]
    assert c["submitted"] == jc["submitted"] == 7
    assert c["done"] == jc["done"] == 7       # room for all: none shed
    assert got["server"]["steps"] == got["steps"] == 7 * 12
    assert got["server"]["sops"] == want["server"]["sops"]


def test_serve_snn_async_entry_points_run_on_cpu(tmp_path, capsys):
    conn = tmp_path / "conn"
    summary = tserve.main([
        "--device", "cpu", "--backend", "cuda", "--fuse-steps", "2",
        *SERVE_ARGV, "--async", "--arrival-rate", "500",
        "--backpressure", "drop-oldest", "--queue-capacity", "4",
        "--deadline-ms", "5", "--qos", "hi=1:2,bg=0:1", "--qos-preempt",
        "--burst", "hi", "--burst-at", "0.001", "--slo-p99-ms", "1",
        "--slo-miss-ratio", "0.5", "--slo-queue-depth", "2",
        "--slo-window-s", "10", "--flight", str(tmp_path / "flight.json"),
        "--connector", str(conn), "--metrics", str(tmp_path / "m.prom"),
        "--trace", str(tmp_path / "trace.jsonl"),
        "--profile", str(tmp_path / "prof"), "--json-summary"])
    out = capsys.readouterr().out
    assert summary["mode"] == "async" and summary["device"] == "cpu"
    assert summary["frontend"]["counts"]["submitted"] == 7
    assert '"mode": "async"' in out and "[serve-snn] qos:" in out
    from repro_torch.obs import reconstruct

    reconstruct(str(tmp_path / "trace.jsonl"))    # no lifecycle violation
    prom = (tmp_path / "m.prom").read_text()
    assert "snn_frontend_requests_total" in prom
    assert (tmp_path / "prof" / "trace.json").exists()
    assert list(conn.iterdir()) == []             # every spill resumed
    for argv, what in ((["--async", "--qos-preempt"], "needs a --qos"),
                       (["--drain", "1", "--async"], "sync-mode"),
                       (["--mesh", "1x2"], "requires --devices"),
                       (["--devices", "4", "--mesh", "3x1"],
                        "does not cover"),
                       (["--devices", "2", "--mesh", "2"],
                        "must look like"),
                       (["--burst", "x"], "require --async")):
        with pytest.raises(SystemExit, match=what):
            tserve.main(["--device", "cpu", *argv])


def test_default_device_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        TSession()
    jnet = _jax_net(3, (6, 10, 4))
    prog = tch.compile_network(_to_port(jnet))
    with pytest.raises(RuntimeError, match="CUDA"):
        tch.make_engine(prog)
    engine = tch.make_engine(prog, device="cpu")
    from repro_torch.serving.snn import SpikeServer

    with pytest.raises(RuntimeError, match="CUDA"):
        SpikeServer(engine)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--streams", "1"])


def test_port_imports_neither_jax_nor_repro():
    """Importing every module of the port leaves no ``jax``, no
    ``repro`` / ``repro.*``, no ``msgpack`` and no ``ml_dtypes`` in
    ``sys.modules`` (neither of the last two is installed on the card's
    machine)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'repro', 'msgpack', 'ml_dtypes'))\n"
        "new = ('repro_torch.events.trace', 'repro_torch.kernels._build', "
        "'repro_torch.kernels.spike_timestep_fused', "
        "'repro_torch.kernels.ref', 'repro_torch.kernels.lif_step', "
        "'repro_torch.kernels.poisson_encode', 'repro_torch.bench_schema', "
        "'repro_torch.benchmarks.common', "
        "'repro_torch.benchmarks.kernel_bench', 'repro_torch.core.prng', "
        "'repro_torch.serving.connector', 'repro_torch.serving.frontend', "
        "'repro_torch.serving.qos', 'repro_torch.distributed.straggler', "
        "'repro_torch.obs.metrics', 'repro_torch.obs.tracing', "
        "'repro_torch.obs.timeline', 'repro_torch.obs.slo', "
        "'repro_torch.obs.flight', 'repro_torch.distributed.partition', "
        "'repro_torch.distributed.spike_mesh', 'repro_torch.tree', "
        "'repro_torch.data.mnist', 'repro_torch.snn.model', "
        "'repro_torch.snn.train', 'repro_torch.training.optimizers', "
        "'repro_torch.training.loop', 'repro_torch.training.compression', "
        "'repro_torch.checkpoint', 'repro_torch.checkpoint._msgpack')\n"
        "assert all(n in sys.modules for n in new), new\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 57


def test_port_sources_name_neither_jax_nor_repro():
    """No source line of the port, nor of chip_smoke.py, imports ``jax``,
    the JAX package, ``msgpack`` or ``ml_dtypes``, even inside a
    function."""
    import re

    repo = pathlib.Path(__file__).resolve().parent.parent
    pattern = re.compile(
        r"^\s*(import\s+(jax|repro|msgpack|ml_dtypes)\b(?!_)"
        r"|from\s+(jax|repro|msgpack|ml_dtypes)(\.|\s))")
    files = sorted((repo / "src" / "repro_torch").rglob("*.py"))
    files.append(repo / "chip_smoke.py")
    assert len(files) > 47
    bad = [f"{f.name}:{i}: {line.strip()}"
           for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if pattern.match(line)]
    assert bad == []


def test_carry_from_jax_continues_byte_equal():
    """A JAX engine's carry, carried across with convert.carry, continues
    in the port exactly as it does in JAX."""
    from repro_torch.core.engine import DecaySpec as TDecay
    from repro_torch.core.engine import SpikeEngine as TEngine
    from repro.core.engine import DecaySpec as JDecay
    from repro.core.engine import SpikeEngine as JEngine

    rng = np.random.default_rng(12)
    n_in, P = 16, 40
    W = (rng.normal(0, 0.5, (n_in + P, P)) * 65536
         * (rng.random((n_in + P, P)) < 0.3)).astype(np.int32)
    je = JEngine(W, n_in, decay=JDecay.shift(0.25), threshold_raw=1 << 16,
                 reset_mode="subtract")
    te = TEngine(W, n_in, decay=TDecay.shift(0.25), threshold_raw=1 << 16,
                 reset_mode="subtract", backend="cuda", device="cpu")
    ext = (rng.random((14, 3, n_in)) < 0.3).astype(np.int32)
    jc, _ = je.step_chunk(je.init_carry(3), jnp.asarray(ext[:6]))
    tc = convert.carry(v=np.asarray(jc["v"]), spikes=np.asarray(jc["spikes"]))
    jc, js = je.step_chunk(jc, jnp.asarray(ext[6:]))
    tc, ts_ = te.step_chunk(tc, ext[6:])
    assert np.array_equal(np.asarray(js), ts_.numpy())
    assert np.array_equal(np.asarray(jc["v"]), tc["v"].numpy())


def test_coding_latency_encode_and_decoders_match_jax():
    from repro.core import coding as jcoding
    from repro_torch.core import coding as tcoding

    x = np.random.default_rng(13).random((4, 9)).astype(np.float32)
    x[0, :3] = [0.0, 1.0, 0.5]
    jl = np.asarray(jcoding.latency_encode(x, 12, dtype=jnp.int32))
    tl = tcoding.latency_encode(x, 12, dtype=torch.int32).numpy()
    assert np.array_equal(jl, tl)
    assert np.array_equal(np.asarray(jcoding.rate_decode(jl)),
                          tcoding.rate_decode(torch.from_numpy(tl)).numpy())
    assert np.array_equal(np.asarray(jcoding.classify_decode(jl)),
                          tcoding.classify_decode(torch.from_numpy(tl))
                          .numpy())
    assert np.allclose(np.asarray(jcoding.analog_decode(jl, -1.0, 2.0)),
                       tcoding.analog_decode(torch.from_numpy(tl), -1.0, 2.0)
                       .numpy(), rtol=0, atol=1e-6)
    x = np.full((2, 5000), 0.3)
    spikes = tcoding.poisson_encode(prng.key(0), x, 4)
    assert spikes.shape == (4, 2, 5000)
    assert abs(float(spikes.mean()) - 0.3) < 0.01
    want = jcoding.poisson_encode(jax.random.key(0), x, 4)
    assert np.array_equal(spikes.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# a seed gives the JAX package's spikes: session.run / run_all, serve_snn
# --------------------------------------------------------------------------

def _inputs(rng, n_inputs, B=3):
    x = rng.uniform(-0.1, 1.1, (B, n_inputs)).astype(np.float32)
    x[0, :3] = [0.0, 1.0, np.nan]
    return x


def _assert_result_equal(jr, tr):
    for k in ("spikes", "output_counts", "predictions"):
        assert np.array_equal(np.asarray(jr[k]), tr[k].numpy()), k
    for k in ("cycles", "sops", "row_fetches"):
        assert np.array_equal(np.asarray(jr[k]), np.asarray(tr[k])), k


@pytest.mark.parametrize("backend,seed", [
    ("reference", 0), ("reference", 42), ("reference", -1),
    ("reference", 2**32), ("cuda", 7), ("cuda-f32", 2**31)])
def test_session_run_with_a_seed_matches_jax(backend, seed):
    nets = _two_models()
    js, ts = _sessions(nets, SMALL, backend)
    x = _inputs(np.random.default_rng(20), 30)
    jr = js.run("A", x, 12, jax.random.key(seed))
    tr = ts.run("A", x, 12, seed=seed)
    _assert_result_equal(jr, tr)
    assert int(tr["spikes"].sum()) > 0
    # a port key is taken as is: a split key gives JAX's split key's run
    jr = js.run("B", x[:, :20], 12, jax.random.split(jax.random.key(seed))[1])
    tr = ts.run("B", x[:, :20], 12, seed=prng.split(prng.key(seed))[1])
    _assert_result_equal(jr, tr)


@pytest.mark.parametrize("seed", [5, -2**31 - 1])
def test_session_run_all_with_a_seed_matches_jax(seed):
    nets = _two_models()
    js, ts = _sessions(nets, SMALL, "reference")
    rng = np.random.default_rng(21)
    xs = {"A": _inputs(rng, 30), "B": _inputs(rng, 20)}
    jr = js.run_all(xs, 10, jax.random.key(seed))
    tr = ts.run_all(xs, 10, seed=seed)
    assert set(tr) == {"A", "B"}
    for name in xs:
        _assert_result_equal(jr[name], tr[name])


def _jax_request_plan(args, names, rng):
    """The JAX launcher's request plan, as ``repro.launch.serve_snn``
    builds it: one ``jax.random.split`` of the running key per stream."""
    from repro.core import coding as jcoding

    key = jax.random.key(args.seed)
    requests = []
    for uid in range(args.streams):
        key, k = jax.random.split(key)
        name = names[uid % len(names)]
        intensity = (args.intensity
                     * rng.random((1, args.n_inputs)).astype(np.float32))
        spikes = np.asarray(jcoding.poisson_encode(
            k, intensity, args.steps_per_stream, dtype=np.int32))[:, 0]
        requests.append((uid, name, spikes))
    return requests


@pytest.mark.parametrize("seed", [0, 3, 2**32 + 5])
def test_serve_snn_request_plan_matches_jax(seed):
    args = tserve.build_parser().parse_args([
        "--seed", str(seed), "--streams", "7", "--n-inputs", "40",
        "--steps-per-stream", "16", "--intensity", "0.6"])
    names = ["snn0", "snn1", "snn2"]
    want = _jax_request_plan(args, names, np.random.default_rng(seed))
    got = tserve._request_plan(args, names, np.random.default_rng(seed))
    assert len(got) == len(want) == 7
    for (ju, jn, js_), (tu, tn, ts_) in zip(want, got):
        assert (tu, tn) == (ju, jn)
        assert ts_.dtype == js_.dtype == np.int32
        assert ts_.shape == (16, 40)
        assert np.array_equal(ts_, js_)
    assert sum(int(s.sum()) for _, _, s in got) > 0
