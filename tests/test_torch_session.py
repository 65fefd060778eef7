"""The serving slice as a whole: the port's compile step, session and
streaming server against the JAX package's, on identical numpy state.

Networks are built once from seeded numpy weights and carried into the
port with :mod:`repro_torch.convert`; both packages are fed the same numpy
chunks (the port's Poisson encoder draws other bits than threefry).
"""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

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
    nets = _two_models()
    _, ts = _sessions({"A": nets["A"]}, SMALL, "reference")
    view = ts.serve("A", n_slots=2)
    view.attach("u")
    with pytest.raises(NotImplementedError, match="connector"):
        ts.deploy("B", _to_port(nets["B"]))
    with pytest.raises(NotImplementedError, match="frontend"):
        ts.serve("A", n_slots=2, frontend=object())
    view.detach("u")
    ts.deploy("B", _to_port(nets["B"]))  # no live streams: fine
    with pytest.raises(RuntimeError, match="stale"):
        view.attach("v")


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
                                   "spike_timestep_fused": 0}  # CPU: plain
    assert "fuse_steps=3: 0 fused window launches" in out


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
    """Importing every module of the port leaves no ``jax`` and no
    ``repro`` / ``repro.*`` in ``sys.modules``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "new = ('repro_torch.events.trace', 'repro_torch.kernels._build', "
        "'repro_torch.kernels.spike_timestep_fused')\n"
        "assert all(n in sys.modules for n in new), new\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 19


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
    gen = torch.Generator().manual_seed(0)
    spikes = tcoding.poisson_encode(gen, np.full((2, 5000), 0.3), 4)
    assert spikes.shape == (4, 2, 5000)
    assert abs(float(spikes.mean()) - 0.3) < 0.01
