"""The rest of the port's compile layer against the JAX package's: Cerebra-S,
the float software baseline, the energy model and the timing model.

Mirrors ``tests/test_cerebra.py`` for Cerebra-S and software (bit-exact
against the twin and against an independent big-int simulator, S and H
predictions, the HW-vs-SW deviation contract, the Cerebra-S cost model,
capacity rejection) and ``tests/test_energy.py`` (all four tests), plus
``counts_from_registry`` on one stub registry, ``timing.speedup_report``
and ``lif_step_float`` in both packages. Networks are built once from
seeded numpy weights and carried into the port with ``convert``. The JAX
side runs its ``reference`` backend.

Integer outputs (rasters, cycles, SOPs, counts) are byte-equal. The float
software path is held two ways: byte-equal spikes on dyadic weights
(``k / 256``, ``|k| <= 127``, at most 1024 sources), whose sums are exact
in float32 in any order; and, on general float weights, the twin test's
own contract plus raster agreement with JAX's of at least 0.999 (a spike
may flip only where two summation orders round across the threshold).
XLA on the CPU does not contract ``v * beta + syn`` into an FMA: the
float LIF step is byte-equal in both packages.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_lm_train import one_torch_thread  # noqa: E402,F401

from repro.core import cerebra_h as jch  # noqa: E402
from repro.core import cerebra_s as jcs  # noqa: E402
from repro.core import energy as jenergy  # noqa: E402
from repro.core import lif as jlif  # noqa: E402
from repro.core import software as jsw  # noqa: E402
from repro.core import timing as jtiming  # noqa: E402
from repro.core.mapping import ClusterGeometry as JGeom  # noqa: E402
from repro.core.network import SNNetwork as JNet  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import cerebra_h as tch  # noqa: E402
from repro_torch.core import cerebra_s as tcs  # noqa: E402
from repro_torch.core import energy as tenergy  # noqa: E402
from repro_torch.core import lif as tlif  # noqa: E402
from repro_torch.core import software as tsw  # noqa: E402
from repro_torch.core import timing as ttiming  # noqa: E402
from repro_torch.core.engine import BACKENDS  # noqa: E402
from repro_torch.core.network import SNNetwork as TNet  # noqa: E402

from conftest import make_ff_net, make_random_net  # noqa: E402
from test_cerebra import _python_sim  # noqa: E402

# the twin test's HW-vs-SW contract, and the port's raster agreement
# with JAX's float path on general weights
PRED_AGREE_MIN = 0.5
RASTER_AGREE_MIN = 0.9
SW_RASTER_AGREE_MIN = 0.999


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


def _eq(j, t) -> bool:
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    return t.dtype == j.dtype and np.array_equal(j, t)


def _s_programs(jnet, n_phys=1024):
    jcfg = jcs.CerebraSConfig(n_physical_neurons=n_phys)
    tcfg = tcs.CerebraSConfig(n_physical_neurons=n_phys)
    return (jcs.compile_network(jnet, jcfg),
            tcs.compile_network(_to_port(jnet), tcfg))


def _assert_s_run_equal(jo, to):
    for key in ("spikes", "output_counts", "cycles", "sops"):
        assert _eq(jo[key], to[key]), key


# --------------------------------------------------------------------------
# Cerebra-S
# --------------------------------------------------------------------------

def test_cerebra_s_compile_matches_jax(rng):
    jnet = make_random_net(rng, n_in=6, n_neurons=10, density=0.4,
                           decay_rate=0.3)
    jp, tp = _s_programs(jnet, 16)
    assert _eq(jp.weights_raw, tp.weights_raw)
    assert _eq(jp.fanout, tp.fanout)
    assert jp.decay_raw == tp.decay_raw == int(round(0.7 * 65536))
    assert jp.output_slice == tp.output_slice
    assert (jp.n_inputs, jp.n_neurons, jp.n_sources) == (
        tp.n_inputs, tp.n_neurons, tp.n_sources)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("reset_mode", ["zero", "subtract"])
def test_cerebra_s_bit_exact_vs_jax_and_python(rng, backend, reset_mode):
    jnet = make_random_net(rng, n_in=6, n_neurons=10, density=0.4,
                           decay_rate=0.3, reset_mode=reset_mode)
    jp, tp = _s_programs(jnet, 16)
    ext = (rng.random((8, 2, 6)) < 0.4).astype(np.int32)
    jo = jcs.run(jp, ext)
    to = tcs.run(tp, ext, backend, device="cpu")
    _assert_s_run_equal(jo, to)
    want = _python_sim(tp.weights_raw.numpy(), ext, tp.params, "mul",
                       tp.decay_raw, 16)
    assert np.array_equal(to["spikes"].numpy(), want)
    assert int(to["spikes"].sum()) > 0


def test_cerebra_s_engine_cache_and_mul_decay(rng):
    jnet = make_random_net(rng, n_in=6, n_neurons=10)
    _, tp = _s_programs(jnet, 16)
    eng = tcs.make_engine(tp, "cuda", device="cpu")
    assert tcs.make_engine(tp, "cuda", device="cpu") is eng
    assert tcs.make_engine(tp, "reference", device="cpu") is not eng
    assert set(tp._engines) == {("cuda", "cpu"), ("reference", "cpu")}
    assert eng.decay.kind == "mul" and eng.decay.raw == tp.decay_raw


def test_s_and_h_predictions_agree(rng):
    """Same logical net through both generations -> same classifications,
    and each generation's outputs equal the twin's."""
    jnet = make_ff_net(rng, sizes=(16, 32, 10))
    tnet = _to_port(jnet)
    ext = (rng.random((25, 8, 16)) < 0.35).astype(np.int32)
    outS = tcs.run(tcs.compile_network(tnet), ext, device="cpu")
    outH = tch.run(tch.compile_network(tnet), ext, device="cpu")
    _assert_s_run_equal(jcs.run(jcs.compile_network(jnet), ext), outS)
    jH = jch.run(jch.compile_network(jnet), ext)
    for key in ("spikes", "output_counts", "cycles", "sops", "row_fetches"):
        assert _eq(jH[key], outH[key]), key
    predS = outS["output_counts"].numpy().argmax(-1)
    predH = outH["output_counts"].numpy().argmax(-1)
    assert (predS == predH).mean() >= 0.75


def test_hw_vs_sw_deviation_contract(rng):
    """The Table IV premise in the port: HW (fixed, snapped decay) vs SW
    (float, exact decay) on identical spike trains -> small deviation;
    and the port's float raster against JAX's."""
    jnet = make_ff_net(rng, sizes=(24, 48, 10), decay_rate=0.2)
    tnet = _to_port(jnet)
    ext = (rng.random((40, 16, 24)) < 0.3).astype(np.float32)
    sw = tsw.run_software(tnet, ext, device="cpu")
    hw = tch.run(tch.compile_network(tnet), ext.astype(np.int32),
                 device="cpu")
    preds_sw = sw["output_counts"].numpy().argmax(-1)
    preds_hw = hw["output_counts"].numpy().argmax(-1)
    assert (preds_sw == preds_hw).mean() >= PRED_AGREE_MIN
    phys = hw["spikes"][:, :, :tnet.n_neurons].numpy()
    assert (phys == sw["spikes"].numpy()).mean() > RASTER_AGREE_MIN
    jsw_out = jsw.run_software(jnet, ext)
    assert sw["spikes"].dtype == torch.float32
    assert sw["spikes"].shape == jsw_out["spikes"].shape
    agree = (sw["spikes"].numpy() == np.asarray(jsw_out["spikes"])).mean()
    assert agree >= SW_RASTER_AGREE_MIN
    np.testing.assert_allclose(sw["output_counts"].numpy(),
                               np.asarray(jsw_out["output_counts"]),
                               rtol=0, atol=2)


@pytest.mark.parametrize("reset_mode", ["zero", "subtract", "hold"])
def test_software_byte_equal_on_dyadic_weights(reset_mode):
    """Weights k/256 with |k| <= 127 over <= 1024 sources: every partial
    sum is a multiple of 2^-8 below 2^17, exact in float32 in any order,
    so the float rasters are byte-equal across packages."""
    rng = np.random.default_rng(11)
    n_in, n = 200, 120
    k = rng.integers(-127, 128, (n_in + n, n))
    W = (k * (rng.random(k.shape) < 0.4) / 256.0).astype(np.float32)
    from repro.core.lif import LIFParams as JLIF

    jnet = JNet(n_inputs=n_in, n_neurons=n, weights=W,
                params=JLIF(decay_rate=0.25, threshold=1.0,
                            reset_mode=reset_mode),
                output_slice=(n - 10, n))
    tnet = _to_port(jnet)
    ext = (rng.random((30, 6, n_in)) < 0.2).astype(np.float32)
    j = jsw.run_software(jnet, ext)
    t = tsw.run_software(tnet, ext, device="cpu")
    assert _eq(j["spikes"], t["spikes"])
    assert _eq(j["output_counts"], t["output_counts"])
    assert 0 < int(t["spikes"].sum()) < t["spikes"].numel()


@pytest.mark.parametrize("reset_mode", ["zero", "subtract", "hold"])
def test_lif_step_float_matches_jax(reset_mode):
    """v * beta, then the add, then fire/reset: byte-equal float32."""
    rng = np.random.default_rng(3)
    kw = dict(decay_rate=0.2, threshold=0.7, reset_mode=reset_mode)
    jp, tp = jlif.LIFParams(**kw), convert.lif_params(**kw)
    v = rng.normal(0, 1, (64, 300)).astype(np.float32)
    syn = rng.normal(0, 1, (64, 300)).astype(np.float32)
    js, jspk = jlif.lif_step_float({"v": jnp.asarray(v)}, jnp.asarray(syn),
                                   jp)
    ts, tspk = tlif.lif_step_float({"v": torch.from_numpy(v)},
                                   torch.from_numpy(syn), tp)
    assert _eq(js["v"], ts["v"]) and _eq(jspk, tspk)
    assert 0 < int(tspk.sum()) < tspk.numel()


def test_cerebra_s_cost_model(rng):
    """Bus cycles = sum of fanouts of spiking sources (1 event / cycle)."""
    jnet = make_random_net(rng, n_in=8, n_neurons=12, density=0.5)
    jp, tp = _s_programs(jnet)
    ext = np.zeros((2, 1, 8), np.int32)
    ext[0, 0, [1, 3]] = 1
    out = tcs.run(tp, ext, device="cpu")
    _assert_s_run_equal(jcs.run(jp, ext), out)
    fanout = tp.fanout
    assert int(out["cycles"][0, 0]) == fanout[1] + fanout[3]
    spiked = np.where(out["spikes"][0, 0].numpy() > 0)[0]
    want = sum(fanout[tp.n_inputs + int(i)] for i in spiked)
    assert int(out["cycles"][1, 0]) == want
    cost = tcs.cost_model(tp, ext, out["spikes"])
    assert cost["cycles"].dtype == torch.int32 and cost["sops"] is cost[
        "cycles"]


def test_cerebra_h_cost_model_parallelism(rng):
    """H cycles track the max-loaded group/L1: H is far below S, and the
    SOPs are the same work in both."""
    tnet = _to_port(make_ff_net(rng, sizes=(20, 64, 10)))
    ext = (rng.random((20, 4, 20)) < 0.4).astype(np.int32)
    outS = tcs.run(tcs.compile_network(tnet), ext, device="cpu")
    outH = tch.run(tch.compile_network(tnet), ext, device="cpu")
    assert int(outH["cycles"].sum()) < int(outS["cycles"].sum())
    assert int(outS["sops"].sum()) == int(outH["sops"].sum())


def test_capacity_rejection():
    """Cerebra-H's row budget and Cerebra-S's array and SRAM limits raise
    the twin's errors."""
    geom = dict(rows_per_group=4)
    dense = TNet(n_inputs=64, n_neurons=64,
                 weights=np.ones((128, 64), np.float32),
                 params=convert.lif_params(decay_rate=0.25, threshold=1.0,
                                           reset_mode="zero"))
    with pytest.raises(ValueError, match="capacity"):
        tch.compile_network(
            dense, tch.CerebraHConfig(geometry=convert.geometry(**geom)))
    with pytest.raises(ValueError, match="capacity"):
        jch.compile_network(
            JNet(n_inputs=64, n_neurons=64, weights=dense.weights,
                 params=jlif.LIFParams(decay_rate=0.25)),
            jch.CerebraHConfig(geometry=JGeom(**geom)))
    with pytest.raises(ValueError, match="physical neurons"):
        tcs.compile_network(dense, tcs.CerebraSConfig(n_physical_neurons=32))
    with pytest.raises(ValueError, match="SRAM budget"):
        tcs.compile_network(dense, tcs.CerebraSConfig(max_external_sources=63))


# --------------------------------------------------------------------------
# Energy and timing
# --------------------------------------------------------------------------

def _reference_counts(mod, model, seconds: float = 1.0):
    r = model.reference_rates
    return mod.WorkloadCounts(
        sops=r["sops_per_s"] * seconds,
        row_fetches=r["rows_per_s"] * seconds,
        spike_packets=r["packets_per_s"] * seconds,
        cycles=model.freq_mhz * 1e6 * seconds,
    )


def test_energy_constants_match_jax():
    assert tenergy.TABLE_V == jenergy.TABLE_V
    assert tenergy.E_SOP_PJ == jenergy.E_SOP_PJ
    assert tenergy.SOPS_PER_ROW == jenergy.SOPS_PER_ROW
    assert dataclasses.asdict(tenergy.EnergyModel.calibrated()) == \
        dataclasses.asdict(jenergy.EnergyModel.calibrated())


def test_calibration_reproduces_table_v():
    model = tenergy.EnergyModel.calibrated()
    counts = _reference_counts(tenergy, model)
    got = model.breakdown_mw(counts)
    for key in ("weight_memory_mw", "neuron_clusters_mw",
                "spike_paths_mw", "data_control_paths_mw"):
        assert got[key] == pytest.approx(tenergy.TABLE_V[key], rel=1e-6), key
    assert got["total_mw"] == pytest.approx(tenergy.TABLE_V["total_mw"],
                                            abs=0.02)
    assert got["weight_memory_pct"] == pytest.approx(95.97, abs=0.01)
    assert got["compute_pj_per_sop"] == 1.05
    jmodel = jenergy.EnergyModel.calibrated()
    assert got == jmodel.breakdown_mw(_reference_counts(jenergy, jmodel))


def test_memory_dominance_invariant():
    model = tenergy.EnergyModel.calibrated()
    for duty in (0.0, 0.1, 0.5, 1.0, 2.0):
        c = _reference_counts(tenergy, model)
        c = tenergy.WorkloadCounts(c.sops * duty, c.row_fetches * duty,
                                   c.spike_packets * duty, c.cycles)
        assert model.breakdown_mw(c)["weight_memory_pct"] > 90.0


def test_energy_accounting_consistency():
    model = tenergy.EnergyModel.calibrated()
    c = _reference_counts(tenergy, model, seconds=0.25)
    e = model.energy_uj(c)
    assert e["total_uj"] == pytest.approx(e["static_uj"] + e["dynamic_uj"])
    assert e["pj_per_sop_system"] > 10 * e["pj_per_sop_compute"]
    mw = model.breakdown_mw(c)["total_mw"]
    assert e["total_uj"] == pytest.approx(mw * 1e-3 * 0.25 * 1e6, rel=1e-6)
    jmodel = jenergy.EnergyModel.calibrated()
    assert e == jmodel.energy_uj(_reference_counts(jenergy, jmodel, 0.25))


def test_counts_from_run(rng):
    jnet = make_ff_net(rng, sizes=(16, 32, 10))
    ext = (rng.random((15, 4, 16)) < 0.4).astype(np.int32)
    out = tch.run(tch.compile_network(_to_port(jnet)), ext, device="cpu")
    counts = tenergy.counts_from_run(out)
    assert counts.sops > 0 and counts.row_fetches > 0
    assert counts.cycles > 0
    assert counts.sops <= counts.row_fetches * 32 + 1e-9
    want = jenergy.counts_from_run(jch.run(jch.compile_network(jnet), ext))
    assert dataclasses.asdict(want) == dataclasses.asdict(counts)


class _Counter:
    def __init__(self, value):
        self.value = value


class _StubRegistry:
    """The registry surface ``counts_from_registry`` reads."""

    def __init__(self, **values):
        self._values = values

    def counter(self, name):
        return _Counter(self._values[name])


@pytest.mark.parametrize("cycles", [None, 123456.0])
def test_counts_from_registry(cycles):
    reg = _StubRegistry(snn_server_sops_total=987654,
                        snn_server_row_fetches_total=43210)
    j = jenergy.counts_from_registry(reg, cycles=cycles)
    t = tenergy.counts_from_registry(reg, cycles=cycles)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert t.sops == 987654.0 and t.spike_packets == t.row_fetches == 43210.0
    if cycles is None:
        per_cycle = tenergy.EnergyModel.calibrated().reference_rates[
            "sops_per_cycle"]
        assert t.cycles == pytest.approx(987654 / per_cycle, rel=1e-12)


def test_speedup_report_matches_jax(rng):
    """S-vs-H timing on the same input, from both packages' cost models."""
    jnet = make_ff_net(rng, sizes=(20, 64, 10))
    tnet = _to_port(jnet)
    ext = (rng.random((20, 4, 20)) < 0.4).astype(np.int32)
    tS = tcs.run(tcs.compile_network(tnet), ext, device="cpu")
    tH = tch.run(tch.compile_network(tnet), ext, device="cpu")
    t = ttiming.speedup_report(tS["cycles"], tH["cycles"])
    j = jtiming.speedup_report(
        jcs.run(jcs.compile_network(jnet), ext)["cycles"],
        jch.run(jch.compile_network(jnet), ext)["cycles"])
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.total_speedup > t.cycle_speedup > 1.0
    assert t.clock_speedup == ttiming.FREQ_H_MHZ / ttiming.FREQ_S_MHZ
    assert ttiming.wall_time_us(962.4, ttiming.FREQ_H_MHZ) == \
        jtiming.wall_time_us(962.4, jtiming.FREQ_H_MHZ)
    assert (ttiming.FREQ_S_MHZ, ttiming.FREQ_H_MHZ,
            ttiming.CRITICAL_PATH_H_NS) == (
        jtiming.FREQ_S_MHZ, jtiming.FREQ_H_MHZ, jtiming.CRITICAL_PATH_H_NS)


def test_cerebra_s_f32_bound_matches_jax(rng):
    """Cerebra-S under ``cuda-f32`` is held to Cerebra-H's build-time
    2^24 bound: the paper's 784-256-10 net builds in both packages, and a
    weight image whose 128-row block sums reach 2^24 is refused in both
    with the twin's error."""
    paper = make_ff_net(rng, sizes=(784, 256, 10), scale=1.0)
    jp, tp = _s_programs(paper)
    jcs.make_engine(jp, "pallas-mxu")
    eng = tcs.make_engine(tp, "cuda-f32", device="cpu")
    assert eng.decay.kind == "mul"
    W = np.zeros((200 + 10, 10), np.float32)
    W[:128, 0] = 2.0  # 128 rows x 2^17 raw = 2^24
    hot = JNet(n_inputs=200, n_neurons=10, weights=W,
               params=jlif.LIFParams(decay_rate=0.25))
    jp, tp = _s_programs(hot, 16)
    with pytest.raises(ValueError, match=r"2\^24") as jerr:
        jcs.make_engine(jp, "pallas-mxu")
    with pytest.raises(ValueError, match=r"2\^24") as terr:
        tcs.make_engine(tp, "cuda-f32", device="cpu")
    assert "16777216" in str(jerr.value) and "16777216" in str(terr.value)
    assert tcs.make_engine(tp, "cuda", device="cpu").decay.kind == "mul"
