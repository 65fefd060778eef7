"""The paper's tables in the port (``repro_torch.benchmarks``) against the
JAX scripts of ``benchmarks/``, on the CPU.

* Table III: the printed rows are equal, as strings.
* Table V on JAX's params and spikes (given as numpy): every printed
  line equal, counts and mW exactly equal, with and without
  ``--measured-sop`` (the measured-vs-analytic delta too); and end to end
  from the seeds, where the port's ``prng.normal`` is rtol 1e-6 to JAX's.
* Speedup: cycles and the speedup report equal on every port backend
  against JAX's ``reference``.
* Table IV: ``run_cell`` at a tiny budget in both packages, held to the
  margins of ``tests/test_torch_snn_train.py``; the hardware half
  byte-equal on JAX-trained params; the summary block equal for the same
  rows.
* ``run.py --fast --device cpu`` runs sections, and ``--only roofline``
  raises.
"""

import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_lm_train import one_torch_thread  # noqa: E402,F401

from benchmarks import speedup_s_vs_h as jspeed  # noqa: E402
from benchmarks import table_iii_comparison as jt3  # noqa: E402
from benchmarks import table_iv_accuracy as jt4  # noqa: E402
from benchmarks import table_v_power as jt5  # noqa: E402
from repro.core import coding as jcoding  # noqa: E402
from repro.core.lif import LIFParams as JLIFParams  # noqa: E402
from repro.data import mnist as jmnist  # noqa: E402
from repro.snn import model as jm  # noqa: E402
from repro.snn import train as jtrain  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.benchmarks import run as trun  # noqa: E402
from repro_torch.benchmarks import speedup_s_vs_h as tspeed  # noqa: E402
from repro_torch.benchmarks import table_iii_comparison as tt3  # noqa: E402
from repro_torch.benchmarks import table_iv_accuracy as tt4  # noqa: E402
from repro_torch.benchmarks import table_v_power as tt5  # noqa: E402
from repro_torch.core.engine import BACKENDS  # noqa: E402

# a CPU-sized Table V / speedup workload (the scripts' flags)
HIDDEN, BATCH, STEPS = 32, 16, 20
SIZE_ARGS = ["--hidden", str(HIDDEN), "--batch", str(BATCH), "--steps",
             str(STEPS)]
# end to end from the seeds: counts and mW to rtol 1e-4 (the params are
# rtol 1e-6 to JAX's, so a weight could land on the next Q16.16 step;
# equal in every run so far)
SEED_RTOL = 1e-4
# Table IV tiny cells (T 10, 20 steps, 64 digits) against the margins of
# test_torch_snn_train.test_evaluate_dual_matches_paper_contract; the two
# packages train in float32 in another order, so their accuracies differ
# by a few digits (up to 2 of 64 measured)
TINY = dict(train_T=10, infer_T=10, train_steps=20, eval_n=64)
ACC_GAP_MAX = 0.1


def _out(fn, *a, **k):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = fn(*a, **k)
    return res, buf.getvalue()


def _jax_inputs(layer_sizes, decay, batch, steps):
    """JAX's drawn params (key 0) and Poisson spikes (key 1) of the Table V
    / speedup scripts, as numpy."""
    jcfg = jm.SNNModelConfig(layer_sizes=layer_sizes,
                             params=JLIFParams(decay_rate=decay))
    params = [np.asarray(w) for w in jm.init_params(jax.random.key(0),
                                                    jcfg)]
    x, _ = jmnist.load_or_generate("test", batch, seed=0)
    spikes = np.array(jcoding.poisson_encode(
        jax.random.key(1), jnp.asarray(x), steps, dtype=np.int32))
    return params, spikes


# --------------------------------------------------------------------------
def test_table_iii_rows_equal_jax():
    jrows, jtext = _out(jt3.main, [])
    trows, ttext = _out(tt3.main, [])
    assert ttext == jtext
    assert trows == jrows


@pytest.mark.parametrize("measured", [False, True])
def test_table_v_on_jax_params_equals_jax(measured):
    """The port's report on JAX's params and spikes: the same printed
    lines, counts, mW and energy as the JAX script's run."""
    extra = ["--measured-sop"] if measured else []
    jres, jtext = _out(jt5.main, SIZE_ARGS + extra)
    params, spikes = _jax_inputs((784, HIDDEN, 10), 0.25, BATCH, STEPS)
    tres, ttext = _out(tt5.report, convert.snn_params(params),
                       tt5.model_config(HIDDEN), torch.from_numpy(spikes),
                       measured_sop=measured, backend="cuda", device="cpu")
    assert ttext == jtext
    for f in ("sops", "row_fetches", "spike_packets", "cycles"):
        assert getattr(tres["counts"], f) == getattr(jres["counts"], f), f
    assert tres["mw"] == {k: float(v) for k, v in jres["mw"].items()}
    assert tres["uj"] == {k: float(v) for k, v in jres["uj"].items()}
    if measured:
        # ROADMAP fault 7, mirrored: measured SOPs count float-nonzero
        # synapses; the delta printed is JAX's (in the text compared above)
        assert set(tres["deltas"]) == {"sops", "row_fetches"}
        assert "table_v/sops_measured_vs_analytic" in ttext


@pytest.mark.parametrize("measured", [False, True])
def test_table_v_from_seeds_matches_jax(measured):
    extra = ["--measured-sop"] if measured else []
    jres, _ = _out(jt5.main, SIZE_ARGS + extra)
    tres, _ = _out(tt5.main, SIZE_ARGS + extra + ["--device", "cpu"])
    for f in ("sops", "row_fetches", "cycles"):
        np.testing.assert_allclose(getattr(tres["counts"], f),
                                   getattr(jres["counts"], f),
                                   rtol=SEED_RTOL, err_msg=f)
    for k, v in jres["mw"].items():
        np.testing.assert_allclose(tres["mw"][k], float(v), rtol=SEED_RTOL,
                                   err_msg=k)


def test_table_v_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tt5.main(SIZE_ARGS)


@pytest.mark.parametrize("backend", BACKENDS)
def test_speedup_equals_jax(backend):
    """Cycles and the report on JAX's params and spikes, every port backend
    against JAX's ``reference`` (batch 8)."""
    args = ["--hidden", str(HIDDEN), "--batch", "8", "--steps", str(STEPS)]
    jres, jtext = _out(jspeed.main, args + ["--backend", "reference"])
    params, spikes = _jax_inputs((784, HIDDEN, 10), 0.25, 8, STEPS)
    tres, ttext = _out(tspeed.report, convert.snn_params(params),
                       tt5.model_config(HIDDEN), torch.from_numpy(spikes),
                       backend=backend, device="cpu")
    assert ttext == jtext
    assert tres["report"].__dict__ == {
        k: float(v) for k, v in jres["report"].__dict__.items()}


# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_cells():
    return {h: (jt4.run_cell(h, TINY["train_T"], TINY["infer_T"],
                             train_steps=TINY["train_steps"],
                             eval_n=TINY["eval_n"]),
                tt4.run_cell(h, TINY["train_T"], TINY["infer_T"],
                             train_steps=TINY["train_steps"],
                             eval_n=TINY["eval_n"], device="cpu"))
            for h in (16, 32)}


@pytest.mark.parametrize("hidden", [16, 32])
def test_table_iv_tiny_cell_meets_margins(tiny_cells, hidden):
    jrow, trow = tiny_cells[hidden]
    for row in (jrow, trow):
        assert row["software_acc"] > 0.3
        assert row["hardware_acc"] > 0.25
        assert abs(row["deviation_pct"]) < 15.0
        assert row["agreement"] > 0.65
    for k in ("software_acc", "hardware_acc"):
        assert abs(trow[k] - jrow[k]) <= ACC_GAP_MAX, k
    assert (trow["hidden"], trow["train_T"], trow["infer_T"]) == (
        jrow["hidden"], jrow["train_T"], jrow["infer_T"])


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_table_iv_hardware_half_on_jax_trained_params(backend):
    """JAX trains the cell; the port's ``evaluate_cell`` on those params
    gives JAX's hardware half byte for byte."""
    jcfg = jtrain.TrainConfig(
        model=jm.SNNModelConfig(layer_sizes=(784, 16, 10),
                                params=JLIFParams(decay_rate=0.1)),
        num_steps_time=10, lr=3e-3, batch_size=96, train_steps=10, seed=0)
    params, _, _ = jtrain.train(jcfg, jmnist.batches(
        "train", 96, 10, seed=0), log_every=0)
    x, y = jmnist.load_or_generate("test", 64, seed=1)
    jres = jtrain.evaluate_dual(params, jcfg.model, x, y, num_steps_time=10)
    tcfg = tt4.cell_config(16, 10, 10)
    trow = tt4.evaluate_cell(convert.snn_params(
        [np.asarray(w) for w in params]), tcfg, 10, eval_n=64,
        backend=backend, device="cpu")
    for k in ("output_counts", "spikes", "cycles", "sops", "row_fetches"):
        a, b = np.asarray(jres["hw_counts"][k]), trow["hw_counts"][k].numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert trow["hardware_acc"] == jres["hardware_acc"]


def test_table_iv_summary_block_equals_jax(monkeypatch):
    """Both mains on the same scripted rows: every printed line equal."""
    rng = np.random.default_rng(0)
    rows = {}

    def fake(h, tt, it, **_):
        key = (h, tt, it)
        if key not in rows:
            sw, hw = rng.integers(0, 513, 2) / 512
            rows[key] = {"hidden": h, "train_T": tt, "infer_T": it,
                         "software_acc": sw, "hardware_acc": hw,
                         "deviation_pct": (hw - sw) * 100.0,
                         "agreement": rng.integers(0, 513) / 512}
        return dict(rows[key])

    monkeypatch.setattr(jt4, "run_cell", fake)
    monkeypatch.setattr(tt4, "run_cell", fake)
    for full in ([], ["--full"]):
        _, jtext = _out(jt4.main, full)
        _, ttext = _out(tt4.main, full + ["--device", "cpu"])
        assert ttext == jtext
        assert "overall_avg_deviation_pp," in ttext
        assert "paper_reference: -2.62pp avg" in ttext


# --------------------------------------------------------------------------
def test_run_fast_sections_on_cpu():
    out, text = _out(trun.main, ["--fast", "--only", "table_iii,speedup",
                                 "--device", "cpu"])
    assert set(out) == {"table_iii", "speedup"}
    assert "===== table_iii (systems comparison) =====" in text
    assert "speedup/clock_speedup,,9.46x (paper: 9.46x)" in text
    assert out["speedup"]["cycles_s"].shape == (25, 32)


def test_run_only_roofline_prints_the_table(tmp_path, monkeypatch):
    """``run --only roofline`` prints the roofline table of the records a
    dry-run wrote (its process group in a subprocess): the header and the
    cells' rows, a cell the rank steps run with its terms and one they
    do not run yet shown with its reason."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    records = tmp_path / "results" / "dryrun_torch.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(repo, "src"))
    for arch in ("granite-3-2b", "minicpm3-4b"):   # the records append
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", "decode_32k", "--mesh", "single", "--device",
             "cpu", "--out", str(records)],
            capture_output=True, text=True, env=env, timeout=300)
        assert proc.returncode == 0, proc.stderr[-2000:]
    monkeypatch.chdir(tmp_path)   # the section reads results/ there
    out, text = _out(trun.main, ["--only", "roofline", "--device", "cpu"])
    assert list(out) == ["roofline"] and len(out["roofline"]) == 2
    assert "===== roofline (from dry-run artifacts) =====" in text
    assert ("arch,shape,mesh,status,compute_s,memory_s,collective_s,"
            "dominant,useful_flops_ratio,roofline_fraction,"
            "mem_gib_per_dev") in text
    assert "\ngranite-3-2b,decode_32k,single_pod_16x16,ok," in text
    assert ("minicpm3-4b,decode_32k,single_pod_16x16,NOT_PORTED,,,,,,,"
            "\"the decode step of MLA (minicpm3) across ranks is") in text
