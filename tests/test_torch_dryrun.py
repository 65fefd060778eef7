"""The port's dry-run: one rank's step on fake tensors under the fake
process group, against the counts the ranks measured and the JAX
dry-run's statuses.

Twin of ``tests/test_dryrun_integration.py``. Every run joins a process
group, so each is a subprocess (``python -m repro_torch.launch.dryrun``
or a script calling ``run_cell``), all started together by one module
fixture with ``--device cpu`` (a fake tensor moved to ``cuda`` raises on
a torch built without CUDA):

* granite-3-2b ``decode_32k`` is ``not_ported`` (ROADMAP item 12e-ii),
  granite-20b ``long_500k`` a ``skip`` with the twin's reason, and
  granite-3-2b ``train_4k`` on the ``(16, 16)`` mesh at ``micro_rows``
  16 (one microbatch) ``ok``: 256 chips, positive terms, a dominant one;
* chip_smoke's phase 15 cell, granite-3-2b whole on ``(4, 1)``, B 8 x S
  512, ``micro_rows`` 2: the calls and bytes four H100 ranks measured
  (563 / 282 / 5 calls; 10.335 GB / 5.268 GB / 0.66 MB, the exact
  integers pinned);
* every cell of ``--arch all --shape all --mesh both`` but the three
  ``train_4k`` cells that run is ``skip`` or ``not_ported``, never
  ``fail`` (one case a cell).

The default ``micro_rows`` (16 microbatches, ~8 min on the CPU) is
marked ``slow``, as the twin marks its own cells.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 900
RUNS_OK = {"granite-3-2b", "granite-20b", "mixtral-8x7b"}
# every cell of --arch all --shape all --mesh both but the three that run
OTHERS = [(arch, shape, multi) for arch in configs.list_archs()
          for shape in SHAPES for multi in (False, True)
          if not (shape == "train_4k" and not multi and arch in RUNS_OK)]

# the phase 15 cell, and the statuses of every cell that does not run
_SCRIPT = r"""
import json, sys
from repro_torch.configs.shapes import Shape
from repro_torch.launch import dryrun

out = {"phase15": dryrun.run_cell(
    "granite-3-2b", Shape("ranks_whole", 512, 8, "train"), mesh=(4, 1),
    variant="micro_rows=2", device="cpu", verbose=False)}
out["others"] = {
    f"{arch}/{shape}/{multi}": dryrun.run_cell(
        arch, shape, multi_pod=multi, device="cpu", verbose=False)
    for arch, shape, multi in json.loads(sys.argv[1])}
print(json.dumps(out))
"""


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                OMP_NUM_THREADS="1")


def _cli(out, *args):
    return [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
            "cpu", "--mesh", "single", "--out", str(out), *args]


def _wait(proc, timeout=TIMEOUT):
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
        pytest.fail(f"hung past {timeout} s\n{stderr[-3000:]}")
    assert proc.returncode == 0, stderr[-3000:]
    return stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    cli = {
        "decode": ["--arch", "granite-3-2b", "--shape", "decode_32k"],
        "long": ["--arch", "granite-20b", "--shape", "long_500k"],
        "train": ["--arch", "granite-3-2b", "--shape", "train_4k",
                  "--variant", "micro_rows=16"],
    }
    procs = {k: subprocess.Popen(_cli(tmp / f"{k}.json", *a), env=_env(),
                                 text=True, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE)
             for k, a in cli.items()}
    procs["script"] = subprocess.Popen(
        [sys.executable, "-c", _SCRIPT, json.dumps(OTHERS)],
        env=_env(), text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    try:
        out = {}
        for k in cli:
            stdout = _wait(procs[k])
            with open(tmp / f"{k}.json") as f:
                out[k] = (json.load(f), stdout)
        out.update(json.loads(_wait(procs["script"]).splitlines()[-1]))
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def test_decode_cell_is_not_ported(runs):
    (rec,), stdout = runs["decode"]
    assert rec["status"] == "not_ported"
    assert "decode across ranks" in rec["reason"]
    assert "item 12e-ii" in rec["reason"]
    assert rec["chips"] == 256 and rec["mesh"] == "single_pod_16x16"
    assert "1 not_ported, 0 fail" in stdout


def test_skip_cell_documented(runs):
    """long_500k on a full-attention arch records the twin's skip."""
    (rec,), _ = runs["long"]
    assert rec["status"] == "skip"
    assert "sub-quadratic" in rec["reason"]


def _check_ok(rec, n_micro):
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 256 and rec["mesh"] == "single_pod_16x16"
    assert rec["n_micro"] == n_micro
    t = rec["roofline"]
    for k in ("compute_s", "memory_s", "collective_s", "bound_s",
              "useful_flops_ratio", "roofline_fraction"):
        assert t[k] > 0, k
    assert t["dominant"] in ("compute", "memory", "collective")
    assert t["bound_s"] == max(t["compute_s"], t["memory_s"],
                               t["collective_s"])
    m = rec["memory"]
    assert m["total_bytes"] == m["argument_bytes"] + m["temp_bytes"]
    assert 0 < m["output_bytes"] <= m["argument_bytes"]
    c = rec["cost"]
    assert 0 < c["dot_flops"] <= c["flops_per_device"]
    # remat recomputes the forward, and 6ND counts no attention scores
    assert t["useful_flops_ratio"] < 1.0
    assert set(rec["collectives"]["counts"]) >= {"all-gather",
                                                 "reduce-scatter",
                                                 "all-reduce"}


def test_train_cell_runs_one_microbatch(runs):
    (rec,), stdout = runs["train"]
    _check_ok(rec, n_micro=1)
    assert rec["variant"] == "micro_rows=16"
    assert "1 ok, 0 skip, 0 not_ported, 0 fail" in stdout


def test_phase15_cell_counts_what_the_ranks_measured(runs):
    """granite-3-2b whole on (4, 1), B 8 x S 512, micro_rows 2: the
    collectives four NCCL ranks counted in ``process_group.BYTES`` /
    ``CALLS`` (PERF.md, phase 15), to the byte."""
    rec = runs["phase15"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_micro"] == 1 and rec["chips"] == 4
    col = rec["collectives"]
    assert col["counts"] == {"all-gather": 563, "reduce-scatter": 282,
                             "all-reduce": 5}
    buf = col["buffer_bytes_by_kind"]
    assert buf == {"all-gather": 10334801920, "reduce-scatter": 5268070400,
                   "all-reduce": 663560}
    assert round(buf["all-gather"] / 1e9, 3) == 10.335
    assert round(buf["reduce-scatter"] / 1e9, 3) == 5.268
    assert round(buf["all-reduce"] / 1e6, 2) == 0.66
    # the twin's convention: a reduce-scatter's scattered result
    assert col["bytes_by_kind"]["reduce-scatter"] * 4 == buf[
        "reduce-scatter"]
    assert col["bytes_by_kind"]["all-gather"] == buf["all-gather"]


@pytest.mark.parametrize("arch,shape,multi", OTHERS)
def test_no_cell_fails(runs, arch, shape, multi):
    """Every other cell of ``--arch all --shape all --mesh both``: long
    contexts on a full-attention arch skip with the twin's reason, the
    rest name item 12e-ii (prefill, decode, the families the rank step
    does not run, the pod axis, llama4-scout's 40 heads over 16 model
    ranks)."""
    r = runs["others"][f"{arch}/{shape}/{multi}"]
    assert r["mesh"] == ("multi_pod_2x16x16" if multi
                         else "single_pod_16x16")
    assert r["status"] in ("skip", "not_ported"), r.get("traceback")
    if r["status"] == "skip":
        assert shape == "long_500k"
        assert "sub-quadratic" in r["reason"]
        return
    assert "item 12e-ii" in r["reason"]
    if SHAPES[shape].kind != "train":
        assert f"{SHAPES[shape].kind} across ranks" in r["reason"]
    elif multi and arch in RUNS_OK | {"llama4-scout-17b-a16e"}:
        assert "the train step of a mesh with a pod axis" in r["reason"]
    elif arch == "llama4-scout-17b-a16e":
        assert "40 heads over 16 model ranks" in r["reason"]


@pytest.mark.slow
def test_train_cell_default_micro_rows(tmp_path):
    """The production cell as the twin runs it: 16 microbatches of one
    row on each of 16 data ranks."""
    out = tmp_path / "dryrun.json"
    proc = subprocess.Popen(_cli(out, "--arch", "granite-3-2b", "--shape",
                                 "train_4k"), env=_env(), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    _wait(proc, timeout=1200)
    with open(out) as f:
        (rec,) = json.load(f)
    _check_ok(rec, n_micro=16)
    assert rec["variant"] is None
