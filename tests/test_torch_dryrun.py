"""The port's dry-run: one rank's step on fake tensors under the fake
process group, against the counts the ranks measured and the JAX
dry-run's statuses.

Twin of ``tests/test_dryrun_integration.py``. Every run joins a process
group, so each is a subprocess (``python -m repro_torch.launch.dryrun``
or a script calling ``run_cell``), all started together by one module
fixture with ``--device cpu`` (a fake tensor moved to ``cuda`` raises on
a torch built without CUDA):

* granite-3-2b ``decode_32k`` is ``ok`` (one decode step of a rank on
  its cache shard: slots over ``model``, rows over ``data``),
  granite-20b ``long_500k`` a ``skip`` with the twin's reason, and
  granite-3-2b ``train_4k`` ``ok`` on the ``(16, 16)`` mesh at
  ``micro_rows`` 16 and on the ``(2, 16, 16)`` mesh at ``micro_rows`` 8
  (one microbatch each): 256 or 512 chips, positive terms, a dominant
  one, and on the pod mesh half the rows and the gradients' all-reduce
  over ``pod``;
* chip_smoke's phase 15 cell, granite-3-2b whole on ``(4, 1)``, B 8 x S
  512, ``micro_rows`` 2: the calls and bytes four H100 ranks measured
  (563 / 282 / 5 calls; 10.335 GB / 5.268 GB / 0.66 MB, the exact
  integers pinned);
* every cell of ``--arch all --shape all --mesh both`` but the eight
  ``train_4k`` cells that run never ``fail`` (one case a cell): the
  prefill, decode and long cells of granite-3-2b, granite-20b,
  mixtral-8x7b and llama4-scout (its 40 query heads split over 16 model
  ranks) on ``(16, 16)`` and ``(2, 16, 16)`` are ``ok``, the rest
  ``skip`` or ``not_ported`` (ROADMAP item 12e-ii): 26 ok, 12 skip, 42
  not_ported and 0 fail in all. The serving cells that run go in a
  subprocess an arch and a mesh, beside the others.

The default ``micro_rows`` (16 microbatches, ~8 min on the CPU) is
marked ``slow``, as the twin marks its own cells; granite-20b's,
mixtral-8x7b's and llama4-scout's ``train_4k`` cells run in the CLI's
run alone.
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
RUNS_OK = {"granite-3-2b", "granite-20b", "mixtral-8x7b",
           "llama4-scout-17b-a16e"}
# every cell of --arch all --shape all --mesh both but the eight train_4k
# cells that run (RUNS_OK's, on both meshes)
OTHERS = [(arch, shape, multi) for arch in configs.list_archs()
          for shape in SHAPES for multi in (False, True)
          if not (shape == "train_4k" and arch in RUNS_OK)]
# the prefill, decode and long cells that run across ranks, on (16, 16)
# and (2, 16, 16)
SERVE_OK = {(arch, shape, multi) for arch in RUNS_OK
            for shape in ("prefill_32k", "decode_32k")
            for multi in (False, True)} | {
    ("mixtral-8x7b", "long_500k", multi) for multi in (False, True)}

# the phase 15 cell (with argv[2] "phase15"), and the records of the
# cells in argv[1]
_SCRIPT = r"""
import json, sys
from repro_torch.configs.shapes import Shape
from repro_torch.launch import dryrun

out = {}
if sys.argv[2] == "phase15":
    out["phase15"] = dryrun.run_cell(
        "granite-3-2b", Shape("ranks_whole", 512, 8, "train"), mesh=(4, 1),
        variant="micro_rows=2", device="cpu", verbose=False)
out["others"] = {
    f"{arch}/{shape}/{multi}": dryrun.run_cell(
        arch, shape, multi_pod=multi, device="cpu", verbose=False)
    for arch, shape, multi in json.loads(sys.argv[1])}
print(json.dumps(out))
"""


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                OMP_NUM_THREADS="1")


def _cli(out, *args, mesh="single"):
    return [sys.executable, "-m", "repro_torch.launch.dryrun", "--device",
            "cpu", "--mesh", mesh, "--out", str(out), *args]


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
        "train_pod": ["--arch", "granite-3-2b", "--shape", "train_4k",
                      "--variant", "micro_rows=8"],
    }
    procs = {k: subprocess.Popen(
        _cli(tmp / f"{k}.json", *a,
             mesh="multi" if k == "train_pod" else "single"), env=_env(),
        text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for k, a in cli.items()}
    groups = {"script": [c for c in OTHERS if c not in SERVE_OK]}
    for arch in sorted(RUNS_OK):
        for multi in (False, True):
            groups[f"{arch}/{multi}"] = [
                c for c in OTHERS if c in SERVE_OK and c[0] == arch
                and c[2] == multi]
    for k, cells in groups.items():
        procs[k] = subprocess.Popen(
            [sys.executable, "-c", _SCRIPT, json.dumps(cells),
             "phase15" if k == "script" else "-"], env=_env(), text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        out = {"others": {}}
        for k in cli:
            stdout = _wait(procs[k])
            with open(tmp / f"{k}.json") as f:
                out[k] = (json.load(f), stdout)
        for k in groups:
            got = json.loads(_wait(procs[k]).splitlines()[-1])
            out["others"].update(got.pop("others"))
            out.update(got)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def test_decode_cell_is_not_ported(runs):
    """granite-3-2b's ``decode_32k`` cell was refused until prefill and
    decode ran across ranks (the name is kept); it is ``ok`` now: one
    decode step of rank 0 on its cache shard, gathering its layers over
    ``data`` and combining the attention over ``model``, with no
    gradient's reduce-scatter."""
    (rec,), stdout = runs["decode"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["chips"] == 256 and rec["mesh"] == "single_pod_16x16"
    assert rec["n_micro"] == 1
    assert "1 ok, 0 skip, 0 not_ported, 0 fail" in stdout
    _check_serve(rec)


def _check_serve(rec):
    """A prefill or decode cell's record: positive roofline terms and
    one dominant, gathers over ``data`` and sums over ``model`` and no
    reduce-scatter (nothing flows back)."""
    assert rec["status"] == "ok", rec.get("traceback")
    t = rec["roofline"]
    for k in ("compute_s", "memory_s", "collective_s", "bound_s",
              "useful_flops_ratio"):
        assert t[k] > 0, k
    assert t["dominant"] in ("compute", "memory", "collective")
    m = rec["memory"]
    assert m["total_bytes"] == m["argument_bytes"] + m["temp_bytes"]
    assert 0 < rec["cost"]["dot_flops"] <= rec["cost"]["flops_per_device"]
    assert set(rec["collectives"]["counts"]) == {"all-gather",
                                                 "all-reduce"}


def test_skip_cell_documented(runs):
    """long_500k on a full-attention arch records the twin's skip."""
    (rec,), _ = runs["long"]
    assert rec["status"] == "skip"
    assert "sub-quadratic" in rec["reason"]


def _check_ok(rec, n_micro, multi=False):
    assert rec["status"] == "ok", rec.get("traceback")
    assert (rec["chips"], rec["mesh"]) == (
        (512, "multi_pod_2x16x16") if multi else (256, "single_pod_16x16"))
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


def test_pod_train_cell_runs_one_microbatch(runs):
    """granite-3-2b ``train_4k`` on ``(2, 16, 16)`` at ``micro_rows`` 8:
    one microbatch of 8 rows a rank (256 over 32 batch shards), the same
    param shards as on ``(16, 16)`` (the gathers and reduce-scatters
    over ``data`` alike, call for call), and each gradient leaf
    all-reduced over ``pod``: more all-reduces than on ``(16, 16)``."""
    (rec,), stdout = runs["train_pod"]
    _check_ok(rec, n_micro=1, multi=True)
    assert rec["variant"] == "micro_rows=8"
    assert "1 ok, 0 skip, 0 not_ported, 0 fail" in stdout
    assert 0 <= rec["groups_s"] < 60
    (flat,), _ = runs["train"]
    pod, one = rec["collectives"]["counts"], flat["collectives"]["counts"]
    for kind in ("all-gather", "reduce-scatter"):
        assert pod[kind] == one[kind], kind
    assert pod["all-reduce"] > one["all-reduce"]
    assert rec["memory"]["argument_bytes"] == flat["memory"][
        "argument_bytes"]


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
    """Every other cell of ``--arch all --shape all --mesh both``: the
    prefill, decode and long cells of the dense GQA / MQA and MoE archs
    on ``(16, 16)`` and ``(2, 16, 16)`` run (``SERVE_OK``: 18, llama4-
    scout's with 40 query heads over 16 model ranks among them; with the
    eight train cells 26 ok), long contexts on a full-attention arch
    skip with the twin's reason (12), the rest name item 12e-ii (42: the
    families the rank steps do not run, on either mesh)."""
    r = runs["others"][f"{arch}/{shape}/{multi}"]
    assert r["mesh"] == ("multi_pod_2x16x16" if multi
                         else "single_pod_16x16")
    kind = SHAPES[shape].kind
    if (arch, shape, multi) in SERVE_OK:
        _check_serve(r)
        assert r["kind"] == kind and r["n_micro"] == 1
        return
    assert r["status"] in ("skip", "not_ported"), r.get("traceback")
    if r["status"] == "skip":
        assert shape == "long_500k"
        assert "sub-quadratic" in r["reason"]
        return
    assert "item 12e-ii" in r["reason"]
    assert arch not in RUNS_OK
    assert "pod" not in r["reason"]
    assert f"the {kind} step of " in r["reason"]


def test_cell_statuses_add_up():
    """The 80 cells: 26 ok, 12 skip, 42 not_ported (as pinned above): a
    mesh with a pod axis runs the dense and MoE families' cells as the
    ``(16, 16)`` mesh does, and refuses the others' as it does."""
    skip = [c for c in OTHERS if c[1] == "long_500k"
            and not configs.get_arch(c[0]).CONFIG.subquadratic]
    train = 2 * len(RUNS_OK)
    assert len(OTHERS) + train == 80
    assert (train + len(SERVE_OK), len(skip),
            len(OTHERS) - len(SERVE_OK) - len(skip)) == (26, 12, 42)
    for multi in (False, True):
        assert {(a, s) for a, s, m in SERVE_OK if m == multi} == {
            (a, s) for a, s, m in SERVE_OK if m != multi}


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
