"""The port's kernel bench (``repro_torch.benchmarks.kernel_bench``) on
the CPU, against the JAX bench (``benchmarks/kernel_bench.py``).

Both benches draw their rasters from ``np.random.default_rng(0)`` in the
same order, so their accounting records (weight blocks touched, SOPs, the
fused-traffic cross-check, active source blocks) must be equal field for
field; only timings and backend names differ. The port's document must
load through the unchanged ``scripts/bench_compare.py``.
"""

import json
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))
sys.path.insert(0, str(REPO))

import bench_compare  # noqa: E402
from benchmarks import kernel_bench as jbench  # noqa: E402
from repro_torch.bench_schema import (AXIS_DEFAULTS,  # noqa: E402
                                     SCHEMA_VERSION)
from repro_torch.benchmarks import kernel_bench as tbench  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

ACCOUNTING = ("event_gating", "event_gating_serving", "fusion_traffic",
              "fusion_serving", "accounting")
TIMING_FIELDS = ("us_per_call", "steps_per_s", "backend")
SWEEP = ["--sparsity", "0.05", "--fuse-steps", "1,2"]


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    """(port document, JAX document, port launch counts before, after)."""
    tmp = tmp_path_factory.mktemp("bench")
    before = dict(tops.LAUNCHES)
    tbench.main(["--device", "cpu", "--backend", "cuda", *SWEEP, "--json",
                 str(tmp / "torch.json")])
    after = dict(tops.LAUNCHES)
    jbench.main(["--backend", "reference", *SWEEP, "--json",
                 str(tmp / "jax.json")])
    return (json.loads((tmp / "torch.json").read_text()),
            json.loads((tmp / "jax.json").read_text()), before, after)


def _accounting(doc, kind):
    recs = sorted((r for r in doc["results"] if r["kind"] == kind),
                  key=lambda r: r["name"])
    return [{k: v for k, v in r.items() if k not in TIMING_FIELDS}
            for r in recs]


@pytest.mark.parametrize("kind", ACCOUNTING)
def test_accounting_records_equal_the_jax_bench(docs, kind):
    port, jax_doc, _, _ = docs
    got, want = _accounting(port, kind), _accounting(jax_doc, kind)
    assert want, f"the JAX bench wrote no {kind} record"
    assert got == want


def test_document_is_schema_2_with_every_axis(docs):
    port = docs[0]
    meta = port["metadata"]
    assert meta["schema"] == SCHEMA_VERSION == 2
    assert meta["device"] == "cpu" and meta["backend_platform"] == "cpu"
    assert meta["torch_version"] == torch.__version__
    assert all(set(AXIS_DEFAULTS) <= set(r) for r in port["results"])
    names = {r["name"] for r in port["results"]}
    assert {"engine/timestep_cuda_d1", "kernel/spike_timestep_fused",
            "kernel/spike_timestep_ref", "kernel/lif_step",
            "kernel/poisson_encode", "fusion/timestep_cuda_K2_s0.05",
            "gating/timestep_cuda_per-example_s0.05"} <= names
    timed = [r for r in port["results"] if r["kind"] in ("kernel",
                                                         "engine_scan")]
    assert all(r["us_per_call"] > 0 for r in timed)


def test_document_loads_through_bench_compare(docs, tmp_path):
    path = tmp_path / "BENCH_torch.json"
    path.write_text(json.dumps(docs[0]))
    label, records = bench_compare.load_doc(path)
    assert len(records) == len(docs[0]["results"])
    findings = bench_compare.compare([(label, records), (label, records)])
    assert findings and all(f["ok"] for f in findings)


def test_cpu_bench_launches_no_kernel(docs):
    _, _, before, after = docs
    assert after == before  # the plain versions ran


@pytest.mark.parametrize("argv,what", [
    (["--mesh", "2x2"], "requires --devices"),
    (["--devices", "4", "--mesh", "3x1"], "does not cover"),
    (["--devices", "4", "--mesh", "2by2"], "must look like")])
def test_unported_modes_raise_pointed_exits(argv, what):
    """Every mode is ported; a mesh flag the JAX bench refuses is refused
    with its message."""
    with pytest.raises(SystemExit, match=what):
        tbench.main(["--device", "cpu", *argv])


# --------------------------------------------------------------------------
# the front-door modes: --async, --qos, --migrate, --obs-overhead
# --------------------------------------------------------------------------

FRONT_DOOR = ("async_frontend", "qos_frontend")


@pytest.fixture(scope="module")
def modes(tmp_path_factory):
    """The port's front-door modes through its ``main`` on the CPU, and
    the JAX bench's same sections on its reference backend."""
    from benchmarks import common as jcommon

    tmp = tmp_path_factory.mktemp("modes")
    tbench.main(["--device", "cpu", "--backend", "cuda", "--async", "--qos",
                 "--migrate", "--obs-overhead", "--json",
                 str(tmp / "torch.json")])
    jcommon.start_recording()
    for section in (jbench.bench_async_frontend, jbench.bench_qos_frontend,
                    jbench.bench_migration):
        section(["reference"], activity=0.05)
    jcommon.write_json(str(tmp / "jax.json"), bench="kernel_bench")
    return (json.loads((tmp / "torch.json").read_text()),
            json.loads((tmp / "jax.json").read_text()))


def _front_door(doc, kind):
    recs = sorted((r for r in doc["results"] if r["kind"] == kind),
                  key=lambda r: r["name"])
    return [{k: (v.replace(f"_{r['backend']}_", "_") if k == "name" else v)
             for k, v in r.items() if k not in TIMING_FIELDS}
            for r in recs]


@pytest.mark.parametrize("kind", FRONT_DOOR)
def test_front_door_records_equal_the_jax_bench(modes, kind):
    port, jax_doc = modes
    got, want = _front_door(port, kind), _front_door(jax_doc, kind)
    assert want and got == want


def test_migration_and_obs_records(modes):
    port, jax_doc = modes
    mig = [r for r in port["results"] if r["kind"] == "migration"]
    jmig = [r for r in jax_doc["results"] if r["kind"] == "migration"]
    assert len(mig) == len(jmig) == 1
    assert (mig[0]["blob_bytes"], mig[0]["n_slots"]) == (
        jmig[0]["blob_bytes"], jmig[0]["n_slots"])
    assert mig[0]["snapshot_us"] > 0 and mig[0]["feed_quantum_us"] > 0
    obs = [r for r in port["results"] if r["kind"] == "obs_overhead"]
    assert len(obs) == 1 and obs[0]["batch"] == 8
    assert obs[0]["bare_us_per_step"] > 0
    args = port["metadata"]["args"]
    assert args["async"] and args["qos"] and args["migrate"]
    assert args["obs_overhead"] and port["metadata"]["schema"] == 2


def test_bad_sweep_lists_exit():
    with pytest.raises(SystemExit, match="--fuse-steps"):
        tbench.main(["--device", "cpu", "--fuse-steps", "0"])
    with pytest.raises(SystemExit, match="--sparsity"):
        tbench.main(["--device", "cpu", "--sparsity", "x"])


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tbench.main([])
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tbench.main(["--device", "cuda", "--backend", "reference"])
