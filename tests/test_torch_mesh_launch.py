"""The launchers' mesh modes on the CPU: the port's ``serve_snn`` and
``kernel_bench`` with ``--devices`` / ``--mesh``, its ``ShardLoadWatch``,
and one multi-device JAX run for reference.

The port's mesh runs on logical host shards in this process. JAX's
launcher and bench are never driven with ``--devices > 1`` here: faking
JAX host devices means rewriting ``XLA_FLAGS`` before JAX starts, which
this process cannot do. The one multi-device JAX run is a subprocess with
its own environment and a time limit.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from repro.launch import serve_snn as jserve  # noqa: E402
from repro.obs import MetricsRegistry as JRegistry  # noqa: E402
from repro.obs import SpanTracer as JTracer  # noqa: E402
from repro.obs.timeline import mesh_lanes as jmesh_lanes  # noqa: E402
from repro_torch.benchmarks import kernel_bench as tbench  # noqa: E402
from repro_torch.core.engine import DecaySpec, SpikeEngine  # noqa: E402
from repro_torch.distributed.spike_mesh import make_spike_mesh  # noqa: E402
from repro_torch.launch import serve_snn as tserve  # noqa: E402
from repro_torch.obs import MetricsRegistry as TRegistry  # noqa: E402
from repro_torch.obs import SpanTracer as TTracer  # noqa: E402
from repro_torch.obs.timeline import mesh_lanes as tmesh_lanes  # noqa: E402
from repro_torch.serving.snn import SpikeServer  # noqa: E402

SERVE_ARGV = ["--device", "cpu", "--streams", "7", "--steps-per-stream",
              "12", "--n-inputs", "16", "--n-neurons", "24", "--n-slots",
              "3", "--chunk", "4"]
# fields of a sync summary that do not depend on the clock
SYNC_FIELDS = ("mode", "streams_done", "steps", "rounds", "n_slots",
               "sparsity", "event_gate", "server", "energy")


def _serve(monkeypatch, tmp_path, argv, tag):
    """The port launcher's summary for ``argv`` and every raster its
    server's ``feed`` returned, in order."""
    fed = []
    feed = SpikeServer.feed

    def recording_feed(self, inputs):
        out = feed(self, inputs)
        fed.append({u: r["spikes"].copy() for u, r in out.items()})
        return out

    monkeypatch.setattr(SpikeServer, "feed", recording_feed)
    path = tmp_path / f"{tag}.json"
    tserve.main([*SERVE_ARGV, *argv, "--json-summary", str(path)])
    monkeypatch.setattr(SpikeServer, "feed", feed)
    return json.loads(path.read_text()), fed


@pytest.mark.parametrize("extra", [
    ["--backend", "reference"],
    ["--backend", "cuda", "--fuse-steps", "8", "--gate", "per-example"],
    ["--backend", "cuda-f32", "--drain", "2"],
], ids=["reference", "cuda-K8-per-example", "cuda-f32-drain"])
@pytest.mark.parametrize("mesh", [["--devices", "4", "--mesh", "2x2"],
                                  ["--devices", "8"]], ids=["2x2", "8"])
def test_serve_snn_mesh_equals_unsharded(monkeypatch, tmp_path, extra,
                                         mesh):
    """``--devices 4 --mesh 2x2`` (and the default 2x4 split of 8) serve
    the same rasters and counts as ``--devices 1``."""
    one, fed_one = _serve(monkeypatch, tmp_path, extra, "d1")
    many, fed_many = _serve(monkeypatch, tmp_path, [*extra, *mesh], "dn")
    assert len(fed_one) == len(fed_many) > 0
    for a, b in zip(fed_one, fed_many):
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[u], b[u]) for u in a)
    for key in SYNC_FIELDS:
        assert many[key] == one[key], key
    n = int(mesh[1])
    kn = 2
    assert many["mesh"] == {"neuron": kn, "batch": n // kn, "shards": n,
                            "physical_devices": ["cpu"]}
    assert one["mesh"] is None
    assert many["meta"]["axes"]["devices"] == n
    rep = many["straggler"]
    assert rep["n_shards"] == n // kn and rep["dispatches"] == one[
        "straggler"]["dispatches"]
    assert len(rep["flag_counts"]) == n // kn
    assert sum(rep["suggested_slot_split"]) == 3
    assert many["launches"]["spike_timestep_fused"] == 0


def test_serve_snn_async_on_a_mesh(monkeypatch, tmp_path, capsys):
    argv = ["--backend", "cuda", "--async", "--arrival-rate", "200",
            "--queue-capacity", "64", "--qos", "hi=2:4,bg=0:1:2",
            "--qos-preempt", "--burst", "hi", "--burst-rate", "1000"]
    one, _ = _serve(monkeypatch, tmp_path, argv, "a1")
    many, _ = _serve(monkeypatch, tmp_path,
                     [*argv, "--devices", "4", "--mesh", "2x2"], "a4")
    assert "sync-mode only" in capsys.readouterr().out
    for key in ("mode", "requests", "policy", "queue_capacity", "qos",
                "burst", "steps"):
        assert many[key] == one[key], key
    assert many["frontend"]["counts"]["done"] == 7
    assert many["server"]["sops"] == one["server"]["sops"]
    assert many["server"]["spikes"] == one["server"]["spikes"]


def test_serve_snn_summary_fields_equal_jax_at_devices_1(tmp_path):
    """At ``--devices 1`` the port's summary carries every field of the
    JAX launcher's, with equal values where the clock does not enter."""
    argv = SERVE_ARGV[2:] + ["--devices", "1"]
    jserve.main([*argv, "--json-summary", str(tmp_path / "j.json")])
    tserve.main(["--device", "cpu", *argv, "--json-summary",
                 str(tmp_path / "t.json")])
    want = json.loads((tmp_path / "j.json").read_text())
    got = json.loads((tmp_path / "t.json").read_text())
    assert set(want) <= set(got)
    for key in SYNC_FIELDS:
        assert got[key] == want[key], key
    assert got["meta"]["axes"] == want["meta"]["axes"]
    assert set(got["straggler"]) == set(want["straggler"])
    for key in ("dispatches", "n_shards"):
        assert got["straggler"][key] == want["straggler"][key]
    assert set(got["straggler"]["dispatch_ms"]) == {"p50", "p95"}


# --------------------------------------------------------------------------
# ShardLoadWatch: one scripted sequence through both classes
# --------------------------------------------------------------------------

def _script(n_slots, slots_per_shard, n=40, seed=0):
    """(dt, live_slots) per dispatch: every slot live at first, then the
    first shard's slots stay busy while the rest go idle, so that shard's
    attributed time stretches (a straggler on a 4-way batch axis)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i < 12:
            live = list(range(n_slots))
        else:
            live = list(range(slots_per_shard))
            if rng.random() < 0.3 and slots_per_shard < n_slots:
                live.append(int(rng.integers(slots_per_shard, n_slots)))
        out.append((0.004 + 0.002 * rng.random(), sorted(set(live))))
    return out


@pytest.mark.parametrize("n_shards,n_slots", [(1, 8), (2, 8), (4, 8),
                                              (2, 5), (4, 6)])
@pytest.mark.parametrize("instrumented", [True, False])
def test_shard_load_watch_matches_jax(n_shards, n_slots, instrumented):
    clock = iter(range(10**6)).__next__
    if instrumented:
        jr, tr = JRegistry(), TRegistry()
        jt, tt = JTracer(clock=clock), TTracer(clock=clock)
    else:
        jr = tr = jt = tt = None
    jw = jserve.ShardLoadWatch(n_shards, n_slots, registry=jr, tracer=jt)
    tw = tserve.ShardLoadWatch(n_shards, n_slots, registry=tr, tracer=tt)
    assert tw.slots_per_shard == jw.slots_per_shard
    for dt, live in _script(n_slots, tw.slots_per_shard):
        jw.observe(dt, live)
        tw.observe(dt, live)
        assert np.array_equal(jw.persistent_flags(), tw.persistent_flags())
    assert tw.report() == jw.report()
    assert tw.flag_counts.tolist() == jw.flag_counts.tolist()
    if instrumented:
        jg = jr.gauge("snn_shard_step_seconds")
        tg = tr.gauge("snn_shard_step_seconds")
        for shard in range(n_shards):
            assert (tg.labels(shard=shard).value
                    == jg.labels(shard=shard).value)
        assert tmesh_lanes(tt) == jmesh_lanes(jt)
        assert tmesh_lanes(tt)["n_dispatches"] == 40
    if (n_shards, n_slots) == (4, 8):
        assert tw.report()["persistent"] == [0]  # the busy shard


def test_watch_rebalance_moves_streams_off_a_flagged_shard():
    """The launcher's straggler pass: ``rebalance_streams`` over a mesh
    server moves streams off the flagged shard bit for bit."""
    from repro_torch.serving.connector import rebalance_streams

    rng = np.random.default_rng(3)
    W = ((rng.random((40, 24)) < 0.3)
         * rng.integers(-2**16, 2**16, (40, 24))).astype(np.int32)
    plain = SpikeEngine(W, 16, decay=DecaySpec.shift(0.25),
                        threshold_raw=1 << 16, reset_mode="zero",
                        backend="cuda", device="cpu")
    ext = (rng.random((10, 16)) < 0.4).astype(np.int32)
    outs = []
    for mesh in (None, make_spike_mesh(2, 2, devices=["cpu"] * 4)):
        srv = SpikeServer(plain, n_slots=6, chunk_steps=3, device="cpu",
                          mesh=mesh)
        for u in range(3):          # slots 0..2: all on batch shard 0
            srv.attach(u)
        first = srv.feed({u: ext[:4] for u in range(3)})
        if mesh is not None:
            moves = rebalance_streams(srv, np.array([True, False]),
                                      slots_per_shard=3)
            assert moves and all(to >= 3 for _, _, to in moves)
        second = srv.feed({u: ext[4:] for u in range(3)})
        outs.append({u: np.concatenate([first[u]["spikes"],
                                        second[u]["spikes"]])
                     for u in range(3)})
    assert all(np.array_equal(outs[0][u], outs[1][u]) for u in range(3))


# --------------------------------------------------------------------------
# the bench's mesh records, and one real multi-device JAX run
# --------------------------------------------------------------------------

JAX_MESH_RUN = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
assert len(jax.devices()) == 4, jax.devices()
from benchmarks import common, kernel_bench as kb
from repro.core.engine import DecaySpec, SpikeEngine
from repro.distributed.spike_mesh import make_spike_mesh

out_npz, out_json = sys.argv[1], sys.argv[2]
mesh = make_spike_mesh(2, 2)
arrays = {}
for i, (B, n_in, n_phys, reset) in enumerate(
        [(3, 37, 48, "subtract"), (5, 200, 130, "zero"), (1, 1, 1, "hold")]):
    rng = np.random.default_rng(100 + i)
    S = n_in + n_phys
    W = ((rng.random((S, n_phys)) < 0.3)
         * rng.integers(-2**16, 2**16, (S, n_phys))).astype(np.int32)
    ext = (rng.random((6, B, n_in)) < 0.35).astype(np.int32)
    act = (rng.random((6, B)) < 0.6).astype(np.int32)
    e = SpikeEngine(W, n_in, decay=DecaySpec.shift(0.25),
                    threshold_raw=1 << 16, reset_mode=reset).to_mesh(mesh)
    o = e.run(jnp.asarray(ext))
    c, s = e.step_chunk(e.init_carry(B), jnp.asarray(ext), jnp.asarray(act))
    arrays.update({f"W{i}": W, f"ext{i}": ext, f"act{i}": act,
                   f"spikes{i}": np.asarray(o["spikes"]),
                   f"v{i}": np.asarray(o["v_final"]),
                   f"chunk{i}": np.asarray(s), f"cv{i}": np.asarray(c["v"])})
np.savez(out_npz, **arrays)
kb.time_call = lambda fn, *a, **k: (jax.block_until_ready(fn(*a)), 1.0)[1]
common.start_recording()
kb.bench_engine_backends(["reference"], batch=8, activity=0.05, mesh=mesh)
kb.bench_streaming(["reference"], n_slots=8, activity=0.05, mesh=mesh)
common.write_json(out_json, bench="kernel_bench")
print("OK")
"""


@pytest.fixture(scope="module")
def jax_mesh_run(tmp_path_factory):
    """JAX's MeshSpikeEngine and bench sections on a real 2 x 2 mesh of
    four faked host devices, in a subprocess: its environment is a
    filtered copy of this one, so nothing here is changed."""
    tmp = tmp_path_factory.mktemp("jaxmesh")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env.update(PYTHONPATH=os.pathsep.join([str(REPO / "src"), str(REPO)]),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_MESH_RUN, str(tmp / "m.npz"),
         str(tmp / "b.json")], env=env, cwd=str(REPO), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0 and "OK" in proc.stdout, (
        f"rc={proc.returncode}\n{proc.stderr[-3000:]}")
    return (dict(np.load(tmp / "m.npz")),
            json.loads((tmp / "b.json").read_text()))


@pytest.mark.parametrize("case", [0, 1, 2])
@pytest.mark.parametrize("backend", ["reference", "cuda", "cuda-f32"])
def test_port_mesh_equals_jax_on_four_devices(jax_mesh_run, case, backend):
    arrays, _ = jax_mesh_run
    W, ext, act = (arrays[f"{k}{case}"] for k in ("W", "ext", "act"))
    reset = ("subtract", "zero", "hold")[case]
    e = SpikeEngine(W, ext.shape[2], decay=DecaySpec.shift(0.25),
                    threshold_raw=1 << 16, reset_mode=reset,
                    backend=backend, device="cpu").to_mesh(
        make_spike_mesh(2, 2, devices=["cpu"] * 4))
    o = e.run(ext)
    assert np.array_equal(o["spikes"].numpy(), arrays[f"spikes{case}"])
    assert np.array_equal(o["v_final"].numpy(), arrays[f"v{case}"])
    c, s = e.step_chunk(e.init_carry(ext.shape[1]), ext, act)
    assert np.array_equal(s.numpy(), arrays[f"chunk{case}"])
    assert np.array_equal(c["v"].numpy(), arrays[f"cv{case}"])


def test_bench_mesh_records_carry_the_jax_names_and_axes(jax_mesh_run,
                                                         tmp_path):
    """``kernel_bench --devices 4 --mesh 2x2`` writes the ``_d4`` engine
    and streaming records of the JAX bench on a 2 x 2 mesh: same names,
    same axes and info; only the times differ."""
    _, jdoc = jax_mesh_run
    tbench.main(["--device", "cpu", "--backend", "reference", "--devices",
                 "4", "--mesh", "2x2", "--streaming", "--json",
                 str(tmp_path / "t.json")])
    tdoc = json.loads((tmp_path / "t.json").read_text())

    def d4(doc):
        return sorted(({k: v for k, v in r.items()
                        if k not in ("us_per_call", "steps_per_s")}
                       for r in doc["results"] if r["name"].endswith("_d4")),
                      key=lambda r: r["name"])

    want = d4(jdoc)
    assert [r["name"] for r in want] == [
        "engine/timestep_reference_d4",
        "streaming/batch_scan_reference_d4",
        "streaming/feed_reference_occ0.25_d4",
        "streaming/feed_reference_occ1_d4"]
    assert d4(tdoc) == want
    assert tdoc["metadata"]["args"]["devices"] == 4
    assert {"engine/timestep_reference_d1",
            "streaming/feed_reference_occ1_d1"} <= {
        r["name"] for r in tdoc["results"]}
