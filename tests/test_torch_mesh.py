"""The port's mesh (``repro_torch.distributed.spike_mesh``) against the
JAX package, on logical CPU shards.

A port mesh here is a ``(neuron, batch)`` grid of host entries (1x1,
1x2, 2x1, 2x2, 2x4), all on the one CPU: the counterpart of JAX's faked
host devices, with no process group and no environment variable. Oracles:

* JAX's single-device ``SpikeEngine`` on ``"reference"``, which
  ``tests/test_spike_mesh.py`` pins byte-equal to JAX's own sharded engine;
* JAX's ``MeshSpikeEngine`` on ``make_spike_mesh(1, 1)``, which runs on the
  one CPU device through ``shard_map``.

Every port backend ("reference", "cuda", "cuda-f32") runs on the CPU, the
kernel backends through the kernels' plain versions. Outputs are compared
with ``np.array_equal`` on int32. The mirrored JAX cases are
``tests/test_spike_mesh.py``, ``test_events.py::test_mesh_engine_keeps_gate``,
``test_fused_steps.py::test_mesh_engine_carries_fuse_steps`` and
``test_carry_migration.py``'s mesh migrations.
"""

import os
import pathlib
import re
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_lm_train import one_torch_thread  # noqa: E402,F401

from repro.core import engine as jeng  # noqa: E402
from repro.core.session import AcceleratorSession as JSession  # noqa: E402
from repro.distributed import spike_mesh as jmesh  # noqa: E402
from repro.serving.snn import SpikeServer as JServer  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.session import AcceleratorSession as TSession  # noqa: E402
from repro_torch.distributed import spike_mesh as tmesh  # noqa: E402
from repro_torch.distributed.spike_mesh import (  # noqa: E402
    MeshCarry, MeshSpikeEngine, SpikeMesh, make_spike_mesh)
from repro_torch.events.aer import dense_to_aer  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving.connector import InMemoryCarryConnector  # noqa: E402
from repro_torch.serving.snn import SpikeServer  # noqa: E402

THRESH = 1 << 16
RESET_MODES = ("zero", "subtract", "hold")
MESHES = [(1, 1), (1, 2), (2, 1), (2, 2), (2, 4)]
MESH_IDS = [f"{kn}x{kb}" for kn, kb in MESHES]
# deliberately ragged (tests/test_spike_mesh.py): neither n_phys nor B
# divides a 2-way mesh axis; n_phys = 130 on 2 neuron shards is 65
# columns a shard
RAGGED_SHAPES = [(3, 37, 48), (1, 1, 1), (5, 200, 130)]


def _mesh(kn, kb) -> SpikeMesh:
    return make_spike_mesh(kn, kb, devices=["cpu"] * (kn * kb))


def _weights(rng, n_in, n_phys, density=0.3, wmax=1 << 16):
    S = n_in + n_phys
    return ((rng.random((S, n_phys)) < density)
            * rng.integers(-wmax, wmax, (S, n_phys))).astype(np.int32)


def _raster(rng, T, B, n_in, p=0.35):
    return (rng.random((T, B, n_in)) < p).astype(np.int32)


def _decays(decay):
    kind, arg = decay
    return getattr(jeng.DecaySpec, kind)(arg), getattr(teng.DecaySpec,
                                                       kind)(arg)


def _pair(W, n_in, *, backend="reference", reset="subtract",
          decay=("shift", 0.25), mesh=(2, 2), gate="batch-tile",
          fuse_steps=1):
    """JAX's single-device reference engine and the port's mesh engine
    on ``backend`` over the same image."""
    jd, td = _decays(decay)
    je = jeng.SpikeEngine(W, n_in, decay=jd, threshold_raw=THRESH,
                          reset_mode=reset)
    te = MeshSpikeEngine(W, n_in, mesh=_mesh(*mesh), decay=td,
                         threshold_raw=THRESH, reset_mode=reset,
                         backend=backend, gate=gate, fuse_steps=fuse_steps)
    return je, te


def _eq(j, t) -> bool:
    t = t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    return t.dtype == j.dtype == np.int32 and np.array_equal(j, t)


def _assert_run_equal(je, te, ext) -> int:
    """Byte-equal run outputs; returns the number of spikes."""
    a, b = je.run(jnp.asarray(ext)), te.run(ext)
    for k in ("spikes", "v_final"):
        assert _eq(a[k], b[k]), k
    return int(b["spikes"].sum())


# --------------------------------------------------------------------------
# construction contracts
# --------------------------------------------------------------------------

def test_make_spike_mesh_validation_matches_jax():
    """Same checks and messages as JAX's ``make_spike_mesh``, over an
    explicit device list of the same length as JAX's one CPU device."""
    one = jax.devices()[:1]
    for kwargs in (dict(neuron=2, batch=2), dict(neuron=0),
                   dict(neuron=1, batch=0), dict(neuron=3, batch=1)):
        with pytest.raises(ValueError) as jerr:
            jmesh.make_spike_mesh(devices=one, **kwargs)
        with pytest.raises(ValueError) as terr:
            make_spike_mesh(devices=["cpu"], **kwargs)
        assert str(terr.value) == str(jerr.value)
    for kn, kb in MESHES:
        mesh = _mesh(kn, kb)
        assert mesh.shape == {"neuron": kn, "batch": kb}
        assert mesh.size == kn * kb
        assert mesh.physical_devices == (torch.device("cpu"),)
    assert (jmesh.make_spike_mesh(1, 1).shape
            == make_spike_mesh(1, 1, devices=["cpu"]).shape)
    # batch=None spreads the rest of the devices over the batch axis
    assert make_spike_mesh(2, devices=["cpu"] * 8).shape == {
        "neuron": 2, "batch": 4}


def test_default_mesh_devices_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default devices work")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_spike_mesh(1, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.ensure_host_devices(4)


@pytest.mark.parametrize("devices,spec", [
    (8, None), (4, None), (2, None), (6, None), (1, None), (3, None),
    (4, "2x2"), (8, "2X4"), (8, "1x8"), (4, "3x1"), (4, "2"), (4, "axb"),
    (4, "0x4"), (4, "2x-2"), (2, "x2")])
def test_parse_mesh_spec_matches_jax(devices, spec):
    try:
        want = jmesh.parse_mesh_spec(devices, spec)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            tmesh.parse_mesh_spec(devices, spec)
        assert str(err.value) == str(e)
    else:
        assert tmesh.parse_mesh_spec(devices, spec) == want


def test_ensure_host_devices_touches_no_environment():
    before = dict(os.environ)
    for n in (1, 2, 4, 8):
        devs = tmesh.ensure_host_devices(n, "cpu")
        assert devs == [torch.device("cpu")] * n
    assert dict(os.environ) == before
    with pytest.raises(ValueError, match=">= 1"):
        tmesh.ensure_host_devices(0, "cpu")


def test_mesh_engine_requires_snn_axes():
    W = _weights(np.random.default_rng(0), 5, 8)
    # a mesh-like object that is not a spike mesh (other axis names)
    wrong = types.SimpleNamespace(devices=((torch.device("cpu"),),),
                                  axis_names=("data", "model"),
                                  shape={"data": 1, "model": 1})
    assert SpikeMesh((("cpu",),)).axis_names == ("neuron", "batch")
    with pytest.raises(ValueError, match="neuron"):
        MeshSpikeEngine(W, 5, mesh=wrong, decay=teng.DecaySpec.shift(0.25),
                        threshold_raw=THRESH, reset_mode="zero")
    with pytest.raises(ValueError, match="rectangular"):
        SpikeMesh((("cpu", "cpu"), ("cpu",)))


@pytest.mark.parametrize("kn,kb", MESHES, ids=MESH_IDS)
def test_to_mesh_is_drop_in(kn, kb):
    """``engine.to_mesh(mesh)`` re-hosts the same program: the same
    config, a ``MeshSpikeEngine``, byte-equal outputs, and the weight
    spec JAX resolves for the same padded image."""
    rng = np.random.default_rng(kn * 10 + kb)
    W = _weights(rng, 37, 48)
    single = teng.SpikeEngine(W, 37, decay=teng.DecaySpec.shift(0.25),
                              threshold_raw=THRESH, reset_mode="hold",
                              backend="cuda", gate="per-example",
                              fuse_steps=8, device="cpu")
    hosted = single.to_mesh(_mesh(kn, kb))
    assert isinstance(hosted, MeshSpikeEngine)
    assert (hosted.reset_mode, hosted.n_phys, hosted.backend, hosted.gate,
            hosted.fuse_steps) == ("hold", 48, "cuda", "per-example", 8)
    assert hosted.device_count == kn * kb and not hosted._use_fused
    # JAX's spec_for reads only mesh.shape: the port's mesh drives it
    from repro.distributed.partition import spec_for as jspec_for

    pp = -(-48 // kn) * kn
    assert hosted._w_spec == tuple(jspec_for(
        ("source", "neuron"), (37 + pp, pp), hosted.mesh, jmesh.SNN_RULES))
    ext = _raster(rng, 5, 3, 37)
    je = jeng.SpikeEngine(W, 37, decay=jeng.DecaySpec.shift(0.25),
                          threshold_raw=THRESH, reset_mode="hold")
    _assert_run_equal(je, hosted, ext)
    _assert_run_equal(je, single, ext)


def test_server_mesh_kwarg_rehosts_engine():
    mesh = _mesh(2, 2)
    W = _weights(np.random.default_rng(1), 37, 48)
    single = teng.SpikeEngine(W, 37, decay=teng.DecaySpec.shift(0.25),
                              threshold_raw=THRESH, reset_mode="zero",
                              device="cpu")
    srv = SpikeServer(single, n_slots=2, chunk_steps=3, mesh=mesh,
                      device="cpu")
    assert isinstance(srv.engine, MeshSpikeEngine)
    assert srv.engine.mesh == mesh and isinstance(srv.carry, MeshCarry)
    # already-mesh engines pass through untouched, whatever ``device``
    srv2 = SpikeServer(srv.engine, n_slots=2, chunk_steps=3, mesh=mesh)
    assert srv2.engine is srv.engine
    srv3 = SpikeServer(srv.engine, n_slots=2, chunk_steps=3)
    assert srv3.engine is srv.engine
    # a re-host keeps the mesh: gate, fusion, device
    assert srv.engine.with_gate("per-example").mesh == mesh
    assert srv.engine.with_fuse_steps(8).mesh == mesh
    assert srv.engine.to_device("cpu") is srv.engine


# --------------------------------------------------------------------------
# the degenerate 1x1 mesh against JAX's own MeshSpikeEngine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("reset", RESET_MODES)
def test_one_by_one_mesh_matches_jax_mesh_engine(reset):
    """JAX's MeshSpikeEngine on make_spike_mesh(1, 1) (shard_map on the
    one CPU device) against the port's 1x1 and 2x2 meshes: run, masked
    step_chunk chains and a single step."""
    rng = np.random.default_rng(7)
    W = _weights(rng, 37, 48)
    jd, td = _decays(("shift", 0.25))
    je = jmesh.MeshSpikeEngine(W, 37, mesh=jmesh.make_spike_mesh(1, 1),
                               decay=jd, threshold_raw=THRESH,
                               reset_mode=reset)
    ext = _raster(rng, 6, 5, 37)
    act = (rng.random((6, 5)) < 0.6).astype(np.int32)
    jo = je.run(jnp.asarray(ext))
    jc, js = je.step_chunk(je.init_carry(5), jnp.asarray(ext),
                           jnp.asarray(act))
    jc1, js1 = je.step(je.init_carry(5), jnp.asarray(ext[0]))
    for shape in ((1, 1), (2, 2)):
        te = MeshSpikeEngine(W, 37, mesh=_mesh(*shape), decay=td,
                             threshold_raw=THRESH, reset_mode=reset,
                             backend="cuda")
        to = te.run(ext)
        assert _eq(jo["spikes"], to["spikes"])
        assert _eq(jo["v_final"], to["v_final"])
        tc, ts = te.step_chunk(te.init_carry(5), ext, act)
        assert _eq(js, ts)
        assert _eq(jc["v"], tc["v"]) and _eq(jc["spikes"], tc["spikes"])
        tc1, ts1 = te.step(te.init_carry(5), ext[0])
        assert _eq(js1, ts1) and _eq(jc1["v"], tc1["v"])


# --------------------------------------------------------------------------
# the acceptance sweep: every mesh x backend x reset, batch run and a
# ragged feed through a sharded server
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kn,kb", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("backend", teng.BACKENDS)
@pytest.mark.parametrize("reset", RESET_MODES)
def test_mesh_parity_backend_reset_sweep(kn, kb, backend, reset):
    rng = np.random.default_rng(11)
    W = _weights(rng, 37, 48)
    je, te = _pair(W, 37, backend=backend, reset=reset, mesh=(kn, kb))
    T = 7
    ext = _raster(rng, T, 5, 37)
    assert _assert_run_equal(je, te, ext) > 0
    # streaming: the same raster dribbled raggedly through a SHARDED
    # server reproduces the one-shot batch raster byte for byte
    srv = SpikeServer(te, n_slots=3, chunk_steps=3)
    uid = srv.attach()
    pieces, t0 = [], 0
    for n in (2, 4, 1):
        pieces.append(srv.feed({uid: ext[t0:t0 + n, 0]})[uid]["spikes"])
        t0 += n
    got = np.concatenate(pieces, axis=0)
    want = np.asarray(je.run(jnp.asarray(ext))["spikes"])[:, 0]
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("B,n_in,n_phys", RAGGED_SHAPES)
@pytest.mark.parametrize("kn,kb", [(2, 2), (2, 1), (1, 2), (2, 4)],
                         ids=["2x2", "2x1", "1x2", "2x4"])
def test_mesh_parity_ragged_shapes(B, n_in, n_phys, kn, kb):
    """Neuron and batch padding never leaks into results: n_phys 1 and 130
    on a 2-way neuron axis, B 1 and 5 on a 2- and 4-way batch axis, on
    every backend (the kernel backends pad each shard's slice on its own)."""
    rng = np.random.default_rng(B * 1000 + n_phys)
    W = _weights(rng, n_in, n_phys)
    ext = _raster(rng, 6, B, n_in)
    for backend in teng.BACKENDS:
        je, te = _pair(W, n_in, backend=backend, mesh=(kn, kb))
        _assert_run_equal(je, te, ext)
        for i, row in enumerate(te._shard_w):
            for w in row:
                if backend != "reference":
                    assert w.shape[0] % 128 == 0 and w.shape[1] % 128 == 0
                else:
                    assert w.shape == (n_in + te._pp, te._ps)


@pytest.mark.parametrize("kn,kb", MESHES, ids=MESH_IDS)
def test_mesh_parity_mul_decay(kn, kb):
    """The Cerebra-S truncating-multiply PDU shards exactly too."""
    rng = np.random.default_rng(5)
    W = _weights(rng, 37, 48)
    ext = _raster(rng, 6, 4, 37)
    for backend in teng.BACKENDS:
        je, te = _pair(W, 37, backend=backend, mesh=(kn, kb),
                       decay=("mul", int(round(0.7 * 65536))))
        assert _assert_run_equal(je, te, ext) > 0


# --------------------------------------------------------------------------
# step / step_chunk with masked slots
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kn,kb", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("backend", teng.BACKENDS)
def test_mesh_step_chunk_masked_slots(kn, kb, backend):
    """Inactive slots keep their carry bit for bit across a sharded chunk
    step, chained over chunks; the carry stays sharded between chunks and
    its pad rows and columns stay zero."""
    rng = np.random.default_rng(13)
    W = _weights(rng, 37, 48)
    je, te = _pair(W, 37, backend=backend, reset="zero", mesh=(kn, kb))
    c1, c2 = je.init_carry(5), te.init_carry(5)
    assert isinstance(c2, MeshCarry)
    for _ in range(3):
        ext = _raster(rng, 4, 5, 37)
        act = (rng.random((4, 5)) < 0.5).astype(np.int32)
        c1, s1 = je.step_chunk(c1, jnp.asarray(ext), jnp.asarray(act))
        c2, s2 = te.step_chunk(c2, ext, act)
        assert _eq(s1, s2)
        assert _eq(c1["v"], c2["v"]) and _eq(c1["spikes"], c2["spikes"])
    assert isinstance(c2, MeshCarry)
    bs = -(-5 // kb)
    for i in range(kn):
        for j in range(kb):
            blk = c2.blocks[i][j]
            assert blk["v"].shape == (bs, te._ps)
            pad_rows = max(0, (j + 1) * bs - 5)
            if pad_rows:
                assert not blk["v"][bs - pad_rows:].any()
    cols = 48 - (kn - 1) * te._ps  # real columns on the last neuron shard
    assert not c2.blocks[kn - 1][0]["v"][:, cols:].any()


@pytest.mark.parametrize("kn,kb", MESHES, ids=MESH_IDS)
def test_mesh_single_step_parity(kn, kb):
    """``step`` routes through the mesh and takes a single-device carry
    dict (here one from the JAX engine, carried over as numpy)."""
    rng = np.random.default_rng(17)
    W = _weights(rng, 37, 48)
    je, te = _pair(W, 37, backend="cuda-f32", mesh=(kn, kb))
    jc, _ = je.step_chunk(je.init_carry(3), jnp.asarray(_raster(rng, 3, 3,
                                                                37)))
    tc = {k: torch.from_numpy(np.asarray(jc[k]).copy()) for k in jc}
    ext_t = (rng.random((3, 37)) < 0.4).astype(np.int32)
    c1, s1 = je.step(jc, jnp.asarray(ext_t))
    c2, s2 = te.step(tc, ext_t)
    assert _eq(s1, s2)
    for k in ("v", "spikes"):
        assert _eq(c1[k], c2[k])
    # the caller's carry is not written through
    assert _eq(jc["v"], tc["v"])


@pytest.mark.parametrize("kn,kb", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
@pytest.mark.parametrize("K", [1, 8])
def test_mesh_run_aer_in_and_out(kn, kb, K):
    """``run`` on an AER stream, with the raster also returned as one:
    equal to the dense run and to the JAX engine's stream."""
    rng = np.random.default_rng(19)
    W = _weights(rng, 37, 48)
    je, te = _pair(W, 37, backend="cuda", mesh=(kn, kb), fuse_steps=K)
    ext = _raster(rng, 9, 6, 37)
    cap = int(ext.sum())
    jo = je.run(jnp.asarray(ext), events_capacity=512, events_policy="drop")
    to = te.run(dense_to_aer(torch.from_numpy(ext), cap),
                events_capacity=512, events_policy="drop")
    assert _eq(jo["spikes"], to["spikes"]) and _eq(jo["v_final"],
                                                   to["v_final"])
    je_, te_ = jo["events"], to["events"]
    assert _eq(je_.addrs, te_.addrs)
    assert int(je_.count) == int(te_.count) > 0
    assert int(je_.total) == int(te_.total)
    assert tuple(je_.shape) == tuple(te_.shape)


# --------------------------------------------------------------------------
# gate and K-step re-hosts keep the mesh (test_events.py,
# test_fused_steps.py)
# --------------------------------------------------------------------------

def test_mesh_engine_keeps_gate():
    rng = np.random.default_rng(3)
    W = _weights(rng, 12, 16)
    mesh = _mesh(2, 2)
    base = teng.SpikeEngine(W, 12, decay=teng.DecaySpec.shift(0.25),
                            threshold_raw=THRESH, reset_mode="zero",
                            backend="cuda", device="cpu")
    eng = base.to_mesh(mesh).with_gate("per-example")
    assert isinstance(eng, MeshSpikeEngine)
    assert eng.gate == "per-example" and eng.mesh == mesh
    ext = _raster(rng, 4, 2, 12, 0.2)
    want = jeng.SpikeEngine(W, 12, decay=jeng.DecaySpec.shift(0.25),
                            threshold_raw=THRESH, reset_mode="zero").run(ext)
    assert _eq(want["spikes"], eng.run(ext)["spikes"])


@pytest.mark.parametrize("kn,kb", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_mesh_engine_carries_fuse_steps(kn, kb, monkeypatch):
    """to_mesh / with_gate / with_fuse_steps keep K, the sharded run stays
    byte-identical, and the mesh steps through the single-step wrapper,
    once per shard per step, issuing no fused window."""
    rng = np.random.default_rng(23)
    W = _weights(rng, 30, 40)
    ext = _raster(rng, 6, 3, 30)
    want = jeng.SpikeEngine(W, 30, decay=jeng.DecaySpec.shift(0.25),
                            threshold_raw=THRESH,
                            reset_mode="subtract").run(ext)
    fused = teng.SpikeEngine(W, 30, decay=teng.DecaySpec.shift(0.25),
                             threshold_raw=THRESH, reset_mode="subtract",
                             backend="cuda", fuse_steps=4, device="cpu")
    sharded = fused.to_mesh(_mesh(kn, kb))
    assert isinstance(sharded, MeshSpikeEngine) and sharded.fuse_steps == 4
    assert sharded.with_gate("per-example").fuse_steps == 4
    assert isinstance(sharded.with_fuse_steps(2), MeshSpikeEngine)
    assert sharded.with_fuse_steps(2).fuse_steps == 2
    calls = []
    single = ops.spike_timestep

    def count(*a, **k):
        calls.append(a[1].shape)
        return single(*a, **k)

    def refuse(*a, **k):
        raise AssertionError("a fused window was issued under a mesh")

    monkeypatch.setattr(ops, "spike_timestep", count)
    monkeypatch.setattr(ops, "spike_timestep_fused", refuse)
    out = sharded.run(ext)
    assert _eq(want["spikes"], out["spikes"])
    assert _eq(want["v_final"], out["v_final"])
    assert len(calls) == 6 * kn * kb
    assert set(calls) == {(128, 128)}  # per-shard padded slices


@pytest.mark.parametrize("kn,kb", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
def test_mesh_builds_sources_once_per_batch_shard(kn, kb, monkeypatch):
    """The neuron shards of a batch shard on one device share one source
    build and gate a step (kb builds a step on a host mesh, kn x kb kernel
    calls); the columns are cut as the rules' weight spec says; neither
    the re-hosted plain engine nor the mesh pads the whole image."""
    rng = np.random.default_rng(31)
    W = _weights(rng, 30, 40)
    ext = _raster(rng, 5, 3, 30)
    single = teng.SpikeEngine(W, 30, decay=teng.DecaySpec.shift(0.25),
                              threshold_raw=THRESH, reset_mode="zero",
                              backend="cuda", device="cpu")
    sharded = single.to_mesh(_mesh(kn, kb))
    assert sharded._w_spec == (None, "neuron")
    assert sharded._ps == sharded._pp // kn == 20
    builds, calls = [], []
    gate, step = ops.gated_sources, ops.spike_timestep

    def count_builds(*a, **k):
        builds.append(a[0].shape)
        return gate(*a, **k)

    def count_calls(*a, **k):
        calls.append(a[0])
        return step(*a, **k)

    monkeypatch.setattr(ops, "gated_sources", count_builds)
    monkeypatch.setattr(ops, "spike_timestep", count_calls)
    got = sharded.run(ext)
    assert len(builds) == 5 * kb and len(calls) == 5 * kn * kb
    assert set(builds) == {(-(-3 // kb), 30 + 40)}
    assert all(isinstance(c, ops.GatedSources) for c in calls)
    assert "_kernel_weights" not in vars(single)
    assert "_kernel_weights" not in vars(sharded)
    want = single.run(ext)
    assert "_kernel_weights" in vars(single)  # padded at its first step
    for k in ("spikes", "v_final"):
        assert torch.equal(got[k], want[k])


def test_gated_sources_keep_their_tile_height():
    src = torch.from_numpy(_raster(np.random.default_rng(0), 1, 3, 20)[0])
    W = torch.zeros((20, 4), dtype=torch.int32)
    v = torch.zeros((3, 4), dtype=torch.int32)
    gated = ops.gated_sources(src, block_batch=8)
    assert gated.padded.shape == (8, 128) and gated.activity.shape == (1, 1)
    assert (gated.rows, gated.width) == (3, 20)
    for got, want in zip(
            ops.spike_timestep(gated, W, v, threshold_raw=THRESH,
                               decay_rate=0.25),
            ops.spike_timestep(src, W, v, threshold_raw=THRESH,
                               decay_rate=0.25)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="tiles of 8 rows"):
        ops.spike_timestep(gated, W, v, threshold_raw=THRESH,
                           decay_rate=0.25, block_batch=1)


# --------------------------------------------------------------------------
# servers: closed loop, slot rows, counters, migration
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kn,kb", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
def test_mesh_closed_loop_through_server(kn, kb):
    rng = np.random.default_rng(29)
    W = _weights(rng, 37, 48)
    je, te = _pair(W, 37, backend="cuda", mesh=(kn, kb))

    def controller(spikes_t):
        return (spikes_t[:37] ^ 1).astype(np.int32)

    ext0 = np.zeros((37,), np.int32)
    ext0[::3] = 1
    js = JServer(je, n_slots=2, chunk_steps=4)
    ts = SpikeServer(te, n_slots=2, chunk_steps=4)
    jo = js.run_closed_loop(js.attach(), controller, 6, ext0)
    to = ts.run_closed_loop(ts.attach(), controller, 6, ext0)
    assert np.array_equal(jo["spikes"], to["spikes"])
    assert np.array_equal(jo["counts"], to["counts"])


@pytest.mark.parametrize("kn,kb", [(1, 2), (2, 2), (2, 4)],
                         ids=["1x2", "2x2", "2x4"])
def test_slot_rows_live_on_the_batch_shard_that_owns_them(kn, kb):
    """snapshot / detach / attach address each slot's rows on its batch
    shard (``slot // slots_per_shard``): the snapshots equal a plain
    server's, a detach zeroes only that slot, and an attach lands there."""
    rng = np.random.default_rng(31)
    W = _weights(rng, 37, 48)
    plain = teng.SpikeEngine(W, 37, decay=teng.DecaySpec.shift(0.25),
                             threshold_raw=THRESH, reset_mode="subtract",
                             backend="cuda", device="cpu")
    a = SpikeServer(plain, n_slots=5, chunk_steps=3, device="cpu")
    b = SpikeServer(plain, n_slots=5, chunk_steps=3, mesh=_mesh(kn, kb))
    uids = [f"s{i}" for i in range(5)]
    feeds = {u: (rng.random((7, 37)) < 0.4).astype(np.int32) for u in uids}
    for srv in (a, b):
        for u in uids:
            srv.attach(u)
        srv.feed(feeds)
    bs = -(-5 // kb)
    for u in uids:
        sa, sb = a.snapshot_stream(u), b.snapshot_stream(u)
        for k in ("v", "spikes"):
            assert np.array_equal(sa.arrays[k], sb.arrays[k])
        slot = b.slot_of(u)
        j, r = slot // bs, slot % bs
        v_blocks = [b.carry.blocks[i][j]["v"][r] for i in range(kn)]
        assert np.array_equal(torch.cat(v_blocks)[:48].numpy(),
                              sa.arrays["v"])
    # detach zeroes the slot on its shard and nothing else
    before = b.carry["v"].clone()
    snap = b.detach_stream("s3", InMemoryCarryConnector())
    after = b.carry["v"]
    assert not after[3].any()
    keep = [s for s in range(5) if s != 3]
    assert torch.equal(after[keep], before[keep])
    # the carry comes back on another server's last slot and continues
    c = SpikeServer(plain, n_slots=5, chunk_steps=2, mesh=_mesh(kn, kb))
    for i in range(4):
        c.attach(f"pad{i}")
    c.attach_stream(snap, uid="s3")
    assert c.slot_of("s3") == 4
    assert np.array_equal(c.engine.carry_rows(c.carry, 4)[0].numpy(),
                          snap.arrays["v"])
    nxt = (rng.random((5, 37)) < 0.4).astype(np.int32)
    a_out = a.feed({"s3": nxt})["s3"]["spikes"]
    c_out = c.feed({"s3": nxt})["s3"]["spikes"]
    assert np.array_equal(a_out, c_out)


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (2, 4)],
                         ids=["1x1", "2x2", "2x4"])
def test_migration_into_mesh_server(shape):
    """A carry parked on a plain server resumes bit-clean on a mesh
    server (test_carry_migration.py), held against JAX's one-shot run."""
    rng = np.random.default_rng(37)
    W = _weights(rng, 11, 24)
    je, _ = _pair(W, 11)
    plain = teng.SpikeEngine(W, 11, decay=teng.DecaySpec.shift(0.25),
                             threshold_raw=THRESH, reset_mode="subtract",
                             device="cpu")
    ext = (rng.random((14, 11)) < 0.35).astype(np.int32)
    want = np.asarray(je.run(jnp.asarray(ext[:, None, :]))["spikes"])[:, 0]
    conn = InMemoryCarryConnector()
    a = SpikeServer(plain, n_slots=3, chunk_steps=5, device="cpu")
    b = SpikeServer(plain, n_slots=4, chunk_steps=3, mesh=_mesh(*shape))
    uid = a.attach("mig")
    first = a.feed({uid: ext[:6]})[uid]["spikes"]
    a.detach_stream(uid, conn)
    b.attach_stream(conn, uid)
    assert uid not in conn
    second = b.feed({uid: ext[6:]})[uid]["spikes"]
    assert np.array_equal(np.concatenate([first, second]), want)
    assert b.streams[uid].steps == 14


@pytest.mark.parametrize("shape", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_migration_out_of_mesh_server(shape):
    """And back: a stream born sharded hops to a plain server."""
    rng = np.random.default_rng(41)
    W = _weights(rng, 37, 48)
    je, te = _pair(W, 37, reset="hold", backend="cuda", mesh=shape)
    ext = (rng.random((12, 37)) < 0.35).astype(np.int32)
    want = np.asarray(je.run(jnp.asarray(ext[:, None, :]))["spikes"])[:, 0]
    conn = InMemoryCarryConnector()
    a = SpikeServer(te, n_slots=2, chunk_steps=4)
    plain = teng.SpikeEngine(W, 37, decay=teng.DecaySpec.shift(0.25),
                             threshold_raw=THRESH, reset_mode="hold",
                             device="cpu")
    b = SpikeServer(plain, n_slots=2, chunk_steps=5, device="cpu")
    uid = a.attach()
    first = a.feed({uid: ext[:5]})[uid]["spikes"]
    a.detach_stream(uid, conn)
    b.attach_stream(conn, uid)
    second = b.feed({uid: ext[5:]})[uid]["spikes"]
    assert np.array_equal(np.concatenate([first, second]), want)


@pytest.mark.parametrize("kn,kb", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
def test_server_counters_count_the_logical_raster_once(kn, kb):
    """With a metrics registry, a mesh server's counters equal a plain
    server's on the same traffic: the obs pass reads the logical raster,
    not one raster per shard."""
    from repro_torch.obs import MetricsRegistry

    rng = np.random.default_rng(43)
    W = _weights(rng, 37, 48)
    plain = teng.SpikeEngine(W, 37, decay=teng.DecaySpec.shift(0.25),
                             threshold_raw=THRESH, reset_mode="zero",
                             backend="cuda", device="cpu")
    regs, outs = [], []
    for mesh in (None, _mesh(kn, kb)):
        reg = MetricsRegistry()
        srv = SpikeServer(plain, n_slots=5, chunk_steps=3, device="cpu",
                          mesh=mesh, metrics=reg)
        for u in range(4):
            srv.attach(u)
        r = np.random.default_rng(1)
        outs.append(srv.feed({u: (r.random((4 + u, 37)) < 0.4).astype(
            np.int32) for u in range(4)}))
        regs.append(reg)
    for u in range(4):
        assert np.array_equal(outs[0][u]["spikes"], outs[1][u]["spikes"])
    text = [reg.to_prometheus() for reg in regs]
    counters = [sorted(line for line in t.splitlines()
                       if line.startswith("snn_server_")
                       and "latency" not in line) for t in text]
    assert counters[0] == counters[1]


# --------------------------------------------------------------------------
# sessions: run_all, streaming churn, the async front door
# --------------------------------------------------------------------------

def _session_nets():
    from conftest import make_random_net

    rng = np.random.default_rng(0)
    return [make_random_net(rng),
            make_random_net(rng, n_in=12, n_neurons=32)]


def _sessions(mesh, backend="reference", **kw):
    from test_torch_session import _to_port as _port_net

    nets = _session_nets()
    js = JSession()
    ts = TSession(backend=backend, device="cpu", mesh=mesh, **kw)
    for name, net in zip(("a", "b"), nets):
        js.deploy(name, net)
        ts.deploy(name, _port_net(net))
    return js, ts


@pytest.mark.parametrize("kn,kb", [(2, 2), (2, 4)], ids=["2x2", "2x4"])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_session_run_all_sharded_parity(kn, kb, backend):
    """Co-resident fused models on a mesh session decode byte-identically
    to the JAX session (spikes, counts, predictions, costs)."""
    js, ts = _sessions(_mesh(kn, kb), backend)
    rng = np.random.default_rng(47)
    inputs = {"a": rng.random((3, 20)).astype(np.float32),
              "b": rng.random((3, 12)).astype(np.float32)}
    ra = js.run_all(inputs, 10, jax.random.key(0))
    rb = ts.run_all(inputs, 10, 0)
    assert isinstance(next(iter(ts._fused_engines.values())),
                      MeshSpikeEngine)
    for name in ("a", "b"):
        for k in ("spikes", "output_counts", "predictions", "cycles",
                  "sops", "row_fetches"):
            want, got = np.asarray(ra[name][k]), rb[name][k]
            got = got.numpy() if isinstance(got, torch.Tensor) else got
            assert np.array_equal(want, np.asarray(got)), (name, k)


@pytest.mark.parametrize("kn,kb", [(2, 2), (1, 2)], ids=["2x2", "1x2"])
@pytest.mark.parametrize("K", [1, 8])
def test_session_streaming_churn_sharded_parity(kn, kb, K):
    """Attach / feed / detach churn across co-resident models' streams on
    a mesh session server matches the JAX single-device server."""
    rng = np.random.default_rng(53)
    js, ts = _sessions(_mesh(kn, kb), "cuda", fuse_steps=K)
    chunks_a = [(rng.random((n, 20)) < 0.4).astype(np.int32)
                for n in (3, 1, 4)]
    chunks_b = [(rng.random((n, 12)) < 0.4).astype(np.int32)
                for n in (2, 5)]
    results = []
    for sess in (js, ts):
        va = sess.serve("a", n_slots=3, chunk_steps=3)
        vb = sess.serve("b", n_slots=3, chunk_steps=3)
        assert va.server is vb.server
        ua, ub = va.attach(), vb.attach()
        outs = [va.feed(ua, chunks_a[0]), vb.feed(ub, chunks_b[0]),
                va.feed(ua, chunks_a[1])]
        va.detach(ua)
        ua2 = va.attach()
        outs.append(va.feed(ua2, chunks_a[2]))
        outs.append(vb.feed(ub, chunks_b[1]))
        results.append(outs)
    assert isinstance(ts.serve("a", n_slots=3, chunk_steps=3).server.engine,
                      MeshSpikeEngine)
    for o_j, o_t in zip(*results):
        for k in ("spikes", "output_counts", "predictions"):
            assert np.array_equal(np.asarray(o_j[k]), np.asarray(o_t[k]))


def test_session_rolling_redeploy_on_a_mesh():
    """A deploy with streams in flight on a mesh session parks them and
    the re-serve restores them into the new mesh server: the stitched
    raster equals the JAX session's uninterrupted one."""
    from conftest import make_random_net
    from test_torch_session import _to_port as _port_net

    rng = np.random.default_rng(59)
    js, ts = _sessions(_mesh(2, 2), "cuda")
    chunk = (rng.random((9, 20)) < 0.4).astype(np.int32)
    jv = js.serve("a", n_slots=2, chunk_steps=3)
    ju = jv.attach()
    want = jv.feed(ju, chunk)["spikes"]
    tv = ts.serve("a", n_slots=2, chunk_steps=3)
    tu = tv.attach()
    first = tv.feed(tu, chunk[:4])["spikes"]
    ts.deploy("c", _port_net(make_random_net(np.random.default_rng(9),
                                             n_in=6, n_neurons=16)))
    tv = ts.serve("a", n_slots=2, chunk_steps=3)
    assert isinstance(tv.server.engine, MeshSpikeEngine)
    second = tv.feed(tu, chunk[4:])["spikes"]
    assert np.array_equal(want, np.concatenate([first, second]))


@pytest.mark.parametrize("kn,kb", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_async_frontend_sharded_parity(kn, kb):
    """Requests through the port's AsyncSpikeFrontend over a mesh server
    are byte-identical to the JAX single-device engine's one-shot run."""
    from repro_torch.serving.frontend import AsyncSpikeFrontend

    rng = np.random.default_rng(61)
    W = _weights(rng, 37, 48)
    je, te = _pair(W, 37, backend="cuda", mesh=(kn, kb))
    rasters = [(rng.random((T, 37)) < 0.35).astype(np.int32)
               for T in (7, 4, 9, 2)]
    server = SpikeServer(te, n_slots=2, chunk_steps=3)
    fe = AsyncSpikeFrontend(server, queue_capacity=len(rasters))
    handles = [fe.submit(r) for r in rasters]
    assert fe.drain()["counts"]["done"] == len(rasters)
    for h, r in zip(handles, rasters):
        want = np.asarray(je.run(jnp.asarray(r[:, None, :]))["spikes"])[:, 0]
        assert np.array_equal(h.result()["spikes"], want)


# --------------------------------------------------------------------------
# the single-controller design: no process group, no environment
# --------------------------------------------------------------------------

def test_port_starts_no_process_group_and_writes_no_environment():
    """No source line of the port, nor of chip_smoke.py, starts a
    ``torch.distributed`` process group, spawns a worker process or
    writes the process environment, but the one module of the LM's rank
    step that joins a process group (``distributed/process_group.py``):
    the spike mesh is one controller over its devices."""
    repo = pathlib.Path(__file__).resolve().parent.parent
    ranks = repo / "src" / "repro_torch" / "distributed" / "process_group.py"
    files = sorted(f for f in (repo / "src" / "repro_torch").rglob("*.py")
                   if f != ranks)
    files.append(repo / "chip_smoke.py")
    pattern = re.compile(
        r"init_process_group|\btorch\.distributed|multiprocessing|"
        r"os\.environ\[[^]]*\]\s*=|os\.environ\.(update|setdefault)|"
        r"os\.putenv|mp\.spawn")
    bad = [f"{f.name}:{i}: {line.strip()}"
           for f in files
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if pattern.search(line)]
    assert bad == []
