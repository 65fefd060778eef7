"""The port's event path against the JAX package's, on the same numpy inputs.

Mirrors ``tests/test_events.py`` case by case where this slice has a
counterpart: the AER round trip (deterministic and property), the overflow
policies, validation and binarization, AER input and output on the engine
(every backend, both gates, K-step fused windows), the full sweep over
the ``cuda``-named backends (their plain versions here) x resets x decay
units, ``SpikeServer.feed_events``, the trace's AER acceptance and
``measured_counts``, and the gesture clips. Every stream, raster, carry
and count is compared byte for byte with the JAX package's (packed lanes
as uint32). The JAX side runs its ``reference`` backend.

``test_aer_stream_is_a_pytree`` has no counterpart: an ``AERStream`` of
the port is a frozen dataclass of tensors, and torch has no jit pytree.
"""

import dataclasses

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_lm_train import one_torch_thread  # noqa: E402,F401

from repro.core import cerebra_h as jch  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core.mapping import ClusterGeometry as JGeom  # noqa: E402
from repro.data import events as jdata  # noqa: E402
from repro.events import aer as jaer  # noqa: E402
from repro.events import trace as jtrace  # noqa: E402
from repro.serving.snn import SpikeServer as JServer  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import cerebra_h as tch  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.data import events as tdata  # noqa: E402
from repro_torch.events import aer as taer  # noqa: E402
from repro_torch.events import trace as ttrace  # noqa: E402
from repro_torch.serving import snn as tsnn  # noqa: E402

from conftest import make_random_net  # noqa: E402

THRESH = 1 << 16
KERNEL_BACKENDS = ("cuda", "cuda-f32")


def _raster(rng, T, B, S, density=0.2):
    return (rng.random((T, B, S)) < density).astype(np.int32)


def _weights(rng, n_in, n_phys, density=0.3, wmax=1 << 14):
    S = n_in + n_phys
    W = (rng.random((S, n_phys)) < density) * rng.integers(
        -wmax, wmax, (S, n_phys))
    return W.astype(np.int32)


def _decays(kind):
    arg = 0.25 if kind == "shift" else int(0.8 * 65536)
    return getattr(jeng.DecaySpec, kind)(arg), getattr(teng.DecaySpec,
                                                       kind)(arg)


def _pair(W, n_in, backend="reference", *, gate="batch-tile", reset="zero",
          decay="shift", fuse_steps=1):
    """The JAX reference engine and the port's ``backend`` engine."""
    jd, td = _decays(decay)
    je = jeng.SpikeEngine(W, n_in, decay=jd, threshold_raw=THRESH,
                          reset_mode=reset)
    te = teng.SpikeEngine(W, n_in, decay=td, threshold_raw=THRESH,
                          reset_mode=reset, backend=backend, gate=gate,
                          fuse_steps=fuse_steps, device="cpu")
    return je, te


def _eq(j, t) -> bool:
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    return t.dtype == j.dtype and np.array_equal(j, t)


def _lanes(t) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _stream_eq(js, ts) -> bool:
    return (js.shape == ts.shape and _eq(js.addrs, ts.addrs)
            and _eq(js.count, ts.count) and _eq(js.total, ts.total)
            and js.capacity == ts.capacity
            and js.overflowed == ts.overflowed and len(js) == len(ts)
            and js.sparsity == ts.sparsity)


def _both(dense, capacity, **kw):
    js, ts = jaer.dense_to_aer(dense, capacity, **kw), taer.dense_to_aer(
        dense, capacity, **kw)
    assert _stream_eq(js, ts)
    assert np.array_equal(np.asarray(jaer.aer_to_packed(js)),
                          _lanes(taer.aer_to_packed(ts)))
    assert _eq(jaer.aer_to_dense(js), taer.aer_to_dense(ts))
    return js, ts


# --------------------------------------------------------------------------
# AER round trip: property test + deterministic companions
# --------------------------------------------------------------------------

@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(T=st.integers(1, 5), B=st.integers(1, 4), S=st.integers(1, 40),
       density=st.floats(0.0, 0.7), pad=st.integers(0, 9),
       seed=st.integers(0, 2**16))
def test_aer_round_trip_property(T, B, S, density, pad, seed):
    """dense -> AER -> dense is the identity for any activity pattern when
    capacity >= event count, and every stream equals the twin's."""
    rng = np.random.default_rng(seed)
    dense = _raster(rng, T, B, S, density)
    _, stream = _both(dense, int(dense.sum()) + pad)
    assert not stream.overflowed
    assert int(stream.count) == int(stream.total) == int(dense.sum())
    assert np.array_equal(taer.aer_to_dense(stream).numpy(), dense)
    addrs = stream.addrs.numpy()[: int(stream.count)]
    assert np.array_equal(addrs, addrs[np.lexsort(addrs.T[::-1])])


def test_aer_round_trip_deterministic(rng):
    cases = [
        np.zeros((3, 2, 5), np.int32),                   # silence
        np.ones((2, 2, 4), np.int32),                    # saturation
        np.zeros((4, 1, 7), np.int32),                   # one event
        _raster(rng, 5, 3, 37, 0.15),                    # ragged activity
        np.ones((2, 1, 64), np.int32),                   # bit 31 of a lane
    ]
    cases[2][2, 0, 6] = 1
    empty_mid = _raster(rng, 6, 2, 9, 0.4)
    empty_mid[2:4] = 0                                    # empty timesteps
    cases.append(empty_mid)
    for dense in cases:
        _, stream = _both(dense, int(dense.sum()) + 3)
        assert np.array_equal(taer.aer_to_dense(stream).numpy(), dense)
        assert not stream.overflowed
        assert len(stream) == int(dense.sum())


def test_aer_overflow_policies():
    dense = np.zeros((3, 1, 4), np.int32)
    dense[0, 0, 1] = dense[1, 0, 0] = dense[2, 0, 3] = 1
    with pytest.raises(OverflowError, match="capacity"):
        taer.dense_to_aer(dense, 2)
    # drop keeps the EARLIEST capacity events (full-FIFO semantics)
    _, stream = _both(dense, 2, policy="drop")
    assert stream.overflowed
    assert (int(stream.count), int(stream.total)) == (2, 3)
    expected = dense.copy()
    expected[2, 0, 3] = 0  # the latest event is the one lost
    assert np.array_equal(taer.aer_to_dense(stream).numpy(), expected)
    _, empty = _both(dense, 0, policy="drop")
    assert empty.capacity == 0 and empty.overflowed


@pytest.mark.parametrize("mod", [jaer, taer], ids=["jax", "torch"])
def test_aer_validation_and_binarization(mod):
    """The same errors in both packages; any nonzero is ONE event."""
    with pytest.raises(ValueError, match="policy"):
        mod.dense_to_aer(np.zeros((1, 1, 1), np.int32), 1, policy="wrap")
    with pytest.raises(ValueError, match=r"\(T, B, S\)"):
        mod.dense_to_aer(np.zeros((2, 3), np.int32), 4)
    with pytest.raises(ValueError, match="capacity"):
        mod.dense_to_aer(np.zeros((1, 1, 1), np.int32), -1)
    dense = np.zeros((2, 1, 3), np.float32)
    dense[1, 0, 2] = 7
    dense[0, 0, 0] = -0.5
    js, ts = _both(dense, 4)
    assert len(ts) == 2
    assert np.array_equal(taer.aer_to_dense(ts).numpy(),
                          (dense != 0).astype(np.int32))


def test_aer_streams_cross_packages():
    """A stream the JAX package made, carried across with
    ``convert.aer_stream``, decodes to the same raster and lanes; so does a
    hand-built stream with filler rows, rows past ``count``, a repeated
    address (lanes add, as in the twin) and valid-looking rows addressed
    past the shape (dropped, except a source in the last lane's tail,
    which lands in the padding bits as in the twin)."""
    rng = np.random.default_rng(5)
    dense = _raster(rng, 6, 3, 70, 0.2)
    js = jaer.dense_to_aer(dense, int(dense.sum()) + 4)
    hand = np.array([
        [0, 0, 31], [0, 0, 31],      # repeated: 2 * 2^31 wraps to 0
        [1, 2, 63], [2, 1, 5],
        [5, 2, 69], [5, 2, 70],      # last source; past S in the tail lane
        [6, 0, 0], [0, 3, 0],        # t past T; slot past B
        [0, 0, 96], [-1, -1, -1],    # lane past the last; filler
        [3, 0, 4], [4, 1, 4],        # past count
    ], np.int32)
    streams = [
        (js, dict(addrs=np.asarray(js.addrs), count=np.asarray(js.count),
                  total=np.asarray(js.total), shape=js.shape)),
        (jaer.AERStream(addrs=jnp.asarray(hand), count=jnp.int32(10),
                        total=jnp.int32(12), shape=(6, 3, 70)),
         dict(addrs=hand, count=10, total=12, shape=(6, 3, 70))),
    ]
    for jst, fields in streams:
        ts = convert.aer_stream(**fields)
        assert _stream_eq(jst, ts)
        assert np.array_equal(np.asarray(jaer.aer_to_packed(jst)),
                              _lanes(taer.aer_to_packed(ts)))
        assert _eq(jaer.aer_to_dense(jst), taer.aer_to_dense(ts))
    lanes = _lanes(taer.aer_to_packed(convert.aer_stream(**streams[1][1])))
    assert lanes[0, 0, 0] == 0 and lanes[5, 2, 2] == (1 << 5) | (1 << 6)
    assert lanes.sum(dtype=np.int64) == (1 << 31) + (1 << 5) + (1 << 5) \
        + (1 << 6)


# --------------------------------------------------------------------------
# AER on the engine: bit-parity with the dense reference and the twin
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend,gate,K", [
    ("reference", "batch-tile", 1), ("cuda", "per-example", 1),
    ("cuda", "batch-tile", 3), ("cuda-f32", "per-example", 4)])
def test_aer_input_output_parity(rng, backend, gate, K):
    """AER in == dense in; AER out is the twin's stream of the raster."""
    B, n_in, n_phys, T = 3, 29, 40, 5
    W = _weights(rng, n_in, n_phys, wmax=1 << 16)
    ext = _raster(rng, T, B, n_in, 0.15)
    je, te = _pair(W, n_in, backend, gate=gate, fuse_steps=K)
    jout = je.run(ext)
    cap = int(np.asarray(jout["spikes"]).sum()) + 2
    jaer_out = je.run(jaer.dense_to_aer(ext, int(ext.sum())),
                      events_capacity=cap)
    tout = te.run(taer.dense_to_aer(ext, int(ext.sum())),
                  events_capacity=cap)
    assert _eq(jout["spikes"], tout["spikes"])
    assert _eq(jout["v_final"], tout["v_final"])
    assert _stream_eq(jaer_out["events"], tout["events"])
    assert np.array_equal(taer.aer_to_dense(tout["events"]).numpy(),
                          tout["spikes"].numpy())
    assert int(tout["spikes"].sum()) > 0


def test_engine_aer_validation(rng):
    W = _weights(rng, 8, 8)
    _, eng = _pair(W, 8)
    bad = taer.dense_to_aer(np.zeros((2, 1, 5), np.int32), 1)
    with pytest.raises(ValueError, match="sources"):
        eng.run(bad)
    # above-threshold weights: every neuron spikes, so capacity 0 is lossy
    W_hot = np.full((8 + 8, 8), 1 << 17, np.int32)
    _, hot = _pair(W_hot, 8)
    ext = np.ones((2, 1, 8), np.int32)
    with pytest.raises(OverflowError):
        hot.run(ext, events_capacity=0)  # default policy refuses loss
    out = hot.run(ext, events_capacity=0, events_policy="drop")
    assert out["events"].overflowed and int(out["events"].count) == 0
    assert int(out["events"].total) == 16


@pytest.mark.parametrize("backend", KERNEL_BACKENDS)
@pytest.mark.parametrize("reset", ["zero", "subtract", "hold"])
@pytest.mark.parametrize("decay_kind", ["shift", "mul"])
def test_event_paths_full_sweep(rng, backend, reset, decay_kind):
    """Per-example gate + AER input + AER output + streaming feed_events,
    byte-equal to the twin's dense reference, across the kernel backends
    x reset modes x decay units."""
    B, n_in, n_phys, T = 5, 37, 48, 7
    W = _weights(rng, n_in, n_phys, wmax=1 << 13)
    ext = _raster(rng, T, B, n_in, 0.12)
    je, te = _pair(W, n_in, backend, gate="per-example", reset=reset,
                   decay=decay_kind)
    ref = je.run(ext)
    ref_spikes = np.asarray(ref["spikes"])
    out = te.run(taer.dense_to_aer(ext, int(ext.sum())),
                 events_capacity=int(ref_spikes.sum()))
    assert _eq(ref["spikes"], out["spikes"])
    assert _eq(ref["v_final"], out["v_final"])
    assert _stream_eq(jaer.dense_to_aer(ref_spikes, int(ref_spikes.sum())),
                      out["events"])
    srv = tsnn.SpikeServer(te, n_slots=2, chunk_steps=3, device="cpu")
    uid = srv.attach()
    res = srv.feed_events(
        {uid: taer.dense_to_aer(ext[:, :1], max(int(ext[:, :1].sum()), 1))},
        out_capacity=int(ref_spikes[:, 0].sum()) + 1)
    assert np.array_equal(res[uid]["spikes"], ref_spikes[:, 0])
    assert np.array_equal(taer.aer_to_dense(res[uid]["events"]).numpy()[:, 0],
                          ref_spikes[:, 0])


# --------------------------------------------------------------------------
# Serving event paths
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", teng.BACKENDS)
def test_feed_events_matches_feed(rng, backend):
    """feed_events == feed in the port, and == the twin's feed_events."""
    n_in, n_phys, T = 11, 12, 6
    W = _weights(rng, n_in, n_phys, density=0.5)
    je, te = _pair(W, n_in, backend)
    srv_a = tsnn.SpikeServer(te, n_slots=2, chunk_steps=4, device="cpu")
    srv_b = tsnn.SpikeServer(te, n_slots=2, chunk_steps=4, device="cpu")
    srv_j = JServer(je, n_slots=2, chunk_steps=4)
    u_a, u_b, u_j = srv_a.attach(), srv_b.attach(), srv_j.attach()
    chunk = _raster(rng, T, 1, n_in, 0.3)
    dense_out = srv_a.feed({u_a: chunk[:, 0]})
    ev_out = srv_b.feed_events(
        {u_b: taer.dense_to_aer(chunk, int(chunk.sum()))}, out_capacity=64)
    j_out = srv_j.feed_events(
        {u_j: jaer.dense_to_aer(chunk, int(chunk.sum()))}, out_capacity=64)
    assert np.array_equal(dense_out[u_a]["spikes"], ev_out[u_b]["spikes"])
    assert _eq(j_out[u_j]["spikes"], ev_out[u_b]["spikes"])
    assert _eq(j_out[u_j]["counts"], ev_out[u_b]["counts"])
    assert _stream_eq(j_out[u_j]["events"], ev_out[u_b]["events"])
    assert np.array_equal(
        taer.aer_to_dense(ev_out[u_b]["events"]).numpy()[:, 0],
        ev_out[u_b]["spikes"])


def test_feed_events_validation(rng):
    W = _weights(rng, 6, 8)
    _, te = _pair(W, 6)
    srv = tsnn.SpikeServer(te, n_slots=1, chunk_steps=2, device="cpu")
    uid = srv.attach()
    wide = taer.dense_to_aer(np.zeros((2, 2, 6), np.int32), 1)
    with pytest.raises(ValueError, match="AER chunk"):
        srv.feed_events({uid: wide})
    wrong = taer.dense_to_aer(np.zeros((2, 1, 5), np.int32), 1)
    with pytest.raises(ValueError, match="AER chunk"):
        srv.feed_events({uid: wrong})
    with pytest.raises(ValueError, match=r"\(T, 1, 6\)"):
        tsnn.decode_aer_chunk(wide, 6)
    ok = np.zeros((2, 1, 6), np.int32)
    ok[1, 0, 3] = 1
    assert np.array_equal(
        tsnn.decode_aer_chunk(taer.dense_to_aer(ok, 1), 6), ok[:, 0])


# --------------------------------------------------------------------------
# Trace recorder: AER streams and measured counts
# --------------------------------------------------------------------------

def test_trace_accepts_aer_streams(rng):
    W = _weights(rng, 9, 12)
    je, te = _pair(W, 9)
    ext = _raster(rng, 4, 2, 9, 0.3)
    out = te.run(ext)["spikes"]
    n_out = int(out.sum())
    dense_rep = ttrace.trace_run(te, ext, out)
    aer_rep = ttrace.trace_run(te, taer.dense_to_aer(ext, int(ext.sum())),
                               taer.dense_to_aer(out, n_out))
    assert dense_rep == aer_rep
    j_rep = jtrace.trace_run(
        je, jaer.dense_to_aer(ext, int(ext.sum())),
        jaer.dense_to_aer(out.numpy(), n_out))
    assert dataclasses.asdict(j_rep) == dataclasses.asdict(aer_rep)


@pytest.mark.parametrize("as_stream", [False, True])
def test_measured_counts_agree_with_cost_model(rng, as_stream):
    """Measured event accounting == the port's analytic cost-model pass on
    the same rasters, and == the twin's measured counts."""
    geom = dict(n_clusters=4, neurons_per_cluster=4, clusters_per_group=2,
                rows_per_group=64, clusters_per_l1=2)
    jnet = make_random_net(rng, n_in=5, n_neurons=12, density=0.5)
    jprog = jch.compile_network(jnet, jch.CerebraHConfig(
        geometry=JGeom(**geom)))
    p = jnet.params
    tnet = convert.network(
        n_inputs=jnet.n_inputs, n_neurons=jnet.n_neurons,
        weights=np.asarray(jnet.weights),
        params=convert.lif_params(decay_rate=p.decay_rate,
                                  threshold=p.threshold,
                                  reset_mode=p.reset_mode),
        output_slice=jnet.output_slice)
    tprog = tch.compile_network(tnet, tch.CerebraHConfig(
        geometry=convert.geometry(**geom)))
    ext = _raster(rng, 8, 2, 5, 0.4)
    out = tch.run(tprog, ext, device="cpu")
    spikes = out["spikes"]
    if as_stream:
        counts = ttrace.measured_counts(
            tprog, taer.dense_to_aer(ext, int(ext.sum())),
            taer.dense_to_aer(spikes, int(spikes.sum())))
    else:
        counts = ttrace.measured_counts(tprog, ext, spikes)
    assert counts.sops == float(out["sops"].sum())
    assert counts.row_fetches == float(out["row_fetches"].sum())
    assert counts.spike_packets == counts.row_fetches
    assert counts.cycles == float(out["cycles"].sum())
    want = jtrace.measured_counts(jprog, ext, spikes.numpy())
    assert dataclasses.asdict(want) == dataclasses.asdict(counts)
    assert counts.sops > 0


# --------------------------------------------------------------------------
# Event-camera workload
# --------------------------------------------------------------------------

def test_gesture_raster_contract():
    d1, l1 = tdata.gesture_raster("test", 5, steps=16, size=12, seed=3)
    d2, l2 = tdata.gesture_raster("test", 5, steps=16, size=12, seed=3)
    assert np.array_equal(d1, d2) and np.array_equal(l1, l2)
    assert d1.shape == (16, 5, tdata.n_channels(12))
    assert set(np.unique(d1)) <= {0, 1}
    assert l1.min() >= 0 and l1.max() < len(tdata.GESTURES)
    assert 0.0 < d1.mean() < 0.15               # event-sparse
    d3, _ = tdata.gesture_raster("train", 5, steps=16, size=12, seed=3)
    assert not np.array_equal(d1, d3)           # splits differ
    jd, jl = jdata.gesture_raster("test", 5, steps=16, size=12, seed=3)
    assert _eq(jd, d1) and _eq(jl, l1)
    assert tdata.GESTURES == jdata.GESTURES
    assert tdata.n_channels(16) == jdata.n_channels(16) == 512


def test_gesture_events_round_trip():
    stream, labels = tdata.gesture_events("test", 3, steps=12, size=10,
                                          seed=1)
    assert isinstance(stream, taer.AERStream)
    assert not stream.overflowed                # auto-sized capacity
    dense, labels2 = tdata.gesture_raster("test", 3, steps=12, size=10,
                                          seed=1)
    assert np.array_equal(taer.aer_to_dense(stream).numpy(), dense)
    assert np.array_equal(labels, labels2)
    jstream, jlabels = jdata.gesture_events("test", 3, steps=12, size=10,
                                            seed=1)
    assert _stream_eq(jstream, stream) and _eq(jlabels, labels)


def test_gesture_classes_distinct():
    """Different trajectories produce different event streams."""
    d, labels = tdata.gesture_raster("test", 16, steps=16, size=12, seed=7)
    by_class: dict = {}
    for i, lab in enumerate(labels):
        by_class.setdefault(int(lab), d[:, i])
    classes = list(by_class)
    assert len(classes) >= 2
    a, b = by_class[classes[0]], by_class[classes[1]]
    assert not np.array_equal(a, b)
