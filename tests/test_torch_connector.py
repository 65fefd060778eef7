"""The port's stream-state connector, carry migration and rolling
redeploy (``repro_torch.serving.connector``, ``SpikeServer``'s connector
half, ``AcceleratorSession``'s drain and restore, and
``repro_torch.distributed.straggler``) against the JAX package's.

Both packages serve the same numpy weights and rasters on the CPU: the
port on its "reference" and "cuda" backends (the kernels' plain versions
here), the JAX package on "reference". Snapshot blobs must be byte-equal,
a blob written by either package must continue a stream byte for byte in
the other, and every error names the same fault in the same words.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core.lif import LIFParams as JLIF  # noqa: E402
from repro.core.network import SNNetwork as JNet  # noqa: E402
from repro.core.session import AcceleratorSession as JSession  # noqa: E402
from repro.distributed import straggler as jstrag  # noqa: E402
from repro.serving import connector as jconn  # noqa: E402
from repro.serving.snn import SpikeServer as JServer  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.lif import LIFParams as TLIF  # noqa: E402
from repro_torch.core.network import SNNetwork as TNet  # noqa: E402
from repro_torch.core.session import AcceleratorSession as TSession  # noqa: E402
from repro_torch.distributed import straggler as tstrag  # noqa: E402
from repro_torch.serving import connector as tconn  # noqa: E402
from repro_torch.serving.snn import SpikeServer as TServer  # noqa: E402

THRESH = 1 << 16
N_IN, P = 10, 16
BACKENDS = ("reference", "cuda")


def _weights(seed, n_in=N_IN, p=P, wmax=1 << 13):
    rng = np.random.default_rng(seed)
    return ((rng.random((n_in + p, p)) < 0.4)
            * rng.integers(-wmax, wmax, (n_in + p, p))).astype(np.int32)


def _raster(seed, T, n_in=N_IN, p=0.35):
    return (np.random.default_rng(seed).random((T, n_in)) < p).astype(
        np.int32)


def _engines(W, backend="reference", *, reset="subtract",
             decay=("shift", 0.25), K=1, gate="batch-tile", n_in=N_IN):
    kind, arg = decay
    je = jeng.SpikeEngine(jnp.asarray(W), n_in,
                          decay=getattr(jeng.DecaySpec, kind)(arg),
                          threshold_raw=THRESH, reset_mode=reset)
    te = teng.SpikeEngine(W, n_in, decay=getattr(teng.DecaySpec, kind)(arg),
                          threshold_raw=THRESH, reset_mode=reset,
                          backend=backend, gate=gate, fuse_steps=K,
                          device="cpu")
    return je, te


def _servers(W, backend="reference", *, n_slots=3, chunk=4, **kw):
    je, te = _engines(W, backend, **kw)
    return (JServer(je, n_slots=n_slots, chunk_steps=chunk),
            TServer(te, n_slots=n_slots, chunk_steps=chunk, device="cpu"))


def _one_shot(W, ext, **kw):
    je, _ = _engines(W, **kw)
    return np.asarray(je.run(ext[:, None, :])["spikes"])[:, 0]


# --------------------------------------------------------------------------
# the snapshot: identity, wire format, corruption
# --------------------------------------------------------------------------

@pytest.mark.parametrize("decay", [("shift", 0.25), ("shift", 0.5),
                                   ("mul", 50000), ("mul", 1 << 16)])
@pytest.mark.parametrize("reset", ["zero", "subtract", "hold"])
def test_slot_params_equal_the_jax_package(decay, reset):
    je, te = _engines(_weights(1), "cuda", decay=decay, reset=reset)
    want, got = jconn.slot_params_of(je), tconn.slot_params_of(te)
    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in
                                               want.values()]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("reset", ["zero", "subtract", "hold"])
@pytest.mark.parametrize("uid", [3, "cam-7"])
def test_snapshot_blob_is_byte_equal_across_packages(backend, reset, uid):
    W = _weights(2)
    js, ts = _servers(W, backend, reset=reset)
    for s in (js, ts):
        s.attach("other")
        s.attach(uid)
    ext = {"other": _raster(3, 9), uid: _raster(4, 7)}
    js.feed(ext), ts.feed(ext)
    jb = js.snapshot_stream(uid).to_bytes()
    tb = ts.snapshot_stream(uid).to_bytes()
    assert tb == jb
    snap = tconn.CarrySnapshot.from_bytes(tb)
    assert snap.meta == {"steps": 7, "spike_count": int(
        ts.streams[uid].spike_count)}
    assert snap.arrays["v"].any()


def test_snapshot_does_not_alias_the_carry():
    """On the CPU a tensor row's numpy view shares storage: the snapshot
    must be a copy, or a later in-place zeroing would reach it."""
    _, ts = _servers(_weights(5), "cuda")
    uid = ts.attach()
    ts.feed({uid: _raster(6, 8)})
    snap = ts.snapshot_stream(uid)
    v = snap.arrays["v"].copy()
    ts.detach(uid)
    assert not ts.carry["v"].any()
    assert np.array_equal(snap.arrays["v"], v) and v.any()


def _snap():
    W = _weights(7)
    _, ts = _servers(W)
    uid = ts.attach("s")
    ts.feed({uid: _raster(8, 5)})
    return ts.snapshot_stream(uid)


def _blob():
    return _snap().to_bytes()


def _corruptions(blob):
    import struct
    import zlib

    def recrc(body):
        return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)

    body = blob[:-4]
    return {
        "truncated": blob[:8],
        "magic": b"XNAPC" + blob[5:],
        "crc": blob[:-5] + bytes([blob[-5] ^ 1]) + blob[-4:],
        "version": recrc(body[:5] + struct.pack("<H", 9) + body[7:]),
        "trailing": recrc(body + b"\0\0\0\0"),
        "payload": recrc(body[:-4]),
        "header": recrc(body[:11] + b"x" + body[12:]),
    }


@pytest.mark.parametrize("kind", ["truncated", "magic", "crc", "version",
                                  "trailing", "payload", "header"])
def test_corrupt_blobs_raise_the_same_error(kind):
    bad = _corruptions(_blob())[kind]
    with pytest.raises(ValueError) as jerr:
        jconn.CarrySnapshot.from_bytes(bad)
    with pytest.raises(ValueError) as terr:
        tconn.CarrySnapshot.from_bytes(bad)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("field,value", [
    ("n_phys", 17), ("decay_kind", "mul"), ("decay_rate", 0.5),
    ("threshold_raw", 7), ("reset_mode", "zero")])
def test_check_compatible_names_the_same_field(field, value):
    snap_t = tconn.CarrySnapshot.from_bytes(_blob())
    snap_j = jconn.CarrySnapshot.from_bytes(_blob())
    params = dict(snap_t.slot_params, **{field: value})
    with pytest.raises(ValueError) as jerr:
        snap_j.check_compatible(params)
    with pytest.raises(ValueError) as terr:
        snap_t.check_compatible(params)
    assert str(terr.value) == str(jerr.value) and field in str(terr.value)


def test_unserializable_dtype_refused_the_same_way():
    arrays = {"v": np.zeros(4, np.complex64)}
    with pytest.raises(ValueError) as jerr:
        jconn.CarrySnapshot("s", {}, arrays).to_bytes()
    with pytest.raises(ValueError) as terr:
        tconn.CarrySnapshot("s", {}, arrays).to_bytes()
    assert str(terr.value) == str(jerr.value)


# --------------------------------------------------------------------------
# cross-package attach: a blob continues the stream in the other package
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("direction", ["jax->port", "port->jax"])
@pytest.mark.parametrize("K", [1, 3])
def test_cross_package_attach_continues_byte_for_byte(backend, direction, K):
    W = _weights(9)
    ext = _raster(10, 14)
    want = _one_shot(W, ext)
    js, ts = _servers(W, backend, K=K, chunk=5)
    src, dst = (js, ts) if direction == "jax->port" else (ts, js)
    sconn = (jconn if src is js else tconn).InMemoryCarryConnector()
    uid = src.attach("mig")
    first = src.feed({uid: ext[:6]})[uid]["spikes"]
    src.detach_stream(uid, sconn)
    blob = sconn._store[jconn._key_token(uid)][1]
    dmod = jconn if dst is js else tconn
    dst.attach("busy")  # the stream lands in slot 1, not the one it left
    dst.attach_stream(dmod.CarrySnapshot.from_bytes(blob), uid=uid)
    assert dst.slot_of(uid) == 1
    second = dst.feed({uid: ext[6:]})[uid]["spikes"]
    got = np.concatenate([np.asarray(first), np.asarray(second)])
    assert got.dtype == np.int32 and np.array_equal(got, want)
    assert dst.streams[uid].steps == 14


def test_file_written_by_jax_restores_in_the_port(tmp_path):
    W = _weights(11)
    ext = {u: _raster(12 + i, 13) for i, u in enumerate(("x", "y"))}
    want = {u: _one_shot(W, r) for u, r in ext.items()}
    js, _ = _servers(W)
    for u in ext:
        js.attach(u)
    first = js.feed({u: r[:5] for u, r in ext.items()})
    assert js.checkpoint_streams(
        jconn.FileCarryConnector(str(tmp_path))) == ["x", "y"]
    del js                                   # the server dies
    conn = tconn.FileCarryConnector(str(tmp_path))
    assert conn.stream_ids() == ["x", "y"]
    _, ts = _servers(W, "cuda")
    assert ts.restore_streams(conn) == ["x", "y"]
    assert len(conn) == 0
    second = ts.feed({u: r[5:] for u, r in ext.items()})
    for u in ext:
        got = np.concatenate([first[u]["spikes"], second[u]["spikes"]])
        assert np.array_equal(got, want[u])


# --------------------------------------------------------------------------
# the connectors and the server's connector half
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["memory", "file"])
def test_connector_crud_contract(kind, tmp_path):
    conn = (tconn.InMemoryCarryConnector() if kind == "memory"
            else tconn.FileCarryConnector(str(tmp_path / "c")))
    snap = _snap()
    assert conn.select("s") is None and not conn.evict("s")
    conn.insert("s", snap)
    conn.insert(("t", 2), snap)
    assert "s" in conn and len(conn) == 2
    # recovered ids are the header's repr parsed back (ints, strs, tuples)
    assert conn.stream_ids() == (["s", "s"] if kind == "file"
                                 else sorted(["s", ("t", 2)], key=repr))
    got = conn.select("s", snap.slot_params)
    assert got.stream_id == repr("s") and got.meta == snap.meta
    for name, arr in snap.arrays.items():
        assert np.array_equal(got.arrays[name], arr)
    with pytest.raises(ValueError, match="incompatible: n_phys"):
        conn.select("s", dict(snap.slot_params, n_phys=3))
    assert conn.evict("s") and "s" not in conn
    if kind == "file":
        assert not [f for f in (tmp_path / "c").iterdir()
                    if f.name.endswith(".tmp")]
        (tmp_path / "c" / (tconn._key_token(("t", 2)) + ".carry")
         ).write_bytes(b"SNAPC junk")
        with pytest.raises(ValueError, match="corrupt carry snapshot"):
            conn.select(("t", 2))


@pytest.mark.parametrize("backend", BACKENDS)
def test_migrate_stream_matches_jax(backend):
    W = _weights(14)
    ext = _raster(15, 12)
    js, ts = _servers(W, backend, n_slots=4)
    outs = []
    for s, mod in ((js, jconn), (ts, tconn)):
        uid = s.attach()
        first = s.feed({uid: ext[:7]})[uid]["spikes"]
        assert mod.migrate_stream(s, uid, slot=3) == 0
        assert mod.migrate_stream(s, uid, slot=3) == 3  # same slot: no-op
        assert not np.asarray(s.carry["v"][0]).any()
        second = s.feed({uid: ext[7:]})[uid]["spikes"]
        outs.append(np.concatenate([np.asarray(first), np.asarray(second)]))
    assert np.array_equal(outs[1], outs[0])
    assert np.array_equal(outs[1], _one_shot(W, ext))


@pytest.mark.parametrize("flagged,live", [
    ([True, False, False, False], ["s0", "s1", "s2"]),
    ([True, True, False, False], ["a", "b", "c", "d", "e"]),
    ([False, True, False, True], [0, 1, 2, 3, 4, 5]),
    ([False, False], ["a"]), ([True, True], ["a"])])
def test_rebalance_streams_makes_the_jax_moves(flagged, live):
    W = _weights(16)
    js, ts = _servers(W, "cuda", n_slots=8)
    rasters = {u: _raster(17 + i, 10) for i, u in enumerate(live)}
    for s in (js, ts):
        for u in live:
            s.attach(u)
        s.feed({u: r[:4] for u, r in rasters.items()})
    want = jconn.rebalance_streams(js, flagged, slots_per_shard=2)
    got = tconn.rebalance_streams(ts, flagged, slots_per_shard=2)
    assert got == want
    assert ts.scheduler.active == js.scheduler.active
    jo = js.feed({u: r[4:] for u, r in rasters.items()})
    to = ts.feed({u: r[4:] for u, r in rasters.items()})
    for u in live:
        assert np.array_equal(to[u]["spikes"], np.asarray(jo[u]["spikes"]))


def _errors(server, mod):
    """Each misuse of the connector half, as (exception type, message)."""
    uid = server.attach("a")
    server.attach("b")
    server.attach("c")                  # both slots taken: "c" waits
    server.feed({uid: _raster(20, 3)})
    snap = server.snapshot_stream(uid)
    other = mod.CarrySnapshot(snap.stream_id,
                              dict(snap.slot_params, threshold_raw=5),
                              snap.arrays, snap.meta)
    conn = mod.InMemoryCarryConnector()
    out = []
    for call in (
            lambda: server.attach_stream(other, uid="x"),
            lambda: server.attach_stream(snap, uid="x"),    # no free slot
            lambda: server.attach_stream(conn),             # no uid
            lambda: server.attach_stream(conn, "ghost"),    # nothing parked
            lambda: server.snapshot_stream("c"),            # waiting
            lambda: mod.migrate_stream(server, "c", slot=0),
            lambda: server.scheduler.submit_at("z", 0)):
        try:
            call()
            out.append(None)
        except Exception as e:  # noqa: BLE001 - compared across packages
            out.append((type(e).__name__, str(e)))
    return out


def test_connector_misuse_raises_as_in_jax():
    W = _weights(21)
    js, ts = _servers(W, "cuda", n_slots=2)
    want, got = _errors(js, jconn), _errors(ts, tconn)
    assert got == want
    assert all(e is not None for e in got)


# --------------------------------------------------------------------------
# the session: rolling redeploy, waiting streams, recovery
# --------------------------------------------------------------------------

def _nets(seed, shapes=((6, 12), (5, 10), (4, 9))):
    rng = np.random.default_rng(seed)
    out = []
    for n_in, n in shapes:
        W = ((rng.random((n_in + n, n)) < 0.4)
             * rng.normal(0.0, 0.5, (n_in + n, n))).astype(np.float32)
        out.append([cls(n_inputs=n_in, n_neurons=n, weights=W,
                        params=lif(decay_rate=0.25, threshold=1.0,
                                   reset_mode="zero"),
                        output_slice=(n - 4, n))
                    for cls, lif in ((JNet, JLIF), (TNet, TLIF))])
    return out


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("K", [1, 4])
def test_rolling_redeploy_continues_as_the_jax_session(backend, K):
    (jA, tA), (jB, tB), _ = _nets(22)
    rng = np.random.default_rng(23)
    ext = {u: (rng.random((13, 6)) < 0.4).astype(np.int32)
           for u in ("p", "q", "r")}
    js = JSession()
    ts = TSession(backend=backend, fuse_steps=K, device="cpu")
    js.deploy("A", jA), ts.deploy("A", tA)
    jv = js.serve("A", n_slots=2, chunk_steps=3)
    tv = ts.serve("A", n_slots=2, chunk_steps=3)
    for v in (jv, tv):
        for u in ext:                   # "r" waits for a slot
            v.attach(u)
    jo = jv.feed_many({u: ext[u][:5] for u in ("p", "q")})
    to = tv.feed_many({u: ext[u][:5] for u in ("p", "q")})
    js.deploy("B", jB), ts.deploy("B", tB)   # parks p and q, re-queues r
    with pytest.raises(RuntimeError, match="stale"):
        tv.feed("p", ext["p"][5:6])
    jv = js.serve("A", n_slots=2, chunk_steps=3)
    tv = ts.serve("A", n_slots=2, chunk_steps=3)
    assert tv.server.scheduler.active == jv.server.scheduler.active
    assert tv.server.scheduler.waiting == ["r"]
    jo2 = jv.feed_many({u: ext[u][5:] for u in ("p", "q")})
    to2 = tv.feed_many({u: ext[u][5:] for u in ("p", "q")})
    for u in ("p", "q"):
        for a, b in ((jo, to), (jo2, to2)):
            assert np.array_equal(b[u]["spikes"], np.asarray(a[u]["spikes"]))
            assert np.array_equal(b[u]["output_counts"],
                                  np.asarray(a[u]["output_counts"]))
        assert tv.server.streams[u].steps == 13
    assert len(ts.connector) == len(js.connector) == 0


def test_redeploy_parks_what_does_not_fit(tmp_path):
    """Parked carries wait in a file connector until a server has room."""
    (jA, tA), (jB, tB), _ = _nets(24)
    ts = TSession(device="cpu",
                  connector=tconn.FileCarryConnector(str(tmp_path)))
    ts.deploy("A", tA)
    v = ts.serve("A", n_slots=3, chunk_steps=4)
    for u in range(3):
        v.attach(u)
    v.feed_many({u: _raster(25 + u, 4, 6) for u in range(3)})
    ts.deploy("B", tB)
    assert len(ts.connector) == 3
    v2 = ts.serve("A", n_slots=2, chunk_steps=4)   # room for two of three
    assert list(v2.server.scheduler.active) == [0, 1]
    assert len(ts.connector) == 1
    with pytest.raises(ValueError, match="already served"):
        ts.serve("A", n_slots=3, chunk_steps=4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_crash_recovery_from_a_port_checkpoint(backend, tmp_path):
    W = _weights(26)
    ext = {u: _raster(27 + i, 15) for i, u in enumerate(("x", "y", "z"))}
    want = {u: _one_shot(W, r) for u, r in ext.items()}
    _, ts = _servers(W, backend)
    for u in ext:
        ts.attach(u)
    first = ts.feed({u: r[:6] for u, r in ext.items()})
    conn = tconn.FileCarryConnector(str(tmp_path))
    assert ts.checkpoint_streams(conn) == ["x", "y", "z"]
    # the barrier is non-destructive: the live server runs on
    again = ts.feed({"x": ext["x"][6:8]})
    assert np.array_equal(again["x"]["spikes"], want["x"][6:8])
    _, fresh = _servers(W, backend, n_slots=2)
    assert fresh.restore_streams(
        tconn.FileCarryConnector(str(tmp_path))) == ["x", "y"]
    assert conn.stream_ids() == ["z"]
    second = fresh.feed({u: ext[u][6:] for u in ("x", "y")})
    for u in ("x", "y"):
        got = np.concatenate([first[u]["spikes"], second[u]["spikes"]])
        assert np.array_equal(got, want[u])
        assert fresh.streams[u].steps == 15


# --------------------------------------------------------------------------
# the straggler detector the rebalance pass and the obs layer read
# --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_detector_flags_as_in_jax(seed):
    rng = np.random.default_rng(seed)
    n = 6
    jd = jstrag.StragglerDetector(num_hosts=n, warmup_steps=3, patience=2)
    td = tstrag.StragglerDetector(num_hosts=n, warmup_steps=3, patience=2)
    for step in range(40):
        t = rng.normal(1.0, 0.05, n)
        if step > 10:
            t[seed] *= 3.0
        assert np.array_equal(td.observe(t), jd.observe(t))
    for k in jd.stats:
        assert np.array_equal(td.stats[k], jd.stats[k])
    flags = jd.observe(rng.normal(1.0, 0.05, n))
    assert np.array_equal(tstrag.donor_shards(flags),
                          jstrag.donor_shards(flags))
    for total in (8, 12, 13):
        assert np.array_equal(tstrag.rebalance_shards(total, flags),
                              jstrag.rebalance_shards(total, flags))
