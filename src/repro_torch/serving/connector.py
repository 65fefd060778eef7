"""Stream-state carry connector — the membrane carry as a movable payload.

SNAP-V keeps each neuron's membrane potential in distributed per-node
memory; in this reproduction that state is the per-slot carry inside
:class:`~repro_torch.serving.snn.SpikeServer`, and it is the system's KV cache:
the one thing that binds a live stream to one server, one mesh, one host.
This module unbinds it, the way vLLM's ``KVConnectorBase`` unbinds the KV
cache from one engine (and FeNN-DMA unbinds neuron state from pinned SRAM
by making it DMA-able payload):

  * :func:`slot_params_of` — the strict carry-compatibility identity of an
    engine: ``(n_phys, decay, threshold_raw, reset_mode)``. Deliberately
    EXCLUDES backend, gate, ``fuse_steps``, mesh shape, and the input
    width — byte-identity holds across all of those re-hostings (pinned by
    the engine test suite), so a snapshot taken under one may restore
    under any other.
  * :class:`CarrySnapshot` — one stream's portable state: membrane
    potentials + last-spike vector (the carry), the step/spike counters,
    and the slot params it is only valid against. Serializes to a
    versioned, CRC-checked host-memory blob; restore is dtype- and
    shape-checked and rejects corrupted blobs.
  * :class:`CarryConnectorBase` — ``insert`` / ``select`` / ``evict`` over
    ``(stream_id, slot_params)`` keys, with :class:`InMemoryCarryConnector`
    (spill to host memory) and :class:`FileCarryConnector` (spill to disk;
    atomic writes, survives the server process) implementations. Both
    store the *serialized* blob, so every select round-trips the wire
    format and a corrupted store fails loudly, never silently.
  * :func:`migrate_stream` / :func:`rebalance_streams` — intra-server slot
    moves, and the mesh load-balancing pass that walks streams off
    straggler-flagged batch shards onto the donor shards' free slots.

Governing contract (pinned against the JAX twin by
tests/test_torch_connector.py): a stream detached to a snapshot and
re-attached anywhere compatible — same server, a different server, a
different mesh shape, another ``gate`` / ``fuse_steps`` / backend
hosting, after a session redeploy, or out of a file after a crash —
produces an output raster byte-identical to the never-migrated run.
Migration changes WHERE a stream's state lives, never one bit of what it
computes.

Twin of :mod:`repro.serving.connector` (the same code, numpy and the
standard library only; the port imports nothing of the JAX package).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import struct
import zlib

import numpy as np

__all__ = [
    "SNAPSHOT_MAGIC",
    "SNAPSHOT_VERSION",
    "CarryConnectorBase",
    "CarrySnapshot",
    "FileCarryConnector",
    "InMemoryCarryConnector",
    "migrate_stream",
    "rebalance_streams",
    "slot_params_of",
]

#: wire-format magic + version. Bump the version on any layout change;
#: readers reject versions they do not know instead of guessing.
SNAPSHOT_MAGIC = b"SNAPC"
SNAPSHOT_VERSION = 1

# dtypes a snapshot may carry. The carry contract is int32, but the wire
# format is generic over the table so counters/metadata arrays added by a
# future version (refractory timers, eligibility traces) need no format
# bump — only a new array name.
_DTYPES = ("int8", "uint8", "int16", "uint16", "int32", "uint32",
           "int64", "uint64", "float32", "float64", "bool")


def slot_params_of(engine) -> dict:
    """The carry-compatibility identity of an engine.

    Two engines with equal slot params hold interchangeable slot carries:
    a ``(n_phys,)`` int32 membrane vector plus last-spike vector evolves
    identically under both (same decay, same threshold, same reset), so a
    snapshot moves between them without changing one bit of the stream's
    future. Everything else — backend, gate, ``fuse_steps``, mesh, input
    width, co-residents — is a *hosting* choice the engine's byte-identity
    contracts already quotient out, and is deliberately absent here.
    """
    decay = engine.decay
    return {
        "n_phys": int(engine.n_phys),
        "decay_kind": str(decay.kind),
        "decay_rate": float(decay.rate),
        "decay_raw": int(decay.raw),
        "threshold_raw": int(engine.threshold_raw),
        "reset_mode": str(engine.reset_mode),
    }


def _key_token(stream_id) -> str:
    """Stable storage token for an arbitrary (repr-able) stream id."""
    rep = repr(stream_id)
    return hashlib.sha256(rep.encode("utf-8")).hexdigest()[:32]


@dataclasses.dataclass
class CarrySnapshot:
    """One stream's portable state: carry + counters + compatibility key.

    ``arrays`` holds the slot carry — ``'v'`` (membrane potentials) and
    ``'spikes'`` (last emitted spike vector), each ``(n_phys,)`` int32
    under the carry contract (the wire format itself is generic over
    dtype/shape; :meth:`check_compatible` enforces the contract at
    restore). ``meta`` carries the stream's counters (``steps``,
    ``spike_count``) so accounting survives migration; there is no
    refractory state in this LIF model, but a future counter rides in
    ``meta``/``arrays`` without a format bump.
    """

    stream_id: object
    slot_params: dict
    arrays: dict            # name -> np.ndarray
    meta: dict = dataclasses.field(default_factory=dict)
    version: int = SNAPSHOT_VERSION

    # -- wire format -------------------------------------------------------
    # MAGIC(5) | version u16 LE | header_len u32 LE | header JSON (utf-8)
    # | raw array payloads (header order, C-contiguous LE) | crc32 u32 LE
    # over everything before it.
    def to_bytes(self) -> bytes:
        header = {
            "stream_id": repr(self.stream_id),
            "slot_params": self.slot_params,
            "meta": self.meta,
            "arrays": [
                {"name": name, "dtype": str(arr.dtype),
                 "shape": list(arr.shape)}
                for name, arr in self.arrays.items()
            ],
        }
        for spec in header["arrays"]:
            if spec["dtype"] not in _DTYPES:
                raise ValueError(
                    f"array {spec['name']!r}: dtype {spec['dtype']} is not "
                    f"snapshot-serializable (one of {_DTYPES})")
        hdr = json.dumps(header, sort_keys=True).encode("utf-8")
        parts = [SNAPSHOT_MAGIC,
                 struct.pack("<HI", self.version, len(hdr)), hdr]
        for name, arr in self.arrays.items():
            a = np.ascontiguousarray(arr)
            if a.dtype.byteorder == ">":  # pragma: no cover - exotic hosts
                a = a.astype(a.dtype.newbyteorder("<"))
            parts.append(a.tobytes())
        body = b"".join(parts)
        return body + struct.pack("<I", zlib.crc32(body) & 0xFFFFFFFF)

    @classmethod
    def from_bytes(cls, blob: bytes) -> "CarrySnapshot":
        """Parse + validate a snapshot blob; raises ``ValueError`` on any
        corruption (bad magic, unknown version, CRC mismatch, truncated or
        oversized payload, malformed header)."""
        if len(blob) < len(SNAPSHOT_MAGIC) + 6 + 4:
            raise ValueError("corrupt carry snapshot: truncated blob")
        if blob[: len(SNAPSHOT_MAGIC)] != SNAPSHOT_MAGIC:
            raise ValueError(
                f"corrupt carry snapshot: bad magic "
                f"{blob[:len(SNAPSHOT_MAGIC)]!r}")
        body, (crc_stored,) = blob[:-4], struct.unpack("<I", blob[-4:])
        if zlib.crc32(body) & 0xFFFFFFFF != crc_stored:
            raise ValueError("corrupt carry snapshot: CRC mismatch")
        off = len(SNAPSHOT_MAGIC)
        version, hdr_len = struct.unpack_from("<HI", body, off)
        if version != SNAPSHOT_VERSION:
            raise ValueError(
                f"carry snapshot version {version} is not supported "
                f"(reader knows version {SNAPSHOT_VERSION})")
        off += 6
        if off + hdr_len > len(body):
            raise ValueError("corrupt carry snapshot: truncated header")
        try:
            header = json.loads(body[off:off + hdr_len].decode("utf-8"))
            specs = header["arrays"]
            slot_params = header["slot_params"]
            meta = header["meta"]
            stream_id = header["stream_id"]
        except (ValueError, KeyError, UnicodeDecodeError) as e:
            raise ValueError(
                f"corrupt carry snapshot: malformed header ({e})") from e
        off += hdr_len
        arrays: dict = {}
        for spec in specs:
            if spec["dtype"] not in _DTYPES:
                raise ValueError(
                    f"corrupt carry snapshot: unknown dtype "
                    f"{spec['dtype']!r}")
            dt = np.dtype(spec["dtype"]).newbyteorder("<")
            shape = tuple(int(s) for s in spec["shape"])
            nbytes = dt.itemsize * int(np.prod(shape, dtype=np.int64))
            if off + nbytes > len(body):
                raise ValueError(
                    "corrupt carry snapshot: truncated array payload")
            arrays[spec["name"]] = np.frombuffer(
                body, dtype=dt, count=int(np.prod(shape, dtype=np.int64)),
                offset=off).reshape(shape).astype(np.dtype(spec["dtype"]))
            off += nbytes
        if off != len(body):
            raise ValueError(
                "corrupt carry snapshot: trailing bytes after payload")
        return cls(stream_id=stream_id, slot_params=slot_params,
                   arrays=arrays, meta=meta, version=version)

    # -- restore-side validation ------------------------------------------
    def check_compatible(self, params: dict) -> None:
        """Raise ``ValueError`` naming the first field on which this
        snapshot cannot restore into a slot with ``params`` (see
        :func:`slot_params_of`), or on a carry array with the wrong
        dtype/shape for the target."""
        for field in ("n_phys", "decay_kind", "decay_rate", "decay_raw",
                      "threshold_raw", "reset_mode"):
            if self.slot_params.get(field) != params[field]:
                raise ValueError(
                    f"carry snapshot for stream {self.stream_id!r} is "
                    f"incompatible: {field}="
                    f"{self.slot_params.get(field)!r} != {params[field]!r}")
        n_phys = params["n_phys"]
        for name in ("v", "spikes"):
            arr = self.arrays.get(name)
            if arr is None:
                raise ValueError(
                    f"carry snapshot for stream {self.stream_id!r} is "
                    f"missing array {name!r}")
            if arr.dtype != np.int32:
                raise ValueError(
                    f"carry snapshot array {name!r}: dtype {arr.dtype} "
                    f"!= int32 (the carry contract)")
            if arr.shape != (n_phys,):
                raise ValueError(
                    f"carry snapshot array {name!r}: shape {arr.shape} "
                    f"!= ({n_phys},)")


class CarryConnectorBase:
    """insert/select/evict over ``(stream_id, slot_params)`` keys.

    The store is keyed by ``stream_id``; the snapshot carries its
    ``slot_params`` half of the key, and :meth:`select` re-checks it when
    the caller supplies the target's params — so a stream id can never
    silently resolve to state for an incompatible engine. Implementations
    store the serialized blob: every select round-trips the wire format,
    so a corrupted store raises at select, not at step time.

    :meth:`instrument` opts a connector into telemetry: every insert
    (op=``snapshot``) and hit select (op=``restore``) counts ops, blob
    bytes, and latency into the registry and records a span. Pure
    accounting around the store — the stored bytes are untouched.
    """

    metrics = None
    tracer = None

    def instrument(self, metrics=None, tracer=None) -> "CarryConnectorBase":
        """Attach a MetricsRegistry / SpanTracer; returns self."""
        self.metrics = metrics
        self.tracer = tracer
        return self

    def _obs_clock(self):
        if self.metrics is not None:
            return self.metrics.clock
        if self.tracer is not None:
            return self.tracer.clock
        return None

    def _obs_op(self, op: str, stream_id, nbytes: int, t0: float) -> None:
        clock = self._obs_clock()
        now = clock()
        if self.metrics is not None:
            m = self.metrics
            m.counter("snn_connector_ops_total").labels(op=op).inc()
            m.counter("snn_connector_bytes_total").labels(op=op).inc(nbytes)
            m.histogram("snn_connector_op_seconds").labels(
                op=op).observe(now - t0)
        if self.tracer is not None:
            from repro_torch.obs.tracing import Span

            self.tracer._record(
                Span(op, stream_id, t0, now, {"nbytes": nbytes}))

    def insert(self, stream_id, snapshot: CarrySnapshot) -> None:
        """Park (or overwrite) a stream's snapshot under ``stream_id``."""
        raise NotImplementedError

    def select(self, stream_id, slot_params: dict | None = None
               ) -> CarrySnapshot | None:
        """The parked snapshot for ``stream_id`` (None if absent). With
        ``slot_params``, an incompatible parked snapshot raises instead
        of restoring wrong state."""
        raise NotImplementedError

    def evict(self, stream_id) -> bool:
        """Drop a parked snapshot; True if one was present."""
        raise NotImplementedError

    def stream_ids(self) -> list:
        """Parked stream ids (recovery enumerates these), sorted by repr
        so recovery order is deterministic regardless of store order."""
        raise NotImplementedError

    def __contains__(self, stream_id) -> bool:
        return self.select(stream_id) is not None

    def __len__(self) -> int:
        return len(self.stream_ids())


class InMemoryCarryConnector(CarryConnectorBase):
    """Host-memory connector: spill target + migration scratchpad.

    This is what makes slot count stop bounding concurrent streams: a
    cold stream's carry lives here (a few hundred bytes) instead of
    holding a slot.
    """

    def __init__(self):
        self._store: dict = {}   # key token -> (stream_id, blob)

    def insert(self, stream_id, snapshot: CarrySnapshot) -> None:
        clock = self._obs_clock()
        t0 = clock() if clock else 0.0
        blob = snapshot.to_bytes()
        self._store[_key_token(stream_id)] = (stream_id, blob)
        if clock:
            self._obs_op("snapshot", stream_id, len(blob), t0)

    def select(self, stream_id, slot_params: dict | None = None
               ) -> CarrySnapshot | None:
        clock = self._obs_clock()
        t0 = clock() if clock else 0.0
        hit = self._store.get(_key_token(stream_id))
        if hit is None:
            return None
        snap = CarrySnapshot.from_bytes(hit[1])
        if slot_params is not None:
            snap.check_compatible(slot_params)
        if clock:
            self._obs_op("restore", stream_id, len(hit[1]), t0)
        return snap

    def evict(self, stream_id) -> bool:
        return self._store.pop(_key_token(stream_id), None) is not None

    def stream_ids(self) -> list:
        return sorted((sid for sid, _ in self._store.values()), key=repr)


class FileCarryConnector(CarryConnectorBase):
    """Disk-backed connector: snapshots survive the server process.

    One ``<token>.carry`` file per stream under ``root`` (token = hash of
    the stream id's repr; the id itself is recovered from the blob
    header). Writes are atomic (tmp + ``os.replace``) so a crash mid-write
    leaves the previous snapshot intact, never a torn one — the property
    the crash-recovery test leans on.
    """

    SUFFIX = ".carry"

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, stream_id) -> str:
        return os.path.join(self.root, _key_token(stream_id) + self.SUFFIX)

    def insert(self, stream_id, snapshot: CarrySnapshot) -> None:
        clock = self._obs_clock()
        t0 = clock() if clock else 0.0
        path = self._path(stream_id)
        tmp = path + ".tmp"
        blob = snapshot.to_bytes()
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
        if clock:
            self._obs_op("snapshot", stream_id, len(blob), t0)

    def select(self, stream_id, slot_params: dict | None = None
               ) -> CarrySnapshot | None:
        clock = self._obs_clock()
        t0 = clock() if clock else 0.0
        path = self._path(stream_id)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            blob = f.read()
        snap = CarrySnapshot.from_bytes(blob)
        if slot_params is not None:
            snap.check_compatible(slot_params)
        if clock:
            self._obs_op("restore", stream_id, len(blob), t0)
        return snap

    def evict(self, stream_id) -> bool:
        try:
            os.remove(self._path(stream_id))
            return True
        except FileNotFoundError:
            return False

    def stream_ids(self) -> list:
        ids = []
        for fname in os.listdir(self.root):
            if not fname.endswith(self.SUFFIX):
                continue
            with open(os.path.join(self.root, fname), "rb") as f:
                snap = CarrySnapshot.from_bytes(f.read())
            # header stores repr(stream_id); recovered ids are the reprs
            # parsed back by the caller's attach (the server restores
            # under the recovered id verbatim, so round-trips are exact
            # for the str/int ids serving traffic actually uses).
            ids.append(_parse_stream_id(snap.stream_id))
        return sorted(ids, key=repr)


def _parse_stream_id(rep: str):
    """Invert ``repr`` for the id types serving traffic uses (ints, strs,
    tuples of those). Anything fancier comes back as the repr string —
    still a stable, unique recovery key."""
    import ast

    try:
        return ast.literal_eval(rep)
    except (ValueError, SyntaxError):
        return rep


# --------------------------------------------------------------------------
# Live migration passes
# --------------------------------------------------------------------------

def migrate_stream(server, uid, *, slot: int) -> int:
    """Move a live stream to a specific free slot of the same server.

    snapshot -> detach (zeroes the old slot) -> attach into ``slot``.
    The stream keeps its uid, counters, and — the contract — its future:
    the output raster continues byte-identically, because a slot index is
    an address, not a parameter of the step. Returns the old slot.
    """
    old = server.slot_of(uid)
    if old is None:
        raise ValueError(f"stream {uid!r} is waiting; nothing to migrate")
    if slot == old:
        return old
    metrics = getattr(server, "metrics", None)
    tracer = getattr(server, "tracer", None)
    clock = (metrics.clock if metrics is not None
             else tracer.clock if tracer is not None else None)
    t0 = clock() if clock else 0.0
    snap = server.snapshot_stream(uid)
    server.detach(uid, reason="parked")
    server.attach_stream(snap, uid=uid, slot=slot)
    if metrics is not None:
        nbytes = sum(a.nbytes for a in snap.arrays.values())
        metrics.counter("snn_connector_ops_total").labels(op="migrate").inc()
        metrics.counter("snn_connector_bytes_total").labels(
            op="migrate").inc(nbytes)
        metrics.histogram("snn_connector_op_seconds").labels(
            op="migrate").observe(clock() - t0)
    if tracer is not None:
        tracer.event("migrated", uid, from_slot=old, to_slot=slot)
    return old


def rebalance_streams(server, flagged, *, slots_per_shard: int) -> list:
    """Walk streams off straggler-flagged batch shards onto donor shards.

    ``flagged`` is the straggler detector's per-shard bool mask (see
    :func:`repro_torch.distributed.straggler.donor_shards`); slots map onto
    batch shards contiguously (``shard = slot // slots_per_shard``, the
    same attribution ``serve_snn``'s ShardLoadWatch uses). Each move is a
    :func:`migrate_stream` — byte-identical by construction — from the
    busiest flagged shard's lowest live slot into the emptiest donor
    shard's lowest free slot (deterministic), until flagged shards hold
    no more live slots than the donors' emptiest or donors run out of
    free slots.

    Returns the moves as ``[(uid, from_slot, to_slot), ...]``.
    """
    from repro_torch.distributed.straggler import donor_shards

    flagged = np.asarray(flagged, bool)
    donors = set(int(d) for d in donor_shards(flagged))
    if not donors or donors == set(range(len(flagged))):
        return []

    def shard_of(slot: int) -> int:
        return min(slot // slots_per_shard, len(flagged) - 1)

    moves = []
    while True:
        active = server.scheduler.active          # uid -> slot
        free = server.scheduler.free_slot_ids
        load = _shard_loads(active, shard_of, len(flagged))
        donor_free = sorted(s for s in free if shard_of(s) in donors)
        if not donor_free:
            break
        # the most loaded flagged shard gives; stop when no flagged shard
        # is busier than the emptiest donor would become after taking one
        flagged_loads = [(load[sh], sh) for sh in range(len(flagged))
                         if flagged[sh] and load[sh] > 0]
        if not flagged_loads:
            break
        src_load, src_shard = max(flagged_loads)
        # receive into the EMPTIEST donor shard (lowest slot id on ties)
        dst = min(donor_free, key=lambda s: (load[shard_of(s)], s))
        if src_load <= load[shard_of(dst)] + 1:
            break  # a move would just relocate the imbalance
        uid, from_slot = min(
            ((u, s) for u, s in active.items()
             if shard_of(s) == src_shard), key=lambda kv: kv[1])
        migrate_stream(server, uid, slot=dst)
        moves.append((uid, from_slot, dst))
    return moves


def _shard_loads(active: dict, shard_of, n_shards: int) -> list:
    """Live-slot count per shard for an ``{uid: slot}`` map."""
    load = [0] * n_shards
    for slot in active.values():
        load[shard_of(slot)] += 1
    return load
