"""Streaming SNN serving — stateful spike streams over one chunk step.

Twin of :mod:`repro.serving.snn` for the synchronous serving path:

  * :class:`SlotScheduler` — admission of stream ids into a fixed set of
    batch slots: FIFO waiting queue, FIFO slot reuse.
  * :class:`SpikeServer` — owns the slot carry ``{v, spikes}`` on the
    engine's device, feeds chunks of external spikes through the masked
    chunk step, zeroes a slot on eviction, runs a closed loop, and moves
    a stream's carry in and out of a stream-state connector
    (:mod:`repro_torch.serving.connector`: snapshot, detach, attach from a
    snapshot, checkpoint and restore).
  * :class:`ModelStream` — a per-model view over a server running the
    fused multi-model engine (``AcceleratorSession.serve``), with the
    async ``submit`` of the group's shared frontend.

The carry leaves the device only in a snapshot. Each chunk moves only its
``(chunk_steps, n_slots, n_inputs)`` input and its mask to the device and
brings the spike raster back once. Exactness contract (as in the JAX
twin): for any chunking of a raster, the concatenated ``feed`` outputs are
byte-identical to one ``SpikeEngine.run`` on it, and ``feed_events``
(AER streams in, optionally AER out) is ``feed`` on the decoded chunks.
A stream snapshotted, detached and attached again anywhere compatible
continues byte for byte. The ``metrics`` / ``tracer`` hooks read the host
raster ``feed`` already brings back and never touch the card.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time

import numpy as np
import torch

from repro_torch.core.energy import SOPS_PER_ROW
from repro_torch.core.engine import SpikeEngine
from repro_torch.device import resolve_device
from repro_torch.events.aer import aer_to_dense, dense_to_aer

__all__ = ["ModelStream", "SlotScheduler", "SpikeServer", "StreamStats",
           "decode_aer_chunk"]

# Source-block granularity the measured-traffic counters account at: the
# kernels' block_src (one weight block per 128 source rows).
_OBS_BLOCK_SRC = 128


class SlotScheduler:
    """Fixed-slot admission bookkeeping (no array state).

    An active uid occupies exactly one slot; a freed slot goes to the
    longest-waiting uid; free slots are reused in FIFO order, so slot
    assignment is a deterministic function of the attach/detach sequence.
    """

    def __init__(self, n_slots: int):
        if n_slots <= 0:
            raise ValueError(f"n_slots must be positive, got {n_slots}")
        self.n_slots = int(n_slots)
        self._slot_of: dict = {}                      # uid -> slot
        self._free = collections.deque(range(n_slots))
        self._waiting: collections.deque = collections.deque()

    @property
    def active(self) -> dict:
        """{uid: slot} of admitted streams (copy)."""
        return dict(self._slot_of)

    @property
    def free_slots(self) -> int:
        """Slots with no resident stream (an admission front door checks
        this before attaching, so its own queue is the only place requests
        ever wait)."""
        return len(self._free)

    @property
    def free_slot_ids(self) -> list:
        """Free slot indices in FIFO-reuse order (copy); migration passes
        pick targeted destinations from this."""
        return list(self._free)

    @property
    def waiting(self) -> list:
        """uids queued for admission, FIFO order (copy)."""
        return list(self._waiting)

    def slot_of(self, uid) -> int | None:
        """The uid's slot, or None while it waits."""
        if uid in self._slot_of:
            return self._slot_of[uid]
        if uid in self._waiting:
            return None
        raise KeyError(f"unknown stream {uid!r}")

    def submit(self, uid) -> int | None:
        """Admit uid into a free slot, or queue it. Returns the slot or
        None (queued)."""
        if uid in self._slot_of or uid in self._waiting:
            raise ValueError(f"stream {uid!r} already submitted")
        if self._free:
            slot = self._free.popleft()
            self._slot_of[uid] = slot
            return slot
        self._waiting.append(uid)
        return None

    def submit_at(self, uid, slot: int) -> int:
        """Admit uid into a SPECIFIC free slot (migration / rebalance
        placement). Never queues: a targeted restore lands now or fails."""
        if uid in self._slot_of or uid in self._waiting:
            raise ValueError(f"stream {uid!r} already submitted")
        if slot not in self._free:
            raise ValueError(f"slot {slot} is not free")
        self._free.remove(slot)
        self._slot_of[uid] = slot
        return slot

    def release(self, uid) -> tuple[int, object | None]:
        """Free uid's slot; the FIFO-head waiter (if any) is admitted into
        it. Returns (freed_slot, admitted_uid_or_None). The caller must
        zero the slot's carry before the admitted stream is stepped."""
        if uid not in self._slot_of:
            raise KeyError(f"stream {uid!r} is not active")
        slot = self._slot_of.pop(uid)
        if self._waiting:
            nxt = self._waiting.popleft()
            self._slot_of[nxt] = slot
            return slot, nxt
        self._free.append(slot)
        return slot, None

    def cancel(self, uid) -> None:
        """Withdraw a WAITING uid (never touches slots)."""
        try:
            self._waiting.remove(uid)
        except ValueError:
            raise KeyError(f"stream {uid!r} is not waiting") from None


def decode_aer_chunk(stream, n_inputs: int, label: str = "AER chunk"
                     ) -> np.ndarray:
    """Validate and decode a single-lane ``(T, 1, n_inputs)`` AER chunk to
    its dense ``(T, n_inputs)`` int32 host raster: the entry contract of
    :meth:`SpikeServer.feed_events` (one lane per stream: the slot address
    inside the server is the server's business, not the caller's)."""
    T, lanes, n_src = stream.shape
    if lanes != 1 or n_src != n_inputs:
        raise ValueError(
            f"{label}: AER chunk must address (T, 1, {n_inputs}), "
            f"got {stream.shape}")
    return aer_to_dense(stream).cpu().numpy()[:, 0, :]


@dataclasses.dataclass
class StreamStats:
    """Per-stream accounting the server keeps while a stream lives."""

    uid: object
    steps: int = 0               # timesteps consumed so far
    spike_count: int = 0         # total output spikes emitted
    attached_at: float = 0.0     # wall clock at submit()
    admitted_at: float | None = None  # wall clock at slot grant


class SpikeServer:
    """Stateful streaming server: churning spike streams, one chunk step.

    The server pins the slot-batch shape ``(chunk_steps, n_slots)``: every
    :meth:`feed` is processed as full chunks padded with inactive steps.
    Slot carries persist across calls on ``device`` (default ``"cuda"``;
    the engine is re-hosted there if it lives elsewhere); :meth:`detach`
    zeroes the evicted slot. ``gate`` re-hosts the engine under another
    event-gate granularity, ``fuse_steps`` under another K-step fused
    window (identical outputs either way). ``chunk_steps`` need not be a
    multiple of K: the engine pads a window's remainder with inactive
    steps.

    ``mesh`` (a :class:`~repro_torch.distributed.spike_mesh.SpikeMesh`)
    scales the server out: the engine is re-hosted as a
    :class:`~repro_torch.distributed.spike_mesh.MeshSpikeEngine` and the
    slot carry stays sharded, each slot's rows on the batch shard that
    owns it (``slot // slots_per_shard``); ``feed`` is byte-identical. The
    mesh's devices place the shards, so ``device`` is not used with a
    mesh engine.

    ``metrics`` / ``tracer`` (a
    :class:`~repro_torch.obs.metrics.MetricsRegistry` / a
    :class:`~repro_torch.obs.tracing.SpanTracer`) opt the server into
    telemetry: per-chunk latency, slot occupancy and measured SOP /
    weight-traffic counters, read from the host raster each dispatch
    already brings back. With both ``None`` the datapath does no extra
    work.
    """

    def __init__(self, engine: SpikeEngine, *, n_slots: int = 8,
                 chunk_steps: int = 8, gate: str | None = None,
                 fuse_steps: int | None = None, device="cuda", mesh=None,
                 metrics=None, tracer=None):
        if chunk_steps <= 0:
            raise ValueError(f"chunk_steps must be positive, got {chunk_steps}")
        if getattr(engine, "mesh", None) is None and mesh is None:
            engine = engine.to_device(resolve_device(device))
        if gate is not None:
            engine = engine.with_gate(gate)
        if fuse_steps is not None:
            engine = engine.with_fuse_steps(fuse_steps)
        if mesh is not None and getattr(engine, "mesh", None) != mesh:
            engine = engine.to_mesh(mesh)
        self.engine = engine
        self.device = engine.device
        self.n_slots = int(n_slots)
        self.chunk_steps = int(chunk_steps)
        self.scheduler = SlotScheduler(n_slots)
        self.carry = engine.init_carry(self.n_slots)
        self.streams: dict = {}      # uid -> StreamStats (active + waiting)
        self._auto_uid = itertools.count()
        self.total_steps = 0         # slot-timesteps consumed (all streams)
        self.metrics = metrics
        self.tracer = tracer
        self._prev_host = None       # (n_slots, n_phys) recurrent mirror
        if metrics is not None:
            w = engine.weights_raw.cpu().numpy()
            # per-source accounting vectors (events.trace semantics): real
            # nonzero fanout, and nonzero SOPS_PER_ROW-wide row segments
            self._fanout = np.count_nonzero(w, axis=1).astype(np.int64)
            pad = (-w.shape[1]) % SOPS_PER_ROW
            wp = np.pad(w, ((0, 0), (0, pad))) if pad else w
            self._rowseg = (
                (wp.reshape(w.shape[0], -1, SOPS_PER_ROW) != 0)
                .any(axis=2).sum(axis=1).astype(np.int64))
            self._n_src_blocks = -(-engine.n_sources // _OBS_BLOCK_SRC)
            self._prev_host = np.zeros(
                (self.n_slots, engine.n_phys), np.int32)
            metrics.gauge("snn_server_slots_total").set(self.n_slots)
            metrics.gauge("snn_server_slots_occupied").set(0)

    # -- observability ----------------------------------------------------
    def _obs_clock(self):
        if self.metrics is not None:
            return self.metrics.clock
        return self.tracer.clock

    def _obs_occupancy(self) -> None:
        if self.metrics is not None:
            self.metrics.gauge("snn_server_slots_occupied").set(
                len(self.scheduler.active))

    def _obs_count_chunk(self, ext_u: np.ndarray, out_u: np.ndarray,
                         prev_row: np.ndarray) -> np.ndarray:
        """Measured-event accounting for ONE stream's (n, ...) raster
        slice (the closed-loop path): source events, SOPs (events x real
        fanout), row fetches and per-example-gate weight-block traffic, as
        :func:`repro_torch.events.trace.trace_run` measures them. Returns
        the stream's new recurrent row."""
        m = self.metrics
        prev_u = np.concatenate([prev_row[None, :], out_u[:-1]], axis=0)
        src = np.concatenate([ext_u, prev_u], axis=1) != 0  # (n, S)
        m.counter("snn_server_source_events_total").labels(
            kind="external").inc(int(np.count_nonzero(ext_u)))
        m.counter("snn_server_source_events_total").labels(
            kind="recurrent").inc(int(np.count_nonzero(prev_u)))
        per_src = src.sum(axis=0, dtype=np.int64)  # (S,) event counts
        m.counter("snn_server_sops_total").inc(int(per_src @ self._fanout))
        m.counter("snn_server_row_fetches_total").inc(
            int(per_src @ self._rowseg))
        n, S = src.shape
        pad = self._n_src_blocks * _OBS_BLOCK_SRC - S
        if pad:
            src = np.pad(src, ((0, 0), (0, pad)))
        touched = int(src.reshape(n, self._n_src_blocks, _OBS_BLOCK_SRC)
                      .any(axis=2).sum())
        m.counter("snn_server_weight_blocks_fetched_total").inc(touched)
        m.counter("snn_server_weight_blocks_dense_total").inc(
            n * self._n_src_blocks)
        return out_u[-1]

    def _obs_feed_chunk(self, t_start: float, active: np.ndarray,
                        spikes: np.ndarray, ext: np.ndarray,
                        chunks: dict, t0: int) -> None:
        """Record one chunk dispatch: latency, step / spike counters, a
        ``chunk_step`` span, and the measured-event accounting in ONE
        vectorised pass over the ``(T, n_slots, ...)`` host raster.
        Inactive (slot, step) rows are masked out, so the counters equal
        per-stream slicing on ragged chunks."""
        from repro_torch.obs.tracing import Span

        dt = self._obs_clock()() - t_start
        n_active = int(active.sum())
        if self.tracer is not None:
            now = self.tracer.clock()
            # participating uids in slot order, so a timeline can
            # attribute the chunk to its streams
            uids = [uid for uid, (slot, arr) in
                    sorted(chunks.items(), key=lambda kv: kv[1][0])
                    if arr.shape[0] - t0 > 0]
            self.tracer._record(Span(
                "chunk_step", None, now - dt, now,
                {"steps": n_active, "streams": len(chunks), "uids": uids}))
        if self.metrics is None:
            return
        m = self.metrics
        m.histogram("snn_server_chunk_latency_seconds").observe(dt)
        m.counter("snn_server_chunks_total").inc()
        m.counter("snn_server_steps_total").inc(n_active)
        m.counter("snn_server_spikes_total").inc(int(spikes.sum()))
        mask = active.astype(bool)                      # (T, n_slots)
        if n_active == 0:
            return
        # recurrent source rows: each stream's previous output (its
        # carried row for step 0), masked to the steps it ran; a full
        # chunk skips the masking copies
        full = bool(mask.all())
        sp = spikes if full else np.where(mask[:, :, None], spikes, 0)
        prev = np.concatenate([self._prev_host[None], sp[:-1]], axis=0)
        ext_b = ext != 0                                # pre-masked zeros
        prev_b = prev != 0
        if not full:
            prev_b &= mask[:, :, None]
        m.counter("snn_server_source_events_total").labels(
            kind="external").inc(int(ext_b.sum()))
        m.counter("snn_server_source_events_total").labels(
            kind="recurrent").inc(int(prev_b.sum()))
        per_src = np.concatenate(
            [ext_b.sum(axis=(0, 1)), prev_b.sum(axis=(0, 1))]
        ).astype(np.int64)                              # (S,) event counts
        m.counter("snn_server_sops_total").inc(int(per_src @ self._fanout))
        m.counter("snn_server_row_fetches_total").inc(
            int(per_src @ self._rowseg))
        src = np.concatenate([ext_b, prev_b], axis=2)   # (T, n_slots, S)
        T, n_slots, S = src.shape
        pad = self._n_src_blocks * _OBS_BLOCK_SRC - S
        if pad:
            src = np.pad(src, ((0, 0), (0, 0), (0, pad)))
        touched = int(src.reshape(T, n_slots, self._n_src_blocks,
                                  _OBS_BLOCK_SRC).any(axis=3).sum())
        m.counter("snn_server_weight_blocks_fetched_total").inc(touched)
        m.counter("snn_server_weight_blocks_dense_total").inc(
            n_active * self._n_src_blocks)
        # roll each served stream's recurrent row forward to its LAST
        # active step's output (ragged streams end mid-chunk)
        n_per = mask.sum(axis=0)
        served = n_per > 0
        self._prev_host[served] = sp[n_per[served] - 1, served]

    # -- lifecycle --------------------------------------------------------
    def attach(self, uid=None):
        """Register a stream. Returns its uid; ``slot_of(uid)`` is None
        while it waits for a slot (FIFO admission on the next detach)."""
        if uid is None:
            uid = next(self._auto_uid)
            while uid in self.streams:  # caller-chosen uids may collide
                uid = next(self._auto_uid)
        now = time.perf_counter()
        slot = self.scheduler.submit(uid)
        st = StreamStats(uid=uid, attached_at=now)
        if slot is not None:
            st.admitted_at = now
        self.streams[uid] = st
        self._obs_occupancy()
        if self.tracer is not None:
            if slot is None:
                self.tracer.event("queued", uid)
            else:
                self.tracer.event("admitted", uid, slot=slot)
        return uid

    def detach(self, uid, *, reason: str = "detached") -> StreamStats:
        """Evict a stream. Frees and zeroes its slot on the device; the
        longest-waiting stream, if any, is admitted into it.

        ``reason`` is observational only: it becomes the stream's terminal
        ``retired`` span outcome, or, with ``reason="parked"``, a
        ``parked`` span, for callers that park the carry in a connector
        so the timeline continues through the later restore."""
        st = self.streams.pop(uid)
        self._obs_detached(uid, st, reason)
        if self.scheduler.slot_of(uid) is None:
            self.scheduler.cancel(uid)
            self._obs_occupancy()
            return st
        slot, admitted = self.scheduler.release(uid)
        self.engine.set_carry_rows(self.carry, slot, 0, 0)
        if self._prev_host is not None:
            self._prev_host[slot] = 0
        if admitted is not None:
            self.streams[admitted].admitted_at = time.perf_counter()
            if self.tracer is not None:
                self.tracer.event("admitted", admitted, slot=slot)
        self._obs_occupancy()
        return st

    def _obs_detached(self, uid, st: StreamStats, reason: str) -> None:
        if self.tracer is None:
            return
        if reason == "parked":
            self.tracer.event("parked", uid, steps_done=int(st.steps))
        else:
            self.tracer.event("retired", uid, outcome=reason,
                              steps_done=int(st.steps))

    def slot_of(self, uid) -> int | None:
        return self.scheduler.slot_of(uid)

    # -- carry migration (the stream-state connector) ---------------------
    def slot_params(self) -> dict:
        """This server's carry-compatibility identity (see
        :func:`repro_torch.serving.connector.slot_params_of`)."""
        from repro_torch.serving.connector import slot_params_of

        return slot_params_of(self.engine)

    def snapshot_stream(self, uid):
        """A stream's portable state, carry rows and counters, WITHOUT
        disturbing it. The stream must hold a slot. One device-to-host
        copy of each carry row, which waits for the card."""
        from repro_torch.serving.connector import CarrySnapshot

        slot = self.scheduler.slot_of(uid)
        if slot is None:
            raise ValueError(
                f"stream {uid!r} is waiting for a slot; nothing to "
                f"snapshot (its carry does not exist yet)")
        st = self.streams[uid]
        # one device-to-host copy of both rows; a fresh array, so a later
        # in-place write to the slot cannot reach the snapshot
        rows = torch.stack(self.engine.carry_rows(self.carry, slot)
                           ).cpu().numpy().copy()
        return CarrySnapshot(
            stream_id=uid,
            slot_params=self.slot_params(),
            arrays={"v": rows[0], "spikes": rows[1]},
            meta={"steps": int(st.steps),
                  "spike_count": int(st.spike_count)},
        )

    def detach_stream(self, uid, connector):
        """Drain a stream to ``connector``: snapshot, park, then detach
        (the slot is zeroed and handed on as by :meth:`detach`)."""
        snap = self.snapshot_stream(uid)
        connector.insert(uid, snap)
        self.detach(uid, reason="parked")
        return snap

    def attach_stream(self, source, uid=None, *, slot: int | None = None):
        """Admit a stream whose carry starts from a snapshot instead of
        power-on zero: the restore half of live migration.

        Args:
          source: a :class:`~repro_torch.serving.connector.CarrySnapshot`,
            or a connector to ``select`` (and, on success, ``evict``) the
            snapshot from under ``uid``.
          uid: the restored stream's id on THIS server (needed with a
            connector; with a snapshot, defaults to a fresh auto id).
          slot: targeted placement (rebalance); default = FIFO free slot.

        The snapshot is checked against this server's slot params, dtype
        and shape before any state changes; both carry rows are then
        written into the device tensors in place. A restored stream needs
        a slot now, so no free slot raises ``RuntimeError``.
        """
        from repro_torch.serving.connector import CarrySnapshot

        connector = None
        if isinstance(source, CarrySnapshot):
            snap = source
            if uid is None:
                uid = next(self._auto_uid)
                while uid in self.streams:
                    uid = next(self._auto_uid)
        else:
            connector = source
            if uid is None:
                raise ValueError(
                    "attach_stream from a connector needs the stream id")
            snap = connector.select(uid)
            if snap is None:
                raise KeyError(f"no parked carry for stream {uid!r}")
        snap.check_compatible(self.slot_params())
        if self.scheduler.free_slots == 0:
            raise RuntimeError(
                f"cannot restore stream {uid!r}: no free slot (a restored "
                f"carry cannot wait in the admission queue)")
        now = time.perf_counter()
        if slot is None:
            slot = self.scheduler.submit(uid)
        else:
            slot = self.scheduler.submit_at(uid, slot)
        rows = torch.from_numpy(np.stack(
            [snap.arrays["v"], snap.arrays["spikes"]])).to(self.device)
        self.engine.set_carry_rows(self.carry, slot, rows[0], rows[1])
        self.streams[uid] = StreamStats(
            uid=uid,
            steps=int(snap.meta.get("steps", 0)),
            spike_count=int(snap.meta.get("spike_count", 0)),
            attached_at=now, admitted_at=now,
        )
        if self._prev_host is not None:
            self._prev_host[slot] = np.asarray(snap.arrays["spikes"],
                                               np.int32)
        self._obs_occupancy()
        if self.tracer is not None:
            self.tracer.event("admitted", uid, slot=slot, resumed=True)
        if connector is not None:
            connector.evict(uid)
        return uid

    def checkpoint_streams(self, connector) -> list:
        """Park a snapshot of EVERY live stream in ``connector`` without
        disturbing any of them: the crash-recovery write barrier. Returns
        the checkpointed uids."""
        uids = sorted(self.scheduler.active, key=repr)
        for uid in uids:
            connector.insert(uid, self.snapshot_stream(uid))
        return uids

    def restore_streams(self, connector, uids=None) -> list:
        """Re-admit parked streams (all of ``connector``'s, or ``uids``)
        into free slots, consuming their snapshots; restores what fits
        and leaves the rest parked. Returns the restored uids."""
        if uids is None:
            uids = connector.stream_ids()
        restored = []
        for uid in uids:
            if self.scheduler.free_slots == 0:
                break
            self.attach_stream(connector, uid)
            restored.append(uid)
        return restored

    # -- streaming --------------------------------------------------------
    def _dispatch(self, ext: np.ndarray, active: np.ndarray) -> np.ndarray:
        """One chunk step: host input and mask in, host raster out."""
        self.carry, spikes = self.engine.step_chunk(
            self.carry, torch.from_numpy(ext).to(self.device),
            torch.from_numpy(active).to(self.device))
        self.total_steps += int(active.sum())
        return spikes.cpu().numpy()

    def feed(self, inputs: dict) -> dict:
        """Push timesteps of external spikes for one or more streams.

        inputs: {uid: (T_uid, n_inputs) array in {0,1}}; ragged T per
        stream is fine; every uid must hold a slot. Returns {uid:
        {'spikes': (T_uid, n_phys) int32, 'counts': (n_phys,)}}. Slots not
        mentioned (or past their stream's T) are masked inactive and keep
        their carries bit-for-bit. A zero-length chunk is a no-op.
        """
        if not inputs:
            return {}
        out: dict = {}
        chunks: dict = {}
        n_phys = self.engine.n_phys
        for uid, arr in inputs.items():
            slot = self.scheduler.slot_of(uid)
            if slot is None:
                raise ValueError(
                    f"stream {uid!r} is waiting for a slot; cannot feed")
            arr = np.asarray(arr)
            if arr.ndim != 2 or arr.shape[1] != self.engine.n_inputs:
                raise ValueError(
                    f"stream {uid!r}: chunk must be "
                    f"(T, {self.engine.n_inputs}), got {arr.shape}")
            if arr.shape[0] == 0:
                out[uid] = {"spikes": np.zeros((0, n_phys), np.int32),
                            "counts": np.zeros((n_phys,), np.int32)}
                continue
            chunks[uid] = (slot, arr.astype(np.int32))
        if not chunks:
            return out

        T_max = max(arr.shape[0] for _, arr in chunks.values())
        n_in = self.engine.n_inputs
        pieces: dict = {uid: [] for uid in chunks}
        obs = self.metrics is not None or self.tracer is not None
        for t0 in range(0, T_max, self.chunk_steps):
            ext = np.zeros((self.chunk_steps, self.n_slots, n_in), np.int32)
            active = np.zeros((self.chunk_steps, self.n_slots), np.int32)
            for uid, (slot, arr) in chunks.items():
                n = min(self.chunk_steps, arr.shape[0] - t0)
                if n <= 0:
                    continue
                ext[:n, slot] = arr[t0:t0 + n]
                active[:n, slot] = 1
            t_chunk = self._obs_clock()() if obs else 0.0
            spikes = self._dispatch(ext, active)
            if obs:
                self._obs_feed_chunk(t_chunk, active, spikes, ext, chunks,
                                     t0)
            for uid, (slot, arr) in chunks.items():
                n = min(self.chunk_steps, arr.shape[0] - t0)
                if n > 0:
                    pieces[uid].append(spikes[:n, slot])

        for uid, (slot, arr) in chunks.items():
            raster = np.concatenate(pieces[uid], axis=0)
            st = self.streams[uid]
            st.steps += raster.shape[0]
            st.spike_count += int(raster.sum())
            out[uid] = {"spikes": raster, "counts": raster.sum(axis=0)}
        return out

    def feed_events(self, inputs: dict, *, out_capacity: int | None = None,
                    out_policy: str = "error") -> dict:
        """Event-driven :meth:`feed`: AER streams in, optionally AER out.

        Each stream is decoded and pushed through the SAME masked chunk
        step ``feed`` uses, so the byte-exactness contract carries over.

        Args:
          inputs: {uid: AERStream}, each addressing a dense ``(T_uid, 1,
            n_inputs)`` chunk (slot axis 1: a stream is one lane).
          out_capacity: when set, each stream's result also carries
            ``'events'``: its output raster as an AER stream of at most
            this many events under ``out_policy``.
        Returns:
          {uid: {'spikes', 'counts'[, 'events']}} exactly as :meth:`feed`.
        """
        dense_inputs = {
            uid: decode_aer_chunk(stream, self.engine.n_inputs,
                                  f"stream {uid!r}")
            for uid, stream in inputs.items()
        }
        out = self.feed(dense_inputs)
        if out_capacity is not None:
            for res in out.values():
                res["events"] = dense_to_aer(
                    res["spikes"][:, None, :], out_capacity,
                    policy=out_policy)
        return out

    def run_closed_loop(self, uid, controller, num_steps: int, ext0) -> dict:
        """Closed loop: the output of step t drives the input at t+1.

        controller: ``spikes_t (n_phys,) int32 -> ext_{t+1} (n_inputs,)``.
        Runs T=1 chunk steps so other streams' slots stay untouched.
        Returns {'spikes': (num_steps, n_phys) int32, 'counts': (n_phys,)}.
        """
        slot = self.scheduler.slot_of(uid)
        if slot is None:
            raise ValueError(f"stream {uid!r} is waiting for a slot")
        ext_t = np.asarray(ext0, np.int32)
        n_in = self.engine.n_inputs
        if ext_t.shape != (n_in,):
            raise ValueError(f"ext0 must be ({n_in},), got {ext_t.shape}")
        rows = []
        active = np.zeros((1, self.n_slots), np.int32)
        active[0, slot] = 1
        for t in range(num_steps):
            ext = np.zeros((1, self.n_slots, n_in), np.int32)
            ext[0, slot] = ext_t
            spikes_t = self._dispatch(ext, active)[0, slot]
            if self.metrics is not None:
                m = self.metrics
                m.counter("snn_server_chunks_total").inc()
                m.counter("snn_server_steps_total").inc(1)
                m.counter("snn_server_spikes_total").inc(
                    int(spikes_t.sum()))
                self._prev_host[slot] = self._obs_count_chunk(
                    ext_t[None, :], spikes_t[None, :],
                    self._prev_host[slot])
            rows.append(spikes_t)
            if t + 1 < num_steps:
                ext_t = np.asarray(controller(spikes_t), np.int32)
                if ext_t.shape != (n_in,):
                    raise ValueError(
                        f"controller must return ({n_in},) external "
                        f"spikes, got shape {ext_t.shape} at step {t}")
        raster = np.stack(rows, axis=0)
        st = self.streams[uid]
        st.steps += num_steps
        st.spike_count += int(raster.sum())
        return {"spikes": raster, "counts": raster.sum(axis=0)}


class ModelStream:
    """Per-model streaming view over a (possibly fused multi-model) server:
    embeds the model's external spikes at its column offset and decodes
    only its own cluster range."""

    def __init__(self, server: SpikeServer, *, name: str, n_inputs: int,
                 ext_offset: int, phys_slice: tuple[int, int],
                 output_map: np.ndarray, stale_check=None, frontend=None):
        self.server = server
        self.name = name
        self.n_inputs = int(n_inputs)
        self.ext_offset = int(ext_offset)
        self.phys_slice = (int(phys_slice[0]), int(phys_slice[1]))
        self.output_map = np.asarray(output_map)
        self._stale_check = stale_check
        #: the group's shared AsyncSpikeFrontend when this view was served
        #: with ``session.serve(..., frontend=)`` (None otherwise)
        self.frontend = frontend

    def _check_fresh(self) -> None:
        if self._stale_check is not None and self._stale_check():
            raise RuntimeError(
                f"stale ModelStream view for {self.name!r}: a later deploy "
                f"changed the fused layout; call session.serve() again")

    def attach(self, uid=None):
        self._check_fresh()
        return self.server.attach(uid)

    def detach(self, uid, *, reason: str = "detached") -> StreamStats:
        return self.server.detach(uid, reason=reason)

    def slot_of(self, uid):
        return self.server.slot_of(uid)

    def embed(self, chunk: np.ndarray) -> np.ndarray:
        """Model-local (T, n_inputs) spikes -> fused-layout external rows
        (zero everywhere but this model's input columns)."""
        chunk = np.asarray(chunk, np.int32)
        fused = np.zeros((chunk.shape[0], self.server.engine.n_inputs),
                         np.int32)
        fused[:, self.ext_offset:self.ext_offset + self.n_inputs] = chunk
        return fused

    def decode(self, raster: np.ndarray) -> dict:
        """Fused physical raster -> this model's masked spikes, output
        counts and prediction (its cluster range only)."""
        lo, hi = self.phys_slice
        spikes = np.zeros_like(raster)
        spikes[:, lo:hi] = raster[:, lo:hi]
        counts = spikes.sum(axis=0)
        return {
            "spikes": spikes,
            "output_counts": counts[self.output_map],
            "predictions": int(np.argmax(counts[self.output_map])),
        }

    def submit(self, chunk, **kwargs):
        """Async entry: enqueue a full model-local ``(T, n_inputs)``
        raster on the group's shared request queue and return a
        :class:`~repro_torch.serving.frontend.RequestHandle`; the decoded
        result is byte-identical to a synchronous :meth:`feed` of the same
        raster. Needs ``session.serve(..., frontend=)``."""
        self._check_fresh()
        if self.frontend is None:
            raise RuntimeError(
                f"view {self.name!r} has no async frontend; pass "
                f"frontend=FrontendConfig(...) to session.serve()")
        return self.frontend.submit(chunk, view=self, **kwargs)

    def submit_events(self, stream, **kwargs):
        """AER-native :meth:`submit`: a ``(T, 1, n_inputs)`` model-local
        AER stream in, the same async handle back."""
        self._check_fresh()
        if self.frontend is None:
            raise RuntimeError(
                f"view {self.name!r} has no async frontend; pass "
                f"frontend=FrontendConfig(...) to session.serve()")
        return self.frontend.submit_events(stream, view=self, **kwargs)

    def feed(self, uid, chunk) -> dict:
        """Push (T, n_inputs) model-local spikes; get the model's masked
        raster + decoded output counts for the chunk back."""
        return self.feed_many({uid: chunk})[uid]

    def feed_many(self, inputs: dict) -> dict:
        """{uid: (T_uid, n_inputs)} for several of this model's streams in
        ONE slot-batch dispatch."""
        self._check_fresh()
        fused: dict = {}
        for uid, chunk in inputs.items():
            chunk = np.asarray(chunk, np.int32)
            if chunk.ndim != 2 or chunk.shape[1] != self.n_inputs:
                raise ValueError(
                    f"stream {uid!r}: chunk must be (T, {self.n_inputs}), "
                    f"got {chunk.shape}")
            fused[uid] = self.embed(chunk)
        out = self.server.feed(fused)
        return {uid: self.decode(o["spikes"]) for uid, o in out.items()}

    def run_closed_loop(self, uid, controller, num_steps: int, ext0) -> dict:
        """Closed loop at timestep granularity: ``controller`` sees the
        model's masked spike vector and returns the next model-local
        external spike vector."""
        self._check_fresh()
        lo, hi = self.phys_slice
        n_fused = self.server.engine.n_inputs

        def fused_controller(spikes_t):
            local = np.zeros_like(spikes_t)
            local[lo:hi] = spikes_t[lo:hi]
            nxt = np.asarray(controller(local), np.int32)
            if nxt.shape != (self.n_inputs,):
                raise ValueError(
                    f"controller must return ({self.n_inputs},) "
                    f"model-local external spikes, got shape {nxt.shape}")
            full = np.zeros((n_fused,), np.int32)
            full[self.ext_offset:self.ext_offset + self.n_inputs] = nxt
            return full

        ext0 = np.asarray(ext0, np.int32)
        if ext0.shape != (self.n_inputs,):
            raise ValueError(
                f"ext0 must be ({self.n_inputs},), got {ext0.shape}")
        full0 = np.zeros((n_fused,), np.int32)
        full0[self.ext_offset:self.ext_offset + self.n_inputs] = ext0
        out = self.server.run_closed_loop(uid, fused_controller, num_steps,
                                          full0)
        return self.decode(out["spikes"])
