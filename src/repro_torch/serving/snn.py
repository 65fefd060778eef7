"""Streaming SNN serving — stateful spike streams over one chunk step.

Twin of :mod:`repro.serving.snn` for the synchronous serving path:

  * :class:`SlotScheduler` — admission of stream ids into a fixed set of
    batch slots: FIFO waiting queue, FIFO slot reuse.
  * :class:`SpikeServer` — owns the slot carry ``{v, spikes}`` on the
    engine's device, feeds chunks of external spikes through the masked
    chunk step, zeroes a slot on eviction, and runs a closed loop.
  * :class:`ModelStream` — a per-model view over a server running the
    fused multi-model engine (``AcceleratorSession.serve``).

The carry never leaves the device. Each chunk moves only its
``(chunk_steps, n_slots, n_inputs)`` input and its mask to the device and
brings the spike raster back once. Exactness contract (as in the JAX
twin): for any chunking of a raster, the concatenated ``feed`` outputs are
byte-identical to one ``SpikeEngine.run`` on it.

Waiting for later slices: metrics / tracer hooks, ``feed_events`` (AER),
and the carry snapshot / ``attach_stream`` methods of the connector.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import time

import numpy as np
import torch

from repro_torch.core.engine import SpikeEngine
from repro_torch.device import resolve_device

__all__ = ["ModelStream", "SlotScheduler", "SpikeServer", "StreamStats"]


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
    """

    def __init__(self, engine: SpikeEngine, *, n_slots: int = 8,
                 chunk_steps: int = 8, gate: str | None = None,
                 fuse_steps: int | None = None, device="cuda"):
        if chunk_steps <= 0:
            raise ValueError(f"chunk_steps must be positive, got {chunk_steps}")
        engine = engine.to_device(resolve_device(device))
        if gate is not None:
            engine = engine.with_gate(gate)
        if fuse_steps is not None:
            engine = engine.with_fuse_steps(fuse_steps)
        self.engine = engine
        self.device = engine.device
        self.n_slots = int(n_slots)
        self.chunk_steps = int(chunk_steps)
        self.scheduler = SlotScheduler(n_slots)
        self.carry = engine.init_carry(self.n_slots)
        self.streams: dict = {}      # uid -> StreamStats (active + waiting)
        self._auto_uid = itertools.count()
        self.total_steps = 0         # slot-timesteps consumed (all streams)

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
        return uid

    def detach(self, uid) -> StreamStats:
        """Evict a stream. Frees and zeroes its slot on the device; the
        longest-waiting stream, if any, is admitted into it."""
        st = self.streams.pop(uid)
        if self.scheduler.slot_of(uid) is None:
            self.scheduler.cancel(uid)
            return st
        slot, admitted = self.scheduler.release(uid)
        self.carry["v"][slot] = 0
        self.carry["spikes"][slot] = 0
        if admitted is not None:
            self.streams[admitted].admitted_at = time.perf_counter()
        return st

    def slot_of(self, uid) -> int | None:
        return self.scheduler.slot_of(uid)

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
        for t0 in range(0, T_max, self.chunk_steps):
            ext = np.zeros((self.chunk_steps, self.n_slots, n_in), np.int32)
            active = np.zeros((self.chunk_steps, self.n_slots), np.int32)
            for uid, (slot, arr) in chunks.items():
                n = min(self.chunk_steps, arr.shape[0] - t0)
                if n <= 0:
                    continue
                ext[:n, slot] = arr[t0:t0 + n]
                active[:n, slot] = 1
            spikes = self._dispatch(ext, active)
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
                 output_map: np.ndarray, stale_check=None):
        self.server = server
        self.name = name
        self.n_inputs = int(n_inputs)
        self.ext_offset = int(ext_offset)
        self.phys_slice = (int(phys_slice[0]), int(phys_slice[1]))
        self.output_map = np.asarray(output_map)
        self._stale_check = stale_check

    def _check_fresh(self) -> None:
        if self._stale_check is not None and self._stale_check():
            raise RuntimeError(
                f"stale ModelStream view for {self.name!r}: a later deploy "
                f"changed the fused layout; call session.serve() again")

    def attach(self, uid=None):
        self._check_fresh()
        return self.server.attach(uid)

    def detach(self, uid) -> StreamStats:
        return self.server.detach(uid)

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
