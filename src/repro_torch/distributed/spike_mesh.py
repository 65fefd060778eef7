"""Mesh-sharded spike engine: one controller over a grid of devices.

Twin of :mod:`repro.distributed.spike_mesh`. The JAX mesh is
single-controller SPMD: one process drives every device through
``shard_map`` and exchanges boundary spikes with ``jax.lax.all_gather``.
Its counterpart here is one process over a ``(neuron, batch)`` grid of
``torch.device`` entries, with no process group:

  Cerebra-H hardware                    mesh engine
  ------------------                    -----------
  node-local weight SRAM slice          each neuron shard holds its
                                        ``(n_inputs + pp, pp / kn)``
                                        column slice on its devices,
                                        padded to the kernels' block
                                        multiples per shard
  neurons assigned to nodes             the carry's neuron columns, split
                                        over ``neuron``
  L2 NoC spike broadcast                per timestep, the previous
                                        boundary spikes of the neuron
                                        shards are concatenated and copied
                                        to every shard of the batch shard
  independent stimulus streams          the batch rows, split over
                                        ``batch`` (no exchange)

The sources of a batch shard (and, on a kernel backend, their padding
and gate scalars) are built once per device of that shard
(``SpikeEngine._sources``); every neuron shard then runs the unmodified
single-device accumulate and fire (``SpikeEngine._advance``) on its
columns, so the kernel backends launch the ``spike_timestep`` kernel once
per shard per step. Each output column's int32 accumulate happens on the
shard that owns it, over the full gathered source vector, so the mesh is
byte-identical to one device.

A mesh may repeat a device: several shards then share one card (or the
host), the counterpart of JAX's faked host devices. Non-divisible shapes
are zero-padded: pad neurons have all-zero weight rows and columns, pad
batch rows are inactive slots, and both are sliced off every result.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.engine import SpikeEngine, _as_int32, _F32_BLOCK_SRC
from repro_torch.device import resolve_device
from repro_torch.distributed.partition import (PartitionRules, _axis_size,
                                                spec_for)
from repro_torch.kernels import ops

__all__ = [
    "BATCH_AXIS",
    "NEURON_AXIS",
    "SNN_RULES",
    "MeshCarry",
    "MeshSpikeEngine",
    "SpikeMesh",
    "ensure_host_devices",
    "make_spike_mesh",
    "parse_mesh_spec",
]

NEURON_AXIS = "neuron"
BATCH_AXIS = "batch"

# Logical-axis -> mesh-axis rules for SNN arrays: the neuron axis (weight
# columns, carries, rasters) over "neuron", independent streams over
# "batch". Source and time axes are never sharded: every shard consumes
# the full gathered source vector, mirroring the NoC broadcast.
SNN_RULES = PartitionRules(
    rules={"neuron": NEURON_AXIS, "batch": BATCH_AXIS},
    batch_axes=(BATCH_AXIS,),
)


@dataclasses.dataclass(frozen=True)
class SpikeMesh:
    """A grid of ``torch.device`` entries: ``devices[i][j]`` runs neuron
    shard ``i`` of batch shard ``j``. Hashable, so it can key an engine
    cache; a device may appear more than once."""

    devices: tuple

    def __post_init__(self):
        rows = tuple(tuple(torch.device(d) for d in row)
                     for row in self.devices)
        if not rows or len({len(r) for r in rows}) != 1 or not rows[0]:
            raise ValueError(
                f"a spike mesh is a non-empty rectangular 2-D grid of "
                f"devices, got rows of {[len(r) for r in rows]}")
        object.__setattr__(self, "devices", rows)

    @property
    def axis_names(self) -> tuple:
        return (NEURON_AXIS, BATCH_AXIS)

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names,
                        (len(self.devices), len(self.devices[0]))))

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def physical_devices(self) -> tuple:
        """The distinct devices behind the grid, in grid order."""
        return tuple(dict.fromkeys(d for row in self.devices for d in row))


def ensure_host_devices(n: int, device="cuda") -> list:
    """``n`` logical devices for an ``n``-shard mesh, touching no
    environment: ``n`` host entries on ``"cpu"``, the visible cards
    round-robin on ``"cuda"`` (shards beyond the card count share cards).
    ``"cuda"`` raises without a card."""
    if n < 1:
        raise ValueError(f"a mesh needs >= 1 device, got {n}")
    dev = resolve_device(device)
    if dev.type == "cpu" or dev.index is not None:
        return [dev] * n
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def parse_mesh_spec(devices: int, spec: str | None) -> tuple[int, int]:
    """``'KNxKB'`` -> (neuron, batch) shard counts covering ``devices``.

    ``spec=None`` picks a default split: a 2-way neuron axis when the
    device count allows (e.g. 2x4 on 8), else all-batch. Shared by every
    launcher/bench ``--devices/--mesh`` flag pair.
    """
    if spec:
        kn_s, sep, kb_s = spec.lower().partition("x")
        try:
            if not sep:
                raise ValueError
            kn, kb = int(kn_s), int(kb_s)
            if kn < 1 or kb < 1:
                raise ValueError
        except ValueError:
            raise ValueError(
                f"--mesh must look like 'KNxKB' (e.g. 2x4), got {spec!r}"
            ) from None
    else:
        kn = 2 if devices % 2 == 0 and devices >= 4 else 1
        kb = devices // kn
    if kn * kb != devices:
        raise ValueError(
            f"--mesh {kn}x{kb} does not cover --devices {devices}")
    return kn, kb


def make_spike_mesh(neuron: int = 1, batch: int | None = None,
                    devices=None) -> SpikeMesh:
    """A ``(neuron, batch)`` mesh over ``devices`` (default: every visible
    card, each once; raises without a card).

    ``batch=None`` spreads every remaining device over the batch axis. An
    explicit ``devices`` list may repeat a device, so several shards can
    share one card.
    """
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if neuron < 1:
        raise ValueError(f"neuron axis must be >= 1, got {neuron}")
    if batch is None:
        batch = max(1, len(devices) // neuron)
    if batch < 1:
        raise ValueError(f"batch axis must be >= 1, got {batch}")
    if neuron * batch > len(devices):
        raise ValueError(
            f"mesh {neuron}x{batch} needs {neuron * batch} devices; "
            f"only {len(devices)} available"
        )
    return SpikeMesh(tuple(tuple(devices[i * batch:(i + 1) * batch])
                           for i in range(neuron)))


def _pad_up(n: int, k: int) -> int:
    return -(-n // k) * k


def _ways(spec: tuple, dim: int, mesh: SpikeMesh) -> int:
    """How many shards ``spec`` cuts dimension ``dim`` into (1 where it
    replicates it)."""
    return _axis_size(mesh, spec[dim] if dim < len(spec) else None)


class MeshCarry:
    """A slot batch's carry where its shards step: ``blocks[i][j]`` is
    ``{"v", "spikes"}``, each ``(B_shard, P_shard)`` int32 on
    ``mesh.devices[i][j]``, for ``batch`` logical rows.

    ``carry["v"]`` / ``carry["spikes"]`` gather a logical ``(batch,
    n_phys)`` copy on the engine's device, so readers treat it as the
    single-device carry dict; slot rows are written through
    :meth:`MeshSpikeEngine.set_carry_rows`.
    """

    def __init__(self, engine: "MeshSpikeEngine", blocks: list, batch: int):
        self.engine = engine
        self.blocks = blocks
        self.batch = int(batch)

    def __getitem__(self, key: str) -> torch.Tensor:
        e = self.engine
        rows = [torch.cat([self.blocks[i][j][key].to(e.device)
                           for i in range(e._kn)], dim=1)
                for j in range(e._kb)]
        return torch.cat(rows, dim=0)[:self.batch, :e.n_phys]


class MeshSpikeEngine(SpikeEngine):
    """A :class:`SpikeEngine` sharded over a ``(neuron, batch)``
    :class:`SpikeMesh`.

    Each neuron shard holds the weight-image columns of its neurons; every
    step first gathers the previous boundary spikes of all neuron shards,
    then steps every shard on its columns. Outputs, carries and the
    ``step_chunk`` masked-slot semantics are byte-identical to the
    single-device engine. ``init_carry`` and ``step_chunk`` keep the carry
    sharded (a :class:`MeshCarry`); ``step_chunk`` and ``step`` also take a
    single-device carry dict.

    ``fuse_steps`` is carried (and kept by :meth:`from_engine`,
    :meth:`with_gate` and :meth:`with_fuse_steps`, so ``to_mesh`` round
    trips keep K), but the mesh executes per step whatever it is: the
    boundary-spike exchange is due every timestep, so a K-step window
    cannot be fused across shards. No fused-window kernel is launched.
    """

    def __init__(self, weights_raw, n_inputs: int, *, mesh: SpikeMesh,
                 decay, threshold_raw: int, reset_mode: str,
                 backend: str = "reference", gate: str = "batch-tile",
                 fuse_steps: int = 1):
        if not isinstance(mesh, SpikeMesh):
            raise ValueError(
                f"mesh must name axes {NEURON_AXIS!r} and {BATCH_AXIS!r} "
                f"(got {mesh!r}); use make_spike_mesh()")
        super().__init__(
            weights_raw, n_inputs, decay=decay, threshold_raw=threshold_raw,
            reset_mode=reset_mode, backend=backend, gate=gate,
            fuse_steps=fuse_steps, device=mesh.devices[0][0])
        self.mesh = mesh
        grid = self._grid = mesh.devices  # [neuron shard][batch shard]
        self._kn = int(mesh.shape[NEURON_AXIS])
        self._kb = int(mesh.shape[BATCH_AXIS])
        # pad the physical axis so each shard owns an equal neuron slice;
        # the source axis grows with it (recurrent feedback stays square)
        self._pp = _pad_up(self.n_phys, self._kn)
        sp = self.n_inputs + self._pp
        w = torch.zeros((sp, self._pp), dtype=torch.int32,
                        device=self.device)
        w[:self.n_inputs, :self.n_phys] = self.weights_raw[:self.n_inputs]
        w[self.n_inputs:self.n_inputs + self.n_phys, :self.n_phys] = (
            self.weights_raw[self.n_inputs:])
        # the rules keep every source row and cut the columns over
        # "neuron": shard i holds columns [i * ps, (i + 1) * ps)
        self._w_spec = spec_for(("source", "neuron"), (sp, self._pp),
                                mesh, SNN_RULES)
        self._ps = self._pp // _ways(self._w_spec, 1, mesh)
        # a shard's slice, padded to the kernels' block multiples on its
        # own (a ragged slice is not a multiple of 128 columns); one copy
        # per (neuron shard, device)
        self._shard_w = []
        for i, row in enumerate(grid):
            cols = w[:, i * self._ps:(i + 1) * self._ps]
            if self._mode is not None:
                cols = ops._pad_to(ops._pad_to(cols, 0, _F32_BLOCK_SRC), 1,
                                   128)
            copies = {d: cols.to(d).contiguous() for d in dict.fromkeys(row)}
            self._shard_w.append([copies[d] for d in row])

    @classmethod
    def from_engine(cls, engine: SpikeEngine, mesh: SpikeMesh
                    ) -> "MeshSpikeEngine":
        """Re-host an existing engine's program on a mesh (same
        semantics)."""
        return cls(engine.weights_raw, engine.n_inputs, mesh=mesh,
                   decay=engine.decay, threshold_raw=engine.threshold_raw,
                   reset_mode=engine.reset_mode, backend=engine.backend,
                   gate=engine.gate, fuse_steps=engine.fuse_steps)

    def _rehost(self, **changes) -> "MeshSpikeEngine":
        """Gate / fusion / device re-hosts KEEP the mesh (the base
        implementation would fall back to a single-device engine)."""
        kw = dict(mesh=self.mesh, decay=self.decay,
                  threshold_raw=self.threshold_raw,
                  reset_mode=self.reset_mode, backend=self.backend,
                  gate=self.gate, fuse_steps=self.fuse_steps)
        kw.update(changes)
        return MeshSpikeEngine(self.weights_raw, self.n_inputs, **kw)

    def to_device(self, device) -> "MeshSpikeEngine":
        """This program on a mesh of the same shape with every shard on
        ``device``. Returns ``self`` when every shard already lives
        there."""
        dev = resolve_device(device)
        mesh = SpikeMesh(tuple(tuple(dev for _ in row)
                               for row in self.mesh.devices))
        return self if mesh == self.mesh else self._rehost(mesh=mesh)

    @property
    def device_count(self) -> int:
        return self._kn * self._kb

    @property
    def _use_fused(self) -> bool:
        return False

    # ------------------------------------------------------------------
    def _batch_shard(self, batch: int) -> int:
        """Rows per batch shard for a ``batch``-row carry: the rules cut
        the padded rows over "batch"."""
        bp = _pad_up(batch, self._kb)
        spec = spec_for(("batch", "neuron"), (bp, self._pp), self.mesh,
                        SNN_RULES)
        return bp // _ways(spec, 0, self.mesh)

    def _shard(self, x: torch.Tensor, bs: int) -> list:
        """A logical ``(B, n_phys)`` tensor as ``[i][j]`` blocks on their
        devices (copies: a block is written in place)."""
        x = x.to(self.device, torch.int32)
        x = torch.nn.functional.pad(
            x, (0, self._pp - x.shape[1], 0, bs * self._kb - x.shape[0]))
        return [[x[j * bs:(j + 1) * bs, i * self._ps:(i + 1) * self._ps]
                 .to(d, copy=True) for j, d in enumerate(row)]
                for i, row in enumerate(self._grid)]

    def _shard_carry(self, carry) -> MeshCarry:
        """A carry dict (or a :class:`MeshCarry` of this engine) as a
        :class:`MeshCarry`."""
        if isinstance(carry, MeshCarry) and carry.engine is self:
            return carry
        batch = carry["v"].shape[0]
        bs = self._batch_shard(batch)
        v, s = self._shard(carry["v"], bs), self._shard(carry["spikes"], bs)
        return MeshCarry(self, [[{"v": v[i][j], "spikes": s[i][j]}
                                 for j in range(self._kb)]
                                for i in range(self._kn)], batch)

    def init_carry(self, batch: int) -> MeshCarry:
        """Power-on state (V = 0, no prior spikes), sharded."""
        bs = self._batch_shard(batch)
        return MeshCarry(self, [[{
            "v": torch.zeros((bs, self._ps), dtype=torch.int32, device=d),
            "spikes": torch.zeros((bs, self._ps), dtype=torch.int32,
                                  device=d)} for d in row]
            for row in self._grid], batch)

    def _locate(self, carry: MeshCarry, slot: int) -> tuple[int, int]:
        if not 0 <= slot < carry.batch:
            raise IndexError(f"slot {slot} outside [0, {carry.batch})")
        bs = self._batch_shard(carry.batch)
        return slot // bs, slot % bs

    def carry_rows(self, carry: MeshCarry, slot: int):
        """One slot's ``(v, spikes)`` rows, read from the batch shard that
        owns the slot (``slot // slots_per_shard``)."""
        j, r = self._locate(carry, slot)
        return tuple(
            torch.cat([carry.blocks[i][j][k][r].to(self.device)
                       for i in range(self._kn)])[:self.n_phys]
            for k in ("v", "spikes"))

    def set_carry_rows(self, carry: MeshCarry, slot: int, v,
                       spikes) -> None:
        """Overwrite one slot's rows in place on the batch shard that owns
        it; pad neurons stay zero."""
        j, r = self._locate(carry, slot)
        for k, row in (("v", v), ("spikes", spikes)):
            row = torch.as_tensor(row).to(self.device, torch.int32)
            row = torch.nn.functional.pad(row.expand(self.n_phys),
                                          (0, self._pp - self.n_phys))
            for i in range(self._kn):
                blk = carry.blocks[i][j][k]
                blk[r] = row[i * self._ps:(i + 1) * self._ps].to(blk.device)

    # ------------------------------------------------------------------
    def step(self, carry, ext_t):
        """One timestep through the mesh: a T = 1 chunk, so the shards'
        column slices and the spike exchange are used."""
        final, spikes = self.step_chunk(carry, _as_int32(ext_t, self.device
                                                         )[None])
        return final, spikes[0]

    def _chunk(self, carry, ext: torch.Tensor, active):
        """The masked scan over the mesh. Each step, per batch shard:
        gather the previous boundary spikes of every neuron shard, build
        the ``(B_shard, n_inputs + pp)`` sources (and their gate scalars)
        once on each device of the shard, then step every neuron shard on
        its columns (the gather ends before any shard of it steps)."""
        carry = self._shard_carry(carry)
        T, B = ext.shape[0], ext.shape[1]
        if B != carry.batch:
            raise ValueError(f"ext has {B} slots, the carry {carry.batch}")
        bs = self._batch_shard(B)
        pad_b = bs * self._kb - B
        ext = torch.nn.functional.pad(ext, (0, 0, 0, pad_b))
        if active is not None:  # pad slots stay idle
            active = torch.nn.functional.pad(active, (0, pad_b))
        grid, kn, kb = self._grid, self._kn, self._kb
        # the distinct devices of each batch shard, and its rows there
        devs = [tuple(dict.fromkeys(grid[i][j] for i in range(kn)))
                for j in range(kb)]
        ext_s = [{d: ext[:, j * bs:(j + 1) * bs].to(d) for d in devs[j]}
                 for j in range(kb)]
        act_s = [{d: None if active is None else
                  (active[:, j * bs:(j + 1) * bs] != 0).to(d)
                  for d in devs[j]} for j in range(kb)]
        raster = [[torch.empty((T, bs, self._ps), dtype=torch.int32,
                               device=d) for d in row] for row in grid]
        blocks = [[dict(b) for b in row] for row in carry.blocks]
        for t in range(T):
            for j in range(kb):
                spk = torch.cat([blocks[i][j]["spikes"].to(grid[0][j])
                                 for i in range(kn)], dim=1)
                src = {d: self._sources(ext_s[j][d][t], spk.to(d))
                       for d in devs[j]}
                for i in range(kn):
                    d, c = grid[i][j], blocks[i][j]
                    new, spikes = self._advance(src[d], c["v"],
                                                self._shard_w[i][j])
                    if act_s[j][d] is None:
                        blocks[i][j], raster[i][j][t] = new, spikes
                        continue
                    keep = act_s[j][d][t][:, None]
                    blocks[i][j] = {
                        "v": torch.where(keep, new["v"], c["v"]),
                        "spikes": torch.where(keep, new["spikes"],
                                              c["spikes"])}
                    raster[i][j][t] = torch.where(keep, spikes, 0)
        out = torch.cat([torch.cat([raster[i][j].to(self.device)
                                    for i in range(kn)], dim=2)
                         for j in range(kb)], dim=1)
        return MeshCarry(self, blocks, B), out[:, :B, :self.n_phys]
