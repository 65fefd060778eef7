"""One process a device: the ranks of an LM mesh on a process group.

The JAX twin is one controller over a grid of devices: ``jax.jit`` with
the partitioner's shardings writes one per-device program, and GSPMD
inserts its collectives. Here each device has a process of its own (a
*rank*), on a ``torch.distributed`` process group, and the program each
rank runs issues its collectives itself:

  * :func:`init_ranks` joins the group from an address the launcher gives
    (``tcp://localhost:<port>``, or ``file://<path>`` for a ``FileStore``
    under a temporary directory, which never collides on a port), with
    an explicit timeout, maps each rank to its mesh coordinates,
    row-major as :attr:`repro_torch.launch.mesh.LMMesh.devices` is, and
    builds one subgroup for each axis line of ``data``, ``model`` and,
    where there is one, ``pod``;
  * the autograd collectives below move a tensor along one axis of the
    mesh, each with the adjoint the LM step needs in its backward pass;
  * :func:`gather_tree` and :func:`scatter_tree` move a whole tree of
    local shards to full tensors on rank 0's host and back (checkpoints,
    tests), one shard at a time by point-to-point sends.

Two conventions fix the adjoints. Over ``data`` each rank's loss is its
part of the global loss (the sum over data ranks is the loss), so a
gather's adjoint is a reduce-scatter and an all-to-all's its inverse.
Over ``model`` every rank holds the same loss (Megatron's convention):
activations outside a tensor-parallel region are replicated, so
:func:`copy_in` all-reduces its gradient and :func:`reduce_out` passes
its gradient through.

Every collective adds the bytes of its buffer to :data:`BYTES` and one
to :data:`CALLS` under its kind (``all_gather``: the gathered output;
``reduce_scatter``: the input; ``all_reduce``: the tensor;
``all_to_all``: the input; ``send``: the sent tensor, counted by the
sender), and the same bytes to :data:`AXIS_BYTES` under ``kind/axis``
(``world`` for the whole group), which :func:`reset_bytes` clears.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed import partition as part
from repro_torch.tree import leaves, unflatten

__all__ = ["AXIS_BYTES", "BYTES", "CALLS", "RankGroups", "all_reduce_",
           "all_to_all", "copy_in", "file_init_method", "free_port", "gather",
           "gather_tree", "init_fake", "init_ranks", "mesh_groups",
           "reduce_out",
           "reset_bytes", "scatter_tree", "shutdown", "world_size"]

# collective kind -> bytes moved / calls since the last reset_bytes()
BYTES: collections.Counter = collections.Counter()
CALLS: collections.Counter = collections.Counter()
# "kind/axis" -> bytes: BYTES split by the mesh axis a collective ran over
AXIS_BYTES: collections.Counter = collections.Counter()


def reset_bytes() -> None:
    BYTES.clear()
    CALLS.clear()
    AXIS_BYTES.clear()


def _count(kind: str, t, axis: str | None = None) -> None:
    n = t.numel() * t.element_size()
    BYTES[kind] += n
    CALLS[kind] += 1
    AXIS_BYTES[f"{kind}/{axis or 'world'}"] += n


@dataclasses.dataclass(frozen=True)
class RankGroups:
    """This rank's place on the mesh: its coordinates, its device and the
    subgroup of each axis line through it (``groups[axis]``)."""

    axis_names: tuple
    sizes: tuple
    rank: int
    device: torch.device
    groups: dict = dataclasses.field(compare=False)

    @property
    def world(self) -> int:
        return int(np.prod(self.sizes))

    @property
    def coords(self) -> dict:
        """Axis name -> this rank's index along it (row-major)."""
        return part.mesh_coords(self.axis_names, self.sizes, self.rank)

    def size(self, axis: str) -> int:
        return dict(zip(self.axis_names, self.sizes)).get(axis, 1)

    def index(self, axis: str) -> int:
        return int(self.coords.get(axis, 0))


def init_ranks(axis_names, sizes, *, rank: int, init_method: str,
               device, timeout_s: float = 600.0) -> RankGroups:
    """Join the process group (``nccl`` on a card, ``gloo`` on the host)
    as ``rank`` of ``prod(sizes)`` and build the axis subgroups of that
    mesh (:func:`mesh_groups`). Every rank calls it with the same mesh;
    it returns once all have joined or raises after ``timeout_s``."""
    sizes = tuple(int(s) for s in sizes)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=init_method, world_size=int(np.prod(sizes)), rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return mesh_groups(axis_names, sizes, device, timeout_s=timeout_s)


def init_fake(world: int) -> None:
    """Join ``torch.distributed``'s ``"fake"`` process group as rank 0 of
    ``world``: every collective returns at once and moves nothing (the
    dry-run, :mod:`repro_torch.launch.dryrun`). :func:`mesh_groups`
    builds the axis groups over it; :func:`shutdown` leaves it."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def mesh_groups(axis_names, sizes, device, *,
                timeout_s: float = 600.0) -> RankGroups:
    """The subgroups of every axis line of an ``axis_names`` x ``sizes``
    mesh over the joined process group (of as many ranks), ranks laid
    out row-major. Every rank calls it, with the same mesh."""
    axis_names, sizes = tuple(axis_names), tuple(int(s) for s in sizes)
    world, rank = int(np.prod(sizes)), dist.get_rank()
    if dist.get_world_size() != world:
        raise ValueError(f"a {sizes} mesh needs {world} ranks; the group "
                         f"has {dist.get_world_size()}")
    timeout = datetime.timedelta(seconds=timeout_s)
    grid = np.arange(world).reshape(sizes)
    groups = {}
    for ax, name in enumerate(axis_names):
        lines = np.moveaxis(grid, ax, -1).reshape(-1, sizes[ax])
        for line in lines:   # every rank creates every group, in order
            ranks = [int(r) for r in line]
            g = dist.new_group(ranks, timeout=timeout)
            if rank in ranks:
                groups[name] = g
    return RankGroups(axis_names, sizes, rank, torch.device(device), groups)


def world_size() -> int:
    """The joined process group's size (0 outside one)."""
    return dist.get_world_size() if dist.is_initialized() else 0


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


# --------------------------------------------------------------------------
# raw collectives along one axis (with the byte count)
# --------------------------------------------------------------------------

# the newer names of the tensor collectives, where this torch has them
_ALL_GATHER = getattr(dist, "all_gather_single", None) or (
    dist.all_gather_into_tensor)
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or (
    dist.reduce_scatter_tensor)


def _all_gather(x, dim: int, groups: RankGroups, axis: str):
    n = groups.size(axis)
    x = x.contiguous()
    out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
    _ALL_GATHER(out, x, group=groups.groups[axis])
    _count("all_gather", out, axis)
    # (n, ..., s, ...) -> (..., n s, ...): the shards in axis order
    out = out.unflatten(0, (n, x.shape[0]))
    return torch.movedim(out, 0, dim).flatten(dim, dim + 1)


def _reduce_scatter(g, dim: int, groups: RankGroups, axis: str):
    n = groups.size(axis)
    parts = torch.movedim(g.unflatten(dim, (n, g.shape[dim] // n)), dim, 0)
    parts = parts.contiguous()
    out = parts.new_empty(parts.shape[1:])
    _REDUCE_SCATTER(out, parts.flatten(0, 1), group=groups.groups[axis])
    _count("reduce_scatter", parts, axis)
    return out


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce_(t, groups: RankGroups, axis: str | None, op: str = "sum"):
    """In-place all-reduce (``op``: ``"sum"`` or ``"max"``) of ``t`` over
    ``axis`` (every rank for None; a no-op over one rank); returns
    ``t``."""
    n = groups.world if axis is None else groups.size(axis)
    if n > 1:
        dist.all_reduce(t, op=_OPS[op],
                        group=None if axis is None else groups.groups[axis])
        _count("all_reduce", t, axis)
    return t


def _all_to_all(x, groups: RankGroups, axis: str):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=groups.groups[axis])
    _count("all_to_all", x, axis)
    return out


# --------------------------------------------------------------------------
# autograd collectives
# --------------------------------------------------------------------------

class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``axis``; backward: reduce-scatter
    (the ranks' users of the gathered tensor differ)."""

    @staticmethod
    def forward(ctx, x, dim, groups, axis):
        ctx.dim, ctx.groups, ctx.axis = dim, groups, axis
        return _all_gather(x, dim, groups, axis)

    @staticmethod
    def backward(ctx, g):
        return (_reduce_scatter(g, ctx.dim, ctx.groups, ctx.axis),
                None, None, None)


def gather(x, dim: int, groups: RankGroups, axis: str):
    """``x``'s shards along ``dim`` from every rank of ``axis``,
    concatenated in axis order (``x`` itself on an axis of one)."""
    if groups.size(axis) == 1:
        return x
    return _Gather.apply(x, dim, groups, axis)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, axis):
        ctx.groups, ctx.axis = groups, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.groups,
                           ctx.axis), None, None


def copy_in(x, groups: RankGroups, axis: str = "model"):
    """Megatron's *f*: ``x`` itself forward, its gradient all-reduced over
    ``axis`` backward. Marks where a replicated tensor enters work that
    differs by rank."""
    if groups.size(axis) == 1:
        return x
    return _CopyIn.apply(x, groups, axis)


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, axis):
        return all_reduce_(x.contiguous().clone(), groups, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def reduce_out(x, groups: RankGroups, axis: str = "model"):
    """Megatron's *g*: the sum of the ranks' partial ``x`` forward, the
    gradient passed through backward."""
    if groups.size(axis) == 1:
        return x
    return _ReduceOut.apply(x, groups, axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, axis):
        ctx.groups, ctx.axis = groups, axis
        return _all_to_all(x, groups, axis)

    @staticmethod
    def backward(ctx, g):
        # the exchange is its own transpose: block i came from rank i's
        # block (this rank), and its gradient goes back there
        return _all_to_all(g, ctx.groups, ctx.axis), None, None


def all_to_all(x, groups: RankGroups, axis: str):
    """``x`` (n, ...) over the ``n`` ranks of ``axis``: block ``i`` goes
    to rank ``i``, and block ``i`` of the result came from rank ``i``."""
    if groups.size(axis) == 1:
        return x
    return _AllToAll.apply(x, groups, axis)


# --------------------------------------------------------------------------
# whole trees of shards (checkpoints): rank 0 and one shard at a time
# --------------------------------------------------------------------------

def _owners(sharding, world: int) -> list:
    """The ranks that hold the distinct blocks of a leaf: index 0 on
    every mesh axis its spec does not use (the others hold replicas)."""
    used = {a for e in sharding.spec for a in part.entry_axes(e)}
    names, sizes = sharding.mesh.axis_names, sharding.mesh.sizes
    return [r for r in range(world)
            if all(i == 0 for ax, i in part.mesh_coords(names, sizes, r)
                   .items() if ax not in used)]


@torch.no_grad()
def gather_tree(tree, shardings, groups: RankGroups):
    """Each leaf of a tree of local shards (``shardings``: the same tree
    of :class:`repro_torch.distributed.partition.Sharding`) whole on rank
    0's host, None on the others. Every rank takes part: the holder of
    each distinct block sends it to rank 0, which takes one block at a
    time into the full host tensor; no other rank holds more than its
    shards."""
    out = []
    for leaf, sh in zip(leaves(tree), leaves(shardings)):
        if not isinstance(leaf, torch.Tensor):
            out.append(leaf)
            continue
        owners = _owners(sh, groups.world)
        if groups.rank != 0:
            if groups.rank in owners:
                x = leaf.contiguous()
                dist.send(x, dst=0)
                _count("send", x)
            continue
        full = torch.empty(
            tuple(d * n for d, (_, n) in zip(
                leaf.shape, part.shard_blocks(sh, leaf.ndim, 0))),
            dtype=leaf.dtype)
        for r in owners:
            if r == 0:
                block = leaf
            else:
                block = torch.empty(leaf.shape, dtype=leaf.dtype,
                                    device=leaf.device)
                dist.recv(block, src=r)
            part.local_shard(full, sh, r).copy_(block)
            del block
        out.append(full)
    return unflatten(tree, out) if groups.rank == 0 else None


@torch.no_grad()
def scatter_tree(full, like, shardings, groups: RankGroups):
    """Rank 0's full tree (host tensors; None on the others) cut into each
    rank's shard, leaf by leaf: rank 0 sends every other rank its own
    block, so no rank but rank 0 (on its host) holds a full leaf;
    ``like`` is a tree of the full leaves' shapes and dtypes (``meta``
    tensors do)."""
    like_leaves = leaves(like)
    full_leaves = (leaves(full) if groups.rank == 0
                   else [None] * len(like_leaves))
    out = []
    for ref, sh, src in zip(like_leaves, leaves(shardings), full_leaves):
        if groups.rank == 0:
            for r in range(1, groups.world):
                x = part.local_shard(src, sh, r).contiguous().to(
                    groups.device)
                dist.send(x, dst=r)
                _count("send", x)
                del x
            out.append(part.local_shard(src, sh, 0).to(groups.device)
                       .clone())
        else:
            buf = torch.empty(part.shard_shape(sh, ref.shape),
                              dtype=ref.dtype, device=groups.device)
            dist.recv(buf, src=0)
            out.append(buf)
    return unflatten(like, out)


def free_port() -> int:
    """A free TCP port on localhost (for ``tcp://localhost:<port>``)."""
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return int(s.getsockname()[1])


def file_init_method(directory: str) -> str:
    """A ``FileStore`` address under ``directory``."""
    return "file://" + os.path.join(os.path.abspath(directory), "store")
