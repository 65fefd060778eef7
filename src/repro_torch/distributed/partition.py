"""Logical-axis -> mesh partitioning with divisibility fallbacks.

Twin of :mod:`repro.distributed.partition`. A rule maps a logical axis
name to a mesh axis (or a tuple of mesh axes); every rule is subject to a
divisibility check against the actual dim, and on failure the dim
replicates. :func:`spec_for` returns the tuple of entries JAX's
``PartitionSpec`` would hold, trailing ``None`` entries dropped.

A mesh here is anything with a ``shape`` mapping of axis name -> size
(and ``axis_names``): :class:`repro_torch.distributed.spike_mesh.
SpikeMesh` for the SNN, :class:`repro_torch.launch.mesh.LMMesh` for the
LM. The LM half mirrors the twin's policy:

  vocab  -> model          embed  -> data (FSDP / ZeRO)
  heads, kv, ffn -> model  expert -> None, or model (expert parallel)
  batch  -> (pod, data)    cache_seq -> model

:func:`params_partition`, :func:`opt_partition`, :func:`batch_partition`
and :func:`cache_partition` return trees of :class:`Sharding` (a mesh
and a spec tuple), the twin's ``NamedSharding``s. The activation
constraints (:func:`activation_sharding`, :func:`constrain_batch`,
:func:`constrain_seq`) read the context as the twin's do and return
their input unchanged: a logical mesh runs on one device
(:func:`repro_torch.launch.mesh.single_device`), where a layout
constraint has nothing to move, and in the rank step (one process a
device, :mod:`repro_torch.distributed.process_group`) activations are
local by construction.

For the rank step, :func:`shard_shape` is the twin's
``NamedSharding.shard_shape``, :func:`local_shard` cuts a rank's shard
from a full tensor and :func:`assemble` puts the ranks' shards back
together; :func:`rank_plan` sets the context the LM's layers read
(:func:`current_rank_plan`): the process group and the spec of every
param leaf, from which a layer gathers its ``embed -> data`` shards
(:meth:`RankPlan.fsdp`). For the serving steps across ranks,
:func:`cache_shards` allocates a rank's shard of each cache leaf (never
the whole cache), and :func:`kv_layout` names which of the partitioner's
three K/V cache layouts a sharding is: the slots over ``model`` (decode
context parallelism), the K/V heads over ``model``, or replicated over
it.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.tree import flatten_with_paths, leaves, tree_map, unflatten

__all__ = ["PartitionRules", "RankPlan", "Sharding", "activation_sharding",
           "assemble", "batch_partition", "cache_partition", "cache_shards",
           "constrain_batch", "constrain_seq", "current_rank_plan",
           "entry_axes", "kv_layout", "layer_shardings", "local_shard",
           "mesh_coords",
           "opt_partition", "params_partition", "rank_plan", "shard_blocks",
           "shard_shape", "spec_for"]


@dataclasses.dataclass(frozen=True)
class PartitionRules:
    """Logical axis name -> mesh axis (or tuple of mesh axes)."""

    rules: dict[str, Any] = dataclasses.field(default_factory=dict)
    batch_axes: tuple[str, ...] = ("data",)

    @classmethod
    def default(cls, mesh, *, expert_parallel: bool = False,
                attn_tp: bool = True) -> "PartitionRules":
        """The LM policy on ``mesh``. ``attn_tp=False`` replicates the
        attention projections; ``expert_parallel`` shards the expert dim
        over ``model`` instead of the ffn dim."""
        multi_pod = "pod" in mesh.axis_names
        rules = {
            "vocab": "model",
            "embed": "data",
            "heads": "model" if attn_tp else None,
            "kv": "model" if attn_tp else None,
            "ffn": "model" if not expert_parallel else None,
            "expert": "model" if expert_parallel else None,
            "layers": None,
            "cache_seq": "model",
            "cache_batch": ("pod", "data") if multi_pod else ("data",),
        }
        return cls(rules=rules,
                   batch_axes=("pod", "data") if multi_pod else ("data",))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """The twin's ``NamedSharding``: a mesh and the entries of its
    ``PartitionSpec`` (a tuple, trailing ``None`` entries dropped), which
    ``PartitionSpec`` writes canonically: a tuple of one mesh axis as the
    axis's name, an empty one as ``None``."""

    mesh: Any
    spec: tuple = ()

    def __post_init__(self):
        object.__setattr__(self, "spec", tuple(
            (e[0] if len(e) == 1 else (e or None))
            if isinstance(e, tuple) else e for e in self.spec))


def _axis_size(mesh, mesh_axes) -> int:
    if mesh_axes is None:
        return 1
    if isinstance(mesh_axes, str):
        mesh_axes = (mesh_axes,)
    return int(np.prod([mesh.shape[a] for a in mesh_axes]))


def spec_for(logical_axes, shape, mesh, rules: PartitionRules) -> tuple:
    """Resolve logical axes to partition entries with divisibility
    checks: one entry per dim (a mesh axis name, a tuple of them, or
    ``None`` = replicated), trailing ``None`` entries dropped. A mesh
    axis is used by at most one dim."""
    out = []
    used: set[str] = set()
    for ax, dim in zip(logical_axes, shape):
        mesh_axes = rules.rules.get(ax) if ax is not None else None
        if mesh_axes is None:
            out.append(None)
            continue
        names = (mesh_axes,) if isinstance(mesh_axes, str) else tuple(
            mesh_axes)
        if any(n in used for n in names):
            out.append(None)
            continue
        size = _axis_size(mesh, names)
        if size <= 1 or dim % size != 0:
            out.append(None)
            continue
        used.update(names)
        out.append(mesh_axes if isinstance(mesh_axes, str) else names)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _pstr(entry) -> str:
    """A path entry as the twin's ``_pstr`` writes it (a dict key, or a
    sequence index)."""
    return str(entry)


def params_partition(param_shapes, mesh, rules: PartitionRules):
    """A tree of tensors (``meta`` ones do) -> a tree of :class:`Sharding`
    by each leaf's logical axes (:func:`repro_torch.models.common.
    axes_of` on its joined path)."""
    from repro_torch.models.common import axes_of

    def one(path, leaf):
        axes = axes_of("/".join(_pstr(p) for p in path), leaf)
        return Sharding(mesh, spec_for(axes, leaf.shape, mesh, rules))

    return unflatten(param_shapes, [one(p, leaf) for p, leaf in
                                    flatten_with_paths(param_shapes)])


def opt_partition(opt_shapes, params_shard, mesh):
    """Adam-style state ``{'step', 'm': <params>, 'v': <params>}``: the
    moments shard exactly like the params, the rest replicates."""
    replicated = Sharding(mesh, ())
    out = {}
    for key, sub in opt_shapes.items():
        if key in ("m", "v", "mu") and sub is not None:
            out[key] = params_shard
        else:
            out[key] = tree_map(lambda _: replicated, sub)
    return out


# --------------------------------------------------------------------------
# Activation-sharding context: the twin's models constrain the batch (or
# sequence) dim where GSPMD propagation drops it, inside the context the
# steps set. Here the steps set the same context, and the constraints
# return their input: one device holds every shard.
# --------------------------------------------------------------------------

_ACT_CTX: "contextvars.ContextVar[tuple | None]" = contextvars.ContextVar(
    "repro_torch_activation_sharding", default=None)


@contextlib.contextmanager
def activation_sharding(batch_axes: tuple[str, ...], batch_size: int,
                        mesh):
    size = _axis_size(mesh, tuple(batch_axes))
    tok = _ACT_CTX.set((tuple(batch_axes), size, batch_size))
    try:
        yield
    finally:
        _ACT_CTX.reset(tok)


def constrain_batch(x, batch_axis: int = 0):
    """The twin's batch-dim constraint: ``x`` itself."""
    del batch_axis
    return x


def constrain_seq(x, seq_axis: int = 1, batch_axis: int | None = 0,
                  mesh_axis: str = "model"):
    """The twin's context-parallel constraint (the sequence dim over
    ``model``): ``x`` itself."""
    del seq_axis, batch_axis, mesh_axis
    return x


# --------------------------------------------------------------------------
# Batch / cache shardings (name-pattern based)
# --------------------------------------------------------------------------

_BATCH_AXES_BY_KEY: dict[str, tuple[str | None, ...]] = {
    # leading axes per rank; "B" = batch; the sequence dim replicates
    "tokens": ("B", None),
    "targets": ("B", None),
    "embeds": ("B", None, None),
    "enc_embeds": ("B", None, None),
    "mrope_positions": (None, "B", None),
    "positions": ("B", None),
}


def batch_partition(batch_shapes, mesh, rules: PartitionRules):
    """Step inputs by leaf name: the batch dim over the batch axes where
    it divides their size, all else replicated."""
    size = _axis_size(mesh, rules.batch_axes)

    def one(path, leaf):
        key = _pstr(path[-1]) if path else ""
        axes = _BATCH_AXES_BY_KEY.get(key, (None,) * leaf.ndim)
        spec = [tuple(rules.batch_axes)
                if ax == "B" and dim % size == 0 and size > 1 else None
                for ax, dim in zip(axes, leaf.shape)]
        while spec and spec[-1] is None:
            spec.pop()
        return Sharding(mesh, tuple(spec))

    return unflatten(batch_shapes, [one(p, leaf) for p, leaf in
                                    flatten_with_paths(batch_shapes)])


_CACHE_AXES_BY_KEY: dict[str, tuple[str | None, ...]] = {
    # per-layer-stacked cache leaves (leading "layers" dim)
    "k": ("layers", "cache_batch", "cache_seq", "kv", None),
    "v": ("layers", "cache_batch", "cache_seq", "kv", None),
    "slot_pos": ("layers", "cache_seq"),
    "ckv": ("layers", "cache_batch", "cache_seq", None),
    "k_rope": ("layers", "cache_batch", "cache_seq", None),
    "ssm": ("layers", "cache_batch", "ffn", None, None),
    "conv": ("layers", "cache_batch", None, "ffn"),
    "state": ("layers", "cache_batch", "heads", None, None),
    "x_att": ("layers", "cache_batch", "embed"),
    "x_ffn": ("layers", "cache_batch", "embed"),
}


def cache_partition(cache_shapes, mesh, rules: PartitionRules):
    """Shardings for (stacked) decode caches by leaf name; the split
    cache's group dims (G[, nloc]) lead and replicate."""

    def one(path, leaf):
        key = _pstr(path[-1])
        axes = _CACHE_AXES_BY_KEY.get(key, ("layers",) + (None,) *
                                      (leaf.ndim - 1))
        if leaf.ndim > len(axes):
            axes = (None,) * (leaf.ndim - len(axes)) + tuple(axes)
        axes = axes[-leaf.ndim:] if leaf.ndim < len(axes) else axes
        return Sharding(mesh, spec_for(axes, leaf.shape, mesh, rules))

    return unflatten(cache_shapes, [one(p, leaf) for p, leaf in
                                    flatten_with_paths(cache_shapes)])


# the fill of a fresh cache leaf by name (an unwritten slot's position is
# -1, as ``init_gqa_cache`` writes it); every other leaf starts at zero
_CACHE_FILL = {"slot_pos": -1}


def cache_shards(cache_shapes, shardings, device):
    """A rank's fresh cache: each leaf of ``cache_shapes`` (``meta``
    tensors do) allocated at its shard's shape under ``shardings`` (from
    :func:`cache_partition`) on ``device`` and filled as the whole cache
    starts, so no rank ever holds the whole of a sharded leaf."""
    def one(path, leaf, sh):
        return torch.full(shard_shape(sh, leaf.shape),
                          _CACHE_FILL.get(_pstr(path[-1]), 0),
                          dtype=leaf.dtype, device=device)

    return unflatten(cache_shapes, [
        one(p, leaf, sh) for (p, leaf), sh in zip(
            flatten_with_paths(cache_shapes), leaves(shardings))])


def kv_layout(sharding) -> str:
    """Which layout :func:`cache_partition` gave a K/V cache leaf (the
    ``(B, T, KV, hd)`` sharding of one layer, :func:`layer_shardings`):
    ``"seq"`` when its slots ``T`` split over ``model`` (``T % M == 0``),
    ``"heads"`` when its K/V heads do (``T % M != 0``, ``KV % M == 0``),
    else ``"replicated"`` over ``model``."""
    spec = tuple(sharding.spec) + (None,) * 4
    if "model" in entry_axes(spec[1]):
        return "seq"
    if "model" in entry_axes(spec[2]):
        return "heads"
    return "replicated"


# --------------------------------------------------------------------------
# Shards of a rank (the twin's NamedSharding.shard_shape and the cut)
# --------------------------------------------------------------------------

def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(sharding: Sharding, shape) -> tuple:
    """The local shape of a ``shape`` array under ``sharding``, as
    ``NamedSharding.shard_shape``: each dim divided by the size of its
    mesh axes (a dim they do not divide raises)."""
    out = [int(d) for d in shape]
    for i, entry in enumerate(sharding.spec):
        n = _axis_size(sharding.mesh, entry_axes(entry) or None)
        if out[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"over {entry} ({n})")
        out[i] //= n
    return tuple(out)


def mesh_coords(axis_names, sizes, rank: int) -> dict:
    """Axis name -> index of ``rank`` on an ``axis_names`` x ``sizes``
    mesh (row-major, as ``LMMesh.devices`` lays the ranks out)."""
    return dict(zip(axis_names,
                    (int(i) for i in np.unravel_index(rank, sizes))))


def shard_blocks(sharding: Sharding, ndim: int, rank: int) -> list:
    """Per dim, ``(block index, block count)`` of ``rank``'s shard: a dim
    over several mesh axes counts them row-major, the first major."""
    coords = mesh_coords(sharding.mesh.axis_names, sharding.mesh.sizes,
                         rank)
    out = []
    for i in range(ndim):
        axes = entry_axes(sharding.spec[i] if i < len(sharding.spec)
                           else None)
        idx, n = 0, 1
        for ax in axes:
            size = sharding.mesh.shape[ax]
            idx, n = idx * size + coords[ax], n * size
        out.append((idx, n))
    return out


def local_shard(x, sharding: Sharding, rank: int):
    """``rank``'s shard of the full array ``x`` (numpy or torch) under
    ``sharding``: a view of ``x``."""
    index = []
    for d, (i, n) in zip(x.shape, shard_blocks(sharding, x.ndim, rank)):
        s = d // n
        index.append(slice(i * s, (i + 1) * s))
    return x[tuple(index)]


def assemble(shards, sharding: Sharding):
    """The full array from ``shards[r]``, rank ``r``'s local shard under
    ``sharding`` for every rank of its mesh: the inverse of
    :func:`local_shard` (replicas write the same block)."""
    first = shards[0]
    blocks = shard_blocks(sharding, first.ndim, 0)
    full = tuple(d * n for d, (_, n) in zip(first.shape, blocks))
    if isinstance(first, np.ndarray):
        out = np.empty(full, first.dtype)
    else:
        out = first.new_empty(full)
    for r, x in enumerate(shards):
        index = []
        for d, (i, _) in zip(x.shape, shard_blocks(sharding, x.ndim, r)):
            index.append(slice(i * d, (i + 1) * d))
        out[tuple(index)] = x
    return out


def layer_shardings(shardings):
    """The shardings of one layer of a tree of layer-stacked leaves: each
    spec without its leading ``layers`` entry (which the rules never
    shard)."""
    return tree_map(lambda s: Sharding(s.mesh, s.spec[1:]), shardings)


# --------------------------------------------------------------------------
# The rank step's context
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RankPlan:
    """What a layer of the rank step reads: the process group (a
    :class:`repro_torch.distributed.process_group.RankGroups`) and
    ``shardings``, the :class:`Sharding` of every param leaf (the
    params' tree). The serving steps add ``cache``, the stacked cache's
    shardings (:func:`cache_partition`), and ``rows_split``: whether the
    batch's rows split over the batch axes (``pod`` x ``data``, as
    :func:`batch_partition` splits them where their size divides the
    batch) or every rank holds them all."""

    groups: Any
    shardings: Any
    cache: Any = None
    rows_split: bool = True

    def layer_shardings(self, key: str = "layers"):
        """The shardings of one layer of the stacked ``params[key]``."""
        return layer_shardings(self.shardings[key])

    def kv_layout(self) -> str:
        """:func:`kv_layout` of the cache's ``k`` (every layer's is the
        same)."""
        return kv_layout(layer_shardings(self.cache)["k"])

    @property
    def batch_axes(self) -> tuple:
        """The mesh axes the batch's rows split over, major first: ``("pod",
        "data")`` on a mesh with a pod axis, else ``("data",)`` (the
        partitioner's ``batch_axes``)."""
        return tuple(a for a in ("pod", "data")
                     if a in self.groups.axis_names) or ("data",)

    @property
    def dp(self) -> int:
        """The batch shards: the size of :attr:`batch_axes`."""
        return int(np.prod([self.groups.size(a) for a in self.batch_axes]))

    @property
    def batch_index(self) -> int:
        """This rank's batch shard: its row-major index over
        :attr:`batch_axes` (pod-major), the block of rows it holds."""
        idx = 0
        for a in self.batch_axes:
            idx = idx * self.groups.size(a) + self.groups.index(a)
        return idx

    def gather_rows(self, x, dim: int = 0):
        """Every batch shard's rows of ``x`` along ``dim``, in batch order:
        gathered over ``data``, then over ``pod`` (pod-major), so the
        backward reduce-scatters over ``pod``, then ``data``."""
        from repro_torch.distributed import process_group as pg

        for axis in reversed(self.batch_axes):
            x = pg.gather(x, dim, self.groups, axis)
        return x

    def fsdp(self, tree, shardings):
        """``tree``'s leaves with their ``data``-sharded dims gathered
        (FSDP): the gather's backward reduce-scatters the gradient to the
        shard. ``shardings`` are the leaves' (a layer's from
        :meth:`layer_shardings`)."""
        from repro_torch.distributed import process_group as pg

        def one(x, sh):
            for dim, entry in enumerate(sh.spec):
                if "data" in entry_axes(entry):
                    x = pg.gather(x, dim, self.groups, "data")
            return x

        return tree_map(one, tree, shardings)


_RANK_PLAN: "contextvars.ContextVar[RankPlan | None]" = (
    contextvars.ContextVar("repro_torch_rank_plan", default=None))


@contextlib.contextmanager
def rank_plan(plan: RankPlan | None):
    tok = _RANK_PLAN.set(plan)
    try:
        yield plan
    finally:
        _RANK_PLAN.reset(tok)


def current_rank_plan() -> RankPlan | None:
    """The rank step's plan, or None outside it (one process)."""
    return _RANK_PLAN.get()
