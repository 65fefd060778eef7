"""LM meshes: a named grid of devices, and the ambient mesh.

Twin of :mod:`repro.launch.mesh`. A :class:`LMMesh` has the axis names
``("data", "model")`` (or ``("pod", "data", "model")``), a ``shape``
mapping of axis name -> size and ``axis_names``, as
``jax.sharding.Mesh`` has, so :func:`repro_torch.distributed.partition.
spec_for` and ``_axis_size`` read it unchanged.

  * :func:`make_host_mesh` lays a ``(data, model)`` grid over the given
    devices (the visible cards by default). A device may repeat, as in
    :class:`repro_torch.distributed.spike_mesh.SpikeMesh`: a logical
    ``4 x 2`` mesh of one card is the counterpart of JAX's eight faked
    host devices.
  * :func:`make_production_mesh` gives the twin's pod shapes, ``(16,
    16)`` and ``(2, 16, 16)``, as an *abstract* mesh (shape only, no
    devices), the counterpart of ``jax.sharding.AbstractMesh``: it serves
    to compute specs at production size.
  * :func:`use_mesh` sets the ambient mesh, the counterpart of JAX's
    ``with mesh:``, which ``moe_forward_ep`` and ``constrain_seq`` read
    through ``pxla.thread_resources``; :func:`current_mesh` reads it.

A mesh runs in one of two ways:

  * a *logical* mesh of one physical device, whatever its logical shape
    (:func:`single_device`): every shard in one process;
  * a *rank* mesh (:func:`make_rank_mesh`): one process a device on a
    process group (:mod:`repro_torch.distributed.process_group`), its
    ``devices`` the
    ranks' devices and ``ranks`` this rank's groups. The train step runs
    on it (FSDP gathers over ``embed -> data``, Megatron TP over
    ``model``, the expert exchange between ranks; ROADMAP item 12e), and
    so do prefill and decode, each rank holding its shard of the cache
    (the slots over ``model`` where they divide: decode context
    parallelism), for the dense GQA / MQA and MoE families, on a mesh
    with or without a ``pod`` axis (the batch over ``(pod, data)``, the
    params replicated over ``pod``), whether or not ``model`` divides
    the query heads; the other families are item 12e-ii and raise.

A mesh over several distinct devices outside a process group raises: the
twin's program has GSPMD's global semantics (MoE capacity over the whole
microbatch, not a shard's), which per-shard data parallelism would not
keep, so no cheaper stand-in is offered.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["LMMesh", "current_mesh", "make_host_mesh",
           "make_production_mesh", "make_rank_mesh", "single_device",
           "use_mesh"]

# how to run a mesh over several devices, for the errors that refuse one
LAUNCH_HINT = ("launch one process a device on a process group: "
               "`python -m repro_torch.launch.train --ranks --mesh DxM` "
               "(or PxDxM) "
               "(ROADMAP item 12e)")


@dataclasses.dataclass(frozen=True)
class LMMesh:
    """A grid of ``torch.device`` entries over named axes (``devices`` is
    None for an abstract mesh). Hashable; a device may appear more than
    once."""

    axis_names: tuple
    sizes: tuple
    devices: tuple | None = None   # flat, row-major over ``sizes``
    # this rank's groups (a process_group.RankGroups) on a rank mesh
    ranks: Any = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        names, sizes = tuple(self.axis_names), tuple(int(s)
                                                     for s in self.sizes)
        if len(names) != len(sizes) or min(sizes, default=0) < 1:
            raise ValueError(f"a mesh needs one size >= 1 per axis, got "
                             f"{names} x {sizes}")
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "sizes", sizes)
        if self.devices is not None:
            devs = tuple(torch.device(d) for d in self.devices)
            if len(devs) != self.size:
                raise ValueError(f"{len(devs)} devices for a mesh of "
                                 f"{self.size}")
            object.__setattr__(self, "devices", devs)

    @property
    def shape(self) -> dict:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.sizes))

    @property
    def empty(self) -> bool:
        return self.size == 0

    @property
    def abstract(self) -> bool:
        return self.devices is None

    @property
    def is_ranks(self) -> bool:
        """One process a device, on a process group."""
        return self.ranks is not None

    @property
    def physical_devices(self) -> tuple:
        """The distinct devices behind the grid, in grid order."""
        return tuple(dict.fromkeys(self.devices or ()))


def make_production_mesh(*, multi_pod: bool = False) -> LMMesh:
    """The twin's pod mesh ``(16, 16)`` ``("data", "model")``, or ``(2, 16,
    16)`` with a leading ``"pod"`` axis, abstract: specs only."""
    if multi_pod:
        return LMMesh(("pod", "data", "model"), (2, 16, 16))
    return LMMesh(("data", "model"), (16, 16))


def make_host_mesh(data: int | None = None, model: int = 1,
                   devices=None) -> LMMesh:
    """A ``(data, model)`` mesh over ``devices`` (default: the visible
    cards; ``"cuda"`` raises without one). ``data`` defaults to
    ``len(devices) // model``; the grid takes the devices round-robin, so
    a device repeats where the grid is larger than the list."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    data = data or max(1, len(devices) // model)
    n = data * model
    return LMMesh(("data", "model"), (data, model),
                  tuple(devices[i % len(devices)] for i in range(n)))


def make_rank_mesh(groups) -> LMMesh:
    """The mesh of a process group's ranks (``groups``: this rank's
    :class:`repro_torch.distributed.process_group.RankGroups`): its
    ``devices`` are the ranks' devices (``cuda:r`` for rank ``r`` on the
    cards, ``cpu`` each on the host), row-major."""
    from repro_torch.distributed.process_group import world_size

    if world_size() != groups.world:
        raise RuntimeError(
            f"a rank mesh of {groups.world} needs a process group of as "
            f"many ranks; {LAUNCH_HINT}")
    dev = groups.device
    devices = tuple(torch.device("cuda", r) if dev.type == "cuda" else dev
                    for r in range(groups.world))
    return LMMesh(groups.axis_names, groups.sizes, devices, ranks=groups)


def single_device(mesh: LMMesh) -> torch.device:
    """The device a mesh's step runs on here: the one physical device of
    a logical mesh, or this rank's device on a rank mesh. Several
    distinct devices outside a process group raise, naming how to launch;
    an abstract mesh cannot run."""
    if mesh.abstract:
        raise ValueError("an abstract mesh has no devices to run on; "
                         "it gives specs only")
    if mesh.is_ranks:
        return mesh.ranks.device
    devs = mesh.physical_devices
    if len(devs) > 1:
        raise NotImplementedError(
            f"a mesh over several devices ({', '.join(map(str, devs))}) "
            f"runs one process a device, not in this one: {LAUNCH_HINT}; "
            f"a logical mesh of one device runs in one process")
    return devs[0]


def refuse_ranks(mesh, what: str) -> None:
    """Raise for ``what`` (a step of a family, or a lever) on a rank mesh:
    ROADMAP item 12e-ii. The train, prefill and decode steps of the dense
    GQA / MQA and MoE families run across ranks, with or without a
    ``pod`` axis, also where ``model`` does not divide the query heads
    (llama4-scout's 40 on 16); the other families' steps, ``moe_ep`` at
    prefill and decode and the ``expert_parallel`` lever are refused by
    :meth:`repro_torch.launch.steps.LMHarness._refuse_across_ranks`."""
    if mesh is not None and getattr(mesh, "is_ranks", False):
        raise NotImplementedError(
            f"{what} across ranks is not ported yet: ROADMAP Queue 1 item "
            f"12e-ii; the train, prefill and decode steps of the dense GQA "
            f"and MoE families run across ranks")


_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_lm_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: LMMesh | None):
    """Make ``mesh`` the ambient mesh of the body (None clears it)."""
    tok = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(tok)


def current_mesh() -> LMMesh | None:
    """The ambient mesh, or None outside :func:`use_mesh`."""
    return _MESH.get()
