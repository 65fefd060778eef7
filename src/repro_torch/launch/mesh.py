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

The LM steps run a mesh of one physical device, whatever its logical
shape (:func:`single_device`). A mesh over several distinct cards raises:
executing the LM across cards (FSDP gathers over ``embed -> data``,
Megatron TP over ``model``, the expert exchange between cards) is ROADMAP
Queue 1 item 12e. The twin's program has GSPMD's global semantics (MoE
capacity over the whole microbatch, not a shard's), which per-shard data
parallelism would not keep, so no cheaper stand-in is offered.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["LMMesh", "current_mesh", "make_host_mesh",
           "make_production_mesh", "single_device", "use_mesh"]


@dataclasses.dataclass(frozen=True)
class LMMesh:
    """A grid of ``torch.device`` entries over named axes (``devices`` is
    None for an abstract mesh). Hashable; a device may appear more than
    once."""

    axis_names: tuple
    sizes: tuple
    devices: tuple | None = None   # flat, row-major over ``sizes``

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


def single_device(mesh: LMMesh) -> torch.device:
    """The one physical device a mesh runs on; several distinct devices
    raise (ROADMAP Queue 1 item 12e), an abstract mesh cannot run."""
    if mesh.abstract:
        raise ValueError("an abstract mesh has no devices to run on; "
                         "it gives specs only")
    devs = mesh.physical_devices
    if len(devs) > 1:
        raise NotImplementedError(
            f"LM execution across several devices "
            f"({', '.join(map(str, devs))}) is not ported yet: ROADMAP "
            f"Queue 1 item 12e (FSDP gathers, tensor parallelism and the "
            f"expert exchange between cards); a logical mesh of one device "
            f"runs")
    return devs[0]


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
