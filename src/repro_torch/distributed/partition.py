"""Logical-axis -> mesh partitioning with divisibility fallbacks.

Twin of :mod:`repro.distributed.partition`, the part the spike mesh reads:
:class:`PartitionRules` and :func:`spec_for`. A rule maps a logical axis
name to a mesh axis (or a tuple of mesh axes); every rule is subject to a
divisibility check against the actual dim, and on failure the dim
replicates. :func:`spec_for` returns the tuple of entries JAX's
``PartitionSpec`` would hold, trailing ``None`` entries dropped.

A mesh here is anything with a ``shape`` mapping of axis name -> size
(:class:`repro_torch.distributed.spike_mesh.SpikeMesh`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

__all__ = ["PartitionRules", "spec_for"]


@dataclasses.dataclass(frozen=True)
class PartitionRules:
    """Logical axis name -> mesh axis (or tuple of mesh axes)."""

    rules: dict[str, Any] = dataclasses.field(default_factory=dict)
    batch_axes: tuple[str, ...] = ("data",)


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
