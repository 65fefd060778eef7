"""Fault-tolerant checkpointing (atomic, versioned, elastic).

Twin of :mod:`repro.checkpoint`, with the same on-disk layout, so each
package loads the other's checkpoints:

  * ``<dir>/step_<n>/arrays.npz``: one entry per leaf, keyed by the leaf's
    ``/``-joined path in ``jax.tree``'s flatten order (dict keys sorted;
    :mod:`repro_torch.tree`). Leaves numpy cannot store (bfloat16, the
    float8 types) are stored as same-width unsigned views and restored
    through the torch dtype of the manifest's name.
  * ``manifest.msgpack``: keys, dtypes, shapes, a tree description, the
    CRC32 of ``arrays.npz`` and user metadata, through the port's own
    MessagePack codec (:mod:`repro_torch.checkpoint._msgpack`).
  * **Atomicity**: staged into ``<dir>/tmp.<step>.<pid>`` and
    ``os.replace``d into place; a crashed save never shadows a good one.
  * **Integrity**: ``load`` checks the CRC32 before restoring.
  * **Retention**: the ``keep`` newest are kept; older ones are removed
    only after a successful save.
  * **Elasticity**: the format holds logical host arrays and no device;
    ``load(..., device_tree=...)`` puts each leaf on its device.
  * **Async**: ``AsyncCheckpointer`` copies to the host at call time and
    writes on a worker thread.

``load`` returns torch tensors on the host (or on ``device_tree``'s
devices).
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack
from repro_torch.tree import (
    flatten_with_paths,
    structure_str,
    tree_map,
    unflatten,
)

__all__ = ["save", "load", "latest_step", "all_steps", "AsyncCheckpointer",
           "CheckpointError"]

_STEP_RE = re.compile(r"^step_(\d+)$")
_NATIVE_KINDS = set("biufc?")  # bool/int/uint/float/complex


class CheckpointError(RuntimeError):
    pass


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as (the array stored in the npz, its dtype's name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        name = str(t.dtype).removeprefix("torch.")
        try:
            return t.numpy(), name
        except TypeError:  # no numpy dtype: store the raw bits
            width = t.element_size()
            raw = t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                          8: torch.int64}[width]).numpy()
            return raw.view(f"u{width}"), name
    arr = np.asarray(leaf)
    if arr.dtype.kind in _NATIVE_KINDS:
        return arr, arr.dtype.name
    return arr.view(f"u{arr.dtype.itemsize}"), str(arr.dtype)


def _restore(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if arr.dtype.name == dtype_name:
        return torch.from_numpy(np.array(arr, copy=True))
    dtype = getattr(torch, dtype_name, None)
    if not isinstance(dtype, torch.dtype):
        raise CheckpointError(f"unknown dtype {dtype_name!r} in manifest")
    signed = {1: np.uint8, 2: np.int16, 4: np.int32, 8: np.int64}[
        arr.dtype.itemsize]
    return torch.from_numpy(np.array(arr.view(signed), copy=True)).view(dtype)


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _flatten(tree) -> dict[str, tuple[np.ndarray, str]]:
    return {_key(path): _host(leaf)
            for path, leaf in flatten_with_paths(tree)}


def save(directory: str, step: int, tree, metadata: dict | None = None,
         keep: int = 3) -> str:
    """Atomically persist ``tree`` as ``<directory>/step_<step>``."""
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree)
    tmp = os.path.join(directory, f"tmp.{step}.{os.getpid()}")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        arrays_path = os.path.join(tmp, "arrays.npz")
        np.savez(arrays_path, **{k: a for k, (a, _) in flat.items()})
        with open(arrays_path, "rb") as f:
            crc = zlib.crc32(f.read())
        manifest = {
            "step": step,
            "keys": list(flat.keys()),
            "dtypes": {k: name for k, (_, name) in flat.items()},
            "shapes": {k: list(a.shape) for k, (a, _) in flat.items()},
            "treedef": structure_str(tree),
            "crc32": crc,
            "metadata": metadata or {},
        }
        with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
            f.write(_msgpack.packb(manifest))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    steps = sorted(all_steps(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s}"),
                      ignore_errors=True)


def all_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = _STEP_RE.match(name)
        if m and os.path.exists(
                os.path.join(directory, name, "manifest.msgpack")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(directory: str) -> int | None:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def load(directory: str, step: int | None = None, *, like=None,
         device_tree=None) -> tuple[Any, dict]:
    """Restore a checkpoint.

    Args:
      directory: checkpoint root.
      step: which step (default: latest).
      like: a tree with the target structure; required to rebuild it (the
        manifest stores paths, not code objects). Without it the result is
        a flat ``{path: tensor}`` dict.
      device_tree: optional tree of devices matching ``like``; each leaf
        is moved to its device.
    Returns: (tree of host tensors, metadata)
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise CheckpointError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step}")
    man_path = os.path.join(path, "manifest.msgpack")
    if not os.path.exists(man_path):
        raise CheckpointError(f"missing manifest in {path}")
    with open(man_path, "rb") as f:
        manifest = _msgpack.unpackb(f.read())
    arrays_path = os.path.join(path, "arrays.npz")
    with open(arrays_path, "rb") as f:
        raw = f.read()
    if zlib.crc32(raw) != manifest["crc32"]:
        raise CheckpointError(
            f"checkpoint {path} failed CRC validation (corrupt/partial)")
    with np.load(arrays_path) as npz:
        flat = {k: _restore(npz[k], manifest["dtypes"][k])
                for k in manifest["keys"]}
    if like is None:
        return flat, manifest["metadata"]
    paths = [_key(p) for p, _ in flatten_with_paths(like)]
    missing = [p for p in paths if p not in flat]
    if missing:
        raise CheckpointError(f"checkpoint missing keys: {missing[:5]} ...")
    tree = unflatten(like, [flat[p] for p in paths])
    if device_tree is not None:
        tree = tree_map(lambda x, d: x.to(d), tree, device_tree)
    return tree, manifest["metadata"]


def _host_copy(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


@dataclasses.dataclass
class AsyncCheckpointer:
    """Overlap checkpoint IO with training (single in-flight save)."""

    directory: str
    keep: int = 3
    _thread: threading.Thread | None = None
    _error: BaseException | None = None

    def save(self, step: int, tree, metadata: dict | None = None) -> None:
        self.wait()  # one in-flight save; device->host copy happens HERE
        flat_host = tree_map(_host_copy, tree)

        def worker():
            try:
                save(self.directory, step, flat_host, metadata, self.keep)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
