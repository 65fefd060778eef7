"""Fault-tolerant training loop.

Twin of :mod:`repro.training.loop`:

  * resume-exact restart: state = (params, opt_state, step); the stateless
    data pipeline replays from any step and the keys are ``fold_in(step)``,
    so a preempted-and-restarted run gives the same trajectory;
  * periodic + final checkpoints through ``AsyncCheckpointer`` (atomic,
    CRC-checked, keep-k), restored onto the devices the state's tensors
    live on;
  * straggler observation hooks (per-host step times -> detector ->
    callback);
  * simulated-failure injection for tests (raise at step k, restart from
    the latest checkpoint).

A step's time ends with a synchronize on the device of the state's first
tensor leaf (the twin blocks on its first leaf).

Across ranks (one process a device) the state holds this rank's shards,
and ``shards`` (:class:`Shards`) moves it to the checkpoint's full layout
and back: every rank takes part in the gather, rank 0 alone writes, and
a resume reads the file on rank 0 and scatters it, so one checkpoint
serves the one-process and the rank launchers.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.distributed.straggler import StragglerDetector
from repro_torch.tree import leaves, tree_map

__all__ = ["LoopConfig", "Shards", "run_loop"]


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    checkpoint_dir: str | None = None
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    log_every: int = 50
    num_hosts: int = 1               # for the straggler detector
    fail_at_step: int | None = None  # test hook: simulate preemption


@dataclasses.dataclass
class Shards:
    """How a rank's state meets the checkpoint: ``gather(state)`` gives
    the full state on the writer (None elsewhere), ``scatter(full,
    state)`` this rank's state from the writer's full one (None
    elsewhere); every rank calls both."""

    writer: bool
    gather: Callable
    scatter: Callable


def _device_of(leaf) -> torch.device:
    return leaf.device if isinstance(leaf, torch.Tensor) else torch.device(
        "cpu")


def _sync(state) -> None:
    first = next((x for x in leaves(state) if isinstance(x, torch.Tensor)),
                 None)
    if first is not None and first.device.type == "cuda":
        torch.cuda.synchronize(first.device)


def run_loop(
    config: LoopConfig,
    state: dict,
    step_fn: Callable,               # (state, batch) -> (state, metrics)
    batch_fn: Callable,              # step -> batch
    *,
    log_fn: Callable = print,
    on_straggler: Callable | None = None,
    shards: Shards | None = None,
) -> dict:
    """Run (or resume) the training loop. ``state`` must contain 'step'.
    With ``shards`` the state is a rank's (module docstring)."""
    writer = shards is None or shards.writer
    saver = (ckpt.AsyncCheckpointer(config.checkpoint_dir,
                                    config.keep_checkpoints)
             if config.checkpoint_dir and writer else None)
    detector = StragglerDetector(config.num_hosts)

    def save(step, meta):
        full = state if shards is None else shards.gather(state)
        if saver:
            saver.save(step, full, meta)

    start = int(state["step"])
    if config.checkpoint_dir and (
            latest := ckpt.latest_step(config.checkpoint_dir)) is not None:
        if latest >= start:
            if shards is None:
                state, _ = ckpt.load(
                    config.checkpoint_dir, latest, like=state,
                    device_tree=tree_map(_device_of, state))
            else:
                full = (ckpt.load(config.checkpoint_dir, latest,
                                  like=state)[0] if writer else None)
                state = shards.scatter(full, state)
            start = int(state["step"])
            log_fn(f"[loop] resumed from checkpoint step {start}")

    metrics = {}
    for step in range(start, config.total_steps):
        if config.fail_at_step is not None and step == config.fail_at_step:
            if saver:
                saver.wait()
            raise RuntimeError(f"simulated preemption at step {step}")
        batch = batch_fn(step)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        _sync(state)
        dt = time.perf_counter() - t0
        state["step"] = step + 1

        flagged = detector.observe(np.full(config.num_hosts, dt))
        if flagged.any() and on_straggler is not None:
            on_straggler(flagged)

        if config.log_every and step % config.log_every == 0:
            msg = " ".join(f"{k}={float(v):.4f}" for k, v in metrics.items()
                           if np.ndim(v) == 0)
            log_fn(f"[loop] step {step}: {msg} ({dt*1e3:.0f} ms)")
        if config.checkpoint_dir and (step + 1) % config.checkpoint_every == 0:
            save(step + 1, {"wall_time": time.time()})
    if config.checkpoint_dir:
        save(config.total_steps, {"final": True})
    if saver:
        saver.wait()
    return state
