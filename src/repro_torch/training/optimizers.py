"""Optimizers on trees of tensors, with the JAX package's arithmetic.

Twin of :mod:`repro.training.optimizers`. ``torch.optim`` is not used:
each update is the twin's float32 expression, op for op, on lists and
dicts of tensors (:mod:`repro_torch.tree`), and the states keep the twin's
layout (``{"step", "m", "v"}`` for Adam, ``{"step", "mu"}`` for SGD), so
a state carries across the packages leaf for leaf.

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

``step`` is a 0-d int32 tensor on the device of the first param.

Across ranks (one process a device) each rank updates its own shards:
Adam is elementwise, and :func:`clip_by_global_norm` takes ``owned`` (a
flag a leaf: this rank's shard is the one counted among its replicas)
and ``all_reduce`` (sums the partial square sum over every rank), so a
leaf replicated over an axis counts once, not once a rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map

__all__ = [
    "Optimizer",
    "Schedules",
    "sgd",
    "adam",
    "adamw",
    "apply_updates",
    "clip_by_global_norm",
    "global_norm",
    "chain_clip",
]


class Optimizer(NamedTuple):
    init: Callable
    update: Callable  # (grads, state, params) -> (updates, state)


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree, *, owned=None, all_reduce=None) -> torch.Tensor:
    """``sqrt`` of the sum over leaves, in flatten order, of each leaf's
    sum of squares in float32. Across ranks: only the leaves ``owned``
    marks, the partial sum completed by ``all_reduce``."""
    flat = leaves(tree)
    owned = [True] * len(flat) if owned is None else owned
    total = sum(torch.sum(torch.square(x.to(torch.float32)))
                for x, own in zip(flat, owned) if own)
    if all_reduce is not None:
        if not isinstance(total, torch.Tensor):   # this rank owns none
            total = torch.zeros((), dtype=torch.float32,
                                device=flat[0].device)
        total = all_reduce(total)
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float, *, owned=None,
                        all_reduce=None):
    norm = global_norm(grads, owned=owned, all_reduce=all_reduce)
    scale = torch.clamp_max(max_norm / (norm + 1e-12), 1.0)
    return tree_map(lambda g: g * scale, grads), norm


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32)


def _step0(params) -> torch.Tensor:
    first = leaves(params)
    dev = first[0].device if first else None
    return torch.zeros((), dtype=torch.int32, device=dev)


# --------------------------------------------------------------------------
def sgd(lr: float | Callable, momentum: float = 0.0,
        nesterov: bool = False) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        mu = tree_map(_zeros_f32, params) if momentum else None
        return {"step": _step0(params), "mu": mu}

    def update(grads, state, params=None):
        del params
        step = state["step"] + 1
        lr_t = lr_fn(step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g.to(torch.float32),
                          state["mu"], grads)
            if nesterov:
                upd = tree_map(lambda m, g: -lr_t * (momentum * m + g),
                               mu, grads)
            else:
                upd = tree_map(lambda m: -lr_t * m, mu)
            return upd, {"step": step, "mu": mu}
        upd = tree_map(lambda g: -lr_t * g, grads)
        return upd, {"step": step, "mu": None}

    return Optimizer(init, update)


# --------------------------------------------------------------------------
def adam(lr: float | Callable, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    return _adam_impl(lr, b1, b2, eps, weight_decay=0.0)


def adamw(lr: float | Callable, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 0.01) -> Optimizer:
    return _adam_impl(lr, b1, b2, eps, weight_decay=weight_decay)


def _adam_impl(lr, b1, b2, eps, weight_decay) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        return {
            "step": _step0(params),
            "m": tree_map(_zeros_f32, params),
            "v": tree_map(_zeros_f32, params),
        }

    def update(grads, state, params=None):
        # The twin's expressions, op for op; each product or sum lands in
        # place in a fresh temporary, so a leaf holds at most two
        # temporaries of its size (a 2.5 B-param state fits one card).
        step = state["step"] + 1
        lr_t = lr_fn(step)
        stepf = step.to(torch.float32)
        bc1 = 1.0 - torch.pow(b1, stepf)
        bc2 = 1.0 - torch.pow(b2, stepf)
        m = tree_map(
            lambda m_, g: (m_ * b1).add_(
                g.to(torch.float32, copy=True).mul_(1 - b1)),
            state["m"], grads)
        v = tree_map(
            lambda v_, g: (v_ * b2).add_(
                torch.square(g.to(torch.float32)).mul_(1 - b2)),
            state["v"], grads)

        def upd(m_, v_, p=None):
            # -(lr) * (m / bc1) / (sqrt(v / bc2) + eps) [- lr wd p]
            u = (m_ / bc1).mul_(-(lr_t))
            u.div_((v_ / bc2).sqrt_().add_(eps))
            if weight_decay and p is not None:
                u.sub_(p.to(torch.float32, copy=True).mul_(
                    lr_t * weight_decay))
            return u

        if weight_decay and params is not None:
            updates = tree_map(upd, m, v, params)
        else:
            updates = tree_map(lambda m_, v_: upd(m_, v_), m, v)
        return updates, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


# --------------------------------------------------------------------------
def chain_clip(opt: Optimizer, max_norm: float) -> Optimizer:
    """Global-norm clipping composed in front of any optimizer."""

    def update(grads, state, params=None):
        grads, _ = clip_by_global_norm(grads, max_norm)
        return opt.update(grads, state, params)

    return Optimizer(opt.init, update)


# --------------------------------------------------------------------------
def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class Schedules:
    """LR schedules as step -> lr callables (float32 tensors)."""

    @staticmethod
    def constant(lr: float):
        return lambda step: torch.tensor(lr, dtype=torch.float32,
                                         device=torch.as_tensor(step).device)

    @staticmethod
    def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                      floor: float = 0.0):
        def fn(step):
            step = _f32(step)
            warm = peak_lr * step / max(warmup_steps, 1)
            prog = torch.clamp((step - warmup_steps)
                               / max(total_steps - warmup_steps, 1), 0.0, 1.0)
            cos = floor + (peak_lr - floor) * 0.5 * (
                1.0 + torch.cos(math.pi * prog))
            return torch.where(step < warmup_steps, warm, cos)
        return fn

    @staticmethod
    def linear_decay(peak_lr: float, total_steps: int):
        def fn(step):
            s = _f32(step)
            return peak_lr * torch.clamp(1.0 - s / total_steps, 0.0, 1.0)
        return fn
