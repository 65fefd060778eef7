"""Cost analysis of one step from the ops it dispatches.

Twin of :mod:`repro.hlo_analysis`, named for what it reads: the JAX
package parses the post-SPMD HLO of a compiled step, while the port has
no compiler between the step and the device, so :func:`analyze_step`
runs the step itself under a ``TorchDispatchMode`` (together with
``torch.utils.flop_counter.FlopCounterMode``) and reads every op the
step dispatches, backward and remat recompute included. On fake tensors
(``FakeTensorMode``) under the ``"fake"`` process group this costs host
time only: no device, no data, no communication.

Its conventions are the twin's (``repro.hlo_analysis``):

  * flops       — dot ops exactly (``FlopCounterMode``'s count: mm, bmm,
                  addmm, convolution, attention); every other op that
                  computes a tensor at 1 flop per output element; views,
                  allocations and collectives at none;
  * bytes       — per op, its tensor inputs plus its tensor outputs. The
                  port runs eagerly, so every op is a launch and this is
                  its real traffic, not the twin's estimate at fusion
                  boundaries;
  * collectives — the c10d ops the step issues, under the twin's kind
                  names, each charged the twin's bytes: all-gather its
                  gathered result, reduce-scatter its scattered result,
                  all-reduce the tensor, all-to-all its input (all-reduce
                  weighted 2x downstream, ring reduce-scatter +
                  all-gather).

Besides, :attr:`StepCost.buffer_bytes` charges each collective as
:data:`repro_torch.distributed.process_group.BYTES` does, which differs
in one kind: a reduce-scatter counts its input, ``n`` times its result
over ``n`` ranks. And the memory the twin reads from
``memory_analysis()``: the peak of the live storage bytes, each storage
counted from the op that allocates it until a ``weakref.finalize`` on it
fires (``argument_bytes``: the inputs' storages, live throughout;
``temp_bytes``: the peak above them; ``total_bytes``: the peak;
``output_bytes``: the result's storages that are not inputs'). Python's
cyclic collector is paused while the step runs, so a storage is freed
when reference counting frees it, as in a step on the card, where the
collector, triggered by Python allocations, rarely runs: on fake tensors
(many more allocations an op) it would run far more often and free
early what a reference cycle holds.
"""

from __future__ import annotations

import dataclasses
import gc
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

__all__ = ["StepCost", "analyze_step", "collective_profile",
           "memory_profile"]

# the c10d op of each process_group collective -> (kind, index of the
# argument charged in the twin's convention, index of the argument
# process_group.BYTES charges); any other c10d op counts under its name,
# charged its first argument
_COLLECTIVES = {
    "_allgather_base_": ("all-gather", 0, 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0, 1),
    "allreduce_": ("all-reduce", 0, 0),
    "alltoall_base_": ("all-to-all", 1, 1),
}

# ops that only allocate: memory, but no flops and no bytes moved
_ALLOCATING = {"empty", "empty_like", "new_empty", "empty_strided",
               "new_empty_strided"}

_DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8",
    torch.int16: "s16", torch.bfloat16: "bf16", torch.float16: "f16",
    torch.int32: "s32", torch.float32: "f32", torch.int64: "s64",
    torch.float64: "f64",
}


def _tensors(x):
    """The tensors in an argument (nested lists, tuples and dicts)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _shape(t) -> str:
    """The twin's shape string: ``bf16[2048,8192]``."""
    name = _DTYPE_NAMES.get(t.dtype, str(t.dtype).replace("torch.", ""))
    return f"{name}[{','.join(str(int(d)) for d in t.shape)}]"


@dataclasses.dataclass
class StepCost:
    flops: float
    bytes_accessed: float
    collective_bytes: dict[str, float]
    collective_counts: dict[str, float]
    dot_flops: float = 0.0
    buffer_bytes: dict[str, float] = dataclasses.field(default_factory=dict)
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    total_bytes: int = 0
    # (op or kind, shape) -> [bytes, count, first op's index in the trace]
    op_rows: dict = dataclasses.field(default_factory=dict, repr=False)
    collective_rows: dict = dataclasses.field(default_factory=dict,
                                              repr=False)

    @property
    def total_collective_bytes(self) -> float:
        """Per-device wire bytes; all-reduce counts 2x (ring RS + AG)."""
        w = {"all-reduce": 2.0}
        return float(sum(v * w.get(k, 1.0)
                         for k, v in self.collective_bytes.items()))

    def as_dict(self) -> dict:
        return {
            "counts": dict(self.collective_counts),
            "bytes_by_kind": dict(self.collective_bytes),
            "total_bytes": self.total_collective_bytes,
        }


class _Live:
    """The live storage bytes and their peak: a storage counts from the
    op that allocates it until the finalizer on it fires."""

    def __init__(self):
        self.keys: set = set()
        self.bytes = self.peak = 0
        self.finalizers: list = []

    def add(self, storage) -> bool:
        key = storage._cdata
        if key in self.keys:
            return False
        n = storage.nbytes()
        self.keys.add(key)
        self.bytes += n
        self.peak = max(self.peak, self.bytes)
        f = weakref.finalize(storage, self._free, key, n)
        f.atexit = False
        self.finalizers.append(f)
        return True

    def _free(self, key, n) -> None:
        self.keys.discard(key)
        self.bytes -= n

    def close(self) -> None:
        for f in self.finalizers:
            f.detach()
        self.finalizers.clear()


class _Trace(TorchDispatchMode):
    """Counts flops, bytes, collectives and live storage of every op
    dispatched under it; ``counter`` (a ``FlopCounterMode`` entered
    below it) gives each op's dot flops."""

    def __init__(self, counter: FlopCounterMode, live: _Live,
                 cost: StepCost):
        super().__init__()
        self.counter, self.live, self.cost = counter, live, cost
        self.n_ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        before = self.counter.get_total_flops()
        out = func(*args, **kwargs)
        self.n_ops += 1
        name = func._schema.name.split("::")[-1]
        if func.namespace == "c10d":
            self._collective(name, args)
            return out
        outs = list(_tensors(out))
        if func.namespace != "aten" or not outs:
            return out
        rets = func._schema.returns
        if any(r.alias_info is not None and not r.alias_info.is_write
               for r in rets):
            return out   # a view: no flops, no bytes, no storage
        if not any(r.alias_info is not None for r in rets):
            for t in outs:   # out of place: its storage is new
                self.live.add(t.untyped_storage())
        if name in _ALLOCATING:
            return out
        dot = self.counter.get_total_flops() - before
        c = self.cost
        if dot:
            c.dot_flops += dot
            c.flops += dot
        else:
            c.flops += sum(t.numel() for t in outs)
        ins = {id(t): t for a in (*args, *kwargs.values())
               for t in _tensors(a)}
        b = sum(_nbytes(t) for t in ins.values()) + sum(_nbytes(t)
                                                        for t in outs)
        c.bytes_accessed += b
        row = c.op_rows.setdefault((name, _shape(outs[0])),
                                   [0.0, 0, self.n_ops])
        row[0] += b
        row[1] += 1
        return out

    def _collective(self, name: str, args) -> None:
        kind, res, buf = _COLLECTIVES.get(name, (name, 0, 0))
        c = self.cost
        result = list(_tensors(args[res]))
        b = float(sum(_nbytes(t) for t in result))
        c.collective_bytes[kind] = c.collective_bytes.get(kind, 0.0) + b
        c.collective_counts[kind] = c.collective_counts.get(kind, 0) + 1
        c.buffer_bytes[kind] = c.buffer_bytes.get(kind, 0.0) + float(
            sum(_nbytes(t) for t in _tensors(args[buf])))
        row = c.collective_rows.setdefault(
            (kind, _shape(result[0]) if result else "()"),
            [0.0, 0, self.n_ops])
        row[0] += b * (2.0 if kind == "all-reduce" else 1.0)
        row[1] += 1


def analyze_step(fn, *args, **kwargs) -> tuple:
    """``(fn(*args, **kwargs), StepCost)``: run ``fn`` once and count what
    it dispatches. Call it inside ``FakeTensorMode`` with fake inputs to
    cost a step without running it (a collective then needs the
    ``"fake"`` process group), or on real tensors to count a real
    step."""
    cost = StepCost(flops=0.0, bytes_accessed=0.0, collective_bytes={},
                    collective_counts={})
    live = _Live()
    for t in _tensors((args, kwargs)):
        live.add(t.untyped_storage())
    cost.argument_bytes = live.bytes
    arg_keys = set(live.keys)
    counter = FlopCounterMode(display=False)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with counter, _Trace(counter, live, cost):
            out = fn(*args, **kwargs)
        seen = set()
        for t in _tensors(out):
            s = t.untyped_storage()
            if s._cdata not in arg_keys and s._cdata not in seen:
                seen.add(s._cdata)
                cost.output_bytes += s.nbytes()
    finally:
        if collecting:
            gc.enable()
        live.close()
    cost.total_bytes = live.peak
    cost.temp_bytes = live.peak - cost.argument_bytes
    return out, cost


def _ranked(rows: dict, top: int) -> list[tuple]:
    out = [(v[0], k[0], k[1], v[1], f"op#{v[2]}") for k, v in rows.items()]
    out.sort(reverse=True)
    return out[:top]


def memory_profile(cost: StepCost, top: int = 16) -> list[tuple]:
    """Bytes accessed by (op, result shape), largest first:
    ``[(bytes, op, shape, count, first op), ...]``."""
    return _ranked(cost.op_rows, top)


def collective_profile(cost: StepCost, top: int = 12) -> list[tuple]:
    """Collective bytes by (kind, result shape), all-reduce weighted 2x,
    largest first: ``[(weighted_bytes, kind, shape, count, first op),
    ...]``."""
    return _ranked(cost.collective_rows, top)
