"""Shared benchmark plumbing: timing helper + CSV / JSON emission.

Twin of ``benchmarks/common.py``: the same functions, the same CSV line
and the same schema-v2 records, timed with a ``torch.cuda.synchronize()``
after each call where the JAX twin blocks until its result is ready.
"""

from __future__ import annotations

import json
import platform
import subprocess
import time

import torch

from repro_torch.bench_schema import AXIS_DEFAULTS, SCHEMA_VERSION

__all__ = ["AXIS_DEFAULTS", "SCHEMA_VERSION", "card_name", "emit",
           "start_recording", "time_call", "write_json"]


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_call(fn, *args, warmup: int = 1, iters: int = 3) -> float:
    """Median wall microseconds per call (after warmup), each call waited
    for on the card."""
    for _ in range(warmup):
        fn(*args)
        _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2] * 1e6


def card_name(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them; ``"cpu"`` on the
    host."""
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip()


# Machine-readable result collection: benchmarks call start_recording()
# once, then every emit() with structured **fields is also appended to an
# in-memory record list that write_json() dumps as a BENCH_*.json.

_records: list[dict] | None = None


def start_recording() -> None:
    global _records
    _records = []


def write_json(path: str, *, device: torch.device, **metadata) -> None:
    if _records is None:
        raise RuntimeError("write_json() without start_recording()")
    doc = {
        "metadata": {
            "schema": SCHEMA_VERSION,
            "backend_platform": device.type,
            "device_count": (torch.cuda.device_count()
                             if device.type == "cuda" else 1),
            "device": card_name(device),
            "torch_version": torch.__version__,
            "cuda_version": torch.version.cuda,
            "python_version": platform.python_version(),
            "recorded_at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            **metadata,
        },
        "results": _records,
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    print(f"[bench] wrote {len(_records)} records -> {path}", flush=True)


def emit(name: str, us_per_call: float | None, derived: str,
         **fields) -> None:
    """Print one CSV line; when recording, also append a JSON record.

    ``fields`` carries the structured axes (backend, batch, occupancy,
    devices, ...); ``us_per_call`` additionally derives ``steps_per_s``
    when the metric is a per-timestep latency.
    """
    us = "" if us_per_call is None else f"{us_per_call:.1f}"
    print(f"{name},{us},{derived}", flush=True)
    if _records is not None:
        per_timestep = fields.pop("per_timestep", False)  # directive, not data
        rec = {"name": name, "info": derived, **fields}
        # schema >= 2: every record carries every cross-bench axis
        for axis, default in AXIS_DEFAULTS.items():
            rec.setdefault(axis, default)
        if us_per_call is not None:
            rec["us_per_call"] = round(us_per_call, 3)
            if per_timestep:
                rec["steps_per_s"] = round(1e6 / us_per_call, 3)
        _records.append(rec)
