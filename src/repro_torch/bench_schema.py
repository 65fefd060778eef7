"""The BENCH_*.json schema contract, the port's own copy.

Twin of :mod:`repro.bench_schema` (numpy-free constants, copied so the
port imports nothing of the JAX package). The port's benchmarks stamp
every document with :data:`SCHEMA_VERSION` and fill every record's
cross-bench axes with :data:`AXIS_DEFAULTS`, so their documents load
through the unchanged ``scripts/bench_compare.py``.

SCHEMA_VERSION 2: every record carries ALL of :data:`AXIS_DEFAULTS`
unconditionally; absent axes are filled with their defaults at emit time.
"""

from __future__ import annotations

__all__ = ["AXIS_DEFAULTS", "SCHEMA_VERSION"]

SCHEMA_VERSION = 2

# The cross-bench axes and the value a record has when its bench did not
# set one ("gate": None = not an engine record / gate not applicable;
# "devices": 1 = single device; "fuse_steps": 1 = unfused kernels).
AXIS_DEFAULTS: dict = {
    "backend": None,
    "gate": None,
    "batch": None,
    "devices": 1,
    "fuse_steps": 1,
}
