"""Synthetic event-camera gestures — a DVS-gesture-style sparse workload.

A dynamic-vision sensor emits an event only where log-intensity CHANGES:
a moving stimulus produces a thin rim of ON events at its leading edge
and OFF events at its trailing edge, and a static scene produces silence.
That is exactly the activity regime the event-gated datapath is built
for, so this module renders one procedurally: a Gaussian blob follows a
per-class trajectory (swipes, circles, diagonals) across a small sensor,
frames are differenced against a change threshold, and the resulting
ON/OFF events become the external spike raster — typically 1–5 % dense.

Twin of :mod:`repro.data.events` (numpy, copied with its imports
rewritten): the same clips for the same ``(seed, split, n)``. Everything
derives from ``(seed, split, index)`` counters — reproducible, shardable,
no iterator state. Channel layout is ``polarity * size^2 + y * size + x``
(ON block first), so ``n_channels = 2 * size * size``.
"""

from __future__ import annotations

import numpy as np

from repro_torch.events.aer import AERStream, dense_to_aer

__all__ = ["GESTURES", "n_channels", "gesture_raster", "gesture_events"]

GESTURES: tuple[str, ...] = (
    "swipe_right", "swipe_left", "swipe_up", "swipe_down",
    "circle_cw", "circle_ccw", "diag_rise", "diag_fall",
)


def n_channels(size: int = 16) -> int:
    """External spike channels a ``size`` x ``size`` sensor produces."""
    return 2 * size * size


def _trajectory(label: int, u: np.ndarray, rng) -> tuple[np.ndarray, np.ndarray]:
    """Blob center (x, y) in [0,1]^2 along the class trajectory at
    progress ``u`` in [0,1], with per-sample jitter."""
    lo, hi = 0.18, 0.82
    phase = rng.uniform(0, 2 * np.pi)
    wobble = rng.uniform(0.0, 0.04)
    off = rng.uniform(-0.06, 0.06, 2)
    path = lo + (hi - lo) * u
    anti = hi - (hi - lo) * u
    mid = 0.5 + wobble * np.sin(2 * np.pi * u + phase)
    name = GESTURES[label]
    if name == "swipe_right":
        x, y = path, mid
    elif name == "swipe_left":
        x, y = anti, mid
    elif name == "swipe_up":
        x, y = mid, anti
    elif name == "swipe_down":
        x, y = mid, path
    elif name in ("circle_cw", "circle_ccw"):
        r = rng.uniform(0.2, 0.3)
        sign = -1.0 if name == "circle_cw" else 1.0
        ang = phase + sign * 2 * np.pi * u
        x, y = 0.5 + r * np.cos(ang), 0.5 + r * np.sin(ang)
    elif name == "diag_rise":
        x, y = path, anti
    else:  # diag_fall
        x, y = path, path
    return np.clip(x + off[0], 0, 1), np.clip(y + off[1], 0, 1)


def gesture_raster(split: str, n: int, *, steps: int = 32, size: int = 16,
                   seed: int = 0, threshold: float = 0.14,
                   noise: float = 5e-4) -> tuple[np.ndarray, np.ndarray]:
    """Render a batch of event-camera gesture clips.

    Returns:
      (events (steps, n, 2*size*size) int32 {0,1}, labels (n,) int32).
      Channel block 0 is ON (intensity rose past ``threshold``), block 1
      is OFF; step 0 differences against a dark sensor, so a clip opens
      with the blob's appearance burst — as a real sensor would.
    """
    base = 0 if split == "train" else 1_000_003
    rng = np.random.default_rng(seed + base)
    labels = rng.integers(0, len(GESTURES), n).astype(np.int32)
    ys, xs = np.mgrid[0:size, 0:size]
    xs = (xs + 0.5) / size
    ys = (ys + 0.5) / size
    u = np.linspace(0.0, 1.0, steps)
    out = np.zeros((steps, n, 2 * size * size), np.int32)
    for i, lab in enumerate(labels):
        srng = np.random.default_rng(seed + base + 7919 * (i + 1))
        cx, cy = _trajectory(int(lab), u, srng)
        sigma = srng.uniform(0.05, 0.08)
        frames = np.exp(
            -((xs[None] - cx[:, None, None]) ** 2
              + (ys[None] - cy[:, None, None]) ** 2) / (2 * sigma ** 2)
        )  # (T, size, size)
        diff = np.diff(frames, axis=0, prepend=np.zeros((1, size, size)))
        on = (diff > threshold).reshape(steps, -1)
        off = (diff < -threshold).reshape(steps, -1)
        ev = np.concatenate([on, off], axis=-1)
        if noise > 0:
            ev |= srng.random(ev.shape) < noise  # sensor background rate
        out[:, i] = ev.astype(np.int32)
    return out, labels


def gesture_events(split: str, n: int, *, steps: int = 32, size: int = 16,
                   seed: int = 0, capacity: int | None = None,
                   **kw) -> tuple[AERStream, np.ndarray]:
    """The same clips as :func:`gesture_raster`, in wire format: one AER
    stream addressing ``(steps, n, 2*size*size)``. ``capacity=None``
    sizes the stream exactly to the event count (no overflow possible);
    an explicit capacity keeps the strict "error" policy."""
    dense, labels = gesture_raster(split, n, steps=steps, size=size,
                                   seed=seed, **kw)
    if capacity is None:
        capacity = int(dense.sum())
    return dense_to_aer(dense, capacity), labels
