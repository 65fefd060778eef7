"""MNIST-compatible data pipeline, numpy only.

Twin of :mod:`repro.data.mnist` (a copy: the port imports nothing of the
JAX package). The loader first looks for real MNIST IDX files
(``MNIST_DIR``, then the twin's two default directories); when none is
found it falls back to **procedural MNIST**: 28x28 digit glyphs rendered
from per-class stroke skeletons with random affine jitter
(shift/scale/rotate), stroke-width variation and pixel noise, a
deterministic 10-class dataset with MNIST's shape and range. Nothing here
downloads anything.

Everything is generated from ``(seed, index)`` counters: batches are
reproducible, shardable and resumable by step number with no iterator
state to checkpoint, and equal to the twin's byte for byte.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

__all__ = ["load_or_generate", "generate", "batches", "render_digits",
           "GLYPHS"]

# --------------------------------------------------------------------------
# Per-class stroke skeletons in the unit square (x right, y down).
# Polylines; rendered with gaussian falloff around each segment.
# --------------------------------------------------------------------------
GLYPHS: dict[int, list[list[tuple[float, float]]]] = {
    0: [[(0.5, 0.12), (0.76, 0.3), (0.76, 0.7), (0.5, 0.88),
         (0.24, 0.7), (0.24, 0.3), (0.5, 0.12)]],
    1: [[(0.35, 0.3), (0.55, 0.12), (0.55, 0.88)],
        [(0.35, 0.88), (0.72, 0.88)]],
    2: [[(0.26, 0.3), (0.4, 0.14), (0.64, 0.14), (0.74, 0.32),
         (0.62, 0.52), (0.3, 0.74), (0.26, 0.86)],
        [(0.26, 0.86), (0.76, 0.86)]],
    3: [[(0.28, 0.18), (0.6, 0.14), (0.72, 0.3), (0.55, 0.47)],
        [(0.42, 0.47), (0.72, 0.52), (0.72, 0.72), (0.55, 0.88),
         (0.28, 0.82)]],
    4: [[(0.62, 0.88), (0.62, 0.12), (0.26, 0.62), (0.78, 0.62)]],
    5: [[(0.72, 0.14), (0.3, 0.14), (0.28, 0.48), (0.6, 0.44),
         (0.74, 0.6), (0.68, 0.82), (0.3, 0.86)]],
    6: [[(0.66, 0.14), (0.38, 0.36), (0.28, 0.62), (0.4, 0.84),
         (0.64, 0.84), (0.72, 0.64), (0.58, 0.5), (0.32, 0.56)]],
    7: [[(0.26, 0.14), (0.76, 0.14), (0.48, 0.88)],
        [(0.36, 0.5), (0.66, 0.5)]],
    8: [[(0.5, 0.14), (0.7, 0.26), (0.62, 0.46), (0.5, 0.5),
         (0.38, 0.46), (0.3, 0.26), (0.5, 0.14)],
        [(0.5, 0.5), (0.72, 0.62), (0.64, 0.84), (0.5, 0.88),
         (0.36, 0.84), (0.28, 0.62), (0.5, 0.5)]],
    9: [[(0.68, 0.44), (0.42, 0.5), (0.28, 0.36), (0.36, 0.16),
         (0.6, 0.12), (0.72, 0.3), (0.68, 0.44), (0.62, 0.88)]],
}


def _segment_distance(px, py, ax, ay, bx, by):
    """Vectorized point-to-segment distance."""
    abx, aby = bx - ax, by - ay
    apx, apy = px - ax, py - ay
    denom = abx * abx + aby * aby + 1e-12
    t = np.clip((apx * abx + apy * aby) / denom, 0.0, 1.0)
    cx, cy = ax + t * abx, ay + t * aby
    return np.sqrt((px - cx) ** 2 + (py - cy) ** 2)


def render_digits(labels: np.ndarray, seed: int, size: int = 28,
                  jitter: bool = True) -> np.ndarray:
    """Render a batch of digit images. labels: (B,) -> (B, size, size) f32."""
    rng = np.random.default_rng(seed)
    B = len(labels)
    ys, xs = np.mgrid[0:size, 0:size]
    xs = (xs + 0.5) / size
    ys = (ys + 0.5) / size
    out = np.zeros((B, size, size), np.float32)
    if jitter:
        theta = rng.uniform(-0.22, 0.22, B)
        scale = rng.uniform(0.85, 1.12, B)
        dx = rng.uniform(-0.1, 0.1, B)
        dy = rng.uniform(-0.1, 0.1, B)
        width = rng.uniform(0.035, 0.055, B)
    else:
        theta = np.zeros(B); scale = np.ones(B)
        dx = np.zeros(B); dy = np.zeros(B)
        width = np.full(B, 0.045)
    for i, lab in enumerate(np.asarray(labels)):
        c, s = np.cos(theta[i]), np.sin(theta[i])
        # inverse-transform pixel coords into glyph space
        gx = ((xs - 0.5 - dx[i]) * c + (ys - 0.5 - dy[i]) * s) / scale[i] + 0.5
        gy = (-(xs - 0.5 - dx[i]) * s + (ys - 0.5 - dy[i]) * c) / scale[i] + 0.5
        dist = np.full_like(gx, 1e9)
        for stroke in GLYPHS[int(lab)]:
            pts = np.asarray(stroke)
            for (ax, ay), (bx, by) in zip(pts[:-1], pts[1:]):
                dist = np.minimum(
                    dist, _segment_distance(gx, gy, ax, ay, bx, by))
        img = np.exp(-0.5 * (dist / width[i]) ** 2)
        if jitter:
            img = img + rng.normal(0, 0.02, img.shape)
        out[i] = np.clip(img, 0.0, 1.0)
    return out


# --------------------------------------------------------------------------
# Real-MNIST IDX loading (used transparently when files exist)
# --------------------------------------------------------------------------

def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, = struct.unpack(">I", f.read(4))
        ndim = magic & 0xFF
        shape = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        return np.frombuffer(f.read(), np.uint8).reshape(shape)


def _find_mnist_dir() -> str | None:
    for cand in (os.environ.get("MNIST_DIR"), "data/mnist",
                 "/root/data/mnist"):
        if cand and os.path.isdir(cand):
            return cand
    return None


def load_or_generate(split: str, n: int, seed: int = 0
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Return (images (n,784) f32 in [0,1], labels (n,) i32)."""
    d = _find_mnist_dir()
    if d is not None:
        prefix = "train" if split == "train" else "t10k"
        try:
            imgs = _read_idx(_first(d, f"{prefix}-images-idx3-ubyte"))
            labs = _read_idx(_first(d, f"{prefix}-labels-idx1-ubyte"))
            imgs = imgs[:n].reshape(len(imgs[:n]), -1).astype(np.float32) / 255.0
            return imgs, labs[:n].astype(np.int32)
        except (FileNotFoundError, ValueError):
            pass
    return generate(split, n, seed)


def generate(split: str, n: int, seed: int = 0
             ) -> tuple[np.ndarray, np.ndarray]:
    """The procedural split that :func:`load_or_generate` falls back to,
    whatever IDX files exist."""
    base = 0 if split == "train" else 1_000_003
    rng = np.random.default_rng(seed + base)
    labels = rng.integers(0, 10, n).astype(np.int32)
    images = render_digits(labels, seed=seed + base + 7)
    return images.reshape(n, -1), labels


def _first(d: str, stem: str) -> str:
    for suffix in ("", ".gz"):
        p = os.path.join(d, stem + suffix)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(stem)


def batches(split: str, batch_size: int, num_steps: int, *, seed: int = 0,
            start_step: int = 0, shard_index: int = 0, num_shards: int = 1):
    """Stateless batch generator: batch(step) is a pure function.

    Resumability: restart at any ``start_step`` and the stream continues
    exactly; sharding: each host renders only its shard (seed mixes in the
    shard index), no cross-host coordination needed.
    """
    for step in range(start_step, num_steps):
        s = seed * 1_000_000 + step * num_shards + shard_index
        base = 0 if split == "train" else 977
        rng = np.random.default_rng(s + base)
        labels = rng.integers(0, 10, batch_size).astype(np.int32)
        images = render_digits(labels, seed=s + base + 13)
        yield step, images.reshape(batch_size, -1), labels
