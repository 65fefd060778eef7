"""The port's MNIST pipeline (:mod:`repro_torch.data.mnist`) against the
JAX package's (:mod:`repro.data.mnist`): the mnist tests of
``tests/test_data.py`` in the port, and every output byte-equal
(``np.array_equal`` with equal dtypes) to the twin's on the same
arguments: rendered digits, ``load_or_generate``, ``batches`` with resume
and sharding, and the IDX reader on files the test writes itself.
"""

import gzip
import struct

import numpy as np
import pytest

from repro.data import mnist as jmnist
from repro_torch.data import mnist as tmnist


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1])
@pytest.mark.parametrize("jitter", [True, False])
def test_render_digits_equals_jax(seed, jitter):
    labels = np.arange(10).astype(np.int32)
    got = tmnist.render_digits(labels, seed=seed, jitter=jitter)
    assert _same(got, jmnist.render_digits(labels, seed=seed, jitter=jitter))
    assert _same(got, tmnist.render_digits(labels, seed=seed, jitter=jitter))
    assert got.shape == (10, 28, 28) and got.dtype == np.float32
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert not np.allclose(got[0], got[1])  # classes render differently


def test_render_digits_other_sizes_equal_jax():
    labels = np.array([9, 1, 1, 4], np.int32)
    for size in (8, 28, 33):
        assert _same(tmnist.render_digits(labels, seed=5, size=size),
                     jmnist.render_digits(labels, seed=5, size=size))
    assert tmnist.GLYPHS == jmnist.GLYPHS


def test_digit_classes_are_separable():
    """Nearest-centroid on clean glyphs classifies jittered renders well
    (``tests/test_data.py``): the procedural dataset is learnable."""
    protos = tmnist.render_digits(np.arange(10), seed=0,
                                  jitter=False).reshape(10, -1)
    rng = np.random.default_rng(5)
    labels = rng.integers(0, 10, 128).astype(np.int32)
    imgs = tmnist.render_digits(labels, seed=11).reshape(128, -1)
    d = ((imgs[:, None] - protos[None]) ** 2).sum(-1)
    assert (d.argmin(1) == labels).mean() > 0.6  # chance is 0.1


@pytest.mark.parametrize("split", ["train", "test"])
def test_batches_resumable_sharded_and_equal_to_jax(split):
    """Every (step, images, labels) equals the twin's; a resumed stream
    continues exactly; shards draw different data and equal the twin's
    shards."""
    full = list(tmnist.batches(split, 8, 6, seed=1))
    for (s1, x1, y1), (s2, x2, y2) in zip(
            full, jmnist.batches(split, 8, 6, seed=1)):
        assert s1 == s2 and _same(x1, x2) and _same(y1, y2)
    assert [s for s, _, _ in full] == list(range(6))
    resumed = list(tmnist.batches(split, 8, 6, seed=1, start_step=3))
    assert [s for s, _, _ in resumed] == [3, 4, 5]
    for (_, x1, y1), (_, x2, y2) in zip(full[3:], resumed):
        assert _same(x1, x2) and _same(y1, y2)
    shards = []
    for i in range(2):
        (_, xt, yt), = tmnist.batches(split, 8, 1, seed=1, shard_index=i,
                                      num_shards=2)
        (_, xj, yj), = jmnist.batches(split, 8, 1, seed=1, shard_index=i,
                                      num_shards=2)
        assert _same(xt, xj) and _same(yt, yj)
        shards.append(xt)
    assert not np.array_equal(*shards)


def test_load_or_generate_contract_and_equal_to_jax():
    x, y = tmnist.load_or_generate("test", 32, seed=0)
    assert x.shape == (32, 784) and y.shape == (32,)
    assert x.dtype == np.float32 and y.dtype == np.int32
    x2, y2 = tmnist.load_or_generate("test", 32, seed=0)
    assert _same(x, x2) and _same(y, y2)
    xt, _ = tmnist.load_or_generate("train", 32, seed=0)
    assert not np.array_equal(x, xt)  # splits differ
    for split, n, seed in (("test", 32, 0), ("train", 17, 3),
                           ("test", 256, 1)):
        got = tmnist.load_or_generate(split, n, seed=seed)
        want = jmnist.load_or_generate(split, n, seed=seed)
        assert _same(got[0], want[0]) and _same(got[1], want[1])


def _write_idx(path, arr: np.ndarray, compress: bool) -> None:
    head = struct.pack(">I", 0x0800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape)
    data = head + arr.astype(np.uint8).tobytes()
    if compress:
        with gzip.open(str(path) + ".gz", "wb") as f:
            f.write(data)
    else:
        path.write_bytes(data)


@pytest.mark.parametrize("compress", [False, True])
def test_idx_files_load_like_jax(tmp_path, monkeypatch, compress):
    """Real-MNIST IDX files (written here, nothing downloaded) found
    through ``MNIST_DIR``: both packages read the same images and labels;
    a directory without the files falls back to the procedural digits."""
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (12, 28, 28))
    labs = rng.integers(0, 10, 12)
    _write_idx(tmp_path / "t10k-images-idx3-ubyte", imgs, compress)
    _write_idx(tmp_path / "t10k-labels-idx1-ubyte", labs, compress)
    monkeypatch.setenv("MNIST_DIR", str(tmp_path))
    assert tmnist._find_mnist_dir() == jmnist._find_mnist_dir() == str(
        tmp_path)
    for n in (5, 12, 20):
        got = tmnist.load_or_generate("test", n, seed=0)
        want = jmnist.load_or_generate("test", n, seed=0)
        assert _same(got[0], want[0]) and _same(got[1], want[1])
    assert _same(got[1], labs.astype(np.int32))
    # no train files here: the procedural fallback, as in the twin
    got = tmnist.load_or_generate("train", 8, seed=4)
    want = jmnist.load_or_generate("train", 8, seed=4)
    assert _same(got[0], want[0]) and _same(got[1], want[1])


def test_generate_is_the_procedural_split_whatever_idx_files_exist(
        tmp_path, monkeypatch):
    """``generate`` is the procedural fallback of ``load_or_generate``,
    byte-equal to the twin's; IDX files under ``MNIST_DIR`` change what
    ``load_or_generate`` returns and leave ``generate`` as it was."""
    monkeypatch.delenv("MNIST_DIR", raising=False)
    monkeypatch.chdir(tmp_path)
    if jmnist._find_mnist_dir() is None:
        want = jmnist.load_or_generate("test", 12, seed=1)
        got = tmnist.generate("test", 12, seed=1)
        assert _same(got[0], want[0]) and _same(got[1], want[1])
    before = tmnist.generate("test", 12, seed=1)
    labs = (np.arange(12) + 3) % 10
    _write_idx(tmp_path / "t10k-images-idx3-ubyte",
               np.zeros((12, 28, 28)), False)
    _write_idx(tmp_path / "t10k-labels-idx1-ubyte", labs, False)
    monkeypatch.setenv("MNIST_DIR", str(tmp_path))
    assert _same(tmnist.load_or_generate("test", 12, seed=1)[1],
                 labs.astype(np.int32))
    after = tmnist.generate("test", 12, seed=1)
    assert _same(after[0], before[0]) and _same(after[1], before[1])
