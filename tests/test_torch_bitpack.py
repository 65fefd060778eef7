"""Bitpacked rasters of the PyTorch port against the JAX package.

Lanes are compared as uint32: the port stores each lane as the int32 with
the same bit pattern. Ragged S and all-ones rows exercise the zero tail
and bit 31.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import bitpack as jbp  # noqa: E402
from repro_torch.kernels import bitpack as tbp  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

SHAPES = [(1, 1), (3, 31), (2, 32), (4, 33), (5, 128), (3, 1000), (2, 4, 70)]


def _raster(shape, density, seed):
    rng = np.random.default_rng(seed)
    x = (rng.random(shape) < density).astype(np.int32)
    x[..., :1] = 1
    return x


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("density", [0.0, 0.1, 1.0])
def test_pack_unpack_count_match_jax(shape, density):
    x = _raster(shape, density, hash((shape, density)) % 2**31)
    jl = np.asarray(jbp.pack_spikes(jnp.asarray(x)))
    tl = tbp.pack_spikes(torch.from_numpy(x))
    assert tl.dtype == torch.int32
    assert np.array_equal(tl.numpy().view(np.uint32), jl)
    assert np.array_equal(tbp.unpack_spikes(tl, shape[-1]).numpy(), x)
    assert np.array_equal(tbp.count_spikes(tl).numpy(),
                          np.asarray(jbp.count_spikes(jnp.asarray(jl))))


def test_all_ones_sets_bit_31():
    x = np.ones((2, 64), np.int32)
    tl = tbp.pack_spikes(torch.from_numpy(x))
    assert tl.numpy().view(np.uint32).tolist() == [[0xFFFFFFFF] * 2] * 2
    assert tbp.count_spikes(tl).tolist() == [64, 64]


@pytest.mark.parametrize("S", [128, 384, 1000])
def test_block_activity_matches_jax(S):
    x = _raster((6, S), 0.03, S)
    x[:, 128:256] = 0  # one silent block
    jl = jbp.pack_spikes(jnp.asarray(x))
    tl = tbp.pack_spikes(torch.from_numpy(x))
    L = tl.shape[-1]
    keep = L - L % 4
    got = tbp.block_activity(tl[:, :keep], 128)
    want = np.asarray(jbp.block_activity(jl[:, :keep], 128))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("block_batch", [1, 8])
def test_gate_activity_matches_jax_formula(block_batch):
    """The wrapper's gate scalars are ops.py's JAX formula over the same
    padded sources."""
    x = _raster((8, 384), 0.02, block_batch)
    x[:, 256:] = 0
    jl = jbp.pack_spikes(jnp.asarray(x))
    want = np.asarray(jbp.block_activity(jl, 128)).reshape(
        8 // block_batch, block_batch, 3).sum(axis=1)
    got = tops.gate_activity(torch.from_numpy(x), block_batch=block_batch)
    assert np.array_equal(got.numpy(), want)
    assert (got[:, 2] == 0).all()


def test_errors():
    with pytest.raises(ValueError, match="lanes"):
        tbp.unpack_spikes(torch.zeros((1, 1), dtype=torch.int32), 40)
    with pytest.raises(ValueError, match="multiple"):
        tbp.block_activity(torch.zeros((1, 4), dtype=torch.int32), 48)
    assert tbp.packed_lanes(0) == 0 and tbp.packed_lanes(33) == 2
