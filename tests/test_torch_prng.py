"""The port's threefry (:mod:`repro_torch.core.prng`) and its Poisson
encoder (:func:`repro_torch.core.coding.poisson_encode`) against
``jax.random`` and :func:`repro.core.coding.poisson_encode`, byte for byte:
keys and split keys word for word, uniforms and spikes with float32 viewed
as int32."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import coding as jcoding  # noqa: E402
from repro_torch.core import coding as tcoding  # noqa: E402
from repro_torch.core import prng  # noqa: E402

SEEDS = [0, 1, 42, -1, -2**31, -2**31 - 1, 2**31 - 1, 2**31, 2**32 - 1,
         2**32]


def _jax_words(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def _as_int32(x) -> np.ndarray:
    x = np.asarray(x)
    assert x.dtype == np.float32
    return x.view(np.int32)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_equals_jax(seed):
    got = prng.key(seed)
    assert got.dtype == torch.int64 and got.shape == (2,)
    assert np.array_equal(got.numpy(), _jax_words(jax.random.key(seed)))


@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_split_chained_five_deep_equals_jax(n):
    jk, tk = jax.random.key(42), prng.key(42)
    for depth in range(5):
        jks, tks = jax.random.split(jk, n), prng.split(tk, n)
        assert tks.shape == (n, 2)
        assert np.array_equal(tks.numpy(), _jax_words(jks)), depth
        jk, tk = jks[-1], tks[-1]  # go deeper through the last key


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5, 2), (25, 8, 784)])
@pytest.mark.parametrize("seed", [0, -1, 2**32 - 1])
def test_uniform_equals_jax(shape, seed):
    jk, tk = jax.random.key(seed), prng.key(seed)
    want = jax.random.uniform(jk, shape)
    got = prng.uniform(tk, shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert np.array_equal(got.numpy().view(np.int32), _as_int32(want))
    # a split key draws the JAX package's bits too
    jsub, tsub = jax.random.split(jk)[1], prng.split(tk)[1]
    assert np.array_equal(prng.uniform(tsub, shape).numpy().view(np.int32),
                          _as_int32(jax.random.uniform(jsub, shape)))


def test_uniform_covers_zero_to_just_below_one():
    u = prng.uniform(prng.key(7), (200_000,))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.5) < 0.005
    # all-zero and all-one bits map to the ends of [0, 1)
    bits = torch.tensor([0, 0xFFFFFFFF], dtype=torch.int64)
    ends = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    assert (ends - 1.0).tolist() == [0.0, np.float32(1 - 2**-23)]


def test_as_key_takes_seeds_and_keys():
    assert torch.equal(prng.as_key(5), prng.key(5))
    assert torch.equal(prng.as_key(np.int64(-3)), prng.key(-3))
    k = prng.split(prng.key(1))[0]
    assert prng.as_key(k) is k
    with pytest.raises(ValueError, match=r"\(2,\)"):
        prng.as_key(torch.zeros(3, dtype=torch.int64))


def _edge_intensities():
    x = np.random.default_rng(5).uniform(-0.5, 1.5, (4, 33)).astype(
        np.float32)
    edge = [0.0, 1.0, -0.5, 1.5, np.nan, np.inf, -np.inf, 0.99999994,
            2.0**-32, 1e-10]
    x.reshape(-1)[:len(edge)] = edge
    return x


@pytest.mark.parametrize("seed", [0, 42, -1, 2**31])
@pytest.mark.parametrize("T", [1, 9])
def test_poisson_encode_equals_jax_on_edge_intensities(seed, T):
    x = _edge_intensities()
    want = np.asarray(jcoding.poisson_encode(jax.random.key(seed), x, T,
                                             dtype=jnp.int32))
    got = tcoding.poisson_encode(prng.key(seed), x, T, dtype=torch.int32)
    assert got.dtype == torch.int32 and tuple(got.shape) == (T, 4, 33)
    assert np.array_equal(got.numpy(), want)
    assert int(got[:, 0, 4].sum()) == 0  # NaN never fires
    assert int(got[:, 0, 1].sum()) == T and int(got[:, 0, 3].sum()) == T
    # the default dtype is float32, as in JAX
    wantf = jcoding.poisson_encode(jax.random.key(seed), x, T)
    gotf = tcoding.poisson_encode(prng.key(seed), torch.from_numpy(x), T)
    assert np.array_equal(gotf.numpy().view(np.int32), _as_int32(wantf))


def test_poisson_encode_float64_input_is_rounded_to_float32_first():
    x = np.random.default_rng(6).random((3, 50))  # float64
    x[0, :4] = [np.nextafter(0.5, 1.0), np.nextafter(0.25, 0.0), 1 - 1e-12,
                1e-300]
    k = jax.random.key(3)
    want = np.asarray(jcoding.poisson_encode(k, x, 40, dtype=jnp.int32))
    got = tcoding.poisson_encode(prng.key(3), x, 40, dtype=torch.int32)
    assert np.array_equal(got.numpy(), want)
    # a split key, any leading shape
    k2 = jax.random.split(k, 3)[2]
    x3 = x.reshape(3, 5, 10)
    want = np.asarray(jcoding.poisson_encode(k2, x3, 4, dtype=jnp.int32))
    got = tcoding.poisson_encode(prng.split(prng.key(3), 3)[2], x3, 4,
                                 dtype=torch.int32)
    assert np.array_equal(got.numpy(), want)


def test_poisson_encode_rate_holds_and_keys_differ():
    x = np.full((2, 5000), 0.3, np.float32)
    a = tcoding.poisson_encode(prng.key(11), x, 4)
    assert torch.equal(a, tcoding.poisson_encode(prng.key(11),
                                                 torch.from_numpy(x), 4))
    assert abs(float(a.mean()) - 0.3) < 0.01
    assert not torch.equal(a, tcoding.poisson_encode(prng.key(12), x, 4))
    with pytest.raises(ValueError, match=r"\(2,\)"):
        tcoding.poisson_encode(11, x, 4)  # a key, not a seed, as in JAX


FOLD_DATA = [0, 1, 7, 150, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_equals_jax(seed):
    """``fold_in`` word for word over seeds and data, 0 and 2^32 - 1
    included, and chained as ``snn/train.py`` chains it (split, then a
    fold per step)."""
    jk, tk = jax.random.key(seed), prng.key(seed)
    for data in FOLD_DATA:
        got = prng.fold_in(tk, data)
        assert got.shape == (2,) and got.dtype == torch.int64
        assert np.array_equal(got.numpy(),
                              _jax_words(jax.random.fold_in(jk, data))), data
    _, jkey = jax.random.split(jk)
    _, tkey = prng.split(tk)
    for step in (0, 1, 299):
        assert np.array_equal(prng.fold_in(tkey, step).numpy(),
                              _jax_words(jax.random.fold_in(jkey, step)))


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5, 2), (784, 32)])
@pytest.mark.parametrize("seed", [0, 42, -1, 2**32 - 1])
def test_normal_is_allclose_to_jax(shape, seed):
    """``normal`` against ``jax.random.normal``: float32, the same shape,
    rtol 1e-6 and no atol (2.4e-7 measured). The uniforms under it are
    JAX's bits; ``erf_inv`` is XLA's polynomial, but its ``log1p`` (the
    float64 one, rounded) differs from XLA's float32 one in the last bit
    now and then, so most values, not all, are bit-equal (at least 90 %,
    ~95 % measured)."""
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
    got = prng.normal(prng.key(seed), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    if want.size >= 1000:
        assert (got.numpy() == want).mean() >= 0.9


def test_erfinv_takes_log1p_and_sqrt_in_float64():
    """``_erfinv_f32`` rounds a float64 ``log1p`` and ``sqrt`` to float32,
    so its bits do not depend on a device's float32 ones: equal to the
    same polynomial in numpy float32 on numpy's float64 ``log1p`` and
    IEEE float32 ``sqrt``, the tails (a third of the draws past the
    branch at w = 5) included."""
    f32 = np.float32
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-1, 1, 100_000),
                        rng.uniform(0.9966, 1.0, 50_000)]).astype(f32)
    x[:4] = [np.nextafter(f32(-1), f32(0)), 0.0, 0.99663, -0.9999999]
    w = (-np.log1p(-(x * x).astype(np.float64))).astype(f32)
    lt = w < f32(5)
    w = np.where(lt, w - f32(2.5), np.sqrt(w) - f32(3)).astype(f32)
    p = None
    for a, b in zip(prng._ERFINV_W_LT_5, prng._ERFINV_W_GE_5):
        c = np.where(lt, f32(a), f32(b)).astype(f32)
        p = c if p is None else (c + p * w).astype(f32)
    got = prng._erfinv_f32(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, (p * x).astype(f32))
