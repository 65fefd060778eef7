"""Integer numerics of the PyTorch port against the JAX package.

Same numpy inputs through both; every comparison is byte equality on
int32 (the repo's contracts are byte-identity contracts).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import fixedpoint as jfxp  # noqa: E402
from repro.core import lif as jlif  # noqa: E402
from repro.kernels import epilogue as jepi  # noqa: E402
from repro_torch.core import fixedpoint as tfxp  # noqa: E402
from repro_torch.core import lif as tlif  # noqa: E402
from repro_torch.kernels import epilogue as tepi  # noqa: E402

I32_MIN, I32_MAX = -2**31, 2**31 - 1


def _potentials(seed: int, n: int = 4096) -> np.ndarray:
    """Random int32 over the whole range, the extremes and small values
    of both signs (negative potentials pin the arithmetic shift)."""
    rng = np.random.default_rng(seed)
    v = rng.integers(I32_MIN, I32_MAX, n, dtype=np.int64, endpoint=True)
    v[:8] = [I32_MIN, I32_MAX, -1, 0, 1, -2**16, 2**16, -(2**16) - 1]
    v[8:64] = rng.integers(-300, 300, 56)
    return v.astype(np.int32)


def _eq(jax_out, torch_out) -> bool:
    a = np.asarray(jax_out)
    b = torch_out.numpy()
    return a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("rate", jfxp.SHIFT_DECAY_RATES)
def test_shift_decay_matches_jax(rate):
    v = _potentials(1)
    assert _eq(jfxp.shift_decay(jnp.asarray(v), rate),
               tfxp.shift_decay(torch.from_numpy(v), rate))


def test_shift_decay_is_arithmetic_on_negatives():
    v = torch.tensor([-1, -7, -8, I32_MIN], dtype=torch.int32)
    # 0.75 -> v >> 2, rounding toward -inf
    assert tfxp.shift_decay(v, 0.75).tolist() == [-1, -2, -2, -(2**29)]
    with pytest.raises(ValueError, match="unsupported"):
        tfxp.shift_decay(v, 0.3)


@pytest.mark.parametrize("b", [0, 1, 2**15, 2**16, 40503])
def test_fx_mul_matches_jax(b):
    a = _potentials(2)
    assert _eq(jfxp.fx_mul(jnp.asarray(a), jnp.int32(b)),
               tfxp.fx_mul(torch.from_numpy(a), b))


def test_fx_mul_identity_at_one_and_rejects_out_of_range():
    a = torch.from_numpy(_potentials(3))
    assert torch.equal(tfxp.fx_mul(a, 1 << 16), a)
    with pytest.raises(ValueError, match="outside"):
        tfxp.fx_mul(a, (1 << 16) + 1)


@pytest.mark.parametrize("reset", jlif.RESET_MODES)
def test_fire_reset_matches_jax(reset):
    v = _potentials(4)
    thr = 1 << 16
    jv, js = jlif.fire_reset(jnp.asarray(v), jnp.int32(thr), reset)
    tv, ts = tlif.fire_reset(torch.from_numpy(v), thr, reset)
    assert _eq(jv, tv) and _eq(js, ts)


@pytest.mark.parametrize("decay", [("shift", 0.125, 0), ("shift", 0.75, 0),
                                   ("mul", 0.0, 0), ("mul", 0.0, 1 << 16),
                                   ("mul", 0.0, 58982)])
@pytest.mark.parametrize("reset", jlif.RESET_MODES)
def test_decay_and_fire_matches_jax(decay, reset):
    kind, rate, raw = decay
    v = _potentials(5)
    acc = _potentials(6)[::-1].copy()  # wraps when added to v
    kw = dict(decay_kind=kind, decay_rate=rate, decay_raw=raw,
              threshold_raw=3 << 15, reset_mode=reset)
    jv, js = jepi.decay_and_fire(jnp.asarray(v), jnp.asarray(acc), **kw)
    tv, ts = tepi.decay_and_fire(torch.from_numpy(v), torch.from_numpy(acc),
                                 **kw)
    assert _eq(jv, tv) and _eq(js, ts)


def test_validate_decay_rejects_like_jax():
    for bad in [("shift", 0.0, 0), ("mul", 0.0, -1), ("mul", 0.0, 2**16 + 1),
                ("exp", 0.25, 0)]:
        with pytest.raises(ValueError):
            jepi.validate_decay(*bad)
        with pytest.raises(ValueError):
            tepi.validate_decay(*bad)


def test_np_to_fixed_and_to_fixed_match_jax():
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.normal(0, 3, 2000), [0.5 / 65536, 1.5 / 65536,
                                                 -2.5 / 65536, 1e9, -1e9]])
    assert np.array_equal(jfxp.np_to_fixed(x), tfxp.np_to_fixed(x))
    xf = x.astype(np.float32)
    assert _eq(jfxp.to_fixed(jnp.asarray(xf)), tfxp.to_fixed(xf))
    assert tfxp.nearest_shift_decay(0.1) == jfxp.nearest_shift_decay(0.1)


def test_lif_step_fixed_matches_jax():
    rng = np.random.default_rng(8)
    v = rng.integers(-2**22, 2**22, (4, 33)).astype(np.int32)
    syn = rng.integers(-2**18, 2**18, (4, 33)).astype(np.int32)
    jp = jlif.LIFParams(decay_rate=0.25, threshold=1.0, reset_mode="subtract")
    tp = tlif.LIFParams(decay_rate=0.25, threshold=1.0, reset_mode="subtract")
    js, jspk = jlif.lif_step_fixed({"v": jnp.asarray(v)}, jnp.asarray(syn), jp)
    ts, tspk = tlif.lif_step_fixed({"v": torch.from_numpy(v)},
                                   torch.from_numpy(syn), tp)
    assert _eq(js["v"], ts["v"]) and _eq(jspk, tspk)
    assert tp.threshold_raw == jp.threshold_raw


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_from_fixed_matches_jax(seed):
    """``from_fixed`` on full-range int32 (past 2^24 the divide rounds)
    and the round trip of ``tests/test_fixedpoint.py``: float32 equal."""
    raw = _potentials(seed)
    assert _eq(jfxp.from_fixed(jnp.asarray(raw)), tfxp.from_fixed(raw))
    x = np.random.default_rng(seed).uniform(-30000, 30000, 512).astype(
        np.float32)
    back = tfxp.from_fixed(tfxp.to_fixed(x))
    assert _eq(jfxp.from_fixed(jfxp.to_fixed(x)), back)
    assert (np.abs(back.numpy() - x) <= 0.5 / 65536 + np.abs(x) * 1e-6).all()


def test_quantize_weights_matches_jax():
    """``tests/test_fixedpoint.py::test_quantize_weights_shapes`` in both
    packages: raw values byte-equal, dequantized values equal."""
    w = np.random.default_rng(0).normal(0, 0.3, (7, 5)).astype(np.float32)
    jraw, jdeq = jfxp.quantize_weights(w)
    traw, tdeq = tfxp.quantize_weights(w)
    assert traw.shape == w.shape and traw.dtype == torch.int32
    assert _eq(jraw, traw) and _eq(jdeq, tdeq)
    np.testing.assert_allclose(tdeq.numpy(), w, atol=1.0 / 65536)
