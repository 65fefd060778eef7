"""The port's ``ops.spike_timestep`` against the JAX package's.

On the CPU the port's wrapper pads, builds the gate scalars and runs the
kernel's plain version; the JAX wrapper runs the Pallas kernel in
interpret mode (as tests/test_kernels.py does). Byte equality on int32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import spike_timestep as tts  # noqa: E402

THRESH = 1 << 16
GATE_BATCH = {"batch-tile": 8, "per-example": 1}


def _inputs(B, S, P, *, wrap: bool, seed: int, density=0.15):
    rng = np.random.default_rng(seed)
    src = (rng.random((B, S)) < density).astype(np.int32)
    if wrap:  # full int32 range: row sums wrap mod 2^32
        W = rng.integers(-2**31, 2**31, (S, P), dtype=np.int64)
        v = rng.integers(-2**31, 2**31, (B, P), dtype=np.int64)
    else:  # |w| < 2^14: every 128-row f32 block sum < 2^21
        W = rng.integers(-2**14, 2**14, (S, P))
        v = rng.integers(-2**18, 2**18, (B, P))
    return src, W.astype(np.int32), v.astype(np.int32)


def _both(src, W, v, **kw):
    use_f32 = kw.pop("use_f32", False)
    jv, js = jops.spike_timestep(jnp.asarray(src), jnp.asarray(W),
                                 jnp.asarray(v), use_mxu=use_f32, **kw)
    tv, tsp = tops.spike_timestep(torch.from_numpy(src), torch.from_numpy(W),
                                  torch.from_numpy(v), use_f32=use_f32, **kw)
    return (np.asarray(jv), np.asarray(js)), (tv.numpy(), tsp.numpy())


def _assert_equal(j, t):
    for a, b in zip(j, t):
        assert b.dtype == np.int32
        assert np.array_equal(a, b)


@pytest.mark.parametrize("gate", list(GATE_BATCH))
@pytest.mark.parametrize("use_f32", [False, True])
@pytest.mark.parametrize("decay", [("shift", 0.25, 0), ("mul", 0.0, 47185)])
@pytest.mark.parametrize("reset", ["zero", "subtract", "hold"])
def test_matches_jax_sweep(gate, use_f32, decay, reset):
    kind, rate, raw = decay
    src, W, v = _inputs(5, 300, 200, wrap=not use_f32,
                        seed=hash((gate, use_f32, decay, reset)) % 2**31)
    src[:, 128:256] = 0  # an all-silent block in every tile
    j, t = _both(src, W, v, decay_kind=kind, decay_rate=rate, decay_raw=raw,
                 threshold_raw=THRESH, reset_mode=reset, use_f32=use_f32,
                 block_batch=GATE_BATCH[gate])
    _assert_equal(j, t)


@pytest.mark.parametrize("rate", [0.125, 0.5, 0.75])
def test_every_shift_rate(rate):
    src, W, v = _inputs(3, 200, 130, wrap=True, seed=int(rate * 8))
    j, t = _both(src, W, v, decay_rate=rate, threshold_raw=THRESH,
                 reset_mode="subtract")
    _assert_equal(j, t)


@pytest.mark.parametrize("B,S,P", [(1, 1, 1), (2, 40, 33), (8, 128, 128),
                                   (3, 400, 256)])
def test_ragged_shapes(B, S, P):
    src, W, v = _inputs(B, S, P, wrap=True, seed=B * 1000 + S + P)
    j, t = _both(src, W, v, decay_rate=0.25, threshold_raw=THRESH)
    _assert_equal(j, t)


def test_leak_free_mul_and_dense_activity():
    """decay_raw = 2^16 (IF neurons) with every source spiking."""
    src, W, v = _inputs(4, 256, 128, wrap=True, seed=3, density=1.0)
    j, t = _both(src, W, v, decay_kind="mul", decay_raw=1 << 16,
                 threshold_raw=THRESH, reset_mode="hold")
    _assert_equal(j, t)


def test_plain_version_checks_shapes_and_rejects_cuda_only_options():
    src, W, v = _inputs(8, 128, 128, wrap=False, seed=0)
    act = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="pre-padded"):
        tts.spike_timestep_plain(act, torch.from_numpy(src[:, :100]),
                                 torch.from_numpy(W), torch.from_numpy(v),
                                 threshold_raw=THRESH, reset_mode="zero",
                                 decay_rate=0.25)
    with pytest.raises(ValueError, match="CUDA"):
        tts.spike_timestep_cuda(act, torch.from_numpy(src),
                                torch.from_numpy(W), torch.from_numpy(v),
                                threshold_raw=THRESH, reset_mode="zero",
                                decay_rate=0.25)
    with pytest.raises(ValueError, match="block_src"):
        tops.spike_timestep(torch.from_numpy(src), torch.from_numpy(W),
                            torch.from_numpy(v), threshold_raw=THRESH,
                            decay_rate=0.25, block_src=64)
    before = dict(tops.LAUNCHES)
    tops.spike_timestep(torch.from_numpy(src), torch.from_numpy(W),
                        torch.from_numpy(v), threshold_raw=THRESH,
                        decay_rate=0.25)
    assert tops.LAUNCHES == before  # the plain version is not a launch
