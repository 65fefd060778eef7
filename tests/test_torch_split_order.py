"""The premise of the port's split timestep kernels, checked on the CPU.

The CUDA kernels (``csrc/spike_timestep.cu``, ``csrc/spike_timestep_fused.cu``)
spread a timestep's 128-source blocks over many CTAs and a block's rows
over warps, and add the partial sums into the accumulators with wrapping
``atomicAdd`` in whatever order the CTAs finish. That gives the bits of
the sequential product only if (a) wrapping int32 sums do not depend on
their order and (b) in f32 mode, truncating each piece of a split block
gives the truncation of the whole block, which holds while every column
sum of |w| over a block stays under 2^24 (the engine's
``mxu_partial_sum_bound``). Here a "split-order" product in numpy, with
the block partials summed in a seeded random order under int64 masks and,
in f32 mode, each block cut at a random row before the per-piece
truncation, is held byte-equal to the JAX Pallas kernels (interpret mode,
as tests/test_kernels.py runs them) and to the port's plain product. The
launch plans the port's wrappers compute are checked here too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    MXU_EXACT_BOUND,
    mxu_partial_sum_bound,
)
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import spike_timestep as tts  # noqa: E402
from repro_torch.kernels import spike_timestep_fused as tsf  # noqa: E402

BLOCK = 128
GATE_BATCH = {"batch-tile": 8, "per-example": 1}
# v = 0, fx_mul by 2^16 (no leak), hold reset: the step's v_out is its
# synaptic sum, so the kernels' product can be read back bit for bit
IDENTITY_LIF = dict(decay_kind="mul", decay_rate=0.0, decay_raw=1 << 16,
                    threshold_raw=(1 << 31) - 1, reset_mode="hold")
MASK32 = (1 << 32) - 1


def _to_int32(x: np.ndarray) -> np.ndarray:
    x = x & MASK32
    return np.where(x >= 1 << 31, x - (1 << 32), x).astype(np.int32)


def block_partials(src, W, *, use_f32: bool, rng) -> list[np.ndarray]:
    """Per-128-source-block partial sums, int64, as the kernels' CTAs
    produce them; in f32 mode each block is cut at a random row and each
    piece is summed in float32 and truncated toward zero."""
    S = src.shape[1]
    pad = (-S) % BLOCK
    src = np.pad(src, ((0, 0), (0, pad))).astype(np.int64)
    W = np.pad(W, ((0, pad), (0, 0))).astype(np.int64)
    parts = []
    for b in range(src.shape[1] // BLOCK):
        s_b = src[:, b * BLOCK:(b + 1) * BLOCK]
        w_b = W[b * BLOCK:(b + 1) * BLOCK]
        if not use_f32:
            parts.append(s_b @ w_b)
            continue
        cut = int(rng.integers(0, BLOCK + 1))
        part = np.zeros((src.shape[0], W.shape[1]), np.int64)
        for lo, hi in ((0, cut), (cut, BLOCK)):
            f = (s_b[:, lo:hi].astype(np.float32)
                 @ w_b[lo:hi].astype(np.float32))
            part += np.trunc(f).astype(np.int64)
        parts.append(part)
    return parts


def split_order_sum(parts, rng) -> np.ndarray:
    """The partials added in a seeded random order, wrapping mod 2^32."""
    acc = np.zeros_like(parts[0])
    for i in rng.permutation(len(parts)):
        acc = (acc + parts[i]) & MASK32
    return _to_int32(acc)


def _weights(rng, S, P, use_f32):
    if use_f32:  # |w| < 2^16: every 128-row column sum < 2^23 < 2^24
        W = rng.integers(-(1 << 16), 1 << 16, (S, P)).astype(np.int32)
        assert mxu_partial_sum_bound(W) < MXU_EXACT_BOUND
        return W
    return rng.integers(-2**31, 2**31, (S, P), dtype=np.int64).astype(
        np.int32)  # full range: the sums wrap


@pytest.mark.parametrize("gate", list(GATE_BATCH))
@pytest.mark.parametrize("use_f32", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_order_product_equals_jax_single_step(gate, use_f32, seed):
    rng = np.random.default_rng(100 + seed + 10 * use_f32)
    B, S, P = 5, 600, 256  # 5 source blocks, the last ragged
    src = (rng.random((B, S)) < 0.2).astype(np.int32)
    src[:, 128:256] = 0  # a silent block the gate skips
    src[0, :] = 1  # a dense row
    W = _weights(rng, S, P, use_f32)
    want = split_order_sum(block_partials(src, W, use_f32=use_f32, rng=rng),
                           rng)
    v0 = np.zeros((B, P), np.int32)
    j_v, _ = jops.spike_timestep(jnp.asarray(src), jnp.asarray(W),
                                 jnp.asarray(v0), use_mxu=use_f32,
                                 block_batch=GATE_BATCH[gate], **IDENTITY_LIF)
    assert np.array_equal(np.asarray(j_v), want)
    # the port's plain product (one order, whole blocks) agrees
    t_v, _ = tts.spike_timestep_plain(
        *_padded_single(src, W, v0, GATE_BATCH[gate]), use_f32=use_f32,
        block_batch=GATE_BATCH[gate], **IDENTITY_LIF)
    assert np.array_equal(t_v[:B, :P].numpy(), want)


def _padded_single(src, W, v, bb):
    """The operands ``ops.spike_timestep`` hands the kernel."""
    sp = tops._pad_to(tops._pad_to(torch.from_numpy(src), 0, bb), 1,
                      BLOCK).contiguous()
    wp = tops._pad_to(tops._pad_to(torch.from_numpy(W), 0, BLOCK), 1, 128)
    vp = tops._pad_to(tops._pad_to(torch.from_numpy(v), 0, bb), 1, 128)
    return (tops.gate_activity(sp, block_batch=bb), sp, wp.contiguous(),
            vp.contiguous())


@pytest.mark.parametrize("gate", list(GATE_BATCH))
@pytest.mark.parametrize("use_f32", [False, True])
@pytest.mark.parametrize("K", [1, 3])
def test_split_order_window_equals_jax_fused(gate, use_f32, K):
    """The fused window's external leg: the (step, block) partials of a
    K-step window, in any order, with W_rec = 0 and the identity LIF so
    the window's v_out is the sum over its steps."""
    rng = np.random.default_rng(200 + K + 10 * use_f32)
    B, n_in, P = 5, 400, 256
    ext = (rng.random((K, B, n_in)) < 0.15).astype(np.int32)
    W_ext = _weights(rng, n_in, P, use_f32)
    W = np.concatenate([W_ext, np.zeros((P, P), np.int32)])
    parts = [p for k in range(K)
             for p in block_partials(ext[k], W_ext, use_f32=use_f32, rng=rng)]
    want = split_order_sum(parts, rng)
    zeros = np.zeros((B, P), np.int32)
    active = np.ones((K, B), np.int32)
    j_v, _, _ = jops.spike_timestep_fused(
        jnp.asarray(ext), jnp.asarray(zeros), jnp.asarray(W),
        jnp.asarray(zeros), jnp.asarray(active), n_inputs=n_in,
        use_mxu=use_f32, block_batch=GATE_BATCH[gate], **IDENTITY_LIF)
    assert np.array_equal(np.asarray(j_v), want)


# --------------------------------------------------------------------------
# launch plans
# --------------------------------------------------------------------------

@pytest.mark.parametrize("gate,grid", [("batch-tile", (8, 21, 1)),
                                       ("per-example", (8, 21, 8))])
def test_single_step_plan_at_the_slice_shape(gate, grid):
    plan = tts.launch_plan(8, 2688, 1024, GATE_BATCH[gate])
    assert plan["product_grid"] == grid
    assert plan["product_ctas"] == grid[0] * grid[1] * grid[2]
    assert plan["epilogue_ctas"] == 8 * 1024 // 256
    assert plan["scratch"] == (8, 1024)


@pytest.mark.parametrize("shape", [(8, 2688, 1000, 8), (8, 100, 1024, 8),
                                   (5, 128, 128, 8), (0, 128, 128, 1),
                                   (65536, 128, 128, 1),
                                   (16384, 128, 131072, 1)])
def test_single_step_plan_refuses(shape):
    with pytest.raises(ValueError):
        tts.launch_plan(*shape)


@pytest.mark.parametrize("gate", list(GATE_BATCH))
def test_fused_plan_at_the_slice_shape(gate):
    bb = GATE_BATCH[gate]
    plan = tsf.launch_plan(8, 8, 1664, 1024, bb)
    assert plan["ext_grid"] == (8, 13, 8 // bb)
    assert plan["ext_ctas"] == 8 * 13 * (8 // bb)
    assert plan["rec_grid"] == (8, 8 // bb) and plan["cluster"] == 8
    assert plan["ext_smem"] == 4 * (128 * 128 + 4 * (8 * bb + 1) + 8 * 128)
    assert plan["rec_smem"] == 4 * (bb * 128 + 2 * bb * 32 + 8192 + 16)
    assert max(plan["ext_smem"], plan["rec_smem"]) <= tsf.MAX_SMEM


@pytest.mark.parametrize("P,cluster,tiles", [(128, 1, 1), (256, 2, 2),
                                              (4096, 8, 32)])
def test_fused_plan_cluster_covers_the_neuron_tiles(P, cluster, tiles):
    plan = tsf.launch_plan(16, 13 * 8, 4096, P, 8)
    assert plan["cluster"] == cluster
    assert plan["ext_grid"] == (tiles, 32, 13)
    assert plan["rec_ctas"] == cluster * 13


@pytest.mark.parametrize("shape", [(2000, 8, 128, 128, 8),  # ext smem
                                   (1, 8, 128, 32896, 8),   # rec smem
                                   (1, 8, 100, 128, 8), (1, 8, 128, 130, 8),
                                   (1, 12, 128, 128, 8), (0, 8, 128, 128, 8),
                                   (1, 1, 128, 1 << 24, 1),
                                   (1, 8, 128 * 65536, 128, 8)])
def test_fused_plan_refuses(shape):
    with pytest.raises(ValueError):
        tsf.launch_plan(*shape)


def test_fused_plan_takes_the_largest_fitting_shapes():
    assert tsf.launch_plan(1000, 8, 128, 128, 8)["ext_smem"] <= tsf.MAX_SMEM
    assert tsf.launch_plan(1, 8, 128, 32768, 8)["rec_smem"] <= tsf.MAX_SMEM
