"""CUDA kernel checks that need the card (marker ``cuda``).

Without a CUDA card these skip; on the GPU machine run them with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
``chip_smoke.py`` runs the full sweep; these are the quick per-module
checks: each kernel against its plain version, and the engine's kernel
backends (single-step and K-step fused) against its reference backend.
"""

import pathlib
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.kernels import bitpack, ops  # noqa: E402
from repro_torch.kernels import spike_timestep_fused as tsf  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the GPU")
    if shutil.which("nvcc") is None and not pathlib.Path(
            "/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("no nvcc: the kernel is built at first use")
    return torch.device("cuda")


@pytest.mark.parametrize("block_batch", [1, 8])
@pytest.mark.parametrize("use_f32", [False, True])
@pytest.mark.parametrize("reset", ["zero", "subtract", "hold"])
def test_kernel_equals_plain_on_the_card(card, block_batch, use_f32, reset):
    rng = np.random.default_rng(block_batch + 10 * use_f32)
    B, S, P = 5, 1000, 300
    hi = 1 << 16 if use_f32 else 1 << 31
    src = torch.from_numpy((rng.random((B, S)) < 0.1).astype(np.int32))
    W = torch.from_numpy(rng.integers(-hi, hi, (S, P)).astype(np.int32))
    v = torch.from_numpy(rng.integers(-2**31, 2**31, (B, P)).astype(np.int32))
    kw = dict(decay_rate=0.25, threshold_raw=1 << 16, reset_mode=reset,
              use_f32=use_f32, block_batch=block_batch)
    before = ops.LAUNCHES["spike_timestep"]
    got = ops.spike_timestep(src.to(card), W.to(card), v.to(card), **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["spike_timestep"] == before + 1
    want = ops.spike_timestep(src, W, v, **kw)  # CPU: the plain version
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("backend", ["cuda", "cuda-f32"])
def test_engine_kernel_backends_equal_reference_on_the_card(card, backend):
    rng = np.random.default_rng(3)
    n_in, P = 40, 200
    W = (rng.normal(0, 0.4, (n_in + P, P)) * 65536
         * (rng.random((n_in + P, P)) < 0.3)).astype(np.int32)
    ext = (rng.random((12, 6, n_in)) < 0.3).astype(np.int32)
    kw = dict(decay=teng.DecaySpec.shift(0.125), threshold_raw=1 << 16,
              reset_mode="zero", device=card)
    ref = teng.SpikeEngine(W, n_in, backend="reference", **kw).run(ext)
    got = teng.SpikeEngine(W, n_in, backend=backend, **kw).run(ext)
    assert torch.equal(ref["spikes"], got["spikes"])
    assert torch.equal(ref["v_final"], got["v_final"])


@pytest.mark.parametrize("shape", [(8, 256, 1024), (5, 1000, 300),
                                   (3, 0, 128)])
@pytest.mark.parametrize("K", [1, 3, 8])
@pytest.mark.parametrize("block_batch", [1, 8])
@pytest.mark.parametrize("use_f32", [False, True])
def test_fused_kernel_equals_plain_on_the_card(card, shape, K, block_batch,
                                               use_f32):
    B, n_in, P = shape
    rng = np.random.default_rng(K + 10 * block_batch + 100 * use_f32)
    hi = 1 << 15 if use_f32 else 1 << 31
    W = rng.integers(-hi, hi, (n_in + P, P), dtype=np.int64).astype(np.int32)
    ext = (rng.random((K, B, n_in)) < 0.1).astype(np.int32)
    v = rng.integers(-2**20, 2**20, (B, P)).astype(np.int32)
    spk = (rng.random((B, P)) < 0.2).astype(np.int32)
    active = (rng.random((K, B)) < 0.7).astype(np.int32)
    kw = dict(decay_rate=0.25, threshold_raw=1 << 16, reset_mode="subtract",
              use_f32=use_f32, block_batch=block_batch)
    args = [torch.from_numpy(a) for a in (ext, spk, W, v, active)]
    ext_p, spk_p, w_ext, w_rec, v_p, act_p, _, _ = ops._fused_pad(
        *args, n_inputs=n_in, block_batch=block_batch, block_src=128)
    packed = bitpack.pack_spikes(ext_p)
    activity = ops.window_gate_activity(packed, block_batch=block_batch)
    host = (activity, packed, w_ext, w_rec, v_p, spk_p, act_p)
    before = ops.LAUNCHES["spike_timestep_fused"]
    got = tsf.spike_timestep_fused(*(t.to(card) for t in host), **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["spike_timestep_fused"] == before + 1
    want = tsf.spike_timestep_fused_plain(*host, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("backend", ["cuda", "cuda-f32"])
@pytest.mark.parametrize("gate", list(teng.GATES))
def test_fused_engine_equals_reference_on_the_card(card, backend, gate):
    rng = np.random.default_rng(4)
    n_in, P = 300, 256
    W = (rng.normal(0, 0.4, (n_in + P, P)) * 65536
         * (rng.random((n_in + P, P)) < 0.3)).astype(np.int32)
    ext = (rng.random((13, 6, n_in)) < 0.2).astype(np.int32)
    kw = dict(decay=teng.DecaySpec.shift(0.125), threshold_raw=1 << 16,
              reset_mode="zero", device=card)
    ref = teng.SpikeEngine(W, n_in, backend="reference", **kw).run(ext)
    before = ops.LAUNCHES["spike_timestep_fused"]
    got = teng.SpikeEngine(W, n_in, backend=backend, gate=gate,
                           fuse_steps=4, **kw).run(ext)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["spike_timestep_fused"] == before + 4  # ceil(13/4)
    assert int(ref["spikes"].sum()) > 0
    assert torch.equal(ref["spikes"], got["spikes"])
    assert torch.equal(ref["v_final"], got["v_final"])
