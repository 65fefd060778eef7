"""CUDA kernel checks that need the card (marker ``cuda``).

Without a CUDA card these skip; on the GPU machine run them with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
``chip_smoke.py`` runs the full sweep; these are the quick per-module
checks: the kernel against its plain version, and the engine's kernel
backends against its reference backend.
"""

import pathlib
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

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
