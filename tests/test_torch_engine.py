"""The port's SpikeEngine against the JAX SpikeEngine, per backend.

Each port backend on the CPU is held against its JAX twin ("reference" ->
"reference", "cuda" -> "pallas", "cuda-f32" -> "pallas-mxu", the Pallas
kernel in interpret mode) on the same numpy weights and spike trains:
``run``, chained ``step`` and masked, ragged ``step_chunk`` chains, byte
equal on int32.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402

THRESH = 1 << 16
N_IN, P = 20, 48


def _weights(seed, n_in=N_IN, p=P, scale=0.5, density=0.3):
    rng = np.random.default_rng(seed)
    w = rng.normal(0.0, scale, (n_in + p, p)) * (rng.random((n_in + p, p))
                                                  < density)
    return np.round(w * 65536).astype(np.int32)


def _ext(seed, T, B, n_in=N_IN, density=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random((T, B, n_in)) < density).astype(np.int32)


def _pair(backend, W, *, decay=("shift", 0.25), reset="zero",
          gate="batch-tile", n_in=N_IN):
    kind, arg = decay
    jd = getattr(jeng.DecaySpec, kind)(arg)
    td = getattr(teng.DecaySpec, kind)(arg)
    je = jeng.SpikeEngine(W, n_in, decay=jd, threshold_raw=THRESH,
                          reset_mode=reset, gate=gate,
                          backend=teng.BACKEND_TABLE[backend][0])
    te = teng.SpikeEngine(W, n_in, decay=td, threshold_raw=THRESH,
                          reset_mode=reset, gate=gate, backend=backend,
                          device="cpu")
    return je, te


def _eq(j, t) -> bool:
    t = t.numpy()
    return t.dtype == np.int32 and np.array_equal(np.asarray(j), t)


@pytest.mark.parametrize("backend", teng.BACKENDS)
@pytest.mark.parametrize("reset", ["zero", "subtract", "hold"])
def test_run_matches_jax_twin(backend, reset):
    W = _weights(1)
    ext = _ext(2, T=10, B=3)
    je, te = _pair(backend, W, reset=reset)
    jo, to = je.run(ext), te.run(ext)
    assert _eq(jo["spikes"], to["spikes"])
    assert _eq(jo["v_final"], to["v_final"])
    assert int(to["spikes"].sum()) > 0


@pytest.mark.parametrize("backend", teng.BACKENDS)
def test_step_chain_equals_jax_run(backend):
    W = _weights(3)
    ext = _ext(4, T=6, B=2)
    je, te = _pair(backend, W, decay=("shift", 0.125))
    want = je.run(ext)
    carry = te.init_carry(2)
    rows = []
    for t in range(ext.shape[0]):
        carry, spikes = te.step(carry, ext[t])
        rows.append(spikes)
    assert _eq(want["spikes"], torch.stack(rows))
    assert _eq(want["v_final"], carry["v"])


@pytest.mark.parametrize("backend", teng.BACKENDS)
@pytest.mark.parametrize("gate", teng.GATES)
def test_masked_ragged_step_chunk_chain(backend, gate):
    """Chunks of ragged length with per-(step, slot) masks: paused slots
    keep their carry bit-for-bit, in both packages."""
    W = _weights(5)
    je, te = _pair(backend, W, gate=gate)
    B = 4
    jc, tc = je.init_carry(B), te.init_carry(B)
    rng = np.random.default_rng(6)
    for i, T in enumerate((3, 5, 1, 4)):
        ext = _ext(10 + i, T, B)
        active = (rng.random((T, B)) < 0.6).astype(np.int32)
        ext = ext * active[:, :, None]  # inactive rows are zero
        jc, js = je.step_chunk(jc, jnp.asarray(ext), jnp.asarray(active))
        tc, ts = te.step_chunk(tc, ext, active)
        assert _eq(js, ts)
        assert _eq(jc["v"], tc["v"]) and _eq(jc["spikes"], tc["spikes"])


@pytest.mark.parametrize("backend", teng.BACKENDS)
@pytest.mark.parametrize("raw", [1 << 16, 47185])
def test_mul_decay_and_leak_free_if(backend, raw):
    W = _weights(7)
    ext = _ext(8, T=8, B=3)
    je, te = _pair(backend, W, decay=("mul", raw), reset="subtract")
    jo, to = je.run(ext), te.run(ext)
    assert _eq(jo["spikes"], to["spikes"])
    assert _eq(jo["v_final"], to["v_final"])


def test_f32_rejection_fires_on_the_same_weights_as_jax():
    n_in = 100  # 148 source rows: one full 128-row block
    kw = dict(threshold_raw=THRESH, reset_mode="zero")
    ok = np.zeros((n_in + P, P), np.int32)
    ok[:128, 0] = (1 << 24) // 128 - 1          # block sum just under 2^24
    bad = ok.copy()
    bad[0, 0] += 128                             # and exactly 2^24
    for W, rejects in ((ok, False), (bad, True)):
        assert (jeng.mxu_partial_sum_bound(W) >= jeng.MXU_EXACT_BOUND) \
            == rejects
        assert teng.mxu_partial_sum_bound(W) == jeng.mxu_partial_sum_bound(W)
        if rejects:
            with pytest.raises(ValueError, match="2\\^24"):
                jeng.SpikeEngine(W, n_in, decay=jeng.DecaySpec.shift(0.25),
                                 backend="pallas-mxu", **kw)
            with pytest.raises(ValueError, match="2\\^24"):
                teng.SpikeEngine(W, n_in, decay=teng.DecaySpec.shift(0.25),
                                 backend="cuda-f32", device="cpu", **kw)
        else:
            jeng.SpikeEngine(W, n_in, decay=jeng.DecaySpec.shift(0.25),
                             backend="pallas-mxu", **kw)
            teng.SpikeEngine(W, n_in, decay=teng.DecaySpec.shift(0.25),
                             backend="cuda-f32", device="cpu", **kw)
    # the exact kernel mode takes any weights
    teng.SpikeEngine(bad, n_in, decay=teng.DecaySpec.shift(0.25),
                     backend="cuda", device="cpu", **kw)


def test_sources_raster_matches_jax():
    ext = _ext(9, T=5, B=2)
    spk = (np.random.default_rng(9).random((5, 2, P)) < 0.2).astype(np.int32)
    assert _eq(jeng.sources_raster(ext, spk),
               teng.sources_raster(torch.from_numpy(ext),
                                   torch.from_numpy(spk)))


def test_unported_paths_raise_and_rehosting_is_identical():
    W = _weights(11)
    _, te = _pair("cuda", W)
    ext = _ext(12, T=7, B=2)
    # the K-step fused window re-hosts the same program: same bytes
    fused = te.with_fuse_steps(4)
    assert fused.fuse_steps == 4 and fused._use_fused
    for k in ("spikes", "v_final"):
        assert torch.equal(fused.run(ext)[k], te.run(ext)[k])
    with pytest.raises(NotImplementedError):
        te.to_mesh(None)
    with pytest.raises(NotImplementedError, match="AER"):
        te.run(object())  # e.g. an AER stream
    # the reference backend has no kernel, so K > 1 is the plain loop
    ref4 = teng.SpikeEngine(W, N_IN, decay=teng.DecaySpec.shift(0.25),
                            threshold_raw=THRESH, reset_mode="zero",
                            fuse_steps=4, device="cpu")
    assert torch.equal(ref4.run(ext)["spikes"], te.run(ext)["spikes"])
    assert te.with_gate("batch-tile") is te
    assert torch.equal(te.with_gate("per-example").run(ext)["spikes"],
                       te.run(ext)["spikes"])
    with pytest.raises(ValueError, match="backend"):
        teng.SpikeEngine(W, N_IN, decay=teng.DecaySpec.shift(0.25),
                         threshold_raw=THRESH, reset_mode="zero",
                         backend="pallas", device="cpu")
