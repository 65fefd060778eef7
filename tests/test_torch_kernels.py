"""The port's ``lif_step`` / ``poisson_encode`` wrappers and its ``ref``
oracles against the JAX package's.

Twin of tests/test_kernels.py for the two elementwise kernels. On the CPU
the port's wrappers run their plain versions (the oracles of
``repro_torch.kernels.ref``); the JAX wrappers run the Pallas kernels in
interpret mode, as tests/test_kernels.py does. Every comparison is exact
equality on the same numpy inputs.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import fixedpoint as fxp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

THRESH = 1 << 16  # 1.0 in Q16.16
SHAPES_2D = [(1, 1), (3, 5), (8, 128), (7, 130), (16, 256), (33, 513)]
RESETS = ["zero", "subtract", "hold"]
# the cross-product of tests/test_kernels.py, trimmed as there: every rate
# and reset on two representative shapes, rate 0.25 / zero on the others
LIF_CASES = [(shape, rate, reset)
             for shape in SHAPES_2D
             for rate in fxp.SHIFT_DECAY_RATES for reset in RESETS
             if shape in ((8, 128), (7, 130))
             or (rate == 0.25 and reset == "zero")]
ENCODE_SHAPES = [(1, 1, 1), (4, 30, 16), (8, 128, 25), (9, 784, 5)]
SEEDS = [0, 42, -1, 2**31 - 1, -2**31]
EDGE = [0.0, 1.0, -0.5, 1.5, 0.99999994, 1e-10, 2.0**-32, np.inf, -np.inf]


def _lif_all(v, syn, **kw):
    """(JAX ops, JAX ref, port ops, port ref), each (v_out, spikes) numpy."""
    jv, js = jnp.asarray(v), jnp.asarray(syn)
    tv, ts = torch.from_numpy(v), torch.from_numpy(syn)
    outs = [jops.lif_step(jv, js, **kw), jref.lif_step_ref(jv, js, **kw),
            tops.lif_step(tv, ts, **kw), tref.lif_step_ref(tv, ts, **kw)]
    return [tuple(np.asarray(x) for x in out) for out in outs]


def _assert_all_equal(outs):
    want = outs[0]
    for got in outs[1:]:
        for g, w in zip(got, want):
            assert g.dtype == np.int32
            assert np.array_equal(g, w)


# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape,rate,reset", LIF_CASES)
def test_lif_step_sweep(shape, rate, reset):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    v = rng.integers(-2**22, 2**22, shape).astype(np.int32)
    syn = rng.integers(-2**18, 2**18, shape).astype(np.int32)
    _assert_all_equal(_lif_all(v, syn, decay_rate=rate,
                               threshold_raw=THRESH, reset_mode=reset))


@pytest.mark.parametrize("rate", fxp.SHIFT_DECAY_RATES)
@pytest.mark.parametrize("reset", RESETS)
def test_lif_step_full_range_wraps(rate, reset):
    """Full-range int32 v and syn: the integrate add and the subtract
    reset wrap mod 2^32 identically; 0.75 is ``v >> 2``."""
    rng = np.random.default_rng(int(rate * 8) + 10 * RESETS.index(reset))
    v, syn = (rng.integers(-2**31, 2**31, (7, 130)).astype(np.int32)
              for _ in range(2))
    v[0, :4] = [-2**31, 2**31 - 1, -1, 0]
    syn[0, :4] = [-1, 1, -2**31, 2**31 - 1]
    outs = _lif_all(v, syn, decay_rate=rate, threshold_raw=-(1 << 20),
                    reset_mode=reset)
    _assert_all_equal(outs)
    v_out = outs[2][0].astype(np.int64)
    decayed = v.astype(np.int64) >> 2 if rate == 0.75 else (
        v.astype(np.int64) - (v.astype(np.int64) >> int(np.log2(1 / rate))))
    wrapped = (decayed + syn + 2**31) % 2**32 - 2**31
    assert np.array_equal(v_out[outs[2][1] == 0], wrapped[outs[2][1] == 0])


def test_lif_step_ref_takes_any_rank():
    rng = np.random.default_rng(5)
    v = rng.integers(-2**22, 2**22, (2, 3, 5)).astype(np.int32)
    syn = rng.integers(-2**18, 2**18, (2, 3, 5)).astype(np.int32)
    kw = dict(decay_rate=0.5, threshold_raw=THRESH, reset_mode="subtract")
    want = jref.lif_step_ref(jnp.asarray(v), jnp.asarray(syn), **kw)
    got = tref.lif_step_ref(torch.from_numpy(v), torch.from_numpy(syn), **kw)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_lif_step_rejects_what_the_kernel_does_not_take():
    v = torch.zeros((2, 3), dtype=torch.int32)
    kw = dict(threshold_raw=THRESH)
    with pytest.raises(ValueError, match="decay_rate"):
        tops.lif_step(v, v, decay_rate=0.3, **kw)
    with pytest.raises(ValueError, match="reset mode"):
        tops.lif_step(v, v, decay_rate=0.25, reset_mode="bogus", **kw)
    with pytest.raises(ValueError, match="int32"):
        tops.lif_step(v, v.to(torch.int64), decay_rate=0.25, **kw)
    with pytest.raises(ValueError, match="differ"):
        tops.lif_step(v, v[:1], decay_rate=0.25, **kw)
    with pytest.raises(ValueError, match=r"\(B, N\)"):
        tops.lif_step(v[0], v[0], decay_rate=0.25, **kw)


# --------------------------------------------------------------------------
def _intensities(B, D, seed):
    """Uniform on [-0.25, 1.25] float32 with the edge values first."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.25, 1.25, (B, D)).astype(np.float32)
    x.reshape(-1)[:len(EDGE)] = EDGE[:x.size]
    return x


@pytest.mark.parametrize("B,D,T", ENCODE_SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_poisson_encode_sweep(B, D, T, seed):
    x = _intensities(B, D, B + D + T)
    want = np.asarray(jops.poisson_encode(seed, jnp.asarray(x), T))
    got = tops.poisson_encode(seed, torch.from_numpy(x), T)
    assert got.dtype == torch.int32 and got.shape == (T, B, D)
    assert np.array_equal(got.numpy(), want)
    plain = tref.poisson_encode_ref(seed, torch.from_numpy(x), T).numpy()
    assert np.array_equal(plain, want)
    if seed >= 0:  # the JAX oracle's jnp.uint32(seed) refuses a negative
        assert np.array_equal(
            np.asarray(jref.poisson_encode_ref(seed, x, T)), want)


def test_poisson_encode_casts_float64_to_float32_first():
    """float64 numpy intensities are rounded to float32 before the clip
    and the threshold, as the JAX wrapper's ``astype(float32)`` does."""
    rng = np.random.default_rng(21)
    x = rng.random((5, 200))
    x[0, :4] = [0.99999999, 1.0 - 2.0**-25, 2.0**-33, 0.5 + 2.0**-30]
    want = np.asarray(jops.poisson_encode(7, x, 9))
    assert np.array_equal(tops.poisson_encode(7, x, 9).numpy(), want)
    assert want[:, 0, 0].all()  # 0.99999999 rounds to 1.0 in float32


def test_poisson_encode_nan_never_fires():
    """NaN is pinned to the JAX result: the clip and the minimum carry it
    into ``astype(uint32)``, which gives 0, so the spike never fires."""
    x = np.full((3, 40), np.nan, np.float32)
    x[:, 20:] = 0.9
    want = np.asarray(jops.poisson_encode(3, x, 50))
    assert np.array_equal(np.asarray(jref.poisson_encode_ref(3, x, 50)), want)
    assert not want[:, :, :20].any() and want[:, :, 20:].any()
    got = tops.poisson_encode(3, torch.from_numpy(x), 50).numpy()
    assert np.array_equal(got, want)


def test_hash_u32_ref_edge_counters():
    edges = [0, 1, 2**31, 2**32 - 1]
    for seed in edges:
        for t, b, d in itertools.product(edges, repeat=3):
            want = int(jref.hash_u32_ref(seed, t, b, d))
            assert int(tref.hash_u32_ref(seed, t, b, d)) == want
    # broadcast tensors, as the encoder calls it
    t = np.arange(3, dtype=np.uint32)[:, None, None]
    b = np.array([0, 2**31, 2**32 - 1], np.uint32)[None, :, None]
    d = np.arange(70000, 70100, dtype=np.uint32)[None, None, :]
    want = np.asarray(jref.hash_u32_ref(12345, jnp.asarray(t),
                                        jnp.asarray(b), jnp.asarray(d)))
    got = tref.hash_u32_ref(12345, torch.from_numpy(t.astype(np.int64)),
                            torch.from_numpy(b.astype(np.int64)),
                            torch.from_numpy(d.astype(np.int64)))
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_poisson_encode_extremes_and_rate():
    B, D, T = 16, 64, 200
    x = torch.cat([torch.zeros((B, D // 2)), torch.ones((B, D // 2))], -1)
    s = tops.poisson_encode(0, x, T)
    assert float(s[:, :, : D // 2].sum()) == 0.0       # p=0 never fires
    assert float(s[:, :, D // 2:].float().mean()) == 1.0  # p=1 always fires
    xm = torch.full((B, D), 0.3)
    sm = tops.poisson_encode(3, xm, T)
    assert abs(float(sm.float().mean()) - 0.3) < 0.01
    assert np.array_equal(sm.numpy(),
                          np.asarray(jops.poisson_encode(3, xm.numpy(), T)))


def test_poisson_encode_seed_sensitivity():
    x = torch.full((4, 32), 0.5)
    a = tops.poisson_encode(1, x, 20)
    b = tops.poisson_encode(2, x, 20)
    assert not torch.equal(a, b)
    assert torch.equal(a, tops.poisson_encode(1, x, 20))


def test_poisson_encode_rejects_a_seed_outside_int32():
    x = torch.full((2, 3), 0.5)
    with pytest.raises(OverflowError):  # jnp.asarray([seed], jnp.int32)
        jops.poisson_encode(2**31, x.numpy(), 4)
    with pytest.raises(ValueError, match="int32"):
        tops.poisson_encode(2**31, x, 4)
    with pytest.raises(ValueError, match=r"\(B, D\)"):
        tops.poisson_encode(0, x[0], 4)


# --------------------------------------------------------------------------
# the encoder kernel's launch plan and index walk, emulated in numpy: a
# thread owns 4 consecutive plane positions from one division and steps to
# the next (b, d); block row y takes t_per_block timesteps
# --------------------------------------------------------------------------

def _mix_u32(h):
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    return h ^ (h >> np.uint32(16))


def _emulate_encoder(seed, x, T, plan):
    """The raster the kernel writes under ``plan``, following its loops,
    and how many times each (t, position) was written."""
    B, D = x.shape
    BD = B * D
    (gx, gy), tpb = plan["grid"], plan["t_per_block"]
    assert plan["threads"] == 256
    out = np.full((T, BD), -1, np.int64)
    writes = np.zeros((T, BD), np.int64)
    j0 = np.arange(gx * 256, dtype=np.int64) * 4
    j0 = j0[j0 < BD]                           # threads with work
    b, d = j0 // D, j0 % D                     # the one division
    flat = x.reshape(-1)
    for k in range(4):
        j = j0 + k
        ok = j < BD
        with np.errstate(invalid="ignore", over="ignore"):
            c = np.clip(flat[j[ok]], np.float32(0), np.float32(1))
            scaled = np.minimum(c * np.float32(2.0**32),
                                np.float32(4294967040.0))
            thr = np.where(np.isnan(c), 0, scaled).astype(np.uint32)
        always = c >= 1
        bd_hash = ((b[ok] * 0x85EBCA77) ^ (d[ok] * 0xC2B2AE3D)).astype(
            np.uint64) & 0xFFFFFFFF
        for y in range(gy):
            for t in range(y * tpb, min(T, (y + 1) * tpb)):
                st = (seed & 0xFFFFFFFF) ^ ((t * 0x9E3779B1) & 0xFFFFFFFF)
                h = _mix_u32((np.uint64(st) ^ bd_hash).astype(np.uint32))
                out[t, j[ok]] = ((h < thr) | always).astype(np.int64)
                writes[t, j[ok]] += 1
        d = d + 1                              # step to the next position
        wrap = d == D
        d[wrap], b[wrap] = 0, b[wrap] + 1
    return out.reshape(T, B, D), writes


@pytest.mark.parametrize("B,D,T,n_sm", [
    (1, 1, 1, 132), (3, 30, 7, 132), (4, 3, 9, 132), (1, 5, 2, 132),
    (2, 2, 100, 132), (8, 784, 25, 132), (8, 784, 25, 1), (5, 7, 11, 1),
    (3, 30, 100, 2)])
def test_encoder_plan_writes_each_position_once_and_equals_plain(B, D, T,
                                                                 n_sm):
    from repro_torch.kernels import poisson_encode as enc

    x = _intensities(B, D, B * D + T)
    x.reshape(-1)[-1] = np.nan
    plan = enc.launch_plan(T, B, D, n_sm)
    assert plan["vector"] == (B * D % 4 == 0)
    for seed in (0, -1, 2**31 - 1):
        got, writes = _emulate_encoder(seed, x, T, plan)
        assert (writes == 1).all()
        want = tref.poisson_encode_ref(seed, torch.from_numpy(x), T)
        assert np.array_equal(got, want.numpy())


def test_encoder_plan_fills_the_card_at_the_large_shape():
    from repro_torch.kernels import poisson_encode as enc

    T, B, D = 100, 256, 784
    plan = enc.launch_plan(T, B, D, 132)
    (gx, gy), tpb = plan["grid"], plan["t_per_block"]
    assert gx * 256 * 4 == B * D and gy * tpb >= T > (gy - 1) * tpb
    assert plan["vector"]
    wave = 132 * 2048  # resident threads of the H100's 132 SMs
    assert tpb > 1 and gx * gy * 256 >= 1.5 * wave  # ~2 waves, t split
    # with the plane alone a fraction of a wave, t takes the rest; a plane
    # that fills the card keeps every timestep in one block row
    assert enc.launch_plan(T, 1024, 4096, 132)["grid"][1] == 1
    # at the bench's shape a block row is one timestep
    assert enc.launch_plan(25, 8, 784, 132)["t_per_block"] == 1
    with pytest.raises(ValueError, match="2\\^31"):
        enc.launch_plan(2, 1 << 16, 1 << 15, 132)
    with pytest.raises(ValueError, match="nothing"):
        enc.launch_plan(0, 4, 4, 132)


# --------------------------------------------------------------------------
@pytest.mark.parametrize("B,S,P", [(1, 1, 1), (2, 40, 33), (5, 160, 300),
                                   (8, 128, 128), (3, 1056, 64)])
def test_spike_timestep_ref_matches_jax(B, S, P):
    rng = np.random.default_rng(B * 1000 + S + P)
    src = (rng.random((B, S)) < 0.15).astype(np.int32)
    W = rng.integers(-2**31, 2**31, (S, P)).astype(np.int32)  # sums wrap
    v = rng.integers(-2**18, 2**18, (B, P)).astype(np.int32)
    kw = dict(decay_rate=0.25, threshold_raw=THRESH, reset_mode="zero")
    want = jref.spike_timestep_ref(src, W, v, **kw)
    got = tref.spike_timestep_ref(torch.from_numpy(src), torch.from_numpy(W),
                                  torch.from_numpy(v), **kw)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))
    # and the port's gated step agrees with its oracle
    step = tops.spike_timestep(torch.from_numpy(src), torch.from_numpy(W),
                               torch.from_numpy(v), **kw)
    for g, w in zip(step, got[:2]):
        assert torch.equal(g, w)


def test_cpu_runs_leave_launches_at_zero():
    before = dict(tops.LAUNCHES)
    assert {"lif_step", "poisson_encode"} <= set(before)
    v = torch.ones((4, 9), dtype=torch.int32)
    tops.lif_step(v, v, decay_rate=0.125, threshold_raw=THRESH)
    tops.poisson_encode(5, torch.full((4, 9), 0.5), 3)
    assert tops.LAUNCHES == before  # the plain versions are not launches


@pytest.mark.parametrize("source", ["spike_timestep.cu",
                                    "spike_timestep_fused.cu"])
def test_first_build_under_threads_compiles_once(source, tmp_path,
                                                 monkeypatch):
    """Eight threads that launch a kernel first (the frontend's pump
    thread beside the main one) compile it once, into a temporary file
    named by process and thread, and all bind the same entry point."""
    import ctypes
    import pathlib
    import subprocess
    import threading
    import time

    from repro_torch.kernels import _build

    compiles, tmp_names = [], []

    def fake_run(cmd, **kwargs):
        out = cmd[cmd.index("-o") + 1]
        tmp_names.append(out)
        compiles.append(threading.get_ident())
        time.sleep(0.05)                 # a slow nvcc widens the race
        pathlib.Path(out).write_bytes(b"\x7fELF")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    class FakeLib:
        def __getattr__(self, name):
            return type("Fn", (), {})()

    monkeypatch.setattr(_build, "_build_dir", lambda: tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda src: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    monkeypatch.setattr(ctypes, "CDLL", lambda path: FakeLib())
    lib = _build.CudaLibrary(_build.CSRC / source, "entry", [])
    barrier = threading.Barrier(8)
    got = []

    def first_launch():
        barrier.wait()
        got.append(lib.function)

    threads = [threading.Thread(target=first_launch) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(compiles) == 1
    assert len(got) == 8 and all(fn is got[0] for fn in got)
    assert f".{compiles[0]}.tmp" in tmp_names[0]
    assert not list(tmp_path.glob("*.tmp"))
    assert lib.build()[1] == ""          # the cached build is reused
