"""The port's K-step fused window against the JAX package's.

Mirrors tests/test_fused_steps.py across the two packages: the same numpy
weights and spike trains go through the JAX engine on ``pallas`` /
``pallas-mxu`` with ``fuse_steps=K`` (the fused Pallas kernel in
interpret mode) and through the port's ``cuda`` / ``cuda-f32`` engine on
``device="cpu"`` (the fused kernel's plain version, same padding and gate
scalars). Rasters, ``v_final`` and carries must be byte equal (tolerance
0). The traffic accounting is held equal too: the port's gate scalars and
``events.trace`` counts against the JAX ones, and the count identity
``(ext_gate_activity > 0).sum() == block_traffic(...)[0]``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jeng  # noqa: E402
from repro.core.cerebra_h import CerebraHConfig as JConfig  # noqa: E402
from repro.core.lif import LIFParams as JLIF  # noqa: E402
from repro.core.mapping import ClusterGeometry as JGeom  # noqa: E402
from repro.core.network import feedforward as jfeedforward  # noqa: E402
from repro.core.session import AcceleratorSession as JSession  # noqa: E402
from repro.events import trace as jtrace  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import cerebra_h as tch  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.session import AcceleratorSession as TSession  # noqa: E402
from repro_torch.events import trace as ttrace  # noqa: E402
from repro_torch.kernels import bitpack  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import spike_timestep as tts  # noqa: E402
from repro_torch.kernels import spike_timestep_fused as tsf  # noqa: E402

THRESH = 1 << 16
KERNEL_BACKENDS = ("cuda", "cuda-f32")
GATE_BATCH = {"batch-tile": 8, "per-example": 1}
DECAYS = {"shift-0.125": ("shift", 0.125), "shift-0.75": ("shift", 0.75),
          "mul": ("mul", 47185)}


def _weights(seed, n_in, P, *, wmax=1 << 15, density=0.3):
    """Sparse random image; |w| < 2^15 keeps every f32 block sum < 2^22."""
    rng = np.random.default_rng(seed)
    S = n_in + P
    return ((rng.random((S, P)) < density)
            * rng.integers(-wmax, wmax, (S, P))).astype(np.int32)


def _raster(seed, T, B, S, density=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random((T, B, S)) < density).astype(np.int32)


def _pair(W, n_in, backend, *, gate="batch-tile", reset="zero",
          decay=("shift", 0.25), K=1, thresh=THRESH):
    kind, arg = decay
    kw = dict(threshold_raw=thresh, reset_mode=reset, gate=gate,
              fuse_steps=K)
    je = jeng.SpikeEngine(W, n_in, decay=getattr(jeng.DecaySpec, kind)(arg),
                          backend=teng.BACKEND_TABLE[backend][0], **kw)
    te = teng.SpikeEngine(W, n_in, decay=getattr(teng.DecaySpec, kind)(arg),
                          backend=backend, device="cpu", **kw)
    return je, te


def _eq(j, t) -> bool:
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return t.dtype == np.int32 and np.array_equal(np.asarray(j), t)


def _assert_run_equal(jo, to):
    assert _eq(jo["spikes"], to["spikes"])
    assert _eq(jo["v_final"], to["v_final"])


# --------------------------------------------------------------------------
# engine run: fused port == fused JAX == unfused, over K x ragged T
# --------------------------------------------------------------------------

@pytest.mark.parametrize("backend", KERNEL_BACKENDS)
@pytest.mark.parametrize("gate", list(GATE_BATCH))
@pytest.mark.parametrize("K", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("T", [7, 13])
def test_fused_run_matches_jax(backend, gate, K, T):
    n_in, P = 37, 48
    W = _weights(1, n_in, P)
    ext = _raster(2 + T, T, 3, n_in)
    je, te = _pair(W, n_in, backend, gate=gate, K=K)
    launches = dict(tops.LAUNCHES)
    jo, to = je.run(ext), te.run(ext)
    _assert_run_equal(jo, to)
    assert int(to["spikes"].sum()) > 0
    # and the unfused port engine gives the same bytes
    unfused = te.with_fuse_steps(1).run(ext)
    assert torch.equal(unfused["spikes"], to["spikes"])
    # on CPU tensors the wrappers run the plain versions: no launch
    assert tops.LAUNCHES == launches


@pytest.mark.parametrize("backend", KERNEL_BACKENDS)
@pytest.mark.parametrize("reset", ["zero", "subtract", "hold"])
@pytest.mark.parametrize("decay", list(DECAYS))
def test_fused_resets_and_decays_match_jax(backend, reset, decay):
    n_in, P = 30, 40
    W = _weights(3, n_in, P)
    ext = _raster(4, 7, 4, n_in)
    je, te = _pair(W, n_in, backend, reset=reset, decay=DECAYS[decay], K=3,
                   gate="per-example")
    _assert_run_equal(je.run(ext), te.run(ext))


@pytest.mark.parametrize("gate", list(GATE_BATCH))
@pytest.mark.parametrize("K", [2, 4])
def test_fused_full_range_weights_wrap_in_exact_mode(gate, K):
    """Full-range int32 weights: accumulates wrap mod 2^32 in both
    packages' exact mode, and the fused port still equals JAX."""
    rng = np.random.default_rng(5)
    n_in, P = 140, 130  # two external blocks, a ragged physical axis
    W = rng.integers(-2**31, 2**31, (n_in + P, P), dtype=np.int64)
    W = (W * (rng.random(W.shape) < 0.5)).astype(np.int32)
    ext = _raster(6, 9, 5, n_in, density=0.4)
    je, te = _pair(W, n_in, "cuda", gate=gate, K=K)
    jo, to = je.run(ext), te.run(ext)
    _assert_run_equal(jo, to)
    assert 0 < int(to["spikes"].sum()) < to["spikes"].numel()


@pytest.mark.parametrize("backend", KERNEL_BACKENDS)
def test_fused_without_external_inputs(backend):
    """n_inputs = 0: one silent external block; recurrent activity from a
    carried-in state still drives the window."""
    P = 48
    W = _weights(7, 0, P, density=0.5)
    rng = np.random.default_rng(8)
    v0 = rng.integers(0, 2 * THRESH, (3, P)).astype(np.int32)
    s0 = (rng.random((3, P)) < 0.5).astype(np.int32)
    ext = np.zeros((6, 3, 0), np.int32)
    je, te = _pair(W, 0, backend, K=4)
    jc, js = je.step_chunk({"v": jnp.asarray(v0), "spikes": jnp.asarray(s0)},
                           jnp.asarray(ext))
    tc, ts_ = te.step_chunk(convert.carry(v=v0, spikes=s0), ext)
    assert _eq(js, ts_)
    assert _eq(jc["v"], tc["v"]) and _eq(jc["spikes"], tc["spikes"])
    assert int(ts_.sum()) > 0


@pytest.mark.parametrize("backend", KERNEL_BACKENDS)
@pytest.mark.parametrize("gate", list(GATE_BATCH))
def test_fused_masked_step_chunk_matches_jax(backend, gate):
    """Ragged chunks under K = 4 with paused slots: every window is ragged
    or masked; carries chain across chunks byte-equal in both packages."""
    n_in, P = 30, 40
    W = _weights(9, n_in, P)
    je, te = _pair(W, n_in, backend, gate=gate, K=4)
    ref = te.with_fuse_steps(1)
    B = 4
    jc, tc, rc = je.init_carry(B), te.init_carry(B), ref.init_carry(B)
    rng = np.random.default_rng(10)
    for i, T in enumerate((5, 3, 7, 1)):
        ext = _raster(11 + i, T, B, n_in, density=0.35)
        active = (rng.random((T, B)) < 0.6).astype(np.int32)
        active[:, 1] = 0  # one slot paused for the whole chunk
        ext = ext * active[:, :, None]
        jc, js = je.step_chunk(jc, jnp.asarray(ext), jnp.asarray(active))
        tc, ts_ = te.step_chunk(tc, ext, active)
        rc, rs = ref.step_chunk(rc, ext, active)
        assert _eq(js, ts_) and torch.equal(rs, ts_)
        assert not ts_[:, 1].any()
        for k in ("v", "spikes"):
            assert _eq(jc[k], tc[k]) and torch.equal(rc[k], tc[k])


# --------------------------------------------------------------------------
# ops level: the fused wrapper and its plain kernel version
# --------------------------------------------------------------------------

@pytest.mark.parametrize("use_f32", [False, True])
@pytest.mark.parametrize("gate", list(GATE_BATCH))
def test_ops_spike_timestep_fused_matches_jax(use_f32, gate):
    rng = np.random.default_rng(12)
    K, B, n_in, P = 3, 5, 200, 130
    hi = 1 << 15 if use_f32 else 1 << 31
    W = rng.integers(-hi, hi, (n_in + P, P), dtype=np.int64).astype(np.int32)
    ext = (rng.random((K, B, n_in)) < 0.2).astype(np.int32)
    ext[:, :, 128:] = 0  # a silent external block in every tile
    v = rng.integers(-2**20, 2**20, (B, P)).astype(np.int32)
    spk = (rng.random((B, P)) < 0.3).astype(np.int32)
    active = (rng.random((K, B)) < 0.7).astype(np.int32)
    kw = dict(n_inputs=n_in, decay_rate=0.25, threshold_raw=THRESH,
              reset_mode="subtract", block_batch=GATE_BATCH[gate])
    jout = jops.spike_timestep_fused(
        jnp.asarray(ext), jnp.asarray(spk), jnp.asarray(W), jnp.asarray(v),
        jnp.asarray(active), use_mxu=use_f32, **kw)
    targs = [torch.from_numpy(a) for a in (ext, spk, W, v, active)]
    tout = tops.spike_timestep_fused(*targs, use_f32=use_f32, **kw)
    for j, t in zip(jout, tout):
        assert _eq(j, t)
    # the engine's pre-padded weight pair gives the same bytes
    pair = tops.fused_weights(targs[2], n_in)
    tout2 = tops.spike_timestep_fused(*targs[:2], pair, *targs[3:],
                                      use_f32=use_f32, **kw)
    for a, b in zip(tout, tout2):
        assert torch.equal(a, b)


@pytest.mark.parametrize("use_f32", [False, True])
@pytest.mark.parametrize("block_batch", [1, 8])
def test_fused_plain_equals_chained_single_step_plain(use_f32, block_batch):
    """The fused plain version is K chained single-step plain versions
    over the concatenated (external, recurrent) sources."""
    rng = np.random.default_rng(13)
    K, B, n_ext, P = 4, 8, 256, 128
    hi = 1 << 15 if use_f32 else 1 << 31
    w_ext = torch.from_numpy(rng.integers(-hi, hi, (n_ext, P),
                                          dtype=np.int64).astype(np.int32))
    w_rec = torch.from_numpy(rng.integers(-hi, hi, (P, P),
                                          dtype=np.int64).astype(np.int32))
    ext = torch.from_numpy((rng.random((K, B, n_ext)) < 0.2).astype(np.int32))
    v = torch.from_numpy(rng.integers(-2**20, 2**20, (B, P)).astype(np.int32))
    spk = torch.from_numpy((rng.random((B, P)) < 0.3).astype(np.int32))
    active = torch.from_numpy((rng.random((K, B)) < 0.7).astype(np.int32))
    packed = bitpack.pack_spikes(ext)
    act = tops.window_gate_activity(packed, block_batch=block_batch)
    kw = dict(threshold_raw=THRESH, reset_mode="zero", decay_rate=0.5,
              use_f32=use_f32, block_batch=block_batch)
    got = tsf.spike_timestep_fused_plain(act, packed, w_ext, w_rec, v, spk,
                                         active, **kw)
    W = torch.cat([w_ext, w_rec])
    for k in range(K):
        src = torch.cat([ext[k], spk], dim=1)
        s_act = tops.gate_activity(src, block_batch=block_batch)
        v_new, s_new = tts.spike_timestep_plain(s_act, src, W, v, **kw)
        keep = (active[k] != 0)[:, None]
        assert torch.equal(got[2][k], torch.where(keep, s_new, 0))
        v = torch.where(keep, v_new, v)
        spk = torch.where(keep, s_new, spk)
    assert torch.equal(got[0], v) and torch.equal(got[1], spk)


def test_fused_wrapper_rejects_bad_operands():
    z = torch.zeros
    i32 = torch.int32
    ok = dict(activity=z((1, 1), dtype=i32), ext_packed=z((2, 8, 4), dtype=i32),
              w_ext=z((128, 128), dtype=i32), w_rec=z((128, 128), dtype=i32),
              v=z((8, 128), dtype=i32), spikes=z((8, 128), dtype=i32),
              active=z((2, 8), dtype=i32))
    kw = dict(threshold_raw=THRESH, reset_mode="zero", decay_rate=0.25)
    tsf.spike_timestep_fused(*ok.values(), **kw)  # well-formed: runs
    bad_shape = dict(ok, w_rec=z((128, 256), dtype=i32))
    with pytest.raises(ValueError, match="pre-padded"):
        tsf.spike_timestep_fused(*bad_shape.values(), **kw)
    bad_type = dict(ok, v=z((8, 128), dtype=torch.int64))
    with pytest.raises(ValueError, match="int32"):
        tsf.spike_timestep_fused(*bad_type.values(), **kw)
    with pytest.raises(ValueError, match="CUDA"):
        tsf.spike_timestep_fused_cuda(*ok.values(), **kw)
    with pytest.raises(ValueError, match="block_src"):
        tops.spike_timestep_fused(z((2, 8, 10), dtype=i32), ok["spikes"],
                                  z((138, 128), dtype=i32), ok["v"],
                                  ok["active"], n_inputs=10, block_src=64,
                                  **kw)


# --------------------------------------------------------------------------
# traffic accounting: gate scalars == trace window-OR model, both packages
# --------------------------------------------------------------------------

@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("tile", [8, 1])
def test_ext_gate_activity_and_trace_counts_match_jax(K, tile):
    ext = _raster(14, 10, 5, 300, 0.05)
    j_act = np.asarray(jops.ext_gate_activity(ext, block_batch=tile,
                                              fuse_steps=K))
    t_act = tops.ext_gate_activity(ext, block_batch=tile, fuse_steps=K)
    assert _eq(j_act, t_act)
    j_bt = jtrace.block_traffic(ext, fuse_steps=K, tile_batch=tile)
    t_bt = ttrace.block_traffic(ext, fuse_steps=K, tile_batch=tile)
    assert j_bt == t_bt
    # the blocks the fused kernel is told to fetch == the trace model
    assert int((t_act > 0).sum()) == t_bt[0]
    # torch rasters are taken as they are
    assert ttrace.block_traffic(torch.from_numpy(ext), fuse_steps=K,
                                tile_batch=tile) == t_bt
    # the fused wrapper's per-window gate scalars are the same counts
    window = tops._pad_to(torch.from_numpy(ext[:K]), 1, tile)
    packed = bitpack.pack_spikes(tops._pad_to(window, 2, 128))
    assert torch.equal(tops.window_gate_activity(packed, block_batch=tile),
                       t_act[0])


@pytest.mark.parametrize("K", [1, 2, 4, 8])
def test_fused_block_traffic_matches_jax(K):
    sources = _raster(15, 8, 4, 256 + 128, 0.1)
    assert (ttrace.fused_block_traffic(sources, 256, fuse_steps=K)
            == jtrace.fused_block_traffic(sources, 256, fuse_steps=K))
    dense = np.ones((8, 4, 384), np.int32)
    touched, total = ttrace.fused_block_traffic(dense, 256, fuse_steps=K)
    assert touched * K == total


def test_trace_run_matches_jax_and_counts_follow_the_kernel():
    n_in, P = 200, 130
    W = _weights(16, n_in, P)
    ext = _raster(17, 12, 4, n_in, 0.1)
    je, te = _pair(W, n_in, "cuda", K=4)
    jo, to = je.run(ext), te.run(ext)
    _assert_run_equal(jo, to)
    jr = jtrace.trace_run(je, ext, np.asarray(jo["spikes"]))
    tr = ttrace.trace_run(te, ext, to["spikes"])
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    assert tr.summary() == jr.summary()
    for K in (1, 2, 4):
        kernel = int((tops.ext_gate_activity(ext, fuse_steps=K) > 0).sum())
        assert kernel == ttrace.block_traffic(ext, fuse_steps=K)[0]
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        ttrace.block_traffic([[[1]]])


# --------------------------------------------------------------------------
# re-hosting and the f32 bound
# --------------------------------------------------------------------------

def test_with_fuse_steps_and_with_gate_rehost_on_every_backend():
    W = _weights(18, 20, 40)
    for backend in teng.BACKENDS:
        e = teng.SpikeEngine(W, 20, decay=teng.DecaySpec.shift(0.25),
                             threshold_raw=THRESH, reset_mode="zero",
                             backend=backend, gate="per-example",
                             device="cpu")
        assert e.with_fuse_steps(1) is e
        e4 = e.with_fuse_steps(4)
        assert (e4.fuse_steps, e4.gate, e4.backend) == (4, "per-example",
                                                        backend)
        assert e4._use_fused == (backend != "reference")
        assert e4.with_gate("batch-tile").fuse_steps == 4
        assert e4.with_gate("per-example") is e4
        ext = _raster(19, 9, 2, 20)
        assert torch.equal(e4.run(ext)["spikes"], e.run(ext)["spikes"])
    with pytest.raises(ValueError, match="fuse_steps"):
        e.with_fuse_steps(0)


def test_f32_bound_is_k_invariant_and_names_k():
    W = _weights(20, 37, 48)
    for K in (1, 2, 8):
        assert teng.mxu_partial_sum_bound(W, fuse_steps=K) == \
            jeng.mxu_partial_sum_bound(W, fuse_steps=K) == \
            teng.mxu_partial_sum_bound(W)
    with pytest.raises(ValueError, match="fuse_steps"):
        teng.mxu_partial_sum_bound(W, fuse_steps=0)
    n_in, P = 100, 128
    big = np.full((n_in + P, P), 1 << 17, np.int32)  # block sum 2^24
    with pytest.raises(ValueError) as ei:
        teng.SpikeEngine(big, n_in, decay=teng.DecaySpec.shift(0.25),
                         threshold_raw=THRESH, reset_mode="zero",
                         backend="cuda-f32", fuse_steps=4, device="cpu")
    msg = str(ei.value)
    assert f"max |w| = {1 << 17}" in msg
    assert "fan-in 128" in msg
    assert "fuse_steps K = 4" in msg
    assert "K-invariant" in msg


# --------------------------------------------------------------------------
# the whole slice: two co-resident nets served with churn under fuse_steps
# --------------------------------------------------------------------------

SMALL = dict(n_clusters=8, neurons_per_cluster=32, clusters_per_group=4,
             rows_per_group=2048, clusters_per_l1=4)  # P = 256


def _jax_net(seed, sizes, scale=0.6):
    rng = np.random.default_rng(seed)
    ws = [rng.normal(0.0, scale / np.sqrt(a), (a, b)).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    return jfeedforward(ws, JLIF(decay_rate=0.25))


def _to_port(jnet):
    p = jnet.params
    return convert.network(
        n_inputs=jnet.n_inputs, n_neurons=jnet.n_neurons,
        weights=np.asarray(jnet.weights),
        params=convert.lif_params(decay_rate=p.decay_rate,
                                  threshold=p.threshold,
                                  reset_mode=p.reset_mode,
                                  int_bits=p.fmt.int_bits,
                                  frac_bits=p.fmt.frac_bits),
        layer_slices=jnet.layer_slices, output_slice=jnet.output_slice)


@pytest.mark.parametrize("backend", KERNEL_BACKENDS)
def test_session_served_with_churn_under_fuse_steps(backend):
    """AcceleratorSession(fuse_steps=4) in both packages, 6-step chunks
    (every chunk ends in a ragged window), streams attached, fed and
    detached with waiters admitted into zeroed slots; also held against
    the port's unfused session on the same plan."""
    nets = {"A": _jax_net(1, (30, 50, 10)), "B": _jax_net(2, (20, 40, 6))}
    geom = SMALL
    js = JSession(JConfig(geometry=JGeom(**geom)),
                  backend=teng.BACKEND_TABLE[backend][0], fuse_steps=4)
    tcfg = tch.CerebraHConfig(geometry=convert.geometry(**geom))
    ts = TSession(tcfg, backend=backend, device="cpu", fuse_steps=4)
    us = TSession(tcfg, backend=backend, device="cpu")
    for name, jnet in nets.items():
        js.deploy(name, jnet)
        ts.deploy(name, _to_port(jnet))
        us.deploy(name, _to_port(jnet))
    views = [{n: s.serve(n, n_slots=4, chunk_steps=6) for n in nets}
             for s in (js, ts, us)]
    assert views[1]["A"].server.engine.fuse_steps == 4
    assert views[1]["A"].server.engine._use_fused
    assert views[2]["A"].server.engine.fuse_steps == 1
    rng = np.random.default_rng(21)
    n_inputs = {"A": 30, "B": 20}

    def chunk(name, T):
        return (rng.random((T, n_inputs[name])) < 0.3).astype(np.int32)

    plan = [("attach", "AB"[u % 2], u, None) for u in range(4)]
    plan += [("feed", "A", None, {0: chunk("A", 11), 2: chunk("A", 5)}),
             ("feed", "B", None, {1: chunk("B", 8), 3: chunk("B", 3)}),
             ("attach", "A", 4, None), ("attach", "B", 5, None),
             ("detach", "A", 0, None),
             ("feed", "A", None, {4: chunk("A", 9), 2: chunk("A", 1)}),
             ("detach", "B", 1, None),
             ("feed", "B", None, {5: chunk("B", 13), 3: chunk("B", 2)})]
    n_spikes = 0
    for op, name, uid, inputs in plan:
        if op == "attach":
            for v in views:
                v[name].attach(uid)
            assert len({v[name].slot_of(uid) for v in views}) == 1
        elif op == "detach":
            for v in views:
                v[name].detach(uid)
        else:
            outs = [v[name].feed_many(inputs) for v in views]
            for u in inputs:
                for o in outs[1:]:
                    assert np.array_equal(outs[0][u]["spikes"],
                                          o[u]["spikes"])
                    assert np.array_equal(outs[0][u]["output_counts"],
                                          o[u]["output_counts"])
                n_spikes += int(outs[1][u]["spikes"].sum())
    assert n_spikes > 0
    jc, tc = views[0]["A"].server.carry, views[1]["A"].server.carry
    assert _eq(jc["v"], tc["v"]) and _eq(jc["spikes"], tc["spikes"])
    assert views[1]["A"].server.total_steps == views[0]["A"].server.total_steps
