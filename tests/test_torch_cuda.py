"""CUDA kernel checks that need the card (marker ``cuda``).

Without a CUDA card these skip; on the GPU machine run them with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
``chip_smoke.py`` runs the full sweep; these are the quick per-module
checks: each kernel against its plain version, the engine's kernel
backends (single-step and K-step fused) against its reference backend,
and the split designs of the two timestep kernels under stress: many
source blocks, all-silent and dense sources, ragged B and P, P = 4096
(more neuron tiles than a cluster holds), K = 16, back-to-back launches
into reused buffers, and CUDA-graph replays; the port's threefry and
a seeded ``AcceleratorSession.run`` on the card against the host; and the
event path and the rest of the compile layer on the card against the
host: AER encode and decode, AER in and out of the engine at K 1 and 8,
Cerebra-S on the kernel backends (their multiply decay), and the float
software baseline under a global TF32 setting; and the front door: a
carry snapshot taken on the card equals the host's byte for byte and
continues the stream on either, and the frontend's pump thread serves on
the card what the host serves; and the mesh: 2 x 2 and 2 x 4 meshes whose
shards share the card equal the unsharded host run; and training: a train
step's loss and gradients on the card equal the host's under a global
TF32 setting, and ``evaluate_dual``'s hardware half on the kernel
backends equals the host's reference.
"""

import pathlib
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import bitpack, ops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import spike_timestep as ts  # noqa: E402
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


@pytest.mark.parametrize("shape", [(1, 1), (7, 130), (8, 1024), (300, 513)])
@pytest.mark.parametrize("rate", [0.125, 0.25, 0.5, 0.75])
@pytest.mark.parametrize("reset", ["zero", "subtract", "hold"])
def test_lif_step_kernel_equals_plain_on_the_card(card, shape, rate, reset):
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    v, syn = (rng.integers(-2**31, 2**31, shape).astype(np.int32)
              for _ in range(2))  # full range: adds and resets wrap
    kw = dict(decay_rate=rate, threshold_raw=1 << 16, reset_mode=reset)
    before = ops.LAUNCHES["lif_step"]
    got = ops.lif_step(torch.from_numpy(v).to(card),
                       torch.from_numpy(syn).to(card), **kw)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["lif_step"] == before + 1
    want = kref.lif_step_ref(torch.from_numpy(v), torch.from_numpy(syn), **kw)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("B,D,T", [(1, 1, 1), (4, 30, 16), (9, 784, 5),
                                   (8, 784, 25), (3, 30, 7), (5, 7, 1),
                                   (2, 2, 100), (256, 784, 100)])
@pytest.mark.parametrize("seed", [0, -1, 2**31 - 1])
def test_poisson_encode_kernel_equals_plain_on_the_card(card, B, D, T, seed):
    rng = np.random.default_rng(B + D + T)
    x = rng.uniform(-0.25, 1.25, (B, D)).astype(np.float32)
    edge = [np.nan, 0.0, 1.0, 0.99999994, 2.0 ** -32, np.inf]
    x.reshape(-1)[:len(edge)] = edge[:x.size]
    before = ops.LAUNCHES["poisson_encode"]
    got = ops.poisson_encode(seed, torch.from_numpy(x).to(card), T)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["poisson_encode"] == before + 1
    want = kref.poisson_encode_ref(seed, torch.from_numpy(x), T)
    assert got.shape == (T, B, D)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("shape", [(), (7,), (3, 5, 2), (25, 8, 784)])
@pytest.mark.parametrize("seed", [0, -1, 2**32 + 7])
def test_prng_on_the_card_equals_the_host(card, shape, seed):
    host = prng.uniform(prng.key(seed), shape)
    got = prng.uniform(prng.key(seed).to(card), shape)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu().view(torch.int32), host.view(torch.int32))
    assert torch.equal(prng.split(prng.key(seed).to(card), 3).cpu(),
                       prng.split(prng.key(seed), 3))


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_session_run_on_the_card_equals_the_host(card, backend):
    from repro_torch.core.lif import LIFParams
    from repro_torch.core.network import feedforward
    from repro_torch.core.session import AcceleratorSession

    rng = np.random.default_rng(8)
    ws = [rng.normal(0.0, 0.6 / np.sqrt(a), (a, b)).astype(np.float32)
          for a, b in ((30, 50), (50, 10))]
    net = feedforward(ws, LIFParams(decay_rate=0.25))
    x = rng.uniform(-0.1, 1.1, (4, 30)).astype(np.float32)
    runs = {}
    for device in (card, "cpu"):
        sess = AcceleratorSession(backend=backend, device=device)
        sess.deploy("m", net)
        runs[str(device)] = sess.run("m", x, 20, seed=-5)
    for k in ("spikes", "output_counts", "predictions"):
        assert torch.equal(runs["cuda"][k].cpu(), runs["cpu"][k]), k
    assert int(runs["cpu"]["spikes"].sum()) > 0


@pytest.mark.parametrize("B,D,T", [(3, 30, 7), (8, 784, 25),
                                   (256, 784, 100)])
def test_poisson_encode_relaunch_replay_and_unaligned_on_the_card(card, B, D,
                                                                  T):
    """Two launches into a poisoned, reused buffer; a CUDA-graph replay;
    an input 4 bytes off 16-byte alignment (the scalar path)."""
    rng = np.random.default_rng(B * D + T)
    x = torch.from_numpy(rng.uniform(-0.25, 1.25, (B, D)).astype(np.float32))
    want = kref.poisson_encode_ref(9, x, T)
    first = ops.poisson_encode(9, x.to(card), T)
    torch.cuda.synchronize()
    assert torch.equal(first.cpu(), want)
    first.fill_(-1)
    del first
    assert torch.equal(ops.poisson_encode(9, x.to(card), T).cpu(), want)
    xc = x.to(card)
    assert torch.equal(_graph_replay(lambda: (ops.poisson_encode(
        9, xc, T),))[0].cpu(), want)
    shifted = torch.empty(B * D + 1, device=card)[1:].view(B, D)
    shifted.copy_(xc)
    assert shifted.data_ptr() % 16 != 0
    assert torch.equal(ops.poisson_encode(9, shifted, T).cpu(), want)


# --------------------------------------------------------------------------
# the split designs under stress
# --------------------------------------------------------------------------

def _graph_replay(fn):
    """``fn()`` captured in a CUDA graph and replayed once; its outputs."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out


def _check_split(fn, want):
    """fn() == plain; a second launch after the first outputs were poisoned
    and freed (so their memory is handed out again) gives the same bytes;
    a CUDA-graph replay equals the eager call."""
    first = fn()
    torch.cuda.synchronize()
    for g, w in zip(first, want):
        assert torch.equal(g.cpu(), w)
    for t in first:
        t.fill_(-1)
    del first
    second = fn()
    torch.cuda.synchronize()
    for g, w in zip(second, want):
        assert torch.equal(g.cpu(), w)
    del second
    for g, w in zip(_graph_replay(fn), want):
        assert torch.equal(g.cpu(), w)


SPLIT_DENSITIES = [0.0, 0.05, 1.0]  # all silent, served-like, dense


@pytest.mark.parametrize("shape", [(8, 4200, 1024), (13, 2592, 130),
                                   (5, 1000, 4096)])
@pytest.mark.parametrize("density", SPLIT_DENSITIES)
@pytest.mark.parametrize("block_batch", [1, 8])
@pytest.mark.parametrize("use_f32", [False, True])
def test_split_single_step_on_the_card(card, shape, density, block_batch,
                                       use_f32):
    B, S, P = shape
    rng = np.random.default_rng(B + S + P + int(100 * density))
    hi = 1 << 16 if use_f32 else 1 << 31  # f32: every block sum < 2^23
    src = torch.from_numpy((rng.random((B, S)) < density).astype(np.int32))
    W = torch.from_numpy(rng.integers(-hi, hi, (S, P), dtype=np.int64)
                         .astype(np.int32))
    v = torch.from_numpy(rng.integers(-2**31, 2**31, (B, P), dtype=np.int64)
                         .astype(np.int32))
    sp = ops._pad_to(ops._pad_to(src, 0, block_batch), 1, 128).contiguous()
    wp = ops._pad_to(ops._pad_to(W, 0, 128), 1, 128).contiguous()
    vp = ops._pad_to(ops._pad_to(v, 0, block_batch), 1, 128).contiguous()
    act = ops.gate_activity(sp, block_batch=block_batch)
    kw = dict(threshold_raw=1 << 16, reset_mode="subtract", decay_rate=0.125,
              use_f32=use_f32, block_batch=block_batch)
    want = ts.spike_timestep_plain(act, sp, wp, vp, **kw)
    dev = [t.to(card) for t in (act, sp, wp, vp)]
    before = ops.LAUNCHES["spike_timestep"]
    _check_split(lambda: ts.spike_timestep_cuda(*dev, **kw), want)
    # two eager calls, one warm-up and one captured call of the graph
    assert ops.LAUNCHES["spike_timestep"] == before + 4


@pytest.mark.parametrize("shape", [(8, 4200, 1024), (13, 200, 130),
                                   (5, 300, 4096)])
@pytest.mark.parametrize("density", SPLIT_DENSITIES)
@pytest.mark.parametrize("block_batch", [1, 8])
@pytest.mark.parametrize("use_f32", [False, True])
def test_split_fused_window_on_the_card(card, shape, density, block_batch,
                                        use_f32):
    B, n_in, P = shape
    K = 16
    rng = np.random.default_rng(B + n_in + P + int(100 * density))
    hi = 1 << 15 if use_f32 else 1 << 31
    W = rng.integers(-hi, hi, (n_in + P, P), dtype=np.int64).astype(np.int32)
    ext = (rng.random((K, B, n_in)) < density).astype(np.int32)
    spk = (rng.random((B, P)) < density).astype(np.int32)
    v = rng.integers(-2**20, 2**20, (B, P)).astype(np.int32)
    active = (rng.random((K, B)) < 0.75).astype(np.int32)
    args = [torch.from_numpy(a) for a in (ext, spk, W, v, active)]
    ext_p, spk_p, w_ext, w_rec, v_p, act_p, _, _ = ops._fused_pad(
        *args, n_inputs=n_in, block_batch=block_batch, block_src=128)
    packed = bitpack.pack_spikes(ext_p)
    activity = ops.window_gate_activity(packed, block_batch=block_batch)
    host = (activity, packed, w_ext, w_rec, v_p, spk_p, act_p)
    kw = dict(decay_rate=0.25, threshold_raw=1 << 16, reset_mode="zero",
              use_f32=use_f32, block_batch=block_batch)
    want = tsf.spike_timestep_fused_plain(*host, **kw)
    dev = [t.to(card) for t in host]
    before = ops.LAUNCHES["spike_timestep_fused"]
    _check_split(lambda: tsf.spike_timestep_fused_cuda(*dev, **kw), want)
    assert ops.LAUNCHES["spike_timestep_fused"] == before + 4


# --------------------------------------------------------------------------
# the event path and the rest of the compile layer on the card
# --------------------------------------------------------------------------

def _stream_equal(a, b) -> bool:
    return (a.shape == b.shape
            and torch.equal(a.addrs.cpu(), b.addrs.cpu())
            and torch.equal(a.count.cpu(), b.count.cpu())
            and torch.equal(a.total.cpu(), b.total.cpu()))


@pytest.mark.parametrize("capacity", [None, 100])
def test_aer_on_the_card_equals_the_host(card, capacity):
    from repro_torch import convert
    from repro_torch.events import aer

    rng = np.random.default_rng(21)
    dense = (rng.random((32, 16, 512)) < 0.03).astype(np.int32)
    cap = int(dense.sum()) if capacity is None else capacity
    host = aer.dense_to_aer(dense, cap, policy="drop")
    got = aer.dense_to_aer(torch.from_numpy(dense).to(card), cap,
                           policy="drop")
    assert got.addrs.device.type == "cuda"
    assert _stream_equal(got, host) and got.overflowed == host.overflowed
    assert torch.equal(aer.aer_to_packed(got).cpu(),
                       aer.aer_to_packed(host))
    assert torch.equal(aer.aer_to_dense(got).cpu(), aer.aer_to_dense(host))
    # rows past count, filler and rows past the shape scatter nothing,
    # with no device-side assert
    hand = dict(addrs=np.array([[0, 0, 31], [0, 0, 31], [31, 15, 511],
                                [32, 0, 0], [0, 16, 0], [0, 0, 512],
                                [-1, -1, -1], [1, 1, 1]], np.int32),
                count=7, total=8, shape=(32, 16, 512))
    on_card = convert.aer_stream(**hand, device=card)
    assert torch.equal(aer.aer_to_packed(on_card).cpu(),
                       aer.aer_to_packed(convert.aer_stream(**hand)))


@pytest.mark.parametrize("backend", ["cuda", "cuda-f32"])
@pytest.mark.parametrize("K", [1, 8])
@pytest.mark.parametrize("gate", list(teng.GATES))
def test_aer_engine_on_the_card_equals_the_host(card, backend, K, gate):
    from repro_torch.events import aer

    rng = np.random.default_rng(22)
    n_in, P = 512, 104
    W = (rng.normal(0, 0.5, (n_in + P, P)) * 65536
         * (rng.random((n_in + P, P)) < 0.08)).astype(np.int32)
    ext = (rng.random((32, 16, n_in)) < 0.03).astype(np.int32)
    kw = dict(decay=teng.DecaySpec.shift(0.25), threshold_raw=1 << 16,
              reset_mode="zero")
    ref = teng.SpikeEngine(W, n_in, backend="reference", device="cpu",
                           **kw).run(ext, events_capacity=ext.size)
    eng = teng.SpikeEngine(W, n_in, backend=backend, gate=gate,
                           fuse_steps=K, device=card, **kw)
    before = dict(ops.LAUNCHES)
    got = eng.run(aer.dense_to_aer(torch.from_numpy(ext).to(card),
                                   int(ext.sum())),
                  events_capacity=ext.size)
    torch.cuda.synchronize()
    name = "spike_timestep" if K == 1 else "spike_timestep_fused"
    assert ops.LAUNCHES[name] > before[name]
    assert torch.equal(got["spikes"].cpu(), ref["spikes"])
    assert torch.equal(got["v_final"].cpu(), ref["v_final"])
    assert _stream_equal(got["events"], ref["events"])
    assert int(ref["spikes"].sum()) > 0


@pytest.mark.parametrize("backend", ["cuda", "cuda-f32"])
def test_cerebra_s_on_the_card_equals_the_host(card, backend):
    from repro_torch.core import cerebra_s
    from repro_torch.core.lif import LIFParams
    from repro_torch.core.network import feedforward

    rng = np.random.default_rng(23)
    ws = [rng.normal(0.0, 1.0 / np.sqrt(a), (a, b)).astype(np.float32)
          for a, b in ((100, 64), (64, 10))]
    net = feedforward(ws, LIFParams(decay_rate=0.1))
    prog = cerebra_s.compile_network(
        net, cerebra_s.CerebraSConfig(n_physical_neurons=128))
    ext = (rng.random((20, 8, 100)) < 0.25).astype(np.int32)
    want = cerebra_s.run(prog, ext, "reference", device="cpu")
    before = ops.LAUNCHES["spike_timestep"]
    got = cerebra_s.run(prog, ext, backend, device=card)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["spike_timestep"] == before + 20
    assert cerebra_s.make_engine(prog, backend, device=card).decay.kind == \
        "mul"
    for k in ("spikes", "output_counts", "cycles", "sops"):
        assert torch.equal(got[k].cpu(), want[k]), k
    assert int(want["spikes"].sum()) > 0


def test_software_on_the_card_ignores_a_global_tf32(card):
    """A weight of 1 - 2^-20 is exact in float32 and rounds to 1.0 in
    TF32: with TF32 the neurons would fire at threshold 1.0 on step 0."""
    from repro_torch.core import software
    from repro_torch.core.lif import LIFParams
    from repro_torch.core.network import SNNetwork

    n_in, n = 64, 128
    W = np.zeros((n_in + n, n), np.float32)
    W[0] = np.float32(1.0 - 2.0 ** -20)
    W[1] = np.float32(2.0 ** -20)
    net = SNNetwork(n_inputs=n_in, n_neurons=n, weights=W,
                    params=LIFParams(decay_rate=0.25, threshold=1.0))
    ext = np.zeros((3, 8, n_in), np.float32)
    ext[:, :, 0] = 1.0
    ext[2, :, 1] = 1.0
    want = software.run_software(net, ext, device="cpu")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = software.run_software(net, ext, device=card)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert torch.equal(got["spikes"].cpu(), want["spikes"])
    assert want["spikes"][0].sum() == 0 and want["spikes"][1].sum() > 0


def _front_engine(device, backend="cuda", K=1):
    rng = np.random.default_rng(77)
    n_in, P = 40, 96
    W = ((rng.random((n_in + P, P)) < 0.3)
         * rng.integers(-2**14, 2**14, (n_in + P, P))).astype(np.int32)
    return teng.SpikeEngine(W, n_in, decay=teng.DecaySpec.shift(0.25),
                            threshold_raw=1 << 16, reset_mode="zero",
                            backend=backend, fuse_steps=K, device=device)


@pytest.mark.parametrize("backend", ["cuda", "cuda-f32"])
@pytest.mark.parametrize("K", [1, 8])
def test_snapshot_and_attach_on_the_card_equal_the_host(card, backend, K):
    from repro_torch.serving.connector import CarrySnapshot
    from repro_torch.serving.snn import SpikeServer

    rng = np.random.default_rng(78)
    ext = (rng.random((30, 40)) < 0.3).astype(np.int32)
    servers = {d: SpikeServer(_front_engine(d, backend, K), n_slots=4,
                              chunk_steps=5, device=d)
               for d in ("cpu", "cuda")}
    blobs, firsts = {}, {}
    for d, s in servers.items():
        s.attach("busy")
        uid = s.attach("x")
        firsts[d] = s.feed({uid: ext[:13], "busy": ext[5:9]})[uid]["spikes"]
        blobs[d] = s.snapshot_stream(uid).to_bytes()
    assert blobs["cuda"] == blobs["cpu"]
    assert np.array_equal(firsts["cuda"], firsts["cpu"])
    # the card's blob continues on the host and the host's on the card
    for src, dst in (("cuda", "cpu"), ("cpu", "cuda")):
        s = servers[dst]
        s.detach("x")
        s.attach_stream(CarrySnapshot.from_bytes(blobs[src]), uid="x",
                        slot=3)
        assert s.carry["v"].device.type == dst
        rest = s.feed({"x": ext[13:]})["x"]["spikes"]
        want = _front_engine("cpu", "reference").run(
            torch.from_numpy(ext[:, None, :]))["spikes"][:, 0].numpy()
        assert np.array_equal(np.concatenate([firsts[src], rest]), want)


@pytest.mark.parametrize("K", [1, 8])
def test_frontend_pump_thread_on_the_card(card, K):
    from repro_torch.serving.connector import InMemoryCarryConnector
    from repro_torch.serving.frontend import AsyncSpikeFrontend
    from repro_torch.serving.qos import QoSClass, QoSPolicy
    from repro_torch.serving.snn import SpikeServer

    rng = np.random.default_rng(79)
    rasters = [(rng.random((int(T), 40)) < 0.3).astype(np.int32)
               for T in rng.integers(5, 40, 12)]
    policy = QoSPolicy(classes={"hi": QoSClass(priority=1),
                                "bg": QoSClass()}, preempt=True)
    outs = {}
    for d in ("cpu", "cuda"):
        server = SpikeServer(_front_engine(d, "cuda", K), n_slots=3,
                             chunk_steps=4, device=d)
        fe = AsyncSpikeFrontend(server, queue_capacity=32, qos=policy,
                                connector=InMemoryCarryConnector())
        fe.start(poll_interval_s=0.0002)
        before = dict(ops.LAUNCHES)
        hs = [fe.submit(r, tenant="hi" if i % 3 == 0 else "bg")
              for i, r in enumerate(rasters)]
        fe.stop(drain=True)
        assert all(h.state == "done" for h in hs)
        outs[d] = [h.result()["spikes"] for h in hs]
        kernel = "spike_timestep" if K == 1 else "spike_timestep_fused"
        launched = ops.LAUNCHES[kernel] - before[kernel]
        assert (launched > 0) == (d == "cuda")
    for a, b in zip(outs["cpu"], outs["cuda"]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
@pytest.mark.parametrize("backend", ["cuda", "cuda-f32"])
@pytest.mark.parametrize("n_phys", [48, 130])
def test_mesh_on_the_card_equals_the_host(card, shape, backend, n_phys):
    """A mesh whose shards share the card equals the unsharded host run:
    run, masked step_chunk and a carry row written into a batch shard;
    each shard launches the single-step kernel once a step."""
    from repro_torch.distributed.spike_mesh import make_spike_mesh

    rng = np.random.default_rng(n_phys + shape[1])
    n_in, B, T = 37, 5, 6
    W = ((rng.random((n_in + n_phys, n_phys)) < 0.3)
         * rng.integers(-2**16, 2**16, (n_in + n_phys, n_phys))
         ).astype(np.int32)
    ext = (rng.random((T, B, n_in)) < 0.35).astype(np.int32)
    act = (rng.random((T, B)) < 0.6).astype(np.int32)
    kw = dict(decay=teng.DecaySpec.shift(0.25), threshold_raw=1 << 16,
              reset_mode="subtract", backend=backend)
    host = teng.SpikeEngine(W, n_in, device="cpu", **kw)
    kn, kb = shape
    mesh = make_spike_mesh(kn, kb, devices=[torch.device("cuda", 0)]
                           * (kn * kb))
    dev = teng.SpikeEngine(W, n_in, device=card, **kw).to_mesh(mesh)
    want = host.run(ext)
    before = ops.LAUNCHES["spike_timestep"]
    got = dev.run(ext)
    assert ops.LAUNCHES["spike_timestep"] - before == T * kn * kb
    for k in ("spikes", "v_final"):
        assert torch.equal(got[k].cpu(), want[k])
    hc, hs = host.step_chunk(host.init_carry(B), ext, act)
    dc, ds = dev.step_chunk(dev.init_carry(B), ext, act)
    assert torch.equal(ds.cpu(), hs)
    assert torch.equal(dc["v"].cpu(), hc["v"])
    dev.set_carry_rows(dc, B - 1, hc["v"][0], hc["spikes"][0])
    assert torch.equal(dev.carry_rows(dc, B - 1)[0].cpu(), hc["v"][0])


def _small_train_config():
    from repro_torch.core.lif import LIFParams
    from repro_torch.snn.model import SNNModelConfig
    from repro_torch.snn.train import TrainConfig

    return TrainConfig(model=SNNModelConfig(layer_sizes=(784, 32, 10),
                                            params=LIFParams(decay_rate=0.1)),
                       num_steps_time=10, lr=3e-3, batch_size=32)


def test_train_step_on_the_card_equals_the_host(card):
    """One train step's loss and gradients on the card against the host
    (rtol 1e-5; gradients rtol 1e-4 + atol 1e-4 x max|g|), with TF32
    switched on globally: the training products do not use it."""
    from repro_torch.core import coding
    from repro_torch.data import mnist
    from repro_torch.snn import model as sm
    from repro_torch.snn import train as st

    cfg = _small_train_config()
    params = sm.init_params(0, cfg.model, device="cpu")
    (_, x, y), = mnist.batches("train", cfg.batch_size, 1, seed=0)
    k = prng.fold_in(prng.key(1), 0)
    sp = coding.poisson_encode(k, torch.from_numpy(x), cfg.num_steps_time)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        gh, mh = st.loss_grads(params, sp, torch.from_numpy(y), cfg)
        gc, mc = st.loss_grads([w.to(card) for w in params], sp.to(card),
                               torch.from_numpy(y).to(card), cfg)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    np.testing.assert_allclose(float(mc["loss"]), float(mh["loss"]),
                               rtol=1e-5)
    for a, b in zip(gh, gc):
        a = a.numpy()
        np.testing.assert_allclose(b.cpu().numpy(), a, rtol=1e-4,
                                   atol=1e-4 * np.abs(a).max())


@pytest.mark.parametrize("backend", ["cuda", "cuda-f32"])
def test_evaluate_dual_on_the_card_equals_the_host(card, backend):
    """``evaluate_dual``'s hardware half on the kernel backends of the
    card byte-equal to the host's reference, T single-step launches."""
    from repro_torch.data import mnist
    from repro_torch.snn import model as sm
    from repro_torch.snn import train as st

    cfg = _small_train_config()
    params = sm.init_params(0, cfg.model, device="cpu")
    x, y = mnist.load_or_generate("test", 64, seed=1)
    host = st.evaluate_dual(params, cfg.model, x, y, num_steps_time=10,
                            backend="reference", device="cpu")
    before = ops.LAUNCHES["spike_timestep"]
    got = st.evaluate_dual([w.to(card) for w in params], cfg.model, x, y,
                           num_steps_time=10, backend=backend, device=card)
    assert ops.LAUNCHES["spike_timestep"] - before == 10
    for k in ("output_counts", "spikes", "cycles", "sops", "row_fetches"):
        assert torch.equal(got["hw_counts"][k].cpu(), host["hw_counts"][k])
    assert got["hardware_acc"] == host["hardware_acc"]
