#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Runs from the root of a checkout on a machine with one NVIDIA GPU. It
builds the port's CUDA kernels from the sources in the checkout and then,
in phases that each exit non-zero on failure:

1. prints torch / CUDA / nvcc versions and the card's name and power limit,
   and builds both kernels (one ``nvcc`` each, started together);
2. holds every kernel byte for byte against its plain PyTorch version on
   the card: the single-step timestep over gates x accumulate modes x
   decays x resets x activity x shapes, and the K-step fused window over
   K x gates x modes x decays x resets x shapes (the serving slice's shape,
   a ragged one and the no-external-input edge), with masked slots;
3. serves the slice end to end: two co-resident 784-256-10 MNIST nets on
   the full 32 x 32 Cerebra-H array, 8 slots x 8-step chunks, 20 streams of
   100 steps with churn, under each gate, on the kernel backends ("cuda",
   "cuda-f32") and on "reference"; rasters and predictions must be byte
   equal, one stream is checked against an independent numpy timestep,
   and the kernel launch counts of the served path must be > 0. Then the
   same plan again with ``fuse_steps`` 8 and 3 (ragged windows) on both
   kernel backends and gates: rasters byte-equal to the unfused run, and
   one fused launch per window issued (no single-step launch);
4. runs the launcher ``repro_torch.launch.serve_snn`` on the card, with
   ``--fuse-steps`` 1 and 8 in turns;
5. times each kernel at the slice's shape, beside its plain version and
   its bound: device time per call from CUDA-graph replays between CUDA
   events (``ms``), and the time per call when issued eagerly from the
   host.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or
without the rest of the repository beside it, the script exits 1 and
prints no result.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = pathlib.Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores
N_STREAMS, STREAM_T, N_SLOTS, CHUNK = 20, 100, 8, 8


def log(msg: str) -> None:
    print(f"[chip-smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"[chip-smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# --------------------------------------------------------------------------
def phase_environment(torch) -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    nvcc = subprocess.run(["/usr/local/cuda/bin/nvcc", "--version"],
                          capture_output=True, text=True, timeout=60)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, nvcc "
        f"{nvcc.stdout.strip().splitlines()[-1] if nvcc.stdout else '?'}")
    log(f"device {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    print(card, flush=True)  # name, power limit as nvidia-smi gives them
    return card


def phase_build(kernels) -> None:
    """One nvcc per kernel source, all started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(kernels)) as pool:
        builds = {name: pool.submit(mod.build) for name, mod in kernels}
        for name, fut in builds.items():
            path, out = fut.result()
            log(f"built {name} -> {path.name}")
            for line in out.splitlines():
                if "Compiling entry function" in line:
                    log(f"  {line.split('function')[1].split(' for ')[0]}")
                elif "registers" in line or "spill stores" in line:
                    log(f"    {line.strip()}")
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
def padded_operands(torch, ops, src, W, v, block_batch):
    sp = ops._pad_to(ops._pad_to(src, 0, block_batch), 1, 128).contiguous()
    wp = ops._pad_to(ops._pad_to(W, 0, 128), 1, 128).contiguous()
    vp = ops._pad_to(ops._pad_to(v, 0, block_batch), 1, 128).contiguous()
    act = ops.gate_activity(sp, block_batch=block_batch)
    return act, sp, wp, vp


def phase_kernel_vs_plain(torch, ts, ops) -> int:
    """Kernel vs plain version on the card, torch.equal on both outputs."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    decays = ([("shift", r, 0) for r in (0.125, 0.25, 0.5, 0.75)]
              + [("mul", 0.0, 0), ("mul", 0.0, 1 << 16), ("mul", 0.0, 40503)])
    n_cases, worst = 0, 0
    for B, S, P in ((8, 2592, 1024), (5, 1000, 300)):
        for use_f32 in (False, True):
            for density in (0.0, 0.02, 0.1, 1.0):
                src = (torch.rand((B, S), generator=gen, device="cuda")
                       < density).to(torch.int32)
                # exact mode: full int32 range, so accumulates wrap;
                # f32 mode: |w| < 2^16, block sums < 2^23
                hi = (1 << 16) if use_f32 else (1 << 31)
                W = torch.randint(-hi, hi, (S, P), generator=gen,
                                  device="cuda", dtype=torch.int64)
                W = W.to(torch.int32)
                v = torch.randint(-(1 << 31), 1 << 31, (B, P), generator=gen,
                                  device="cuda", dtype=torch.int64)
                v = v.to(torch.int32)
                for block_batch in (8, 1):
                    act, sp, wp, vp = padded_operands(torch, ops, src, W, v,
                                                      block_batch)
                    for kind, rate, raw in decays:
                        for reset in ("zero", "subtract", "hold"):
                            kw = dict(threshold_raw=1 << 16,
                                      reset_mode=reset, decay_kind=kind,
                                      decay_rate=rate, decay_raw=raw,
                                      use_f32=use_f32,
                                      block_batch=block_batch)
                            got = ts.spike_timestep_cuda(act, sp, wp, vp,
                                                         **kw)
                            want = ts.spike_timestep_plain(act, sp, wp, vp,
                                                           **kw)
                            torch.cuda.synchronize()
                            for g, w in zip(got, want):
                                err = int((g.to(torch.int64)
                                           - w.to(torch.int64)).abs().max())
                                worst = max(worst, err)
                                check(torch.equal(g, w),
                                      f"kernel != plain at B,S,P={B},{S},{P}"
                                      f" f32={use_f32} density={density} "
                                      f"block_batch={block_batch} "
                                      f"decay={kind}/{rate}/{raw} "
                                      f"reset={reset}: max |diff| {err}")
                            n_cases += 1
    log(f"kernel == plain (torch.equal on v_out and spikes) in all "
        f"{n_cases} cases: 2 shapes x 2 modes x 4 activities x 2 gates x "
        f"7 decays x 3 resets; max |diff| {worst}")
    return worst


def fused_operands(ops, bitpack, ext, spk, W, v, active, n_in, block_batch):
    """The padded operands and window-OR gate scalars the fused kernel
    takes, as ``ops.spike_timestep_fused`` prepares them."""
    ext_p, spk_p, w_ext, w_rec, v_p, act_p, _, _ = ops._fused_pad(
        ext, spk, W, v, active, n_inputs=n_in, block_batch=block_batch,
        block_src=128)
    packed = bitpack.pack_spikes(ext_p).contiguous()
    activity = ops.window_gate_activity(packed, block_batch=block_batch)
    return activity, packed, w_ext, w_rec, v_p, spk_p, act_p


def phase_fused_vs_plain(torch, tsf, ops, bitpack) -> int:
    """Fused kernel vs its plain version on the card, torch.equal on
    v_out, the spike carry and the raster, with a launch-error check
    after every launch."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    decays = [("shift", 0.125, 0), ("shift", 0.75, 0), ("mul", 0.0, 47185)]
    n_cases, worst = 0, 0
    # (B, n_inputs, P): the serving slice, a ragged shape, no inputs
    for B, n_in, P in ((8, 1568, 1024), (5, 200, 130), (3, 0, 128)):
        for use_f32 in (False, True):
            hi = (1 << 15) if use_f32 else (1 << 31)
            W = torch.randint(-hi, hi, (n_in + P, P), generator=gen,
                              device="cuda", dtype=torch.int64)
            W = W.to(torch.int32)
            for K in (1, 2, 3, 4, 8):
                ext = (torch.rand((K, B, n_in), generator=gen, device="cuda")
                       < 0.05).to(torch.int32)
                spk = (torch.rand((B, P), generator=gen, device="cuda")
                       < 0.2).to(torch.int32)
                v = torch.randint(-(1 << 20), 1 << 20, (B, P),
                                  generator=gen, device="cuda",
                                  dtype=torch.int32)
                active = (torch.rand((K, B), generator=gen, device="cuda")
                          < 0.75).to(torch.int32)  # masked slots
                for block_batch in (8, 1):
                    args = fused_operands(ops, bitpack, ext, spk, W,
                                          v, active, n_in, block_batch)
                    for kind, rate, raw in decays:
                        for reset in ("zero", "subtract", "hold"):
                            kw = dict(threshold_raw=1 << 16,
                                      reset_mode=reset, decay_kind=kind,
                                      decay_rate=rate, decay_raw=raw,
                                      use_f32=use_f32,
                                      block_batch=block_batch)
                            got = tsf.spike_timestep_fused_cuda(*args, **kw)
                            torch.cuda.synchronize()
                            want = tsf.spike_timestep_fused_plain(*args,
                                                                  **kw)
                            for g, w in zip(got, want):
                                err = int((g.to(torch.int64)
                                           - w.to(torch.int64)).abs().max())
                                worst = max(worst, err)
                                check(torch.equal(g, w),
                                      f"fused kernel != plain at B,n_in,P="
                                      f"{B},{n_in},{P} K={K} f32={use_f32} "
                                      f"block_batch={block_batch} "
                                      f"decay={kind}/{rate}/{raw} "
                                      f"reset={reset}: max |diff| {err}")
                            n_cases += 1
    log(f"fused kernel == plain (torch.equal on v_out, spike carry and "
        f"raster) in all {n_cases} cases: 3 shapes x 2 modes x 5 K x 2 "
        f"gates x 3 decays x 3 resets, masked slots; max |diff| {worst}")
    return worst


# --------------------------------------------------------------------------
def mnist_nets(np, feedforward, cfg):
    """Two 784-256-10 nets from seeded numpy weights, the paper's LIF."""
    nets = {}
    for i, name in enumerate(("mnist0", "mnist1")):
        rng = np.random.default_rng(100 + i)
        sizes = cfg.layer_sizes(256)
        ws = [rng.normal(0.0, 1.0 / np.sqrt(a), (a, b)).astype(np.float32)
              for a, b in zip(sizes[:-1], sizes[1:])]
        nets[name] = feedforward(ws, cfg.LIF)
    return nets


def serve_plan(np):
    """A fixed churn plan: stream uid -> (model, (T, 784) Poisson raster,
    ragged chunk lengths), and the uids arriving in each round."""
    rng = np.random.default_rng(7)
    streams = {}
    for uid in range(N_STREAMS):
        intensity = 0.25 * rng.random(784)
        raster = (rng.random((STREAM_T, 784)) < intensity).astype(np.int32)
        lens = rng.integers(1, 13, STREAM_T)  # ragged chunks of 1..12
        streams[uid] = (f"mnist{uid % 2}", raster, lens)
    arrivals, uid = [], 0
    while uid < N_STREAMS:
        n = int(rng.integers(0, 5))
        arrivals.append(list(range(uid, min(uid + n, N_STREAMS))))
        uid += n
    return streams, arrivals


def serve_once(np, torch, session_cls, cfg, nets, backend, gate, plan,
               fuse_steps=1):
    """Serve the plan; returns ({uid: raster}, {uid: prediction}, session,
    chunk dispatches issued)."""
    sess = session_cls(cfg.ACCELERATOR, backend=backend, device="cuda",
                       fuse_steps=fuse_steps)
    for name, net in nets.items():
        sess.deploy(name, net)
    views = {name: sess.serve(name, n_slots=N_SLOTS, chunk_steps=CHUNK,
                              gate=gate) for name in nets}
    server = views["mnist0"].server
    streams, arrivals = plan
    arrivals = [list(a) for a in arrivals]
    live, pieces, counts = {}, {}, {}
    dispatches = 0
    while arrivals or live:
        if arrivals:
            for uid in arrivals.pop(0):
                views[streams[uid][0]].attach(uid)
                live[uid] = [0, 0]  # cursor, chunk index
                pieces[uid], counts[uid] = [], 0
        done = []
        per_model = {name: {} for name in nets}
        for uid, (cur, k) in live.items():
            if server.slot_of(uid) is None:
                continue
            name, raster, lens = streams[uid]
            n = int(min(lens[k], STREAM_T - cur))
            per_model[name][uid] = raster[cur:cur + n]
            live[uid] = [cur + n, k + 1]
            if cur + n >= STREAM_T:
                done.append(uid)
        for name, inputs in per_model.items():
            if inputs:
                longest = max(len(x) for x in inputs.values())
                dispatches += -(-longest // CHUNK)
                for uid, out in views[name].feed_many(inputs).items():
                    pieces[uid].append(out["spikes"])
                    counts[uid] = counts[uid] + out["output_counts"]
        for uid in done:
            live.pop(uid)
            views[streams[uid][0]].detach(uid)
    rasters = {u: np.concatenate(p, axis=0) for u, p in pieces.items()}
    preds = {u: int(np.argmax(c)) for u, c in counts.items()}
    return rasters, preds, sess, dispatches


def numpy_timestep_raster(np, engine, ext_fused, reset_mode):
    """Independent oracle: the Cerebra-H timestep in numpy int64 for one
    stream alone (shift decay, wrapping adds, >= threshold, reset)."""
    W = engine.weights_raw.cpu().numpy().astype(np.int64)
    shift = {0.125: 3, 0.25: 2, 0.5: 1}[engine.decay.rate]
    thr = engine.threshold_raw
    P = engine.n_phys
    v = np.zeros(P, np.int64)
    spk = np.zeros(P, np.int64)
    out = []
    wrap = lambda x: ((x + 2**31) % 2**32) - 2**31  # noqa: E731
    for ext_t in ext_fused:
        syn = np.concatenate([ext_t, spk]) @ W
        v_new = wrap(v - (v >> shift) + syn)
        spk = (v_new >= thr).astype(np.int64)
        v = np.where(spk > 0, 0, v_new) if reset_mode == "zero" else v_new
        out.append(spk.astype(np.int32))
    return np.stack(out)


def phase_serve(np, torch, ops, session_cls, feedforward, cfg):
    from repro_torch.core.engine import mxu_partial_sum_bound

    nets = mnist_nets(np, feedforward, cfg)
    plan = serve_plan(np)
    launches, served_steps, fused_launches = 0, 0, 0
    rates = {}  # (backend, gate, K) -> served stream-steps per second
    f32_bound = None
    for gate in ("batch-tile", "per-example"):
        t0 = time.perf_counter()
        ref, ref_pred, ref_sess, _ = serve_once(np, torch, session_cls, cfg,
                                                nets, "reference", gate, plan)
        log(f"served {len(ref)} streams x {STREAM_T} steps on reference "
            f"({gate}) in {time.perf_counter() - t0:.2f} s")
        spikes = sum(int(r.sum()) for r in ref.values())
        check(all(r.shape == (STREAM_T, 1024) and r.dtype == np.int32
                  for r in ref.values()), "served raster shape/dtype")
        check(spikes > 0, "the served slice emitted no spikes")
        check(all(0 <= p < 10 for p in ref_pred.values()), "predictions")
        # independent numpy oracle for one stream (co-resident streams in
        # other slots cannot touch its row)
        eng = next(iter(ref_sess._fused_engines.values()))
        name, raster, _ = plan[0][0]
        ext_fused = np.zeros((STREAM_T, eng.n_inputs), np.int64)
        off = 0 if name == "mnist0" else 784
        ext_fused[:, off:off + 784] = raster
        want = numpy_timestep_raster(np, eng, ext_fused,
                                     eng.reset_mode)
        check(np.array_equal(want, ref[0]),
              "reference served raster != independent numpy timestep")
        for backend in ("cuda", "cuda-f32"):
            ops.LAUNCHES["spike_timestep"] = 0  # just before the main path
            ops.LAUNCHES["spike_timestep_fused"] = 0
            t0 = time.perf_counter()
            got, pred, sess, _ = serve_once(np, torch, session_cls, cfg,
                                            nets, backend, gate, plan)
            torch.cuda.synchronize()
            n = ops.LAUNCHES["spike_timestep"]  # just after it
            dt = time.perf_counter() - t0
            server = next(iter(sess._stream_servers.values()))
            check(n > 0, f"{backend}/{gate}: the served path launched no "
                         f"spike_timestep kernel")
            check(ops.LAUNCHES["spike_timestep_fused"] == 0,
                  f"{backend}/{gate}: the unfused path launched the fused "
                  f"kernel")
            check(all(np.array_equal(got[u], ref[u]) for u in ref),
                  f"{backend}/{gate}: served rasters != reference")
            check(pred == ref_pred,
                  f"{backend}/{gate}: predictions != reference")
            launches += n
            served_steps += server.total_steps
            rates[(backend, gate, 1)] = server.total_steps / dt
            log(f"{backend} ({gate}): rasters and predictions byte-equal to "
                f"reference for {len(got)} streams ({spikes} spikes); "
                f"LAUNCHES={dict(ops.LAUNCHES)}; {server.total_steps} "
                f"stream-steps in {dt:.2f} s; "
                f"{n / server.total_steps:.3f} launches per stream-step")
            if backend == "cuda-f32":
                f32_bound = mxu_partial_sum_bound(
                    server.engine.weights_raw.cpu().numpy())
        fused_launches += serve_fused(np, torch, ops, session_cls, cfg, nets,
                                      plan, gate, ref, ref_pred, rates)
    log(f"f32 worst-case block sum {f32_bound} (< 2^24 = {1 << 24})")
    return launches, served_steps, fused_launches, rates


def serve_fused(np, torch, ops, session_cls, cfg, nets, plan, gate, ref,
                ref_pred, rates) -> int:
    """The plan served with K-step fused windows: K = 8 (one window per
    8-step chunk) and K = 3 (ragged: 3 + 3 + 2), on both kernel backends.
    Rasters byte-equal to the unfused run; one fused launch per window
    issued and no single-step launch."""
    total = 0
    for K in (8, 3):
        for backend in ("cuda", "cuda-f32"):
            ops.LAUNCHES["spike_timestep"] = 0  # just before the main path
            ops.LAUNCHES["spike_timestep_fused"] = 0
            t0 = time.perf_counter()
            got, pred, sess, dispatches = serve_once(
                np, torch, session_cls, cfg, nets, backend, gate, plan,
                fuse_steps=K)
            torch.cuda.synchronize()
            n = ops.LAUNCHES["spike_timestep_fused"]  # just after it
            n_single = ops.LAUNCHES["spike_timestep"]
            dt = time.perf_counter() - t0
            server = next(iter(sess._stream_servers.values()))
            windows = dispatches * -(-CHUNK // K)
            check(server.engine.fuse_steps == K and server.engine._use_fused,
                  f"{backend}/{gate}/K={K}: the served engine is not fused")
            check(n == windows and n > 0,
                  f"{backend}/{gate}/K={K}: {n} fused launches for {windows} "
                  f"windows issued")
            check(n_single == 0, f"{backend}/{gate}/K={K}: {n_single} "
                                 f"single-step launches on the fused path")
            check(all(np.array_equal(got[u], ref[u]) for u in ref),
                  f"{backend}/{gate}/K={K}: fused served rasters != unfused")
            check(pred == ref_pred,
                  f"{backend}/{gate}/K={K}: predictions != unfused")
            total += n
            rates[(backend, gate, K)] = server.total_steps / dt
            log(f"{backend} ({gate}) fuse_steps={K}: rasters and "
                f"predictions byte-equal to the unfused run; {n} fused "
                f"launches = {dispatches} chunk dispatches x "
                f"{-(-CHUNK // K)} windows, 0 single-step; "
                f"{server.total_steps} stream-steps in {dt:.2f} s")
    return total


def phase_launcher(torch, ops):
    """``serve_snn`` with --fuse-steps 1 and 8 in turns (1, 8, 8, 1), so
    the two are compared within one run on one card."""
    from repro_torch.launch import serve_snn

    runs = []
    for K in (1, 8, 8, 1):
        ops.LAUNCHES["spike_timestep"] = 0
        ops.LAUNCHES["spike_timestep_fused"] = 0
        summary = serve_snn.main([
            "--device", "cuda", "--backend", "cuda", "--models", "2",
            "--n-inputs", "784", "--n-neurons", "266",
            "--steps-per-stream", "100", "--seed", "0",
            "--fuse-steps", str(K)])
        torch.cuda.synchronize()
        launched = dict(ops.LAUNCHES)
        kernel = "spike_timestep" if K == 1 else "spike_timestep_fused"
        check(launched[kernel] > 0, f"serve_snn --fuse-steps {K} launched "
                                    f"no {kernel} kernel")
        check(sum(launched.values()) == launched[kernel],
              f"serve_snn --fuse-steps {K} launched {launched}")
        check(summary["launches"] == launched,
              "serve_snn's launch counts disagree with the kernels'")
        check(summary["streams_done"] == 24, "serve_snn did not finish")
        log(f"serve_snn --fuse-steps {K}: {summary['steps_per_s']:.1f} "
            f"steps/s, {summary['steps']} stream-steps, {launched[kernel]} "
            f"{kernel} launches, chunk dispatch p50 "
            f"{summary['dispatch_ms']['p50']:.2f} ms")
        runs.append(summary)
    return runs


# --------------------------------------------------------------------------
def served_sources(np, torch, session_cls, feedforward, cfg):
    """A real (8, 2592) source matrix of the slice: 8 streams (4 per
    model) stepped 40 times, sources of the last step."""
    nets = mnist_nets(np, feedforward, cfg)
    sess = session_cls(cfg.ACCELERATOR, backend="reference", device="cuda")
    for name, net in nets.items():
        sess.deploy(name, net)
    eng = sess._fused_engine(list(sess.models.values()))
    rng = np.random.default_rng(3)
    intensity = 0.25 * rng.random((N_SLOTS, 784))
    carry = eng.init_carry(N_SLOTS)
    for _ in range(40):
        ext = np.zeros((N_SLOTS, eng.n_inputs), np.int32)
        for b in range(N_SLOTS):
            off = 0 if b % 2 == 0 else 784
            ext[b, off:off + 784] = rng.random(784) < intensity[b]
        ext_t = torch.from_numpy(ext).cuda()
        sources = torch.cat([ext_t, carry["spikes"]], dim=-1)
        carry, _ = eng.step(carry, ext_t)
    return eng, sources, carry["v"]


def cuda_time_ms(torch, fn, iters=200, warmup=20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(torch, fn, calls=20, replays=20) -> float:
    """Device time per call: ``calls`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events, so the host's cost of
    issuing each call (Python, argument checks, ctypes) is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def phase_times(np, torch, ts, ops, session_cls, feedforward, cfg):
    eng, sources, v = served_sources(np, torch, session_cls, feedforward,
                                     cfg)
    W = eng.weights_raw
    kw0 = dict(threshold_raw=eng.threshold_raw, reset_mode=eng.reset_mode,
               decay_kind="shift", decay_rate=eng.decay.rate)
    active_rows = int((sources != 0).any(dim=0).sum())
    nnz = int((sources != 0).sum())
    log(f"timing inputs: sources {tuple(sources.shape)} from a served "
        f"step, {nnz} spikes ({100 * nnz / sources.numel():.2f}%), "
        f"{active_rows} of {sources.shape[1]} source rows active")
    variants = {}
    for gate, bb in (("batch-tile", 8), ("per-example", 1)):
        act, sp, wp, vp = padded_operands(torch, ops, sources, W, v, bb)
        Bp, Sp = sp.shape
        Pp = wp.shape[1]
        blocks = int((act > 0).sum())
        for mode in ("exact", "f32"):
            kw = dict(kw0, use_f32=(mode == "f32"), block_batch=bb)
            kernel = lambda: ts.spike_timestep_cuda(  # noqa: E731
                act, sp, wp, vp, **kw)
            plain = lambda: ts.spike_timestep_plain(  # noqa: E731
                act, sp, wp, vp, **kw)
            # the wrapper: pad, bitpacked gate scalars, launch
            step = lambda: ops.spike_timestep(  # noqa: E731
                sources, wp, v, **kw)
            k_ms, p_ms, step_ms = (graph_time_ms(torch, f)
                                   for f in (kernel, plain, step))
            k_eager, p_eager, step_eager = (
                cuda_time_ms(torch, f, iters=100)
                for f in (kernel, plain, step))
            got = ts.spike_timestep_cuda(act, sp, wp, vp, **kw)
            want = ts.spike_timestep_plain(act, sp, wp, vp, **kw)
            err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs()
                          .max()) for g, w in zip(got, want))
            check(err == 0, f"timing inputs: kernel != plain ({gate}, {mode})")
            # least bytes: each input read once (the weight rows of active
            # sources only, as this run's data needs), each output written
            nbytes = 4 * (Bp * Sp + act.numel() + active_rows * Pp + Bp * Pp
                          + 2 * Bp * Pp)
            ops_n = nnz * Pp * (2 if mode == "f32" else 1) + 12 * Bp * Pp
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            o_ms = ops_n / FP32_OPS_PER_S * 1e3
            bound = max(b_ms, o_ms)
            variants[f"{gate}/{mode}"] = {
                "ms": k_ms, "plain_ms": p_ms, "ops_step_ms": step_ms,
                "eager_ms": k_eager, "eager_plain_ms": p_eager,
                "eager_ops_step_ms": step_eager, "bound_ms": bound,
                "bound_by": "bytes" if b_ms >= o_ms else "operations",
                "max_abs_err": err, "active_blocks": blocks,
                "grid_ctas": (Pp // 128) * (Bp // bb)}
            log(f"spike_timestep {gate}/{mode}: device time per call "
                f"(CUDA graph) kernel {k_ms * 1e3:.1f} us, plain "
                f"{p_ms * 1e3:.1f} us, whole ops step {step_ms * 1e3:.1f} us;"
                f" issued eagerly kernel {k_eager * 1e3:.1f} us, plain "
                f"{p_eager * 1e3:.1f} us, ops step {step_eager * 1e3:.1f} us;"
                f" bound {bound * 1e3:.2f} us "
                f"({nbytes / 1e6:.2f} MB at 3.35 TB/s) -> "
                f"{100 * bound / k_ms:.1f}% of bound; {blocks} active gate "
                f"blocks, {(Pp // 128) * (Bp // bb)} CTAs")
    log("library_ms: no single PyTorch call computes the gated integer "
        "product together with the LIF epilogue; none is timed")
    return variants


def served_window(np, torch, session_cls, feedforward, cfg, K):
    """A real window of the slice: 8 streams (4 per model) stepped 40
    times on the reference engine, then the next K steps' external spikes
    and the carry at window entry."""
    nets = mnist_nets(np, feedforward, cfg)
    sess = session_cls(cfg.ACCELERATOR, backend="reference", device="cuda")
    for name, net in nets.items():
        sess.deploy(name, net)
    eng = sess._fused_engine(list(sess.models.values()))
    rng = np.random.default_rng(5)
    intensity = 0.25 * rng.random((N_SLOTS, 784))

    def ext_step():
        ext = np.zeros((N_SLOTS, eng.n_inputs), np.int32)
        for b in range(N_SLOTS):
            off = 0 if b % 2 == 0 else 784
            ext[b, off:off + 784] = rng.random(784) < intensity[b]
        return torch.from_numpy(ext).cuda()

    carry = eng.init_carry(N_SLOTS)
    for _ in range(40):
        carry, _ = eng.step(carry, ext_step())
    ext = torch.stack([ext_step() for _ in range(K)])
    return eng, ext, carry


def phase_times_fused(np, torch, tsf, ops, bitpack, session_cls,
                      feedforward, cfg, single):
    """The fused kernel at the slice shape on a served window of K = 8
    steps, beside its plain version, the whole ops wrapper and its bound;
    per step against the single-step kernel of the same run."""
    K = 8
    eng, ext, carry = served_window(np, torch, session_cls, feedforward,
                                    cfg, K)
    n_in = eng.n_inputs
    active = torch.ones((K, N_SLOTS), dtype=torch.int32, device="cuda")
    pair = ops.fused_weights(eng.weights_raw, n_in)
    kw0 = dict(threshold_raw=eng.threshold_raw, reset_mode=eng.reset_mode,
               decay_kind="shift", decay_rate=eng.decay.rate)
    # the work this window's data needs: external rows that spike in any
    # (step, slot), recurrent rows of neurons that spike entering any step
    _, _, raster = ops.spike_timestep_fused(
        ext, carry["spikes"], pair, carry["v"], active, n_inputs=n_in, **kw0)
    rec_in = torch.cat([carry["spikes"][None], raster[:-1]])  # (K, B, P)
    ext_rows = int((ext != 0).any(dim=1).any(dim=0).sum())
    rec_rows = int((rec_in != 0).any(dim=1).any(dim=0).sum())
    nnz = int((ext != 0).sum()) + int((rec_in != 0).sum())
    log(f"fused timing inputs: a served window of K={K} steps x "
        f"{N_SLOTS} slots; {int((ext != 0).sum())} external spikes on "
        f"{ext_rows} of {n_in} rows, {int((rec_in != 0).sum())} recurrent "
        f"spikes on {rec_rows} of {eng.n_phys} rows, "
        f"{int(raster.sum())} spikes emitted")
    variants = {}
    for gate, bb in (("batch-tile", 8), ("per-example", 1)):
        args = fused_operands(ops, bitpack, ext, carry["spikes"],
                              eng.weights_raw, carry["v"], active, n_in, bb)
        activity, packed, w_ext, w_rec, v_p, spk_p, act_p = args
        Bp, Pp = v_p.shape
        blocks = int((activity > 0).sum())
        for mode in ("exact", "f32"):
            kw = dict(kw0, use_f32=(mode == "f32"), block_batch=bb)
            kernel = lambda: tsf.spike_timestep_fused_cuda(  # noqa: E731
                *args, **kw)
            plain = lambda: tsf.spike_timestep_fused_plain(  # noqa: E731
                *args, **kw)
            # the wrapper: pad, bitpack, window-OR gate scalars, launch
            window = lambda: ops.spike_timestep_fused(  # noqa: E731
                ext, carry["spikes"], pair, carry["v"], active,
                n_inputs=n_in, **kw)
            k_ms, p_ms, w_ms = (graph_time_ms(torch, f)
                                for f in (kernel, plain, window))
            k_eager, p_eager, w_eager = (
                cuda_time_ms(torch, f, iters=50)
                for f in (kernel, plain, window))
            got = kernel()
            want = plain()
            err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs()
                          .max()) for g, w in zip(got, want))
            check(err == 0, f"fused timing inputs: kernel != plain "
                            f"({gate}, {mode})")
            nbytes = 4 * ((ext_rows + rec_rows) * Pp + packed.numel()
                          + activity.numel() + act_p.numel()
                          + 4 * Bp * Pp + K * Bp * Pp)
            ops_n = nnz * Pp * (2 if mode == "f32" else 1) + 12 * K * Bp * Pp
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            o_ms = ops_n / FP32_OPS_PER_S * 1e3
            bound = max(b_ms, o_ms)
            step_ms = single[f"{gate}/{mode}"]["ms"]
            variants[f"{gate}/{mode}"] = {
                "ms": k_ms, "ms_per_step": k_ms / K, "plain_ms": p_ms,
                "ops_window_ms": w_ms, "eager_ms": k_eager,
                "eager_plain_ms": p_eager, "eager_ops_window_ms": w_eager,
                "bound_ms": bound,
                "bound_by": "bytes" if b_ms >= o_ms else "operations",
                "single_step_ms": step_ms, "max_abs_err": err,
                "active_ext_blocks": blocks,
                "grid_ctas": min(8, Pp // 128) * (Bp // bb)}
            log(f"spike_timestep_fused {gate}/{mode}: device time per "
                f"window (CUDA graph) kernel {k_ms * 1e3:.1f} us = "
                f"{k_ms / K * 1e3:.1f} us per step (single-step kernel "
                f"{step_ms * 1e3:.1f} us), plain {p_ms * 1e3:.1f} us, whole "
                f"ops window {w_ms * 1e3:.1f} us; issued eagerly kernel "
                f"{k_eager * 1e3:.1f} us, plain {p_eager * 1e3:.1f} us, ops "
                f"window {w_eager * 1e3:.1f} us; bound {bound * 1e3:.2f} us "
                f"({nbytes / 1e6:.2f} MB at 3.35 TB/s) -> "
                f"{100 * bound / k_ms:.1f}% of bound; {blocks} active "
                f"external gate blocks")
    log("library_ms (fused): no single PyTorch call computes the gated "
        "K-step window with its LIF epilogues; none is timed")
    return variants


# --------------------------------------------------------------------------
def main() -> None:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a "
             "CUDA card")
    if not (ROOT / "src" / "repro_torch" / "__init__.py").is_file():
        fail(f"no src/repro_torch beside {__file__}: run it from a "
             f"checkout of the repository")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import snap_v_snn as cfg
    from repro_torch.core.network import feedforward
    from repro_torch.core.session import AcceleratorSession
    from repro_torch.kernels import bitpack, ops
    from repro_torch.kernels import spike_timestep as ts
    from repro_torch.kernels import spike_timestep_fused as tsf

    check(not any(m == "jax" or m.startswith(("jax.", "repro."))
                  or m == "repro" for m in sys.modules),
          "the port pulled in jax or the JAX package")
    # the plain versions' float32 products must not run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("phase 1: environment")
    card = phase_environment(torch)
    phase_build([("spike_timestep", ts), ("spike_timestep_fused", tsf)])

    log("phase 2: kernels vs plain versions on the card")
    worst = phase_kernel_vs_plain(torch, ts, ops)
    worst_fused = phase_fused_vs_plain(torch, tsf, ops, bitpack)

    log("phase 3: the serving slice end to end, unfused and fused")
    launches, served_steps, fused_launches, rates = phase_serve(
        np, torch, ops, AcceleratorSession, feedforward, cfg)
    for (backend, gate, K), rate in sorted(rates.items()):
        log(f"served {backend} ({gate}) fuse_steps={K}: {rate:.1f} "
            f"stream-steps/s")

    log("phase 4: the launcher, --fuse-steps 1 and 8 in turns")
    launcher = phase_launcher(torch, ops)

    log("phase 5: times on the card")
    variants = phase_times(np, torch, ts, ops, AcceleratorSession,
                           feedforward, cfg)
    fused_variants = phase_times_fused(np, torch, tsf, ops, bitpack,
                                       AcceleratorSession, feedforward, cfg,
                                       variants)
    main_v = variants["batch-tile/exact"]
    main_f = fused_variants["batch-tile/exact"]
    log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    launcher_rates = {f"K={s['fuse_steps']} run {i}": s["steps_per_s"]
                      for i, s in enumerate(launcher)}

    print(json.dumps({"kernels": [{
        "name": "spike_timestep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spike_timestep.cu",
        "replaces": "src/repro/kernels/spike_timestep.py:50",
        "launches": launches,
        "max_abs_err": max(worst, main_v["max_abs_err"]),
        "ms": main_v["ms"],
        "plain_ms": main_v["plain_ms"],
        "bound_ms": main_v["bound_ms"],
        "bound_by": main_v["bound_by"],
        "library_ms": None,
        "variants": variants,
        "served_stream_steps": served_steps,
        "card": card,
    }, {
        "name": "spike_timestep_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spike_timestep_fused.cu",
        "replaces": "src/repro/kernels/spike_timestep.py:208",
        "launches": fused_launches,
        "max_abs_err": max(worst_fused, main_f["max_abs_err"]),
        "ms": main_f["ms"],
        "plain_ms": main_f["plain_ms"],
        "bound_ms": main_f["bound_ms"],
        "bound_by": main_f["bound_by"],
        "library_ms": None,
        "fuse_steps": 8,
        "variants": fused_variants,
        "served_stream_steps_per_s": {
            f"{b}/{g}/K={k}": r for (b, g, k), r in sorted(rates.items())},
        "launcher_steps_per_s": launcher_rates,
        "card": card,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
