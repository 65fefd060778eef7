#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Runs from the root of a checkout on a machine with one NVIDIA GPU. It
builds the port's CUDA kernels from the sources in the checkout and then,
in phases that each exit non-zero on failure:

1. prints torch / CUDA / nvcc versions and the card's name and power limit,
   and builds the four kernels (one ``nvcc`` each, started together);
2. holds every kernel byte for byte against its plain PyTorch version on
   the card: the single-step timestep over gates x accumulate modes x
   decays x resets x activity x shapes, the K-step fused window over
   K x gates x modes x decays x resets x shapes (the serving slice's shape,
   a ragged one and the no-external-input edge), with masked slots, the
   LIF update over shapes x decay rates x resets x thresholds on
   full-range int32, and the rate encoder over shapes x seeds with
   out-of-range, edge and NaN intensities (each case also relaunched,
   replayed from a CUDA graph and fed an unaligned input, the scalar
   path); then the split designs of both
   timestep kernels under stress (S >= 4096, all-silent and dense
   sources, ragged B and P, P = 4096, K = 16), each case also launched
   twice into reused buffers and replayed from a CUDA graph; and the
   port's threefry (``core/prng``) and ``AcceleratorSession.run`` for a
   seed, on the card against the same calls on the host;
3. serves the slice end to end: two co-resident 784-256-10 MNIST nets on
   the full 32 x 32 Cerebra-H array, 8 slots x 8-step chunks, 20 streams of
   100 steps with churn, under each gate, on the kernel backends ("cuda",
   "cuda-f32") and on "reference"; rasters and predictions must be byte
   equal, one stream is checked against an independent numpy timestep,
   and the kernel launch counts of the served path must be > 0. Then the
   same plan again with ``fuse_steps`` 8 and 3 (ragged windows) on both
   kernel backends and gates: rasters byte-equal to the unfused run, and
   one fused launch per window issued (no single-step launch);
4. runs the entry points on the card: the launcher
   ``repro_torch.launch.serve_snn`` with ``--fuse-steps`` 1 and 8 in
   turns, and the port's kernel bench
   ``repro_torch.benchmarks.kernel_bench``, the path of the LIF update and
   the encoder (its document must be schema 2 with every axis on every
   record, and both kernels must have been launched);
5. times each kernel at its main path's shape, beside its plain version
   and its bound: device time per call from CUDA-graph replays between
   CUDA events (``ms``), the time per call when issued eagerly from the
   host, and the device time of each launch of a call (memset, product,
   epilogue; memset, external leg, recurrent leg) from ``torch.profiler``;
   the LIF update and the encoder also where their bytes bind (past the
   50 MB L2), each beside the launch floor (one LIF launch on a (1, 1)
   input) and its share of the byte bound;
6. drives the event path and Cerebra-S on the card. The configuration of
   ``examples/event_camera.py``: 64 gesture clips x 32 steps of a
   16 x 16 x 2 sensor (512 inputs) as one AER stream made on the card, the
   gesture net (96 hidden + 8 outputs) on the default 32 x 32 Cerebra-H
   array, ``engine.run`` AER in and AER out on "cuda" and "cuda-f32" x
   both gates x ``fuse_steps`` 1 and 8, each equal to the host's
   "reference" in spikes, ``v_final`` and the output stream;
   ``SpikeServer.feed_events`` (8 slots, 16 clips, ragged chunks of 1..12
   steps) equal to ``feed``; the trace and the measured counts equal to
   the host's, priced by the Table V energy model. Then Cerebra-S on the
   paper's 784-256-10 net (B 8 x T 100 threefry Poisson input at 0.25) on
   "cuda" and "cuda-f32" (the kernels' multiply decay) equal to the host
   reference in spikes, cycles and SOPs, its speedup against Cerebra-H,
   and the float software baseline card against host. It prints the
   device and wall time of ``dense_to_aer``, ``aer_to_dense``,
   ``engine.run`` at K 1 and 8, and one Cerebra-S step, beside the card's
   name and power limit;
7. drives the front door on the card: phase 3's plan on "cuda" and
   "cuda-f32" x ``fuse_steps`` 1 and 8, each run byte-equal to phase 3's
   uninterrupted rasters: every live stream moved once by
   ``migrate_stream`` mid-plan; ``checkpoint_streams`` into a
   ``FileCarryConnector`` and ``restore_streams`` on a fresh session and
   server; a third model deployed with streams in flight (a rolling
   redeploy) and the group re-served; and ``session.serve(frontend=...)``
   with ``submit`` and the pump thread, once FIFO and once under a
   two-class QoS policy with preemption and deadlines that park and
   resume streams. A metrics registry and a span tracer ride the runs:
   the server's counters must equal ``events.trace.measured_counts`` of
   the served rasters, and the traced lifecycles must reconstruct without
   a violation. Then ``serve_snn --async --qos ... --qos-preempt`` and the
   ``--drain`` drill with ``--connector``, ``--metrics -``, ``--trace`` and
   ``--json-summary``, and ``kernel_bench --async --qos --migrate
   --obs-overhead --json``. It prints the wall time of
   ``snapshot_stream``, ``attach_stream``, ``migrate_stream`` and a
   ``FileCarryConnector`` insert / select of a P = 1024 carry, async
   against sync stream-steps/s at K 1 and 8, and the obs overhead ratio;
8. drives the mesh on the card, its shards sharing card 0: phase 3's
   plan through ``AcceleratorSession(mesh=...)`` on a 2 x 2 and a 2 x 4
   mesh, on "cuda" and "cuda-f32" x both gates x ``fuse_steps`` 1 and 8,
   rasters and predictions byte-equal to phase 3's unsharded run, with
   exactly dispatches x chunk steps x shards single-step launches and no
   fused one; the single-step kernel against its plain version at the
   shard shapes (2 x 2 and 2 x 4 shards of the slice, and a ragged shard
   of 65 columns); a carry moved from an unsharded server into a 2 x 4
   mesh server and back, byte-equal to phase 3; ``serve_snn --devices 4
   --mesh 2x2 --json-summary`` against ``--devices 1`` (equal counters,
   four times the launches) and ``kernel_bench --devices 4 --mesh 2x2
   --streaming --json``. It prints the wall and device time of one step
   of the 8-slot slice unsharded and on both meshes over five interleaved
   rounds, and a profiler breakdown of the host's work a step (time in
   torch ops and CUDA API calls against Python between them, the
   costliest ops; the 2 x 2 step's Chrome trace goes to
   ``chiprun_out/``), beside the card's name and power limit;
9. trains the paper's 784-256-10 net on the card (``model_config(256)``,
   T 25, batch 128, 300 steps of Adam at lr 2e-3 on procedural digits)
   with its first step held against the host's (loss and gradients
   allclose, TF32 switched on globally to show the training products
   do not use it), ``make_sharded_train_step`` on two shards of card 0
   against the unsharded step (loss, gradient norm, Adam's first moment
   and params), and a run resumed from a port checkpoint
   at step 150 against the uninterrupted one (atol 1e-6); then
   ``evaluate_dual`` on 1024 procedural test digits at T 25 on "cuda" and
   "cuda-f32": the hardware half (counts, predictions, raster, cycles,
   SOPs) byte-equal to the card's and the host's "reference", with T
   single-step launches each and no fused one. It prints software and
   hardware accuracy, the deviation, the agreement, the device and wall
   time of one train step (median of 21) and of one ``evaluate_dual``,
   and pJ/SOP of the Table V energy model on the measured SOPs, beside
   the card's name and power limit;
10. runs the paper's tables on the card through
   ``repro_torch.benchmarks.run --fast`` (Table III, Table V, the S-vs-H
   speedup and the five-width Table IV, the kernel backend "cuda"), with
   exactly one single-step launch a timestep of Table V, both speedup
   generations and every Table IV evaluation, and no fused one; every
   Table IV row's hardware half byte-equal to the card's "reference",
   Table V's counts and mW equal on "reference", the speedup's cycles
   equal on "cuda-f32" and "reference", and Table V with
   ``--measured-sop``. It prints the rows, the average deviation, compute
   and system pJ/SOP, the SOPs counted on float-nonzero against quantized
   synapses (ROADMAP fault 7) and the launches;
11. drives the dense LM serving path at full width: granite-3-2b (40
   layers, d 2048, 32 heads / 8 KV, vocab 49155), its param count against
   its leaves; ``repro_torch.launch.serve --arch granite-3-2b --full`` in
   bf16 with the launcher's defaults (12 requests, max-batch 4, max-new
   16, max-seq 96), printing tokens/s, per-batch latency, the memory peak
   and one decode step's device, busy and wall time; in float32 (IEEE
   products) prefill + decode against the teacher-forced logits (rtol /
   atol 2e-3); and a two-layer cut of full width, card against host;
12. drives the attention-family LM blocks at full width (``--seed``
   draws their inputs): gemma3-12b (48 layers, 5:1 local:global windows,
   q/k norm, geglu, vocab 262144) and minicpm3-4b (62 layers, MLA) whole
   through ``launch.serve --full`` in bf16 at the launcher's defaults;
   mixtral-8x7b at full width cut to 8 of 32 layers (MoE top-2; the whole
   does not fit one card) through ``BatchServer`` with the launcher's
   request plan, with the share of prefill (token, expert) pairs that
   capacity 1.25 drops; llama4-scout at full width cut to 2 layers (MoE
   top-1 + shared expert), prefill and greedy decode; qwen2-vl-2b whole
   through ``LMHarness``'s prefill and decode steps with embeddings
   (4, 48, 1536) and M-RoPE ids (3, 4, 48). Each prints its param count
   (the leaves == ``param_count()`` plus the norm scales it leaves out),
   bytes, tokens/s, one decode step's device, busy and wall time at B 4
   and the memory peak; every logit finite and every token in the
   vocabulary. In float32 (IEEE products) each arch cut to 12 (gemma3:
   two local:global groups), 2, or 1 (llama4-scout) layers: prefill +
   decode against teacher forcing (MoE at capacity_factor E/k; rtol /
   atol 2e-3) and the cut's logits card against host (1e-3);
13. drives the non-attention LM families and whisper at full width
   (``--seed`` draws their inputs): zamba2-1.2b (38 Mamba2 layers, one
   shared attention block invoked six times with its LoRA deltas) and
   rwkv6-7b (32 layers) whole through ``launch.serve --full`` in bf16 at
   the launcher's defaults; whisper-large-v3 whole (32 + 32 layers, the
   32768-row position table) through ``LMHarness``'s prefill and decode
   steps at ``Shape("whisper_1500", 3000, 4)``: 1500 frames (4, 1500,
   1280) encoded once with their cross K/V cached, a 4-token prompt, 32
   greedy decode steps, the harness's decode step giving the same tokens.
   Each prints what phase 12 prints (its param count == the JAX
   package's leaves); every logit finite, every token in the vocabulary.
   In float32 each arch cut to 12 (zamba2: two shared-block
   invocations), 4 (rwkv6) or 4 + 4 (whisper, its 64-row table) layers:
   prefill + decode against teacher forcing (2e-3) and card against host
   (1e-3);
14. trains LMs on the card: granite-3-2b whole (40 layers, bf16) through
   ``LMHarness(micro_rows=2).make_train_step`` on a 1 x 1 mesh of the
   card, 4 steps of B 8 x S 512 (4 strided microbatches of 2 x 512,
   remat, float32 accumulation, AdamW) on ``data/lm`` batches, printing
   each step's loss, grad norm, wall and CUDA-event ms, the memory peak
   and the param count (== the JAX package's leaves), and a fifth step's
   device-busy ms from ``torch.profiler``; the loss must fall (the first
   batch's after the steps below its first). A float32
   2-layer cut of full width, one step card against host (loss rel 1e-5,
   grad norm 1e-4, Adam's m within ``grads_close``). One mixtral-8x7b
   MoE layer at full width (float32) through ``moe_forward_ep`` on a
   data 4 x model 2 mesh of the card: dropless == the dense dispatch
   (rtol 2e-4, atol 2e-5), and at capacity factor 0.5 the same dropped
   pairs as on the host, outputs within 1e-5. Then ``python -m
   repro_torch.launch.train`` on the card stopped by ``--fail-at-step
   5`` and run again: the resumed params == an uninterrupted run's
   (atol 1e-5);
15. trains across ranks (``scripts/torch_lm_ranks_calls.py``): one NCCL
   process a card, ``min(4, visible cards)`` of them (4, 2 or 1), each
   running ``LMHarness.make_train_step`` on its shards of a rank mesh
   (FSDP over ``data``, tensor parallelism over ``model``, the expert
   all-to-all; with a ``pod`` axis the batch over ``(pod, data)`` and
   every gradient leaf summed over ``pod``): a float32 granite-3-2b
   2-layer cut and a mixtral-8x7b MoE layer (``moe_ep``) at full width on
   ``(2, 2)``, ``(4, 1)``, ``(2, 2, 1)`` and ``(2, 1, 2)`` (two cards:
   ``(2, 1)``, ``(1, 2)``; one: ``(1, 1)`` and the pod mesh ``(1, 1,
   1)``), each held to the one-card logical step of the same mesh (loss
   rel 1e-5, grad norm 1e-4, Adam's m and v within ``grads_close``, the
   params within Adam's first-step bound; on one rank bit for bit); with
   four cards also float32 REDUCED cuts whose query heads ``model`` does
   not divide (llama4-scout at 10 query / 2 K/V heads on ``(1, 4)`` and
   5 / 1 on ``(2, 2)`` with ``moe_ep`` off and on and ``(2, 1, 2)``,
   granite-3-2b at 10 / 2 and 10 / 5 on ``(1, 4)``), held alike, and
   granite-3-2b whole in bf16 on ``(4, 1)`` and on ``(2, 2, 1)``, B 8 x
   S 512, ``micro_rows`` 2, 4 steps: per step loss, grad
   norm, wall and CUDA-event ms and the NCCL calls and bytes by kind and
   by axis (the pod all-reduce apart), each rank's memory peak; the loss
   must fall; and the dry-run of each cell (below) counts the calls and
   bytes the ranks counted, exactly, its peak printed beside theirs. With
   fewer cards a line names the runs that need four. Any rank's failure
   fails the run;
16. runs the dry-run of phase 14's cell (``repro_torch.launch.dryrun``:
   granite-3-2b whole, bf16, B 8 x S 512, ``micro_rows`` 2, a ``(1, 1)``
   rank mesh of fake CUDA tensors under the fake process group, costed
   by ``repro_torch.op_analysis``): its live-storage peak must lie within
   0.8-1.25 of phase 14's measured peak; prints both peaks, the ratio and
   the roofline terms on the H100's data-sheet constants beside phase
   14's step times; then ``op_analysis.analyze_step`` on one real step
   of that cell on the card, its live-storage peak within 1 % of the
   allocator's;
17. serves across ranks (``scripts/torch_lm_serve_ranks_calls.py``):
   one NCCL process a card, ``min(4, visible cards)`` of them, each
   running ``LMHarness.make_prefill_step`` and ``make_decode_step`` on
   its shards of the params and of the cache (the slots over ``model``:
   decode context parallelism): float32 cuts at full width of
   granite-3-2b (2 layers), granite-20b (2 layers, MQA) and mixtral-8x7b
   (2 layers, MoE, window 4096) on ``(2, 2)``, ``(4, 1)``, ``(1, 4)``,
   ``(2, 2, 1)`` and ``(2, 1, 2)`` (the last two with a ``pod`` axis: the
   rows and the cache over ``(pod, data)``; two cards: ``(2, 1)``, ``(1,
   2)``; one: ``(1, 1)`` and ``(1, 1, 1)``), B 4 x S 512
   prefill and 8 decode steps teacher-forced on the one-card run's
   tokens, each held to the one-card logical steps (logits and the
   gathered cache within 1e-5 of each tensor's scale, ``|d| <= 1e-5
   (|want| + max |want|)``, with ``slot_pos`` equal, tokens equal where
   the one-card top-2 margin exceeds 1e-4; on one rank bit for bit); with
   four cards also float32 REDUCED cuts whose query heads ``model`` does
   not divide (llama4-scout at 10 query / 2 K/V heads on ``(1, 4)`` and
   5 / 1 on ``(2, 2)``, granite-3-2b at 10 / 2 and 10 / 5 on ``(1, 4)``;
   the ring over ``model`` and replicated), held alike; llama4-scout at
   its own widths with 10 query / 2 K/V heads on ``(1, 4)`` (a rank's
   ``wq`` / ``wk`` / ``wo`` shard as on ``(16, 16)``), 2 layers, float32,
   B 4 x S 512 and 16 decode steps, held alike, with the attention split
   and under ``attn_tp=False``: each variant's decode step wall and
   CUDA-event ms at p50 / p95, rank 0's busy and NCCL ms in a profiled
   step, the NCCL calls and bytes, equal to its dry-run's; and
   mixtral-8x7b whole in bf16 on ``(2, 2)``, which
   no one card holds: 8 prompts of 512 tokens, 32 greedy decode steps,
   per rank the memory peaks and param shard bytes, the prefill's wall,
   the decode step's wall and CUDA-event ms at p50 / p95, tokens/s, the
   NCCL calls and bytes of a decode step, rank 0's busy ms in a profiled
   step and its NCCL part, every token in the vocabulary and every logit
   finite; and the dry-run of that decode cell counts the calls and
   bytes the ranks counted, exactly. With fewer cards a line names the
   runs that need four. Any rank's failure fails the run.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or
without the rest of the repository beside it, the script exits 1 and
prints no result.
"""

from __future__ import annotations

import json
import pathlib
import re
import subprocess
import sys
import tempfile
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


def check_no_jax() -> None:
    check(not any(m == "jax" or m.startswith(("jax.", "repro."))
                  or m == "repro" for m in sys.modules),
          "the port pulled in jax or the JAX package")


def reset_launches(ops) -> None:
    """Every kernel's launch count to 0, just before a main path runs."""
    for name in ops.LAUNCHES:
        ops.LAUNCHES[name] = 0


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


def capture_graph(torch, fn, calls=1, warmup=1):
    """``calls`` calls of ``fn`` captured in one CUDA graph, after
    ``warmup`` calls on a side stream; returns the graph and the outputs
    of the last captured call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            out = fn()
    return graph, out


def graph_replay(torch, fn):
    """``fn()`` captured in a CUDA graph and replayed once; its outputs."""
    graph, out = capture_graph(torch, fn)
    graph.replay()
    torch.cuda.synchronize()
    return out


def check_relaunch(torch, fn, want, what) -> int:
    """``fn()`` against the plain outputs ``want``; then, with the first
    outputs poisoned and freed so the caching allocator hands their memory
    to the next call, a back-to-back launch must give identical bytes, and
    a CUDA-graph replay must equal the eager call. Returns max |diff|."""
    first = fn()
    torch.cuda.synchronize()
    err = max_abs_diff(torch, first, want)
    check(all(torch.equal(g, w) for g, w in zip(first, want)),
          f"{what}: kernel != plain, max |diff| {err}")
    snapshot = [t.clone() for t in first]
    for t in first:
        t.fill_(-1)
    del first
    second = fn()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(second, snapshot)),
          f"{what}: a second launch into reused buffers changed the bytes")
    del second
    replay = graph_replay(torch, fn)
    check(all(torch.equal(a, b) for a, b in zip(replay, snapshot)),
          f"{what}: the CUDA-graph replay != the eager call")
    return err


# stress shapes of the split designs: many source blocks (S >= 4096),
# ragged B and P, and P = 4096, where neuron tiles outnumber a cluster
SPLIT_SHAPES = ((8, 4200, 1024), (13, 2592, 130), (5, 1000, 4096))
FUSED_SPLIT_SHAPES = ((8, 4200, 1024), (13, 200, 130), (5, 300, 4096))
SPLIT_DENSITIES = (0.0, 0.05, 1.0)  # all silent, served-like, dense


def phase_split_stress(torch, ts, tsf, ops, bitpack) -> int:
    """Both redesigned kernels on the stress shapes: all-silent, sparse and
    dense sources, both gates and modes, K = 16 windows; each case checked
    by :func:`check_relaunch`."""
    gen = torch.Generator(device="cuda").manual_seed(15)

    def rand_int(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                             dtype=torch.int64).to(torch.int32)

    def spikes(shape, density):
        return (torch.rand(shape, generator=gen, device="cuda")
                < density).to(torch.int32)

    n_cases, worst = 0, 0
    for B, S, P in SPLIT_SHAPES:
        for use_f32 in (False, True):
            hi = (1 << 16) if use_f32 else (1 << 31)  # f32: block sums < 2^23
            W, v = rand_int(-hi, hi, (S, P)), rand_int(-(1 << 31), 1 << 31,
                                                       (B, P))
            for density in SPLIT_DENSITIES:
                src = spikes((B, S), density)
                for block_batch in (8, 1):
                    act, sp, wp, vp = padded_operands(torch, ops, src, W, v,
                                                      block_batch)
                    kw = dict(threshold_raw=1 << 16, reset_mode="subtract",
                              decay_kind="shift", decay_rate=0.125,
                              use_f32=use_f32, block_batch=block_batch)
                    want = ts.spike_timestep_plain(act, sp, wp, vp, **kw)
                    worst = max(worst, check_relaunch(
                        torch, lambda: ts.spike_timestep_cuda(  # noqa: B023
                            act, sp, wp, vp, **kw), want,
                        f"spike_timestep stress B,S,P={B},{S},{P} "
                        f"f32={use_f32} density={density} "
                        f"block_batch={block_batch}"))
                    n_cases += 1
    K = 16
    for B, n_in, P in FUSED_SPLIT_SHAPES:
        for use_f32 in (False, True):
            hi = (1 << 15) if use_f32 else (1 << 31)
            W = rand_int(-hi, hi, (n_in + P, P))
            v = rand_int(-(1 << 20), 1 << 20, (B, P))
            active = spikes((K, B), 0.75)  # masked slots
            for density in SPLIT_DENSITIES:
                ext, spk = spikes((K, B, n_in), density), spikes((B, P),
                                                                 density)
                for block_batch in (8, 1):
                    args = fused_operands(ops, bitpack, ext, spk, W, v,
                                          active, n_in, block_batch)
                    kw = dict(threshold_raw=1 << 16, reset_mode="zero",
                              decay_kind="shift", decay_rate=0.25,
                              use_f32=use_f32, block_batch=block_batch)
                    want = tsf.spike_timestep_fused_plain(*args, **kw)
                    worst = max(worst, check_relaunch(
                        torch, lambda: tsf.spike_timestep_fused_cuda(  # noqa
                            *args, **kw), want,
                        f"spike_timestep_fused stress B,n_in,P={B},{n_in},"
                        f"{P} K={K} f32={use_f32} density={density} "
                        f"block_batch={block_batch}"))
                    n_cases += 1
    log(f"split designs under stress: kernel == plain, a second launch into "
        f"reused buffers byte-identical, CUDA-graph replay == eager, in all "
        f"{n_cases} cases: single step {SPLIT_SHAPES} and fused K={K} "
        f"{FUSED_SPLIT_SHAPES} (B, S or n_inputs, P) x 2 modes x densities "
        f"{SPLIT_DENSITIES} x 2 gates; max |diff| {worst}")
    return worst


def max_abs_diff(torch, got, want) -> int:
    return max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
               if g.numel() else 0 for g, w in zip(got, want))


# the shapes of tests/test_kernels.py SHAPES_2D, the bench's and a large one
LIF_SHAPES = ((1, 1), (3, 5), (8, 128), (7, 130), (16, 256), (33, 513),
              (8, 1024), (4096, 4096))


def phase_lif_vs_plain(torch, lif, ref) -> int:
    """LIF kernel vs its plain version (``ref.lif_step_ref``) on the card,
    torch.equal on both outputs, full-range int32 ``v`` and ``syn`` so the
    adds and the subtract reset wrap."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    n_cases, worst = 0, 0
    for shape in LIF_SHAPES:
        v, syn = (torch.randint(-(1 << 31), 1 << 31, shape, generator=gen,
                                device="cuda", dtype=torch.int64)
                  .to(torch.int32) for _ in range(2))
        for rate in (0.125, 0.25, 0.5, 0.75):
            for reset in ("zero", "subtract", "hold"):
                for thr in (1 << 16, -(1 << 20)):
                    kw = dict(decay_rate=rate, threshold_raw=thr,
                              reset_mode=reset)
                    got = lif.lif_step_cuda(v, syn, **kw)
                    torch.cuda.synchronize()
                    want = ref.lif_step_ref(v, syn, **kw)
                    err = max_abs_diff(torch, got, want)
                    worst = max(worst, err)
                    check(all(torch.equal(g, w) for g, w in zip(got, want)),
                          f"lif_step kernel != plain at {shape} rate={rate} "
                          f"reset={reset} threshold={thr}: max |diff| {err}")
                    n_cases += 1
    log(f"lif_step kernel == plain (torch.equal on v_out and spikes) in all "
        f"{n_cases} cases: {len(LIF_SHAPES)} shapes x 4 rates x 3 resets x 2 "
        f"thresholds, full-range int32; max |diff| {worst}")
    return worst


# (B, D, T): the sweep's shapes, planes with B*D % 4 != 0 (the scalar
# path), T 1 and T 100, and the large shape where bytes bind
ENCODE_SHAPES = ((1, 1, 1), (4, 30, 16), (8, 128, 25), (9, 784, 5),
                 (8, 784, 25), (3, 30, 7), (5, 7, 1), (2, 2, 100),
                 (256, 784, 100))
ENCODE_SEEDS = (0, 42, -1, (1 << 31) - 1)


def encode_intensities(torch, gen, B, D):
    """Uniform on [-0.25, 1.25] float32, the first entries replaced by the
    edge values: 0, 1, < 0, > 1, the largest float32 below 1, tiny ones,
    NaN and the infinities."""
    x = torch.rand((B, D), generator=gen, device="cuda") * 1.5 - 0.25
    edge = torch.tensor([0.0, 1.0, -0.5, 1.5, 0.99999994, 1e-10, 2.0 ** -32,
                         float("nan"), float("inf"), float("-inf")],
                        device="cuda")
    flat = x.view(-1)
    n = min(flat.numel(), edge.numel())
    flat[:n] = edge[:n]
    return x


def phase_encode_vs_plain(torch, enc, ref) -> int:
    """Encoder kernel vs its plain version (``ref.poisson_encode_ref``) on
    the card, torch.equal on the (T, B, D) raster, each case through
    :func:`check_relaunch`; every input also 4 bytes off 16-byte alignment,
    which takes the kernel's scalar path."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    n_cases, worst, spikes = 0, 0, 0
    for B, D, T in ENCODE_SHAPES:
        x = encode_intensities(torch, gen, B, D)
        shifted = torch.empty(B * D + 1, device="cuda")[1:].view(B, D)
        shifted.copy_(x)
        for seed in ENCODE_SEEDS:
            for inp, where in ((x, "aligned"), (shifted, "unaligned")):
                want = ref.poisson_encode_ref(seed, inp, T)
                check(want.shape == (T, B, D), "plain encoder shape")
                worst = max(worst, check_relaunch(
                    torch, lambda: (enc.poisson_encode_cuda(  # noqa: B023
                        seed, inp, T),), (want,),
                    f"poisson_encode B,D,T={B},{D},{T} seed={seed} {where}"))
                spikes += int(want.sum())
                n_cases += 1
    log(f"poisson_encode kernel == plain (torch.equal on the raster), a "
        f"second launch into reused buffers byte-identical, CUDA-graph "
        f"replay == eager, in all {n_cases} cases: {len(ENCODE_SHAPES)} "
        f"shapes (B, D, T) {ENCODE_SHAPES} x {len(ENCODE_SEEDS)} seeds x "
        f"aligned / unaligned input, edge and NaN intensities; {spikes} "
        f"spikes; max |diff| {worst}")
    return worst


PRNG_SEEDS = (0, 42, -1, (1 << 32) + 7)
PRNG_SHAPES = ((), (7,), (3, 5, 2), (25, 8, 784))


def phase_prng_card_vs_host(np, torch, prng, session_cls, feedforward, cfg):
    """The port's threefry and the session's seeded run on the card against
    the same calls on the host: the spikes of a seed must not depend on
    the device. torch.equal on uniforms (as int32), split keys, rasters,
    counts and predictions."""
    n_cases = 0
    for seed in PRNG_SEEDS:
        host_key = prng.key(seed)
        card_key = host_key.cuda()
        check(torch.equal(prng.split(card_key, 3).cpu(),
                          prng.split(host_key, 3)),
              f"prng.split on the card != host for seed {seed}")
        for shape in PRNG_SHAPES:
            card = prng.uniform(card_key, shape)
            check(card.device.type == "cuda", "uniform left the key's device")
            host = prng.uniform(host_key, shape)
            check(torch.equal(card.cpu().view(torch.int32),
                              host.view(torch.int32)),
                  f"prng.uniform on the card != host for seed {seed} "
                  f"shape {shape}")
            n_cases += 1
    big = prng.uniform(prng.key(3).cuda(), ENCODE_LARGE)  # 20 M draws
    check(torch.equal(big.cpu().view(torch.int32),
                      prng.uniform(prng.key(3), ENCODE_LARGE)
                      .view(torch.int32)),
          f"prng.uniform on the card != host at {ENCODE_LARGE}")
    nets = mnist_nets(np, feedforward, cfg)
    x = np.random.default_rng(4).random((8, 784)).astype(np.float32)
    spikes = 0
    for backend in ("cuda", "reference"):
        runs = {}
        for device in ("cuda", "cpu"):
            sess = session_cls(cfg.ACCELERATOR, backend=backend,
                               device=device)
            for name, net in nets.items():
                sess.deploy(name, net)
            runs[device] = sess.run("mnist1", x, 25, seed=7)
        torch.cuda.synchronize()
        for k in ("spikes", "output_counts", "predictions"):
            check(torch.equal(runs["cuda"][k].cpu(), runs["cpu"][k]),
                  f"session.run({backend}) on the card != host: {k}")
        spikes += int(runs["cuda"]["spikes"].sum())
        n_cases += 1
    check(spikes > 0, "session.run emitted no spikes")
    log(f"prng and session.run: card == host (torch.equal) in all {n_cases} "
        f"cases: seeds {PRNG_SEEDS} x uniform shapes {PRNG_SHAPES}, split "
        f"keys, uniform at {ENCODE_LARGE}; session.run of mnist1 (B 8, T 25, seed 7) on the "
        f"cuda and reference backends, {spikes} spikes")


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
               fuse_steps=1, mesh=None):
    """Serve the plan (on ``mesh`` when given); returns ({uid: raster},
    {uid: prediction}, session, chunk dispatches issued)."""
    sess = session_cls(cfg.ACCELERATOR, backend=backend, device="cuda",
                       fuse_steps=fuse_steps, mesh=mesh)
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
    refs = {}   # gate -> the reference backend's rasters (phases 7, 8)
    ref_preds = {}  # gate -> the reference backend's predictions
    f32_bound = None
    for gate in ("batch-tile", "per-example"):
        t0 = time.perf_counter()
        ref, ref_pred, ref_sess, _ = serve_once(np, torch, session_cls, cfg,
                                                nets, "reference", gate, plan)
        refs[gate], ref_preds[gate] = ref, ref_pred
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
            reset_launches(ops)  # just before the main path
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
    return launches, served_steps, fused_launches, rates, refs, ref_preds


def serve_fused(np, torch, ops, session_cls, cfg, nets, plan, gate, ref,
                ref_pred, rates) -> int:
    """The plan served with K-step fused windows: K = 8 (one window per
    8-step chunk) and K = 3 (ragged: 3 + 3 + 2), on both kernel backends.
    Rasters byte-equal to the unfused run; one fused launch per window
    issued and no single-step launch."""
    total = 0
    for K in (8, 3):
        for backend in ("cuda", "cuda-f32"):
            reset_launches(ops)  # just before the main path
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
        reset_launches(ops)
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
            f"{summary['straggler']['dispatch_ms']['p50']:.2f} ms")
        runs.append(summary)
    return runs


def phase_kernel_bench(torch, ops):
    """The port's kernel bench on the card: the entry point whose path
    runs the LIF update and the encoder. Returns the launch counts of the
    run."""
    from repro_torch.bench_schema import AXIS_DEFAULTS, SCHEMA_VERSION
    from repro_torch.benchmarks import kernel_bench

    with tempfile.TemporaryDirectory() as tmp:
        out = pathlib.Path(tmp) / "kernel_bench.json"
        reset_launches(ops)  # just before the main path
        t0 = time.perf_counter()
        kernel_bench.main([
            "--device", "cuda", "--backend", "all", "--streaming",
            "--sparsity", "0.05", "--fuse-steps", "1,8", "--json",
            str(out)])
        torch.cuda.synchronize()
        launched = dict(ops.LAUNCHES)  # just after it
        dt = time.perf_counter() - t0
        doc = json.loads(out.read_text())
    records = doc["results"]
    check(doc["metadata"]["schema"] == SCHEMA_VERSION == 2,
          f"kernel bench schema {doc['metadata'].get('schema')}")
    check(doc["metadata"]["device"] != "cpu",
          "kernel bench metadata does not name the card")
    check(len(records) > 0 and all(
        all(axis in rec for axis in AXIS_DEFAULTS) for rec in records),
        "a kernel bench record lacks a schema-v2 axis")
    for name in ("lif_step", "poisson_encode", "spike_timestep",
                 "spike_timestep_fused"):
        check(launched[name] > 0, f"the kernel bench launched no {name} "
                                  f"kernel: {launched}")
    check(all(r.get("counter_consistent", True) for r in records),
          "fused traffic counters disagree")
    log(f"kernel_bench: {len(records)} schema-{SCHEMA_VERSION} records in "
        f"{dt:.1f} s on {doc['metadata']['device']}; LAUNCHES={launched}")
    return launched


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
    graph, _ = capture_graph(torch, fn, calls=calls, warmup=3)
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


def launch_breakdown_us(torch, fn, n=20) -> dict:
    """Device time per call of each launch ``fn()`` issues (kernels and
    memsets, by name), from ``torch.profiler`` over ``n`` eager calls."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        t = getattr(evt, "device_time_total", 0)
        if t > 0:  # "void (anonymous namespace)::name<8, false>(...)" -> name
            m = re.search(r"(\w+)(?:<[^>]*>)?\(",
                          evt.key.replace("(anonymous namespace)", ""))
            out[m.group(1) if m else evt.key] = t / n
    return out


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
            plan = ts.launch_plan(Bp, Sp, Pp, bb)
            legs = launch_breakdown_us(torch, kernel)
            variants[f"{gate}/{mode}"] = {
                "ms": k_ms, "plain_ms": p_ms, "ops_step_ms": step_ms,
                "eager_ms": k_eager, "eager_plain_ms": p_eager,
                "eager_ops_step_ms": step_eager, "bound_ms": bound,
                "bound_by": "bytes" if b_ms >= o_ms else "operations",
                "max_abs_err": err, "active_blocks": blocks,
                "grid_ctas": plan["product_ctas"],
                "epilogue_ctas": plan["epilogue_ctas"],
                "launch_us": legs}
            log(f"spike_timestep {gate}/{mode}: device time per call "
                f"(CUDA graph) kernel {k_ms * 1e3:.1f} us, plain "
                f"{p_ms * 1e3:.1f} us, whole ops step {step_ms * 1e3:.1f} us;"
                f" issued eagerly kernel {k_eager * 1e3:.1f} us, plain "
                f"{p_eager * 1e3:.1f} us, ops step {step_eager * 1e3:.1f} us;"
                f" bound {bound * 1e3:.2f} us "
                f"({nbytes / 1e6:.2f} MB at 3.35 TB/s) -> "
                f"{100 * bound / k_ms:.1f}% of bound; {blocks} active gate "
                f"blocks, {plan['product_ctas']} product CTAs; launches "
                f"(profiler, us): "
                + ", ".join(f"{n} {t:.2f}" for n, t in legs.items()))
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
            plan = tsf.launch_plan(K, Bp, w_ext.shape[0], Pp, bb)
            legs = launch_breakdown_us(torch, kernel)
            variants[f"{gate}/{mode}"] = {
                "ms": k_ms, "ms_per_step": k_ms / K, "plain_ms": p_ms,
                "ops_window_ms": w_ms, "eager_ms": k_eager,
                "eager_plain_ms": p_eager, "eager_ops_window_ms": w_eager,
                "bound_ms": bound,
                "bound_by": "bytes" if b_ms >= o_ms else "operations",
                "single_step_ms": step_ms, "max_abs_err": err,
                "active_ext_blocks": blocks,
                "ext_ctas": plan["ext_ctas"], "rec_ctas": plan["rec_ctas"],
                "launch_us": legs}
            log(f"spike_timestep_fused {gate}/{mode}: device time per "
                f"window (CUDA graph) kernel {k_ms * 1e3:.1f} us = "
                f"{k_ms / K * 1e3:.1f} us per step (single-step kernel "
                f"{step_ms * 1e3:.1f} us), plain {p_ms * 1e3:.1f} us, whole "
                f"ops window {w_ms * 1e3:.1f} us; issued eagerly kernel "
                f"{k_eager * 1e3:.1f} us, plain {p_eager * 1e3:.1f} us, ops "
                f"window {w_eager * 1e3:.1f} us; bound {bound * 1e3:.2f} us "
                f"({nbytes / 1e6:.2f} MB at 3.35 TB/s) -> "
                f"{100 * bound / k_ms:.1f}% of bound; {blocks} active "
                f"external gate blocks; {plan['ext_ctas']} external-leg and "
                f"{plan['rec_ctas']} recurrent-leg CTAs; launches "
                f"(profiler, us): "
                + ", ".join(f"{n} {t:.2f}" for n, t in legs.items()))
    log("library_ms (fused): no single PyTorch call computes the gated "
        "K-step window with its LIF epilogues; none is timed")
    return variants


def time_elementwise(torch, name, kernel, plain, wrapper, nbytes, ops_n,
                     floor_ms):
    """Device time (CUDA-graph replay) of an elementwise kernel, its plain
    version and its ops wrapper, eager times, and its bound, beside the
    launch floor."""
    k_ms, p_ms, w_ms = (graph_time_ms(torch, f)
                        for f in (kernel, plain, wrapper))
    k_eager, p_eager, w_eager = (cuda_time_ms(torch, f, iters=100)
                                 for f in (kernel, plain, wrapper))
    got, want = kernel(), plain()
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    err = max_abs_diff(torch, got, want)
    check(err == 0, f"{name} timing inputs: kernel != plain")
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = ops_n / FP32_OPS_PER_S * 1e3
    bound = max(b_ms, o_ms)
    log(f"{name}: device time per call (CUDA graph) kernel "
        f"{k_ms * 1e3:.2f} us (launch floor {floor_ms * 1e3:.2f} us), plain "
        f"{p_ms * 1e3:.2f} us, whole ops wrapper "
        f"{w_ms * 1e3:.2f} us; issued eagerly kernel {k_eager * 1e3:.2f} us, "
        f"plain {p_eager * 1e3:.2f} us, ops wrapper {w_eager * 1e3:.2f} us; "
        f"bound {bound * 1e3:.3f} us ({nbytes / 1e6:.3f} MB at 3.35 TB/s, "
        f"{ops_n} int ops) -> {100 * bound / k_ms:.1f}% of bound")
    return {"ms": k_ms, "plain_ms": p_ms, "ops_ms": w_ms, "eager_ms": k_eager,
            "eager_plain_ms": p_eager, "eager_ops_ms": w_eager,
            "bound_ms": bound,
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "share_of_bound": bound / k_ms, "launch_floor_ms": floor_ms,
            "max_abs_err": err}


LIF_KW = dict(decay_rate=0.25, threshold_raw=1 << 16, reset_mode="zero")


def time_lif(torch, lif, ref, ops, v, syn, floor_ms, what):
    n = v.numel()
    # v and syn read once, v_out and spikes written once; decay (shift,
    # subtract), add, compare, reset: 5 integer operations per element
    return time_elementwise(
        torch, f"lif_step {what} {tuple(v.shape)}",
        lambda: lif.lif_step_cuda(v, syn, **LIF_KW),
        lambda: ref.lif_step_ref(v, syn, **LIF_KW),
        lambda: ops.lif_step(v, syn, **LIF_KW), 4 * 4 * n, 5 * n, floor_ms)


def time_encode(torch, enc, ref, ops, x, T, floor_ms, what):
    B, D = x.shape
    # intensities read once, the raster written once; per element the
    # hash (3 multiplies and 3 xors of the counters, 3 shifts, 3 xors and
    # 2 multiplies of the finaliser) and the compare and or, per (b, d)
    # the clip, scale, minimum and conversion
    return time_elementwise(
        torch, f"poisson_encode {what} T {T} x B {B} x D {D}",
        lambda: enc.poisson_encode_cuda(0, x, T),
        lambda: ref.poisson_encode_ref(0, x, T),
        lambda: ops.poisson_encode(0, x, T),
        4 * B * D + 4 * T * B * D, 16 * T * B * D + 5 * B * D, floor_ms)


# where bytes bind: (B, P) of the LIF update and (T, B, D) of the encoder,
# each far past the 50 MB L2 (268.4 MB and 81.1 MB)
LIF_LARGE = (1024, 16384)
ENCODE_LARGE = (100, 256, 784)


def phase_times_elementwise(np, torch, lif, enc, ref, ops):
    """The LIF update and the encoder at the kernel bench's shapes and
    inputs (B 8 x P 1024, and T 25 x B 8 x D 784) and where their bytes
    bind, beside the launch floor: the same LIF launch path on a (1, 1)
    input."""
    one = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    floor_ms = graph_time_ms(torch, lambda: lif.lif_step_cuda(one, one,
                                                              **LIF_KW))
    log(f"launch floor: lif_step_cuda on a (1, 1) input, "
        f"{floor_ms * 1e3:.2f} us per call (CUDA graph)")
    rng = np.random.default_rng(0)
    B, P, D, T = 8, 1024, 784, 25
    v, syn = (torch.from_numpy(rng.integers(lo, -lo, (B, P)).astype(
        np.int32)).cuda() for lo in (-2**20, -2**16))
    lif_t = time_lif(torch, lif, ref, ops, v, syn, floor_ms, "bench")
    gen = torch.Generator(device="cuda").manual_seed(16)
    v, syn = (torch.randint(lo, -lo, LIF_LARGE, generator=gen, device="cuda",
                            dtype=torch.int32) for lo in (-2**20, -2**16))
    lif_t["large"] = time_lif(torch, lif, ref, ops, v, syn, floor_ms,
                              "large")
    del v, syn
    x = torch.from_numpy(rng.random((B, D)).astype(np.float32)).cuda()
    enc_t = time_encode(torch, enc, ref, ops, x, T, floor_ms, "bench")
    T_l, B_l, D_l = ENCODE_LARGE
    x = torch.rand((B_l, D_l), generator=gen, device="cuda")
    enc_t["large"] = time_encode(torch, enc, ref, ops, x, T_l, floor_ms,
                                 "large")
    log("library_ms (lif_step, poisson_encode): no single PyTorch call "
        "computes the LIF update or the counter-hash encoder (torch.rand is "
        "another generator); none is timed")
    return lif_t, enc_t


# --------------------------------------------------------------------------
# phase 6: the event path and Cerebra-S on the card
# --------------------------------------------------------------------------
GESTURE_CLIPS, GESTURE_T, GESTURE_SIZE = 64, 32, 16
FEED_CLIPS = 16
S_BATCH, S_STEPS, S_INTENSITY = 8, 100, 0.25
SW_AGREE_MIN = 0.999  # card vs host float rasters (summation orders differ)


def make_gesture_net(np, SNNetwork, LIFParams, rng, n_in, *, hidden=96,
                     n_out=8):
    """The random sparse gesture SNN of ``examples/event_camera.py``
    (numpy, copied): 96 hidden + 8 output neurons over the sensor."""
    n_neurons = hidden + n_out
    W = np.zeros((n_in + n_neurons, n_neurons), np.float32)
    W[:n_in, :hidden] = ((rng.random((n_in, hidden)) < 0.08)
                         * rng.normal(0.0, 0.9, (n_in, hidden)))
    W[n_in:n_in + hidden, hidden:] = (
        (rng.random((hidden, n_out)) < 0.4)
        * rng.normal(0.0, 0.6, (hidden, n_out)))
    return SNNetwork(
        n_inputs=n_in, n_neurons=n_neurons, weights=W,
        params=LIFParams(decay_rate=0.25, threshold=1.0, reset_mode="zero"),
        output_slice=(hidden, n_neurons))


def streams_equal(torch, a, b) -> bool:
    return (a.shape == b.shape and torch.equal(a.addrs.cpu(), b.addrs.cpu())
            and torch.equal(a.count.cpu(), b.count.cpu())
            and torch.equal(a.total.cpu(), b.total.cpu()))


def device_and_wall_us(torch, fn, n) -> tuple[float, float, float]:
    """Per eager call: µs between CUDA events, host wall µs to the end of
    the work (synchronized), over ``n`` calls after two warm-up calls; and
    the µs the device is busy: the device time of all its launches
    (kernels, memsets, copies) from ``torch.profiler``, per call."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e6
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    busy = sum(getattr(evt, "device_time_total", 0)
               for evt in prof.key_averages()) / n
    return start.elapsed_time(end) / n * 1e3, wall, busy


def serve_clips(np, torch, aer, server_cls, engine, dense, lens, events):
    """The first FEED_CLIPS clips through a SpikeServer of 8 slots x
    8-step chunks in ragged chunks (``lens``), all attached at once (8
    wait) and detached when done; with ``events`` through feed_events
    (each chunk an AER stream made on the card, the outputs re-encoded),
    else through feed. Returns {clip: raster}."""
    srv = server_cls(engine, n_slots=N_SLOTS, chunk_steps=CHUNK,
                     device="cuda")
    T = dense.shape[0]
    cursor = {}
    pieces = {uid: [] for uid in range(FEED_CLIPS)}
    for uid in range(FEED_CLIPS):
        srv.attach(uid)
        cursor[uid] = [0, 0]
    while cursor:
        inputs = {}
        for uid, (cur, k) in cursor.items():
            if srv.slot_of(uid) is None:
                continue
            n = int(min(lens[uid, k], T - cur))
            chunk = dense[cur:cur + n, uid]
            if events:
                inputs[uid] = aer.dense_to_aer(
                    torch.from_numpy(chunk[:, None, :]).cuda(),
                    int(chunk.sum()))
            else:
                inputs[uid] = chunk
            cursor[uid] = [cur + n, k + 1]
        out = (srv.feed_events(inputs, out_capacity=12 * 1024)
               if events else srv.feed(inputs))
        for uid, res in out.items():
            pieces[uid].append(res["spikes"])
            if events:
                check(np.array_equal(
                    aer.aer_to_dense(res["events"]).numpy()[:, 0],
                    res["spikes"]), "feed_events' output stream != raster")
        for uid in [u for u, (cur, _) in cursor.items() if cur >= T]:
            cursor.pop(uid)
            srv.detach(uid)
    return {uid: np.concatenate(p, axis=0) for uid, p in pieces.items()}


def phase_event_path(np, torch, ops):
    """examples/event_camera.py on the card: gesture clips as one AER
    stream, AER in and AER out of the Cerebra-H engine on both kernel
    backends x gates x K 1 / 8, feed_events against feed, the trace and
    the measured counts; every result against the host's reference."""
    from repro_torch.core import cerebra_h, energy
    from repro_torch.core.lif import LIFParams
    from repro_torch.core.network import SNNetwork
    from repro_torch.data import events as ev_data
    from repro_torch.events import aer, trace
    from repro_torch.serving.snn import SpikeServer

    stream, labels = ev_data.gesture_events(
        "test", GESTURE_CLIPS, steps=GESTURE_T, size=GESTURE_SIZE, seed=0)
    T, B, D = stream.shape
    check(D == 512 and len(labels) == B, f"gesture stream shape {stream.shape}")
    dense = aer.aer_to_dense(stream)  # host
    n_in_events = int(stream.total)
    log(f"{B} gesture clips x {T} steps on a {GESTURE_SIZE}x{GESTURE_SIZE}x2 "
        f"sensor: {n_in_events} events ({100 * stream.sparsity:.2f}% dense)")
    net = make_gesture_net(np, SNNetwork, LIFParams,
                           np.random.default_rng(0), D)
    prog = cerebra_h.compile_network(net)
    host_eng = cerebra_h.make_engine(prog, "reference", device="cpu")
    ref = host_eng.run(dense)
    cap = int(ref["spikes"].sum())
    check(cap > 0, "the gesture net emitted no spikes")
    ref = host_eng.run(stream, events_capacity=cap)

    dense_card = dense.cuda()
    card_stream = aer.dense_to_aer(dense_card, n_in_events)
    check(card_stream.addrs.device.type == "cuda"
          and streams_equal(torch, card_stream, stream),
          "dense_to_aer on the card != host")
    check(torch.equal(aer.aer_to_packed(card_stream).cpu(),
                      aer.aer_to_packed(stream))
          and torch.equal(aer.aer_to_dense(card_stream).cpu(), dense),
          "aer_to_packed / aer_to_dense on the card != host")

    reset_launches(ops)  # just before the main path
    engines = {}
    for backend in ("cuda", "cuda-f32"):
        for gate in ("batch-tile", "per-example"):
            for K in (1, 8):
                eng = cerebra_h.make_engine(prog, backend, device="cuda") \
                    .with_gate(gate).with_fuse_steps(K)
                out = eng.run(card_stream, events_capacity=cap)
                what = f"event path {backend}/{gate}/K={K}"
                check(torch.equal(out["spikes"].cpu(), ref["spikes"]),
                      f"{what}: spikes != host reference")
                check(torch.equal(out["v_final"].cpu(), ref["v_final"]),
                      f"{what}: v_final != host reference")
                check(streams_equal(torch, out["events"], ref["events"]),
                      f"{what}: output AER stream != host reference")
                engines[(backend, gate, K)] = (eng, out)
    rng = np.random.default_rng(6)
    lens = rng.integers(1, 13, (FEED_CLIPS, T))  # ragged chunks of 1..12
    dense_np = dense.numpy()
    served = {}
    for backend, gate, K in (("cuda", "per-example", 1),
                             ("cuda-f32", "batch-tile", 8)):
        eng = engines[(backend, gate, K)][0]
        by_feed = serve_clips(np, torch, aer, SpikeServer, eng, dense_np,
                              lens, events=False)
        by_events = serve_clips(np, torch, aer, SpikeServer, eng, dense_np,
                                lens, events=True)
        for uid in range(FEED_CLIPS):
            check(np.array_equal(by_events[uid], by_feed[uid]),
                  f"feed_events != feed ({backend}/{gate}/K={K}, clip {uid})")
            check(np.array_equal(by_feed[uid], ref["spikes"][:, uid].numpy()),
                  f"served clip {uid} != host reference run")
        served[(backend, gate, K)] = sum(int(r.sum()) for r in
                                         by_feed.values())
    eng, out = engines[("cuda", "per-example", 1)]
    report = trace.trace_run(eng, card_stream, out["events"])
    check(report == trace.trace_run(host_eng, dense, ref["spikes"]),
          "trace_run on the card's streams != host")
    measured = trace.measured_counts(prog, card_stream, out["events"])
    check(measured == trace.measured_counts(prog, dense, ref["spikes"]),
          "measured_counts on the card's streams != host")
    torch.cuda.synchronize()
    launched = dict(ops.LAUNCHES)  # just after it
    for name in ("spike_timestep", "spike_timestep_fused"):
        check(launched[name] > 0, f"the event path launched no {name} "
                                  f"kernel: {launched}")
    log(f"event path: 8 runs (cuda, cuda-f32 x batch-tile, per-example x "
        f"K 1, 8) == host reference in spikes, v_final and the output "
        f"stream ({cap} spike events out); feed_events == feed == the run "
        f"for {FEED_CLIPS} clips on 8 slots ({served}); LAUNCHES={launched}")
    log(f"trace: {report.summary()}")
    model = energy.EnergyModel.calibrated()
    uj = model.energy_uj(measured)
    log(f"measured energy: {measured.sops:.0f} SOPs, "
        f"{measured.row_fetches:.0f} row fetches, {measured.cycles:.0f} "
        f"cycles -> {uj['dynamic_uj']:.4f} uJ dynamic, "
        f"{uj['total_uj']:.4f} uJ total ({model.e_sop_pj} pJ/SOP compute, "
        f"{uj['pj_per_sop_system']:.1f} pJ/SOP system incl. static)")

    times = {}
    times["dense_to_aer"] = device_and_wall_us(
        torch, lambda: aer.dense_to_aer(dense_card, n_in_events), 50)
    times["aer_to_dense"] = device_and_wall_us(
        torch, lambda: aer.aer_to_dense(card_stream), 50)
    for K in (1, 8):
        eng = engines[("cuda", "batch-tile", K)][0]
        times[f"engine.run K={K}"] = device_and_wall_us(
            torch, lambda: eng.run(card_stream), 10)
    return launched, times


def phase_cerebra_s(np, torch, ops, feedforward, cfg):
    """Cerebra-S on the paper's 784-256-10 net: the kernel backends (their
    multiply decay) against the host reference, S against H in time, and
    the float software baseline card against host."""
    from repro_torch.core import (cerebra_h, cerebra_s, coding, prng,
                                  software, timing)
    from repro_torch.core.engine import MXU_EXACT_BOUND, mxu_partial_sum_bound

    net = mnist_nets(np, feedforward, cfg)["mnist0"]
    ext = coding.poisson_encode(
        prng.key(0), torch.full((S_BATCH, 784), S_INTENSITY), S_STEPS,
        dtype=torch.int32)  # host, (T, B, 784)
    ext_card = ext.cuda()
    prog = cerebra_s.compile_network(net)
    want = cerebra_s.run(prog, ext, "reference", device="cpu")
    bound = mxu_partial_sum_bound(prog.weights_raw.numpy())
    check(bound < MXU_EXACT_BOUND, f"Cerebra-S f32 bound {bound} >= 2^24")
    reset_launches(ops)  # just before the main path
    for backend in ("cuda", "cuda-f32"):
        got = cerebra_s.run(prog, ext_card, backend, device="cuda")
        for k in ("spikes", "output_counts", "cycles", "sops"):
            check(torch.equal(got[k].cpu(), want[k]),
                  f"Cerebra-S {backend}: {k} != host reference")
    torch.cuda.synchronize()
    launched = dict(ops.LAUNCHES)  # just after it
    check(launched["spike_timestep"] == 2 * S_STEPS,
          f"Cerebra-S launched {launched}")
    check(cerebra_s.make_engine(prog, "cuda", device="cuda").decay.kind
          == "mul", "Cerebra-S engine does not decay by multiply")
    hprog = cerebra_h.compile_network(net, cfg.ACCELERATOR)
    h_card = cerebra_h.run(hprog, ext_card, "cuda", device="cuda")
    h_host = cerebra_h.run(hprog, ext, "reference", device="cpu")
    check(torch.equal(h_card["cycles"].cpu(), h_host["cycles"]),
          "Cerebra-H cycles on the card != host")
    rep = timing.speedup_report(got["cycles"].cpu(), h_card["cycles"].cpu())
    log(f"Cerebra-S 784-256-10, B {S_BATCH} x T {S_STEPS} Poisson at "
        f"{S_INTENSITY}: cuda and cuda-f32 == host reference in spikes, "
        f"output counts, cycles and SOPs ({int(want['spikes'].sum())} "
        f"spikes, {int(want['sops'].sum())} SOPs; decay_raw "
        f"{prog.decay_raw}, f32 worst block sum {bound} < 2^24); "
        f"LAUNCHES={launched}")
    log(f"speedup S vs H: {rep.cycles_s:.0f} vs {rep.cycles_h:.0f} cycles "
        f"(x{rep.cycle_speedup:.2f}), clock x{rep.clock_speedup:.2f}, "
        f"{rep.time_s_us:.1f} vs {rep.time_h_us:.1f} us "
        f"(x{rep.total_speedup:.2f} total)")
    sw_card = software.run_software(net, ext_card, device="cuda")
    sw_host = software.run_software(net, ext, device="cpu")
    agree = float((sw_card["spikes"].cpu() == sw_host["spikes"])
                  .double().mean())
    diff = float((sw_card["output_counts"].cpu()
                  - sw_host["output_counts"]).abs().max())
    check(agree >= SW_AGREE_MIN and diff <= 2,
          f"software card vs host: agreement {agree}, counts off by {diff}")
    log(f"software baseline card vs host: spike agreement {agree:.6f} "
        f"(>= {SW_AGREE_MIN}), output counts within {diff:.0f} "
        f"(allclose atol 2), {int(sw_host['spikes'].sum())} host spikes")
    eng = cerebra_s.make_engine(prog, "cuda", device="cuda")
    carry = eng.init_carry(S_BATCH)
    ext_t = ext_card[0]
    step = device_and_wall_us(torch, lambda: eng.step(carry, ext_t), 200)
    return launched, step


# --------------------------------------------------------------------------
# phase 7: the front door on the card
# --------------------------------------------------------------------------
MID_ROUND = 12      # the round phase 7's sync runs move their streams at


def third_net(np, feedforward, cfg):
    """A net at the JAX tests' widths (64-40-10, the paper's LIF): it fits
    the 8 clusters the two MNIST nets leave free and joins their group."""
    rng = np.random.default_rng(300)
    sizes = (64, 40, 10)
    ws = [rng.normal(0.0, 1.0 / np.sqrt(a), (a, b)).astype(np.float32)
          for a, b in zip(sizes[:-1], sizes[1:])]
    return feedforward(ws, cfg.LIF)


def front_session(session_cls, cfg, nets, backend, K, **kw):
    sess = session_cls(cfg.ACCELERATOR, backend=backend, device="cuda",
                       fuse_steps=K, **kw)
    for name, net in nets.items():
        sess.deploy(name, net)
    return sess


def serve_views(sess, names, frontend=None):
    return {name: sess.serve(name, n_slots=N_SLOTS, chunk_steps=CHUNK,
                             frontend=frontend) for name in names}


def serve_hooked(np, views, plan, hook):
    """Phase 3's plan through the sync loop, admitting a stream only when
    a slot is free; at ``MID_ROUND`` ``hook(views)`` moves the live
    streams and may hand back new views. Returns {uid: raster}."""
    streams, arrivals = plan
    arrivals = [list(a) for a in arrivals]
    queue, live = [], {}
    pieces = {uid: [] for uid in streams}
    rnd, hooked = 0, False
    while arrivals or queue or live:
        if arrivals:
            queue += arrivals.pop(0)
        server = views["mnist0"].server
        while queue and server.scheduler.free_slots > 0:
            uid = queue.pop(0)
            views[streams[uid][0]].attach(uid)
            live[uid] = [0, 0]  # cursor, chunk index
        if not hooked and rnd >= MID_ROUND and live:
            views = hook(views) or views
            hooked = True
        per_model = {name: {} for name in views}
        done = []
        for uid, (cur, k) in live.items():
            name, raster, lens = streams[uid]
            n = int(min(lens[k], STREAM_T - cur))
            per_model[name][uid] = raster[cur:cur + n]
            live[uid] = [cur + n, k + 1]
            if cur + n >= STREAM_T:
                done.append(uid)
        for name, inputs in per_model.items():
            if inputs:
                for uid, out in views[name].feed_many(inputs).items():
                    pieces[uid].append(out["spikes"])
        for uid in done:
            live.pop(uid)
            views[streams[uid][0]].detach(uid, reason="done")
        rnd += 1
    check(hooked, "the plan ended before its middle round")
    return {u: np.concatenate(p, axis=0) for u, p in pieces.items()}


def serve_async(np, sess, plan, frontend, deadline_every=0, timeout_s=300):
    """The plan through ``session.serve(frontend=...)`` and ``submit``, the
    pump on its own thread. The frontend's clock counts pump rounds, so a
    deadline of 3000 ms is 3 rounds: a stream given one parks mid-flight
    (or, still queued, expires and is submitted again) and is resumed.
    Returns ({uid: raster}, frontend metrics, wall seconds)."""
    streams, arrivals = plan
    views = serve_views(sess, ("mnist0", "mnist1"), frontend)
    fe = views["mnist0"].frontend
    check(fe is not None and fe is views["mnist1"].frontend,
          "co-resident views do not share one frontend")
    fe.clock = lambda: float(fe.rounds)
    order = [uid for a in arrivals for uid in a]
    t0 = time.perf_counter()
    fe.start(poll_interval_s=0.0002)
    handles = {}
    for uid in order:
        name, raster, _ = streams[uid]
        dl = 3000.0 if deadline_every and uid % deadline_every == 0 else None
        handles[uid] = views[name].submit(raster, deadline_ms=dl)
    while True:
        pending = 0
        for uid, h in handles.items():
            if h.state == "parked":
                fe.resume(h)
            elif h.state == "expired" and not h.result():
                name, raster, _ = streams[uid]  # expired while queued
                handles[uid] = views[name].submit(raster)
            pending += not h.done
        if not pending and fe.idle:
            break
        if fe._pump_error is not None:
            fe.stop(drain=False)    # raises the pump thread's error
        if time.perf_counter() - t0 > timeout_s:
            fe.stop(drain=False)
            fail(f"the async front door did not finish in {timeout_s} s")
        time.sleep(0.0005)
    fe.stop(drain=True)
    wall = time.perf_counter() - t0
    out = {}
    for uid, h in handles.items():
        check(h.state == "done", f"async stream {uid} ended {h.state}")
        res = h.result()
        check("partial" not in res, f"async stream {uid} is partial")
        out[uid] = res["spikes"]
    return out, fe.metrics(), wall


def check_measured(np, sess, metrics, plan, rasters, what):
    """The server's measured-work counters == events.trace.measured_counts
    of the served rasters, summed over the two models. measured_counts
    counts a program's logical synapses (nonzero float weights) and the
    server the quantized ones the kernels multiply: the programs are
    given their quantized fanout first, and the SOPs of synapses that
    quantize to 0 are returned beside the check."""
    import dataclasses

    from repro_torch.core.energy import counts_from_registry
    from repro_torch.events.trace import measured_counts

    streams, _ = plan
    sops = rows = logical = 0.0
    for name in ("mnist0", "mnist1"):
        prog = sess.models[name].program
        raw = prog.weights_raw.reshape(prog.n_sources, -1).cpu().numpy()
        quantized = dataclasses.replace(prog,
                                        fanout=np.count_nonzero(raw, axis=1))
        uids = [u for u in sorted(streams) if streams[u][0] == name]
        ext = np.stack([streams[u][1] for u in uids], axis=1)
        out = np.stack([rasters[u] for u in uids], axis=1)
        want = measured_counts(quantized, ext, out)
        sops += want.sops
        rows += want.row_fetches
        logical += measured_counts(prog, ext, out).sops
    got = counts_from_registry(metrics)
    check((got.sops, got.row_fetches) == (sops, rows),
          f"{what}: server counters {got.sops} SOPs / {got.row_fetches} rows "
          f"!= measured_counts {sops} / {rows}")
    return sops, logical - sops


def phase_front_door(np, torch, ops, session_cls, feedforward, cfg, ref):
    """Migration, recovery, rolling redeploy and the async front door (FIFO
    and two-class QoS with preemption) on "cuda" / "cuda-f32" x K 1 / 8,
    every run byte-equal to phase 3's uninterrupted rasters, with the
    server's counters == measured_counts and the traced lifecycles
    violation-free. Returns (launch counts, {what: stream-steps/s})."""
    from repro_torch.obs import MetricsRegistry, SpanTracer, reconstruct
    from repro_torch.serving.connector import (FileCarryConnector,
                                               InMemoryCarryConnector,
                                               migrate_stream)
    from repro_torch.serving.frontend import FrontendConfig
    from repro_torch.serving.qos import QoSClass, QoSPolicy

    nets = mnist_nets(np, feedforward, cfg)
    plan = serve_plan(np)
    names = ("mnist0", "mnist1")
    launched = {name: 0 for name in ops.LAUNCHES}
    rates = {}
    qos = QoSPolicy(classes={"mnist0": QoSClass(priority=1, weight=4),
                             "mnist1": QoSClass(priority=0, weight=1)},
                    preempt=True)

    def run(what, fn):
        """One path: counts to 0 just before it, read just after."""
        reset_launches(ops)
        t0 = time.perf_counter()
        got, metrics, tracer, sess, extra = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for name, n in ops.LAUNCHES.items():
            launched[name] += n
        kernel = "spike_timestep" if K == 1 else "spike_timestep_fused"
        check(ops.LAUNCHES[kernel] > 0, f"{what}: no {kernel} launch")
        check(set(got) == set(ref) and all(
            np.array_equal(got[u], ref[u]) for u in ref),
            f"{what}: rasters != phase 3's uninterrupted reference")
        sops, underflow = check_measured(np, sess, metrics, plan, got, what)
        if tracer is not None:
            rep = reconstruct(tracer)   # raises LifecycleViolation
            n_tl = len(rep.streams)
        else:
            n_tl = 0
        rates[what] = N_STREAMS * STREAM_T / dt
        log(f"{what}: {len(got)} rasters byte-equal to the uninterrupted "
            f"reference; counters == measured_counts ({sops:.0f} SOPs; "
            f"{underflow:.0f} more on weights that quantize to 0); "
            f"{n_tl} timelines violation-free; {extra}; "
            f"{N_STREAMS * STREAM_T} stream-steps in {dt:.2f} s; "
            f"LAUNCHES={dict(ops.LAUNCHES)}")

    for backend in ("cuda", "cuda-f32"):
        for K in (1, 8):
            tag = f"{backend}/K={K}"

            def migration():
                m, tr = MetricsRegistry(), SpanTracer()
                sess = front_session(session_cls, cfg, nets, backend, K,
                                     metrics=m, tracer=tr)
                moves = []

                def hook(views):
                    server = views["mnist0"].server
                    conn = InMemoryCarryConnector()
                    active = sorted(server.scheduler.active.items(),
                                    key=lambda kv: kv[1])
                    parked = None
                    if server.scheduler.free_slots == 0:
                        parked = active.pop(0)
                        server.detach_stream(parked[0], conn)
                    for uid, old in active:
                        migrate_stream(server, uid,
                                       slot=server.scheduler.free_slot_ids[-1])
                        moves.append((uid, old, server.slot_of(uid)))
                    if parked is not None:
                        uid, old = parked
                        slot = [s for s in server.scheduler.free_slot_ids
                                if s != old][0]
                        server.attach_stream(conn, uid, slot=slot)
                        moves.append((uid, old, slot))
                    check(all(a != b for _, a, b in moves),
                          "a migrated stream stayed in its slot")

                got = serve_hooked(np, serve_views(sess, names), plan, hook)
                return got, m, tr, sess, f"{len(moves)} live streams moved"

            def recovery():
                m = MetricsRegistry()
                sess = front_session(session_cls, cfg, nets, backend, K,
                                     metrics=m)
                box = {}
                tmp = tempfile.TemporaryDirectory()

                def hook(views):
                    root = tmp.name
                    uids = views["mnist0"].server.checkpoint_streams(
                        FileCarryConnector(root))
                    fresh = front_session(session_cls, cfg, nets, backend,
                                          K, metrics=m)
                    new_views = serve_views(fresh, names)
                    back = new_views["mnist0"].server.restore_streams(
                        FileCarryConnector(root))
                    check(sorted(back) == sorted(uids),
                          f"restored {back} of checkpointed {uids}")
                    box["n"], box["sess"] = len(back), fresh
                    return new_views

                got = serve_hooked(np, serve_views(sess, names), plan, hook)
                tmp.cleanup()
                return (got, m, None, box["sess"],
                        f"{box['n']} streams restored on a fresh server")

            def redeploy():
                m, tr = MetricsRegistry(), SpanTracer()
                sess = front_session(session_cls, cfg, nets, backend, K,
                                     metrics=m, tracer=tr)
                box = {}

                def hook(views):
                    live = set(views["mnist0"].server.scheduler.active)
                    sess.deploy("third", third_net(np, feedforward, cfg))
                    new_views = serve_views(sess, names)
                    back = set(new_views["mnist0"].server.scheduler.active)
                    check(back == live, "the redeploy lost a live stream")
                    box["n"] = len(live)
                    return new_views

                got = serve_hooked(np, serve_views(sess, names), plan, hook)
                check(m.counter("snn_session_redeploys_total").value == 1,
                      "no rolling redeploy counted")
                return got, m, tr, sess, (f"{box['n']} live streams across "
                                          f"a third model's deploy")

            def async_run(policy, deadline_every):
                def go():
                    m, tr = MetricsRegistry(), SpanTracer()
                    sess = front_session(session_cls, cfg, nets, backend, K,
                                         metrics=m, tracer=tr)
                    fe_cfg = FrontendConfig(queue_capacity=2 * N_STREAMS,
                                            spill=deadline_every > 0,
                                            qos=policy)
                    got, fm, wall = serve_async(np, sess, plan, fe_cfg,
                                                deadline_every)
                    c = fm["counts"]
                    return got, m, tr, sess, (
                        f"{c['done']} done, {c['parked']} parked, "
                        f"{c['resumed']} resumed, {c['evicted']} preempted, "
                        f"{fm['rounds']} pump rounds")
                return go

            run(f"migration {tag}", migration)
            run(f"recovery {tag}", recovery)
            run(f"rolling redeploy {tag}", redeploy)
            run(f"async FIFO {tag}", async_run(None, 0))
            run(f"async QoS+preempt {tag}", async_run(qos, 3))
    return launched, rates


def median_us(fn, n=100, setup=None):
    times = []
    for _ in range(n):
        if setup is not None:
            setup()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2] * 1e6


def phase_carry_times(np, torch, session_cls, feedforward, cfg):
    """Wall µs of one snapshot_stream, attach_stream, migrate_stream and
    one FileCarryConnector insert / select of a P = 1024 carry, on the
    served slice ("cuda", 7 of 8 slots live)."""
    from repro_torch.serving.connector import (FileCarryConnector,
                                               migrate_stream)

    sess = front_session(session_cls, cfg, mnist_nets(np, feedforward, cfg),
                         "cuda", 1)
    views = serve_views(sess, ("mnist0", "mnist1"))
    server = views["mnist0"].server
    streams, _ = serve_plan(np)
    for uid in range(N_SLOTS - 1):
        name, raster, _ = streams[uid]
        views[name].attach(uid)
        views[name].feed(uid, raster[:CHUNK])
    torch.cuda.synchronize()
    uid = 0
    out = {"snapshot_stream": median_us(lambda: server.snapshot_stream(uid))}
    snap = server.snapshot_stream(uid)
    out["attach_stream"] = median_us(
        lambda: server.attach_stream(snap, uid=uid),
        setup=lambda: server.detach(uid))
    slots = iter(range(10**6))
    out["migrate_stream"] = median_us(lambda: migrate_stream(
        server, uid, slot=server.scheduler.free_slot_ids[0]
        if next(slots) % 2 else server.scheduler.free_slot_ids[-1]))
    with tempfile.TemporaryDirectory() as root:
        conn = FileCarryConnector(root)
        out["FileCarryConnector.insert"] = median_us(
            lambda: conn.insert(uid, snap))
        out["FileCarryConnector.select"] = median_us(
            lambda: conn.select(uid))
    check(len(snap.to_bytes()) > 8 * 1024, "a P = 1024 carry is 8 KiB+")
    return out, len(snap.to_bytes())


def phase_front_door_entry_points(torch, ops):
    """serve_snn --async --qos ... --qos-preempt --connector DIR --metrics -
    --trace FILE --json-summary, and the sync --drain drill; then
    kernel_bench --async --qos --migrate --obs-overhead --json. Returns
    (launch counts, the bench's obs-overhead record)."""
    import contextlib
    import io

    from repro_torch.benchmarks import kernel_bench
    from repro_torch.launch import serve_snn
    from repro_torch.obs import reconstruct

    launched = {name: 0 for name in ops.LAUNCHES}
    base = ["--device", "cuda", "--backend", "cuda", "--models", "2",
            "--n-inputs", "784", "--n-neurons", "266",
            "--steps-per-stream", "100", "--seed", "0"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        for what, extra in (
                ("async", ["--async", "--arrival-rate", "2000",
                           "--qos", "hi=1:4,bg=0:1", "--qos-preempt",
                           "--burst", "hi", "--deadline-ms", "40",
                           "--slo-p99-ms", "50"]),
                # a third 784-266-10 net would not fit the array: 200
                ("drain", ["--drain", "4", "--fuse-steps", "8",
                           "--n-neurons", "200"])):
            reset_launches(ops)
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                summary = serve_snn.main(
                    base + extra + ["--connector", str(tmp / f"c-{what}"),
                                    "--metrics", "-", "--trace",
                                    str(tmp / f"{what}.jsonl"),
                                    "--json-summary"])
            torch.cuda.synchronize()
            for name, n in ops.LAUNCHES.items():
                launched[name] += n
            out = text.getvalue()
            check("snn_server_sops_total" in out and '"mode"' in out,
                  f"serve_snn {what}: no metrics or JSON summary on stdout")
            check(summary["launches"] == dict(ops.LAUNCHES),
                  f"serve_snn {what}: launch counts disagree")
            check(sum(summary["launches"].values()) > 0,
                  f"serve_snn {what} launched no kernel")
            rep = reconstruct(str(tmp / f"{what}.jsonl"))
            if what == "async":
                c = summary["frontend"]["counts"]
                check(c["submitted"] == 24, "serve_snn --async submissions")
                check(summary["server"]["steps"] == summary["steps"],
                      "serve_snn --async step counters disagree")
            else:
                check(summary["streams_done"] == 24 and
                      summary["steps"] == 2400, "serve_snn --drain lost work")
                check("hot-deployed" in out, "serve_snn --drain did not drain")
            log(f"serve_snn {what}: {summary['steps']} stream-steps at "
                f"{summary['steps_per_s']:.1f}/s, {len(rep.streams)} "
                f"timelines violation-free, LAUNCHES="
                f"{summary['launches']}")
        reset_launches(ops)
        kernel_bench.main(["--device", "cuda", "--backend", "cuda",
                           "--async", "--qos", "--migrate", "--obs-overhead",
                           "--json", str(tmp / "bench.json")])
        torch.cuda.synchronize()
        for name, n in ops.LAUNCHES.items():
            launched[name] += n
        doc = json.loads((tmp / "bench.json").read_text())
    check(doc["metadata"]["schema"] == 2, "kernel bench schema")
    recs = doc["results"]
    kinds = {r["kind"] for r in recs}
    check({"async_frontend", "qos_frontend", "migration",
           "obs_overhead"} <= kinds, f"kernel bench kinds {kinds}")
    qos = {r["scenario"]: r for r in recs if r["kind"] == "qos_frontend"}
    check(all(qos[s]["hi_p99_rounds"] < qos["fifo"]["hi_p99_rounds"]
              for s in ("wfq", "preempt")),
          "QoS did not isolate the burst class")
    obs = [r for r in recs if r["kind"] == "obs_overhead"][0]
    log(f"kernel_bench front door: {len(recs)} records; LAUNCHES="
        f"{dict(ops.LAUNCHES)}")
    return launched, obs


# --------------------------------------------------------------------------
MESH_SHAPES = ((2, 2), (2, 4))


def card_mesh(torch, make_spike_mesh, kn, kb):
    """A (kn, kb) mesh whose shards all share card 0."""
    return make_spike_mesh(kn, kb, devices=[torch.device("cuda", 0)]
                           * (kn * kb))


def phase_mesh_serve(np, torch, ops, session_cls, feedforward, cfg, refs,
                     ref_preds):
    """Phase 3's plan through ``AcceleratorSession(mesh=...)`` on a 2 x 2
    and a 2 x 4 mesh of card 0, on "cuda" / "cuda-f32" x both gates x
    ``fuse_steps`` 1 / 8: rasters and predictions byte-equal to phase 3's
    unsharded run, every shard launching the single-step kernel once a
    step (launches = chunk dispatches x chunk steps x shards) and no fused
    window. Returns (single-step launches, {what: stream-steps/s})."""
    from repro_torch.distributed.spike_mesh import (MeshSpikeEngine,
                                                    make_spike_mesh)

    nets = mnist_nets(np, feedforward, cfg)
    plan = serve_plan(np)
    total, rates = 0, {}
    for kn, kb in MESH_SHAPES:
        mesh = card_mesh(torch, make_spike_mesh, kn, kb)
        for gate in ("batch-tile", "per-example"):
            for backend in ("cuda", "cuda-f32"):
                for K in (1, 8):
                    what = f"mesh {kn}x{kb} {backend}/{gate}/K={K}"
                    reset_launches(ops)  # just before the main path
                    t0 = time.perf_counter()
                    got, pred, sess, dispatches = serve_once(
                        np, torch, session_cls, cfg, nets, backend, gate,
                        plan, fuse_steps=K, mesh=mesh)
                    torch.cuda.synchronize()
                    n = ops.LAUNCHES["spike_timestep"]  # just after it
                    n_fused = ops.LAUNCHES["spike_timestep_fused"]
                    dt = time.perf_counter() - t0
                    server = next(iter(sess._stream_servers.values()))
                    eng = server.engine
                    check(isinstance(eng, MeshSpikeEngine)
                          and eng.mesh == mesh and eng.fuse_steps == K
                          and eng.gate == gate,
                          f"{what}: the served engine is not the mesh's")
                    want = dispatches * CHUNK * kn * kb
                    check(n == want and n > 0,
                          f"{what}: {n} single-step launches, expected "
                          f"{want} (dispatches x steps x shards)")
                    check(n_fused == 0,
                          f"{what}: {n_fused} fused launches under a mesh")
                    check(all(np.array_equal(got[u], refs[gate][u])
                              for u in refs[gate]),
                          f"{what}: rasters != phase 3's unsharded run")
                    check(pred == ref_preds[gate],
                          f"{what}: predictions != phase 3's")
                    total += n
                    rates[what] = server.total_steps / dt
                    log(f"{what}: rasters and predictions byte-equal to "
                        f"phase 3 for {len(got)} streams; {n} single-step "
                        f"launches = {dispatches} dispatches x {CHUNK} "
                        f"steps x {kn * kb} shards, 0 fused; "
                        f"{server.total_steps} stream-steps in {dt:.2f} s")
    return total, rates


def phase_mesh_kernel_shapes(torch, ts, ops) -> int:
    """The single-step kernel against its plain version at the shapes a
    mesh shard gives it: a 2 x 2 shard of the slice (4 rows, 2592 sources,
    512 columns), a 2 x 4 shard (2 rows), and a ragged shard (3 of 5 rows,
    200 + 130 sources, 65 columns, padded to 128 on its own)."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    n_cases, worst = 0, 0
    for B, S, P in ((4, 2592, 512), (2, 2592, 512), (3, 330, 65)):
        for use_f32 in (False, True):
            hi = (1 << 16) if use_f32 else (1 << 31)
            W = torch.randint(-hi, hi, (S, P), generator=gen, device="cuda",
                              dtype=torch.int64).to(torch.int32)
            v = torch.randint(-(1 << 31), 1 << 31, (B, P), generator=gen,
                              device="cuda", dtype=torch.int64)
            v = v.to(torch.int32)
            for density in (0.02, 0.25):
                src = (torch.rand((B, S), generator=gen, device="cuda")
                       < density).to(torch.int32)
                for block_batch in (8, 1):
                    act, sp, wp, vp = padded_operands(torch, ops, src, W, v,
                                                      block_batch)
                    for reset in ("zero", "subtract", "hold"):
                        kw = dict(threshold_raw=1 << 16, reset_mode=reset,
                                  decay_kind="shift", decay_rate=0.25,
                                  decay_raw=0, use_f32=use_f32,
                                  block_batch=block_batch)
                        got = ts.spike_timestep_cuda(act, sp, wp, vp, **kw)
                        want = ts.spike_timestep_plain(act, sp, wp, vp, **kw)
                        torch.cuda.synchronize()
                        for g, w in zip(got, want):
                            err = int((g.to(torch.int64)
                                       - w.to(torch.int64)).abs().max())
                            worst = max(worst, err)
                            check(torch.equal(g, w),
                                  f"kernel != plain at shard shape B,S,P="
                                  f"{B},{S},{P} f32={use_f32} density="
                                  f"{density} block_batch={block_batch} "
                                  f"reset={reset}: max |diff| {err}")
                        n_cases += 1
    log(f"kernel == plain at the mesh shard shapes in all {n_cases} cases "
        f"(3 shard shapes incl. a 65-column ragged one x 2 modes x 2 "
        f"activities x 2 gates x 3 resets); max |diff| {worst}")
    return worst


def phase_mesh_carries(np, torch, session_cls, feedforward, cfg, refs):
    """A carry migrated into and out of a mesh server: stream 0 of phase
    3's plan starts on an unsharded server, moves to a 2 x 4 mesh server
    at step 40 and back at step 70; the stitched raster equals phase 3's."""
    from repro_torch.distributed.spike_mesh import make_spike_mesh
    from repro_torch.serving.connector import InMemoryCarryConnector

    nets = mnist_nets(np, feedforward, cfg)
    streams, _ = serve_plan(np)
    name, raster, _ = streams[0]
    views = []
    for mesh in (None, card_mesh(torch, make_spike_mesh, 2, 4)):
        sess = session_cls(cfg.ACCELERATOR, backend="cuda", device="cuda",
                           mesh=mesh)
        for n, net in nets.items():
            sess.deploy(n, net)
        views.append(sess.serve(name, n_slots=N_SLOTS, chunk_steps=CHUNK))
    plain, meshed = views
    conn = InMemoryCarryConnector()
    for v in views:  # occupy a few slots, so the carry lands mid-batch
        for i in range(5):
            v.attach(f"pad{i}")
    plain.attach(0)
    pieces = [plain.feed(0, raster[:40])["spikes"]]
    plain.server.detach_stream(0, conn)
    meshed.server.attach_stream(conn, 0)
    slot = meshed.slot_of(0)
    pieces.append(meshed.feed(0, raster[40:70])["spikes"])
    meshed.server.detach_stream(0, conn)
    plain.server.attach_stream(conn, 0)
    pieces.append(plain.feed(0, raster[70:])["spikes"])
    got = np.concatenate(pieces, axis=0)
    check(np.array_equal(got, refs["batch-tile"][0]),
          "a carry moved into and out of a 2x4 mesh server != phase 3")
    log(f"carry of stream 0 moved plain -> mesh 2x4 (slot {slot} of "
        f"{N_SLOTS}, batch shard {slot // (N_SLOTS // 4)}) -> plain: raster "
        f"byte-equal to phase 3 ({int(got.sum())} spikes)")


def phase_mesh_entry_points(torch, ops):
    """``serve_snn --devices 4 --mesh 2x2`` against ``--devices 1`` (same
    counters and rasters' statistics, four times the single-step
    launches, no fused one), then ``kernel_bench --devices 4 --mesh 2x2
    --streaming --json``. Returns the launch counts of the mesh runs."""
    import contextlib
    import io

    from repro_torch.benchmarks import kernel_bench
    from repro_torch.launch import serve_snn

    launched = {name: 0 for name in ops.LAUNCHES}
    base = ["--device", "cuda", "--backend", "cuda", "--models", "2",
            "--n-inputs", "784", "--n-neurons", "266",
            "--steps-per-stream", "100", "--seed", "0"]
    summaries = {}
    for devices in ((), ("--devices", "4", "--mesh", "2x2")):
        reset_launches(ops)
        with contextlib.redirect_stdout(io.StringIO()) as out:
            summary = serve_snn.main(base + list(devices) + ["--json-summary"])
        torch.cuda.synchronize()
        check(summary["launches"] == dict(ops.LAUNCHES),
              "serve_snn's launch counts disagree with the kernels'")
        summaries[len(devices)] = (summary, out.getvalue())
        if devices:
            for name, n in ops.LAUNCHES.items():
                launched[name] += n
    one, (many, text) = summaries[0][0], summaries[4]
    for key in ("streams_done", "steps", "rounds", "sparsity", "event_gate",
                "server", "energy"):
        check(many[key] == one[key], f"serve_snn --devices 4 {key} != "
                                     f"--devices 1")
    check(many["mesh"] == {"neuron": 2, "batch": 2, "shards": 4,
                           "physical_devices": ["cuda:0"]},
          f"serve_snn mesh summary {many['mesh']}")
    check("backed by 1 physical" in text, "serve_snn did not state the "
                                          "physical devices")
    n1, n4 = (s["launches"]["spike_timestep"] for s in (one, many))
    check(n4 == 4 * n1 > 0 and many["launches"]["spike_timestep_fused"] == 0,
          f"serve_snn --devices 4: {n4} launches vs {n1} unsharded")
    rep = many["straggler"]
    check(rep["n_shards"] == 2 and len(rep["flag_counts"]) == 2,
          f"serve_snn straggler watch {rep}")
    log(f"serve_snn --devices 4 --mesh 2x2: counters equal to --devices 1, "
        f"{n4} single-step launches = 4 x {n1}; {many['steps_per_s']:.1f} "
        f"vs {one['steps_per_s']:.1f} stream-steps/s; dispatch p50 "
        f"{rep['dispatch_ms']['p50']:.2f} vs "
        f"{one['straggler']['dispatch_ms']['p50']:.2f} ms; watch flags "
        f"{rep['flag_counts']}")
    with tempfile.TemporaryDirectory() as tmp:
        reset_launches(ops)
        kernel_bench.main(["--device", "cuda", "--backend", "cuda",
                           "--devices", "4", "--mesh", "2x2", "--streaming",
                           "--json", str(pathlib.Path(tmp) / "b.json")])
        torch.cuda.synchronize()
        for name, n in ops.LAUNCHES.items():
            launched[name] += n
        doc = json.loads((pathlib.Path(tmp) / "b.json").read_text())
    d4 = {r["name"]: r for r in doc["results"] if r["devices"] == 4}
    check(set(d4) == {"engine/timestep_cuda_d4",
                      "streaming/batch_scan_cuda_d4",
                      "streaming/feed_cuda_occ1_d4",
                      "streaming/feed_cuda_occ0.25_d4"},
          f"kernel_bench --devices 4 records {sorted(d4)}")
    check(ops.LAUNCHES["spike_timestep"] > 0, "kernel_bench --devices 4 "
                                              "launched no kernel")
    log("kernel_bench --devices 4 --mesh 2x2: "
        + ", ".join(f"{n} {r['us_per_call']:.1f} us" for n, r in
                    sorted(d4.items())))
    return launched, {n: r["us_per_call"] for n, r in d4.items()}


def host_breakdown(torch, fn, n, trace_path=None) -> dict:
    """Where the host's time of ``fn()`` goes, from a CPU + CUDA
    ``torch.profiler`` trace over ``n`` calls: the wall a call under the
    profiler, the host µs inside torch ops and CUDA API calls (self
    time), the rest (Python between ops), the ops and CUDA API calls a
    call issues, and the five costliest by self time. Writes the Chrome
    trace to ``trace_path`` when given."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e6
    host = [e for e in prof.key_averages()
            if getattr(e, "self_cpu_time_total", 0) > 0]
    in_ops = sum(e.self_cpu_time_total for e in host) / n
    api = [e for e in host if e.key.startswith(("cuda", "cu"))]
    top = sorted(host, key=lambda e: -e.self_cpu_time_total)[:5]
    if trace_path is not None:
        trace_path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(trace_path))
    return {"wall_us": wall, "in_ops_us": in_ops,
            "python_us": wall - in_ops,
            "ops": sum(e.count for e in host if e not in api) / n,
            "cuda_api_calls": sum(e.count for e in api) / n,
            "cuda_api_us": sum(e.self_cpu_time_total for e in api) / n,
            "top": [(e.key, e.count / n, e.self_cpu_time_total / n)
                    for e in top]}


def phase_mesh_times(np, torch, session_cls, feedforward, cfg):
    """The wall and device time of one step of the slice's 8-slot batch
    (``step_chunk`` of one step, "cuda", batch-tile) unsharded and on the
    2 x 2 and 2 x 4 meshes of card 0: five rounds of 50 calls each, the
    shapes in turn within a round (so a slower host slows every shape
    alike); then a profiler breakdown of the host's work a step, with the
    2 x 2 step's Chrome trace under ``chiprun_out/``. Returns ({what:
    [(device, wall, busy) a round]}, {what: breakdown})."""
    from repro_torch.distributed.spike_mesh import make_spike_mesh

    nets = mnist_nets(np, feedforward, cfg)
    sess = session_cls(cfg.ACCELERATOR, backend="cuda", device="cuda")
    for name, net in nets.items():
        sess.deploy(name, net)
    eng = sess._fused_engine(list(sess.models.values()))
    rng = np.random.default_rng(5)
    ext = torch.from_numpy((rng.random((1, N_SLOTS, eng.n_inputs)) < 0.1)
                           .astype(np.int32)).cuda()
    steps = {}
    for shape in ((1, 1),) + MESH_SHAPES:
        e = eng if shape == (1, 1) else eng.to_mesh(
            card_mesh(torch, make_spike_mesh, *shape))
        carry = e.init_carry(N_SLOTS)
        for _ in range(20):  # a warm carry: the slice has been stepping
            carry, _ = e.step_chunk(carry, ext)
        what = ("unsharded" if shape == (1, 1)
                else f"mesh {shape[0]}x{shape[1]}")
        steps[what] = lambda e=e, c=carry: e.step_chunk(c, ext)
    times = {what: [] for what in steps}
    for _ in range(5):
        for what, fn in steps.items():
            times[what].append(device_and_wall_us(torch, fn, 50))
    trace = ROOT / "chiprun_out" / "mesh_step_2x2.trace.json"
    breakdown = {what: host_breakdown(
        torch, fn, 20, trace if what == "mesh 2x2" else None)
        for what, fn in steps.items()}
    for what, b in breakdown.items():
        log(f"host breakdown of one step, {what} (profiler, 20 steps): "
            f"wall {b['wall_us']:.1f} us, in torch ops and CUDA API "
            f"{b['in_ops_us']:.1f} us, Python between them "
            f"{b['python_us']:.1f} us; {b['ops']:.0f} ops and "
            f"{b['cuda_api_calls']:.0f} CUDA API calls "
            f"({b['cuda_api_us']:.1f} us) a step; costliest: "
            + "; ".join(f"{k} x{c:.0f} {u:.1f} us" for k, c, u in b["top"]))
    log(f"the 2 x 2 step's Chrome trace: {trace.relative_to(ROOT)}")
    return times, breakdown


# --------------------------------------------------------------------------
# phase 9: training and the paper's HW-vs-SW deviation on the card
# --------------------------------------------------------------------------
TRAIN_HIDDEN = 256   # the paper's 784-256-10 net
EVAL_DIGITS = 1024   # procedural test digits for evaluate_dual
RESUME_AT = 150      # the checkpoint step of the resumed run
TRAIN_SHARDS = 2     # shards of card 0 for make_sharded_train_step
GRAD_RTOL = 1e-4     # card vs host grads: rtol, and atol GRAD_RTOL x max|g|
LOSS_RTOL = 1e-5     # card vs host loss (float sums in another order)
STEP_TIMES = 21      # train steps timed, median
ADAM_EPS = 1e-8      # optimizers.adam's default eps


def grads_close(np, got, want, what) -> float:
    """|got - want| <= GRAD_RTOL * (|want| + max|want|) per leaf; returns
    the worst ratio of the difference to that tolerance."""
    worst = 0.0
    for g, w in zip(got, want):
        g, w = g.detach().cpu().numpy(), w.detach().cpu().numpy()
        tol = GRAD_RTOL * (np.abs(w) + np.abs(w).max())
        worst = max(worst, float((np.abs(g - w) / tol).max()))
    check(worst <= 1.0, f"{what}: grads differ by {worst:.3f} x tolerance")
    return worst


def first_step_close(np, got, want, m_want, lr, eps, what) -> float:
    """Params after Adam's first step, ``p - lr * g / (|g| + eps)`` with
    ``g = m / (1 - b1)`` the clipped gradient: a gradient ``delta =
    GRAD_RTOL * (|g| + max|g|)`` apart moves the update by at most ``lr *
    min(2, eps * delta / (max(|g| - delta, 0) + eps)^2)``; plus one float32
    rounding of a param in [-1, 1] (2^-23). Returns the worst ratio."""
    worst = 0.0
    for a, b, m in zip(got, want, m_want):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        g = np.abs(m.cpu().numpy().astype(np.float64)) / 0.1
        delta = GRAD_RTOL * (g + g.max())
        bound = lr * np.minimum(2.0, eps * delta / (
            np.maximum(g - delta, 0.0) + eps) ** 2) + 2.0 ** -23
        worst = max(worst, float((np.abs(a - b) / bound).max()))
    check(worst <= 1.0, f"{what}: params {worst:.3f} x the first step's "
          f"bound apart")
    return worst


def median_times_ms(torch, fn, n) -> tuple[float, float]:
    """Median over ``n`` calls (after one warm-up) of the device time
    between CUDA events around a call and of its synchronized wall time."""
    fn()
    torch.cuda.synchronize()
    dev, wall = [], []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        dev.append(start.elapsed_time(end))
    return sorted(dev)[n // 2], sorted(wall)[n // 2]


def phase_training(np, torch, ops, cfg, card) -> dict:
    """Train 784-256-10 on the card (T 25, batch 128, 300 steps, lr 2e-3,
    procedural digits); its first step against the host's; a checkpointed
    resume; the data-parallel step on two shards of card 0; and
    ``evaluate_dual`` on 1024 test digits on "cuda" and "cuda-f32", the
    hardware half byte-equal to the card's and the host's "reference"."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.core import coding, energy, prng
    from repro_torch.data import mnist
    from repro_torch.snn import model as sm
    from repro_torch.snn import train as st
    from repro_torch.training import optimizers
    from repro_torch.tree import tree_map

    tcfg = st.TrainConfig(model=cfg.model_config(TRAIN_HIDDEN))
    B, T, n = tcfg.batch_size, tcfg.num_steps_time, tcfg.train_steps
    lr = tcfg.lr
    opt = optimizers.adam(lr)
    k0, key = prng.split(prng.key(tcfg.seed))
    p_host = sm.init_params(k0, tcfg.model, device="cpu")
    p_card = sm.init_params(k0, tcfg.model, device="cuda")
    init_diff = max(float((a.cpu() - b).abs().max())
                    for a, b in zip(p_card, p_host))
    check(init_diff <= 1e-6, f"init_params card vs host: {init_diff}")
    p0 = [w.cuda() for w in p_host]  # both sides start from the host's
    batches = list(mnist.batches("train", B, n, seed=0))
    _, x0, y0 = batches[0]
    xh, yh = torch.from_numpy(x0), torch.from_numpy(y0)
    xc, yc = xh.cuda(), yh.cuda()
    k = prng.fold_in(key, 0)

    # the first step, card against host, with TF32 switched on globally:
    # the training products must not use it
    spikes_h = coding.poisson_encode(k, xh, T)
    spikes_c = coding.poisson_encode(k, xc, T)
    check(torch.equal(spikes_c.cpu(), spikes_h), "train spikes card != host")
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        g_h, m_h = st.loss_grads(p_host, spikes_h, yh, tcfg)
        g_c, m_c = st.loss_grads(p0, spikes_c, yc, tcfg)
        step = st.make_train_step(tcfg, opt)
        ph, sh, _ = step(p_host, opt.init(p_host), k, xh, yh)
        pc, sc, mc = step(p0, opt.init(p0), k, xc, yc)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
    loss_rel = abs(float(m_c["loss"]) / float(m_h["loss"]) - 1)
    check(loss_rel <= LOSS_RTOL, f"first step loss card vs host {loss_rel}")
    check(float(m_c["acc"]) == float(m_h["acc"]), "first step acc")
    g_worst = grads_close(np, g_c, g_h, "first step card vs host")
    p_worst = first_step_close(np, pc, ph, sh["m"], lr, ADAM_EPS,
                               "first step card vs host")
    log(f"first train step, card vs host (TF32 on globally): loss "
        f"{float(m_c['loss']):.6f} vs {float(m_h['loss']):.6f} (rel "
        f"{loss_rel:.2e} <= {LOSS_RTOL}), grads within {g_worst:.3f} of "
        f"rtol {GRAD_RTOL} + atol {GRAD_RTOL} x max|g|, params within "
        f"{p_worst:.3f} of the first step's bound; init_params card vs "
        f"host {init_diff:.2e}")

    # data-parallel: two shards of card 0 against the unsharded step
    sharded = st.make_sharded_train_step(tcfg, opt, ["cuda:0"] * TRAIN_SHARDS)
    # the loss is a mean of the shard losses and Adam's first update is
    # near lr * sign(g), so neither sees how the shard grads were weighted:
    # the gradient norm and Adam's first moment (0.1 x the clipped grads) do
    ps, ss, ms = sharded(p0, opt.init(p0), k, xc, yc)
    s_rel = {m: abs(float(ms[m]) / float(mc[m]) - 1)
             for m in ("loss", "grad_norm")}
    for m, rel in s_rel.items():
        check(rel <= LOSS_RTOL, f"sharded {m} rel {rel} > {LOSS_RTOL}")
    m_worst = grads_close(np, ss["m"], sc["m"], "sharded vs unsharded m")
    s_worst = first_step_close(np, ps, pc, sc["m"], lr, ADAM_EPS,
                               "sharded vs unsharded")
    log(f"make_sharded_train_step on {TRAIN_SHARDS} shards of card 0 == "
        f"unsharded: loss rel {s_rel['loss']:.2e}, grad_norm rel "
        f"{s_rel['grad_norm']:.2e} (<= {LOSS_RTOL}), Adam m within "
        f"{m_worst:.3f} of rtol {GRAD_RTOL} + atol {GRAD_RTOL} x max|m|, "
        f"params within {s_worst:.3f} of the first step's bound")

    # the train step's device and wall time (median of STEP_TIMES)
    s0 = opt.init(p0)
    step_ms = median_times_ms(torch, lambda: step(p0, s0, k, xc, yc),
                              STEP_TIMES)
    _, _, step_busy_us = device_and_wall_us(
        torch, lambda: step(p0, s0, k, xc, yc), 5)

    # train, then resume from a checkpoint at RESUME_AT
    t0 = time.perf_counter()
    p_full, _, m_full = st.train(tcfg, iter(batches), device="cuda",
                                 log_every=50, log_fn=log)
    train_s = time.perf_counter() - t0
    check(all(float(w.abs().max()) <= tcfg.model.weight_clip
              for w in p_full), "trained weights outside the clip")
    p_half, s_half, _ = st.train(tcfg, iter(batches[:RESUME_AT]),
                                 device="cuda", log_every=0)
    like = {"params": p_half, "opt": s_half}
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, RESUME_AT, like)
        restored, _ = ckpt.load(d, RESUME_AT, like=like, device_tree=tree_map(
            lambda x: x.device, like))
    p_res, _, _ = st.train(tcfg, iter(batches[RESUME_AT:]),
                           params=restored["params"],
                           opt_state=restored["opt"], device="cuda",
                           log_every=0)
    resume_diff = max(float((a - b).abs().max())
                      for a, b in zip(p_res, p_full))
    check(resume_diff <= 1e-6, f"resumed run {resume_diff} off the "
          f"uninterrupted one")
    log(f"trained {n} steps on the card in {train_s:.1f} s (last batch "
        f"loss {float(m_full['loss']):.4f}, acc {float(m_full['acc']):.3f});"
        f" resumed from a checkpoint at step {RESUME_AT}: max |diff| "
        f"{resume_diff:.2e} (atol 1e-6)")

    # evaluate_dual: the hardware half on the kernels, == the references;
    # procedural test digits, whatever IDX files the machine holds
    x, y = mnist.generate("test", EVAL_DIGITS, seed=1)
    host = st.evaluate_dual([w.cpu() for w in p_full], tcfg.model, x, y,
                            num_steps_time=T, backend="reference",
                            device="cpu")
    results, launches = {}, {}
    for backend in ("reference", "cuda", "cuda-f32"):
        reset_launches(ops)  # just before the path
        res = st.evaluate_dual(p_full, tcfg.model, x, y, num_steps_time=T,
                               backend=backend, device="cuda")
        torch.cuda.synchronize()
        launches[backend] = dict(ops.LAUNCHES)  # just after it
        results[backend] = res
        for ref_name, ref in (("host reference", host),
                              ("card reference", results["reference"])):
            for kk in ("output_counts", "spikes", "cycles", "sops",
                       "row_fetches"):
                check(torch.equal(res["hw_counts"][kk].cpu(),
                                  ref["hw_counts"][kk].cpu()),
                      f"evaluate_dual {backend}: {kk} != {ref_name}")
            check(res["hardware_acc"] == ref["hardware_acc"],
                  f"evaluate_dual {backend}: hardware_acc != {ref_name}")
        check(abs(res["software_acc"] - host["software_acc"]) <= 0.01,
              f"evaluate_dual {backend}: software_acc card "
              f"{res['software_acc']} vs host {host['software_acc']}")
    for backend in ("cuda", "cuda-f32"):
        got = launches[backend]
        check(got["spike_timestep"] == T and got["spike_timestep_fused"] == 0,
              f"evaluate_dual {backend} launched {got}")
    check(launches["reference"]["spike_timestep"] == 0,
          f"evaluate_dual reference launched {launches['reference']}")
    log(f"evaluate_dual, {EVAL_DIGITS} digits x T {T}: cuda and cuda-f32 "
        f"== card and host reference in counts, predictions, raster, "
        f"cycles and SOPs; LAUNCHES cuda {launches['cuda']}, cuda-f32 "
        f"{launches['cuda-f32']}, reference {launches['reference']}")
    res = results["cuda"]
    hw = {kk: v.cpu() for kk, v in res["hw_counts"].items()}
    uj = energy.EnergyModel.calibrated().energy_uj(
        energy.counts_from_run(hw))
    def evaluate():
        st.evaluate_dual(p_full, tcfg.model, x, y, num_steps_time=T,
                         backend="cuda", device="cuda")

    eval_ms = median_times_ms(torch, evaluate, 3)
    _, _, eval_busy_us = device_and_wall_us(torch, evaluate, 2)
    out = {
        "software_acc": res["software_acc"],
        "hardware_acc": res["hardware_acc"],
        "deviation_pct": res["deviation_pct"],
        "agreement": res["agreement"],
        "host_software_acc": host["software_acc"],
        "sops": float(hw["sops"].sum()),
        "pj_per_sop_system": uj["pj_per_sop_system"],
        "pj_per_sop_compute": uj["pj_per_sop_compute"],
        "train_step_device_ms": step_ms[0],
        "train_step_wall_ms": step_ms[1],
        "train_step_busy_ms": step_busy_us / 1e3,
        "evaluate_dual_device_ms": eval_ms[0],
        "evaluate_dual_wall_ms": eval_ms[1],
        "evaluate_dual_busy_ms": eval_busy_us / 1e3,
        "train_s": train_s,
        "resume_max_abs_diff": resume_diff,
        "launches": launches["cuda"]["spike_timestep"]
        + launches["cuda-f32"]["spike_timestep"],
    }
    log(f"784-{TRAIN_HIDDEN}-10 T {T}: software_acc {out['software_acc']:.4f}"
        f", hardware_acc {out['hardware_acc']:.4f}, deviation_pct "
        f"{out['deviation_pct']:+.4f}, agreement {out['agreement']:.4f} "
        f"({card})")
    log(f"time one train step (batch {B}, T {T}): device {step_ms[0]:.3f} ms "
        f"between events, wall {step_ms[1]:.3f} ms, median of {STEP_TIMES}; "
        f"device busy {step_busy_us / 1e3:.3f} ms "
        f"({100 * step_busy_us / 1e3 / step_ms[1]:.1f} % of wall) "
        f"({card})")
    log(f"time one evaluate_dual ({EVAL_DIGITS} digits x T {T}, cuda): "
        f"device {eval_ms[0]:.1f} ms between events, wall {eval_ms[1]:.1f} "
        f"ms, median of 3; device busy {eval_busy_us / 1e3:.1f} ms "
        f"({100 * eval_busy_us / 1e3 / eval_ms[1]:.1f} % of wall) ({card})")
    log(f"energy (Table V model) on the measured {out['sops']:.0f} SOPs: "
        f"{out['pj_per_sop_system']:.3f} pJ/SOP system incl. static, "
        f"{out['pj_per_sop_compute']} pJ/SOP compute ({card})")
    return out


# --------------------------------------------------------------------------
# phase 10: the paper's tables on the card
# --------------------------------------------------------------------------
FAST_TABLE_V_STEPS = 50     # benchmarks/run.py --fast budgets
FAST_SPEEDUP_STEPS = 25
FAST_EVAL_N = 256
TABLE_IV_T = 25             # the width sweep's (train_T, infer_T)
TABLE_V_HIDDEN, TABLE_V_BATCH = 128, 64   # table_v_power's defaults
HW_KEYS = ("output_counts", "spikes", "cycles", "sops", "row_fetches")


def phase_tables(np, torch, ops, card) -> dict:
    """``repro_torch.benchmarks.run --fast`` with Table III, Table V, the
    S-vs-H speedup and the five-width Table IV on the card (the kernel
    backend "cuda"), its launches counted around it; then Table V on
    "reference" (counts and mW equal) and with ``--measured-sop``, the
    speedup on "cuda-f32" and "reference" (cycles equal), and each Table
    IV row's hardware half on the card's "reference" (byte-equal)."""
    from repro_torch.benchmarks import run as brun
    from repro_torch.benchmarks import speedup_s_vs_h as sp
    from repro_torch.benchmarks import table_iv_accuracy as t4
    from repro_torch.benchmarks import table_v_power as t5
    from repro_torch.core import cerebra_h, coding, prng
    from repro_torch.data import mnist
    from repro_torch.events import trace
    from repro_torch.snn.model import init_params, to_snnetwork

    reset_launches(ops)  # just before the path
    t0 = time.perf_counter()
    out = brun.main(["--fast", "--only", "table_iii,table_v,speedup,table_iv",
                     "--device", "cuda"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)  # just after it
    rows = out["table_iv"]
    check([r["hidden"] for r in rows] == list(t4.HIDDEN_SIZES),
          f"table_iv rows {[r['hidden'] for r in rows]}")
    want = (FAST_TABLE_V_STEPS + 2 * FAST_SPEEDUP_STEPS
            + len(rows) * TABLE_IV_T)
    check(launches["spike_timestep"] == want
          and launches["spike_timestep_fused"] == 0,
          f"the tables launched {launches}; want {want} single-step")
    check(out["table_iii"][0][6] == 1.05, "Table III: SNAP-V's pJ/SOP")

    # Table IV: every row's hardware half == the card's reference backend
    for r in rows:
        cfg = t4.cell_config(r["hidden"], r["train_T"], 0)
        ref = t4.evaluate_cell(r["params"], cfg, r["infer_T"],
                               eval_n=FAST_EVAL_N, backend="reference",
                               device="cuda")
        for k in HW_KEYS:
            check(torch.equal(r["hw_counts"][k], ref["hw_counts"][k]),
                  f"table_iv h{r['hidden']}: {k} cuda != reference")
        check(r["hardware_acc"] == ref["hardware_acc"]
              and r["software_acc"] == ref["software_acc"],
              f"table_iv h{r['hidden']}: accuracy cuda != reference")
        check(0.0 < r["software_acc"] <= 1.0 and 0.0 < r["hardware_acc"]
              <= 1.0, f"table_iv h{r['hidden']}: accuracies {r}")
    devs = [r["deviation_pct"] for r in rows]

    # Table V: the reference backend gives the same counts and mW
    tv = out["table_v"]
    tv_ref = t5.main(["--steps", str(FAST_TABLE_V_STEPS), "--backend",
                      "reference", "--device", "cuda"])
    for f in ("sops", "row_fetches", "spike_packets", "cycles"):
        check(getattr(tv["counts"], f) == getattr(tv_ref["counts"], f),
              f"table_v {f}: cuda != reference")
    check(tv["mw"] == tv_ref["mw"], "table_v mW: cuda != reference")
    tv_m = t5.main(["--steps", str(FAST_TABLE_V_STEPS), "--measured-sop",
                    "--device", "cuda"])
    # ROADMAP fault 7: the measured SOPs price events by float-nonzero
    # synapses; the trace's own count uses the quantized image
    cfg5 = t5.model_config(TABLE_V_HIDDEN)
    x, _ = mnist.load_or_generate("test", TABLE_V_BATCH, seed=0)
    spikes = coding.poisson_encode(prng.key(1), torch.from_numpy(x).cuda(),
                                   FAST_TABLE_V_STEPS, dtype=torch.int32)
    prog = cerebra_h.compile_network(to_snnetwork(
        init_params(prng.key(0), cfg5, device="cuda"), cfg5))
    hw = cerebra_h.run(prog, spikes, backend="cuda", device="cuda")
    rep = trace.trace_run(cerebra_h.make_engine(prog, "cuda", device="cuda"),
                          spikes, hw["spikes"])
    quantized_sops = rep.measured_sops
    check(tv_m["counts"].sops >= quantized_sops,
          "measured SOPs below the quantized synapses' count")

    # speedup: the same cycles on every backend
    spd = out["speedup"]
    for backend in ("cuda-f32", "reference"):
        other = sp.main(["--steps", str(FAST_SPEEDUP_STEPS), "--backend",
                         backend, "--device", "cuda"])
        for k in ("cycles_s", "cycles_h"):
            check(np.array_equal(other[k], spd[k]),
                  f"speedup {k}: {backend} != cuda")
        check(other["report"] == spd["report"], f"speedup {backend} report")

    res = {
        "launches": launches["spike_timestep"],
        "wall_s": wall_s,
        "table_iv": [{k: r[k] for k in ("hidden", "train_T", "infer_T",
                                        "software_acc", "hardware_acc",
                                        "deviation_pct", "agreement")}
                     for r in rows],
        "avg_deviation_pp": float(np.mean(devs)),
        "compute_pj_per_sop": float(tv["mw"]["compute_pj_per_sop"]),
        "system_pj_per_sop": float(tv["uj"]["pj_per_sop_system"]),
        "measured_system_pj_per_sop": float(
            tv_m["uj"]["pj_per_sop_system"]),
        "weight_memory_pct": float(tv["mw"]["weight_memory_pct"]),
        "analytic_sops": float(tv_m["analytic"].sops),
        "measured_sops": float(tv_m["counts"].sops),
        "quantized_sops": int(quantized_sops),
        "deltas_pct": {k: float(v) for k, v in tv_m["deltas"].items()},
        "cycle_speedup": float(spd["report"].cycle_speedup),
        "total_speedup": float(spd["report"].total_speedup),
    }
    for r in res["table_iv"]:
        log(f"table_iv h{r['hidden']} T {r['train_T']}x{r['infer_T']} "
            f"(procedural digits, 60 steps, {FAST_EVAL_N} test digits): "
            f"software {r['software_acc']:.4f}, hardware "
            f"{r['hardware_acc']:.4f}, deviation {r['deviation_pct']:+.4f} "
            f"pp, agreement {r['agreement']:.4f} ({card})")
    log(f"table_iv average deviation {res['avg_deviation_pp']:+.4f} pp over "
        f"{len(rows)} widths (the paper: -2.62 on MNIST); hardware half == "
        f"the card's reference on every row ({card})")
    log(f"table_v ({TABLE_V_HIDDEN} hidden, B {TABLE_V_BATCH} x T "
        f"{FAST_TABLE_V_STEPS}): compute {res['compute_pj_per_sop']:.4f} "
        f"pJ/SOP, system {res['system_pj_per_sop']:.4f} pJ/SOP analytic, "
        f"{res['measured_system_pj_per_sop']:.4f} measured; weight memory "
        f"{res['weight_memory_pct']:.2f} % of power; SOPs analytic "
        f"{res['analytic_sops']:.0f}, measured (float-nonzero synapses) "
        f"{res['measured_sops']:.0f}, on quantized synapses "
        f"{quantized_sops} ({card})")
    log(f"speedup: cycles {res['cycle_speedup']:.4f}x, total "
        f"{res['total_speedup']:.4f}x; cycles equal on cuda, cuda-f32 and "
        f"reference ({card})")
    log(f"tables: run.py --fast (4 sections) in {wall_s:.1f} s, "
        f"{res['launches']} spike_timestep launches ({card})")
    return res


# --------------------------------------------------------------------------
# phase 11: the dense LM serving path at full width
# --------------------------------------------------------------------------
LM_ARCH = "granite-3-2b"
LM_CHECK = (2, 12, 6)       # B, S, prefill length of the teacher-forcing check
LM_DECODE_TOL = 2e-3        # tests/test_models.py's prefill / decode rtol, atol
LM_CUT_LAYERS = 2
LM_CUT_TOL = 1e-3           # the cut's card vs host logits: rtol and atol
LM_STEP_TIMES = 21          # decode steps timed, median
LM_STEP_BATCH, LM_STEP_SEQ = 4, 48


def worst_ratio(got, want, tol) -> float:
    """max |got - want| / (tol + tol |want|) over all elements."""
    got, want = got.double().cpu(), want.double().cpu()
    return float(((got - want).abs() / (tol + tol * want.abs())).max())


def phase_lm(np, torch, card) -> dict:
    """granite-3-2b at full width on the card: the param count against the
    leaves; ``launch.serve --full`` with the launcher's defaults in bf16
    (tokens/s, per-batch latency, one decode step's device and wall time,
    memory peak); float32 prefill + decode against teacher forcing (IEEE
    float32 products); a two-layer cut, card against host."""
    import dataclasses
    import gc

    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.device import ieee_fp32_matmul
    from repro_torch.launch import serve
    from repro_torch.launch.steps import LMHarness
    from repro_torch.tree import flatten_with_paths, tree_map

    mod = configs.get_arch(LM_ARCH)
    cfg = mod.CONFIG
    leaves = [t for _, t in flatten_with_paths(
        LMHarness(LM_ARCH, cfg=cfg).param_shapes())]
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    check(n_params == cfg.param_count(),
          f"{LM_ARCH}: {n_params} leaves != param_count {cfg.param_count()}")

    # the launcher, bf16, its defaults (12 requests, max-batch 4, max-new
    # 16, max-seq 96)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = serve.main(["--arch", LM_ARCH, "--full", "--device", "cuda"])
    torch.cuda.synchronize()
    serve_peak = torch.cuda.max_memory_allocated()
    server = res.pop("server")
    n_tok = sum(len(t) for b in res["batches"] for t in b["tokens"])
    check(n_tok == res["total_tokens"] == 12 * 16,
          f"served {n_tok} tokens, want {12 * 16}")
    check(all(0 <= int(t.min()) and int(t.max()) < cfg.vocab_size
              for b in res["batches"] for t in b["tokens"]),
          "a served token outside the vocabulary")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (LM_STEP_BATCH, LM_STEP_SEQ)).astype(np.int32))
    tok, cache = server._prefill(server.params, toks.cuda(),
                                 batch=LM_STEP_BATCH, seq=LM_STEP_SEQ)

    def step():
        server._decode_step(server.params, cache, tok, LM_STEP_SEQ)

    step_ms = median_times_ms(torch, step, LM_STEP_TIMES)
    _, _, step_busy_us = device_and_wall_us(torch, step, 5)
    del server, cache, tok
    gc.collect()
    torch.cuda.empty_cache()

    # float32 at full width: prefill + decode == teacher forcing
    torch.cuda.reset_peak_memory_stats()
    model = mod.build(dataclasses.replace(cfg, dtype=torch.float32))
    t0 = time.perf_counter()
    params = model.init(prng.key(1), device="cuda")
    torch.cuda.synchronize()
    init32_s = time.perf_counter() - t0
    B, S, k = LM_CHECK
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, S)).astype(
        np.int32)).cuda()
    with ieee_fp32_matmul(), torch.inference_mode():
        full, _ = model.forward(params, {"tokens": toks})
        check(bool(torch.isfinite(full).all()), "float32 logits not finite")
        cache = model.init_cache(B, S, device="cuda")
        logits, cache = model.prefill(params, {"tokens": toks[:, :k]},
                                      cache)
        decode_worst = worst_ratio(logits[:, 0], full[:, k - 1],
                                   LM_DECODE_TOL)
        for pos in range(k, S):
            logits, cache = model.decode_step(
                params, {"tokens": toks[:, pos:pos + 1]}, pos, cache)
            decode_worst = max(decode_worst, worst_ratio(
                logits[:, 0], full[:, pos], LM_DECODE_TOL))
    f32_peak = torch.cuda.max_memory_allocated()
    check(decode_worst <= 1.0, f"float32 prefill / decode off teacher "
          f"forcing by {decode_worst:.3f} x the tolerance")
    del params, cache, full, logits
    gc.collect()
    torch.cuda.empty_cache()

    # a two-layer cut of full width, card against host
    cut = mod.build(dataclasses.replace(cfg, dtype=torch.float32,
                                        n_layers=LM_CUT_LAYERS))
    p_card = cut.init(prng.key(2), device="cuda")
    p_host = tree_map(lambda t: t.cpu(), p_card)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (2, 8)).astype(
        np.int32))
    with ieee_fp32_matmul(), torch.inference_mode():
        lc, _ = cut.forward(p_card, {"tokens": toks.cuda()})
        lh, _ = cut.forward(p_host, {"tokens": toks})
    cut_worst = worst_ratio(lc, lh, LM_CUT_TOL)
    cut_abs = float((lc.cpu() - lh).abs().max())
    check(cut_worst <= 1.0, f"the {LM_CUT_LAYERS}-layer cut: card vs host "
          f"{cut_worst:.3f} x the tolerance")
    del p_card, p_host
    gc.collect()
    torch.cuda.empty_cache()

    out = {
        "params": n_params, "param_bytes": param_bytes,
        "init_s": res["init_s"], "init32_s": init32_s,
        "serve_peak_bytes": serve_peak, "f32_peak_bytes": f32_peak,
        "tokens_per_s": res["tokens_per_s"], "total_tokens": n_tok,
        "wall_s": res["wall_s"],
        "batch_latency_s": [b["latency_s"] for b in res["batches"]],
        "batch_tokens_per_s": [b["tokens_per_s"] for b in res["batches"]],
        "decode_step_device_ms": step_ms[0],
        "decode_step_wall_ms": step_ms[1],
        "decode_step_busy_ms": step_busy_us / 1e3,
        "decode_worst": decode_worst, "cut_worst": cut_worst,
        "cut_max_abs": cut_abs,
    }
    log(f"{LM_ARCH}: {n_params} params == param_count, {param_bytes} bytes "
        f"in bf16; init {res['init_s']:.2f} s (bf16), {init32_s:.2f} s "
        f"(float32) ({card})")
    log(f"{LM_ARCH} serve (bf16, 12 requests, max-batch 4, max-new 16, "
        f"max-seq 96): {n_tok} tokens in {res['wall_s']:.3f} s, "
        f"{res['tokens_per_s']:.1f} tokens/s; per-batch latency "
        + ", ".join(f"{t:.3f}" for t in out["batch_latency_s"])
        + f" s; memory peak {serve_peak / 2**30:.2f} GiB ({card})")
    log(f"{LM_ARCH} one decode step (B {LM_STEP_BATCH}, position "
        f"{LM_STEP_SEQ} of a 96-slot cache, bf16): device {step_ms[0]:.3f} ms between events, wall {step_ms[1]:.3f} "
        f"ms, median of {LM_STEP_TIMES}; device busy "
        f"{step_busy_us / 1e3:.3f} ms ({100 * step_busy_us / 1e3 / step_ms[1]:.1f}"
        f" % of wall) ({card})")
    log(f"{LM_ARCH} float32 (IEEE products): prefill {k} + decode to {S} "
        f"within {decode_worst:.4f} of rtol/atol {LM_DECODE_TOL} of the "
        f"teacher-forced logits; memory peak {f32_peak / 2**30:.2f} GiB; "
        f"{LM_CUT_LAYERS}-layer cut card vs host max |diff| {cut_abs:.3e}, "
        f"{cut_worst:.4f} of rtol/atol {LM_CUT_TOL} ({card})")
    return out


# --------------------------------------------------------------------------
# phase 12: the attention-family LM blocks at full width
# --------------------------------------------------------------------------
ZOO_SERVED = ("gemma3-12b", "minicpm3-4b")  # whole, through launch.serve
ZOO_MIXTRAL_LAYERS = 8      # of 32: the whole, 93.4 GB in bf16, exceeds a card
ZOO_SCOUT_LAYERS = 2        # of 48: the whole is 215.5 GB in bf16
ZOO_SCOUT = (4, 48, 16)     # llama4-scout: batch, prompt tokens, new tokens
ZOO_VL = (4, 48, 16)        # qwen2-vl-2b: batch, prompt embeddings, new tokens
# float32 depth cuts of full width for teacher forcing and card vs host:
# gemma3 keeps two [local x 5, global] groups, so a global layer is in it;
# llama4-scout one layer, or its host copy would exceed 25 GB
ZOO_CUTS = {"gemma3-12b": 12, "minicpm3-4b": 2, "mixtral-8x7b": 2,
            "llama4-scout-17b-a16e": 1, "qwen2-vl-2b": 2}


def free_card(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def uncounted_norms(cfg) -> int:
    """The norm scales the analytic ``param_count`` leaves out: q/k norm
    and MLA's two latent norms, per layer."""
    per = 2 * cfg.resolved_head_dim if cfg.qk_norm else 0
    if cfg.mla is not None:
        per += cfg.mla.q_lora_rank + cfg.mla.kv_lora_rank
    return cfg.n_layers * per


# the JAX package's leaves of these archs' CONFIGs (its ``LMHarness.
# param_shapes`` on the CPU): its analytic ``param_count`` does not
# describe them (zamba2's shared block and LoRA, rwkv6's mixes and decay,
# whisper's encoder and position table)
JAX_LEAVES = {"zamba2-1.2b": 1106350208, "rwkv6-7b": 7534415872,
              "whisper-large-v3": 1577530880}


def lm_size(arch, cfg) -> tuple[int, int]:
    """(params, bytes) of ``cfg``'s leaves, drawn on ``meta``; the count
    must be ``param_count()`` plus the norm scales it leaves out, or, for
    the archs of JAX_LEAVES, the JAX package's leaves."""
    from repro_torch.launch.steps import LMHarness
    from repro_torch.tree import flatten_with_paths

    leaves = [t for _, t in flatten_with_paths(
        LMHarness(arch, cfg=cfg).param_shapes())]
    n = sum(t.numel() for t in leaves)
    if arch in JAX_LEAVES:
        check(n == JAX_LEAVES[arch],
              f"{arch}: {n} leaves != JAX's {JAX_LEAVES[arch]}")
    else:
        check(n == cfg.param_count() + uncounted_norms(cfg),
              f"{arch}: {n} leaves != param_count {cfg.param_count()} + "
              f"{uncounted_norms(cfg)} norm scales")
    return n, sum(t.numel() * t.element_size() for t in leaves)


def check_served(res, vocab, n_tokens, what) -> None:
    got = sum(len(t) for b in res["batches"] for t in b["tokens"])
    check(got == res["total_tokens"] == n_tokens,
          f"{what}: served {got} tokens, want {n_tokens}")
    check(all(0 <= int(t.min()) and int(t.max()) < vocab
              for b in res["batches"] for t in b["tokens"]),
          f"{what}: a served token outside the vocabulary")


def server_step_times(np, torch, server, vocab, seed) -> tuple:
    """One bf16 decode step of ``server`` at B LM_STEP_BATCH, position
    LM_STEP_SEQ of its cache: device and wall ms (medians of
    LM_STEP_TIMES) and device-busy ms."""
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(
        1, vocab, (LM_STEP_BATCH, LM_STEP_SEQ)).astype(np.int32)).cuda()
    tok, cache = server._prefill(server.params, toks, batch=LM_STEP_BATCH,
                                 seq=LM_STEP_SEQ)

    def step():
        server._decode_step(server.params, cache, tok, LM_STEP_SEQ)

    dev_ms, wall_ms = median_times_ms(torch, step, LM_STEP_TIMES)
    _, _, busy_us = device_and_wall_us(torch, step, 5)
    return dev_ms, wall_ms, busy_us / 1e3


def zoo_served_arch(np, torch, arch, seed) -> dict:
    """``launch.serve --arch <arch> --full`` in bf16 at the launcher's
    defaults (12 requests, max-batch 4, max-new 16, max-seq 96), whole."""
    from repro_torch import configs
    from repro_torch.launch import serve

    cfg = configs.get_arch(arch).CONFIG
    n, nbytes = lm_size(arch, cfg)
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    res = serve.main(["--arch", arch, "--full", "--device", "cuda"])
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    server = res.pop("server")
    check_served(res, cfg.vocab_size, 12 * 16, arch)
    step = server_step_times(np, torch, server, cfg.vocab_size, seed)
    del server
    free_card(torch)
    return {"arch": arch, "layers": cfg.n_layers, "params": n,
            "param_bytes": nbytes, "init_s": res["init_s"],
            "tokens": res["total_tokens"], "wall_s": res["wall_s"],
            "tokens_per_s": res["tokens_per_s"],
            "batch_latency_s": [b["latency_s"] for b in res["batches"]],
            "peak_bytes": peak, "step": step}


def prefill_drops(np, torch, server, reqs, batches) -> dict:
    """Replays the served batches' prefills with ``moe.moe_forward``
    wrapped to count the routed (token, expert) pairs and those capacity
    drops, over all layers and batches: all pairs, and the pairs of
    prompt tokens (not the left padding)."""
    from repro_torch.models import moe

    counts = []
    plain = moe.moe_forward
    prompt_rows = []   # the current batch's prompt-token mask, (B * S,)

    def counted(p, x, cfg, *, dropless=False):
        if not dropless:
            xf = x.reshape(-1, x.shape[-1])
            _, _, gate_idx = moe.route(p, xf, cfg.moe)
            C = moe.capacity(xf.shape[0], cfg.moe, False)
            _, _, st, keep, _ = moe.dispatch(gate_idx, cfg.moe.n_experts, C)
            real = prompt_rows[-1][st]
            counts.append(torch.stack([
                (~keep).sum(), torch.full_like((~keep).sum(), keep.numel()),
                (~keep & real).sum(), real.sum()]))
        return plain(p, x, cfg, dropless=dropless)

    moe.moe_forward = counted
    try:
        for b in batches:
            prompts = [reqs[u].prompt for u in b["uids"]]
            S = max(len(q) for q in prompts)
            toks = np.zeros((len(prompts), S), np.int32)  # left-padded
            real = np.zeros((len(prompts), S), bool)
            for i, q in enumerate(prompts):
                toks[i, S - len(q):] = q
                real[i, S - len(q):] = True
            prompt_rows.append(torch.from_numpy(real.reshape(-1)).cuda())
            server._prefill(server.params, torch.from_numpy(toks).cuda(),
                            batch=len(prompts), seq=S)
    finally:
        moe.moe_forward = plain
    dropped, routed, dropped_real, routed_real = (
        int(v) for v in torch.stack(counts).sum(0).cpu())
    return {"dropped": dropped, "routed": routed,
            "prompt_dropped": dropped_real, "prompt_routed": routed_real}


def zoo_mixtral(np, torch, seed) -> dict:
    """mixtral-8x7b at full width, its depth cut to ZOO_MIXTRAL_LAYERS,
    through ``BatchServer`` with ``launch.serve``'s request plan (bf16);
    the share of prefill (token, expert) pairs capacity 1.25 drops."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.launch import serve
    from repro_torch.serving import BatchServer

    arch = "mixtral-8x7b"
    mod = configs.get_arch(arch)
    cfg = dataclasses.replace(mod.CONFIG, n_layers=ZOO_MIXTRAL_LAYERS)
    n, nbytes = lm_size(arch, cfg)
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    model = mod.build(cfg)
    t0 = time.perf_counter()
    params = model.init(prng.key(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    server = BatchServer(model, params, max_seq=96, device="cuda")
    reqs = serve.request_plan(cfg.vocab_size, 12, 96, 16)
    res = serve.run(server, reqs, 4)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    check_served(res, cfg.vocab_size, 12 * 16, arch)
    drops = prefill_drops(np, torch, server, reqs, res["batches"])
    check(0 < drops["prompt_routed"] <= drops["routed"]
          and drops["dropped"] < drops["routed"],
          f"{arch}: prefill drops {drops}")
    step = server_step_times(np, torch, server, cfg.vocab_size, seed)
    del server, model, params
    free_card(torch)
    return {"arch": arch, "layers": cfg.n_layers, "params": n,
            "param_bytes": nbytes, "init_s": init_s,
            "tokens": res["total_tokens"], "wall_s": res["wall_s"],
            "tokens_per_s": res["tokens_per_s"],
            "batch_latency_s": [b["latency_s"] for b in res["batches"]],
            "peak_bytes": peak, "step": step, "prefill_drops": drops}


def greedy_run(np, torch, prefill, decode, first_in, new, vocab, what):
    """Prefill, then ``new`` greedy decode steps; every logit finite and
    every token in the vocabulary. Returns (tokens (B, new), wall s, one
    decode step's device / wall / busy ms at the first position)."""
    t0 = time.perf_counter()
    logits, cache = prefill(first_in)
    check(bool(torch.isfinite(logits).all()), f"{what}: prefill logits "
          f"not finite")
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    first = (tok, cache)
    out = [tok]
    for s in range(new - 1):
        logits, cache = decode(tok, cache, s)
        check(bool(torch.isfinite(logits).all()),
              f"{what}: decode logits not finite at step {s}")
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        out.append(tok)
    toks = torch.cat(out, dim=1).cpu()
    wall = time.perf_counter() - t0
    check(0 <= int(toks.min()) and int(toks.max()) < vocab,
          f"{what}: a token outside the vocabulary")

    def step():
        decode(first[0], first[1], 0)

    dev_ms, wall_ms = median_times_ms(torch, step, LM_STEP_TIMES)
    _, _, busy_us = device_and_wall_us(torch, step, 5)
    return toks, wall, (dev_ms, wall_ms, busy_us / 1e3)


def zoo_scout(np, torch, seed) -> dict:
    """llama4-scout at full width, its depth cut to ZOO_SCOUT_LAYERS:
    prefill and greedy decode in bf16."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core import prng

    arch = "llama4-scout-17b-a16e"
    mod = configs.get_arch(arch)
    cfg = dataclasses.replace(mod.CONFIG, n_layers=ZOO_SCOUT_LAYERS)
    n, nbytes = lm_size(arch, cfg)
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    model = mod.build(cfg)
    t0 = time.perf_counter()
    params = model.init(prng.key(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, S, new = ZOO_SCOUT
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        1, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()

    @torch.inference_mode()
    def prefill(batch):
        return model.prefill(params, batch,
                             model.init_cache(B, S + new, device="cuda"))

    @torch.inference_mode()
    def decode(tok, cache, s):
        return model.decode_step(params, {"tokens": tok}, S + s, cache)

    out, wall, step = greedy_run(np, torch, prefill, decode,
                                 {"tokens": toks}, new, cfg.vocab_size, arch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del params, model
    free_card(torch)
    return {"arch": arch, "layers": cfg.n_layers, "params": n,
            "param_bytes": nbytes, "init_s": init_s, "tokens": out.numel(),
            "wall_s": wall, "tokens_per_s": out.numel() / wall,
            "peak_bytes": peak, "step": step}


def vl_inputs(np, torch, cfg, rng, B, S, dtype):
    """Merged patch + text embeddings (B, S, d) and M-RoPE ids (3, B, S):
    temporal ids run 0..S-1, height and width ids are patch coordinates."""
    emb = torch.from_numpy(rng.normal(0, 0.02, (B, S, cfg.d_model)).astype(
        np.float32)).to(dtype).cuda()
    p3 = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
    p3[1:] = rng.integers(0, 16, (2, B, S))
    return emb, torch.from_numpy(p3).cuda()


def zoo_vl(np, torch, seed) -> dict:
    """qwen2-vl-2b, whole, through ``LMHarness``'s prefill and decode steps
    in bf16, with embeddings and M-RoPE ids drawn from ``seed``."""
    from repro_torch import configs
    from repro_torch.configs.shapes import Shape
    from repro_torch.core import prng
    from repro_torch.launch.steps import LMHarness

    arch = "qwen2-vl-2b"
    cfg = configs.get_arch(arch).CONFIG
    n, nbytes = lm_size(arch, cfg)
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    h = LMHarness(arch, cfg=cfg)
    t0 = time.perf_counter()
    params = h.model.init(prng.key(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    B, S, new = ZOO_VL
    shape = Shape("vl", S + new, B, "prefill")
    emb, p3 = vl_inputs(np, torch, cfg, np.random.default_rng(seed), B, S,
                        cfg.dtype)
    check(tuple(emb.shape) == (B, S, cfg.d_model)
          and tuple(p3.shape) == (3, B, S), "qwen2-vl input shapes")
    prefill_step = h.make_prefill_step(shape, device="cuda")
    decode_step = h.make_decode_step(shape)

    @torch.inference_mode()
    def decode(tok, cache, s):
        # the step's logits, with the harness's M-RoPE ids of the position
        tin = {"tokens": tok,
               "mrope_positions": torch.full((3, B, 1), S + s,
                                             dtype=torch.int32,
                                             device="cuda")}
        return h.model.decode_step(params, tin, S + s, cache)

    out, wall, step = greedy_run(
        np, torch, lambda b: prefill_step(params, b), decode,
        {"embeds": emb, "mrope_positions": p3}, new, cfg.vocab_size, arch)
    # the harness's decode step gives the same greedy tokens
    logits, cache = prefill_step(params, {"embeds": emb,
                                          "mrope_positions": p3})
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    got = [tok]
    for s in range(new - 1):
        tok, cache = decode_step(params, cache, {"tokens": tok}, S + s)
        got.append(tok)
    check(torch.equal(torch.cat(got, dim=1).cpu(), out),
          "qwen2-vl: the harness's decode step's tokens differ")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del params, cache, logits
    free_card(torch)
    return {"arch": arch, "layers": cfg.n_layers, "params": n,
            "param_bytes": nbytes, "init_s": init_s, "tokens": out.numel(),
            "wall_s": wall, "tokens_per_s": out.numel() / wall,
            "peak_bytes": peak, "step": step}


def zoo_f32(np, torch, arch, layers, seed) -> dict:
    """Float32 (IEEE products) at full width, depth cut to ``layers``:
    prefill + decode against teacher forcing (MoE at capacity_factor E/k;
    whisper with WHISPER_CUT_FRAMES frames, its self cache of the tokens),
    then the same params' logits card against host."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.device import ieee_fp32_matmul
    from repro_torch.tree import tree_map

    mod = configs.get_arch(arch)
    cfg = dataclasses.replace(mod.CONFIG, dtype=torch.float32,
                              n_layers=layers)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    model = mod.build(cfg)
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    params = model.init(prng.key(1), device="cuda")
    rng = np.random.default_rng(seed)
    B, S, k = LM_CHECK
    if cfg.frontend == "embeddings":
        emb, p3 = vl_inputs(np, torch, cfg, rng, B, S, torch.float32)

        def inputs(a, b):
            return {"embeds": emb[:, a:b], "mrope_positions": p3[:, :, a:b]}
    elif arch == WHISPER:
        enc, toks = whisper_inputs(np, torch, cfg, rng, B,
                                   WHISPER_CUT_FRAMES, S, torch.float32)

        def inputs(a, b):
            return {"enc_embeds": enc, "tokens": toks[:, a:b]}
    else:
        toks = torch.from_numpy(rng.integers(
            1, cfg.vocab_size, (B, S)).astype(np.int32)).cuda()

        def inputs(a, b):
            return {"tokens": toks[:, a:b]}
    with ieee_fp32_matmul(), torch.inference_mode():
        full, _ = model.forward(params, inputs(0, S))
        check(bool(torch.isfinite(full).all()),
              f"{arch}: float32 logits not finite")
        if arch == WHISPER:
            cache = model.init_cache(B, S, WHISPER_CUT_FRAMES, device="cuda")
        else:
            cache = model.init_cache(B, S, device="cuda")
        logits, cache = model.prefill(params, inputs(0, k), cache)
        worst = worst_ratio(logits[:, 0], full[:, k - 1], LM_DECODE_TOL)
        for pos in range(k, S):
            logits, cache = model.decode_step(params, inputs(pos, pos + 1),
                                              pos, cache)
            worst = max(worst, worst_ratio(logits[:, 0], full[:, pos],
                                           LM_DECODE_TOL))
    peak = torch.cuda.max_memory_allocated()
    check(worst <= 1.0, f"{arch} float32 {layers}-layer cut: prefill / "
          f"decode off teacher forcing by {worst:.3f} x the tolerance")
    del cache, full, logits
    free_card(torch)
    # the same params on the host, a (2, 8) input
    p_host = tree_map(lambda t: t.cpu(), params)
    with ieee_fp32_matmul(), torch.inference_mode():
        lc, _ = model.forward(params, inputs(0, 8))
        lh, _ = model.forward(p_host, tree_map(lambda t: t.cpu(),
                                               inputs(0, 8)))
    cut_worst = worst_ratio(lc, lh, LM_CUT_TOL)
    cut_abs = float((lc.cpu() - lh).abs().max())
    check(cut_worst <= 1.0, f"{arch} {layers}-layer cut: card vs host "
          f"{cut_worst:.3f} x the tolerance")
    del params, p_host, lc, lh
    free_card(torch)
    return {"layers": layers, "decode_worst": worst, "cut_worst": cut_worst,
            "cut_max_abs": cut_abs, "peak_bytes": peak}


def log_zoo(r, how, f32, card) -> None:
    dev_ms, wall_ms, busy_ms = r["step"]
    line = (f"{r['arch']} ({how}, {r['layers']} layers): {r['params']} "
            f"params, {r['param_bytes']} bytes in bf16, init "
            f"{r['init_s']:.2f} s; {r['tokens']} tokens in "
            f"{r['wall_s']:.3f} s, {r['tokens_per_s']:.1f} tokens/s")
    if "batch_latency_s" in r:
        line += "; per-batch latency " + ", ".join(
            f"{t:.3f}" for t in r["batch_latency_s"]) + " s"
    log(line + f"; memory peak {r['peak_bytes'] / 2**30:.2f} GiB ({card})")
    log(f"{r['arch']} one decode step (B 4, bf16): device {dev_ms:.3f} ms "
        f"between events, wall {wall_ms:.3f} ms, median of {LM_STEP_TIMES}; "
        f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} % of "
        f"wall) ({card})")
    if "prefill_drops" in r:
        d = r["prefill_drops"]
        log(f"{r['arch']} prefill at capacity 1.25: {d['dropped']} of "
            f"{d['routed']} (token, expert) pairs dropped "
            f"({100 * d['dropped'] / d['routed']:.2f} %), of the prompt "
            f"tokens' pairs (not the left padding) {d['prompt_dropped']} of "
            f"{d['prompt_routed']} "
            f"({100 * d['prompt_dropped'] / d['prompt_routed']:.2f} %), over "
            f"{r['layers']} layers and the served batches ({card})")
    log(f"{r['arch']} float32 {f32['layers']}-layer cut (IEEE products): "
        f"prefill {LM_CHECK[2]} + decode to {LM_CHECK[1]} within "
        f"{f32['decode_worst']:.4f} of rtol/atol {LM_DECODE_TOL} of teacher "
        f"forcing; card vs host max |diff| {f32['cut_max_abs']:.3e}, "
        f"{f32['cut_worst']:.4f} of rtol/atol {LM_CUT_TOL}; memory peak "
        f"{f32['peak_bytes'] / 2**30:.2f} GiB ({card})")


def phase_lm_zoo(np, torch, card, seed) -> dict:
    """gemma3-12b and minicpm3-4b whole through ``launch.serve --full``;
    mixtral-8x7b at full width and 8 layers through ``BatchServer``;
    llama4-scout at full width and 2 layers, prefill and decode;
    qwen2-vl-2b whole through the harness's steps with embeddings and
    M-RoPE ids; each arch's float32 depth cut against teacher forcing and
    card against host."""
    out = {}
    for arch in ZOO_SERVED:
        out[arch] = zoo_served_arch(np, torch, arch, seed)
    out["mixtral-8x7b"] = zoo_mixtral(np, torch, seed)
    out["llama4-scout-17b-a16e"] = zoo_scout(np, torch, seed)
    out["qwen2-vl-2b"] = zoo_vl(np, torch, seed)
    for arch, layers in ZOO_CUTS.items():
        out[arch]["f32"] = zoo_f32(np, torch, arch, layers, seed)
    for arch, how in (("gemma3-12b", "launch.serve --full, whole"),
                      ("minicpm3-4b", "launch.serve --full, whole"),
                      ("mixtral-8x7b", "BatchServer, full width"),
                      ("llama4-scout-17b-a16e", "prefill + decode, full "
                       "width"),
                      ("qwen2-vl-2b", "LMHarness steps, embeddings, whole")):
        log_zoo(out[arch], how, out[arch]["f32"], card)
    return out


# --------------------------------------------------------------------------
# phase 13: the non-attention LM families and whisper at full width
# --------------------------------------------------------------------------
ZOO_RECURRENT = ("zamba2-1.2b", "rwkv6-7b")  # whole, through launch.serve
WHISPER = "whisper-large-v3"
# whisper through the harness: S // 2 = 1500 encoder frames (its 30 s audio
# context) and 1500 self-cache slots, B 4; a 4-token prompt, then 32
# greedy decode steps
WHISPER_SHAPE = ("whisper_1500", 3000, 4)
WHISPER_PROMPT, WHISPER_DECODE = 4, 32
WHISPER_CUT_FRAMES = 16     # encoder frames of whisper's float32 cut
# float32 depth cuts of full width for teacher forcing and card vs host:
# zamba2 keeps two shared-block invocations (after layers 5 and 11);
# whisper 4 encoder + 4 decoder layers, its position table 64 rows (the
# build's identity test)
ZOO_RECURRENT_CUTS = {"zamba2-1.2b": 12, "rwkv6-7b": 4, WHISPER: 4}


def whisper_inputs(np, torch, cfg, rng, B, F, S, dtype):
    """Frame embeddings (B, F, d) of ``dtype`` and tokens (B, S) on the
    card."""
    enc = torch.from_numpy(rng.normal(0, 0.1, (B, F, cfg.d_model)).astype(
        np.float32)).to(dtype).cuda()
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (B, S)).astype(
        np.int32)).cuda()
    return enc, toks


def zoo_whisper(np, torch, seed) -> dict:
    """whisper-large-v3, whole (CONFIG: the 32768-row position table),
    through ``LMHarness``'s prefill and decode steps in bf16 at
    WHISPER_SHAPE: 1500 frames from ``seed`` encoded once, their cross K/V
    cached, a 4-token prompt, 32 greedy decode steps."""
    from repro_torch import configs
    from repro_torch.configs.shapes import Shape
    from repro_torch.core import prng
    from repro_torch.launch.steps import LMHarness

    cfg = configs.get_arch(WHISPER).CONFIG
    n, nbytes = lm_size(WHISPER, cfg)
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    h = LMHarness(WHISPER)
    check(h.model.max_dec_len == 1 << 15,
          f"whisper CONFIG built with {h.model.max_dec_len} position rows")
    t0 = time.perf_counter()
    params = h.model.init(prng.key(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    shape = Shape(*WHISPER_SHAPE, "prefill")
    B, F = shape.global_batch, shape.seq_len // 2
    enc, prompt = whisper_inputs(np, torch, cfg, np.random.default_rng(seed),
                                 B, F, WHISPER_PROMPT, cfg.dtype)
    check(tuple(h.batch_shapes(shape)["enc_embeds"].shape)
          == tuple(enc.shape) == (4, 1500, 1280), "whisper input shapes")
    prefill_step = h.make_prefill_step(shape, device="cuda")
    decode_step = h.make_decode_step(shape)

    @torch.inference_mode()
    def decode(tok, cache, s):
        return h.model.decode_step(params, {"tokens": tok},
                                   WHISPER_PROMPT + s, cache)

    first_in = {"enc_embeds": enc, "tokens": prompt}
    out, wall, step = greedy_run(
        np, torch, lambda b: prefill_step(params, b), decode, first_in,
        WHISPER_DECODE + 1, cfg.vocab_size, WHISPER)
    # the harness's decode step gives the same greedy tokens
    logits, cache = prefill_step(params, first_in)
    check(tuple(cache["cross"]["k"].shape) == (32, 4, 1500, 20, 64)
          and tuple(cache["self"]["k"].shape) == (32, 4, 1500, 20, 64),
          "whisper cache shapes")
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    got = [tok]
    for s in range(WHISPER_DECODE):
        tok, cache = decode_step(params, cache, {"tokens": tok},
                                 WHISPER_PROMPT + s)
        got.append(tok)
    check(torch.equal(torch.cat(got, dim=1).cpu(), out),
          "whisper: the harness's decode step's tokens differ")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del params, cache, logits
    free_card(torch)
    return {"arch": WHISPER, "layers": cfg.n_layers, "params": n,
            "param_bytes": nbytes, "init_s": init_s, "tokens": out.numel(),
            "wall_s": wall, "tokens_per_s": out.numel() / wall,
            "peak_bytes": peak, "step": step}


def phase_lm_zoo_recurrent(np, torch, card, seed) -> dict:
    """zamba2-1.2b and rwkv6-7b whole through ``launch.serve --full``;
    whisper-large-v3 whole through the harness's steps with 1500 frames;
    each arch's float32 depth cut against teacher forcing and card against
    host."""
    out = {}
    for arch in ZOO_RECURRENT:
        out[arch] = zoo_served_arch(np, torch, arch, seed)
    out[WHISPER] = zoo_whisper(np, torch, seed)
    for arch, layers in ZOO_RECURRENT_CUTS.items():
        out[arch]["f32"] = zoo_f32(np, torch, arch, layers, seed)
    for arch, how in (("zamba2-1.2b", "launch.serve --full, whole"),
                      ("rwkv6-7b", "launch.serve --full, whole"),
                      (WHISPER, "LMHarness steps, 1500 frames, whole")):
        log_zoo(out[arch], how, out[arch]["f32"], card)
    return out


# --------------------------------------------------------------------------
# phase 14: LM training
# --------------------------------------------------------------------------
TRAIN_LM_SHAPE = (512, 8)   # seq, global batch: 4 microbatches of 2 x 512
TRAIN_LM_MICRO_ROWS = 2
TRAIN_LM_STEPS = 4
TRAIN_CUT = (2, 2, 64)      # float32 cut: layers, batch, seq
EP_ARCH, EP_MESH = "mixtral-8x7b", (4, 2)
EP_X = (8, 32)              # batch, seq of the MoE layer's input
EP_CF = 0.5                 # capacity factor of the capacity path: drops
EP_TOL = (2e-4, 2e-5)       # dropless EP vs dense: tests/test_perf_variants
EP_HOST_TOL = 1e-5          # capacity path, card vs host: rtol and atol
RESUME_TOL = 1e-5           # tests/test_system.py's resume atol


def lm_train_whole(np, torch, card) -> dict:
    """granite-3-2b whole (bf16 CONFIG) through ``LMHarness(...,
    micro_rows=2).make_train_step`` on a 1 x 1 mesh of the card, 4 steps
    on ``data/lm`` batches: per step loss, grad norm, wall ms and ms
    between CUDA events; the memory peak; the device's busy ms in a fifth
    step, under ``torch.profiler``. The loss must fall: the first batch's
    loss after the steps below the first step's."""
    from repro_torch import configs
    from repro_torch.configs.shapes import Shape
    from repro_torch.core import prng
    from repro_torch.data import lm
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import LMHarness
    from repro_torch.tree import leaves

    cfg = configs.get_arch(LM_ARCH).CONFIG
    n_params, nbytes = lm_size(LM_ARCH, cfg)
    h = LMHarness(LM_ARCH, cfg=cfg, micro_rows=TRAIN_LM_MICRO_ROWS)
    S, B = TRAIN_LM_SHAPE
    shape = Shape("train_card", S, B, "train")
    mesh = make_host_mesh(devices=["cuda"])
    n_micro = h.n_microbatches(shape, mesh)
    check(n_micro == B // TRAIN_LM_MICRO_ROWS,
          f"n_micro {n_micro} != {B // TRAIN_LM_MICRO_ROWS}")
    free_card(torch)
    held = torch.cuda.memory_allocated()  # left by the earlier phases
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = h.model.init(prng.key(0), device="cuda")
    opt_state = h.opt.init(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = h.make_train_step(shape, mesh)
    stream = lm.TokenStream(cfg.vocab_size, seed=0)
    steps, batches = [], []
    for i in range(TRAIN_LM_STEPS):
        toks = torch.from_numpy(stream.sample(B, S, i).astype(
            np.int32)).cuda()
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        batches.append(batch)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        params, opt_state, m = step(params, opt_state, batch)
        end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        steps.append({"loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"]),
                      "wall_ms": wall, "event_ms": start.elapsed_time(end)})
    peak = torch.cuda.max_memory_allocated()
    # one more step under torch.profiler: the device's busy time in it
    from torch.profiler import ProfilerActivity, profile

    toks = torch.from_numpy(stream.sample(B, S, TRAIN_LM_STEPS).astype(
        np.int32)).cuda()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        params, opt_state, _ = step(params, opt_state, {
            "tokens": toks[:, :-1], "targets": toks[:, 1:]})
        torch.cuda.synchronize()
    busy_ms = sum(getattr(evt, "device_time_total", 0)
                  for evt in prof.key_averages()) / 1e3
    check(all(p.device.type == "cuda" and p.dtype == torch.bfloat16
              for p in leaves(params)), "the train step left the card")
    check(int(opt_state["step"]) == TRAIN_LM_STEPS + 1,
          "optimizer step count")
    check(all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"])
              for s in steps), f"non-finite loss or grad norm: {steps}")
    del opt_state, step
    with torch.no_grad():
        after = float(h.model.loss(params, batches[0])[0])
    check(after < steps[0]["loss"], f"the loss did not fall: the first "
          f"batch's {steps[0]['loss']:.4f} before the steps, {after:.4f} "
          f"after")
    del params
    free_card(torch)
    return {"params": n_params, "param_bytes": nbytes, "init_s": init_s,
            "n_micro": n_micro, "steps": steps, "peak_bytes": peak,
            "first_batch_after": after, "busy_ms": busy_ms, "held": held}


def train_cut_step(torch, h, shape, device, params, batch):
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(devices=[device])
    return h.make_train_step(shape, mesh)(params, h.opt.init(params), batch)


def lm_train_f32_cut(np, torch) -> dict:
    """granite-3-2b at full width cut to 2 layers, float32, one train step
    (B 2 x S 64, two microbatches) on the card and on the host from the
    same params: loss, grad norm and Adam's first moment."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.configs.shapes import Shape
    from repro_torch.core import prng
    from repro_torch.data import lm
    from repro_torch.launch.steps import LMHarness
    from repro_torch.tree import leaves, tree_map

    layers, B, S = TRAIN_CUT
    cfg = dataclasses.replace(configs.get_arch(LM_ARCH).CONFIG,
                              n_layers=layers, dtype=torch.float32)
    h = LMHarness(LM_ARCH, cfg=cfg)
    shape = Shape("train_cut", S, B, "train")
    p_card = h.model.init(prng.key(1), device="cuda")
    p_host = tree_map(lambda t: t.cpu(), p_card)
    toks = torch.from_numpy(lm.TokenStream(cfg.vocab_size, seed=1).sample(
        B, S, 0).astype(np.int32))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    _, o_card, m_card = train_cut_step(
        torch, h, shape, "cuda", p_card,
        tree_map(lambda t: t.cuda(), batch))
    _, o_host, m_host = train_cut_step(torch, h, shape, "cpu", p_host, batch)
    loss_rel = abs(float(m_card["loss"]) / float(m_host["loss"]) - 1)
    norm_rel = abs(float(m_card["grad_norm"]) / float(m_host["grad_norm"])
                   - 1)
    check(loss_rel <= LOSS_RTOL, f"f32 cut train step: loss card vs host "
          f"{loss_rel:.3e}")
    check(norm_rel <= GRAD_RTOL, f"f32 cut train step: grad norm card vs "
          f"host {norm_rel:.3e}")
    m_worst = grads_close(np, leaves(o_card["m"]), leaves(o_host["m"]),
                          "f32 cut train step: Adam's m card vs host")
    del p_card, p_host, o_card, o_host
    free_card(torch)
    return {"layers": layers, "loss": float(m_card["loss"]),
            "loss_rel": loss_rel, "norm_rel": norm_rel, "m_worst": m_worst}


def lm_train_ep(np, torch) -> dict:
    """One mixtral-8x7b MoE layer at full width (float32) through
    ``moe_forward_ep`` on a data 4 x model 2 mesh of the card: dropless
    against the dense dispatch, and on the capacity path (capacity factor
    EP_CF) the same dropped pairs and outputs as on the host."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.launch.mesh import make_host_mesh, use_mesh
    from repro_torch.models import moe
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(configs.get_arch(EP_ARCH).CONFIG,
                              dtype=torch.float32)
    free_card(torch)
    p = moe.init_moe(prng.key(2), cfg, device="cuda")
    B, S = EP_X
    x = torch.from_numpy(np.random.default_rng(2).normal(
        0, 0.5, (B, S, cfg.d_model)).astype(np.float32)).cuda()
    mesh = make_host_mesh(data=EP_MESH[0], model=EP_MESH[1],
                          devices=["cuda"])
    with torch.inference_mode():
        dense, _ = moe.moe_forward(p, x, cfg, dropless=True)
        with use_mesh(mesh):
            ep, _ = moe.moe_forward_ep(p, x, cfg, dropless=True)
    rtol, atol = EP_TOL
    ep_worst = float(((ep - dense).abs() / (atol + rtol * dense.abs()))
                     .max())
    check(ep_worst <= 1.0, f"dropless moe_forward_ep vs dense: "
          f"{ep_worst:.3f} x the tolerance")

    # the capacity path, card and host, with the dropped pairs recorded
    ccfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=EP_CF))
    real, kept = moe.dispatch, []

    def recording(gate_idx, E, C):
        out = real(gate_idx, E, C)
        kept.append(out[3].cpu())
        return out

    moe.dispatch = recording
    try:
        with torch.inference_mode(), use_mesh(mesh):
            y_card, aux_card = moe.moe_forward_ep(p, x, ccfg)
        card_keep, kept[:] = list(kept), []
        p_host = tree_map(lambda t: t.cpu(), p)
        host_mesh = make_host_mesh(data=EP_MESH[0], model=EP_MESH[1],
                                   devices=["cpu"])
        with torch.inference_mode(), use_mesh(host_mesh):
            y_host, aux_host = moe.moe_forward_ep(p_host, x.cpu(), ccfg)
        host_keep = list(kept)
    finally:
        moe.dispatch = real
    check(len(card_keep) == len(host_keep) == EP_MESH[0]
          and all(torch.equal(a, b) for a, b in zip(card_keep, host_keep)),
          "moe_forward_ep: card and host keep other (token, expert) pairs")
    dropped = int(sum((~k).sum() for k in card_keep))
    pairs = int(sum(k.numel() for k in card_keep))
    check(dropped > 0, "the capacity path dropped no pair")
    host_worst = worst_ratio(y_card, y_host, EP_HOST_TOL)
    check(host_worst <= 1.0, f"moe_forward_ep capacity path card vs host "
          f"{host_worst:.3f} x the tolerance")
    check(abs(float(aux_card) - float(aux_host)) <= EP_HOST_TOL * abs(
        float(aux_host)), "moe_forward_ep aux card vs host")
    del p, p_host, x, dense, ep, y_card, y_host
    free_card(torch)
    return {"ep_worst": ep_worst, "host_worst": host_worst,
            "dropped": dropped, "pairs": pairs}


def lm_train_launcher(np, torch) -> dict:
    """``python -m repro_torch.launch.train`` on the card (its default
    device): 8 steps stopped by ``--fail-at-step 5``, run again from the
    step-3 checkpoint; the final params equal an uninterrupted run's."""
    import os

    from repro_torch import checkpoint as ckpt
    from repro_torch.launch import train
    from repro_torch.tree import leaves

    args = ["--arch", LM_ARCH, "--steps", "8", "--batch", "4", "--seq",
            "16", "--checkpoint-every", "3"]
    ref = train.main(args)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", *args,
               "--checkpoint-dir", d]
        first = subprocess.run(cmd + ["--fail-at-step", "5"], env=env,
                               capture_output=True, text=True, timeout=300)
        check(first.returncode != 0 and "simulated preemption at step 5"
              in first.stderr, f"--fail-at-step 5 did not stop the run: "
              f"rc {first.returncode}\n{first.stderr[-2000:]}")
        again = subprocess.run(cmd, env=env, capture_output=True, text=True,
                               timeout=300)
        check(again.returncode == 0, f"the resumed run failed: "
              f"{again.stderr[-2000:]}")
        check("[loop] resumed from checkpoint step 3" in again.stdout,
              "the second run did not resume from step 3")
        final, _ = ckpt.load(d, 8, like=ref)
    worst = max(float((a.float().cpu() - b.float()).abs().max())
                for a, b in zip(leaves(ref["params"]),
                                leaves(final["params"])))
    check(worst <= RESUME_TOL, f"resumed launcher run vs uninterrupted: "
          f"{worst}")
    check(all(p.device.type == "cuda" for p in leaves(ref["params"])),
          "the launcher did not train on the card")
    return {"resume_max_abs": worst}


def phase_lm_train(np, torch, card) -> dict:
    """granite-3-2b trained whole on the card; the float32 cut card vs
    host; expert parallelism at mixtral's width; the launcher's restart."""
    t0 = time.perf_counter()
    out = {"whole": lm_train_whole(np, torch, card),
           "f32": lm_train_f32_cut(np, torch),
           "ep": lm_train_ep(np, torch),
           "launcher": lm_train_launcher(np, torch)}
    out["phase_s"] = time.perf_counter() - t0
    w = out["whole"]
    for i, s in enumerate(w["steps"]):
        log(f"train {LM_ARCH} (whole, {w['params']} params, bf16) step {i}: "
            f"loss {s['loss']:.4f}, grad norm {s['grad_norm']:.4f}, wall "
            f"{s['wall_ms']:.1f} ms, {s['event_ms']:.1f} ms between CUDA "
            f"events ({card})")
    log(f"train {LM_ARCH}: {w['n_micro']} microbatches of "
        f"{TRAIN_LM_MICRO_ROWS} x {TRAIN_LM_SHAPE[0]} a step, init "
        f"{w['init_s']:.2f} s, peak {w['peak_bytes'] / 2**30:.2f} GiB "
        f"({w['held'] / 2**30:.2f} held before), "
        f"device busy {w['busy_ms']:.1f} ms in a profiled step; the first "
        f"batch's loss {w['steps'][0]['loss']:.4f} -> "
        f"{w['first_batch_after']:.4f} after {TRAIN_LM_STEPS + 1} steps "
        f"({card})")
    f = out["f32"]
    log(f"train {LM_ARCH} float32 {f['layers']}-layer cut, card vs host: "
        f"loss rel {f['loss_rel']:.3e}, grad norm rel {f['norm_rel']:.3e}, "
        f"m {f['m_worst']:.4f} x tol")
    e = out["ep"]
    log(f"moe_forward_ep {EP_ARCH} layer on {EP_MESH[0]} x {EP_MESH[1]}: "
        f"dropless vs dense {e['ep_worst']:.4f} x tol; capacity "
        f"{EP_CF}: {e['dropped']} of {e['pairs']} pairs dropped, the same "
        f"on the host, outputs {e['host_worst']:.4f} x tol")
    log(f"launch.train restart: resumed params vs uninterrupted max |d| "
        f"{out['launcher']['resume_max_abs']}; phase 14 "
        f"{out['phase_s']:.1f} s ({card})")
    return out


# --------------------------------------------------------------------------
# phase 15: the LM train step across ranks
# --------------------------------------------------------------------------
def phase_lm_ranks(np, torch, card) -> dict:
    """``scripts/torch_lm_ranks_calls.py`` on the visible cards (at most
    four): its ranks' float32 cases against the one-card logical step
    and, with four, granite-3-2b whole on ``(4, 1)`` and ``(2, 2, 1)``."""
    import os

    n_cards = torch.cuda.device_count()
    world = 4 if n_cards >= 4 else (2 if n_cards >= 2 else 1)
    if world < 4:
        log(f"phase 15 on {n_cards} card(s): the (2, 2), (4, 1), (2, 2, 1) "
            f"and (2, 1, 2) rank steps and granite-3-2b whole on (4, 1) and "
            f"(2, 2, 1) need four cards; this run holds the NCCL path on "
            f"{world} rank(s)" + (", on (1, 1) and (1, 1, 1)"
                                  if world == 1 else ""))
    free_card(torch)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        out = pathlib.Path(d) / "ranks.json"
        proc = subprocess.run(
            [sys.executable, str(ROOT / "scripts" / "torch_lm_ranks_calls.py"),
             "--world", str(world), "--out", str(out)], env=env,
            capture_output=True, text=True, timeout=1000)
        check(proc.returncode == 0 and out.is_file(),
              f"the ranks failed: rc {proc.returncode}\n"
              f"{proc.stderr[-3000:]}")
        res = json.loads(out.read_text())
    res["phase_s"] = time.perf_counter() - t0
    for c in res["cases"]:
        mesh = " x ".join(map(str, c["mesh"]))
        if world == 1:
            check(c["bit_equal"], f"{c['what']} on one NCCL rank ({mesh}) "
                  f"is not the one-process step bit for bit")
        else:
            check(c["loss_rel"] <= LOSS_RTOL and c["norm_rel"] <= GRAD_RTOL
                  and max(c["m_worst"], c["v_worst"], c["new_worst"])
                  <= 1.0, f"{c['what']} on {mesh} ranks vs the one-card "
                  f"logical mesh: {c}")
        log(f"ranks {c['what']} on {mesh}: loss {c['loss']:.6f} (one card "
            f"{c['ref_loss']:.6f}, rel {c['loss_rel']:.2e}), grad norm rel "
            f"{c['norm_rel']:.2e}, m {c['m_worst']:.4f} / v "
            f"{c['v_worst']:.4f} x tol, params {c['new_worst']:.4f} x the "
            f"first-step bound, bit-equal {c['bit_equal']}; step "
            f"{c['wall_ms']:.1f} ms, NCCL bytes {c['nccl_bytes']} ({card})")
    for w, d in ((res["whole"], res.get("dryrun")),
                 (res.get("whole_pod"), res.get("dryrun_pod"))):
        if w is None:
            continue
        mesh = " x ".join(map(str, w["mesh"]))
        check(all(np.isfinite(s["loss"]) and np.isfinite(s["grad_norm"])
                  for s in w["steps"]), f"non-finite whole steps: {w}")
        check(w["first_batch_after"] < w["steps"][0]["loss"],
              f"the loss did not fall across ranks on {mesh}: "
              f"{w['steps'][0]['loss']:.4f} -> {w['first_batch_after']:.4f}")
        for i, s in enumerate(w["steps"]):
            log(f"ranks {LM_ARCH} whole (bf16) on {mesh}, step {i}: loss "
                f"{s['loss']:.4f}, grad norm {s['grad_norm']:.4f}, wall "
                f"{s['wall_ms']:.1f} ms, {s['event_ms']:.1f} ms between "
                f"CUDA events, NCCL calls {s['nccl_calls']}, bytes "
                f"{s['nccl_bytes']}, by axis {s['nccl_axis_bytes']} ({card})")
        log(f"ranks {LM_ARCH} whole on {mesh}: {w['n_micro']} "
            f"microbatch(es) a rank, "
            f"init {w['init_s']:.2f} s (peaks "
            + ", ".join(f"{b / 2**30:.2f}" for b in w["init_peak_bytes"])
            + " GiB a rank), step peaks "
            + ", ".join(f"{b / 2**30:.2f}" for b in w["peak_bytes"])
            + " GiB a rank, param shards "
            + ", ".join(f"{b / 2**30:.2f}" for b in w["param_shard_bytes"])
            + f" GiB; rank 0 busy {w['busy_ms']:.1f} ms in a profiled step "
            f"({w['nccl_busy_ms']:.1f} ms of it in NCCL kernels: "
            + ", ".join(f"{k} {v:.1f}" for k, v in sorted(
                w["nccl_ms_by_kernel"].items()))
            + f"); the first batch's loss {w['steps'][0]['loss']:.4f} -> "
            f"{w['first_batch_after']:.4f} ({card})")
        # the launcher held the dry-run's counts to every step's
        log(f"dry-run {LM_ARCH} whole on {mesh}: calls {d['calls']} and "
            f"bytes {d['bytes']} == every step's; peak "
            f"{d['memory']['total_bytes'] / 2**30:.4f} GiB a rank, "
            + ", ".join(f"{r:.4f}" for r in d["peak_over_measured"])
            + f" of the ranks' measured peaks; {d['seconds']:.1f} s "
            f"({card})")
    log(f"phase 15: {res['world']} rank(s), {res['phase_s']:.1f} s ({card})")
    return res


# --------------------------------------------------------------------------
# phase 17: prefill and decode across ranks
# --------------------------------------------------------------------------
def phase_lm_serve_ranks(np, torch, card) -> dict:
    """``scripts/torch_lm_serve_ranks_calls.py`` on the visible cards (at
    most four): its ranks' float32 cuts against the one-card logical
    steps and, with four, mixtral-8x7b whole on ``(2, 2)``."""
    import os

    n_cards = torch.cuda.device_count()
    world = 4 if n_cards >= 4 else (2 if n_cards >= 2 else 1)
    if world < 4:
        log(f"phase 17 on {n_cards} card(s): the (2, 2), (4, 1), (1, 4), "
            f"(2, 2, 1) and (2, 1, 2) prefill and decode steps and "
            f"mixtral-8x7b whole in bf16 on (2, 2) need four cards; this "
            f"run holds the NCCL path on {world} rank(s)"
            + (", on (1, 1) and (1, 1, 1)" if world == 1 else ""))
    free_card(torch)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        out = pathlib.Path(d) / "serve_ranks.json"
        proc = subprocess.run(
            [sys.executable,
             str(ROOT / "scripts" / "torch_lm_serve_ranks_calls.py"),
             "--world", str(world), "--out", str(out)], env=env,
            capture_output=True, text=True, timeout=1100)
        check(proc.returncode == 0 and out.is_file(),
              f"the serving ranks failed: rc {proc.returncode}\n"
              f"{proc.stderr[-3000:]}")
        res = json.loads(out.read_text())
    res["phase_s"] = time.perf_counter() - t0
    for c in res["cases"]:
        mesh = str(tuple(c["mesh"]))
        if world == 1:
            check(c["bit_equal"], f"{c['what']} on one NCCL rank is not "
                  f"the one-card prefill and decode bit for bit: {c}")
        else:
            check(c["logits_ok"] and c["cache_ok"] and c["tokens_ok"],
                  f"{c['what']} on {mesh} ranks vs the one-card logical "
                  f"mesh: {c}")
        spread = ("n/a (MoE)" if c["one_card_half_batch_err"] is None
                  else f"{c['one_card_half_batch_err']:.3e}")
        log(f"serve ranks {c['what']} on {mesh} ({c['layout']} cache): "
            f"prefill logits max |d| {c['logits_max_abs_err']:.3e} (max "
            f"|logit| {c['logits_max_abs']:.3f}; {c['logits_scaled_err']:.4f}"
            f" x the tolerance; the one-card prefill of half the batch "
            f"{spread} from the whole's), cache "
            f"k / v max |d| {c['cache_max_abs_err']['k']:.3e} / "
            f"{c['cache_max_abs_err']['v']:.3e} (max |k| / |v| "
            f"{c['cache_max_abs']['k']:.3f} / {c['cache_max_abs']['v']:.3f}; "
            f"{max(c['cache_scaled_err'].values()):.4f} x the tolerance), "
            f"slot_pos equal, tokens "
            f"equal on {c['tokens_compared']} of {c['tokens_total']} with "
            f"a top-2 margin > 1e-4 (all equal: {c['tokens_equal_all']}, "
            f"least margin {c['min_margin']:.2e}), bit-equal "
            f"{c['bit_equal']}; prefill {c['prefill_ms']:.1f} ms, decode "
            f"{min(c['decode_ms']):.1f}-{max(c['decode_ms']):.1f} ms wall "
            f"({card})")
    for c, d in zip(res["scout"], res.get("scout_dryrun") or []):
        check(c["logits_ok"] and c["cache_ok"] and c["tokens_ok"],
              f"{c['what']} on (1, 4) ranks vs the one-card logical mesh: "
              f"{c}")
        # the launcher held the dry-run's counts to every decode step's
        log(f"serve ranks {c['what']} ({c['params']} params; "
            f"{c['param_shard_bytes'] / 2**30:.2f} GiB a rank's shard) on "
            f"(1, 4), {c['layout']} cache: prefill logits "
            f"{c['logits_scaled_err']:.4f} x the tolerance, cache "
            f"{max(c['cache_scaled_err'].values()):.4f}, tokens equal on "
            f"{c['tokens_compared']} of {c['tokens_total']}; B "
            f"{c['batch']} x {c['prompt']} prompt tokens, prefill "
            f"{c['prefill_ms']:.1f} ms wall; {len(c['decode_ms'])} decode "
            f"steps {c['decode_wall_ms_p50']:.2f} / "
            f"{c['decode_wall_ms_p95']:.2f} ms wall p50 / p95, "
            f"{c['decode_event_ms_p50']:.2f} / {c['decode_event_ms_p95']:.2f}"
            f" ms between CUDA events; rank 0 busy {c['busy_ms']:.2f} ms in "
            f"a profiled decode step ({c['nccl_busy_ms']:.2f} ms of it in "
            f"NCCL kernels); NCCL calls {d['calls']} and bytes {d['bytes']}"
            f" a step == the dry-run's (bound "
            f"{d['roofline']['bound_s'] * 1e3:.3f} ms, "
            f"{d['roofline']['dominant']}) ({card})")
    w = res["whole"]
    if w is not None:
        check(w["logits_finite"] and w["tokens_in_vocab"],
              f"{w['arch']} whole across ranks: non-finite logits or a "
              f"token out of the vocabulary")
        gib = lambda xs: ", ".join(f"{b / 2**30:.2f}" for b in xs)  # noqa
        log(f"serve ranks {w['arch']} whole ({w['params']} params, bf16) on "
            f"(2, 2): init {w['init_s']:.1f} s (peaks {gib(w['init_peak_bytes'])}"
            f" GiB a rank), serving peaks {gib(w['peak_bytes'])} GiB a rank, "
            f"param shards {gib(w['param_shard_bytes'])} GiB, cache shards "
            f"{gib(w['cache_shard_bytes'])} GiB ({card})")
        log(f"serve ranks {w['arch']} whole: B {w['batch']} x {w['prompt']} "
            f"prompt tokens, prefill {w['prefill_ms']:.1f} ms wall; "
            f"{w['new']} decode steps {w['decode_wall_ms_p50']:.1f} / "
            f"{w['decode_wall_ms_p95']:.1f} ms wall p50 / p95, "
            f"{w['decode_event_ms_p50']:.1f} / "
            f"{w['decode_event_ms_p95']:.1f} ms between CUDA events; "
            f"{w['decode_tokens_per_s']:.1f} decode tokens/s, "
            f"{w['tokens_per_s']:.1f} with the prefill; a decode step's NCCL "
            f"calls {w['steps'][0]['nccl_calls']} and bytes "
            f"{w['steps'][0]['nccl_bytes']}; rank 0 busy "
            f"{w['busy_ms']:.1f} ms in a profiled decode step "
            f"({w['nccl_busy_ms']:.1f} ms of it in NCCL kernels) ({card})")
        d = res["dryrun"]   # the launcher held its counts to every step's
        log(f"dry-run {w['arch']} whole decode on (2, 2): calls "
            f"{d['calls']} and bytes {d['bytes']} == every step's; peak "
            f"{d['memory']['total_bytes'] / 2**30:.4f} GiB a rank, "
            + ", ".join(f"{r:.4f}" for r in d["peak_over_measured"])
            + f" of the ranks' serving peaks; {d['seconds']:.1f} s ({card})")
    log(f"phase 17: {res['world']} rank(s), {res['phase_s']:.1f} s ({card})")
    return res


# --------------------------------------------------------------------------
# phase 16: the dry-run of phase 14's cell
# --------------------------------------------------------------------------
DRYRUN_PEAK_RATIO = (0.8, 1.25)   # dry-run peak over phase 14's measured
TRACKED_PEAK_RATIO = (0.99, 1.01)  # op analysis of a real step / allocator


def phase_lm_dryrun(np, torch, card, whole) -> dict:
    """``repro_torch.launch.dryrun.run_cell`` of phase 14's cell:
    granite-3-2b whole, bf16, B 8 x S 512, ``micro_rows`` 2, as a ``(1,
    1)`` rank mesh of fake CUDA tensors under the fake process group (no
    card memory, no communication). Its live-storage peak must lie
    within ``DRYRUN_PEAK_RATIO`` of the peak phase 14 measured
    (``max_memory_allocated`` less what earlier phases held); its
    roofline terms are printed beside phase 14's step. Then the op
    analysis of one real step of that cell on the card: its live-storage
    peak within ``TRACKED_PEAK_RATIO`` of the allocator's."""
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch import dryrun

    S, B = TRAIN_LM_SHAPE
    t0 = time.perf_counter()
    rec = dryrun.run_cell(
        LM_ARCH, Shape("train_card", S, B, "train"), mesh=(1, 1),
        variant=f"micro_rows={TRAIN_LM_MICRO_ROWS}", device="cuda",
        verbose=False)
    rec["phase_s"] = time.perf_counter() - t0
    check(rec["status"] == "ok", f"the dry-run of phase 14's cell: "
          f"{rec['status']} {rec.get('error')}\n{rec.get('traceback')}")
    check(rec["n_micro"] == whole["n_micro"], f"the dry-run's "
          f"{rec['n_micro']} microbatches, phase 14's {whole['n_micro']}")
    measured = whole["peak_bytes"] - whole["held"]
    peak = rec["memory"]["total_bytes"]
    ratio = peak / measured
    lo, hi = DRYRUN_PEAK_RATIO
    check(lo <= ratio <= hi, f"the dry-run's peak {peak} B is {ratio:.4f} "
          f"of phase 14's measured {measured} B, outside {lo}-{hi}")
    t = rec["roofline"]
    event_ms = sorted(s["event_ms"] for s in whole["steps"])
    log(f"dry-run {LM_ARCH} whole, (1, 1), B {B} x S {S}, micro_rows "
        f"{TRAIN_LM_MICRO_ROWS}: peak {peak / 2**30:.4f} GiB (arguments "
        f"{rec['memory']['argument_bytes'] / 2**30:.4f}, temporaries "
        f"{rec['memory']['temp_bytes'] / 2**30:.4f}) vs phase 14's measured "
        f"{measured / 2**30:.4f} GiB ({whole['peak_bytes'] / 2**30:.4f} "
        f"less {whole['held'] / 2**30:.4f} held): ratio {ratio:.4f} "
        f"({card})")
    log(f"dry-run {LM_ARCH} roofline on H100 data-sheet constants: "
        f"{rec['cost']['flops_per_device']:.6e} FLOP "
        f"({rec['cost']['dot_flops']:.6e} in dots), "
        f"{rec['cost']['bytes_per_device']:.6e} B; compute "
        f"{t['compute_s'] * 1e3:.1f} ms, memory {t['memory_s'] * 1e3:.1f} "
        f"ms, dominant {t['dominant']}, useful flops ratio "
        f"{t['useful_flops_ratio']:.4f}; phase 14's steps "
        f"{event_ms[0]:.1f}-{event_ms[-1]:.1f} ms between CUDA events, "
        f"the bound {t['bound_s'] * 1e3 / event_ms[0]:.4f} of the fastest; "
        f"analyzed in {rec['phase_s']:.1f} s of host time ({card})")
    rec["tracked"] = tracked_real_step(np, torch, card)
    return rec


def tracked_real_step(np, torch, card) -> dict:
    """``op_analysis.analyze_step`` on real CUDA tensors: one step of
    phase 14's cell on the logical 1 x 1 mesh, its live-storage peak
    against ``max_memory_allocated`` over the same step."""
    from repro_torch import configs
    from repro_torch.configs.shapes import Shape
    from repro_torch.core import prng
    from repro_torch.data import lm
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import LMHarness
    from repro_torch.op_analysis import analyze_step

    cfg = configs.get_arch(LM_ARCH).CONFIG
    h = LMHarness(LM_ARCH, cfg=cfg, micro_rows=TRAIN_LM_MICRO_ROWS)
    S, B = TRAIN_LM_SHAPE
    step = h.make_train_step(Shape("train_card", S, B, "train"),
                             make_host_mesh(devices=["cuda"]))
    free_card(torch)
    held = torch.cuda.memory_allocated()
    params = h.model.init(prng.key(0), device="cuda")
    opt_state = h.opt.init(params)
    toks = torch.from_numpy(lm.TokenStream(cfg.vocab_size, seed=0).sample(
        B, S, 0).astype(np.int32)).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stepped, cost = analyze_step(
        step, params, opt_state,
        {"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    torch.cuda.synchronize()
    out = {"seconds": time.perf_counter() - t0,
           "allocator": torch.cuda.max_memory_allocated() - held,
           "tracked": cost.total_bytes, "flops": cost.flops,
           "dot_flops": cost.dot_flops}
    del params, opt_state, stepped, step, cost
    free_card(torch)
    ratio = out["tracked"] / out["allocator"]
    lo, hi = TRACKED_PEAK_RATIO
    check(lo <= ratio <= hi, f"the op analysis of a real step tracked "
          f"{out['tracked']} B at its peak, the allocator "
          f"{out['allocator']} B: {ratio:.5f}, outside {lo}-{hi}")
    log(f"op analysis of one real {LM_ARCH} step on the card (logical 1 x "
        f"1): live-storage peak {out['tracked']} B vs the allocator's "
        f"{out['allocator']} B ({ratio:.5f}); {out['dot_flops']:.6e} dot "
        f"FLOP; {out['seconds']:.1f} s under the trace ({card})")
    return out


# --------------------------------------------------------------------------
def main() -> None:
    import argparse

    ap = argparse.ArgumentParser(description="chip smoke test of the port")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of phases 12 and 13's tokens, embeddings, "
                    "ids and frames")
    args = ap.parse_args()
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
    from repro_torch.core import prng
    from repro_torch.core.network import feedforward
    from repro_torch.core.session import AcceleratorSession
    from repro_torch.kernels import bitpack
    from repro_torch.kernels import lif_step as lif
    from repro_torch.kernels import ops
    from repro_torch.kernels import poisson_encode as enc
    from repro_torch.kernels import ref
    from repro_torch.kernels import spike_timestep as ts
    from repro_torch.kernels import spike_timestep_fused as tsf

    check_no_jax()
    # the plain versions' float32 products must not run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    log("phase 1: environment")
    card = phase_environment(torch)
    phase_build([("spike_timestep", ts), ("spike_timestep_fused", tsf),
                 ("lif_step", lif), ("poisson_encode", enc)])

    log("phase 2: kernels vs plain versions on the card")
    worst = phase_kernel_vs_plain(torch, ts, ops)
    worst_fused = phase_fused_vs_plain(torch, tsf, ops, bitpack)
    worst_stress = phase_split_stress(torch, ts, tsf, ops, bitpack)
    worst_lif = phase_lif_vs_plain(torch, lif, ref)
    worst_enc = phase_encode_vs_plain(torch, enc, ref)
    phase_prng_card_vs_host(np, torch, prng, AcceleratorSession, feedforward,
                            cfg)

    log("phase 3: the serving slice end to end, unfused and fused")
    launches, served_steps, fused_launches, rates, refs, ref_preds = \
        phase_serve(np, torch, ops, AcceleratorSession, feedforward, cfg)
    for (backend, gate, K), rate in sorted(rates.items()):
        log(f"served {backend} ({gate}) fuse_steps={K}: {rate:.1f} "
            f"stream-steps/s")

    log("phase 4: the entry points: the launcher, --fuse-steps 1 and 8 in "
        "turns, and the kernel bench")
    launcher = phase_launcher(torch, ops)
    bench_launches = phase_kernel_bench(torch, ops)

    log("phase 5: times on the card")
    variants = phase_times(np, torch, ts, ops, AcceleratorSession,
                           feedforward, cfg)
    fused_variants = phase_times_fused(np, torch, tsf, ops, bitpack,
                                       AcceleratorSession, feedforward, cfg,
                                       variants)
    lif_t, enc_t = phase_times_elementwise(np, torch, lif, enc, ref, ops)

    log("phase 6: the event path and Cerebra-S on the card")
    event_launches, event_times = phase_event_path(np, torch, ops)
    s_launches, s_step = phase_cerebra_s(np, torch, ops, feedforward, cfg)

    log("phase 7: the front door on the card")
    front_launches, front_rates = phase_front_door(
        np, torch, ops, AcceleratorSession, feedforward, cfg,
        refs["batch-tile"])
    carry_us, blob_bytes = phase_carry_times(np, torch, AcceleratorSession,
                                             feedforward, cfg)
    entry_launches, obs_rec = phase_front_door_entry_points(torch, ops)
    for name in ("spike_timestep", "spike_timestep_fused"):
        check(front_launches[name] > 0 and entry_launches[name] > 0,
              f"phase 7 launched no {name} kernel")

    log("phase 8: the mesh on the card")
    mesh_launches, mesh_rates = phase_mesh_serve(
        np, torch, ops, AcceleratorSession, feedforward, cfg, refs,
        ref_preds)
    worst_shard = phase_mesh_kernel_shapes(torch, ts, ops)
    phase_mesh_carries(np, torch, AcceleratorSession, feedforward, cfg, refs)
    mesh_entry_launches, mesh_bench = phase_mesh_entry_points(torch, ops)
    mesh_times, mesh_host = phase_mesh_times(
        np, torch, AcceleratorSession, feedforward, cfg)

    log("phase 9: training and the paper's HW-vs-SW deviation on the card")
    trained = phase_training(np, torch, ops, cfg, card)

    log("phase 10: the paper's tables on the card")
    tables = phase_tables(np, torch, ops, card)

    log("phase 11: the dense LM serving path at full width on the card")
    phase_lm(np, torch, card)

    log("phase 12: the attention-family LM blocks at full width on the "
        "card")
    phase_lm_zoo(np, torch, card, args.seed)

    log("phase 13: the non-attention LM families and whisper at full width "
        "on the card")
    phase_lm_zoo_recurrent(np, torch, card, args.seed)

    log("phase 14: LM training on the card")
    lm_train = phase_lm_train(np, torch, card)

    log("phase 15: the LM train step across ranks, one process a card")
    phase_lm_ranks(np, torch, card)

    log("phase 16: the dry-run of phase 14's cell on fake tensors")
    phase_lm_dryrun(np, torch, card, lm_train["whole"])

    log("phase 17: prefill and decode across ranks, one process a card")
    phase_lm_serve_ranks(np, torch, card)
    check_no_jax()

    print(card, flush=True)  # name, power limit as nvidia-smi gives them
    for what, (dev_us, wall_us, busy_us) in [*event_times.items(),
                                             ("Cerebra-S step", s_step)]:
        log(f"time {what}: device {dev_us:.1f} us between events, wall "
            f"{wall_us:.1f} us, device busy {busy_us:.1f} us "
            f"({100 * busy_us / wall_us:.1f} % of wall) per call ({card})")
    for what, us in carry_us.items():
        log(f"time {what}: wall {us:.1f} us per call, a P = 1024 carry "
            f"({blob_bytes} B blob) ({card})")
    for backend in ("cuda", "cuda-f32"):
        for K in (1, 8):
            log(f"rate {backend} K={K}: async FIFO "
                f"{front_rates[f'async FIFO {backend}/K={K}']:.1f} vs sync "
                f"{rates[(backend, 'batch-tile', K)]:.1f} stream-steps/s "
                f"(phase 3) ({card})")
    for what, rounds in mesh_times.items():
        walls = sorted(w for _, w, _ in rounds)
        dev_us, wall_us, busy_us = rounds[0]
        log(f"time one step of the 8-slot slice, {what}: device "
            f"{dev_us:.1f} us between events, wall {wall_us:.1f} us, device "
            f"busy {busy_us:.1f} us ({100 * busy_us / wall_us:.1f} % of "
            f"wall) in round 1; wall over 5 rounds min / median / max "
            f"{walls[0]:.1f} / {walls[2]:.1f} / {walls[-1]:.1f} us, busy "
            + " / ".join(f"{b:.1f}" for _, _, b in rounds) + f" us ({card})")
    for what, rate in mesh_rates.items():
        log(f"rate {what}: {rate:.1f} stream-steps/s ({card})")
    log(f"obs overhead (kernel_bench --obs-overhead, cuda): "
        f"{obs_rec['overhead_frac']:+.4f} (instrumented "
        f"{obs_rec['instrumented_us_per_step']} vs bare "
        f"{obs_rec['bare_us_per_step']} us/step) ({card})")
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
        "max_abs_err": max(worst, worst_stress, worst_shard,
                           main_v["max_abs_err"]),
        "ms": main_v["ms"],
        "plain_ms": main_v["plain_ms"],
        "bound_ms": main_v["bound_ms"],
        "bound_by": main_v["bound_by"],
        "library_ms": None,
        "variants": variants,
        "served_stream_steps": served_steps,
        "event_path_launches": event_launches["spike_timestep"],
        "cerebra_s_launches": s_launches["spike_timestep"],
        "front_door_launches": front_launches["spike_timestep"],
        "front_door_entry_launches": entry_launches["spike_timestep"],
        "mesh_launches": mesh_launches,
        "mesh_entry_launches": mesh_entry_launches["spike_timestep"],
        "mesh_stream_steps_per_s": mesh_rates,
        "mesh_step_us": {what: [{"device": d, "wall": w, "busy": b}
                                for d, w, b in rounds]
                         for what, rounds in mesh_times.items()},
        "mesh_step_host_us": {what: {k: v for k, v in b.items()
                                     if k != "top"}
                              for what, b in mesh_host.items()},
        "mesh_bench_us": mesh_bench,
        "evaluate_dual_launches": trained["launches"],
        "training": trained,
        "tables_launches": tables["launches"],
        "tables": tables,
        "card": card,
    }, {
        "name": "spike_timestep_fused",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/spike_timestep_fused.cu",
        "replaces": "src/repro/kernels/spike_timestep.py:208",
        "launches": fused_launches,
        "max_abs_err": max(worst_fused, worst_stress, main_f["max_abs_err"]),
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
        "event_path_launches": event_launches["spike_timestep_fused"],
        "front_door_launches": front_launches["spike_timestep_fused"],
        "front_door_entry_launches": entry_launches["spike_timestep_fused"],
        "front_door_stream_steps_per_s": front_rates,
        "carry_wall_us": carry_us,
        "obs_overhead_frac": obs_rec["overhead_frac"],
        "card": card,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{name}.cu",
        "replaces": replaces,
        "launches": bench_launches[name],
        **t,
        "max_abs_err": max(worst_k, t["max_abs_err"]),
        "library_ms": None,
        "main_path": "repro_torch.benchmarks.kernel_bench",
        "card": card,
    } for name, replaces, worst_k, t in (
        ("lif_step", "src/repro/kernels/lif_step.py:27", worst_lif, lif_t),
        ("poisson_encode", "src/repro/kernels/poisson_encode.py:38",
         worst_enc, enc_t))]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
