"""LM training launcher: ``python -m repro_torch.launch.train --arch <id>``.

Twin of :mod:`repro.launch.train`: arch registry -> model -> AdamW over
a warmup-cosine schedule -> the stateless token stream
(:mod:`repro_torch.data.lm`) -> the fault-tolerant loop
(:func:`repro_torch.training.loop.run_loop`: atomic checkpoints,
resume-exact restart, straggler hooks). A step is the twin's plain one:
value and gradient of the loss, global-norm clip to 1, the AdamW update
(no microbatching, no remat). The default is each arch's REDUCED config;
``--full`` is the published width. Runs on ``--device`` (default
``cuda``; ``cpu`` for the host) and prints the twin's ``[train]`` lines.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b --full

Fault tolerance: run with ``--checkpoint-dir D --fail-at-step K``, then
run the same command again; the loop resumes from the latest checkpoint
and reproduces the uninterrupted trajectory. ``main`` returns the final
state.

Across ranks: ``--ranks --mesh DxM`` launches one process a device of
the ``(data, model)`` mesh on a process group (NCCL on ``cuda``, one card
a rank; gloo on ``--device cpu``), each running
:meth:`repro_torch.launch.steps.LMHarness.make_train_step` on its shards
(FSDP over ``data``, tensor parallelism over ``model``, one sequence a
batch shard a microbatch) under the same schedule; ``--mesh PxDxM`` adds
a leading ``pod`` axis of ``P`` (the batch over ``(pod, data)``, the
params and the state replicated over ``pod``, the gradients summed over
it). A mesh
larger than the visible cards raises; a rank that fails ends every rank
and the launcher with a nonzero exit. Checkpoints are gathered to rank 0
in the one-process layout (one file serves both forms) and scattered on
resume.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --ranks --mesh 2x2 --steps 8
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --ranks --mesh 2x2x1 --steps 8
    python -m repro_torch.launch.train --ranks --mesh 4x1 --full
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.configs.shapes import Shape
from repro_torch.core import prng
from repro_torch.data import lm
from repro_torch.device import resolve_device
from repro_torch.distributed import process_group as pg
from repro_torch.launch.mesh import make_rank_mesh
from repro_torch.launch.steps import LMHarness
from repro_torch.training import optimizers
from repro_torch.training.loop import LoopConfig, Shards, run_loop
from repro_torch.tree import leaves, unflatten


RANK_TIMEOUT_S = 900.0   # seconds a rank's collective may wait


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b",
                    choices=configs.list_archs())
    ap.add_argument("--full", action="store_true",
                    help="use the full published config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="simulate preemption (restart resumes)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--ranks", action="store_true",
                    help="one process a device of --mesh, on a process "
                         "group (nccl on cuda, gloo on cpu)")
    ap.add_argument("--mesh", default=None,
                    help="DxM: data x model ranks, or PxDxM with a pod "
                         "axis (with --ranks)")
    ap.add_argument("--fail-rank", type=int, default=None,
                    help="with --fail-at-step: only this rank fails")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init-method", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.mesh is not None and not args.ranks:
        ap.error("--mesh runs one process a device: it needs --ranks")
    if args.ranks:
        args.mesh = args.mesh or "1x1"
        if args.rank is None:
            return _launch_ranks(args, sys.argv[1:] if argv is None
                                 else list(argv))
        return _rank_main(args)
    dev = resolve_device(args.device)

    mod = configs.get_arch(args.arch)
    cfg = mod.CONFIG if args.full else mod.REDUCED
    h = LMHarness(args.arch, cfg=cfg, lr=args.lr)
    model = h.model
    opt = optimizers.adamw(
        optimizers.Schedules.warmup_cosine(args.lr, args.steps // 10,
                                           args.steps))
    n_params = sum(t.numel() for t in leaves(h.param_shapes()))
    print(f"[train] arch={args.arch} params={n_params/1e6:.1f}M "
          f"batch={args.batch} seq={args.seq}")

    def initial_state():
        params = model.init(prng.key(0), device=dev)
        return {"params": params, "opt": opt.init(params),
                "step": np.asarray(0)}

    def step_fn(state, batch):
        params = state["params"]
        live = [p.detach().requires_grad_() for p in leaves(params)]
        loss, _ = model.loss(unflatten(params, live), batch)
        grads = unflatten(params, list(torch.autograd.grad(loss, live)))
        with torch.no_grad():
            grads, gnorm = optimizers.clip_by_global_norm(grads, 1.0)
            updates, opt_state = opt.update(grads, state["opt"], params)
            params = optimizers.apply_updates(params, updates)
        return dict(state, params=params, opt=opt_state), {
            "loss": loss.detach(), "grad_norm": gnorm}

    stream = lm.TokenStream(cfg.vocab_size, seed=0)

    def batch_fn(step):
        toks = torch.from_numpy(stream.sample(args.batch, args.seq, step))
        return {"tokens": toks[:, :-1].to(torch.int32).to(dev),
                "targets": toks[:, 1:].to(torch.int32).to(dev)}

    loop_cfg = LoopConfig(
        total_steps=args.steps,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        log_every=args.log_every,
        fail_at_step=args.fail_at_step,
    )
    # the initial state is made in the call, so no frame here keeps it
    # alive beside the loop's (2 x 25 GB at granite-3-2b's full width)
    state = run_loop(loop_cfg, initial_state(), step_fn, batch_fn)
    print(f"[train] done at step {int(state['step'])}")
    return state


def _mesh_of(text: str) -> tuple[tuple, tuple]:
    """``(axis names, sizes)`` of ``DxM`` or ``PxDxM``."""
    sizes = tuple(int(v) for v in text.lower().split("x"))
    names = {2: ("data", "model"), 3: ("pod", "data", "model")}.get(
        len(sizes))
    if names is None or min(sizes) < 1:
        raise ValueError(f"--mesh {text}: DxM or PxDxM, each at least 1")
    return names, sizes


def _launch_ranks(args, argv) -> dict:
    """Start one process a rank, watch them, and end them all when one
    fails: the launcher's exit code is the first failure's."""
    _, sizes = _mesh_of(args.mesh)
    world = int(np.prod(sizes))
    dev = resolve_device(args.device)
    if dev.type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"a {args.mesh} mesh needs {world} cards; "
                         f"{torch.cuda.device_count()} are visible")
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        if dev.type == "cuda":
            init = f"tcp://localhost:{pg.free_port()}"
        else:
            init = "file://" + os.path.join(tmp, "store")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train", *argv,
             "--rank", str(r), "--init-method", init])
            for r in range(world)]
        failed = None
        try:
            while failed is None and any(p.poll() is None for p in procs):
                failed = next((p.returncode for p in procs
                               if p.returncode not in (None, 0)), None)
                time.sleep(0.05)
            if failed is None:
                failed = next((p.returncode for p in procs
                               if p.returncode), None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.terminate()
            for p in procs:
                try:
                    p.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
    if failed:
        print(f"[train] a rank failed (exit {failed}); all {world} ended",
              flush=True)
        raise SystemExit(failed if failed > 0 else 1)
    print(f"[train] {world} ranks done", flush=True)
    return {"ranks": world}


def _rank_main(args) -> dict:
    """One rank: its shards of the params and the state, the harness's
    train step on the rank mesh, the loop with gathered checkpoints."""
    names, sizes = _mesh_of(args.mesh)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", args.rank)
    else:
        torch.set_num_threads(1)   # the host's ranks share its cores
    groups = pg.init_ranks(names, sizes, rank=args.rank,
                           init_method=args.init_method, device=dev,
                           timeout_s=RANK_TIMEOUT_S)
    try:
        return _rank_loop(args, groups)
    finally:
        pg.shutdown()


def _rank_loop(args, groups) -> dict:
    mesh = make_rank_mesh(groups)
    mod = configs.get_arch(args.arch)
    cfg = mod.CONFIG if args.full else mod.REDUCED
    h = LMHarness(args.arch, cfg=cfg, lr=args.lr)
    h.opt = optimizers.adamw(
        optimizers.Schedules.warmup_cosine(args.lr, args.steps // 10,
                                           args.steps))
    shape = Shape("train", args.seq, args.batch, "train")
    train_step = h.make_train_step(shape, mesh)
    (p_shard, o_shard, _), _, _ = h.shardings(shape, mesh, "train")
    rank = groups.rank
    log = print if rank == 0 else (lambda *a, **k: None)
    n_params = sum(t.numel() for t in leaves(h.param_shapes()))
    log(f"[train] arch={args.arch} params={n_params/1e6:.1f}M "
        f"batch={args.batch} seq={args.seq} ranks={args.mesh}")
    shardings = {"params": p_shard, "opt": o_shard}
    full_like = {"params": h.param_shapes(), "opt": h.opt_shapes()}

    def initial_state():
        params = h.model.init(prng.key(0), device=groups.device,
                              shard=(p_shard, rank))
        return {"params": params, "opt": h.opt.init(params),
                "step": np.asarray(0)}

    def gather(state):
        full = pg.gather_tree({k: state[k] for k in shardings}, shardings,
                              groups)
        return None if full is None else dict(full, step=state["step"])

    def scatter(full, state):
        out = pg.scatter_tree(
            None if full is None else {k: full[k] for k in shardings},
            full_like, shardings, groups)
        step = torch.tensor(0 if full is None else int(full["step"]),
                            device=groups.device)
        pg.all_reduce_(step, groups, None, op="max")
        return dict(out, step=np.asarray(int(step)))

    def step_fn(state, batch):
        params, opt_state, metrics = train_step(state["params"],
                                                state["opt"], batch)
        return dict(state, params=params, opt=opt_state), metrics

    stream = lm.TokenStream(cfg.vocab_size, seed=0)

    def batch_fn(step):
        toks = torch.from_numpy(stream.sample(args.batch, args.seq, step))
        return {"tokens": toks[:, :-1].to(torch.int32),
                "targets": toks[:, 1:].to(torch.int32)}

    fail = args.fail_at_step if args.fail_rank in (None, rank) else None
    loop_cfg = LoopConfig(total_steps=args.steps,
                          checkpoint_dir=args.checkpoint_dir,
                          checkpoint_every=args.checkpoint_every,
                          log_every=args.log_every, fail_at_step=fail)
    state = run_loop(loop_cfg, initial_state(), step_fn, batch_fn,
                     log_fn=log, shards=Shards(rank == 0, gather, scatter))
    log(f"[train] done at step {int(state['step'])}")
    return state


if __name__ == "__main__":
    main()
