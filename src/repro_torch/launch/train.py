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
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import prng
from repro_torch.data import lm
from repro_torch.device import resolve_device
from repro_torch.launch.steps import LMHarness
from repro_torch.training import optimizers
from repro_torch.training.loop import LoopConfig, run_loop
from repro_torch.tree import leaves, unflatten


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
    args = ap.parse_args(argv)
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


if __name__ == "__main__":
    main()
