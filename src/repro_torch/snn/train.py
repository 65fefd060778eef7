"""Surrogate-gradient training for the spiking MLPs (paper §VI-A role).

Twin of :mod:`repro.snn.train`: rate-encode (the port's threefry, so a
key gives the twin's spikes) -> BPTT with the fast-sigmoid surrogate
(autograd through :func:`repro_torch.core.lif.surrogate_spike`) -> Adam
with the twin's arithmetic (:mod:`repro_torch.training.optimizers`);
optionally data-parallel over a list of devices, one controller.

The twin's training path is plain ``jnp`` with no Pallas kernel, so this
one is plain torch: ``spk @ W`` is ``torch.matmul``, in full float32 on
the card (TF32 off for the forward and the backward products).

Evaluation runs both arithmetic paths on identical spike trains:
  software: float32, exact trained decay (``software.run_software``);
  hardware: the bit-exact Cerebra-H model (quantized weights, snapped
            shift decay) via ``cerebra_h.run``, whose kernel backends
            launch ``csrc/spike_timestep.cu`` on the card.
Their accuracy difference is the paper's Table IV deviation.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.core import cerebra_h, coding, prng, software
from repro_torch.device import ieee_fp32_matmul, resolve_device
from repro_torch.snn.model import (
    SNNModelConfig,
    forward,
    init_params,
    to_snnetwork,
)
from repro_torch.training import optimizers

__all__ = ["TrainConfig", "loss_fn", "loss_grads", "make_train_step",
           "make_sharded_train_step", "train", "evaluate_dual"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: SNNModelConfig = dataclasses.field(default_factory=SNNModelConfig)
    num_steps_time: int = 25          # T during training
    lr: float = 2e-3
    batch_size: int = 128
    train_steps: int = 300
    rate_reg: float = 1e-6            # hidden-rate regularizer
    grad_clip: float = 1.0
    seed: int = 0


def loss_fn(params, spikes, labels, config: TrainConfig):
    """Spike-count cross entropy (snnTorch's ce_rate_loss) plus the
    hidden-rate regularizer. Returns ``(loss, {'loss': ce, 'acc': acc})``.
    """
    out = forward(params, spikes, config.model)
    counts = out["output_counts"]
    logp = torch.log_softmax(counts, dim=-1)
    ce = -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))
    reg = config.rate_reg * out["hidden_spike_total"] / spikes.shape[1]
    acc = torch.mean((torch.argmax(counts, -1) == labels).to(torch.float32))
    return ce + reg, {"loss": ce, "acc": acc}


def loss_grads(params, spikes, labels, config: TrainConfig):
    """``jax.value_and_grad(loss_fn, has_aux=True)``'s gradients and
    metrics: ``(grads, {'loss', 'acc'})`` w.r.t. ``params``, on their
    device. Forward and backward products run in full float32 (no TF32),
    whatever the global setting."""
    leaves = [w.detach().requires_grad_(True) for w in params]
    with ieee_fp32_matmul():
        loss, metrics = loss_fn(leaves, spikes, labels, config)
        grads = torch.autograd.grad(loss, leaves)
    return list(grads), {k: v.detach() for k, v in metrics.items()}


@torch.no_grad()
def _apply(params, grads, opt_state, config: TrainConfig,
           opt: optimizers.Optimizer):
    grads, gnorm = optimizers.clip_by_global_norm(grads, config.grad_clip)
    updates, opt_state = opt.update(grads, opt_state, params)
    params = optimizers.apply_updates(params, updates)
    # hardware-deployability constraint: clip weights into the Q16.16-safe
    # range (also keeps the cuda-f32 backend exact)
    clip = config.model.weight_clip
    params = [torch.clamp(w, -clip, clip) for w in params]
    return params, opt_state, gnorm


def make_train_step(config: TrainConfig, opt: optimizers.Optimizer):
    """``step(params, opt_state, key, images, labels) -> (params,
    opt_state, metrics)`` on the devices of ``images`` and the params."""

    def train_step(params, opt_state, key, images, labels):
        spikes = coding.poisson_encode(key, images, config.num_steps_time)
        grads, metrics = loss_grads(params, spikes, labels, config)
        params, opt_state, gnorm = _apply(params, grads, opt_state, config,
                                          opt)
        return params, opt_state, dict(metrics, grad_norm=gnorm)

    return train_step


def train(config: TrainConfig, data_iter, *, params=None, opt_state=None,
          start_step: int = 0, log_every: int = 50, log_fn=print,
          device="cuda"):
    """Train on ``device`` (default ``"cuda"``; pass ``"cpu"`` for the
    host); resumable via (params, opt_state, start_step)."""
    dev = resolve_device(device)
    # split deterministically BEFORE the init branch so a resumed run (params
    # supplied) folds the same per-step keys as the original run did
    k0, key = prng.split(prng.key(config.seed))
    if params is None:
        params = init_params(k0, config.model, device=dev)
    opt = optimizers.adam(config.lr)
    if opt_state is None:
        opt_state = opt.init(params)
    step_fn = make_train_step(config, opt)
    metrics = {}
    for step, images, labels in data_iter:
        key_t = prng.fold_in(key, step)
        params, opt_state, metrics = step_fn(
            params, opt_state, key_t, _on(images, dev), _on(labels, dev))
        if log_every and step % log_every == 0:
            log_fn(f"step {step}: loss={float(metrics['loss']):.4f} "
                   f"acc={float(metrics['acc']):.3f}")
    return params, opt_state, metrics


def _on(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x).to(dev)


# --------------------------------------------------------------------------
def evaluate_dual(params, config: SNNModelConfig, images, labels, *,
                  num_steps_time: int, seed: int = 0,
                  h_config: cerebra_h.CerebraHConfig | None = None,
                  backend: str = "cuda", device="cuda") -> dict:
    """Software vs hardware accuracy on identical spike trains.

    Both halves run on ``device`` (default ``"cuda"``; ``"cpu"`` for the
    host). ``backend`` selects the SpikeEngine backend of the hardware
    half. It defaults to ``"cuda"``, the kernel backend, where the JAX
    twin defaults to ``"reference"``: on the card it launches
    ``csrc/spike_timestep.cu`` once a timestep, on the host it runs that
    kernel's plain version. Every backend gives the same bytes.

    Returns {'software_acc', 'hardware_acc', 'deviation_pct', 'agreement',
    'hw_counts'}; ``hw_counts`` is ``cerebra_h.run``'s dict.
    """
    dev = resolve_device(device)
    net = to_snnetwork(params, config)
    spikes = coding.poisson_encode(prng.key(seed), _on(images, dev),
                                   num_steps_time, dtype=torch.int32)
    labels = np.asarray(labels)

    sw = software.run_software(net, spikes.to(torch.float32), device=dev)
    sw_pred = torch.argmax(sw["output_counts"], -1).cpu().numpy()

    program = cerebra_h.compile_network(net, h_config)
    hw = cerebra_h.run(program, spikes, backend=backend, device=dev)
    hw_pred = torch.argmax(hw["output_counts"], -1).cpu().numpy()

    sw_acc = float((sw_pred == labels).mean())
    hw_acc = float((hw_pred == labels).mean())
    return {
        "software_acc": sw_acc,
        "hardware_acc": hw_acc,
        "deviation_pct": (hw_acc - sw_acc) * 100.0,
        "agreement": float((sw_pred == hw_pred).mean()),
        "hw_counts": hw,
    }


# --------------------------------------------------------------------------
# Data-parallel variant: one controller over a list of devices (which may
# repeat, as a SpikeMesh's may). The batch splits into equal shards in
# order; each shard runs forward and backward on its device against a
# replica of the params; the shard grads are summed in shard order on the
# first device and averaged, which is the full batch's gradient (the loss
# is a batch mean); the update runs once there.
# --------------------------------------------------------------------------

def make_sharded_train_step(config: TrainConfig, opt: optimizers.Optimizer,
                            devices: Sequence):
    """``step(params, opt_state, key, images, labels)`` as
    :func:`make_train_step`'s, data-parallel over ``devices``. The spikes
    are encoded for the whole batch on the first device (the unsharded
    step's spikes), then split. Params and state live on the first device.
    """
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("make_sharded_train_step needs at least one device")
    n = len(devs)

    def step(params, opt_state, key, images, labels):
        home = devs[0]
        images, labels = _on(images, home), _on(labels, home)
        B = images.shape[0]
        if B % n:
            raise ValueError(f"batch {B} does not split into {n} equal "
                             f"shards")
        spikes = coding.poisson_encode(key, images, config.num_steps_time)
        b = B // n
        total, shard_metrics = None, []
        for i, d in enumerate(devs):
            g, m = loss_grads([w.to(d) for w in params],
                          spikes[:, i * b:(i + 1) * b].to(d),
                          labels[i * b:(i + 1) * b].to(d), config)
            g = [x.to(home) for x in g]
            total = g if total is None else [t + x for t, x in zip(total, g)]
            shard_metrics.append(m)
        grads = [t / n for t in total]
        metrics = {k: torch.stack([m[k].to(home) for m in shard_metrics]
                                  ).mean() for k in shard_metrics[0]}
        params, opt_state, gnorm = _apply(params, grads, opt_state, config,
                                          opt)
        return params, opt_state, dict(metrics, grad_norm=gnorm)

    return step
