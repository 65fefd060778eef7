"""Streaming SNN serving launcher: ``python -m repro_torch.launch.serve_snn``.

Twin of the synchronous mode of :mod:`repro.launch.serve_snn`: brings up
an :class:`~repro_torch.core.session.AcceleratorSession` on ``--device``
(default ``cuda``), deploys co-resident random SNNs, and drives synthetic
Poisson request traffic through the streaming server: streams arrive per
chunk-round, wait FIFO for a batch slot, push their stimulus in
fixed-size chunks through one slot-batch step, and detach. Prints
aggregate steps/s, per-stream latency, chunk dispatch times and the
kernel launches of the run (``--fuse-steps K`` serves K-step fused
windows, one fused kernel launch each).

Not ported yet: ``--async``, ``--qos*``, ``--burst*``, ``--slo-*``,
``--mesh``/``--devices``, ``--connector``, ``--drain``, ``--metrics``,
``--trace``, ``--profile``, ``--flight``, ``--json-summary``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core import coding, prng
from repro_torch.core.engine import BACKENDS, GATES
from repro_torch.core.lif import LIFParams
from repro_torch.core.network import SNNetwork
from repro_torch.core.session import AcceleratorSession
from repro_torch.kernels import ops


def make_net(rng, n_in: int, n_neurons: int, *, density: float = 0.25,
             out: int = 10) -> SNNetwork:
    """Small random recurrent SNN with an output population."""
    W = ((rng.random((n_in + n_neurons, n_neurons)) < density)
         * rng.normal(0.0, 0.5, (n_in + n_neurons, n_neurons)))
    return SNNetwork(
        n_inputs=n_in, n_neurons=n_neurons,
        weights=W.astype(np.float32),
        params=LIFParams(decay_rate=0.25, threshold=1.0, reset_mode="zero"),
        output_slice=(n_neurons - out, n_neurons))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=24,
                    help="total streams to serve")
    ap.add_argument("--n-slots", type=int, default=8,
                    help="batch slots (concurrent streams)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="timesteps pushed per feed() call")
    ap.add_argument("--steps-per-stream", type=int, default=48,
                    help="inference timesteps each stream requests")
    ap.add_argument("--arrival-rate", type=float, default=4.0,
                    help="Poisson arrivals per chunk-round")
    ap.add_argument("--backend", choices=list(BACKENDS), default="reference")
    ap.add_argument("--gate", choices=list(GATES), default=None,
                    help="event-gate granularity of the serving engine "
                         "(per-example = the batch-tile=1 serving mode)")
    ap.add_argument("--fuse-steps", type=int, default=1,
                    help="K timesteps per fused kernel window on the "
                         "serving engine (kernel backends; weight blocks "
                         "fetched once per window, outputs byte-identical "
                         "for any K)")
    ap.add_argument("--models", type=int, default=2,
                    help="co-resident models sharing the fused engine")
    ap.add_argument("--n-inputs", type=int, default=24)
    ap.add_argument("--n-neurons", type=int, default=48)
    ap.add_argument("--intensity", type=float, default=0.25,
                    help="stimulus intensity scale (Poisson spike rate "
                         "cap); event workloads live well below 1.0")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine and its carries "
                         "('cuda' needs a card; 'cpu' runs the plain path)")
    return ap


def _request_plan(args, names, rng) -> list:
    """Stream i -> (uid, model, Poisson-encoded (T, n_inputs) stimulus),
    encoded on the host with the i-th key split off ``prng.key(--seed)``,
    as the JAX launcher splits ``jax.random.key(--seed)``: the same seed
    gives the JAX launcher's stimuli."""
    key = prng.key(args.seed)
    requests = []
    for uid in range(args.streams):
        key, k = prng.split(key)
        intensity = (args.intensity
                     * rng.random((1, args.n_inputs)).astype(np.float32))
        spikes = coding.poisson_encode(k, intensity, args.steps_per_stream,
                                       dtype=torch.int32)[:, 0].numpy()
        requests.append((uid, names[uid % len(names)], spikes))
    return requests


def main(argv=None) -> dict:
    """Run the sync serving loop; prints the summary and returns it."""
    args = build_parser().parse_args(argv)
    if args.arrival_rate <= 0:
        raise SystemExit("--arrival-rate must be > 0 (arrivals per "
                         "chunk-round; the arrival plan cannot make "
                         "progress at rate 0)")
    rng = np.random.default_rng(args.seed)
    sess = AcceleratorSession(backend=args.backend, device=args.device,
                              fuse_steps=args.fuse_steps)
    names = [f"snn{i}" for i in range(args.models)]
    for name in names:
        sess.deploy(name, make_net(rng, args.n_inputs, args.n_neurons))
    # serve AFTER all deploys: deploying invalidates the fused layout
    views = {name: sess.serve(name, n_slots=args.n_slots,
                              chunk_steps=args.chunk, gate=args.gate)
             for name in names}
    server = next(iter(views.values())).server
    print(f"[serve-snn] {args.models} co-resident model(s) on one fused "
          f"engine ({server.engine.n_sources} sources x "
          f"{server.engine.n_phys} neurons), backend={args.backend}, "
          f"gate={server.engine.gate}, fuse_steps={args.fuse_steps}, "
          f"device={server.device}, {args.n_slots} slots x {args.chunk}-step "
          f"chunks")

    requests = _request_plan(args, names, rng)
    # Poisson arrivals: number of new requests per chunk-round
    arrivals: list[list] = []
    i = 0
    while i < len(requests):
        n = int(rng.poisson(args.arrival_rate))
        arrivals.append(requests[i:i + n])
        i += n

    live: dict = {}           # uid -> [name, spikes, cursor]
    t_arrive: dict = {}
    t_done: dict = {}
    dispatch_s: list = []
    rounds = 0
    launches0 = dict(ops.LAUNCHES)
    t0 = time.perf_counter()
    while arrivals or live or server.scheduler.waiting:
        now = time.perf_counter()
        if arrivals:
            for uid, name, spikes in arrivals.pop(0):
                views[name].attach(uid)
                live[uid] = [name, spikes, 0]
                t_arrive[uid] = now
        # ONE batched dispatch per round across models
        done = []
        fused_inputs = {}
        for uid, (name, spikes, cur) in live.items():
            if server.slot_of(uid) is None:
                continue  # still waiting for a slot
            n = min(args.chunk, len(spikes) - cur)
            fused_inputs[uid] = views[name].embed(spikes[cur:cur + n])
            live[uid][2] = cur + n
            if cur + n >= len(spikes):
                done.append(uid)
        if fused_inputs:
            t_chunk = time.perf_counter()
            server.feed(fused_inputs)
            dispatch_s.append(time.perf_counter() - t_chunk)
        for uid in done:
            views[live.pop(uid)[0]].detach(uid)
            t_done[uid] = time.perf_counter()
        rounds += 1
    wall = time.perf_counter() - t0
    launches = {k: n - launches0[k] for k, n in ops.LAUNCHES.items()}

    lats = np.asarray([t_done[u] - t_arrive[u] for u in t_done])
    disp = np.asarray(dispatch_s)
    steps = server.total_steps
    summary = {
        "mode": "sync",
        "device": str(server.device),
        "backend": args.backend,
        "gate": server.engine.gate,
        "fuse_steps": args.fuse_steps,
        "launches": launches,
        "streams_done": len(t_done),
        "steps": int(steps),
        "wall_s": wall,
        "rounds": rounds,
        "steps_per_s": steps / wall,
        "n_slots": args.n_slots,
        "stream_latency_ms": None if not len(lats) else {
            "mean": float(lats.mean() * 1e3),
            "p50": float(np.percentile(lats, 50) * 1e3),
            "p95": float(np.percentile(lats, 95) * 1e3),
        },
        "dispatches": int(disp.size),
        "dispatch_ms": None if not disp.size else {
            "p50": float(np.percentile(disp, 50) * 1e3),
            "p95": float(np.percentile(disp, 95) * 1e3),
        },
    }
    for line in _render(summary):
        print(line)
    return summary


def _render(s: dict) -> list[str]:
    lines = [
        f"[serve-snn] {s['streams_done']} streams, {s['steps']} "
        f"stream-timesteps in {s['wall_s']:.2f}s over {s['rounds']} rounds "
        f"-> {s['steps_per_s']:.0f} steps/s",
        f"[serve-snn] fuse_steps={s['fuse_steps']}: "
        f"{s['launches']['spike_timestep_fused']} fused window launches, "
        f"{s['launches']['spike_timestep']} single-step launches"]
    lat = s["stream_latency_ms"]
    if lat is not None:
        lines.append(
            f"[serve-snn] per-stream latency: mean {lat['mean']:.1f} ms, "
            f"p50 {lat['p50']:.1f} ms, p95 {lat['p95']:.1f} ms "
            f"(queueing under {s['n_slots']} slots)")
    d = s["dispatch_ms"]
    if d is not None:
        lines.append(
            f"[serve-snn] {s['dispatches']} chunk dispatches: "
            f"p50 {d['p50']:.1f} ms, p95 {d['p95']:.1f} ms")
    return lines


if __name__ == "__main__":
    main()
