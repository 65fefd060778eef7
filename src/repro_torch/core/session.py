"""AcceleratorSession — the SoC orchestration layer (SpikeCore's role).

Twin of :mod:`repro.core.session`: deploys models into disjoint cluster
ranges (multi-model co-residency), runs them solo or fused in one engine
pass over the union SRAM image, and hands out streaming views
(:meth:`AcceleratorSession.serve`) over one fused-engine server per LIF
configuration, optionally behind one async frontend per server. A deploy
while streams are live is a rolling redeploy: their carries park in the
session's stream-state connector and the next ``serve`` restores them.
With a mesh, the fused engines run sharded over it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import cerebra_h, coding, prng
from repro_torch.core.engine import DecaySpec, SpikeEngine
from repro_torch.core.mapping import ClusterGeometry, Placement
from repro_torch.core.network import SNNetwork
from repro_torch.device import resolve_device

__all__ = ["AcceleratorSession", "DeployedModel"]


@dataclasses.dataclass
class DeployedModel:
    name: str
    program: cerebra_h.CerebraHProgram
    cluster_range: tuple[int, int]   # [lo, hi) physical clusters
    input_offset: int                # external-source base address


class AcceleratorSession:
    """Host-side runtime for one Cerebra-H accelerator instance.

    ``backend`` ("reference" | "cuda" | "cuda-f32") selects the engine
    backend for every run; ``device`` (default ``"cuda"``, raising without
    a card) is where engines, carries and rasters live. ``fuse_steps`` K
    is the fused kernel window of every engine the session builds (1 =
    single-step kernels); outputs are byte-identical for any K.
    ``connector`` (default: an
    :class:`~repro_torch.serving.connector.InMemoryCarryConnector`) parks
    in-flight carries across a redeploy and backs the frontends' spill;
    ``metrics`` / ``tracer`` are threaded into every server, frontend and
    connector the session builds. ``mesh`` (a
    :class:`~repro_torch.distributed.spike_mesh.SpikeMesh`, see
    ``make_spike_mesh``) scales the fused paths out: ``run_all`` and the
    servers behind :meth:`serve` step a mesh-sharded engine, byte-identical
    to the single-device session; encoding and solo :meth:`run` stay on
    ``device``.
    """

    def __init__(self, config: cerebra_h.CerebraHConfig | None = None,
                 backend: str = "reference", device="cuda", mesh=None,
                 fuse_steps: int = 1, connector=None, metrics=None,
                 tracer=None):
        from repro_torch.serving.connector import InMemoryCarryConnector

        self.config = config or cerebra_h.CerebraHConfig()
        self.backend = backend
        self.device = resolve_device(device)
        self.mesh = mesh
        self.fuse_steps = int(fuse_steps)
        self.metrics = metrics
        self.tracer = tracer
        self.connector = (connector if connector is not None
                          else InMemoryCarryConnector())
        if (metrics is not None or tracer is not None) and hasattr(
                self.connector, "instrument"):
            self.connector.instrument(metrics, tracer)
        # {lif signature: [(uid, connector key | None), ...]}: streams
        # parked by deploy(), FIFO restore order, consumed by serve(); a
        # None key is a stream that was still waiting for a slot
        self._parked_groups: dict = {}
        self.models: dict[str, DeployedModel] = {}
        self._next_cluster = 0
        self._next_input = 0
        # {(model names, lif signature, backend, mesh, K): SpikeEngine}
        self._fused_engines: dict = {}
        # {(group names, sig, backend, K, slots, chunk, gate): SpikeServer}
        self._stream_servers: dict = {}
        # async front doors, keyed like the servers they queue for
        self._frontends: dict = {}
        # bumped on every deploy; stale ModelStream views then raise
        self._serve_epoch = 0

    # ------------------------------------------------------------------
    @property
    def geometry(self) -> ClusterGeometry:
        return self.config.geometry

    def free_clusters(self) -> int:
        return self.geometry.n_clusters - self._next_cluster

    def deploy(self, name: str, net: SNNetwork) -> DeployedModel:
        """Deploy a model into the next free cluster range (config path).

        A ROLLING redeploy when streams are in flight: every live stream
        of every cached server is drained to the session connector first
        (:meth:`_drain_streams`), and the next :meth:`serve` of its LIF
        group restores it into the new fused server; the stream's raster
        continues byte-identically across the deploy."""
        if name in self.models:
            raise ValueError(f"model {name!r} already deployed")
        geom = self.geometry
        npc = geom.neurons_per_cluster
        need = -(-net.n_neurons // npc)  # ceil clusters
        # round up to a group boundary so no two models share a weight SRAM
        cpg = geom.clusters_per_group
        need = -(-need // cpg) * cpg
        if need > self.free_clusters():
            raise ValueError(
                f"model {name!r} needs {need} clusters; only "
                f"{self.free_clusters()} free")
        lo = self._next_cluster
        placement = Placement(geom, lo * npc + np.arange(net.n_neurons))
        program = cerebra_h.compile_network(net, self.config, placement)
        model = DeployedModel(name=name, program=program,
                              cluster_range=(lo, lo + need),
                              input_offset=self._next_input)
        self.models[name] = model
        self._next_cluster += need
        self._next_input += net.n_inputs
        parked = self._drain_streams()  # park in-flight carries first
        self._fused_engines.clear()   # resident set changed
        self._stream_servers.clear()  # fused layout changed with it
        self._frontends.clear()       # queues die with their servers
        self._serve_epoch += 1
        if self.metrics is not None:
            self.metrics.counter("snn_session_deploys_total").inc()
            if parked:
                self.metrics.counter("snn_session_redeploys_total").inc()
        if self.tracer is not None:
            self.tracer.event("deploy", name, models=len(self.models),
                              parked_streams=parked)
        return model

    def _drain_streams(self) -> int:
        """Rolling-redeploy drain: park every in-flight stream of every
        cached server in the session connector. The next :meth:`serve` of
        the same LIF group restores them (FIFO, what fits the new
        server's slots), and their rasters continue byte-identically: the
        physical array size is fixed across deploys, existing models keep
        their cluster ranges and input offsets, and a new model's clusters
        stay silent for other streams. Returns the carries parked."""
        parked = 0
        for key, server in self._stream_servers.items():
            sig = key[1]
            group = self._parked_groups.setdefault(sig, [])
            epoch = self._serve_epoch
            # admitted streams first (dict order = admission order), so
            # FIFO restore keeps the pre-deploy service order
            for uid in server.scheduler.active:
                ckey = ("deploy", epoch, sig, uid)
                self.connector.insert(ckey, server.snapshot_stream(uid))
                group.append((uid, ckey))
                parked += 1
                if self.tracer is not None:
                    self.tracer.event("redeployed", uid, epoch=epoch)
            for uid in server.scheduler.waiting:
                group.append((uid, None))
        return parked

    # ------------------------------------------------------------------
    def _encode(self, key, intensities, num_steps: int) -> torch.Tensor:
        x = torch.as_tensor(intensities, device=self.device)
        return coding.poisson_encode(key, x, num_steps, dtype=torch.int32)

    def run(self, name: str, intensities, num_steps: int, seed) -> dict:
        """Encode -> infer -> decode for one resident model.

        intensities: (B, n_inputs) in [0, 1]. ``seed`` is an int, taken as
        ``prng.key(seed)``, or a :mod:`~repro_torch.core.prng` key; the
        spikes are the JAX package's for ``jax.random.key(seed)`` on any
        device. Returns :func:`cerebra_h.run`'s result plus
        ``'predictions'``.
        """
        model = self.models[name]
        spikes = self._encode(prng.as_key(seed), intensities, num_steps)
        result = cerebra_h.run(model.program, spikes, backend=self.backend,
                               device=self.device)
        result["predictions"] = torch.argmax(result["output_counts"], dim=-1)
        return result

    # ------------------------------------------------------------------
    @staticmethod
    def _lif_signature(program: cerebra_h.CerebraHProgram):
        """The global accelerator config a fused step must share."""
        return (program.decay_rate, program.params.threshold_raw,
                program.params.reset_mode)

    def _fused_engine(self, members: list[DeployedModel]) -> SpikeEngine:
        """One physical-array engine over the union of members' programs:
        external sources concatenated in deployment order, recurrent rows
        summed (disjoint cluster ranges cannot overlap)."""
        sig = self._lif_signature(members[0].program)
        key = (tuple(m.name for m in members), sig, self.backend, self.mesh,
               self.fuse_steps)
        engine = self._fused_engines.get(key)
        if engine is not None:
            return engine
        n_phys = self.geometry.n_physical
        n_ext = sum(m.program.n_inputs for m in members)
        W = torch.zeros((n_ext + n_phys, n_phys), dtype=torch.int32)
        off = 0
        for m in members:
            flat = m.program.weights_raw.reshape(m.program.n_sources, -1)
            n_in = m.program.n_inputs
            W[off:off + n_in] = flat[:n_in]
            W[n_ext:] += flat[n_in:]
            off += n_in
        decay_rate, threshold_raw, reset_mode = sig
        engine = SpikeEngine(W, n_ext, decay=DecaySpec.shift(decay_rate),
                             threshold_raw=threshold_raw,
                             reset_mode=reset_mode, backend=self.backend,
                             fuse_steps=self.fuse_steps, device=self.device)
        if self.mesh is not None:
            engine = engine.to_mesh(self.mesh)
        self._fused_engines[key] = engine
        return engine

    def run_all(self, inputs: dict, num_steps: int, seed) -> dict:
        """Advance every resident model in one fused engine pass per LIF
        configuration. ``seed`` is as in :meth:`run`; each model is encoded
        with the key :meth:`run` would use, and its decoded outputs (and
        cost-model counts) are bit-identical to a solo deployment."""
        members = [self.models[name] for name in inputs]
        batches = {np.shape(inputs[m.name])[0] for m in members}
        if len(batches) > 1:
            raise ValueError(f"batch sizes differ across models: {batches}")
        key = prng.as_key(seed)
        ext = {m.name: self._encode(key, inputs[m.name], num_steps)
               for m in members}
        groups: dict = {}
        for m in members:
            groups.setdefault(self._lif_signature(m.program), []).append(m)

        npc = self.geometry.neurons_per_cluster
        results: dict = {}
        for group in groups.values():
            engine = self._fused_engine(group)
            fused_ext = torch.cat([ext[m.name] for m in group], dim=-1)
            raster = engine.run(fused_ext)["spikes"]  # (T, B, P)
            for m in group:
                lo, hi = m.cluster_range
                # mask to the model's cluster range (other slots silent)
                spikes = torch.zeros_like(raster)
                spikes[:, :, lo * npc:hi * npc] = \
                    raster[:, :, lo * npc:hi * npc]
                prog = m.program
                cost = cerebra_h.cost_model(prog, ext[m.name], spikes)
                out_map = torch.as_tensor(prog.output_map,
                                          device=spikes.device)
                out_counts = spikes[:, :, out_map].sum(dim=0,
                                                       dtype=torch.int32)
                results[m.name] = {
                    "spikes": spikes,
                    "output_counts": out_counts,
                    "cycles": cost["cycles"],
                    "sops": cost["sops"],
                    "row_fetches": cost["row_fetches"],
                    "predictions": torch.argmax(out_counts, dim=-1),
                }
        return results

    # ------------------------------------------------------------------
    def serve(self, name: str, *, n_slots: int = 4, chunk_steps: int = 8,
              gate: str | None = None, frontend=None):
        """Streaming entry: a :class:`~repro_torch.serving.snn.ModelStream`
        view for one resident model.

        All resident models sharing ``name``'s LIF configuration stream
        through ONE fused-engine server; repeated ``serve`` calls reuse it.
        ``gate`` selects the event-gate granularity (identical outputs).

        ``frontend`` (a
        :class:`~repro_torch.serving.frontend.FrontendConfig`) hangs ONE
        :class:`~repro_torch.serving.frontend.AsyncSpikeFrontend` off the
        group's server (co-resident views share its request queue) and
        gives the view ``submit`` / ``submit_events``; async outputs stay
        byte-identical to synchronous ``feed``. A conflicting config for
        the same group raises.

        A later :meth:`deploy` invalidates outstanding views; in-flight
        streams park in the session connector and the re-``serve``
        restores them.
        """
        from repro_torch.serving.frontend import AsyncSpikeFrontend
        from repro_torch.serving.snn import ModelStream, SpikeServer

        model = self.models[name]
        sig = self._lif_signature(model.program)
        group = [m for m in self.models.values()
                 if self._lif_signature(m.program) == sig]
        group_key = (tuple(m.name for m in group), sig, self.backend,
                     self.fuse_steps)
        # gate=None means the engine's own gate: one server key either way
        gate = gate if gate is not None else self._fused_engine(group).gate
        key = group_key + (int(n_slots), int(chunk_steps), gate)
        server = self._stream_servers.get(key)
        if server is None:
            # one server per group, or co-resident streams would split
            for other in self._stream_servers:
                if other[: len(group_key)] == group_key:
                    n_slots_o, chunk_o, gate_o = other[len(group_key):]
                    raise ValueError(
                        f"group {group_key[0]} is already served with "
                        f"n_slots={n_slots_o}, chunk_steps={chunk_o}, "
                        f"gate={gate_o}; co-resident views must share "
                        f"one server")
            server = SpikeServer(self._fused_engine(group), n_slots=n_slots,
                                 chunk_steps=chunk_steps, gate=gate,
                                 device=self.device, metrics=self.metrics,
                                 tracer=self.tracer)
            self._stream_servers[key] = server
            self._restore_parked(sig, server)
        fe = self._frontends.get(key)
        if frontend is not None:
            cfg = frontend
            spill = cfg.spill or (cfg.qos is not None and cfg.qos.preempt)
            if fe is None:
                fe = AsyncSpikeFrontend(
                    server, queue_capacity=cfg.queue_capacity,
                    backpressure=cfg.backpressure,
                    deadline_ms=cfg.deadline_ms,
                    connector=self.connector if spill else None,
                    metrics=self.metrics, tracer=self.tracer,
                    slo=cfg.slo, qos=cfg.qos)
                self._frontends[key] = fe
            elif (fe.queue_capacity, fe.backpressure,
                  fe.default_deadline_ms, fe.qos,
                  fe.connector is not None) != (
                      cfg.queue_capacity, cfg.backpressure,
                      cfg.deadline_ms, cfg.qos, spill):
                raise ValueError(
                    f"group {group_key[0]} already has a frontend with "
                    f"queue_capacity={fe.queue_capacity}, "
                    f"backpressure={fe.backpressure!r}, "
                    f"deadline_ms={fe.default_deadline_ms}, "
                    f"spill={fe.connector is not None}, "
                    f"qos={fe.qos}; co-resident "
                    f"views must share one request queue")
        ext_offset = 0
        for m in group:
            if m.name == name:
                break
            ext_offset += m.program.n_inputs
        npc = self.geometry.neurons_per_cluster
        lo, hi = model.cluster_range
        epoch = self._serve_epoch
        return ModelStream(
            server,
            name=name,
            n_inputs=model.program.n_inputs,
            ext_offset=ext_offset,
            phys_slice=(lo * npc, hi * npc),
            output_map=model.program.output_map,
            stale_check=lambda: self._serve_epoch != epoch,
            frontend=fe,
        )

    def _restore_parked(self, sig, server) -> list:
        """Restore the streams :meth:`_drain_streams` parked for this LIF
        group into the (new) server: FIFO, carries through
        ``attach_stream``, still-waiting uids simply re-queued. Restores
        what fits the free slots; the rest stay parked for a later
        ``serve``. Returns the restored uids."""
        parked = self._parked_groups.pop(sig, [])
        restored, leftovers = [], []
        for uid, ckey in parked:
            if ckey is None:
                server.attach(uid)
                restored.append(uid)
            elif server.scheduler.free_slots > 0:
                snap = self.connector.select(ckey)
                server.attach_stream(snap, uid=uid)
                self.connector.evict(ckey)
                restored.append(uid)
            else:
                leftovers.append((uid, ckey))
        if leftovers:
            self._parked_groups[sig] = leftovers
        return restored

    def utilization(self) -> dict:
        geom = self.geometry
        used_neurons = sum(m.program.n_neurons for m in self.models.values())
        used_rows = sum(
            int(np.sum(m.program.capacity_report["rows_per_group"]))
            for m in self.models.values())
        return {
            "clusters_used": self._next_cluster,
            "clusters_total": geom.n_clusters,
            "neuron_utilization": used_neurons / geom.n_physical,
            "row_utilization": used_rows
            / (geom.n_groups * geom.rows_per_group),
            "models": list(self.models),
        }
