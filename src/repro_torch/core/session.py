"""AcceleratorSession — the SoC orchestration layer (SpikeCore's role).

Twin of :mod:`repro.core.session`: deploys models into disjoint cluster
ranges (multi-model co-residency), runs them solo or fused in one engine
pass over the union SRAM image, and hands out streaming views
(:meth:`AcceleratorSession.serve`) over one fused-engine server per LIF
configuration.

Not taken yet: the stream-state connector (a deploy while streams are
live raises instead of draining them), the async ``frontend=``, the mesh
and the metrics / tracer hooks.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import cerebra_h, coding
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
    """

    def __init__(self, config: cerebra_h.CerebraHConfig | None = None,
                 backend: str = "reference", device="cuda",
                 fuse_steps: int = 1):
        self.config = config or cerebra_h.CerebraHConfig()
        self.backend = backend
        self.device = resolve_device(device)
        self.fuse_steps = int(fuse_steps)
        self.models: dict[str, DeployedModel] = {}
        self._next_cluster = 0
        self._next_input = 0
        # {(model names, lif signature, backend, K): SpikeEngine}
        self._fused_engines: dict = {}
        # {(group names, sig, backend, K, slots, chunk, gate): SpikeServer}
        self._stream_servers: dict = {}
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

        Raises ``NotImplementedError`` while any stream is attached: the
        rolling redeploy drains live carries through the stream-state
        connector, which is not ported yet.
        """
        if name in self.models:
            raise ValueError(f"model {name!r} already deployed")
        live = sum(len(s.scheduler.active) + len(s.scheduler.waiting)
                   for s in self._stream_servers.values())
        if live:
            raise NotImplementedError(
                f"deploy with {live} live stream(s) needs the stream-state "
                f"connector to park their carries, which is not ported yet "
                f"(ROADMAP Queue 3); detach the streams first")
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
        self._fused_engines.clear()   # resident set changed
        self._stream_servers.clear()  # fused layout changed with it
        self._serve_epoch += 1
        return model

    # ------------------------------------------------------------------
    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def run(self, name: str, intensities, num_steps: int, seed: int) -> dict:
        """Encode -> infer -> decode for one resident model.

        intensities: (B, n_inputs) in [0, 1]; ``seed`` seeds the Poisson
        encoder (the same seed gives the same spikes). Returns
        :func:`cerebra_h.run`'s result plus ``'predictions'``.
        """
        model = self.models[name]
        spikes = coding.poisson_encode(self._generator(seed), intensities,
                                       num_steps, dtype=torch.int32)
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
        key = (tuple(m.name for m in members), sig, self.backend,
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
        self._fused_engines[key] = engine
        return engine

    def run_all(self, inputs: dict, num_steps: int, seed: int) -> dict:
        """Advance every resident model in one fused engine pass per LIF
        configuration. Each model is encoded with the generator seed
        :meth:`run` would use, and its decoded outputs (and cost-model
        counts) are bit-identical to a solo deployment."""
        members = [self.models[name] for name in inputs]
        batches = {np.shape(inputs[m.name])[0] for m in members}
        if len(batches) > 1:
            raise ValueError(f"batch sizes differ across models: {batches}")
        ext = {m.name: coding.poisson_encode(
                   self._generator(seed), inputs[m.name], num_steps,
                   dtype=torch.int32)
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
        A later :meth:`deploy` invalidates outstanding views.
        """
        from repro_torch.serving.snn import ModelStream, SpikeServer

        if frontend is not None:
            raise NotImplementedError(
                "the async frontend is not ported yet (ROADMAP Queue 1 "
                "item 8); feed the view synchronously")
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
                                 device=self.device)
            self._stream_servers[key] = server
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
        )

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
