"""SpikeEngine — the timestep core every accelerator model runs on.

Twin of :mod:`repro.core.engine`. The engine owns the loop over time and
the carries (membrane potential + previous-boundary spikes) and dispatches
the accumulate + fire of each step to a backend:

  ``"reference"``  plain torch: exact int32 product + the shared epilogue.
  ``"cuda"``       the event-gated CUDA kernel, exact int32 accumulate.
  ``"cuda-f32"``   the same kernel summing each 128-source block in fp32;
                   exact only under the 2^24 bound, which is checked at
                   engine build from the weight image.

All three give byte-identical rasters. On a CPU engine the two kernel
backends run the kernels' plain versions (same padding and gate scalars).
JAX's ``lax.scan`` becomes a Python loop over T. With ``fuse_steps`` K > 1
the kernel backends advance in K-step windows, one fused kernel launch
each (``ops.spike_timestep_fused``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core import fixedpoint as fxp
from repro_torch.core.lif import fire_reset, lif_init
from repro_torch.device import resolve_device
from repro_torch.events.aer import AERStream, aer_to_dense, dense_to_aer
from repro_torch.kernels import ops
from repro_torch.kernels.spike_timestep import exact_int32_matmul

__all__ = [
    "BACKENDS",
    "BACKEND_TABLE",
    "GATES",
    "MXU_EXACT_BOUND",
    "DecaySpec",
    "SpikeEngine",
    "mxu_partial_sum_bound",
    "sources_raster",
]

# port backend -> (JAX twin, kernel accumulate mode; None = plain torch)
BACKEND_TABLE: dict[str, tuple[str, str | None]] = {
    "reference": ("reference", None),
    "cuda": ("pallas", "exact"),
    "cuda-f32": ("pallas-mxu", "f32"),
}
BACKENDS: tuple[str, ...] = tuple(BACKEND_TABLE)

# Event-gate granularity: one activity scalar per (8-example batch tile,
# source block), or per (example, source block). Outputs are identical;
# the gate only changes which already-zero work is skipped.
GATES: tuple[str, ...] = ("batch-tile", "per-example")
_GATE_TILE_BATCH = {"batch-tile": 8, "per-example": 1}

# f32 has a 24-bit significand: integer sums stay exact below 2^24.
MXU_EXACT_BOUND: int = 1 << 24
_F32_BLOCK_SRC = 128  # source-block size the f32 accumulate reduces over

@dataclasses.dataclass(frozen=True)
class DecaySpec:
    """Which Potential-Decay Unit the program compiled for: ``shift``
    (Cerebra-H, hardware ``rate``) or ``mul`` (Cerebra-S, raw Q16.16
    retain factor ``raw``)."""

    kind: str
    rate: float = 0.0
    raw: int = 0

    @classmethod
    def shift(cls, rate: float) -> "DecaySpec":
        if rate not in fxp.SHIFT_DECAY_RATES:
            raise ValueError(
                f"shift decay rate {rate} not in {fxp.SHIFT_DECAY_RATES}")
        return cls(kind="shift", rate=float(rate))

    @classmethod
    def mul(cls, raw: int) -> "DecaySpec":
        # raw == 2^16 is beta = 1.0 (leak-free IF): the hi/lo split is the
        # exact identity there
        if not 0 <= raw <= (1 << 16):
            raise ValueError(f"mul retain factor {raw} outside [0, 2^16]")
        return cls(kind="mul", raw=int(raw))

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        if self.kind == "shift":
            return fxp.shift_decay(v, self.rate)
        if self.kind == "mul":
            return fxp.fx_mul(v, self.raw)
        raise ValueError(f"unknown decay kind {self.kind!r}")


def mxu_partial_sum_bound(weights_raw, block_src: int = _F32_BLOCK_SRC, *,
                          fuse_steps: int = 1) -> int:
    """Worst-case f32 partial-sum magnitude of the f32 accumulate: the
    largest per-block column sum of |w| (sources are {0,1}; inter-block
    sums are int32 and always exact). K-invariant, as in the JAX twin."""
    if fuse_steps < 1:
        raise ValueError(f"fuse_steps must be >= 1, got {fuse_steps}")
    w = np.abs(np.asarray(weights_raw, np.int64))
    pad = (-w.shape[0]) % block_src
    if pad:
        w = np.pad(w, ((0, pad), (0, 0)))
    blocks = w.reshape(-1, block_src, w.shape[1]).sum(axis=1)
    return int(blocks.max()) if blocks.size else 0


def sources_raster(ext_spikes: torch.Tensor, spikes: torch.Tensor):
    """(T, B, S) source activity: external spikes + PREVIOUS-step spikes
    (the accelerator captures array spikes at the timestep boundary)."""
    ext = torch.as_tensor(ext_spikes).to(torch.int32)
    spk = torch.as_tensor(spikes).to(torch.int32)
    prev = torch.cat([torch.zeros_like(spk[:1]), spk[:-1]], dim=0)
    return torch.cat([ext.to(spk.device), prev], dim=-1)


def _as_int32(x, device) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x).to(device=device, dtype=torch.int32)


class SpikeEngine:
    """One physical neuron array stepping under a fixed LIF configuration::

        sources_t = concat(external_t, spikes_{t-1})          # (B, S)
        syn_t     = sources_t @ W_raw                         # backend
        v_t, spikes_t = fire_reset(decay(v_{t-1}) + syn_t)    # shared LIF

    ``device`` defaults to ``"cuda"`` and raises when there is no card;
    tests pass ``device="cpu"``.
    """

    def __init__(self, weights_raw, n_inputs: int, *, decay: DecaySpec,
                 threshold_raw: int, reset_mode: str,
                 backend: str = "reference", gate: str = "batch-tile",
                 fuse_steps: int = 1, device="cuda"):
        if backend not in BACKEND_TABLE:
            raise ValueError(f"unknown backend {backend!r}; expected one of "
                             f"{BACKENDS}")
        if gate not in GATES:
            raise ValueError(f"unknown event gate {gate!r}; expected one of "
                             f"{GATES}")
        fuse_steps = int(fuse_steps)
        if fuse_steps < 1:
            raise ValueError(f"fuse_steps must be >= 1, got {fuse_steps}")
        mode = BACKEND_TABLE[backend][1]
        self.device = resolve_device(device)
        weights_raw = _as_int32(weights_raw, self.device)
        if weights_raw.ndim != 2:
            raise ValueError(
                f"weights must be a flat (n_sources, n_phys) SRAM image, "
                f"got shape {tuple(weights_raw.shape)}")
        n_sources, n_phys = weights_raw.shape
        if not 0 <= n_inputs <= n_sources:
            raise ValueError(f"n_inputs={n_inputs} outside [0, {n_sources}]")
        if n_inputs + n_phys != n_sources:
            raise ValueError(
                f"source axis {n_sources} != n_inputs {n_inputs} + n_phys "
                f"{n_phys}: recurrent spikes could not be fed back")
        if mode == "f32":
            w_host = weights_raw.cpu().numpy()
            worst = mxu_partial_sum_bound(w_host, fuse_steps=fuse_steps)
            if worst >= MXU_EXACT_BOUND:
                w_max = int(np.abs(w_host.astype(np.int64)).max())
                raise ValueError(
                    f"cuda-f32 backend rejected at build time: worst-case "
                    f"f32 partial sum {worst} >= 2^24 ({MXU_EXACT_BOUND}) "
                    f"for max |w| = {w_max} raw Q16.16, per-block source "
                    f"fan-in {_F32_BLOCK_SRC}, fuse_steps K = {fuse_steps} "
                    f"(the bound is K-invariant: the fused window stacks "
                    f"along the product's batch axis, never its reduction "
                    f"axis); the f32 accumulate would not be bit-exact for "
                    f"this weight image. Reduce fan-in or weight "
                    f"magnitudes, or use backend='cuda'.")
        self.weights_raw = weights_raw
        self.n_inputs = int(n_inputs)
        self.n_phys = int(n_phys)
        self.n_sources = int(n_sources)
        self.decay = decay
        self.threshold_raw = int(threshold_raw)
        self.reset_mode = str(reset_mode)
        self.backend = backend
        self.gate = gate
        self.fuse_steps = fuse_steps
        self._mode = mode

    # kernel backends pad the image to the block multiples once, at the
    # first step or window, so a step moves no weight copy (the ops
    # wrappers accept the padded layouts as they are); an engine that is
    # only re-hosted (``to_mesh``) never pads its whole image
    @functools.cached_property
    def _kernel_weights(self) -> torch.Tensor:
        return ops._pad_to(ops._pad_to(self.weights_raw, 0, _F32_BLOCK_SRC),
                           1, 128).contiguous()

    @functools.cached_property
    def _fused_weights(self):
        return ops.fused_weights(self.weights_raw, self.n_inputs)

    # ------------------------------------------------------------------
    def _rehost(self, **changes) -> "SpikeEngine":
        kw = dict(decay=self.decay, threshold_raw=self.threshold_raw,
                  reset_mode=self.reset_mode, backend=self.backend,
                  gate=self.gate, fuse_steps=self.fuse_steps,
                  device=self.device)
        kw.update(changes)
        return SpikeEngine(self.weights_raw, self.n_inputs, **kw)

    def with_gate(self, gate: str) -> "SpikeEngine":
        """This program under another event-gate granularity (identical
        outputs). Returns ``self`` when the gate already matches."""
        return self if gate == self.gate else self._rehost(gate=gate)

    def with_fuse_steps(self, fuse_steps: int) -> "SpikeEngine":
        """This program under another K-step window (identical outputs;
        only the kernel granularity and weight traffic differ). Returns
        ``self`` when K already matches."""
        if int(fuse_steps) == self.fuse_steps:
            return self
        return self._rehost(fuse_steps=fuse_steps)

    def to_device(self, device) -> "SpikeEngine":
        """This program on another device. Returns ``self`` when it
        already lives there."""
        dev = resolve_device(device)
        return self if dev == self.device else self._rehost(device=dev)

    def to_mesh(self, mesh):
        """Drop-in scale-out: this program re-hosted on a ``(neuron,
        batch)`` mesh (:class:`repro_torch.distributed.spike_mesh.
        MeshSpikeEngine`), with byte-identical ``run`` / ``step_chunk``."""
        from repro_torch.distributed.spike_mesh import MeshSpikeEngine

        return MeshSpikeEngine.from_engine(self, mesh)

    # ------------------------------------------------------------------
    def init_carry(self, batch: int) -> dict:
        """Power-on state: V = 0, no prior spikes."""
        return {
            "v": lif_init((batch, self.n_phys), fixed=True,
                          device=self.device)["v"],
            "spikes": torch.zeros((batch, self.n_phys), dtype=torch.int32,
                                  device=self.device),
        }

    def carry_rows(self, carry, slot: int):
        """One slot's ``(v, spikes)`` rows of a slot-batch carry."""
        return carry["v"][slot], carry["spikes"][slot]

    def set_carry_rows(self, carry, slot: int, v, spikes) -> None:
        """Overwrite one slot's carry rows in place."""
        carry["v"][slot] = v
        carry["spikes"][slot] = spikes

    def _sources(self, ext_t: torch.Tensor, spikes: torch.Tensor):
        """A step's sources, ``concat(ext_t, spikes_{t-1})``; on a kernel
        backend padded and gated (:func:`ops.gated_sources`), once for
        every weight slice that reads them."""
        sources = torch.cat([ext_t.to(torch.int32), spikes], dim=-1)
        if self._mode is None:
            return sources
        return ops.gated_sources(sources,
                                 block_batch=_GATE_TILE_BATCH[self.gate])

    def _advance(self, sources, v: torch.Tensor, weights: torch.Tensor):
        """Accumulate ``sources`` (from :meth:`_sources`) through
        ``weights``, then decay, integrate and fire ``v``: this engine's
        image, or a mesh shard's column slice of it."""
        if self._mode is None:
            syn = exact_int32_matmul(sources, weights)
            v_new = fxp.wrap_int32(self.decay.apply(v).to(torch.int64)
                                   + syn.to(torch.int64))
            v_out, spikes = fire_reset(v_new, self.threshold_raw,
                                       self.reset_mode)
        else:
            v_out, spikes = ops.spike_timestep(
                sources, weights, v, decay_kind=self.decay.kind,
                decay_rate=self.decay.rate, decay_raw=self.decay.raw,
                threshold_raw=self.threshold_raw, reset_mode=self.reset_mode,
                use_f32=(self._mode == "f32"),
                block_batch=_GATE_TILE_BATCH[self.gate])
        return {"v": v_out, "spikes": spikes}, spikes

    def _step(self, carry: dict, ext_t: torch.Tensor):
        """One fused timestep for a batch of external spike vectors."""
        weights = (self.weights_raw if self._mode is None
                   else self._kernel_weights)
        return self._advance(self._sources(ext_t, carry["spikes"]),
                             carry["v"], weights)

    def step(self, carry: dict, ext_t) -> tuple[dict, torch.Tensor]:
        """One timestep: ``(carry, ext_t (B, n_inputs)) -> (carry',
        spikes_t)``. Chaining ``step`` T times equals one :meth:`run`."""
        return self._step(carry, _as_int32(ext_t, self.device))

    # ------------------------------------------------------------------
    def step_chunk(self, carry: dict, ext, active=None):
        """Advance a slot batch over a chunk of timesteps, with masking.

        ext: (T, B, n_inputs) external spikes; active: (T, B) mask, slot
        b consumes step t iff ``active[t, b] != 0`` (None = all active).
        Inactive slots keep their carry bit-for-bit and report zero
        spikes. Returns ``(carry', spikes (T, B, n_phys))`` on the engine's
        device.
        """
        ext = _as_int32(ext, self.device)
        if ext.ndim != 3 or ext.shape[2] != self.n_inputs:
            raise ValueError(f"ext must be (T, B, {self.n_inputs}), got "
                             f"{tuple(ext.shape)}")
        if active is not None:
            active = _as_int32(active, self.device)
            if active.shape != ext.shape[:2]:
                raise ValueError(f"active mask must be "
                                 f"{tuple(ext.shape[:2])}, got "
                                 f"{tuple(active.shape)}")
        return self._chunk(carry, ext, active)

    def _chunk(self, carry, ext: torch.Tensor, active):
        """The scan behind :meth:`step_chunk` and :meth:`run`: ``active``
        None means every slot steps every step."""
        if self._use_fused:
            if active is None:
                active = torch.ones(ext.shape[:2], dtype=torch.int32,
                                    device=self.device)
            return self._fused_scan(carry, ext, active)
        return self._masked_chunk_scan(carry, ext, active)

    def _masked_chunk_scan(self, carry: dict, ext: torch.Tensor, active):
        """Advance where active; keep the carry (and emit zero spikes)
        where not. The paused-stream contract of the JAX twin."""
        T, B = ext.shape[0], ext.shape[1]
        raster = torch.empty((T, B, self.n_phys), dtype=torch.int32,
                             device=self.device)
        for t in range(T):
            new, spikes = self._step(carry, ext[t])
            if active is None:
                carry, raster[t] = new, spikes
                continue
            keep = active[t][:, None] != 0
            carry = {
                "v": torch.where(keep, new["v"], carry["v"]),
                "spikes": torch.where(keep, new["spikes"], carry["spikes"]),
            }
            raster[t] = torch.where(keep, spikes, 0)
        return carry, raster

    # ------------------------------------------------------------------
    # K-step fused path: with fuse_steps > 1 on a kernel backend, run and
    # step_chunk advance in K-step windows, one fused kernel launch each
    # (each active external weight block fetched once per window). A
    # ragged T pads up to a K multiple with active = 0: the kernel's
    # masked-slot contract makes the remainder byte-identical to the
    # unfused masked scan.
    # ------------------------------------------------------------------
    @property
    def _use_fused(self) -> bool:
        return self.fuse_steps > 1 and self._mode is not None

    def _window(self, carry: dict, ext_w: torch.Tensor,
                act_w: torch.Tensor):
        """One fused K-step window: (carry, (K, B, *) inputs) -> (carry',
        (K, B, P) emitted raster)."""
        v_out, spk_carry, raster = ops.spike_timestep_fused(
            ext_w, carry["spikes"], self._fused_weights, carry["v"], act_w,
            n_inputs=self.n_inputs, decay_kind=self.decay.kind,
            decay_rate=self.decay.rate, decay_raw=self.decay.raw,
            threshold_raw=self.threshold_raw, reset_mode=self.reset_mode,
            use_f32=(self._mode == "f32"),
            block_batch=_GATE_TILE_BATCH[self.gate])
        return {"v": v_out, "spikes": spk_carry}, raster

    def _fused_scan(self, carry: dict, ext: torch.Tensor,
                    active: torch.Tensor):
        K = self.fuse_steps
        T, B = ext.shape[0], ext.shape[1]
        ext = ops._pad_to(ext, 0, K)
        active = ops._pad_to(active, 0, K)
        raster = torch.empty((ext.shape[0], B, self.n_phys),
                             dtype=torch.int32, device=self.device)
        for t0 in range(0, ext.shape[0], K):
            carry, raster[t0:t0 + K] = self._window(
                carry, ext[t0:t0 + K], active[t0:t0 + K])
        return carry, raster[:T]

    def run(self, ext_spikes, *, events_capacity: int | None = None,
            events_policy: str = "error") -> dict:
        """Run the engine from power-on over a spike train.

        Args:
          ext_spikes: dense ``(T, B, n_inputs)`` spikes (numpy or torch),
            or an :class:`~repro_torch.events.aer.AERStream` addressing
            that shape, decoded on the engine's device.
          events_capacity: when set, the output raster is ALSO returned as
            an AER stream of at most this many events under
            ``events_policy`` ("error" refuses a lossy encode, "drop"
            keeps the earliest events and flags overflow).
        Returns:
          ``{'spikes': (T, B, n_phys), 'v_final': (B, n_phys)}``, int32 on
          the engine's device, plus ``'events'`` with ``events_capacity``.
        """
        if isinstance(ext_spikes, AERStream):
            if ext_spikes.shape[2] != self.n_inputs:
                raise ValueError(
                    f"AER stream addresses {ext_spikes.shape[2]} sources; "
                    f"engine expects {self.n_inputs} inputs"
                )
            ext_spikes = aer_to_dense(ext_spikes.to(self.device))
        ext = _as_int32(ext_spikes, self.device)
        if ext.ndim != 3 or ext.shape[2] != self.n_inputs:
            raise ValueError(f"ext_spikes must be (T, B, {self.n_inputs}), "
                             f"got {tuple(ext.shape)}")
        carry, raster = self._chunk(self.init_carry(ext.shape[1]), ext,
                                    None)
        out = {"spikes": raster, "v_final": carry["v"]}
        if events_capacity is not None:
            out["events"] = dense_to_aer(raster, events_capacity,
                                         policy=events_policy)
        return out
