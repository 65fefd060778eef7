"""Shared building blocks + config schema for the LM model zoo.

Twin of :mod:`repro.models.common`. Parameters are plain nested dicts of
tensors (the twin's pytrees); models are pure functions of them. The
config schema is the twin's, field for field, with ``dtype`` a
``torch.dtype``. Weights are drawn through :mod:`repro_torch.core.prng`,
the port's copy of JAX's threefry, so a key gives the twin's params (the
normals to rtol 1e-6; see :func:`repro_torch.core.prng.normal`).

The logical-axis registry (``AXES``, ``axes_of``) is the twin's, entry
for entry: it feeds the LM partitioner
(:mod:`repro_torch.distributed.partition`).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import prng

__all__ = [
    "MoEConfig", "MLAConfig", "SSMConfig", "RWKVConfig", "TransformerConfig",
    "rms_norm", "layer_norm", "make_rope", "apply_rope", "apply_mrope",
    "cross_entropy_loss", "dense_init", "silu", "gelu", "sigmoid",
    "softplus", "AXES", "axes_of",
]

# --------------------------------------------------------------------------
# Config schema
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    shared_expert: bool = False      # llama4: always-on shared expert
    router_aux_weight: float = 0.01  # load-balance loss


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    rope_head_dim: int = 32
    nope_head_dim: int = 64
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128  # SSD chunked-scan block length


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64
    gate_lora: int = 32


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    # --- attention pattern ---
    block_kind: str = "attn"                  # attn | mamba2 | rwkv6
    sliding_window: int | None = None         # SWA width for local layers
    global_every: int | None = None           # every k-th layer is global
    rope_theta: float = 10_000.0
    mrope: bool = False                       # qwen2-vl 3D rope
    shared_attn_every: int | None = None      # zamba2 shared block period
    # --- family-specific blocks ---
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    rwkv: RWKVConfig | None = None
    # --- misc ---
    qk_norm: bool = False                     # gemma3-style q/k RMSNorm
    attn_bias: bool = False                   # whisper uses biased projections
    mlp_kind: str = "swiglu"                  # swiglu | geglu | gelu
    norm_eps: float = 1e-6
    embed_scale: bool = False                 # gemma: x *= sqrt(d)
    tie_embeddings: bool = False
    frontend: str = "tokens"                  # tokens | embeddings
    dtype: Any = torch.bfloat16
    # long-context capability flag (set for SWA/SSM/hybrid archs)
    subquadratic: bool = False
    # the twin's sharding levers (item 12c; DecoderLM refuses them) and
    # its memory levers: split_cache gives windowed layers ring caches of
    # sliding_window slots and only the global layers full ones (needs
    # L % global_every == 0, globals at k*global_every-1); attn_scores_bf16
    # keeps the attention scores in bf16, the softmax in float32
    seq_parallel_attn: bool = False
    moe_ep: bool = False
    split_cache: bool = False
    attn_scores_bf16: bool = False
    remat_policy: str = "nothing"
    # pad the embedding/unembedding vocab dim to a multiple; padded logits
    # are masked in _unembed
    vocab_pad_to: int | None = None

    @property
    def padded_vocab(self) -> int:
        if not self.vocab_pad_to:
            return self.vocab_size
        m = self.vocab_pad_to
        return -(-self.vocab_size // m) * m

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_group(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def param_count(self) -> int:
        """Analytic parameter count (the twin's formula)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd = self.resolved_head_dim
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.block_kind == "rwkv6" and self.rwkv:
            att = d * d * 4 + d * (self.rwkv.decay_lora * 2
                                   + self.rwkv.gate_lora * 2) + 6 * d
        elif self.mla:
            m = self.mla
            att = (d * m.q_lora_rank
                   + m.q_lora_rank * self.n_heads
                   * (m.nope_head_dim + m.rope_head_dim)
                   + d * (m.kv_lora_rank + m.rope_head_dim)
                   + m.kv_lora_rank * self.n_heads
                   * (m.nope_head_dim + m.v_head_dim)
                   + self.n_heads * m.v_head_dim * d)
        else:
            att = d * (self.n_heads * hd) * 2 + d * (
                self.n_kv_heads * hd) * 2
        gates = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        if self.moe:
            mlp = self.moe.n_experts * gates * d * f + d * self.moe.n_experts
            if self.moe.shared_expert:
                mlp += gates * d * f
        else:
            mlp = gates * d * f
        if self.block_kind == "mamba2" and self.ssm:
            din = self.ssm.expand * d
            nh = din // self.ssm.head_dim
            att = 0
            mlp_ssm = (d * (2 * din + 2 * self.ssm.d_state + nh)
                       + din * d + din * self.ssm.d_conv + 2 * nh)
            mlp = mlp_ssm if self.moe is None and self.mlp_kind == "none" \
                else mlp_ssm + gates * d * f
        return emb + L * (att + mlp + 2 * d) + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        gates = 3 if self.mlp_kind in ("swiglu", "geglu") else 2
        total = self.param_count()
        expert_params = self.moe.n_experts * gates * d * f * self.n_layers
        active_expert = self.moe.top_k * gates * d * f * self.n_layers
        return total - expert_params + active_expert


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

def dense_init(key, shape, in_axis: int = 0, *, device) -> torch.Tensor:
    """``normal(key, shape) / sqrt(fan_in)`` in float32 on ``device``, as
    the twin draws it (the scale rounded to float32 first)."""
    fan_in = shape[in_axis] if isinstance(in_axis, int) else int(
        np.prod([shape[a] for a in in_axis]))
    std = float(np.float32(1.0 / np.sqrt(fan_in)))
    return prng.normal(key, tuple(shape), device) * std


class _RMSNorm(torch.autograd.Function):
    """RMSNorm with the twin's custom VJP: float32 math inside, the input
    dtype at both boundaries (the cotangents too)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        xf = x.to(torch.float32)
        inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        y = xf * inv * (1.0 + scale.to(torch.float32))
        return y.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        xf = x.to(torch.float32)
        gf = g.to(torch.float32)
        inv = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True)
                          + ctx.eps)
        xn = xf * inv
        a = 1.0 + scale.to(torch.float32)
        ag = a * gf
        dscale = torch.sum((gf * xn).reshape(-1, x.shape[-1]), dim=0)
        dx = inv * (ag - xn * torch.mean(ag * xn, dim=-1, keepdim=True))
        return dx.to(x.dtype), dscale.to(scale.dtype), None


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm: float32 math inside, input-dtype tensors at the boundaries
    (forward and backward)."""
    return _RMSNorm.apply(x, scale, eps)


def layer_norm(x, scale, bias, eps: float = 1e-6):
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = (x - mu) * torch.rsqrt(var + eps)
    y = y * scale.to(torch.float32) + bias.to(torch.float32)
    return y.to(dtype)


def make_rope(positions, head_dim: int, theta: float):
    """positions: (..., S) int -> (cos, sin) of shape (..., S, head_dim//2),
    float32."""
    half = head_dim // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = 1.0 / (theta ** (ar / half))
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x: (B, S, H, D); cos/sin: (B, S, D//2) or (S, D//2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if cos.ndim == 2:
        cos = cos[None]
        sin = sin[None]
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def apply_mrope(x, positions3, head_dim: int, theta: float,
                sections=(1, 1, 2)):
    """Qwen2-VL multimodal RoPE: positions3 (3, B, S) = (t, h, w) ids.

    head_dim//2 rotary freqs are split across the three position streams in
    ratio ``sections`` (temporal gets the low-frequency end); each stream's
    freqs are :func:`make_rope`'s over its own range.
    """
    half = head_dim // 2
    total = sum(sections)
    bounds = np.cumsum([0] + [half * s // total for s in sections])
    bounds[-1] = half
    positions3 = torch.as_tensor(positions3, device=x.device)
    cos_parts, sin_parts = [], []
    for i in range(3):
        lo, hi = int(bounds[i]), int(bounds[i + 1])
        ar = torch.arange(lo, hi, dtype=torch.float32, device=x.device)
        freqs = 1.0 / (theta ** (ar / half))
        ang = positions3[i].to(torch.float32)[..., None] * freqs
        cos_parts.append(torch.cos(ang))
        sin_parts.append(torch.sin(ang))
    cos = torch.cat(cos_parts, dim=-1)  # (B, S, half)
    sin = torch.cat(sin_parts, dim=-1)
    return apply_rope(x, cos, sin)


# The twin's activations as XLA lowers them, op for op in the input dtype
# (each op rounded to it, the constants too): in bfloat16 this gives the
# twin's bytes where F.silu / F.gelu, which round once, differ in ~40 %.

def _const(x, value: float) -> torch.Tensor:
    return torch.full((), value, dtype=x.dtype, device=x.device)


def sigmoid(x):
    """``jax.nn.sigmoid`` (``lax.logistic``): ``1 / (1 + exp(-x))``."""
    return 1 / (1 + torch.exp(-x))


def silu(x):
    """``jax.nn.silu``: ``x * (1 / (1 + exp(-x)))``."""
    return x * sigmoid(x)


def softplus(x):
    """``jax.nn.softplus``, which is ``jnp.logaddexp(x, 0)``: ``max(x, 0) +
    log1p(exp(-|x|))``. ``torch.nn.functional.softplus`` is another
    formula (linear past a threshold of 20)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def gelu(x):
    """``jax.nn.gelu`` (its default tanh approximation): ``x * (0.5 * (1 +
    tanh(sqrt(2 / pi) * (x + 0.044715 * x^3))))``."""
    inner = _const(x, np.sqrt(2 / np.pi)) * (
        x + _const(x, 0.044715) * (x * x * x))
    return x * (0.5 * (1 + torch.tanh(inner)))


def cross_entropy_loss(logits, targets, z_weight: float = 1e-4):
    """Token-mean CE + z-loss. The gold logit is a gather: the twin's
    one-hot product picks the same float exactly."""
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1,
                        targets.to(torch.int64)[..., None])[..., 0]
    ce = torch.mean(logz - gold)
    zl = z_weight * torch.mean(logz * logz)
    return ce + zl, {"ce": ce, "z_loss": zl}


# --------------------------------------------------------------------------
# Logical-axis registry: leaf path suffix -> logical axes (no stacked dim;
# the partitioner prepends "layers" when leaf rank == len(axes)+1).
# --------------------------------------------------------------------------

AXES: dict[str, tuple[str | None, ...]] = {
    # embeddings / head
    "embed/table": ("vocab", "embed"),
    "unembed/table": ("embed", "vocab"),
    "final_norm/scale": (None,),
    # attention
    "attn/wq": ("embed", "heads"),
    "attn/wk": ("embed", "kv"),
    "attn/wv": ("embed", "kv"),
    "attn/wo": ("heads", "embed"),
    "attn/q_norm/scale": (None,),
    "attn/k_norm/scale": (None,),
    # MLA
    "attn/wq_a": ("embed", None),
    "attn/wq_b": (None, "heads"),
    "attn/wkv_a": ("embed", None),
    "attn/wkv_b": (None, "heads"),
    "attn/q_a_norm/scale": (None,),
    "attn/kv_a_norm/scale": (None,),
    # dense MLP
    "mlp/w_gate": ("embed", "ffn"),
    "mlp/w_up": ("embed", "ffn"),
    "mlp/w_down": ("ffn", "embed"),
    # MoE. The router is tiny (d x E) — replicate it: sharding its embed
    # dim over data makes the routing matmul contract a sharded dim and
    # all-reduce (T, E) f32 per layer (§Perf cell A, hypothesis A5).
    "moe/router": (None, None),
    "moe/w_gate": ("expert", "embed", "ffn"),
    "moe/w_up": ("expert", "embed", "ffn"),
    "moe/w_down": ("expert", "ffn", "embed"),
    "moe/shared_w_gate": ("embed", "ffn"),
    "moe/shared_w_up": ("embed", "ffn"),
    "moe/shared_w_down": ("ffn", "embed"),
    # mamba2
    "ssm/in_proj": ("embed", "ffn"),
    "ssm/out_proj": ("ffn", "embed"),
    "ssm/conv_w": (None, "ffn"),
    "ssm/A_log": ("ffn",),
    "ssm/D": ("ffn",),
    "ssm/dt_bias": ("ffn",),
    "ssm/norm/scale": ("ffn",),
    # rwkv6
    "rwkv/wr": ("embed", "heads"),
    "rwkv/wk": ("embed", "heads"),
    "rwkv/wv": ("embed", "heads"),
    "rwkv/wg": ("embed", "heads"),
    "rwkv/wo": ("heads", "embed"),
    "rwkv/decay_a": ("embed", None),
    "rwkv/decay_b": (None, "heads"),
    "rwkv/mix": (None, "embed"),
    "rwkv/u": ("heads",),
    "rwkv/ln_x/scale": ("heads",),
    "rwkv/wk_mlp": ("embed", "ffn"),
    "rwkv/wv_mlp": ("ffn", "embed"),
    "rwkv/wr_mlp": ("embed", None),
    # norms inside blocks
    "pre_norm/scale": (None,),
    "post_norm/scale": (None,),
    "pre_mlp_norm/scale": (None,),
    # layer norms with bias (whisper)
    "pre_norm/bias": (None,),
    "post_norm/bias": (None,),
    "final_norm/bias": (None,),
    # whisper cross-attn
    "xattn/wq": ("embed", "heads"),
    "xattn/wk": ("embed", "kv"),
    "xattn/wv": ("embed", "kv"),
    "xattn/wo": ("heads", "embed"),
    "pre_xattn_norm/scale": (None,),
    "pre_xattn_norm/bias": (None,),
    # whisper biases
    "attn/bq": ("heads",),
    "attn/bv": ("kv",),
    "attn/bo": (None,),
    "xattn/bq": ("heads",),
    "xattn/bv": ("kv",),
    "xattn/bo": (None,),
    "mlp/b_up": ("ffn",),
    "mlp/b_down": (None,),
    # positional embeddings (whisper)
    "pos_embed/table": (None, "embed"),
    # zamba2 lora adapters on the shared block
    "lora_a": ("embed", None),
    "lora_b": (None, "heads"),
}


def axes_of(path: str, leaf) -> tuple[str | None, ...]:
    """Resolve logical axes for a leaf by longest-suffix match in AXES."""
    parts = path.split("/")
    for take in range(min(3, len(parts)), 0, -1):
        suffix = "/".join(parts[-take:])
        if suffix in AXES:
            axes = AXES[suffix]
            if leaf.ndim == len(axes) + 1:
                return ("layers",) + tuple(axes)
            if leaf.ndim == len(axes):
                return tuple(axes)
    # sane default: replicate
    return (None,) * leaf.ndim
