"""RWKV-6 "Finch" block — attention-free token mixing with data-dependent
decay (the rwkv6-7b backbone).

Twin of :mod:`repro.models.rwkv6`. Per head (k-dim x v-dim state S):

    y_t = r_t . (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T        w_t = exp(-exp(decay(x_t)))

``decay(x)`` is the low-rank data-dependent decay, in float32. The
twin's ``lax.scan`` over time is a Python loop here; the state and the
recurrence are float32, with IEEE float32 products on a card. Decode
carries (S, the previous token of the time mix and of the channel mix).
"""

from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.device import ieee_fp32_matmul
from repro_torch.models.common import (
    RWKVConfig,
    TransformerConfig,
    dense_init,
    sigmoid,
    silu,
)

__all__ = ["init_rwkv6", "rwkv6_scan", "rwkv6_step", "init_rwkv6_cache",
           "init_rwkv6_ffn", "rwkv6_ffn", "rwkv6_ffn_step"]


def _dims(cfg: TransformerConfig):
    r: RWKVConfig = cfg.rwkv
    nh = cfg.d_model // r.head_dim
    return r, nh, r.head_dim


def init_rwkv6(key, cfg: TransformerConfig, *, device) -> dict:
    r, nh, hd = _dims(cfg)
    d = cfg.d_model
    ks = prng.split(key, 8)
    return {
        "wr": dense_init(ks[0], (d, d), device=device),
        "wk": dense_init(ks[1], (d, d), device=device),
        "wv": dense_init(ks[2], (d, d), device=device),
        "wg": dense_init(ks[3], (d, d), device=device),
        "wo": dense_init(ks[4], (d, d), device=device),
        "decay_a": dense_init(ks[5], (d, r.decay_lora), device=device),
        "decay_b": dense_init(ks[6], (r.decay_lora, d), device=device) * 0.1,
        # the r, k, v, g, w shift mixes
        "mix": prng.uniform(ks[7], (5, d), device=device),
        "u": torch.zeros((nh, hd), device=device),
        "ln_x": {"scale": torch.zeros((d,), device=device)},
    }


def init_rwkv6_ffn(key, cfg: TransformerConfig, *, device) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    k1, k2, k3 = prng.split(key, 3)
    return {
        "wk_mlp": dense_init(k1, (d, f), device=device),
        "wv_mlp": dense_init(k2, (f, d), device=device),
        "wr_mlp": dense_init(k3, (d, d), device=device),
        "mix": prng.uniform(prng.fold_in(key, 9), (2, d), device=device),
    }


def init_rwkv6_cache(cfg: TransformerConfig, batch: int, dtype=None, *,
                     device) -> dict:
    r, nh, hd = _dims(cfg)
    dtype = dtype or cfg.dtype
    return {
        "state": torch.zeros((batch, nh, hd, hd), dtype=torch.float32,
                             device=device),
        "x_att": torch.zeros((batch, cfg.d_model), dtype=dtype,
                             device=device),
        "x_ffn": torch.zeros((batch, cfg.d_model), dtype=dtype,
                             device=device),
    }


def _mix(x, x_prev, m):
    return x + (x_prev - x) * m[None, None]


def _shift(x, x_prev):
    """The previous token of each position: ``x_prev`` (zeros if None),
    then x[:, :-1]."""
    if x_prev is None:
        x_prev = torch.zeros((x.shape[0], x.shape[2]), dtype=x.dtype,
                             device=x.device)
    return torch.cat([x_prev[:, None], x[:, :-1]], dim=1)


def _decay(p, xw):
    f32 = torch.float32
    with ieee_fp32_matmul():
        lora = (xw.to(f32) @ p["decay_a"].to(f32)) @ p["decay_b"].to(f32)
    return torch.exp(-torch.exp(lora))


def _group_norm(x, scale, nh, eps=1e-5):
    """Per-head layer norm of the wkv output (RWKV's ln_x); the variance
    as ``jnp.var`` takes it, the mean of the squared deviations."""
    B, S, d = x.shape
    xh = x.reshape(B, S, nh, d // nh).to(torch.float32)
    mu = xh.mean(-1, keepdim=True)
    c = xh - mu
    var = (c * c).mean(-1, keepdim=True)
    xh = c * torch.rsqrt(var + eps)
    return (xh.reshape(B, S, d)
            * (1.0 + scale.to(torch.float32))).to(x.dtype)


def _projections(p, x, shifted, B, S, nh, hd):
    """r, k, v (B, S, nh, hd) in float32, the gate g (B, S, d) and the
    decay w (B, S, nh, hd) in float32."""
    mix = p["mix"]
    xr, xk, xv, xg, xw = (_mix(x, shifted, mix[i]) for i in range(5))
    f32 = torch.float32
    rv = (xr @ p["wr"].to(x.dtype)).reshape(B, S, nh, hd).to(f32)
    kv = (xk @ p["wk"].to(x.dtype)).reshape(B, S, nh, hd).to(f32)
    vv = (xv @ p["wv"].to(x.dtype)).reshape(B, S, nh, hd).to(f32)
    g = silu(xg @ p["wg"].to(x.dtype))
    w = _decay(p, xw).reshape(B, S, nh, hd)
    return rv, kv, vv, g, w


def _wkv(state, r, k, v, w, u):
    """One step in float32: r, k, v, w (B, nh, hd); u (nh, hd). Returns
    (state, y (B, nh, hd))."""
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhk,bhkv->bhv", r, state + u[None, :, :, None] * kv)
    return w[..., None] * state + kv, y


def rwkv6_scan(p: dict, x, *, cfg: TransformerConfig,
               x_prev=None, return_cache: bool = False):
    """Time mix over a sequence. x: (B, S, d)."""
    r, nh, hd = _dims(cfg)
    B, S, d = x.shape
    rv, kv, vv, g, w = _projections(p, x, _shift(x, x_prev), B, S, nh, hd)
    u = p["u"].to(torch.float32)
    state = torch.zeros((B, nh, hd, hd), dtype=torch.float32,
                        device=x.device)
    ys = []
    with ieee_fp32_matmul():
        for t in range(S):
            state, y_t = _wkv(state, rv[:, t], kv[:, t], vv[:, t], w[:, t],
                              u)
            ys.append(y_t)
    y = torch.stack(ys, dim=1).reshape(B, S, d).to(x.dtype)
    y = _group_norm(y, p["ln_x"]["scale"], nh)
    out = (y * g) @ p["wo"].to(x.dtype)
    if return_cache:
        return out, {"state": state, "x_att": x[:, -1]}
    return out, None


def rwkv6_step(p: dict, x, cache: dict, *, cfg: TransformerConfig):
    """Single-token decode. x: (B, 1, d)."""
    r, nh, hd = _dims(cfg)
    B, _, d = x.shape
    rv, kv, vv, g, w = _projections(p, x, cache["x_att"][:, None], B, 1, nh,
                                    hd)
    with ieee_fp32_matmul():
        state, y = _wkv(cache["state"], rv[:, 0], kv[:, 0], vv[:, 0],
                        w[:, 0], p["u"].to(torch.float32))
    y = y.reshape(B, 1, d).to(x.dtype)
    y = _group_norm(y, p["ln_x"]["scale"], nh)
    out = ((y[:, 0] * g[:, 0]) @ p["wo"].to(x.dtype))[:, None]
    return out, {"state": state, "x_att": x[:, 0]}


def rwkv6_ffn(p: dict, x, *, x_prev=None):
    """Channel mix. x: (B, S, d)."""
    shifted = _shift(x, x_prev)
    xk = _mix(x, shifted, p["mix"][0])
    xr = _mix(x, shifted, p["mix"][1])
    k = torch.relu(xk @ p["wk_mlp"].to(x.dtype))
    k = k * k
    r = sigmoid(xr @ p["wr_mlp"].to(x.dtype))
    return r * (k @ p["wv_mlp"].to(x.dtype))


def rwkv6_ffn_step(p: dict, x, x_prev):
    """x: (B, 1, d); x_prev: (B, d) -> (out, new_x_prev)."""
    return rwkv6_ffn(p, x, x_prev=x_prev), x[:, 0]
