"""Mamba2 (SSD) block — zamba2's backbone.

Twin of :mod:`repro.models.mamba2`. Selective state-space with a scalar
decay per head (the SSD formulation):

    dt_t   = softplus(dt_raw_t + dt_bias)            (B, nh)
    dA_t   = exp(-exp(A_log) * dt_t)                 (B, nh)
    state  = dA_t * state + (x_t * dt_t) outer B_t   (B, nh, hd, ds)
    y_t    = state . C_t + D * x_t

Two execution paths share one parameterization:
  * ``mamba2_scan`` — the twin's ``lax.scan`` over time as a Python loop
    (train / prefill; exact);
  * ``mamba2_step`` — single-token decode with the carried (conv, ssm)
    state.

The two keep the twin's two forms of the causal depthwise conv: the scan
adds the ``d_conv`` shifted taps one after the other (each add rounded in
the model dtype), the step contracts the taps of its history at once
(float32 sums, rounded once). The state and the recurrence are float32,
with IEEE float32 products on a card.
"""

from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.device import ieee_fp32_matmul
from repro_torch.models.common import (
    SSMConfig,
    TransformerConfig,
    dense_init,
    rms_norm,
    silu,
    softplus,
)

__all__ = ["init_mamba2", "mamba2_scan", "mamba2_step", "init_mamba2_cache"]


def _dims(cfg: TransformerConfig):
    s: SSMConfig = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    conv_dim = d_in + 2 * s.d_state
    return s, d_in, nh, conv_dim


def init_mamba2(key, cfg: TransformerConfig, *, device) -> dict:
    s, d_in, nh, conv_dim = _dims(cfg)
    k1, k2, k3 = prng.split(key, 3)
    # in_proj emits [z, x, B, C, dt]
    out_width = 2 * d_in + 2 * s.d_state + nh
    return {
        "in_proj": dense_init(k1, (cfg.d_model, out_width), device=device),
        "conv_w": dense_init(k2, (s.d_conv, conv_dim), device=device),
        "A_log": torch.zeros((nh,), device=device),
        "D": torch.ones((nh,), device=device),
        "dt_bias": torch.zeros((nh,), device=device),
        "norm": {"scale": torch.zeros((d_in,), device=device)},
        "out_proj": dense_init(k3, (d_in, cfg.d_model), device=device),
    }


def init_mamba2_cache(cfg: TransformerConfig, batch: int, dtype=None, *,
                      device) -> dict:
    s, d_in, nh, conv_dim = _dims(cfg)
    dtype = dtype or cfg.dtype
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, nh, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }


def _split(cfg, zxbcdt):
    s, d_in, nh, _ = _dims(cfg)
    z = zxbcdt[..., :d_in]
    xc = zxbcdt[..., d_in: 2 * d_in + 2 * s.d_state]  # conv input [x,B,C]
    dt = zxbcdt[..., 2 * d_in + 2 * s.d_state:]
    return z, xc, dt


def _post(cfg, p, y, z, x):
    y = y * silu(z)
    y = rms_norm(y, p["norm"]["scale"], cfg.norm_eps)
    return (y @ p["out_proj"].to(y.dtype)).to(x.dtype)


def _decay(p, dt_raw):
    """(dt, dA) in float32 from the raw dt projection."""
    f32 = torch.float32
    dt = softplus(dt_raw.to(f32) + p["dt_bias"].to(f32))
    dA = torch.exp(-torch.exp(p["A_log"].to(f32)) * dt)
    return dt, dA


def _ssd_update(state, xs, b, c, dA, dt):
    """One SSD step in float32: xs (B, nh, hd), b / c (B, ds), dA / dt
    (B, nh). Returns (state, y (B, nh, hd))."""
    upd = (xs * dt[..., None])[..., None] * b[:, None, None, :]
    state = dA[..., None, None] * state + upd
    y = torch.einsum("bhds,bs->bhd", state, c)
    return state, y


def mamba2_scan(p: dict, x, *, cfg: TransformerConfig,
                return_cache: bool = False):
    """x: (B, S, d_model) -> (out, cache | None). Causal depthwise conv +
    sequential SSD scan."""
    s, d_in, nh, conv_dim = _dims(cfg)
    B, S, _ = x.shape
    f32 = torch.float32
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    z, xc, dt_raw = _split(cfg, zxbcdt)

    # causal depthwise conv over time: the taps added one after the other
    pad = torch.zeros((B, s.d_conv - 1, conv_dim), dtype=xc.dtype,
                      device=x.device)
    xc_p = torch.cat([pad, xc], dim=1)
    conv_w = p["conv_w"].to(xc.dtype)
    xc_conv = sum(xc_p[:, i: i + S] * conv_w[i][None, None]
                  for i in range(s.d_conv))
    xc_conv = silu(xc_conv)
    xs = xc_conv[..., :d_in].reshape(B, S, nh, s.head_dim)
    Bt = xc_conv[..., d_in: d_in + s.d_state].to(f32)
    Ct = xc_conv[..., d_in + s.d_state:].to(f32)
    dt, dA = _decay(p, dt_raw)  # (B, S, nh)

    xs32 = xs.to(f32)
    state = torch.zeros((B, nh, s.head_dim, s.d_state), dtype=f32,
                        device=x.device)
    ys = []
    with ieee_fp32_matmul():
        for t in range(S):
            state, y_t = _ssd_update(state, xs32[:, t], Bt[:, t], Ct[:, t],
                                     dA[:, t], dt[:, t])
            ys.append(y_t)
    y = torch.stack(ys, dim=1)  # (B, S, nh, hd)
    y = y + p["D"].to(f32)[None, None, :, None] * xs32
    y = y.reshape(B, S, d_in).to(x.dtype)
    out = _post(cfg, p, y, z, x)
    if return_cache:
        tail = (xc[:, -(s.d_conv - 1):] if S >= s.d_conv - 1
                else xc_p[:, -(s.d_conv - 1):])
        return out, {"conv": tail, "ssm": state}
    return out, None


def mamba2_step(p: dict, x, cache: dict, *, cfg: TransformerConfig):
    """Single-token decode. x: (B, 1, d_model)."""
    s, d_in, nh, conv_dim = _dims(cfg)
    B = x.shape[0]
    f32 = torch.float32
    zxbcdt = x[:, 0] @ p["in_proj"].to(x.dtype)  # (B, width)
    z, xc, dt_raw = _split(cfg, zxbcdt)

    conv_hist = torch.cat([cache["conv"].to(xc.dtype), xc[:, None]],
                          dim=1)  # (B, d_conv, cd)
    conv_w = p["conv_w"].to(xc.dtype)
    # the twin's einsum over the taps: exact products, float32 sums
    taps = (conv_hist.to(f32) * conv_w.to(f32)[None]).sum(dim=1)
    xc_conv = silu(taps.to(xc.dtype))
    new_conv = conv_hist[:, 1:]

    xs = xc_conv[:, :d_in].reshape(B, nh, s.head_dim).to(f32)
    b_t = xc_conv[:, d_in: d_in + s.d_state].to(f32)
    c_t = xc_conv[:, d_in + s.d_state:].to(f32)
    dt, dA = _decay(p, dt_raw)  # (B, nh)

    with ieee_fp32_matmul():
        state, y = _ssd_update(cache["ssm"], xs, b_t, c_t, dA, dt)
    y = y + p["D"].to(f32)[None, :, None] * xs
    y = y.reshape(B, d_in).to(x.dtype)
    out = _post(cfg, p, y[:, None], z[:, None], x)
    return out, {"conv": new_conv, "ssm": state}
