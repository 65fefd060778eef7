"""The non-attention LM families of the port against the JAX package, on
the CPU: Mamba2 (``repro_torch.models.mamba2``; the decoder stack of
``block_kind="mamba2"``), the Zamba2 hybrid (``models.zamba2``;
zamba2-1.2b) and RWKV6 (``models.rwkv6``; rwkv6-7b), with the harness, the
launcher and ``BatchServer`` on the recurrent caches. Whisper's cases are
in ``tests/test_torch_lm_whisper.py``, which shares the helpers here and
the bodies of the arch-level cases (``check_*``).

Every case feeds the same numpy inputs, made from a seed, to both
packages, on JAX's params loaded through ``convert.lm_params``. JAX
initialises many leaves to a constant that makes their term an identity
or zero (norm scales, ``A_log``, ``dt_bias``, ``D``, ``u``, zamba2's
``lora_b``, whisper's biases and LayerNorm scales): every such leaf is
replaced by seeded normals (scale 0.1, about its constant), the same
values in both packages, so the LoRA, the bonus ``u``, the decay's
``A_log`` and every bias are exercised.

Tolerances (``tests/test_torch_lm.py``'s): float32 outputs rtol / atol
``F32_TOL`` (1e-5; XLA's and torch's float32 ``exp`` / ``log1p`` and sum
orders differ in the last bits, and the recurrences compound them over
S), prefill / decode
against teacher forcing ``DECODE_TOL`` (2e-3), whisper's cached
cross-attention against its uncached path ``F32_TOL``. bf16: one layer
body byte-equal to JAX's op-by-op (eager) body in at least
``LAYER_SAME_MIN`` of its elements, the stack within ``EAGER_RTOL`` /
``EAGER_ATOL`` of JAX's op-by-op stack and no further from JAX's jitted
forward than JAX's own op-by-op stack is (plus the port's gap to it);
``BatchServer`` greedy tokens equal to JAX's up to the first step where
JAX's top-2 margin is within ``BF16_MARGIN``. A tolerance that had to be
wider is stated beside its measured gap.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_lm_train import one_torch_thread  # noqa: E402,F401

from test_torch_lm import (  # noqa: E402
    BF16_MARGIN, BF16_TOL, DECODE_TOL, EAGER_ATOL, EAGER_RTOL,
    EAGER_SAME_MIN, F32_TOL, LAYER_SAME_MIN, _jax_margins, _requests,
    _tol_ratio,
)

from repro import configs as jconfigs  # noqa: E402
from repro.launch.steps import LMHarness as JHarness  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import mamba2 as jm2  # noqa: E402
from repro.models import rwkv6 as jrk  # noqa: E402
from repro.models.transformer import DecoderLM as JDecoderLM  # noqa: E402
from repro.serving import BatchServer as JServer  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import Scheduler as JScheduler  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.shapes import SHAPES, Shape  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import LMHarness, SkipCell  # noqa: E402
from repro_torch.models import attention as tattention  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import mamba2 as tm2  # noqa: E402
from repro_torch.models import rwkv6 as trk  # noqa: E402
from repro_torch.models.transformer import DecoderLM  # noqa: E402
from repro_torch.serving import BatchServer, Request, Scheduler  # noqa: E402
from repro_torch.tree import flatten_with_paths, tree_map  # noqa: E402

DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
# the recurrent archs (whisper: tests/test_torch_lm_whisper.py)
SERVED = ["zamba2-1.2b", "rwkv6-7b"]
WHISPER = "whisper-large-v3"


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------
def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _randomized(tree, seed):
    """``tree`` (JAX arrays) with every leaf that is one constant, 0 or 1
    (the identity-making inits), replaced by that constant plus seeded
    normals of scale 0.1, cast to the leaf's dtype."""
    rng = np.random.default_rng(seed)

    def f(a):
        a32 = np.asarray(jnp.asarray(a).astype(jnp.float32))
        c = float(a32.flat[0])
        if c in (0.0, 1.0) and np.all(a32 == c):
            r = c + rng.normal(0, 0.1, a.shape)
            return jnp.asarray(r, jnp.float32).astype(a.dtype)
        return a

    return jax.tree.map(f, tree)


def _cfgs(arch, dtype=jnp.float32, **change):
    jcfg = dataclasses.replace(jconfigs.get_arch(arch).REDUCED, dtype=dtype,
                               **change)
    tcfg = dataclasses.replace(tconfigs.get_arch(arch).REDUCED,
                               dtype=DTYPES[dtype], **change)
    return jcfg, tcfg


def _load(jp, seed):
    jp = _randomized(jp, seed)
    return jp, convert.lm_params(jax.tree.map(np.asarray, jp))


def _models(arch, seed=0, dtype=jnp.float32):
    """(JAX model, port model, JAX params, port params) of ``arch``'s
    REDUCED config; ``"mamba2-stack"`` is the decoder stack of
    ``block_kind="mamba2"`` at zamba2's REDUCED widths."""
    if arch == "mamba2-stack":
        jcfg, tcfg = _cfgs("zamba2-1.2b", dtype)
        jm, tm = JDecoderLM(jcfg), DecoderLM(tcfg)
    else:
        jcfg, tcfg = _cfgs(arch, dtype)
        jm = jconfigs.get_arch(arch).build(jcfg)
        tm = tconfigs.get_arch(arch).build(tcfg)
    jp, tp = _load(jm.init(jax.random.key(seed)), seed + 100)
    return jm, tm, jp, tp


def _batch(arch, seed, B=2, S=12, F=8, d=64):
    """Tokens (B, S) and targets; whisper also ``enc_embeds`` (B, F, d),
    as JAX's ``_batch_for`` adds them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, 256, (B, S)).astype(np.int32)
    out = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    if arch == WHISPER:
        out["enc_embeds"] = rng.normal(0, 0.1, (B, F, d)).astype(np.float32)
    return out


def _jb(batch, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype if v.dtype == np.float32 else None)
            for k, v in batch.items()}


def _tb(batch, dtype=torch.float32):
    return {k: _t(v).to(dtype) if v.dtype == np.float32 else _t(v)
            for k, v in batch.items()}


def _x(seed, shape, scale=1.0):
    return np.random.default_rng(seed).normal(0, scale, shape).astype(
        np.float32)


def _close(got, want, tol=F32_TOL, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol,
                               err_msg=what)


def _same_share(got, want) -> float:
    """The share of byte-equal bf16 elements."""
    return float((np.asarray(want).view(np.int16)
                  == got.view(torch.int16).numpy()).mean())


# --------------------------------------------------------------------------
# the elementwise forms
# --------------------------------------------------------------------------
def test_softplus_sigmoid_silu_match_jax():
    """``softplus`` is ``jnp.logaddexp(x, 0)``'s formula (float32, to rtol
    1e-6: the libraries' ``log1p`` / ``exp`` differ in the last bit; 2.6e-7
    measured); ``sigmoid`` and ``silu`` in bf16 are XLA's op-by-op chains,
    byte-equal on every bf16 value in 2^-100 <= |x| < 80 (XLA flushes
    subnormals to zero: the sigmoid of x < -87, the products of tinier
    x)."""
    r = _x(0, (100000,), 5.0)
    np.testing.assert_allclose(tcommon.softplus(_t(r)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(r))),
                               rtol=1e-6, atol=0)
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16).view(
        np.int16)
    xt = _t(bits).view(torch.bfloat16)
    a = xt.float().abs()
    xt = xt[torch.isfinite(a) & (a < 80) & (a >= 2.0 ** -100)]
    xj = jnp.asarray(xt.view(torch.int16).numpy()).view(jnp.bfloat16)
    for tf, jf in ((tcommon.sigmoid, jax.nn.sigmoid),
                   (tcommon.silu, jax.nn.silu)):
        assert np.array_equal(tf(xt).view(torch.int16).numpy(),
                              np.asarray(jf(xj)).view(np.int16)), tf.__name__


# --------------------------------------------------------------------------
# Mamba2
# --------------------------------------------------------------------------
def _mamba_case(seed=0, dtype=jnp.float32):
    jcfg, tcfg = _cfgs("zamba2-1.2b", dtype)
    jp, tp = _load(jax.tree.map(lambda a: a.astype(dtype),
                                jm2.init_mamba2(jax.random.key(seed), jcfg)),
                   seed + 7)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("S", [2, 3, 12])
def test_mamba2_scan_matches_jax(S):
    """The scan, with and without its cache, at S below, at and past
    ``d_conv - 1`` (the conv tail's two branches); randomized ``A_log``,
    ``dt_bias``, ``D`` and norm scale."""
    jcfg, tcfg, jp, tp = _mamba_case()
    x = _x(1, (2, S, jcfg.d_model))
    jout, _ = jm2.mamba2_scan(jp, jnp.asarray(x), cfg=jcfg)
    tout, none = tm2.mamba2_scan(tp, _t(x), cfg=tcfg)
    assert none is None and tout.shape == jout.shape
    _close(tout, jout)
    jout, jc = jm2.mamba2_scan(jp, jnp.asarray(x), cfg=jcfg,
                               return_cache=True)
    tout, tc = tm2.mamba2_scan(tp, _t(x), cfg=tcfg, return_cache=True)
    _close(tout, jout)
    for k in ("conv", "ssm"):
        assert tuple(tc[k].shape) == jc[k].shape, k
        _close(tc[k], jc[k], what=k)


def test_mamba2_step_matches_jax():
    """One decode step on a random carried state: output, conv history and
    SSM state."""
    jcfg, tcfg, jp, tp = _mamba_case(1)
    shapes = jm2.init_mamba2_cache(jcfg, 2)
    cache = {k: _x(2 + i, v.shape) for i, (k, v) in enumerate(
        sorted(shapes.items()))}
    x = _x(4, (2, 1, jcfg.d_model))
    jout, jc = jm2.mamba2_step(jp, jnp.asarray(x),
                               jax.tree.map(jnp.asarray, cache), cfg=jcfg)
    tout, tc = tm2.mamba2_step(tp, _t(x), tree_map(_t, cache), cfg=tcfg)
    _close(tout, jout)
    for k in ("conv", "ssm"):
        _close(tc[k], jc[k], what=k)


@pytest.mark.parametrize("k", [2, 5])
def test_mamba2_scan_then_steps_equal_the_scan(k):
    """A scan of the first k tokens (its cache from the tail branch at k =
    2) then single steps give the whole scan's outputs: the scan's and the
    step's two conv forms agree."""
    jcfg, tcfg, jp, tp = _mamba_case(2)
    x = _t(_x(5, (2, 9, jcfg.d_model)))
    full, _ = tm2.mamba2_scan(tp, x, cfg=tcfg)
    out, cache = tm2.mamba2_scan(tp, x[:, :k], cfg=tcfg, return_cache=True)
    outs = [out]
    for t in range(k, 9):
        o, cache = tm2.mamba2_step(tp, x[:, t:t + 1], cache, cfg=tcfg)
        outs.append(o)
    _close(torch.cat(outs, dim=1), full)


# --------------------------------------------------------------------------
# RWKV6
# --------------------------------------------------------------------------
def _rwkv_case(seed=0, dtype=jnp.float32):
    jcfg, tcfg = _cfgs("rwkv6-7b", dtype)
    k1, k2 = jax.random.split(jax.random.key(seed))
    p = {"rwkv": jrk.init_rwkv6(k1, jcfg), "ffn": jrk.init_rwkv6_ffn(k2, jcfg)}
    jp, tp = _load(jax.tree.map(lambda a: a.astype(dtype), p), seed + 11)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("with_prev", [False, True])
def test_rwkv6_scan_matches_jax(with_prev):
    """The time mix over a sequence, from zeros or from a given previous
    token, with its cache; randomized ``u`` and ``ln_x`` scale."""
    jcfg, tcfg, jp, tp = _rwkv_case()
    x = _x(1, (2, 12, jcfg.d_model))
    prev = _x(2, (2, jcfg.d_model)) if with_prev else None
    jout, jc = jrk.rwkv6_scan(
        jp["rwkv"], jnp.asarray(x), cfg=jcfg, return_cache=True,
        x_prev=None if prev is None else jnp.asarray(prev))
    tout, tc = trk.rwkv6_scan(
        tp["rwkv"], _t(x), cfg=tcfg, return_cache=True,
        x_prev=None if prev is None else _t(prev))
    _close(tout, jout)
    for k in ("state", "x_att"):
        _close(tc[k], jc[k], what=k)
    if with_prev:  # the previous token reaches the first position only
        base, _ = trk.rwkv6_scan(tp["rwkv"], _t(x), cfg=tcfg)
        assert not torch.allclose(base[:, 0], tout[:, 0])


def test_rwkv6_step_matches_jax():
    """One decode step of the time mix on a random state."""
    jcfg, tcfg, jp, tp = _rwkv_case(1)
    shapes = jrk.init_rwkv6_cache(jcfg, 2)
    cache = {k: _x(3 + i, v.shape) for i, (k, v) in enumerate(
        sorted(shapes.items()))}
    x = _x(6, (2, 1, jcfg.d_model))
    jout, jc = jrk.rwkv6_step(jp["rwkv"], jnp.asarray(x),
                              jax.tree.map(jnp.asarray, cache), cfg=jcfg)
    tout, tc = trk.rwkv6_step(tp["rwkv"], _t(x), tree_map(_t, cache),
                              cfg=tcfg)
    _close(tout, jout)
    assert sorted(tc) == sorted(jc) == ["state", "x_att"]
    for k in tc:
        _close(tc[k], jc[k], what=k)


def test_rwkv6_ffn_and_step_match_jax():
    """The channel mix over a sequence (with and without a previous token)
    and its step."""
    jcfg, tcfg, jp, tp = _rwkv_case(2)
    x = _x(1, (2, 12, jcfg.d_model))
    prev = _x(2, (2, jcfg.d_model))
    _close(trk.rwkv6_ffn(tp["ffn"], _t(x)),
           jrk.rwkv6_ffn(jp["ffn"], jnp.asarray(x)))
    _close(trk.rwkv6_ffn(tp["ffn"], _t(x), x_prev=_t(prev)),
           jrk.rwkv6_ffn(jp["ffn"], jnp.asarray(x), x_prev=jnp.asarray(prev)))
    jout, jprev = jrk.rwkv6_ffn_step(jp["ffn"], jnp.asarray(x[:, :1]),
                                     jnp.asarray(prev))
    tout, tprev = trk.rwkv6_ffn_step(tp["ffn"], _t(x[:, :1]), _t(prev))
    _close(tout, jout)
    assert np.array_equal(tprev.numpy(), np.asarray(jprev))


# --------------------------------------------------------------------------
# Zamba2's shared block
# --------------------------------------------------------------------------
def test_zamba2_shared_block_with_lora_matches_jax():
    """The shared attention + MLP block at each invocation, with nonzero
    LoRA deltas (``lora_b`` randomized): each invocation's output equals
    JAX's, with and without a cache, and the deltas make the invocations
    differ."""
    jm, tm, jp, tp = _models("zamba2-1.2b", 0)
    x = _x(1, (2, 6, jm.cfg.d_model))
    pos_j = jnp.broadcast_to(jnp.arange(6, dtype=jnp.int32)[None], (2, 6))
    pos_t = torch.arange(6, dtype=torch.int32)[None].expand(2, 6)
    outs = []
    for inv in range(len(jm.shared_layers)):
        jy, _ = jm._shared_block(jp, jnp.asarray(x), inv, pos_j, None, None)
        ty, _ = tm._shared_block(tp, _t(x), inv, pos_t, None, None)
        _close(ty, jy, what=f"invocation {inv}")
        jc = jattention.init_gqa_cache(jm.cfg, 2, 8)
        tc = tattention.init_gqa_cache(tm.cfg, 2, 8, device="cpu")
        jy2, jc = jm._shared_block(jp, jnp.asarray(x), inv, pos_j, jc,
                                   jnp.int32(0))
        ty2, tc = tm._shared_block(tp, _t(x), inv, pos_t, tc, 0)
        _close(ty2, jy2)
        for k in ("k", "v"):
            _close(tc[k], jc[k], what=k)
        assert np.array_equal(tc["slot_pos"].numpy(),
                              np.asarray(jc["slot_pos"]))
        outs.append(ty)
    assert len(outs) == 2 and not torch.allclose(outs[0], outs[1])


# --------------------------------------------------------------------------
# the archs: float32 forward, loss, prefill + decode
# --------------------------------------------------------------------------
# rwkv6's float32 logits: the decay exp(-exp(.)) and the ln_x group norm
# carry the libraries' last-bit differences (exp, sum orders) through the
# recurrence: the port is 1.97e-5 at most from JAX's jitted forward over 5
# param seeds x 3 batches (1.65 x F32_TOL), and JAX's own jitted and
# op-by-op forwards are 2.1e-5 apart on the case below
RWKV_F32_TOL = 3e-5


@pytest.mark.parametrize("arch", SERVED + ["mamba2-stack"])
def test_forward_and_loss_match_jax_f32(arch):
    check_forward_and_loss_match_jax_f32(arch)


def check_forward_and_loss_match_jax_f32(arch):
    """Logits to F32_TOL (rwkv6: RWKV_F32_TOL) and the loss to rtol 1e-6
    (the aux loss is 0)."""
    jm, tm, jp, tp = _models(arch, 1)
    batch = _batch(arch, 0)
    jl, jaux = jm.forward(jp, _jb(batch))
    tl, taux = tm.forward(tp, _tb(batch))
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    _close(tl, jl, RWKV_F32_TOL if arch == "rwkv6-7b" else F32_TOL)
    assert float(taux) == float(jaux) == 0.0
    jloss, jparts = jm.loss(jp, _jb(batch))
    tloss, tparts = tm.loss(tp, _tb(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    for k in ("ce", "z_loss"):
        np.testing.assert_allclose(float(tparts[k]), float(jparts[k]),
                                   rtol=1e-5)


@pytest.mark.parametrize("arch", SERVED + ["mamba2-stack"])
def test_prefill_decode_matches_forward_f32(arch):
    """``tests/test_models.py::test_prefill_decode_matches_forward`` on the
    port (zamba2 and rwkv6 are JAX's ``DECODE_ARCHS``), with JAX's
    teacher-forced logits as the reference too; the caller's cache is not
    written."""
    jm, tm, jp, tp = _models(arch, 1)
    B, S, k = 2, 12, 6
    toks = _batch(arch, 0, B, S)["tokens"]
    full_t, _ = tm.forward(tp, {"tokens": _t(toks)})
    full_j, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    cache = tm.init_cache(B, S, device="cpu")
    logits, cache = tm.prefill(tp, {"tokens": _t(toks[:, :k])}, cache)
    for ref in (full_t, full_j):
        _close(logits[:, 0], _np(ref)[:, k - 1], DECODE_TOL)
    for pos in range(k, S):
        before = tree_map(lambda t: t.clone(), cache)
        logits, new = tm.decode_step(tp, {"tokens": _t(toks[:, pos:pos + 1])},
                                     pos, cache)
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
            flatten_with_paths(cache), flatten_with_paths(before)))
        cache = new
        for ref in (full_t, full_j):
            _close(logits[:, 0], _np(ref)[:, pos], DECODE_TOL,
                   f"{arch} decode at {pos}")


@pytest.mark.parametrize("arch", SERVED)
def test_left_padding_enters_the_recurrent_state(arch):
    """A mirrored quirk: ``BatchServer`` left-pads prompts with ``pad_id``
    0 and prefills the pads as tokens, so in a recurrent arch they enter
    the state (JAX's server does the same). The port's padded prefill
    equals JAX's, and differs from the unpadded prompt's."""
    jm, tm, jp, tp = _models(arch, 2)
    prompt = _batch(arch, 3, 1, 6)["tokens"]
    padded = np.concatenate([np.zeros((1, 4), np.int32), prompt], axis=1)
    outs = {}
    for name, toks in (("padded", padded), ("bare", prompt)):
        S = toks.shape[1]
        jl, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                           jm.init_cache(1, 16))
        tl, _ = tm.prefill(tp, {"tokens": _t(toks)},
                           tm.init_cache(1, 16, device="cpu"))
        _close(tl, jl, what=f"{name} ({S} tokens)")
        outs[name] = tl
    assert not torch.allclose(outs["padded"], outs["bare"], atol=1e-3)
    server = BatchServer(tm, tp, max_seq=32, device="cpu")
    tok, _ = server._prefill(server.params, _t(padded), batch=1, seq=10)
    assert int(tok[0, 0]) == int(torch.argmax(outs["padded"][0, -1]))


# --------------------------------------------------------------------------
# bfloat16
# --------------------------------------------------------------------------
# a mamba2 layer returns x + s_out, which cancels to near 0 in places: a
# one-step bf16 difference of s_out (|s_out| ~0.03, a step 2^-13) then
# stands beside a tiny sum (2.4e-4 on an output of 5.6e-3 measured, one
# element of 1536), past two steps of the sum; the atol of that case
MAMBA_LAYER_ATOL = 2.0 ** -11


@pytest.mark.parametrize("arch", ["rwkv6-7b", "mamba2-stack"])
def test_layer_body_bf16_equals_jax_eager(arch):
    """One bf16 layer of the decoder stack (rwkv6's time + channel mix,
    the mamba2 block), op by op: at least LAYER_SAME_MIN of its elements
    byte-equal to JAX's eager body, all within two bf16 steps (atol
    2^-14; the mamba2 block MAMBA_LAYER_ATOL)."""
    jm, tm, jp, tp = _models(arch, 0, jnp.bfloat16)
    toks = _batch(arch, 0)["tokens"]
    jx = jm._embed(jp, {"tokens": jnp.asarray(toks)})
    tx = tm._embed(tp, {"tokens": _t(toks)})
    pos_j = jnp.broadcast_to(jnp.arange(12, dtype=jnp.int32)[None], (2, 12))
    pos_t = torch.arange(12, dtype=torch.int32)[None].expand(2, 12)
    for i in range(jm.cfg.n_layers):
        jl = jax.tree.map(lambda a: a[i], jp["layers"])
        tl = tree_map(lambda t: t[i], tp["layers"])
        with jax.disable_jit():
            jy, _, _ = jm._layer_body(jx, jl, jnp.int32(0), None, None,
                                      pos_j, None)
        ty, _, _ = tm._layer_body(tx, tl, 0, None, None, pos_t)
        assert ty.dtype == torch.bfloat16
        assert _same_share(ty, jy) >= LAYER_SAME_MIN, f"layer {i}"
        np.testing.assert_allclose(
            _np(ty), _np(jy), rtol=2.0 ** -6, err_msg=f"layer {i}",
            atol=MAMBA_LAYER_ATOL if arch == "mamba2-stack" else 2.0 ** -14)


def test_zamba2_shared_block_bf16_equals_jax_eager():
    """The zamba2 shared block at each invocation (with its LoRA delta),
    bf16, op by op: at least LAYER_SAME_MIN byte-equal to JAX's eager
    block (all of it, measured), all within two bf16 steps."""
    jm, tm, jp, tp = _models("zamba2-1.2b", 0, jnp.bfloat16)
    x = jnp.asarray(_x(1, (2, 12, 64)), jnp.bfloat16)
    pos_j = jnp.broadcast_to(jnp.arange(12, dtype=jnp.int32)[None], (2, 12))
    pos_t = torch.arange(12, dtype=torch.int32)[None].expand(2, 12)
    tx = _t(np.asarray(x).view(np.int16)).view(torch.bfloat16)
    for inv in range(len(jm.shared_layers)):
        with jax.disable_jit():
            jy, _ = jm._shared_block(jp, x, inv, pos_j, None, None)
        ty, _ = tm._shared_block(tp, tx, inv, pos_t, None, None)
        assert ty.dtype == torch.bfloat16
        assert _same_share(ty, jy) >= LAYER_SAME_MIN, inv
        np.testing.assert_allclose(_np(ty), _np(jy), rtol=2.0 ** -6,
                                   atol=2.0 ** -14)


@pytest.mark.parametrize("arch", SERVED)
def test_forward_bf16_within_tolerance(arch):
    check_forward_bf16_within_tolerance(arch)


def check_forward_bf16_within_tolerance(arch):
    """The bf16 stack: within EAGER_RTOL / EAGER_ATOL of JAX's op-by-op
    forward (``jax.disable_jit``: its scans run as Python loops, each op
    alone), EAGER_SAME_MIN of it byte-equal, and within BF16_TOL of JAX's
    jitted forward or, where XLA's fused bodies move JAX's own op-by-op
    forward further, no further from it than that plus the port's gap to
    the op-by-op forward."""
    jm, tm, jp, tp = _models(arch, 0, jnp.bfloat16)
    for seed in (0, 1):
        batch = _batch(arch, seed)
        jl, _ = jm.forward(jp, _jb(batch, jnp.bfloat16))
        with jax.disable_jit():
            je, _ = jm.forward(jp, _jb(batch, jnp.bfloat16))
        tl, _ = tm.forward(tp, _tb(batch, torch.bfloat16))
        assert tl.dtype == torch.bfloat16
        assert _same_share(tl, je) >= EAGER_SAME_MIN, seed
        np.testing.assert_allclose(_np(tl), _np(je), rtol=EAGER_RTOL,
                                   atol=EAGER_ATOL)
        to_jit = _tol_ratio(_np(tl), _np(jl), BF16_TOL, BF16_TOL)
        eager_to_jit = _tol_ratio(_np(je), _np(jl), BF16_TOL, BF16_TOL)
        to_eager = _tol_ratio(_np(tl), _np(je), BF16_TOL, BF16_TOL)
        bound = 1.0 if eager_to_jit <= 1.0 else eager_to_jit + to_eager
        assert to_jit <= bound, (seed, to_jit, eager_to_jit)


# --------------------------------------------------------------------------
# serving: BatchServer, the harness, the launcher, convert
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", SERVED)
def test_batch_server_greedy_tokens_match_jax(arch):
    """A ``Scheduler``-batched request set through both ``BatchServer``s
    (bf16, left-padded prompts, recurrent caches): the same batches, each
    request's tokens equal up to the first step where JAX's top-2 margin
    is within BF16_MARGIN; at least a quarter of the tokens compared (the
    random REDUCED models' margins fall within it early: zamba2 24 of 64
    compared, no request to its end; every token equal but two past
    margins of 2^-7 and 2^-6)."""
    jm, tm, jp, tp = _models(arch, 0, jnp.bfloat16)
    max_seq, max_new = 64, 8
    reqs = _requests(np.random.default_rng(0), 8, 256, max_new)
    js, ts = JScheduler(4), Scheduler(4)
    for uid, prompt, n in reqs:
        js.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=n))
        ts.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
    jserver = JServer(jm, jp, max_seq=max_seq)
    tserver = BatchServer(tm, tp, max_seq=max_seq, device="cpu")
    compared = total = 0
    while True:
        jb, tb = js.next_batch(), ts.next_batch()
        assert [r.uid for r in tb] == [r.uid for r in jb]
        if not jb:
            break
        jc, tc = jserver.serve(jb), tserver.serve(tb)
        margins = _jax_margins(jm, jp, jb, max_seq, max_new)
        for i, (a, b) in enumerate(zip(jc, tc)):
            assert (b.uid, b.prompt_len) == (a.uid, a.prompt_len)
            assert len(b.tokens) == len(a.tokens)
            close = margins[i] <= BF16_MARGIN
            n = int(np.argmax(close)) if close.any() else len(a.tokens)
            assert np.array_equal(b.tokens[:n], a.tokens[:n]), (b.uid, n)
            compared += n
            total += len(a.tokens)
    assert compared >= total / 4, (compared, total)


@pytest.mark.parametrize("arch", SERVED)
def test_harness_steps_serve_greedy(arch):
    check_harness_steps_serve_greedy(arch)


def check_harness_steps_serve_greedy(arch):
    """``make_prefill_step`` / ``make_decode_step`` (float32; whisper's
    batch with ``enc_embeds``, its caches of half the shape) against the
    model's own forward: the greedy tokens of teacher forcing."""
    _, tcfg = _cfgs(arch)
    h = LMHarness(arch, cfg=tcfg)
    jh = JHarness(arch, cfg=_cfgs(arch)[0])
    jp, params = _load(jh.model.init(jax.random.key(2)), 9)
    shape = Shape("tiny", 20, 2, "decode")
    batch = _tb(_batch(arch, 4, 2, 10))
    first = {k: v[:, :4] if k == "tokens" else v for k, v in batch.items()
             if k != "targets"}
    logits, cache = h.make_prefill_step(shape, device="cpu")(params, first)
    jlogits, _ = jh.make_prefill_step(Shape("tiny", 20, 2, "decode"))(
        jp, {k: jnp.asarray(v.numpy()) for k, v in first.items()})
    _close(logits, jlogits)
    decode = h.make_decode_step(shape)
    full, _ = h.model.forward(params, batch)
    toks = batch["tokens"]
    for pos in range(4, 10):
        nxt, cache = decode(params, cache, {"tokens": toks[:, pos:pos + 1]},
                            pos)
        assert nxt.dtype == torch.int32 and nxt.shape == (2, 1)
        assert torch.equal(nxt[:, 0], torch.argmax(full[:, pos], -1).to(
            torch.int32))


def _same_tree_shapes(jtree, ttree):
    jflat = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tflat = flatten_with_paths(ttree)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == [
        "".join(f"['{q}']" for q in p) for p, _ in tflat]
    for (_, a), (path, b) in zip(jflat, tflat):
        assert tuple(b.shape) == a.shape, path
        assert b.dtype == DTYPES.get(a.dtype.type, {np.int32: torch.int32}
                                     .get(a.dtype.type)), path
        assert b.device.type == "meta", path


@pytest.mark.parametrize("arch", SERVED)
def test_harness_batch_and_cache_shapes_match_jax(arch):
    check_harness_batch_and_cache_shapes_match_jax(arch)


def check_harness_batch_and_cache_shapes_match_jax(arch):
    """``batch_shapes`` / ``cache_shapes`` / ``token_shapes`` of the
    published CONFIG on every shape equal JAX's ``eval_shape``s (whisper:
    ``enc_embeds``, tokens and targets of half the sequence, self and cross
    caches of half); ``SkipCell`` where JAX skips (whisper's long_500k)."""
    jh = JHarness(arch, cfg=jconfigs.get_arch(arch).CONFIG)
    th = LMHarness(arch, cfg=tconfigs.get_arch(arch).CONFIG)
    for name, shape in SHAPES.items():
        jshape = jconfigs.SHAPES[name]
        if name == "long_500k" and not th.cfg.subquadratic:
            with pytest.raises(SkipCell):
                th.batch_shapes(shape)
            continue
        _same_tree_shapes(jh.batch_shapes(jshape), th.batch_shapes(shape))
        _same_tree_shapes(jh.cache_shapes(jshape), th.cache_shapes(shape))
        _same_tree_shapes(jh.token_shapes(jshape), th.token_shapes(shape))


def test_lm_params_carries_the_new_trees():
    """``convert.lm_params`` carries zamba2's LoRA pairs stacked over the
    invocations and whisper's ``enc_layers`` / ``dec_layers`` byte for
    byte, bf16 included."""
    for arch, lead in (("zamba2-1.2b", ("lora", 2)),
                       (WHISPER, ("dec_layers", 2))):
        jcfg, _ = _cfgs(arch, jnp.bfloat16)
        jp = jconfigs.get_arch(arch).build(jcfg).init(jax.random.key(0))
        tp = convert.lm_params(jax.tree.map(np.asarray, jp))
        jl = jax.tree_util.tree_flatten_with_path(jp)[0]
        tl = flatten_with_paths(tp)
        assert len(jl) == len(tl)
        for (_, a), (_, b) in zip(jl, tl):
            assert b.dtype == torch.bfloat16
            assert np.array_equal(np.asarray(a).view(np.int16),
                                  b.view(torch.int16).numpy())
        key, n = lead
        assert all(t.shape[0] == n for _, t in flatten_with_paths(tp[key]))


@pytest.mark.parametrize("arch", SERVED)
def test_serve_launcher_on_recurrent_archs(arch):
    """The launcher serves zamba2 and rwkv6 on the CPU (REDUCED)."""
    out = tserve.main(["--device", "cpu", "--arch", arch, "--requests", "3",
                       "--max-new", "3"])
    assert out["total_tokens"] == 9
    assert all(0 <= int(t.min()) and int(t.max()) < 256
               for b in out["batches"] for t in b["tokens"])

