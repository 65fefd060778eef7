"""Whisper's encoder-decoder with cross-attention in the port
(``repro_torch.models.whisper``, ``models.attention.gqa_forward(kv_x=
...)``; whisper-large-v3) against the JAX package, on the CPU, with the
harness's whisper branches and the launcher's refusal. The helpers,
tolerances and the randomized constant leaves (biases, LayerNorm scales)
are ``tests/test_torch_lm_recurrent.py``'s, and so are the bodies of the
arch-level cases it shares with the recurrent archs.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_lm_train import one_torch_thread  # noqa: E402,F401

from test_torch_lm import DECODE_TOL, LAYER_SAME_MIN  # noqa: E402
from test_torch_lm_recurrent import (  # noqa: E402
    WHISPER, _batch, _close, _jb, _models, _np, _same_share, _t, _tb, _x,
    check_forward_and_loss_match_jax_f32,
    check_forward_bf16_within_tolerance,
    check_harness_batch_and_cache_shapes_match_jax,
    check_harness_steps_serve_greedy,
)

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import whisper as jwhisper  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import LMHarness  # noqa: E402
from repro_torch.models import attention as tattention  # noqa: E402
from repro_torch.models import whisper as twhisper  # noqa: E402
from repro_torch.tree import flatten_with_paths, tree_map  # noqa: E402


def test_cross_attention_matches_jax_and_the_cached_path():
    """``gqa_forward(kv_x=...)`` against JAX's (biased q / v / o, no K
    bias, no rotary, no causal mask), with ``kv_positions`` too; a cache
    passed with ``kv_x`` comes back as it was; and whisper's
    ``_xattn_cached`` on prefill's cross K/V equals the uncached path."""
    jm, tm, jp, tp = _models(WHISPER, 1)
    lj = jax.tree.map(lambda a: a[0], jp["dec_layers"])["xattn"]
    lt = tree_map(lambda a: a[0], tp["dec_layers"])["xattn"]
    assert sorted(lt) == ["bo", "bq", "bv", "wk", "wo", "wq", "wv"]
    x, mem = _x(2, (2, 5, 64)), _x(3, (2, 7, 64))
    pos_j = jnp.broadcast_to(jnp.arange(5, dtype=jnp.int32)[None], (2, 5))
    pos_t = torch.arange(5, dtype=torch.int32)[None].expand(2, 5)
    jo, _ = jattention.gqa_forward(lj, jnp.asarray(x), cfg=jm.cfg,
                                   positions=pos_j, kv_x=jnp.asarray(mem))
    cache = tattention.init_gqa_cache(tm.cfg, 2, 4, device="cpu")
    to, tc = tattention.gqa_forward(lt, _t(x), cfg=tm.cfg, positions=pos_t,
                                    kv_x=_t(mem), cache=cache, write_pos=0)
    _close(to, jo)
    assert tc is cache
    kvp = np.array([[0, 1, 2, -1, 4, 5, -1]] * 2, np.int32)
    jo, _ = jattention.gqa_forward(lj, jnp.asarray(x), cfg=jm.cfg,
                                   positions=pos_j, kv_x=jnp.asarray(mem),
                                   kv_positions=jnp.asarray(kvp))
    tk, _ = tattention.gqa_forward(lt, _t(x), cfg=tm.cfg, positions=pos_t,
                                   kv_x=_t(mem), kv_positions=_t(kvp))
    _close(tk, jo)
    assert not torch.allclose(tk, to)  # the -1 slots are masked
    # the cached cross K/V of prefill (no K bias) against the uncached path
    cross = {"k": (_t(mem) @ lt["wk"]).reshape(2, 7, 4, 16),
             "v": (_t(mem) @ lt["wv"] + lt["bv"]).reshape(2, 7, 4, 16)}
    _close(tm._xattn_cached(lt, _t(x), pos_t, cross), to)


def test_whisper_encode_matches_jax():
    """The encoder (sinusoidal positions, biased LayerNorm, unmasked
    self-attention, biased GELU MLP) on random frames."""
    jm, tm, jp, tp = _models(WHISPER, 2)
    e = _x(4, (2, 10, 64), 0.1)
    _close(tm.encode(tp, _t(e)), jm.encode(jp, jnp.asarray(e)))
    assert np.array_equal(twhisper._sinusoid(10, 64),
                          np.asarray(jwhisper._sinusoid(10, 64)))


def test_whisper_encdec_paths():
    """``tests/test_models.py::test_whisper_encdec_paths`` on the port:
    prefill (the encoder once, cross K/V cached) + decode against the
    teacher-forced logits, the port's and JAX's; the loss against JAX's;
    the 64-row position table of a non-CONFIG build, wrapped past 64."""
    jm, tm, jp, tp = _models(WHISPER, 3)
    assert tm.max_dec_len == jm.max_dec_len == 64
    B, F, S, k = 2, 8, 10, 4
    batch = _batch(WHISPER, 5, B, S, F)
    jloss, _ = jm.loss(jp, _jb(batch))
    tloss, _ = tm.loss(tp, _tb(batch))
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    full_t, _ = tm.forward(tp, _tb(batch))
    full_j, _ = jm.forward(jp, _jb(batch))
    _close(full_t, full_j)
    cache = tm.init_cache(B, S, F, device="cpu")
    logits, cache = tm.prefill(
        tp, {"enc_embeds": _t(batch["enc_embeds"]),
             "tokens": _t(batch["tokens"][:, :k])}, cache)
    for ref in (full_t, full_j):
        _close(logits[:, 0], _np(ref)[:, k - 1], DECODE_TOL)
    for pos in range(k, S):
        before = tree_map(lambda t: t.clone(), cache)
        logits, new = tm.decode_step(
            tp, {"tokens": _t(batch["tokens"][:, pos:pos + 1])}, pos, cache)
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
            flatten_with_paths(cache), flatten_with_paths(before)))
        cache = new
        for ref in (full_t, full_j):
            _close(logits[:, 0], _np(ref)[:, pos], DECODE_TOL,
                   f"decode at {pos}")
    # positions past the table wrap: position 70 reads row 6
    tok = batch["tokens"][:, :1]
    assert torch.equal(tm._dec_embed(tp, _t(tok), 70),
                       tm._dec_embed(tp, _t(tok), 6))
    a, _ = tm.decode_step(tp, {"tokens": _t(tok)}, 70, cache)
    ja, _ = jm.decode_step(jp, {"tokens": jnp.asarray(tok)}, jnp.int32(70),
                           jax.tree.map(jnp.asarray, tree_map(
                               lambda t: t.numpy(), cache)))
    _close(a, ja)


def test_whisper_full_config_keeps_the_32768_row_table():
    """``build(CONFIG)`` gets 32768 position rows, any other config 64, by
    the twin's identity test; the harness shapes show it."""
    mod, jmod = tconfigs.get_arch(WHISPER), jconfigs.get_arch(WHISPER)
    assert mod.build().max_dec_len == jmod.build().max_dec_len == 1 << 15
    same = dataclasses.replace(mod.CONFIG)
    assert mod.build(same).max_dec_len == jmod.build(
        dataclasses.replace(jmod.CONFIG)).max_dec_len == 64
    shapes = LMHarness(WHISPER).param_shapes()
    assert tuple(shapes["pos_embed"]["table"].shape) == (1 << 15, 1280)




WHISPER_LAYER_ATOL = 2.0 ** -8


@pytest.mark.parametrize("i", [0, 1])
def test_whisper_layers_bf16_equal_jax_eager(i):
    """Whisper's encoder layer i (with the sinusoid add and the final
    LayerNorm: ``encode`` over that layer alone) and decoder layer i (with
    the final LayerNorm and the tied logits: ``_decoder`` over that layer
    alone, on JAX's encoder output), bf16, op by op: at
    least LAYER_SAME_MIN byte-equal to JAX's eager ones, all within two
    bf16 steps or WHISPER_LAYER_ATOL. A LayerNorm output a float32 ulp
    from a bf16 boundary can round the other way (the libraries sum the
    mean and variance in other orders) and move its row's MLP output:
    encoder layer 1, one element, 3.05e-3 on an output of 2.16e-2; over
    both layers at once 98.4 % byte-equal."""
    jm, tm, jp, tp = _models(WHISPER, 0, jnp.bfloat16)
    one = lambda m: type(m)(dataclasses.replace(m.cfg, n_layers=1),  # noqa
                            m.max_dec_len)
    jm, tm = one(jm), one(tm)
    for key in ("enc_layers", "dec_layers"):
        jp[key] = jax.tree.map(lambda a: a[i:i + 1], jp[key])
        tp[key] = tree_map(lambda a: a[i:i + 1], tp[key])
    batch = _batch(WHISPER, 2, F=10)
    pos_j = jnp.broadcast_to(jnp.arange(12, dtype=jnp.int32)[None], (2, 12))
    pos_t = torch.arange(12, dtype=torch.int32)[None].expand(2, 12)
    with jax.disable_jit():
        je = jm.encode(jp, jnp.asarray(batch["enc_embeds"], jnp.bfloat16))
        jx = jm._dec_embed(jp, jnp.asarray(batch["tokens"]), 0)
        jl, _ = jm._decoder(jp, jx, pos_j, je, None, None)
    te = tm.encode(tp, _t(batch["enc_embeds"]).to(torch.bfloat16))
    tx = tm._dec_embed(tp, _t(batch["tokens"]), 0)
    assert _same_share(tx, jx) == 1.0
    memory = _t(np.asarray(je).view(np.int16)).view(torch.bfloat16)
    tl, _ = tm._decoder(tp, tx, pos_t, memory, None, None)
    for ty, jy in ((te, je), (tl, jl)):
        assert ty.dtype == torch.bfloat16
        assert _same_share(ty, jy) >= LAYER_SAME_MIN
        np.testing.assert_allclose(_np(ty), _np(jy), rtol=2.0 ** -6,
                                   atol=WHISPER_LAYER_ATOL)




def test_serve_refuses_whisper():
    """``launch.serve --arch whisper-large-v3`` exits with JAX's message."""
    with pytest.raises(SystemExit, match="needs a modality frontend"):
        tserve.main(["--arch", WHISPER, "--device", "cpu"])


# --------------------------------------------------------------------------
# the arch-level cases shared with the recurrent archs
# --------------------------------------------------------------------------
def test_forward_and_loss_match_jax_f32():
    check_forward_and_loss_match_jax_f32(WHISPER)


def test_forward_bf16_within_tolerance():
    check_forward_bf16_within_tolerance(WHISPER)


def test_harness_steps_serve_greedy():
    check_harness_steps_serve_greedy(WHISPER)


def test_harness_batch_and_cache_shapes_match_jax():
    check_harness_batch_and_cache_shapes_match_jax(WHISPER)
