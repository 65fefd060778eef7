"""The LM serving path of the port (``repro_torch.models``, ``configs``,
``serving.BatchServer`` / ``Scheduler``, ``launch.steps`` / ``serve``)
against the JAX package, on REDUCED configs, on the CPU. The registry,
init and shape cases cover all ten archs of JAX's registry; the numerics
and serving cases here cover the attention family (granite-3-2b: GQA,
swiglu; granite-20b: MQA, gelu; mixtral-8x7b: MoE top-2 with
sliding-window rings; llama4-scout: MoE top-1 with a shared expert;
gemma3-12b: local:global windows, q/k norm, geglu, scaled tied
embeddings; minicpm3-4b: MLA; qwen2-vl-2b: the embeddings frontend). The
attention family's blocks (MoE dispatch, MLA, M-RoPE, the split cache,
bf16 scores) are in ``tests/test_torch_lm_blocks.py``; the non-attention
families and whisper (zamba2-1.2b, rwkv6-7b, whisper-large-v3) in
``tests/test_torch_lm_recurrent.py``.

* The registry: the port's archs are JAX's, in its order; each one's
  CONFIG and REDUCED equal JAX's field for field (``dtype`` mapped), and
  each resolves to a model of the twin's class and a harness.
* ``init(prng.key(s))`` against ``init(jax.random.key(s))``: float32
  leaves to rtol 1e-6 (``prng.normal``), bfloat16 ones within one bf16
  step; ``param_count`` equals JAX's, and the leaves equal JAX's leaves
  (for the attention family also the analytic count but for the norm
  scales it leaves out: q/k norm, MLA's latent norms).
* On JAX's params (``convert.lm_params``), float32: ``forward`` logits to
  rtol / atol 1e-5, ``prefill`` + ``decode_step`` against the
  teacher-forced logits at JAX's 2e-3 (MoE archs at ``capacity_factor =
  E/k``, as JAX's own test), ``loss`` to rtol 1e-6, the MoE aux loss too.
* bfloat16: one layer body byte-equal to JAX's op-by-op (eager) body
  in at least ``LAYER_SAME_MIN`` of its elements; the stack within
  ``EAGER_RTOL`` / ``EAGER_ATOL`` of JAX's op-by-op stack, and within
  ``BF16_TOL`` of JAX's jitted one (XLA fuses the jitted scan body and
  drops some bf16 roundings the eager ops keep) or, where that fusion
  moves JAX's own op-by-op stack further, no further from it than JAX's
  op-by-op stack is; ``BatchServer`` greedy tokens
  equal to JAX's up to the first step where JAX's own top-2 margin is
  within ``BF16_MARGIN``.
* ``rms_norm`` forward and backward equal to ``jax.vjp`` in float32, and
  bf16 at its boundaries; ``Scheduler.next_batch`` order; the launcher on
  ``--device cpu``.
"""

import dataclasses
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_lm_train import one_torch_thread  # noqa: E402,F401

from repro import configs as jconfigs  # noqa: E402
from repro.launch.steps import LMHarness as JHarness  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.serving import BatchServer as JServer  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import Scheduler as JScheduler  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import LMHarness, SkipCell  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.serving import BatchServer, Request, Scheduler  # noqa: E402
from repro_torch.tree import flatten_with_paths, tree_map  # noqa: E402

# the attention family: its numerics and serving cases are here
ATTN_ARCHS = ["granite-3-2b", "granite-20b", "mixtral-8x7b",
              "llama4-scout-17b-a16e", "gemma3-12b", "minicpm3-4b",
              "qwen2-vl-2b"]
# every arch of the JAX registry: the registry, init and shape cases are
# here; the numerics and serving cases of the non-attention families and
# whisper are in tests/test_torch_lm_recurrent.py
ARCHS = ATTN_ARCHS + ["whisper-large-v3", "zamba2-1.2b", "rwkv6-7b"]
# the archs the token launcher serves (qwen2-vl-2b has the embeddings
# frontend: JAX's launcher refuses it, and it is served through the
# harness's steps)
SERVED = [a for a in ATTN_ARCHS if a != "qwen2-vl-2b"]
F32_TOL = 1e-5        # forward logits, float32: rtol and atol
DECODE_TOL = 2e-3     # prefill / decode vs teacher forcing (JAX's own)
# bf16 logits, port vs JAX's jitted forward: |d| <= atol + rtol |jax|,
# 2^-5 each (two bf16 steps at 2..4; 2 measured at most)
BF16_TOL = 2.0 ** -5
# a greedy token is compared where JAX's top-2 margin exceeds BF16_MARGIN:
# twice the largest |port - JAX| logit gap on the decode path (2^-5
# measured over 8 steps x 4 rows, logits up to 3.7), so neither side's
# rounding can swap the top two
BF16_MARGIN = 2 * 2.0 ** -5
# one bf16 layer, port vs JAX's eager body: the share of byte-equal
# elements (granite-3-2b: all; granite-20b's gelu: 1533 of 1536 at least)
LAYER_SAME_MIN = 0.99
# the bf16 stack, port vs JAX's op-by-op stack: |d| <= atol + rtol |jax|
# (2^-7 measured at most, one bf16 step of a logit in [1, 2)), and the
# share of byte-equal logits (98.4 % measured at least)
EAGER_RTOL, EAGER_ATOL, EAGER_SAME_MIN = 2.0 ** -6, 2.0 ** -7, 0.98
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def _cfgs(arch, dtype=None):
    jmod, tmod = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    jcfg, tcfg = jmod.REDUCED, tmod.REDUCED
    if dtype is not None:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        tcfg = dataclasses.replace(tcfg, dtype=DTYPES[dtype])
    return jmod.build(jcfg), tmod.build(tcfg)


def _teacher_forcing(cfg):
    """``cfg`` with ``capacity_factor = E/k`` for MoE archs: capacity
    dispatch is then dropless, so teacher-forced and incremental paths are
    comparable (JAX's ``tests/test_models.py`` does the same)."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def _jax_params(jmodel, seed):
    jp = jmodel.init(jax.random.key(seed))
    return jp, convert.lm_params(jax.tree.map(np.asarray, jp))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(1, vocab, shape).astype(
        np.int32)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", ["CONFIG", "REDUCED"])
def test_config_equals_jax_field_for_field(arch, which):
    jc = getattr(jconfigs.get_arch(arch), which)
    tc = getattr(tconfigs.get_arch(arch), which)
    assert [f.name for f in dataclasses.fields(tc)] == [
        f.name for f in dataclasses.fields(jc)]
    for f in dataclasses.fields(jc):
        a, b = getattr(jc, f.name), getattr(tc, f.name)
        if f.name == "dtype":
            assert DTYPES[a] == b
        elif dataclasses.is_dataclass(a):  # MoEConfig, MLAConfig, ...
            assert type(b).__name__ == type(a).__name__, f.name
            assert dataclasses.asdict(b) == dataclasses.asdict(a), f.name
        else:
            assert a == b, f.name
    for prop in ("padded_vocab", "resolved_head_dim", "q_group"):
        assert getattr(tc, prop) == getattr(jc, prop), prop
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()


def test_registry_lists_every_jax_arch():
    """The port's registry is JAX's, in its order."""
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert sorted(tconfigs.list_archs()) == sorted(ARCHS)
    assert not hasattr(tconfigs, "NOT_PORTED")
    assert tconfigs.SHAPES == {k: tconfigs.Shape(**dataclasses.asdict(v))
                               for k, v in jconfigs.SHAPES.items()}


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_every_jax_arch_resolves_in_the_port(arch):
    """Each arch of JAX's registry resolves in the port: its module, a
    model of the twin's class built from CONFIG and REDUCED, and a
    harness."""
    jmod, tmod = jconfigs.get_arch(arch), tconfigs.get_arch(arch)
    assert tmod.__name__ == jmod.__name__.replace("repro.", "repro_torch.")
    for which in ("CONFIG", "REDUCED"):
        jm = jmod.build(getattr(jmod, which))
        tm = tmod.build(getattr(tmod, which))
        assert type(tm).__name__ == type(jm).__name__
        assert tm.cfg.name == jm.cfg.name == arch
    h = LMHarness(arch)
    assert h.cfg is tmod.CONFIG and type(h.model).__name__ == type(
        JHarness(arch).model).__name__


def test_unknown_arch_is_a_key_error():
    with pytest.raises(KeyError):
        tconfigs.get_arch("no-such-arch")


def test_unported_blocks_and_steps_raise():
    """What still raises: a train or prefill step on a mesh over several
    distinct cards (LM execution across cards, ROADMAP item 12e), an
    unknown block kind (a ValueError) and the long_500k cell of a
    full-attention arch (a SkipCell). The train step, the shardings and
    the remat / ``seq_parallel_attn`` / ``moe_ep`` levers run
    (``tests/test_torch_lm_train.py``, ``test_torch_lm_mesh.py``,
    ``test_torch_lm_partition.py``)."""
    from repro_torch.launch.mesh import LMMesh

    base = tconfigs.get_arch("granite-3-2b").REDUCED
    build = tconfigs.get_arch("granite-3-2b").build
    with pytest.raises(ValueError):
        build(dataclasses.replace(base, block_kind="no-such-block"))
    for lever in ("seq_parallel_attn", "moe_ep"):
        assert getattr(build(dataclasses.replace(base, **{lever: True}))
                       .cfg, lever)
    h = LMHarness("granite-3-2b", cfg=base)
    two_cards = LMMesh(("data", "model"), (2, 1), ("cuda:0", "cuda:1"))
    with pytest.raises(NotImplementedError, match="item 12e"):
        h.make_train_step(SHAPES["train_4k"], two_cards)
    with pytest.raises(NotImplementedError, match="item 12e"):
        h.make_prefill_step(SHAPES["prefill_32k"], two_cards)
    assert h.shardings(SHAPES["decode_32k"], two_cards, "decode")
    with pytest.raises(ValueError):
        h.shardings(SHAPES["decode_32k"], two_cards, "no-such-kind")
    with pytest.raises(SkipCell):
        h.cache_shapes(SHAPES["long_500k"])


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_init_matches_jax(arch, dtype):
    jmodel, tmodel = _cfgs(arch, dtype)
    for seed in (0, 3):
        jl = jax.tree_util.tree_flatten_with_path(
            jmodel.init(jax.random.key(seed)))[0]
        tl = flatten_with_paths(tmodel.init(prng.key(seed), device="cpu"))
        assert [jax.tree_util.keystr(p) for p, _ in jl] == [
            "".join(f"['{k}']" for k in p) for p, _ in tl]
        for (_, a), (_, b) in zip(jl, tl):
            assert b.dtype == DTYPES[dtype] and tuple(b.shape) == a.shape
            if dtype == jnp.float32:
                np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                           rtol=1e-6, atol=1e-7)
            else:  # one float32 ulp apart can round to adjacent bf16 steps
                a, b = _np(a), _np(b)
                np.testing.assert_allclose(b, a, rtol=2.0 ** -7, atol=0)


def uncounted_norms(cfg) -> int:
    """The norm scales the analytic ``param_count`` leaves out: q/k norm
    and MLA's two latent norms, per layer."""
    per = 2 * cfg.resolved_head_dim if cfg.qk_norm else 0
    if cfg.mla is not None:
        per += cfg.mla.q_lora_rank + cfg.mla.kv_lora_rank
    return cfg.n_layers * per


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("which", ["CONFIG", "REDUCED"])
def test_param_count_equals_the_leaves(arch, which):
    """The port's leaves count JAX's for every arch. For the attention
    family they also count ``param_count()`` plus the norm scales it
    leaves out; JAX's analytic count does not describe zamba2's shared
    block and LoRA, rwkv6's mixes and LoRA decay, or whisper's encoder and
    position table (zamba2-1.2b: 1106350208 leaves, 2950167296 counted;
    rwkv6-7b 7534415872 / 8347717632; whisper-large-v3 1577530880 /
    762005760), and ``param_count`` keeps JAX's formula."""
    cfg = getattr(tconfigs.get_arch(arch), which)
    shapes = LMHarness(arch, cfg=cfg).param_shapes()
    leaves = [t for _, t in flatten_with_paths(shapes)]
    assert all(t.device.type == "meta" and t.dtype == cfg.dtype
               for t in leaves)
    n = sum(t.numel() for t in leaves)
    jleaves = jax.tree.leaves(JHarness(
        arch, cfg=getattr(jconfigs.get_arch(arch), which)).param_shapes())
    assert n == sum(int(np.prod(s.shape)) for s in jleaves)
    if arch in ATTN_ARCHS:
        assert n == cfg.param_count() + uncounted_norms(cfg)


def test_chunked_normal_equals_jax(monkeypatch):
    """A draw made chunk by chunk (a small ``_CHUNK``, ragged last chunk)
    gives the same normals as one made at once, and JAX's to rtol 1e-6."""
    k = prng.key(7)
    whole, whole_u = prng.normal(k, (3, 1000)), prng.uniform(k, (777,))
    monkeypatch.setattr(prng, "_CHUNK", 256)
    chunked = prng.normal(k, (3, 1000))
    assert torch.equal(chunked, whole)
    assert torch.equal(prng.uniform(k, (777,)), whole_u)
    np.testing.assert_allclose(
        chunked.numpy(), np.asarray(jax.random.normal(jax.random.key(7),
                                                      (3, 1000))),
        rtol=1e-6, atol=1e-7)


def test_lm_params_keeps_dtypes_and_values():
    jmodel, _ = _cfgs("granite-20b")
    jp = jmodel.init(jax.random.key(0))
    tp = convert.lm_params(jax.tree.map(np.asarray, jp))
    for (_, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(jp)[0],
                              flatten_with_paths(tp)):
        assert b.dtype == torch.bfloat16
        assert np.array_equal(np.asarray(a).view(np.int16),
                              b.view(torch.int16).numpy())


# --------------------------------------------------------------------------
# float32 numerics
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_forward_and_loss_match_jax_f32(arch):
    jmodel, tmodel = _cfgs(arch, jnp.float32)
    jp, tp = _jax_params(jmodel, 1)
    toks = _tokens(0, (2, 12), jmodel.cfg.vocab_size)
    jl, jaux = jmodel.forward(jp, {"tokens": jnp.asarray(toks)})
    tl, taux = tmodel.forward(tp, {"tokens": torch.from_numpy(toks)})
    assert tl.shape == jl.shape and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=F32_TOL,
                               atol=F32_TOL)
    if jmodel.cfg.moe is None:
        assert float(taux) == float(jaux) == 0.0
    else:  # the sum of the layers' router balance losses
        assert float(jaux) > 0
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    batch = {"tokens": toks, "targets": np.roll(toks, -1, axis=1)}
    jloss, jparts = jmodel.loss(jp, jax.tree.map(jnp.asarray, batch))
    tloss, tparts = tmodel.loss(tp, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)
    for k in ("ce", "z_loss"):
        np.testing.assert_allclose(float(tparts[k]), float(jparts[k]),
                                   rtol=1e-5)
    np.testing.assert_allclose(float(tparts["aux"]), float(jparts["aux"]),
                               rtol=1e-6)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_prefill_decode_matches_forward_f32(arch):
    """``tests/test_models.py::test_prefill_decode_matches_forward`` on the
    port, with JAX's teacher-forced logits as the reference too (MoE archs
    at ``capacity_factor = E/k``)."""
    jmodel, tmodel = _cfgs(arch, jnp.float32)
    jmodel = type(jmodel)(_teacher_forcing(jmodel.cfg))
    tmodel = type(tmodel)(_teacher_forcing(tmodel.cfg))
    jp, tp = _jax_params(jmodel, 1)
    B, S, k = 2, 12, 6
    toks = _tokens(0, (B, S), jmodel.cfg.vocab_size)
    full_t, _ = tmodel.forward(tp, {"tokens": torch.from_numpy(toks)})
    full_j, _ = jmodel.forward(jp, {"tokens": jnp.asarray(toks)})
    cache = tmodel.init_cache(B, S, device="cpu")
    logits_k, cache = tmodel.prefill(
        tp, {"tokens": torch.from_numpy(toks[:, :k])}, cache)
    for ref in (full_t.numpy(), np.asarray(full_j)):
        np.testing.assert_allclose(logits_k[:, 0].numpy(), ref[:, k - 1],
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
    for pos in range(k, S):
        before = {n: v.clone() for n, v in cache.items()}
        step_logits, new = tmodel.decode_step(
            tp, {"tokens": torch.from_numpy(toks[:, pos:pos + 1])}, pos,
            cache)
        assert all(torch.equal(cache[n], before[n]) for n in cache), (
            "decode_step wrote into the caller's cache")
        cache = new
        for ref in (full_t.numpy(), np.asarray(full_j)):
            np.testing.assert_allclose(
                step_logits[:, 0].numpy(), ref[:, pos], rtol=DECODE_TOL,
                atol=DECODE_TOL, err_msg=f"{arch} decode at pos {pos}")


# --------------------------------------------------------------------------
# bfloat16 numerics and serving
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_layer_body_bf16_equals_jax_eager(arch):
    """One bf16 layer, op by op: the port's body gives JAX's eager body's
    bytes (the activations are XLA's op-by-op bf16 formulas) but for a
    few elements where a float32 ``tanh`` or ``exp`` of the two libraries
    rounds to the next bf16 step: at least LAYER_SAME_MIN equal, all within
    two steps."""
    jmodel, tmodel = _cfgs(arch)
    jp, tp = _jax_params(jmodel, 0)
    toks = _tokens(0, (2, 12), jmodel.cfg.vocab_size)
    jx = jmodel._embed(jp, {"tokens": jnp.asarray(toks)})
    tx = tmodel._embed(tp, {"tokens": torch.from_numpy(toks)})
    assert np.array_equal(np.asarray(jx).view(np.int16),
                          tx.view(torch.int16).numpy())
    pos_j = jnp.broadcast_to(jnp.arange(12, dtype=jnp.int32)[None], (2, 12))
    pos_t = torch.arange(12, dtype=torch.int32)[None].expand(2, 12)
    windows = jmodel.layer_windows()
    for i in range(jmodel.cfg.n_layers):
        jl = jax.tree.map(lambda a: a[i], jp["layers"])
        tl = tree_map(lambda t: t[i], tp["layers"])
        jy, _, jaux = jmodel._layer_body(jx, jl, jnp.int32(windows[i]),
                                         None, None, pos_j, None)
        ty, _, taux = tmodel._layer_body(tx, tl, int(windows[i]), None,
                                         None, pos_t)
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
        assert ty.dtype == torch.bfloat16
        same = np.asarray(jy).view(np.int16) == ty.view(torch.int16).numpy()
        assert same.mean() >= LAYER_SAME_MIN, f"layer {i}"
        np.testing.assert_allclose(_np(ty), _np(jy), rtol=2.0 ** -6,
                                   atol=2.0 ** -14, err_msg=f"layer {i}")


def _jax_eager_logits(jmodel, jp, toks):
    """JAX's forward op by op: its layer body, final norm and unembed run
    eagerly, one op at a time (no jitted scan body)."""
    B, S = toks.shape
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    windows = jmodel.layer_windows()
    with jax.disable_jit():
        x = jmodel._embed(jp, {"tokens": jnp.asarray(toks)})
        for i in range(jmodel.cfg.n_layers):
            x, _, _ = jmodel._layer_body(
                x, jax.tree.map(lambda a: a[i], jp["layers"]),
                jnp.int32(windows[i]), None, None, pos, None)
        x = jcommon.rms_norm(x, jp["final_norm"]["scale"],
                             jmodel.cfg.norm_eps)
        return jmodel._unembed(jp, x)


def _tol_ratio(got, want, rtol, atol) -> float:
    """max |got - want| / (atol + rtol |want|)."""
    return float((np.abs(got - want) / (atol + rtol * np.abs(want))).max())


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_forward_bf16_within_tolerance(arch):
    """The bf16 stack: within EAGER_RTOL / EAGER_ATOL of JAX's op-by-op
    stack (EAGER_SAME_MIN of it byte-equal), and within BF16_TOL of JAX's
    jitted forward. Where XLA's fused scan body moves JAX's own op-by-op
    stack further than BF16_TOL from the jitted one (a bf16 rounding that
    sends a token to another expert, mixtral's seed 1; 1.02-1.19 x
    BF16_TOL in llama4-scout and minicpm3), the port is held no further
    from the jitted forward than that, plus its own gap to the op-by-op
    stack."""
    jmodel, tmodel = _cfgs(arch)
    jp, tp = _jax_params(jmodel, 0)
    for seed in (0, 1):
        toks = _tokens(seed, (2, 12), jmodel.cfg.vocab_size)
        jl, _ = jmodel.forward(jp, {"tokens": jnp.asarray(toks)})
        tl, _ = tmodel.forward(tp, {"tokens": torch.from_numpy(toks)})
        assert tl.dtype == torch.bfloat16
        je = _jax_eager_logits(jmodel, jp, toks)
        same = np.asarray(je).view(np.int16) == tl.view(torch.int16).numpy()
        assert same.mean() >= EAGER_SAME_MIN, (seed, same.mean())
        np.testing.assert_allclose(_np(tl), _np(je), rtol=EAGER_RTOL,
                                   atol=EAGER_ATOL)
        to_jit = _tol_ratio(_np(tl), _np(jl), BF16_TOL, BF16_TOL)
        eager_to_jit = _tol_ratio(_np(je), _np(jl), BF16_TOL, BF16_TOL)
        to_eager = _tol_ratio(_np(tl), _np(je), BF16_TOL, BF16_TOL)
        bound = 1.0 if eager_to_jit <= 1.0 else eager_to_jit + to_eager
        assert to_jit <= bound, (seed, to_jit, eager_to_jit)


def _requests(rng, n, vocab, max_new):
    out = []
    for uid in range(n):
        plen = int(rng.integers(4, 40))
        out.append((uid, rng.integers(1, vocab, plen).astype(np.int32),
                    max_new))
    return out


def _jax_margins(jmodel, jp, batch, max_seq, n_steps):
    """JAX's top-2 logit margin at each greedy step of
    ``BatchServer.serve`` for ``batch``: its prefill and decode path,
    on its own tokens."""
    B = len(batch)
    S = max(len(r.prompt) for r in batch)
    toks = np.zeros((B, S), np.int32)
    for i, r in enumerate(batch):
        toks[i, S - len(r.prompt):] = r.prompt
    cache = jmodel.init_cache(B, max_seq)
    logits, cache = jax.jit(jmodel.prefill)(
        jp, {"tokens": jnp.asarray(toks)}, cache)
    decode = jax.jit(jmodel.decode_step)
    margins = []
    for step in range(n_steps):
        lg = np.asarray(logits[:, -1].astype(jnp.float32))
        top2 = np.sort(lg, axis=-1)[:, -2:]
        margins.append(top2[:, 1] - top2[:, 0])
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        logits, cache = decode(jp, {"tokens": tok}, jnp.int32(S + step),
                               cache)
    return np.stack(margins, 1)


@pytest.mark.parametrize("arch", SERVED)
def test_batch_server_greedy_tokens_match_jax(arch):
    """A ``Scheduler``-batched request set through both ``BatchServer``s
    (bf16): the same batches, and each request's tokens equal up to the
    first step where JAX's top-2 margin is within BF16_MARGIN; at least
    one request compared to its end."""
    jmodel, tmodel = _cfgs(arch)
    jp, tp = _jax_params(jmodel, 0)
    max_seq, max_new = 64, 8
    reqs = _requests(np.random.default_rng(0), 8, jmodel.cfg.vocab_size,
                     max_new)
    js, ts = JScheduler(4), Scheduler(4)
    for uid, prompt, n in reqs:
        js.submit(JRequest(uid=uid, prompt=prompt, max_new_tokens=n))
        ts.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n))
    jserver = JServer(jmodel, jp, max_seq=max_seq)
    tserver = BatchServer(tmodel, tp, max_seq=max_seq, device="cpu")
    whole = 0
    while True:
        jb, tb = js.next_batch(), ts.next_batch()
        assert [r.uid for r in tb] == [r.uid for r in jb]
        if not jb:
            break
        jc, tc = jserver.serve(jb), tserver.serve(tb)
        margins = _jax_margins(jmodel, jp, jb, max_seq, max_new)
        for i, (a, b) in enumerate(zip(jc, tc)):
            assert (b.uid, b.prompt_len) == (a.uid, a.prompt_len)
            assert b.tokens.dtype == np.int32 and len(b.tokens) == len(
                a.tokens)
            close = margins[i] <= BF16_MARGIN
            n = int(np.argmax(close)) if close.any() else len(a.tokens)
            # the first n tokens had clear margins; token n is JAX's pick
            # among near-ties, so it is compared only if the port agrees
            assert np.array_equal(b.tokens[:n], a.tokens[:n]), (b.uid, n)
            whole += n == len(a.tokens)
        stats = tserver.throughput_stats(tc)
        assert stats["generated_tokens"] == sum(len(c.tokens) for c in tc)
    assert whole >= 1


def test_batch_server_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, tmodel = _cfgs("granite-3-2b")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        tmodel.init(prng.key(0))
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        BatchServer(tmodel, {}, max_seq=8)


# --------------------------------------------------------------------------
# rms_norm, the scheduler, the harness, the launcher
# --------------------------------------------------------------------------
def test_rms_norm_matches_jax_vjp():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 5, 24)).astype(np.float32)
    scale = rng.normal(0, 0.1, (24,)).astype(np.float32)
    g = rng.normal(0, 1, (2, 5, 24)).astype(np.float32)
    jy, vjp = jax.vjp(lambda a, s: jcommon.rms_norm(a, s, 1e-6),
                      jnp.asarray(x), jnp.asarray(scale))
    jdx, jds = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    ts = torch.from_numpy(scale).requires_grad_(True)
    ty = tcommon.rms_norm(tx, ts, 1e-6)
    tdx, tds = torch.autograd.grad(ty, (tx, ts), torch.from_numpy(g))
    for a, b in ((jy, ty), (jdx, tdx), (jds, tds)):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=1e-6, atol=1e-6)
    # bf16 at both boundaries, as the custom VJP keeps it
    xb = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    sb = torch.from_numpy(scale).to(torch.bfloat16).requires_grad_(True)
    yb = tcommon.rms_norm(xb, sb)
    dxb, dsb = torch.autograd.grad(yb, (xb, sb),
                                   torch.from_numpy(g).to(torch.bfloat16))
    assert yb.dtype == dxb.dtype == dsb.dtype == torch.bfloat16
    jyb, jvjp = jax.vjp(lambda a, s: jcommon.rms_norm(a, s),
                        jnp.asarray(x, jnp.bfloat16),
                        jnp.asarray(scale, jnp.bfloat16))
    assert np.array_equal(np.asarray(jyb).view(np.int16),
                          yb.detach().view(torch.int16).numpy())


def test_scheduler_order_matches_jax():
    """One scripted sequence of submits and next_batch calls."""
    rng = np.random.default_rng(3)
    js, ts = JScheduler(3), Scheduler(3)
    order_j, order_t, uid = [], [], 0
    for rnd in range(8):
        for _ in range(int(rng.integers(0, 5))):
            p = np.ones(int(rng.integers(1, 60)), np.int32)
            js.submit(JRequest(uid=uid, prompt=p))
            ts.submit(Request(uid=uid, prompt=p))
            uid += 1
        order_j.append([r.uid for r in js.next_batch()])
        order_t.append([r.uid for r in ts.next_batch()])
    while js.pending or ts.pending:
        order_j.append([r.uid for r in js.next_batch()])
        order_t.append([r.uid for r in ts.next_batch()])
    assert order_t == order_j and uid > 10


@pytest.mark.parametrize("arch", ARCHS)
def test_harness_shapes_match_jax(arch):
    jh = JHarness(arch, cfg=jconfigs.get_arch(arch).REDUCED)
    th = LMHarness(arch, cfg=tconfigs.get_arch(arch).REDUCED)
    shape = SHAPES["decode_32k"]
    jc = jax.tree_util.tree_flatten_with_path(
        jh.cache_shapes(jconfigs.SHAPES["decode_32k"]))[0]
    tc = flatten_with_paths(th.cache_shapes(shape))
    assert [jax.tree_util.keystr(p) for p, _ in jc] == [
        "".join(f"['{k}']" for k in p) for p, _ in tc]
    for (_, a), (_, b) in zip(jc, tc):
        assert tuple(b.shape) == a.shape and b.device.type == "meta"
    assert tuple(th.token_shapes(shape)["tokens"].shape) == (
        jh.token_shapes(jconfigs.SHAPES["decode_32k"])["tokens"].shape)


@pytest.mark.parametrize("arch", ATTN_ARCHS)
def test_harness_steps_serve_greedy(arch):
    """``make_prefill_step`` / ``make_decode_step`` (float32) against the
    model's own forward: the greedy tokens of teacher forcing (MoE archs
    at ``capacity_factor = E/k``)."""
    cfg = _teacher_forcing(dataclasses.replace(
        tconfigs.get_arch(arch).REDUCED, dtype=torch.float32))
    h = LMHarness(arch, cfg=cfg)
    params = h.model.init(prng.key(2), device="cpu")
    shape = tconfigs.Shape("tiny", 10, 2, "decode")
    toks = torch.from_numpy(_tokens(4, (2, 10), cfg.vocab_size))
    logits, cache = h.make_prefill_step(shape, device="cpu")(
        params, {"tokens": toks[:, :4]})
    decode = h.make_decode_step(shape)
    full, _ = h.model.forward(params, {"tokens": toks})
    for pos in range(4, 10):
        nxt, cache = decode(params, cache, {"tokens": toks[:, pos:pos + 1]},
                            pos)
        assert nxt.dtype == torch.int32 and nxt.shape == (2, 1)
        assert torch.equal(nxt[:, 0], torch.argmax(full[:, pos], -1).to(
            torch.int32))


def test_serve_launcher_on_cpu():
    out = tserve.main(["--device", "cpu", "--requests", "6",
                       "--max-new", "4"])
    assert out["total_tokens"] == 6 * 4
    assert sum(len(b["uids"]) for b in out["batches"]) == 6
    assert all(b["latency_s"] > 0 for b in out["batches"])
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "granite-20b", "--requests", "3", "--max-new", "2"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[-1].startswith("[serve] 3 requests, 6 tokens in ")
    assert all(line.startswith("[serve] batch ") for line in lines[:-1])
