"""The attention-family blocks of the port's LM zoo against the JAX
package, on the CPU: the MoE layer (``repro_torch.models.moe``), MLA and
bf16 scores (``models.attention``), M-RoPE (``models.common``), the split
cache (``DecoderLM._run_stack_split``), the embeddings frontend, and the
harness's and launcher's handling of them. Every case feeds the same
numpy inputs, made from a seed, to both packages; params are JAX's,
loaded through ``convert.lm_params``.

Tolerances: float32 outputs rtol / atol ``F32_TOL`` (1e-5), the MoE aux
loss rtol 1e-6, M-RoPE byte-equal or rtol 1e-6, prefill / decode against
teacher forcing at JAX's ``DECODE_TOL`` (2e-3). MoE capacity dispatch must
drop the same (token, expert) pairs as JAX; JAX's dropped pairs are read
from its output (each token's output is the gated sum of the experts it
kept). bf16 MoE outputs are compared byte for byte on the tokens whose
router margin (top-k against the (k+1)-th probability) exceeds
``ROUTER_MARGIN``: below it a last-bit difference of the float32 router
may route a token elsewhere, and the output is discontinuous there.
"""

import dataclasses
import itertools
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_lm_train import one_torch_thread  # noqa: E402,F401

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch.steps import LMHarness as JHarness  # noqa: E402
from repro.models import attention as jattention  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.shapes import SHAPES, Shape  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.steps import LMHarness, SkipCell  # noqa: E402
from repro_torch.models import attention as tattention  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.tree import flatten_with_paths, tree_map  # noqa: E402

F32_TOL = 1e-5
AUX_RTOL = 1e-6
DECODE_TOL = 2e-3
# a token's bf16 MoE output is compared where its router's top-k vs
# (k+1)-th probability margin exceeds this: 1000x the float32 router's
# last-bit noise (~1e-7) between the two libraries' products
ROUTER_MARGIN = 1e-4
# a bf16-score layer body, port vs JAX's op-by-op body: the share of
# byte-equal elements. A score is a float32 sum rounded to bf16; the two
# libraries sum the products in different orders, and a sum within a
# float32 ulp of a bf16 rounding boundary rounds to the other neighbour,
# which moves that row's softmax: gemma3's global layer 2 at key 0, 98.1 %
# equal and within 0.30 of BF16_TOL (the other layers and keys 1-3: all)
SCORES_SAME_MIN = 0.98
# tests/test_torch_lm.py's bound on a bf16 logit: atol and rtol 2^-5
BF16_TOL = 2.0 ** -5
DTYPES = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _t(a, dtype=None):
    """A numpy array as a CPU tensor (``dtype``: a torch dtype to cast to)."""
    t = torch.from_numpy(np.array(a, copy=True))
    return t if dtype is None else t.to(dtype)


def _cfgs(arch, dtype=jnp.float32, **change):
    jcfg = dataclasses.replace(jconfigs.get_arch(arch).REDUCED, dtype=dtype,
                               **change)
    tcfg = dataclasses.replace(tconfigs.get_arch(arch).REDUCED,
                               dtype=DTYPES[dtype], **change)
    return jcfg, tcfg


def _teacher_forcing(cfg):
    """MoE at ``capacity_factor = E/k`` (dropless capacity dispatch)."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))


def _models(arch, seed, dtype=jnp.float32, **change):
    jcfg, tcfg = _cfgs(arch, dtype, **change)
    jm = jconfigs.get_arch(arch).build(jcfg)
    tm = tconfigs.get_arch(arch).build(tcfg)
    jp = jm.init(jax.random.key(seed))
    return jm, tm, jp, convert.lm_params(jax.tree.map(np.asarray, jp))


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------
def _moe_case(arch, capacity_factor, seed=0, B=2, S=32, dtype=jnp.float32):
    jcfg, tcfg = _cfgs(arch, dtype)
    if capacity_factor is not None:
        jcfg, tcfg = (dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=capacity_factor)) for c in (jcfg, tcfg))
    jp = jmoe.init_moe(jax.random.key(3 + seed), jcfg)
    if dtype != jnp.float32:
        jp = jax.tree.map(lambda a: a.astype(dtype), jp)
    tp = convert.lm_params(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(seed).normal(0, 1, (B, S, jcfg.d_model))
    jx = jnp.asarray(x, jnp.float32).astype(dtype)
    tx = _t(np.asarray(jx.astype(jnp.float32))).to(DTYPES[dtype])
    return jcfg, tcfg, jp, tp, jx, tx


def _jax_route(jp, jx, m):
    xf = jx.reshape(-1, jx.shape[-1])
    probs = jax.nn.softmax(xf.astype(jnp.float32)
                           @ jp["router"].astype(jnp.float32), axis=-1)
    vals, idx = jax.lax.top_k(probs, m.top_k)
    return np.asarray(probs), np.asarray(vals), np.asarray(idx)


def _expert_outputs(p, xf, kind):
    """(T, E, d) float64: every expert's output for every token."""
    xf = xf.astype(np.float64)
    wg, wu, wd = (np.asarray(p[k], np.float64)
                  for k in ("w_gate", "w_up", "w_down"))
    silu = lambda z: z / (1 + np.exp(-z))  # noqa: E731
    gelu = lambda z: 0.5 * z * (1 + np.tanh(  # noqa: E731
        np.sqrt(2 / np.pi) * (z + 0.044715 * z ** 3)))
    act = silu if kind == "swiglu" else gelu
    h = act(np.einsum("td,edf->tef", xf, wg)) * np.einsum(
        "td,edf->tef", xf, wu)
    return np.einsum("tef,efd->ted", h, wd)


def _jax_dropped_pairs(jp, jcfg, jx, jout, gate_vals, gate_idx):
    """JAX's dropped (token, expert) pairs, read from its output: the
    subset of each token's top-k experts whose gated sum (plus the shared
    expert) gives the token's output; the others were dropped."""
    xf = np.asarray(jx, np.float64).reshape(-1, jcfg.d_model)
    out = np.asarray(jout, np.float64).reshape(xf.shape)
    if jcfg.moe.shared_expert:
        silu = lambda z: z / (1 + np.exp(-z))  # noqa: E731
        g, u, dn = (np.asarray(jp[k], np.float64) for k in (
            "shared_w_gate", "shared_w_up", "shared_w_down"))
        out = out - (silu(xf @ g) * (xf @ u)) @ dn
    y = _expert_outputs(jp, xf, jcfg.mlp_kind)
    k = jcfg.moe.top_k
    dropped = set()
    for t in range(xf.shape[0]):
        fits = []
        for keep in itertools.product((False, True), repeat=k):
            want = sum((gate_vals[t, j] * y[t, gate_idx[t, j]]
                        for j in range(k) if keep[j]), np.zeros_like(out[t]))
            fits.append((float(np.abs(out[t] - want).max()), keep))
        fits.sort(key=lambda f: f[0])
        # one subset fits to float32 noise; any other is off by a whole term
        assert fits[0][0] < 1e-4 < fits[1][0], (t, fits[:2])
        dropped |= {(t, int(gate_idx[t, j])) for j in range(k)
                    if not fits[0][1][j]}
    return dropped


def _port_dropped_pairs(tp, tx, tcfg, dropless):
    xf = tx.reshape(-1, tcfg.d_model)
    _, _, gate_idx = tmoe.route(tp, xf, tcfg.moe)
    C = tmoe.capacity(xf.shape[0], tcfg.moe, dropless)
    _, se, st, keep, _ = tmoe.dispatch(gate_idx, tcfg.moe.n_experts, C)
    return {(int(t), int(e)) for t, e, kp in zip(st, se, keep) if not kp}


MOE_CASES = [  # (arch, capacity factor, dropless, drops expected)
    ("mixtral-8x7b", 0.5, False, True),
    ("mixtral-8x7b", None, False, None),
    ("mixtral-8x7b", None, True, False),
    ("llama4-scout-17b-a16e", 0.5, False, True),
    ("llama4-scout-17b-a16e", None, False, None),
    ("llama4-scout-17b-a16e", None, True, False),
]


@pytest.mark.parametrize("arch,cf,dropless,drops", MOE_CASES)
def test_moe_forward_f32_matches_jax(arch, cf, dropless, drops):
    """Top-2 (mixtral) and top-1 with a shared expert (llama4-scout), with
    capacity drops (factor 0.5), at the default factor 1.25 and dropless:
    the same routing, the same dropped (token, expert) pairs, outputs to
    F32_TOL and the aux loss to AUX_RTOL."""
    jcfg, tcfg, jp, tp, jx, tx = _moe_case(arch, cf)
    jout, jaux = jmoe.moe_forward(jp, jx, jcfg, dropless=dropless)
    tout, taux = tmoe.moe_forward(tp, tx, tcfg, dropless=dropless)
    assert tout.shape == jout.shape and tout.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=AUX_RTOL)

    probs, gate_vals, gate_idx = _jax_route(jp, jx, jcfg.moe)
    tprobs, tvals, tidx = tmoe.route(tp, tx.reshape(-1, tcfg.d_model),
                                     tcfg.moe)
    assert np.array_equal(tidx.numpy(), gate_idx)
    np.testing.assert_allclose(tprobs.numpy(), probs, rtol=F32_TOL,
                               atol=1e-7)
    jdrop = _jax_dropped_pairs(
        jp, jcfg, jx, jout,
        np.asarray(gate_vals / (gate_vals.sum(-1, keepdims=True) + 1e-9)),
        gate_idx)
    tdrop = _port_dropped_pairs(tp, tx, tcfg, dropless)
    assert tdrop == jdrop
    if drops is not None:
        assert bool(tdrop) == drops, len(tdrop)


def test_moe_capacity_is_jaxs():
    """C = max(8, ceil8(T k / E x capacity_factor)), or ceil8(T) dropless."""
    for E, k, cf in ((8, 2, 1.25), (16, 1, 1.25), (4, 2, 0.5), (4, 1, 4.0)):
        m = tcommon.MoEConfig(n_experts=E, top_k=k, capacity_factor=cf)
        for T in (1, 4, 7, 24, 64, 312, 1000):
            want = max(8, -(-int(np.ceil(T * k / E * cf)) // 8) * 8)
            assert tmoe.capacity(T, m, False) == want
            assert tmoe.capacity(T, m, True) == max(8, -(-T // 8) * 8)


def test_moe_combine_order_free():
    """The combine's ``index_add_`` may add a token's addends in any order
    (atomics on the card): for top-1 and top-2 in bf16 every order gives
    the same bytes, and JAX's scatter-add's."""
    rng = np.random.default_rng(5)
    T, k, d = 64, 2, 48
    st = np.repeat(np.arange(T), k)
    contrib = rng.normal(0, 1, (T * k, d)).astype(np.float32)
    contrib[rng.random(T * k) < 0.2] = 0.0      # dropped pairs add zeros
    want = np.asarray(jnp.zeros((T, d), jnp.bfloat16).at[st].add(
        jnp.asarray(contrib, jnp.bfloat16)))
    c = _t(contrib, torch.bfloat16)
    for perm in (np.arange(T * k), np.arange(T * k)[::-1],
                 rng.permutation(T * k)):
        perm = torch.from_numpy(perm.copy())
        got = torch.zeros((T, d), dtype=torch.bfloat16).index_add_(
            0, torch.from_numpy(st)[perm], c[perm])
        assert np.array_equal(got.view(torch.int16).numpy(),
                              want.view(np.int16))


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("dropless", [False, True])
def test_moe_forward_bf16_where_router_margin_clears(arch, dropless):
    """The bf16 MoE block byte-equal to JAX's (op by op) on every token
    whose router margin exceeds ROUTER_MARGIN; those are most tokens."""
    jcfg, tcfg, jp, tp, jx, tx = _moe_case(arch, None, seed=1, B=4, S=16,
                                           dtype=jnp.bfloat16)
    with jax.disable_jit():
        jout, jaux = jmoe.moe_forward(jp, jx, jcfg, dropless=dropless)
    tout, taux = tmoe.moe_forward(tp, tx, tcfg, dropless=dropless)
    assert tout.dtype == torch.bfloat16
    np.testing.assert_allclose(float(taux), float(jaux), rtol=AUX_RTOL)
    probs, _, _ = _jax_route(jp, jx, jcfg.moe)
    top = np.sort(probs, axis=-1)[:, ::-1]
    k = jcfg.moe.top_k
    clear = top[:, k - 1] - top[:, k] > ROUTER_MARGIN
    assert clear.mean() > 0.9
    a = np.asarray(jout).view(np.int16).reshape(-1, jcfg.d_model)
    b = tout.view(torch.int16).numpy().reshape(-1, jcfg.d_model)
    assert np.array_equal(a[clear], b[clear])


def test_moe_ep_raises_with_its_item():
    """``moe_forward_ep`` falls back to the dense dispatch (equal outputs
    and aux) with no ambient mesh and on a mesh whose data axis does not
    divide the experts, as the twin's; on an eligible mesh a batch that
    does not split over the batch-shard rows raises, as the twin's
    ``shard_map`` refuses it."""
    from repro_torch.launch.mesh import make_host_mesh, use_mesh

    jcfg, tcfg, jp, tp, jx, tx = _moe_case("llama4-scout-17b-a16e", None)
    want, want_aux = tmoe.moe_forward(tp, tx, tcfg)
    for mesh in (None, make_host_mesh(data=3, devices=["cpu"])):
        with use_mesh(mesh):
            got, aux = tmoe.moe_forward_ep(tp, tx, tcfg)
        assert torch.equal(got, want) and torch.equal(aux, want_aux)
    rows = make_host_mesh(data=4, devices=["cpu"])   # 4 experts, B 2
    with use_mesh(rows), pytest.raises(ValueError, match="split"):
        tmoe.moe_forward_ep(tp, tx, tcfg)


def test_moe_ep_falls_back_without_mesh(rng):
    """``tests/test_perf_variants.py::test_moe_ep_falls_back_without_mesh``
    on the port: with ``moe_ep`` and no mesh the model's loss is finite
    and equals the dense dispatch's."""
    cfg = dataclasses.replace(tconfigs.get_arch("mixtral-8x7b").REDUCED,
                              dtype=torch.float32)
    toks = _t(rng.integers(1, cfg.vocab_size, (2, 8)).astype(np.int32))
    batch = {"tokens": toks, "targets": toks}
    dense = tconfigs.get_arch("mixtral-8x7b").build(cfg)
    ep = tconfigs.get_arch("mixtral-8x7b").build(
        dataclasses.replace(cfg, moe_ep=True))
    params = dense.init(0, device="cpu")
    loss, _ = ep.loss(params, batch)
    assert np.isfinite(float(loss))
    assert float(loss) == float(dense.loss(params, batch)[0])


def test_moe_router_balance_aux(rng):
    """``tests/test_models.py::test_moe_router_balance_aux`` on the port
    (REDUCED mixtral, bf16, a smoke batch from ``batch_shapes``): the aux
    loss is positive; in float32 it equals JAX's on JAX's params."""
    smoke = Shape("smoke", 32, 2, "train")
    h = LMHarness("mixtral-8x7b",
                  cfg=tconfigs.get_arch("mixtral-8x7b").REDUCED)
    params = h.model.init(0, device="cpu")
    batch = {k: _t(rng.integers(0, min(h.cfg.vocab_size, 100), v.shape)
                   .astype(np.int32))
             for k, v in h.batch_shapes(smoke).items()}
    _, aux = h.model.forward(params, batch)
    assert float(aux) > 0.0
    jm, tm, jp, tp = _models("mixtral-8x7b", 5)
    jl, jaux = jm.forward(jp, {"tokens": jnp.asarray(batch["tokens"])})
    tl, taux = tm.forward(tp, batch)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=AUX_RTOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=F32_TOL,
                               atol=F32_TOL)


# --------------------------------------------------------------------------
# MLA
# --------------------------------------------------------------------------
def _mla_case(seed=0, B=2, S=12):
    jcfg, tcfg = _cfgs("minicpm3-4b")
    jp = jattention.init_mla(jax.random.key(seed), jcfg)
    tp = convert.lm_params(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(seed).normal(0, 1, (B, S, jcfg.d_model)
                                           ).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    return jcfg, tcfg, jp, tp, x, pos


@pytest.mark.parametrize("chunk", [None, 4])
def test_mla_forward_without_cache_matches_jax(chunk, monkeypatch):
    """MLA over the in-call latents (float32), whole and in query chunks
    of 4 (``SDPA_CHUNK`` lowered in both packages)."""
    if chunk is not None:
        monkeypatch.setattr(jattention, "SDPA_CHUNK", chunk)
        monkeypatch.setattr(tattention, "SDPA_CHUNK", chunk)
    jcfg, tcfg, jp, tp, x, pos = _mla_case()
    jo, jc = jattention.mla_forward(jp, jnp.asarray(x), cfg=jcfg,
                                    positions=jnp.asarray(pos))
    to, tc = tattention.mla_forward(tp, _t(x), cfg=tcfg, positions=_t(pos))
    assert jc is None and tc is None
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=F32_TOL,
                               atol=F32_TOL)


def test_mla_forward_with_cache_matches_jax():
    """A prefill of 6 tokens into a 10-slot latent cache, then decode steps
    past its end (the ring wraps): outputs and the cache (``ckv``,
    ``k_rope``, ``slot_pos``) against JAX's after every call."""
    jcfg, tcfg, jp, tp, x, pos = _mla_case(seed=1, S=14)
    jcache = jattention.init_mla_cache(jcfg, 2, 10)
    tcache = tattention.init_mla_cache(tcfg, 2, 10, device="cpu")
    calls = [(0, 6)] + [(s, s + 1) for s in range(6, 14)]
    for a, b in calls:
        jo, jcache = jattention.mla_forward(
            jp, jnp.asarray(x[:, a:b]), cfg=jcfg,
            positions=jnp.asarray(pos[:, a:b]), cache=jcache,
            write_pos=jnp.int32(a))
        before = {k: v.clone() for k, v in tcache.items()}
        to, new = tattention.mla_forward(
            tp, _t(x[:, a:b]), cfg=tcfg, positions=_t(pos[:, a:b]),
            cache=tcache, write_pos=a)
        assert all(torch.equal(tcache[k], before[k]) for k in tcache)
        tcache = new
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=F32_TOL,
                                   atol=F32_TOL, err_msg=f"call at {a}")
        assert np.array_equal(tcache["slot_pos"].numpy(),
                              np.asarray(jcache["slot_pos"]))
        for k in ("ckv", "k_rope"):
            np.testing.assert_allclose(tcache[k].numpy(),
                                       np.asarray(jcache[k]), rtol=F32_TOL,
                                       atol=F32_TOL)


# --------------------------------------------------------------------------
# M-RoPE and the embeddings frontend
# --------------------------------------------------------------------------
@pytest.mark.parametrize("head_dim,sections", [(16, (1, 1, 2)),
                                               (128, (1, 1, 2)),
                                               (24, (2, 1, 1))])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_apply_mrope_matches_jax(head_dim, sections, dtype):
    rng = np.random.default_rng(head_dim)
    B, S, H = 2, 9, 3
    x = rng.normal(0, 1, (B, S, H, head_dim)).astype(np.float32)
    p3 = rng.integers(0, 4096, (3, B, S)).astype(np.int32)
    jx = jnp.asarray(x).astype(dtype)
    want = jcommon.apply_mrope(jx, jnp.asarray(p3), head_dim, 1e6,
                               sections=sections)
    got = tcommon.apply_mrope(_t(np.asarray(jx.astype(jnp.float32))).to(
        DTYPES[dtype]), _t(p3), head_dim, 1e6, sections=sections)
    assert got.dtype == DTYPES[dtype] and got.shape == want.shape
    if dtype == jnp.bfloat16:
        assert np.array_equal(got.view(torch.int16).numpy(),
                              np.asarray(want).view(np.int16))
        return
    # rtol 1e-6 of each rotated pair's size, |x1| + |x2|: an output near 0
    # is a difference of two products, where a last-bit cos / sin of the
    # two libraries is large relative to the result but not to the pair
    half = head_dim // 2
    size = np.abs(x[..., :half]) + np.abs(x[..., half:])
    size = np.concatenate([size, size], axis=-1)
    assert (np.abs(_np(got) - _np(want)) <= 1e-6 * size).all()


def test_mrope_with_equal_ids_is_rope():
    """Three equal position streams give the 1-D rope bytes (the decode
    step's M-RoPE ids, which the harness fills with the position)."""
    rng = np.random.default_rng(0)
    x = _t(rng.normal(0, 1, (2, 5, 3, 128)).astype(np.float32))
    pos = _t(rng.integers(0, 1000, (2, 5)).astype(np.int32))
    cos, sin = tcommon.make_rope(pos, 128, 1e6)
    assert torch.equal(tcommon.apply_mrope(x, pos[None].expand(3, 2, 5), 128,
                                           1e6),
                       tcommon.apply_rope(x, cos, sin))


def _vl_inputs(cfg, seed, B, S):
    rng = np.random.default_rng(seed)
    emb = rng.normal(0, 0.05, (B, S, cfg.d_model)).astype(np.float32)
    p3 = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
    p3[1:] = rng.integers(0, 8, (2, B, S))      # spatial ids of patches
    return emb, p3


def test_qwen2vl_mrope_changes_logits():
    """``tests/test_models.py::test_qwen2vl_mrope_changes_logits`` on the
    port (float32, key 4): the M-RoPE ids change the logits; each equals
    JAX's forward on the same embeddings and ids."""
    jm, tm, jp, tp = _models("qwen2-vl-2b", 4)
    rng = np.random.default_rng(0)
    B, S = 1, 8
    emb = rng.normal(0, 0.05, (B, S, jm.cfg.d_model)).astype(np.float32)
    pos_a = np.broadcast_to(np.arange(S, dtype=np.int32), (3, B, S)).copy()
    pos_b = pos_a.copy()
    pos_b[1:] *= 3
    logits = []
    for p3 in (pos_a, pos_b):
        jl, _ = jm.forward(jp, {"embeds": jnp.asarray(emb),
                                "mrope_positions": jnp.asarray(p3)})
        tl, _ = tm.forward(tp, {"embeds": _t(emb), "mrope_positions": _t(p3)})
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=F32_TOL,
                                   atol=F32_TOL)
        logits.append(tl.numpy())
    assert not np.allclose(logits[0], logits[1])


def test_embeddings_prefill_decode_matches_forward_f32():
    """qwen2-vl-2b (float32): ``embeds`` and M-RoPE ids through prefill
    and decode (each step's embedding and ids given) against the
    teacher-forced logits of the port and of JAX; the loss on embeddings
    equals JAX's."""
    jm, tm, jp, tp = _models("qwen2-vl-2b", 1)
    B, S, k = 2, 12, 6
    emb, p3 = _vl_inputs(jm.cfg, 3, B, S)
    full_j, _ = jm.forward(jp, {"embeds": jnp.asarray(emb),
                                "mrope_positions": jnp.asarray(p3)})
    full_t, _ = tm.forward(tp, {"embeds": _t(emb), "mrope_positions": _t(p3)})
    np.testing.assert_allclose(full_t.numpy(), np.asarray(full_j),
                               rtol=F32_TOL, atol=F32_TOL)
    cache = tm.init_cache(B, S, device="cpu")
    logits, cache = tm.prefill(tp, {"embeds": _t(emb[:, :k]),
                                    "mrope_positions": _t(p3[:, :, :k])},
                               cache)
    for ref in (full_t.numpy(), np.asarray(full_j)):
        np.testing.assert_allclose(logits[:, 0].numpy(), ref[:, k - 1],
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
    for pos in range(k, S):
        logits, cache = tm.decode_step(
            tp, {"embeds": _t(emb[:, pos:pos + 1]),
                 "mrope_positions": _t(p3[:, :, pos:pos + 1])}, pos, cache)
        for ref in (full_t.numpy(), np.asarray(full_j)):
            np.testing.assert_allclose(logits[:, 0].numpy(), ref[:, pos],
                                       rtol=DECODE_TOL, atol=DECODE_TOL)
    tgt = np.random.default_rng(4).integers(0, 256, (B, S)).astype(np.int32)
    jloss, _ = jm.loss(jp, {"embeds": jnp.asarray(emb), "targets": tgt,
                            "mrope_positions": jnp.asarray(p3)})
    tloss, _ = tm.loss(tp, {"embeds": _t(emb), "targets": _t(tgt),
                            "mrope_positions": _t(p3)})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)


def test_harness_steps_with_embeddings_match_jax():
    """qwen2-vl-2b through both harnesses' prefill (``embeds`` + M-RoPE
    ids) and decode steps (the harness fills the decode step's M-RoPE
    ids), float32: the same greedy tokens."""
    arch = "qwen2-vl-2b"
    jcfg, tcfg = _cfgs(arch)
    jh, th = JHarness(arch, cfg=jcfg), LMHarness(arch, cfg=tcfg)
    jp = jh.model.init(jax.random.key(2))
    tp = convert.lm_params(jax.tree.map(np.asarray, jp))
    shape = Shape("tiny", 16, 2, "prefill")
    emb, p3 = _vl_inputs(jcfg, 6, 2, 16)
    k = 8
    jl, jcache = jh.make_prefill_step(shape)(
        jp, {"embeds": jnp.asarray(emb[:, :k]),
             "mrope_positions": jnp.asarray(p3[:, :, :k])})
    tl, tcache = th.make_prefill_step(shape, device="cpu")(
        tp, {"embeds": _t(emb[:, :k]), "mrope_positions": _t(p3[:, :, :k])})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=F32_TOL,
                               atol=F32_TOL)
    jtok = jnp.argmax(jl[:, -1], -1).astype(jnp.int32)[:, None]
    ttok = torch.argmax(tl[:, -1], -1).to(torch.int32)[:, None]
    jdec, tdec = jh.make_decode_step(shape), th.make_decode_step(shape)
    for pos in range(k, 16):
        assert np.array_equal(ttok.numpy(), np.asarray(jtok)), pos
        jtok, jcache = jdec(jp, jcache, {"tokens": jtok}, jnp.int32(pos))
        ttok, tcache = tdec(tp, tcache, {"tokens": ttok}, pos)
        assert ttok.dtype == torch.int32 and ttok.shape == (2, 1)
    assert np.array_equal(ttok.numpy(), np.asarray(jtok))


# --------------------------------------------------------------------------
# local:global windows and the split cache
# --------------------------------------------------------------------------
def test_split_cache_stack_matches_uniform_and_jax():
    """gemma3-12b REDUCED (6 layers: [local, local, global] x 2, window 8)
    with ``split_cache``, float32: prefill 6 tokens, decode to 20 (past
    the window, so the local rings wrap). The logits equal the uniform
    cache's (the same model without ``split_cache``) and JAX's split
    path's; the caches (``local`` (G, g-1, ...) rings of 8 slots,
    ``global`` (G, ...) of 20) equal JAX's after every step."""
    jm, tm, jp, tp = _models("gemma3-12b", 7, split_cache=True)
    uniform = tconfigs.get_arch("gemma3-12b").build(
        dataclasses.replace(tm.cfg, split_cache=False))
    B, S, k = 2, 20, 6
    toks = np.random.default_rng(1).integers(1, 256, (B, S)).astype(np.int32)
    jcache = jm.init_cache(B, S)
    tcache = tm.init_cache(B, S, device="cpu")
    ucache = uniform.init_cache(B, S, device="cpu")
    assert sorted(tcache) == ["global", "local"]
    assert tuple(tcache["local"]["k"].shape) == (2, 2, B, 8, 2, 16)
    assert tuple(tcache["global"]["k"].shape) == (2, B, S, 2, 16)
    full, _ = tm.forward(tp, {"tokens": _t(toks)})
    steps = [(0, k)] + [(p, p + 1) for p in range(k, S)]
    for a, b in steps:
        tin = {"tokens": _t(toks[:, a:b])}
        if a == 0:
            jl, jcache = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, a:b])},
                                    jcache)
            tl, tcache = tm.prefill(tp, tin, tcache)
            ul, ucache = uniform.prefill(tp, tin, ucache)
        else:
            jl, jcache = jm.decode_step(
                jp, {"tokens": jnp.asarray(toks[:, a:b])}, jnp.int32(a),
                jcache)
            tl, tcache = tm.decode_step(tp, tin, a, tcache)
            ul, ucache = uniform.decode_step(tp, tin, a, ucache)
        for ref in (np.asarray(jl), ul.numpy()):
            np.testing.assert_allclose(tl.numpy(), ref, rtol=F32_TOL,
                                       atol=F32_TOL, err_msg=f"at {a}")
        np.testing.assert_allclose(tl[:, 0].numpy(), full[:, b - 1].numpy(),
                                   rtol=DECODE_TOL, atol=DECODE_TOL)
        jflat = jax.tree_util.tree_flatten_with_path(jcache)[0]
        tflat = flatten_with_paths(tcache)
        assert [jax.tree_util.keystr(p) for p, _ in jflat] == [
            "".join(f"['{q}']" for q in p) for p, _ in tflat]
        for (_, want), (path, got) in zip(jflat, tflat):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=F32_TOL, atol=F32_TOL,
                                       err_msg=str(path))


def test_sliding_window_ring_cache_long_decode():
    """``tests/test_models.py::test_sliding_window_ring_cache_long_decode``
    on the port: mixtral REDUCED (window 8, capacity_factor E/k, float32,
    JAX's key 2) decoded to 3x the window matches teacher forcing, the
    port's and JAX's."""
    jcfg, tcfg = (_teacher_forcing(c) for c in _cfgs("mixtral-8x7b"))
    jm = jconfigs.get_arch("mixtral-8x7b").build(jcfg)
    tm = tconfigs.get_arch("mixtral-8x7b").build(tcfg)
    jp = jm.init(jax.random.key(2))
    tp = convert.lm_params(jax.tree.map(np.asarray, jp))
    B, S = 1, 24
    toks = np.random.default_rng(0).integers(1, tcfg.vocab_size, (B, S)
                                             ).astype(np.int32)
    full, _ = tm.forward(tp, {"tokens": _t(toks)})
    jfull, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    cache = tm.init_cache(B, S, device="cpu")
    assert cache["k"].shape[2] == 8       # every layer windowed: ring of 8
    _, cache = tm.prefill(tp, {"tokens": _t(toks[:, :4])}, cache)
    for pos in range(4, S):
        step, cache = tm.decode_step(tp, {"tokens": _t(toks[:, pos:pos + 1])},
                                     pos, cache)
    for ref in (full[:, -1].numpy(), np.asarray(jfull[:, -1])):
        np.testing.assert_allclose(step[:, 0].numpy(), ref, rtol=DECODE_TOL,
                                   atol=DECODE_TOL)


# --------------------------------------------------------------------------
# bf16 attention scores
# --------------------------------------------------------------------------
@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("scores_bf16", [False, True])
def test_sdpa_scores_bf16_matches_jax(window, scores_bf16):
    """``sdpa`` on bf16 q / k / v (GQA, group 2): bf16 scores (divide and
    mask in bf16, softmax in float32) or float32 ones, byte-equal to JAX's
    op-by-op ``sdpa``."""
    rng = np.random.default_rng(11)
    B, S, Hkv, g, hd = 2, 12, 2, 2, 16
    q, k, v = (jnp.asarray(rng.normal(0, 1, (B, S, h, hd)), jnp.bfloat16)
               for h in (Hkv * g, Hkv, Hkv))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32)[None], (B, S))
    with jax.disable_jit():
        want = jattention.sdpa(q, k, v, jnp.asarray(pos), jnp.asarray(pos),
                               causal=True, window=window, q_group=g,
                               scores_bf16=scores_bf16)
    tq, tk, tv = (_t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
                  for a in (q, k, v))
    got = tattention.sdpa(tq, tk, tv, _t(pos), _t(pos), causal=True,
                          window=window, q_group=g, scores_bf16=scores_bf16)
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(),
                          np.asarray(want).view(np.int16))


def test_attn_scores_bf16_model_matches_jax():
    """gemma3-12b REDUCED with ``attn_scores_bf16`` in bf16: each layer
    body, on JAX's input to it, byte-equal to JAX's op-by-op body in all
    layers but at most one, that one in SCORES_SAME_MIN of its elements
    and all within BF16_TOL; and the flag changes the output (it is not
    ignored)."""
    jm, tm, jp, tp = _models("gemma3-12b", 0, jnp.bfloat16,
                             attn_scores_bf16=True)
    plain = tconfigs.get_arch("gemma3-12b").build(
        dataclasses.replace(tm.cfg, attn_scores_bf16=False))
    toks = np.random.default_rng(2).integers(1, 256, (2, 12)).astype(np.int32)
    jx = jm._embed(jp, {"tokens": jnp.asarray(toks)})
    tx = tm._embed(tp, {"tokens": _t(toks)})
    pos_j = jnp.broadcast_to(jnp.arange(12, dtype=jnp.int32)[None], (2, 12))
    pos_t = _t(np.asarray(pos_j))
    windows = jm.layer_windows()
    differs, whole = False, 0
    for i in range(jm.cfg.n_layers):
        jl = jax.tree.map(lambda a: a[i], jp["layers"])
        tl = tree_map(lambda t: t[i], tp["layers"])
        with jax.disable_jit():
            jy, _, _ = jm._layer_body(jx, jl, jnp.int32(windows[i]), None,
                                      None, pos_j, None)
        ty, _, _ = tm._layer_body(tx, tl, int(windows[i]), None, None, pos_t)
        py, _, _ = plain._layer_body(tx, tl, int(windows[i]), None, None,
                                     pos_t)
        same = ty.view(torch.int16).numpy() == np.asarray(jy).view(np.int16)
        assert same.mean() >= SCORES_SAME_MIN, (i, same.mean())
        whole += bool(same.all())
        np.testing.assert_allclose(_np(ty), _np(jy), rtol=BF16_TOL,
                                   atol=BF16_TOL, err_msg=f"layer {i}")
        differs |= not torch.equal(ty, py)
        # the next layer starts from JAX's output on both sides
        jx, tx = jy, _t(np.asarray(jy.astype(jnp.float32))).to(
            torch.bfloat16)
    assert differs
    assert whole >= jm.cfg.n_layers - 1


# --------------------------------------------------------------------------
# the harness's shapes and the launcher
# --------------------------------------------------------------------------
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


@pytest.mark.parametrize("arch,split", [
    ("mixtral-8x7b", False), ("llama4-scout-17b-a16e", False),
    ("gemma3-12b", False), ("gemma3-12b", True), ("minicpm3-4b", False),
    ("qwen2-vl-2b", False)])
def test_harness_batch_and_cache_shapes_match_jax(arch, split):
    """``batch_shapes`` / ``cache_shapes`` / ``token_shapes`` of the
    published CONFIG on every shape equal JAX's ``eval_shape``s (dtypes
    too), ``SkipCell`` where JAX skips; ``split`` turns on gemma3's split
    cache (the other archs have no local:global pattern)."""
    change = {"split_cache": True} if split else {}
    jcfg = dataclasses.replace(jconfigs.get_arch(arch).CONFIG, **change)
    tcfg = dataclasses.replace(tconfigs.get_arch(arch).CONFIG, **change)
    jh, th = JHarness(arch, cfg=jcfg), LMHarness(arch, cfg=tcfg)
    for name, shape in SHAPES.items():
        jshape = jconfigs.SHAPES[name]
        if name == "long_500k" and not tcfg.subquadratic:
            with pytest.raises(SkipCell):
                th.batch_shapes(shape)
            with pytest.raises(SkipCell):
                th.cache_shapes(shape)
            continue
        _same_tree_shapes(jh.batch_shapes(jshape), th.batch_shapes(shape))
        _same_tree_shapes(jh.cache_shapes(jshape), th.cache_shapes(shape))
        _same_tree_shapes(jh.token_shapes(jshape), th.token_shapes(shape))


def test_serve_refuses_the_embeddings_frontend(monkeypatch):
    """``launch.serve --arch qwen2-vl-2b`` exits with JAX's message: the
    token launcher serves token-frontend archs only."""
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "qwen2-vl-2b"])
    with pytest.raises(SystemExit) as jexit:
        jserve.main()
    with pytest.raises(SystemExit) as texit:
        tserve.main(["--arch", "qwen2-vl-2b", "--device", "cpu"])
    assert str(texit.value) == str(jexit.value)
    assert "needs a modality frontend" in str(texit.value)


@pytest.mark.parametrize("arch", ["gemma3-12b", "minicpm3-4b",
                                  "mixtral-8x7b"])
def test_serve_launcher_on_new_archs(arch):
    """The launcher serves each new token-frontend arch on the CPU."""
    out = tserve.main(["--device", "cpu", "--arch", arch, "--requests", "3",
                       "--max-new", "3"])
    assert out["total_tokens"] == 9
    assert all(0 <= int(t.min()) and int(t.max()) < 256
               for b in out["batches"] for t in b["tokens"])
