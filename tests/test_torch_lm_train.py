"""The LM train step of the port (``LMHarness.make_train_step``) and
rematerialisation against the JAX package, on REDUCED configs, float32,
on the CPU.

* One train step on a 1 x 1 mesh, B 4 x S 16, ``micro_rows`` 1 and 2
  (four and two microbatches), on JAX's params with every leaf JAX
  initialises to one constant (0 or 1) randomized in both packages,
  against ``jax.jit(JAX's make_train_step)``: the loss to rtol 1e-5
  (rwkv6 3e-5, as its forward), ``grad_norm`` to 1e-4, Adam's returned
  ``m`` and ``v`` within ``grads_close`` (rtol 1e-4 + atol 1e-4 x the
  leaf's max), the new params within Adam's first-step bound of that
  gradient tolerance (the first update is near ``-lr sign(g)``, so a
  tiny gradient apart by its tolerance may move by up to ``2 lr``). The
  attention family and whisper are here; zamba2 and rwkv6 are in
  ``tests/test_torch_lm_loop.py``.
* Remat (``tests/test_perf_variants.py::test_remat_policies_same_loss``
  on the port): under each of ``"nothing"``, ``"attn_out"`` and
  ``"dots"`` the loss and every gradient equal the run without remat,
  and the backward pass recomputes: ``"nothing"`` runs the forward's
  matrix products again, ``"dots"`` none of them.
* ``tests/test_models.py::test_arch_smoke_forward_and_grads`` on the
  port: every arch's REDUCED config in bf16, loss and gradients finite,
  some gradient nonzero, logits of (B, S, V).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.shapes import Shape as JShape  # noqa: E402
from repro.launch.steps import LMHarness as JHarness  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.shapes import Shape  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.steps import LMHarness  # noqa: E402
from repro_torch.tree import leaves, unflatten  # noqa: E402

# the attention family and whisper (zamba2 and rwkv6: the loop's file)
TRAIN_ARCHS = ["granite-3-2b", "granite-20b", "mixtral-8x7b",
               "llama4-scout-17b-a16e", "gemma3-12b", "minicpm3-4b",
               "qwen2-vl-2b", "whisper-large-v3"]
B, S = 4, 16
LOSS_RTOL = {"rwkv6-7b": 3e-5}   # rwkv6: its forward's tolerance
NORM_RTOL, GRAD_RTOL = 1e-4, 1e-4
LR = 1e-4                        # LMHarness's default lr
SMOKE = Shape("smoke", 32, 2, "train")
# XLA's LLVM backend at -O0: compiles JAX's train step 2-3x faster, the
# same float32 ops
FAST_XLA = {"xla_backend_optimization_level": 0}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The module on one torch thread, its module fixtures too (restored
    after): the suite runs several workers on the host's cores, and
    torch's OpenMP pool oversubscribed by them runs these small ops up to
    100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jit_compiled(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` at ``FAST_XLA``."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST_XLA)


# --------------------------------------------------------------------------
# helpers (tests/test_torch_lm_loop.py imports them)
# --------------------------------------------------------------------------
def randomized(tree, seed):
    """``tree`` (JAX arrays) with every leaf that is one constant, 0 or 1,
    replaced by that constant plus seeded normals of scale 0.1."""
    rng = np.random.default_rng(seed)

    def f(a):
        a32 = np.asarray(jnp.asarray(a).astype(jnp.float32))
        c = float(a32.flat[0])
        if c in (0.0, 1.0) and np.all(a32 == c):
            r = c + rng.normal(0, 0.1, a.shape)
            return jnp.asarray(r, jnp.float32).astype(a.dtype)
        return a

    return jax.tree.map(f, tree)


def f32_harnesses(arch, **fields):
    """(JAX harness, port harness) of ``arch``'s REDUCED config in
    float32."""
    jcfg = dataclasses.replace(jconfigs.get_arch(arch).REDUCED,
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_arch(arch).REDUCED,
                               dtype=torch.float32)
    return (JHarness(arch, cfg=jcfg, **fields),
            LMHarness(arch, cfg=tcfg, **fields))


def jax_params(jh, seed=0):
    """JAX's params of ``seed``, constant leaves randomized, and the
    port's copy of them."""
    jp = randomized(jh.model.init(jax.random.key(seed)), seed + 100)
    return jp, convert.lm_params(jax.tree.map(np.asarray, jp))


def train_batch(jh, seed, B=B, S=S):
    """numpy inputs of ``jh.batch_shapes``: tokens in [0, 100), float
    inputs of scale 0.1, M-RoPE ids that are positions plus 0..2."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in jh.batch_shapes(JShape("t", S, B, "train")).items():
        if s.dtype == jnp.int32:
            out[k] = rng.integers(0, 100, s.shape).astype(np.int32)
        else:
            out[k] = rng.normal(0, 0.1, s.shape).astype(np.float32)
    if "mrope_positions" in out:
        out["mrope_positions"] = (np.arange(S, dtype=np.int32)
                                  + rng.integers(0, 3, (3, B, S))
                                  ).astype(np.int32)
    return out


def grads_close(got, want, what):
    """|got - want| <= GRAD_RTOL (|want| + max |want|), leaf by leaf."""
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().numpy(), np.asarray(w)
        tol = GRAD_RTOL * (np.abs(w) + np.abs(w).max())
        assert np.all(np.abs(g - w) <= tol), (what, i,
                                              float(np.abs(g - w).max()))


def first_step_close(got, want, m, what):
    """Params after AdamW's first step from the same params: a gradient
    ``delta = GRAD_RTOL (|g| + max |g|)`` apart (``g = m / (1 - b1)``)
    moves ``lr g / (|g| + eps)`` by at most ``lr min(2, eps delta /
    (max(|g| - delta, 0) + eps)^2)``; plus a float32 rounding of the
    param."""
    for i, (a, b, mm) in enumerate(zip(got, want, m)):
        a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
        g = np.abs(np.asarray(mm, np.float64)) / 0.1
        delta = GRAD_RTOL * (g + g.max())
        bound = LR * np.minimum(2.0, 1e-8 * delta / (
            np.maximum(g - delta, 0.0) + 1e-8) ** 2) + 2.0 ** -23 * (
                1 + np.abs(b))
        assert np.all(np.abs(a - b) <= bound), (what, i)


def check_train_step_matches_jax(arch, micro_rows):
    jh, th = f32_harnesses(arch, micro_rows=micro_rows)
    jp, tp = jax_params(jh)
    batch = train_batch(jh, 1)
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                              ("data", "model"))
    jargs = (jp, jh.opt.init(jp),
             {k: jnp.asarray(v) for k, v in batch.items()})
    jp2, jo2, jm = jit_compiled(
        jh.make_train_step(JShape("t", S, B, "train"), jmesh), *jargs)(*jargs)
    mesh = make_host_mesh(devices=["cpu"])
    shape = Shape("t", S, B, "train")
    assert th.n_microbatches(shape, mesh) == B // micro_rows
    tp2, to2, tm = th.make_train_step(shape, mesh)(
        tp, th.opt.init(tp), batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=LOSS_RTOL.get(arch, 1e-5))
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=NORM_RTOL)
    grads_close(leaves(to2["m"]), jax.tree.leaves(jo2["m"]), "m")
    grads_close(leaves(to2["v"]), jax.tree.leaves(jo2["v"]), "v")
    first_step_close(leaves(tp2), jax.tree.leaves(jp2),
                     jax.tree.leaves(jo2["m"]), "params")
    assert int(to2["step"]) == 1


def loss_and_grads(model, params, batch, remat):
    live = [p.detach().requires_grad_() for p in leaves(params)]
    loss, _ = model.loss(unflatten(params, live), batch, remat=remat)
    return loss, torch.autograd.grad(loss, live, allow_unused=True)


def check_remat_equals_plain(arch, policy):
    """Loss and every gradient under ``remat=True`` equal the plain run's
    bit for bit (the recompute repeats the same float ops)."""
    jh, th = f32_harnesses(arch)
    model = tconfigs.get_arch(arch).build(dataclasses.replace(
        th.cfg, remat_policy=policy))
    params = model.init(prng.key(2), device="cpu")
    batch = train_batch(jh, 3, B=2)
    l0, g0 = loss_and_grads(model, params, batch, False)
    l1, g1 = loss_and_grads(model, params, batch, True)
    assert float(l0.detach()) == float(l1.detach())
    for a, b in zip(g0, g1):
        if a is None:
            assert b is None
        else:
            assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------
@pytest.mark.parametrize("micro_rows", [1, 2])
@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_matches_jax(arch, micro_rows):
    check_train_step_matches_jax(arch, micro_rows)


# --------------------------------------------------------------------------
# remat
# --------------------------------------------------------------------------
@pytest.mark.parametrize("policy", ["nothing", "attn_out", "dots"])
@pytest.mark.parametrize("arch", ["granite-3-2b", "mixtral-8x7b",
                                  "minicpm3-4b", "rwkv6-7b"])
def test_remat_policies_same_loss_and_grads(arch, policy):
    check_remat_equals_plain(arch, policy)


class _Count(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the aten ops run under it, by name."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.n[name] = self.n.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def test_remat_recomputes_in_the_backward_pass():
    """The backward pass of granite-3-2b under each policy: ``"nothing"``
    runs the layers' forward products again (all but each layer's last,
    ``w_down``, whose output the backward pass does not need: the
    recompute stops early), ``"attn_out"`` those but each layer's ``wo``
    (the attention output is kept), ``"dots"`` none of them (as many
    products as without remat) while it reruns the elementwise ops."""
    jh, th = f32_harnesses("granite-3-2b")
    params = th.model.init(prng.key(2), device="cpu")
    batch = train_batch(jh, 3, B=2)
    counts = {}
    for policy in (None, "nothing", "attn_out", "dots"):
        model = tconfigs.get_arch("granite-3-2b").build(dataclasses.replace(
            th.cfg, remat_policy=policy or "nothing"))
        live = [p.detach().requires_grad_() for p in leaves(params)]
        with _Count() as fwd:
            loss, _ = model.loss(unflatten(params, live), batch,
                                 remat=policy is not None)
        with _Count() as bwd:
            torch.autograd.grad(loss, live)
        dots = lambda c: c.n.get("mm", 0) + c.n.get("bmm", 0)  # noqa
        counts[policy] = (dots(fwd), dots(bwd), sum(bwd.n.values()))
    plain_fwd, plain_bwd, plain_ops = counts[None]
    # the unembedding is the one product outside the layers
    recomputed = plain_fwd - 1 - th.cfg.n_layers
    assert recomputed > 0
    assert counts["nothing"][1] == plain_bwd + recomputed
    assert counts["attn_out"][1] == plain_bwd + recomputed - th.cfg.n_layers
    assert counts["dots"][1] == plain_bwd
    assert counts["dots"][2] > plain_ops  # its elementwise ops rerun
    assert all(c[0] == plain_fwd for c in counts.values())


def test_remat_rejects_an_unknown_policy():
    _, th = f32_harnesses("granite-3-2b")
    model = tconfigs.get_arch("granite-3-2b").build(dataclasses.replace(
        th.cfg, remat_policy="everything"))
    params = model.init(prng.key(0), device="cpu")
    with pytest.raises(ValueError, match="remat policy"):
        model.loss(params, train_batch(f32_harnesses("granite-3-2b")[0], 0),
                   remat=True)


# --------------------------------------------------------------------------
# tests/test_models.py's smoke, on the port
# --------------------------------------------------------------------------
@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_arch_smoke_forward_and_grads(arch):
    rng = np.random.default_rng(0)
    h = LMHarness(arch, cfg=tconfigs.get_arch(arch).REDUCED)
    params = h.model.init(prng.key(0), device="cpu")
    batch = {}
    for k, s in h.batch_shapes(SMOKE).items():
        if s.dtype == torch.int32:
            batch[k] = torch.from_numpy(rng.integers(
                0, min(h.cfg.vocab_size, 100), s.shape).astype(np.int32))
        else:
            batch[k] = torch.from_numpy(rng.normal(
                0, 0.02, s.shape).astype(np.float32)).to(s.dtype)
    loss, grads = loss_and_grads(h.model, params, batch, False)
    assert np.isfinite(float(loss))
    grads = [g for g in grads if g is not None]
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert any(float(g.float().abs().sum()) > 0 for g in grads)
    logits, _ = h.model.forward(params, batch)
    Bt, St = batch["targets"].shape
    assert logits.shape == (Bt, St, h.cfg.vocab_size)
