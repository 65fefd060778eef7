"""The LM train step on a logical mesh, expert parallelism and the
context-parallel attention of the port against the JAX package on a mesh
of faked devices.

JAX runs its mesh on 8 faked CPU devices, which needs ``XLA_FLAGS`` set
before JAX starts: one subprocess (its environment scrubbed of ``JAX_*``
and ``XLA_*``, as ``tests/test_perf_variants.py`` runs its mesh) computes
every JAX result once and writes them to an ``.npz``; each case here
runs the port on a logical mesh of ``cpu`` of the same shape and holds
it to that file.

* ``LMHarness.make_train_step`` on ``(2, 2)`` and ``(4, 2)`` meshes
  (``n_micro`` 4 and 2 at B 8, microbatches strided across the data
  shards) and on ``(2, 2, 2)`` and ``(2, 2, 1)`` meshes with a ``pod``
  axis (the batch over ``(pod, data)``), float32, every constant leaf
  randomized: granite-3-2b, and mixtral-8x7b and llama4-scout with
  ``moe_ep`` off and on, at capacity factor 0.5 so capacity drops
  (token, expert) pairs in every microbatch (llama4-scout with
  ``moe_ep`` on the 4 x 2 and 2 x 2 x 1 meshes only). The loss to rtol
  1e-5, ``grad_norm`` to 1e-4, Adam's ``m`` and ``v`` within
  ``grads_close`` (rtol 1e-4 + atol 1e-4 x max), the new params within
  Adam's first-step bound of that gradient tolerance.
  With ``moe_ep`` each data row routes its own tokens under its own
  capacity, so the mesh changes the numbers and a wrong split or a wrong
  exchange shows; across pods the aux loss is pod 0's, its gradient the
  mean's over every pod's rows, as the twin's.
* ``moe_forward_ep`` alone on the capacity path (the same dropped pairs:
  a pair dropped on one side only moves its token's output by far more
  than 1e-5), and dropless against the dense dispatch at JAX's own
  tolerance (``tests/test_perf_variants.py``: rtol 2e-4, atol 2e-5).
* ``seq_parallel_attn``: the forward under JAX's context-parallel
  constraints on a ``(2, 2)`` mesh, 1e-5.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.shapes import Shape  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    LMMesh,
    make_host_mesh,
    use_mesh,
)
from repro_torch.launch.steps import LMHarness  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.tree import leaves, unflatten  # noqa: E402

from test_torch_lm_train import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 8, 16
CF = 0.5             # capacity factor of the MoE cases: drops in each
LOSS_RTOL, NORM_RTOL, GRAD_RTOL = 1e-5, 1e-4, 1e-4
LR = 1e-4            # LMHarness's lr: Adam's first step moves <= 2 lr
# (arch, moe_ep, mesh)
TRAIN_CASES = [
    ("granite-3-2b", False, (2, 2)), ("granite-3-2b", False, (4, 2)),
    ("mixtral-8x7b", False, (2, 2)), ("mixtral-8x7b", False, (4, 2)),
    ("mixtral-8x7b", True, (2, 2)), ("mixtral-8x7b", True, (4, 2)),
    ("llama4-scout-17b-a16e", True, (4, 2)),
    ("granite-3-2b", False, (2, 2, 1)),
    ("mixtral-8x7b", False, (2, 2, 2)), ("mixtral-8x7b", True, (2, 2, 2)),
    ("llama4-scout-17b-a16e", True, (2, 2, 1)),
]
EP_MESHES = [(2, 2), (4, 2), (2, 2, 2)]


def _tag(shape):
    return "x".join(map(str, shape))


def _host_mesh(shape):
    """The logical mesh of ``shape`` on ``cpu``: a leading ``pod`` axis on
    three entries."""
    return LMMesh(("pod", "data", "model")[-len(shape):], shape,
                  ("cpu",) * int(np.prod(shape)))

# runs under JAX with 8 faked devices; prints OK at the end
_JAX_SIDE = r"""
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.configs.shapes import Shape
from repro.distributed import partition as part
from repro.launch.steps import LMHarness
from repro.models import moe as moe_mod

B, S, CF = %(B)d, %(S)d, %(CF)r
TRAIN_CASES, EP_MESHES = %(TRAIN_CASES)r, %(EP_MESHES)r
FAST_XLA = {"xla_backend_optimization_level": 0}
out = {}


def mesh_of(shape):
    n = int(np.prod(shape))
    return jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                             ("pod", "data", "model")[-len(shape):])


def randomized(tree, seed):
    rng = np.random.default_rng(seed)

    def f(a):
        a32 = np.asarray(a, np.float32)
        c = float(a32.flat[0])
        if c in (0.0, 1.0) and np.all(a32 == c):
            return jnp.asarray(c + rng.normal(0, 0.1, a.shape), jnp.float32)
        return a
    return jax.tree.map(f, tree)


def cfg_of(arch, **change):
    cfg = dataclasses.replace(configs.get_arch(arch).REDUCED,
                              dtype=jnp.float32, **change)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=CF))
    return cfg


def put(prefix, tree):
    for i, leaf in enumerate(jax.tree.leaves(tree)):
        out[f"{prefix}/{i}"] = np.asarray(leaf)


rng = np.random.default_rng(0)
for arch, ep, shape in TRAIN_CASES:
    tag = f"train/{arch}/{ep}/" + "x".join(map(str, shape))
    mesh = mesh_of(shape)
    h = LMHarness(arch, cfg=cfg_of(arch, moe_ep=ep))
    params = randomized(h.model.init(jax.random.key(0)), 100)
    toks = rng.integers(1, 256, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    sh = Shape("mesh", S, B, "train")
    ins, outs, _ = h.shardings(sh, mesh, "train")
    args = (params, h.opt.init(params), batch)
    with mesh:
        step = jax.jit(h.make_train_step(sh, mesh), in_shardings=ins,
                       out_shardings=outs).lower(*args).compile(
                           compiler_options=FAST_XLA)
        p2, o2, metrics = step(*args)
    put(tag + "/params", params)
    put(tag + "/new", p2)
    put(tag + "/m", o2["m"])
    put(tag + "/v", o2["v"])
    for k, v in batch.items():
        out[f"{tag}/batch/{k}"] = v
    out[tag + "/loss"] = np.asarray(metrics["loss"])
    out[tag + "/grad_norm"] = np.asarray(metrics["grad_norm"])
    out[tag + "/n_micro"] = np.asarray(h.n_microbatches(sh, mesh))

cfg = cfg_of("mixtral-8x7b")
p = randomized(moe_mod.init_moe(jax.random.key(3), cfg), 103)
put("ep/params", p)
x = jnp.asarray(rng.normal(0, 0.5, (B, S, cfg.d_model)), jnp.float32)
out["ep/x"] = np.asarray(x)
for shape in EP_MESHES:
    mesh = mesh_of(shape)
    with mesh:
        xs = jax.device_put(x, jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(mesh.axis_names[:-1])))
        y, aux = jax.jit(lambda p, x: moe_mod.moe_forward_ep(p, x, cfg)).lower(
            p, xs).compile(compiler_options=FAST_XLA)(p, xs)
    out["ep/" + "x".join(map(str, shape)) + "/out"] = np.asarray(y)
    out["ep/" + "x".join(map(str, shape)) + "/aux"] = np.asarray(aux)

arch = "llama4-scout-17b-a16e"
mesh = mesh_of((2, 2))
m = configs.get_arch(arch).build(cfg_of(arch, seq_parallel_attn=True))
params = randomized(m.init(jax.random.key(4)), 104)
toks = rng.integers(1, 256, (4, S)).astype(np.int32)
with mesh, part.activation_sharding(("data",), 4, mesh):
    logits, _ = jax.jit(m.forward).lower(params, {"tokens": toks}).compile(
        compiler_options=FAST_XLA)(params, {"tokens": toks})
put("sp/params", params)
out["sp/tokens"] = toks
out["sp/logits"] = np.asarray(logits)

np.savez(sys.argv[1], **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """Every JAX result of this file, from one subprocess on 8 faked
    devices (the environment scrubbed, then pinned to CPU and 8 devices;
    a run killed by a signal is retried once)."""
    path = str(tmp_path_factory.mktemp("jax_mesh") / "jax.npz")
    code = _JAX_SIDE % {"B": B, "S": S, "CF": CF,
                        "TRAIN_CASES": TRAIN_CASES, "EP_MESHES": EP_MESHES}
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env.update(PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    for _ in range(2):
        proc = subprocess.run([sys.executable, "-c", code, path], env=env,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode >= 0:
            break
    assert proc.returncode == 0 and "OK" in proc.stdout, (
        f"rc={proc.returncode}\n{proc.stderr[-3000:]}")
    with np.load(path) as f:
        return dict(f)


def _cfg(arch, **change):
    cfg = dataclasses.replace(tconfigs.get_arch(arch).REDUCED,
                              dtype=torch.float32, **change)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=CF))
    return cfg


def _tree(like, jax_side, prefix):
    """``like``'s structure holding the JAX leaves saved under ``prefix``
    (the same flatten order)."""
    n = len(leaves(like))
    return unflatten(like, [torch.from_numpy(jax_side[f"{prefix}/{i}"])
                            for i in range(n)])


def grads_close(got, want, what):
    """|got - want| <= GRAD_RTOL (|want| + max |want|), leaf by leaf."""
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().numpy(), np.asarray(w)
        tol = GRAD_RTOL * (np.abs(w) + np.abs(w).max())
        assert np.all(np.abs(g - w) <= tol), (what, i)


def first_step_close(got, want, m, what):
    """Params after Adam's first step from the same params: a gradient
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


@pytest.fixture
def drops(monkeypatch):
    """Counts the (token, expert) pairs the port's dispatch drops."""
    seen = []

    def counting(gate_idx, E, C):
        res = real(gate_idx, E, C)
        seen.append(int((~res[3]).sum()))
        return res

    real = tmoe.dispatch
    monkeypatch.setattr(tmoe, "dispatch", counting)
    return seen


@pytest.mark.parametrize("arch,ep,shape", TRAIN_CASES)
def test_mesh_train_step_matches_jax(jax_side, drops, arch, ep, shape):
    tag = f"train/{arch}/{ep}/{_tag(shape)}"
    h = LMHarness(arch, cfg=_cfg(arch, moe_ep=ep))
    mesh = _host_mesh(shape)
    assert mesh.physical_devices == (torch.device("cpu"),)
    sh = Shape("mesh", S, B, "train")
    assert h.n_microbatches(sh, mesh) == int(jax_side[tag + "/n_micro"])
    like = h.model.init(0, device="cpu")
    params = _tree(like, jax_side, tag + "/params")
    batch = {k: jax_side[f"{tag}/batch/{k}"] for k in ("tokens", "targets")}
    new, opt, metrics = h.make_train_step(sh, mesh)(
        params, h.opt.init(params), batch)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(jax_side[tag + "/loss"]),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(jax_side[tag + "/grad_norm"]),
                               rtol=NORM_RTOL)
    n = len(leaves(like))
    want = {k: [jax_side[f"{tag}/{k}/{i}"] for i in range(n)]
            for k in ("m", "v", "new")}
    grads_close(leaves(opt["m"]), want["m"], "m")
    grads_close(leaves(opt["v"]), want["v"], "v")
    first_step_close(leaves(new), want["new"], want["m"], "params")
    if h.cfg.moe is not None:
        assert sum(drops) > 0, "capacity dropped no pair"


def test_moe_ep_routes_each_data_row_alone(jax_side):
    """With ``moe_ep`` a data row routes its own tokens under its own
    capacity, so on a mesh of several rows a microbatch drops other pairs
    than the dense dispatch over the whole microbatch (JAX's losses
    differ); on a 1 x 1 mesh, one row a microbatch, the two agree."""
    for shape in EP_MESHES:
        tag = _tag(shape)
        assert abs(float(jax_side[f"train/mixtral-8x7b/True/{tag}/loss"])
                   - float(jax_side[f"train/mixtral-8x7b/False/{tag}/loss"])
                   ) > 1e-4
    tag = "train/mixtral-8x7b/True/4x2"
    mesh = make_host_mesh(devices=["cpu"])
    losses = []
    for ep in (False, True):
        h = LMHarness("mixtral-8x7b", cfg=_cfg("mixtral-8x7b", moe_ep=ep))
        params = _tree(h.model.init(0, device="cpu"), jax_side,
                       tag + "/params")
        batch = {k: jax_side[f"{tag}/batch/{k}"]
                 for k in ("tokens", "targets")}
        _, _, m = h.make_train_step(Shape("mesh", S, B, "train"), mesh)(
            params, h.opt.init(params), batch)
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1]


@pytest.mark.parametrize("shape", EP_MESHES)
def test_moe_forward_ep_capacity_matches_jax(jax_side, drops, shape):
    cfg = _cfg("mixtral-8x7b")
    like = tmoe.init_moe(prng.key(0), cfg, device="cpu")
    p = _tree(like, jax_side, "ep/params")
    x = torch.from_numpy(jax_side["ep/x"])
    mesh = _host_mesh(shape)
    with use_mesh(mesh):
        y, aux = tmoe.moe_forward_ep(p, x, cfg)
    tag = f"ep/{_tag(shape)}"
    np.testing.assert_allclose(y.numpy(), jax_side[tag + "/out"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jax_side[tag + "/aux"]),
                               rtol=1e-6)
    # one route a batch-shard row: pod x data of them
    assert len(drops) == int(np.prod(shape[:-1])) and sum(drops) > 0


@pytest.mark.parametrize("arch,shape", [("mixtral-8x7b", (4, 2)),
                                        ("mixtral-8x7b", (2, 2)),
                                        ("llama4-scout-17b-a16e", (4, 2))])
def test_moe_forward_ep_dropless_matches_dense(arch, shape):
    """``tests/test_perf_variants.py::test_moe_ep_matches_dense_dispatch``
    on the port: dropless, expert parallelism == the dense dispatch."""
    cfg = dataclasses.replace(tconfigs.get_arch(arch).REDUCED,
                              dtype=torch.float32)
    p = tmoe.init_moe(prng.key(0), cfg, device="cpu")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 0.5, (4, 16, cfg.d_model)).astype(
        np.float32))
    d_out, _ = tmoe.moe_forward(p, x, cfg, dropless=True)
    mesh = make_host_mesh(data=shape[0], model=shape[1], devices=["cpu"])
    with use_mesh(mesh):
        e_out, _ = tmoe.moe_forward_ep(p, x, cfg, dropless=True)
    np.testing.assert_allclose(e_out.numpy(), d_out.numpy(), rtol=2e-4,
                               atol=2e-5)


def test_seq_parallel_attn_forward_matches_jax(jax_side):
    arch = "llama4-scout-17b-a16e"
    model = tconfigs.get_arch(arch).build(_cfg(arch, seq_parallel_attn=True))
    params = _tree(model.init(0, device="cpu"), jax_side, "sp/params")
    mesh = make_host_mesh(data=2, model=2, devices=["cpu"])
    with use_mesh(mesh):
        logits, _ = model.forward(params, {"tokens": jax_side["sp/tokens"]})
    np.testing.assert_allclose(logits.detach().numpy(),
                               jax_side["sp/logits"], rtol=1e-5, atol=1e-5)
