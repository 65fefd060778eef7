"""The LM train step across ranks (one process a device, on a process
group) against the JAX package's step on a mesh of faked devices and
against the port's one-process logical mesh of the same shape.

One module fixture draws every input with numpy from a seed (params of
granite-3-2b, mixtral-8x7b and llama4-scout at REDUCED width in float32,
every leaf random, and one batch), writes them to an ``.npz`` and starts
two runs side by side, each with a timeout:

* one subprocess runs JAX's ``make_train_step`` (``jax.jit`` with the
  partitioner's shardings) on 4 faked CPU devices, its environment
  scrubbed of ``JAX_*`` and ``XLA_*`` as ``tests/test_torch_lm_mesh.py``
  runs its mesh, over the meshes ``(2, 2)``, ``(4, 1)`` and ``(1, 4)``;
* one launch of 4 gloo ranks (a ``FileStore`` under a temporary
  directory: xdist workers never collide on a port; one torch thread a
  rank) runs the port's rank step on the same cases, gathers the new
  params and Adam's moments to rank 0 and records every rank's local
  shapes and collective counts.

Cases: granite-3-2b, and mixtral-8x7b and llama4-scout with ``moe_ep``
off and on, at capacity factor 0.5 so capacity drops pairs. Each is held
to JAX and, separately, to the port's logical mesh (run here), at
``tests/test_torch_lm_mesh.py``'s tolerances: the loss to rtol 1e-5,
``grad_norm`` to 1e-4, ``m`` / ``v`` within ``grads_close``, the new
params within Adam's first-step bound. Besides: every local shape is the
shard's (params, moments and the float32 accumulator; twin of
``NamedSharding.shard_shape`` on an abstract JAX mesh up to ``(16,
16)``), shard then gather is the identity, the sharded init is the
cut of the whole draw, ``launch.train --ranks``
resumed equals the uninterrupted run bit for bit, a failing rank ends
the launcher nonzero, and what is not ported across ranks raises naming
ROADMAP item 12e-ii. A third subprocess runs the dry-run
(``repro_torch.launch.dryrun.run_cell``: rank 0's step on fake tensors
under the fake process group) of every case; its collective calls and
bytes by kind and its dot FLOPs equal what the ranks counted.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs.shapes import Shape as JShape  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.shapes import Shape  # noqa: E402
from repro_torch.distributed import partition as tpart  # noqa: E402
from repro_torch.distributed import process_group as pg  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.steps import LMHarness  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.tree import flatten_with_paths, leaves, unflatten  # noqa

from test_torch_lm_train import (  # noqa: E402,F401
    first_step_close,
    grads_close,
    one_torch_thread,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S = 8, 16
CF = 0.5                 # the MoE cases' capacity factor: drops in each
LOSS_RTOL, NORM_RTOL = 1e-5, 1e-4
MESHES = [(2, 2), (4, 1), (1, 4)]
ARCHS = ["granite-3-2b", "mixtral-8x7b", "llama4-scout-17b-a16e"]
CASES = [(arch, ep, mesh) for mesh in MESHES for arch, ep in (
    ("granite-3-2b", False), ("mixtral-8x7b", False), ("mixtral-8x7b", True),
    ("llama4-scout-17b-a16e", False), ("llama4-scout-17b-a16e", True))]
TIMEOUT = 600            # seconds a launch may take before it fails


def _tag(arch, ep, mesh):
    return f"{arch}/{ep}/{mesh[0]}x{mesh[1]}"


# runs under JAX with 4 faked devices; prints OK at the end
_JAX_SIDE = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.configs.shapes import Shape
from repro.launch.steps import LMHarness

inp = dict(np.load(sys.argv[1]))
B, S, CF = %(B)d, %(S)d, %(CF)r
FAST_XLA = {"xla_backend_optimization_level": 0}
out = {}
for arch, ep, shape in json.loads(sys.argv[3]):
    tag = f"{arch}/{ep}/{shape[0]}x{shape[1]}"
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(shape),
                             ("data", "model"))
    cfg = dataclasses.replace(configs.get_arch(arch).REDUCED,
                              dtype=jnp.float32, moe_ep=ep)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=CF))
    h = LMHarness(arch, cfg=cfg)
    like, tdef = jax.tree.flatten(h.param_shapes())
    params = jax.tree.unflatten(tdef, [jnp.asarray(inp[f"params/{arch}/{i}"])
                                       for i in range(len(like))])
    batch = {"tokens": inp["tokens"], "targets": inp["targets"]}
    sh = Shape("ranks", S, B, "train")
    ins, outs, _ = h.shardings(sh, mesh, "train")
    args = (params, h.opt.init(params), batch)
    with mesh:
        step = jax.jit(h.make_train_step(sh, mesh), in_shardings=ins,
                       out_shardings=outs).lower(*args).compile(
                           compiler_options=FAST_XLA)
        p2, o2, metrics = step(*args)
    for key, tree in (("new", p2), ("m", o2["m"]), ("v", o2["v"])):
        for i, leaf in enumerate(jax.tree.leaves(tree)):
            out[f"{tag}/{key}/{i}"] = np.asarray(leaf)
    out[tag + "/loss"] = np.asarray(metrics["loss"])
    out[tag + "/grad_norm"] = np.asarray(metrics["grad_norm"])
    out[tag + "/n_micro"] = np.asarray(h.n_microbatches(sh, mesh))
np.savez(sys.argv[2], **out)
print("OK")
"""

# one rank of the port's run (argv: rank, init method, inputs, out dir,
# cases); rank 0 writes the gathered results, every rank its shapes
_RANK_SIDE = r"""
import dataclasses, json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch import configs, convert
from repro_torch.configs.shapes import Shape
from repro_torch.distributed import process_group as pg
from repro_torch.launch import steps as tsteps
from repro_torch.launch.mesh import make_rank_mesh
from repro_torch.launch.steps import LMHarness
from repro_torch.tree import leaves, unflatten
from torch.utils.flop_counter import FlopCounterMode

acc_shapes = []     # the float32 accumulator's shapes, one entry a step
_accumulate = tsteps._accumulate


def _recording(*a, **k):
    gsum, lsum = _accumulate(*a, **k)
    acc_shapes.append([list(g.shape) for g in gsum])
    return gsum, lsum


tsteps._accumulate = _recording

rank, init, inputs, outdir = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                              sys.argv[4])
B, S, CF = %(B)d, %(S)d, %(CF)r
inp = dict(np.load(inputs))
batch = {"tokens": inp["tokens"], "targets": inp["targets"]}
groups = {}
groups[(2, 2)] = pg.init_ranks(("data", "model"), (2, 2), rank=rank,
                               init_method=init, device="cpu",
                               timeout_s=%(TIMEOUT)d)
out, shapes = {}, {}
for arch, ep, shape in json.loads(sys.argv[5]):
    shape = tuple(shape)
    tag = f"{arch}/{ep}/{shape[0]}x{shape[1]}"
    if shape not in groups:
        groups[shape] = pg.mesh_groups(("data", "model"), shape, "cpu",
                                       timeout_s=%(TIMEOUT)d)
    g = groups[shape]
    mesh = make_rank_mesh(g)
    cfg = dataclasses.replace(configs.get_arch(arch).REDUCED,
                              dtype=torch.float32, moe_ep=ep)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=CF))
    h = LMHarness(arch, cfg=cfg)
    sh = Shape("ranks", S, B, "train")
    (p_shard, _, _), _, _ = h.shardings(sh, mesh, "train")
    like = h.param_shapes()
    tree = unflatten(like, [inp[f"params/{arch}/{i}"]
                            for i in range(len(leaves(like)))])
    params = convert.lm_rank_params(tree, p_shard, rank)
    step = h.make_train_step(sh, mesh)
    pg.reset_bytes()
    acc_shapes.clear()
    with FlopCounterMode(display=False) as flops:
        new, opt, metrics = step(params, h.opt.init(params), batch)
    calls = dict(pg.CALLS)
    shapes[tag] = {
        "params": [list(x.shape) for x in leaves(new)],
        "m": [list(x.shape) for x in leaves(opt["m"])],
        "v": [list(x.shape) for x in leaves(opt["v"])],
        "acc": acc_shapes[-1],
        "calls": calls,
        "bytes": dict(pg.BYTES),
        "dot_flops": flops.get_total_flops(),
        "loss": float(metrics["loss"]),
        "grad_norm": float(metrics["grad_norm"]),
    }
    full = pg.gather_tree({"new": new, "m": opt["m"], "v": opt["v"]},
                          {"new": p_shard, "m": p_shard, "v": p_shard}, g)
    if rank == 0:
        for key in ("new", "m", "v"):
            for i, leaf in enumerate(leaves(full[key])):
                out[f"{tag}/{key}/{i}"] = leaf.numpy()
        out[tag + "/loss"] = np.asarray(float(metrics["loss"]))
        out[tag + "/grad_norm"] = np.asarray(float(metrics["grad_norm"]))
with open(os.path.join(outdir, f"shapes_{rank}.json"), "w") as f:
    json.dump(shapes, f)
if rank == 0:
    np.savez(os.path.join(outdir, "ranks.npz"), **out)
pg.shutdown()
print("OK")
"""


# the dry-run of every case (argv: cases, out file): rank 0's step on fake
# tensors under the fake process group of the case's mesh
_DRYRUN_SIDE = r"""
import dataclasses, json, sys
import torch
torch.set_num_threads(1)
from repro_torch import configs
from repro_torch.configs.shapes import Shape
from repro_torch.launch import dryrun

B, S, CF = %(B)d, %(S)d, %(CF)r
out = {}
for arch, ep, shape in json.loads(sys.argv[1]):
    cfg = dataclasses.replace(configs.get_arch(arch).REDUCED,
                              dtype=torch.float32, moe_ep=ep)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=CF))
    out[f"{arch}/{ep}/{shape[0]}x{shape[1]}"] = dryrun.run_cell(
        arch, Shape("ranks", S, B, "train"), mesh=tuple(shape), cfg=cfg,
        device="cpu", verbose=False)
with open(sys.argv[2], "w") as f:
    json.dump(out, f)
print("OK")
"""


def _cfg(arch, **change):
    cfg = dataclasses.replace(tconfigs.get_arch(arch).REDUCED,
                              dtype=torch.float32, **change)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=CF))
    return cfg


def _params_np(arch, seed):
    """Every leaf random: norm scales 0.1 N(0, 1), the rest N(0, 1) over
    the square root of the fan-in (the second-to-last dim)."""
    rng = np.random.default_rng(seed)
    out = []
    for path, t in flatten_with_paths(LMHarness(arch, cfg=_cfg(arch))
                                      .param_shapes()):
        shape = tuple(t.shape)
        if "norm" in "/".join(map(str, path)) or len(shape) < 2:
            out.append(rng.normal(0, 0.1, shape))
        else:
            out.append(rng.normal(0, 1, shape) / np.sqrt(shape[-2]))
    return [a.astype(np.float32) for a in out]


def _clean_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env.update(PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1", **extra)
    return env


def _launch_cmd(*args):
    return [sys.executable, "-m", "repro_torch.launch.train", "--device",
            "cpu", "--ranks", "--mesh", "2x2", "--batch", "4", "--seq", "8",
            "--log-every", "1", *args]


RESUME = ["--steps", "4", "--checkpoint-every", "2"]


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """The launcher's runs that need no other's result, started at once
    and each waited for, with a timeout, by its tests: uninterrupted, and
    cut at step 3 by rank 0 alone raising (``--fail-rank 0``: the writer
    waits for its last checkpoint first; the other ranks wait in a
    collective until the launcher ends them)."""
    tmp = tmp_path_factory.mktemp("launch")

    def start(*args):
        return subprocess.Popen(_launch_cmd(*args), env=_clean_env(),
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, cwd=tmp)

    procs = {
        "whole": start(*RESUME, "--checkpoint-dir", str(tmp / "a")),
        "cut": start(*RESUME, "--checkpoint-dir", str(tmp / "b"),
                     "--fail-at-step", "3", "--fail-rank", "0"),
    }
    procs = {k: (p, []) for k, p in procs.items()}
    yield tmp, procs
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _wait(proc, timeout=TIMEOUT):
    """``(returncode, stdout, stderr)`` of ``proc`` (or of a fixture's
    ``(proc, memo)``, read once and kept); a hang kills it and fails the
    test."""
    proc, memo = proc if isinstance(proc, tuple) else (proc, [])
    if memo:
        return memo[0]
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        pytest.fail(f"hung past {timeout} s\n{err[-3000:]}")
    memo.append((proc.returncode, out, err))
    return memo[0]


def _finish(proc, what):
    rc, out, err = _wait(proc)
    assert rc == 0 and "OK" in out, f"{what}: rc={rc}\n{err[-3000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory, launches):
    """JAX's results (one subprocess a mesh) and the ranks' (one launch of
    4), all side by side with the launcher's runs."""
    tmp = tmp_path_factory.mktemp("ranks")
    inputs = str(tmp / "inputs.npz")
    rng = np.random.default_rng(7)
    toks = rng.integers(1, 256, (B, S + 1)).astype(np.int32)
    arrays = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    for n, arch in enumerate(ARCHS):
        for i, a in enumerate(_params_np(arch, 100 + n)):
            arrays[f"params/{arch}/{i}"] = a
    np.savez(inputs, **arrays)
    subs = {"B": B, "S": S, "CF": CF, "TIMEOUT": TIMEOUT}
    jax_env = _clean_env(
        XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_procs = [subprocess.Popen(
        [sys.executable, "-c", _JAX_SIDE % subs, inputs,
         str(tmp / f"jax_{i}.npz"),
         json.dumps([c for c in CASES if c[2] == mesh])], text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=jax_env)
        for i, mesh in enumerate(MESHES)]
    init = pg.file_init_method(str(tmp))
    ranks = [subprocess.Popen(
        [sys.executable, "-c", _RANK_SIDE % subs, str(r), init, inputs,
         str(tmp), json.dumps(CASES)], text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, env=_clean_env()) for r in range(4)]
    dry = subprocess.Popen(
        [sys.executable, "-c", _DRYRUN_SIDE % subs, json.dumps(CASES),
         str(tmp / "dryrun.json")], text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, env=_clean_env())
    try:
        for r, proc in enumerate(ranks):
            _finish(proc, f"rank {r}")
        for i, proc in enumerate(jax_procs):
            _finish(proc, f"the JAX side on {MESHES[i]}")
        _finish(dry, "the dry-run")
    finally:
        for proc in ranks + jax_procs + [dry]:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    jax_out = {}
    for i in range(len(MESHES)):
        with np.load(tmp / f"jax_{i}.npz") as f:
            jax_out.update(f)
    with np.load(tmp / "ranks.npz") as f:
        rank_out = dict(f)
    shapes = []
    for r in range(4):
        with open(tmp / f"shapes_{r}.json") as f:
            shapes.append(json.load(f))
    with open(tmp / "dryrun.json") as f:
        dryrun = json.load(f)
    return {"inputs": dict(np.load(inputs)), "jax": jax_out,
            "ranks": rank_out, "shapes": shapes, "dryrun": dryrun}


def _check(got, want, tag, n):
    np.testing.assert_allclose(float(got[tag + "/loss"]),
                               float(want[tag + "/loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(got[tag + "/grad_norm"]),
                               float(want[tag + "/grad_norm"]),
                               rtol=NORM_RTOL)
    w = {k: [want[f"{tag}/{k}/{i}"] for i in range(n)]
         for k in ("m", "v", "new")}
    g = {k: [torch.from_numpy(np.asarray(got[f"{tag}/{k}/{i}"]))
             for i in range(n)] for k in ("m", "v", "new")}
    grads_close(g["m"], w["m"], "m")
    grads_close(g["v"], w["v"], "v")
    first_step_close(g["new"], w["new"], w["m"], "params")


def _n_leaves(arch):
    return len(leaves(LMHarness(arch, cfg=_cfg(arch)).param_shapes()))


@pytest.mark.parametrize("arch,ep,mesh", CASES)
def test_ranks_match_jax(runs, arch, ep, mesh):
    """4 gloo ranks == JAX's ``make_train_step`` on 4 faked devices."""
    tag = _tag(arch, ep, mesh)
    _check(runs["ranks"], runs["jax"], tag, _n_leaves(arch))


@pytest.mark.parametrize("arch,ep,mesh", CASES)
def test_dryrun_counts_what_the_ranks_did(runs, arch, ep, mesh):
    """The dry-run of the same cut, mesh and batch (rank 0's step on fake
    tensors under the fake process group) issues the collectives the 4
    gloo ranks issued, call for call and byte for byte by kind
    (``process_group.CALLS`` / ``BYTES``), and counts rank 0's dot FLOPs
    (``FlopCounterMode``) exactly."""
    tag = _tag(arch, ep, mesh)
    rec = runs["dryrun"][tag]
    assert rec["status"] == "ok", rec.get("traceback")
    got = runs["shapes"][0][tag]
    col = rec["collectives"]
    assert {k.replace("-", "_"): v for k, v in col["counts"].items()} == \
        got["calls"]
    assert {k.replace("-", "_"): v for k, v in
            col["buffer_bytes_by_kind"].items()} == got["bytes"]
    assert rec["cost"]["dot_flops"] == got["dot_flops"]
    # the twin's convention differs in the reduce-scatter alone
    for kind, b in col["bytes_by_kind"].items():
        if kind != "reduce-scatter":
            assert b == col["buffer_bytes_by_kind"][kind], (tag, kind)


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


@pytest.mark.parametrize("arch,ep,mesh", CASES)
def test_ranks_match_the_logical_mesh(runs, drops, arch, ep, mesh):
    """4 gloo ranks == the port's one-process logical mesh of the same
    shape (``cpu``), whose MoE cases drop pairs."""
    tag = _tag(arch, ep, mesh)
    h = LMHarness(arch, cfg=_cfg(arch, moe_ep=ep))
    like = h.param_shapes()
    n = len(leaves(like))
    inp = runs["inputs"]
    params = convert.lm_params(unflatten(like, [
        inp[f"params/{arch}/{i}"] for i in range(n)]))
    lmesh = tmesh.make_host_mesh(data=mesh[0], model=mesh[1],
                                 devices=["cpu"])
    sh = Shape("ranks", S, B, "train")
    assert h.n_microbatches(sh, lmesh) == int(runs["jax"][tag + "/n_micro"])
    new, opt, metrics = h.make_train_step(sh, lmesh)(
        params, h.opt.init(params),
        {k: inp[k] for k in ("tokens", "targets")})
    want = {tag + "/loss": np.asarray(float(metrics["loss"])),
            tag + "/grad_norm": np.asarray(float(metrics["grad_norm"]))}
    for key, tree in (("new", new), ("m", opt["m"]), ("v", opt["v"])):
        for i, leaf in enumerate(leaves(tree)):
            want[f"{tag}/{key}/{i}"] = leaf.numpy()
    _check(runs["ranks"], want, tag, n)
    if h.cfg.moe is not None:
        assert sum(drops) > 0, "capacity dropped no pair"


@pytest.mark.parametrize("mesh", MESHES)
def test_no_rank_holds_a_full_sharded_leaf(runs, mesh):
    """On every rank the params, Adam's moments and the float32
    accumulator have the shard's shape (a leaf the mesh shards is never
    whole), the step's loss and norm agree across ranks, and the
    gradient is reduce-scattered each microbatch where ``data`` > 1."""
    for arch, ep, m in CASES:
        if m != mesh:
            continue
        tag = _tag(arch, ep, mesh)
        h = LMHarness(arch, cfg=_cfg(arch, moe_ep=ep))
        lm = tmesh.LMMesh(("data", "model"), mesh)
        shard = leaves(tpart.params_partition(h.param_shapes(), lm,
                                              h.rules(lm)))
        full = [tuple(t.shape) for t in leaves(h.param_shapes())]
        want = [list(tpart.shard_shape(s, f)) for s, f in zip(shard, full)]
        assert any(list(f) != w for f, w in zip(full, want)), tag
        for r in range(4):
            got = runs["shapes"][r][tag]
            for key in ("params", "m", "v", "acc"):
                assert got[key] == want, (tag, r, key)
            assert got["loss"] == runs["shapes"][0][tag]["loss"]
            assert got["grad_norm"] == runs["shapes"][0][tag]["grad_norm"]
            n_micro = int(runs["jax"][tag + "/n_micro"])
            rs = got["calls"].get("reduce_scatter", 0)
            assert rs % n_micro == 0 and (rs > 0 or mesh[0] == 1), (tag,
                                                                     rs)


def _abstract(shape):
    names = ("data", "model")
    return (jax.sharding.AbstractMesh(shape, names),
            tmesh.LMMesh(names, shape))


@pytest.mark.parametrize("mesh", MESHES + [(16, 16)])
@pytest.mark.parametrize("arch", ["granite-3-2b", "mixtral-8x7b"])
def test_shard_shapes_match_jax(arch, mesh):
    """Every param and optimizer leaf's local shape == JAX's
    ``NamedSharding(mesh, spec).shard_shape`` at CONFIG width."""
    jm, tm = _abstract(mesh)
    sh = JShape("t", 128, 256, "train")
    jins, _, jargs = jsteps.LMHarness(arch).shardings(sh, jm, "train")
    tins, _, targs = LMHarness(arch).shardings(
        Shape("t", 128, 256, "train"), tm, "train")
    for k in (0, 1):   # params, opt state
        jl = jax.tree.leaves(jins[k], is_leaf=lambda x: isinstance(
            x, jax.sharding.NamedSharding))
        jshapes = [s.shape for s in jax.tree.leaves(jargs[k])]
        tl, tshapes = leaves(tins[k]), [t.shape for t in leaves(targs[k])]
        assert len(jl) == len(tl)
        for js, jshape, ts, tshape in zip(jl, jshapes, tl, tshapes):
            assert tuple(jshape) == tuple(tshape)
            assert tpart.shard_shape(ts, tshape) == tuple(
                js.shard_shape(tuple(jshape)))


@pytest.mark.parametrize("mesh", MESHES + [(16, 16)])
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_then_gather_is_the_identity(arch, mesh):
    """``convert.lm_rank_params`` for every rank, then
    ``convert.lm_params_of_ranks``, gives the tree back exactly; each
    rank's shard is a block of the shard shape."""
    h = LMHarness(arch, cfg=_cfg(arch))
    lm = tmesh.LMMesh(("data", "model"), mesh)
    shard = tpart.params_partition(h.param_shapes(), lm, h.rules(lm))
    tree = unflatten(h.param_shapes(), _params_np(arch, 0))
    per_rank = [convert.lm_rank_params(tree, shard, r)
                for r in range(lm.size)]
    for r in (0, lm.size - 1):
        for x, s, f in zip(leaves(per_rank[r]), leaves(shard),
                           leaves(tree)):
            assert tuple(x.shape) == tpart.shard_shape(s, f.shape)
    back = convert.lm_params_of_ranks(per_rank, shard)
    for a, b in zip(leaves(back), leaves(tree)):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_init_is_the_cut_of_the_whole_draw(arch, mesh):
    """``DecoderLM.init(shard=(shardings, rank))``, which cuts each layer
    as it is drawn, gives every rank exactly its shards of the whole
    draw."""
    h = LMHarness(arch, cfg=_cfg(arch))
    lm = tmesh.LMMesh(("data", "model"), mesh)
    shard = tpart.params_partition(h.param_shapes(), lm, h.rules(lm))
    whole = h.model.init(0, device="cpu")
    for r in (0, lm.size - 1):
        got = h.model.init(0, device="cpu", shard=(shard, r))
        for x, s, f in zip(leaves(got), leaves(shard), leaves(whole)):
            assert torch.equal(x, tpart.local_shard(f, s, r))


def test_launcher_resume_equals_the_uninterrupted_run(launches):
    """``launch.train --ranks --mesh 2x2``: killed by ``--fail-at-step``
    and run again, its final checkpoint (gathered to rank 0, the
    one-process layout) equals the uninterrupted run's bit for bit, and
    the one-process launcher resumes from it."""
    tmp, procs = launches
    rc, _, err = _wait(procs["whole"])
    assert rc == 0, err[-3000:]
    rc, _, err = _wait(procs["cut"])
    assert rc != 0 and "simulated preemption" in err

    def start(*cmd):
        return subprocess.Popen(list(cmd), env=_clean_env(), text=True,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, cwd=tmp)

    # the ranks resume "b"; the one-process launcher resumes "a" beside it
    again = start(*_launch_cmd(*RESUME, "--checkpoint-dir", str(tmp / "b")))
    one = start(sys.executable, "-m", "repro_torch.launch.train",
                "--device", "cpu", "--batch", "4", "--seq", "8", "--steps",
                "5", "--checkpoint-dir", str(tmp / "a"))
    rc, out, err = _wait(again)
    assert rc == 0, err[-3000:]
    assert "resumed from checkpoint step 2" in out
    rc, out, err = _wait(one)
    assert rc == 0 and "resumed from checkpoint step 4" in out, err[-3000:]
    from repro_torch import checkpoint as ckpt

    a, _ = ckpt.load(str(tmp / "a"), 4)
    b, _ = ckpt.load(str(tmp / "b"), 4)
    assert sorted(a) == sorted(b) and any(k.startswith("opt/m") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # the one-process layout: the full shapes of the params
    h = LMHarness("granite-3-2b", cfg=tconfigs.get_arch(
        "granite-3-2b").REDUCED)
    for path, t in flatten_with_paths(h.param_shapes()):
        key = "params/" + "/".join(map(str, path))
        assert tuple(a[key].shape) == tuple(t.shape), key


def test_a_failing_rank_ends_the_launcher(launches):
    """Rank 0 alone raises at step 3; the others, in a collective with
    it, fail or are ended by the launcher, which exits nonzero well
    within the timeout (the ranks' own collectives wait 900 s)."""
    rc, out, err = _wait(launches[1]["cut"], timeout=300)
    assert rc != 0 and "a rank failed" in out
    assert "[rank0]" in err and "simulated preemption" in err


def test_a_mesh_larger_than_the_cards_raises(monkeypatch):
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="needs 4 cards"):
        train.main(["--ranks", "--mesh", "2x2", "--steps", "1"])


def _fake_rank_mesh(shape=(2, 2)):
    """A rank mesh's bookkeeping without a process group: enough for
    what raises before any collective."""
    groups = pg.RankGroups(("data", "model"), shape, 0,
                           torch.device("cpu"), {})
    return tmesh.LMMesh(("data", "model"), shape,
                        ("cpu",) * (shape[0] * shape[1]), ranks=groups)


def test_distinct_devices_outside_a_process_group_raise():
    two = tmesh.LMMesh(("data", "model"), (2, 1), ("cuda:0", "cuda:1"))
    with pytest.raises(NotImplementedError, match="item 12e.*--ranks|"
                       "--ranks.*item 12e"):
        tmesh.single_device(two)
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_rank_mesh(_fake_rank_mesh().ranks)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_steps_across_ranks_raise(kind):
    h = LMHarness("granite-3-2b", cfg=_cfg("granite-3-2b"))
    sh = Shape("t", S, B, kind)
    with pytest.raises(NotImplementedError, match="item 12e-ii"):
        h.step_fn(sh, _fake_rank_mesh(), kind)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "gemma3-12b",
                                  "qwen2-vl-2b", "zamba2-1.2b", "rwkv6-7b",
                                  "whisper-large-v3"])
def test_other_families_across_ranks_raise(arch):
    h = LMHarness(arch, cfg=tconfigs.get_arch(arch).REDUCED)
    with pytest.raises(NotImplementedError, match="item 12e-ii"):
        h.make_train_step(Shape("t", S, B, "train"), _fake_rank_mesh())


def test_expert_parallel_lever_across_ranks_raises():
    h = LMHarness("mixtral-8x7b", cfg=_cfg("mixtral-8x7b"),
                  expert_parallel=True)
    with pytest.raises(NotImplementedError, match="item 12e-ii"):
        h.make_train_step(Shape("t", S, B, "train"), _fake_rank_mesh())


@pytest.mark.parametrize("arch,ep", [("granite-3-2b", False),
                                     ("mixtral-8x7b", True),
                                     ("llama4-scout-17b-a16e", False)])
def test_one_rank_is_the_one_process_step_bit_for_bit(tmp_path, arch, ep):
    """A process group of one rank (gloo here, NCCL on a card) runs the
    rank step's code and gives the one-process step's bits: the loss, the
    norm, the new params and both moments."""
    groups = pg.init_ranks(("data", "model"), (1, 1), rank=0,
                           init_method=pg.file_init_method(str(tmp_path)),
                           device="cpu", timeout_s=60)
    try:
        h = LMHarness(arch, cfg=_cfg(arch, moe_ep=ep))
        like = h.param_shapes()
        tree = unflatten(like, _params_np(arch, 5))
        rng = np.random.default_rng(5)
        toks = rng.integers(1, 256, (4, S + 1)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        sh = Shape("one", S, 4, "train")
        got = []
        for mesh in (tmesh.make_rank_mesh(groups),
                     tmesh.make_host_mesh(devices=["cpu"])):
            params = convert.lm_params(tree)
            got.append(h.make_train_step(sh, mesh)(
                params, h.opt.init(params), batch))
    finally:
        pg.shutdown()
    (p1, o1, m1), (p2, o2, m2) = got
    assert torch.equal(m1["loss"], m2["loss"])
    assert torch.equal(m1["grad_norm"], m2["grad_norm"])
    for a, b in zip(leaves((p1, o1)), leaves((p2, o2))):
        assert torch.equal(a, b)
