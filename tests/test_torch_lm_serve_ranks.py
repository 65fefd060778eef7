"""Prefill and decode across ranks (one process a device, on a process
group) against the JAX package's jitted steps on a mesh of faked devices
and against the port's one-process logical mesh of the same shape.

One module fixture draws every input with numpy from a seed (params of
granite-3-2b, granite-20b, mixtral-8x7b and llama4-scout at REDUCED width
in float32, every leaf random, and one batch of tokens), writes them to
an ``.npz`` and starts three runs side by side, each with a timeout:

* one subprocess runs JAX's ``make_prefill_step`` and ``make_decode_step``
  under ``jax.jit`` with the partitioner's shardings (``shardings(shape,
  mesh, "prefill" | "decode")``) on 4 faked CPU devices, its environment
  scrubbed of ``JAX_*`` and ``XLA_*``, over the meshes ``(2, 2)``, ``(4,
  1)`` and ``(1, 4)`` of ``("data", "model")`` and ``(2, 2, 1)`` and
  ``(2, 1, 2)`` of ``("pod", "data", "model")`` (the rows and the cache
  over ``(pod, data)``);
* one launch of 4 gloo ranks (a ``FileStore`` under a temporary
  directory; one torch thread a rank) runs the port's rank steps on the
  same cases, gathers the cache to rank 0 and records every rank's cache
  shard shapes, its valid slots, its tokens and its collective counts;
* one subprocess runs the dry-run of every case's prefill and decode
  (``repro_torch.launch.dryrun.run_cell``: rank 0's step on fake tensors
  under the fake process group).

Query heads ``model`` does not divide (``"<arch>@HxKV"`` sets the head
counts, :data:`PARTIAL`): llama4-scout at 10 query and 2 K/V heads on
``(1, 4)`` and at 5 and 1 on ``(2, 2)`` (2.5 query heads and half a K/V
head a rank, as its 40 and 8 on 16 model ranks), granite-3-2b at ``(10,
2)`` and ``(10, 5)`` on ``(1, 4)`` (a rank's three heads read two K/V
heads unevenly), on the two ring layouts they can meet (slots over
``model``, and a ring of 17 slots replicated over it) and from an empty
cache.

A case prefills B 8 x S 16 and takes ``N_DEC`` teacher-forced decode
steps (the cache is S long, so the ring wraps; mixtral's window of 8
wraps it at prefill already). Three granite-3-2b cases have a cache of
17 slots, which ``model`` does not divide, so the partitioner shards the
K/V heads (``(2, 2)``, ``(2, 1, 2)``) or replicates the ring over
``model`` (``(1, 4)``); the other cases shard the slots over ``model``.
Three cases decode from an empty cache, where the model ranks beyond the
first hold no valid slot. Held: the prefill's logits to ``F32_TOL``;
every decode step's tokens equal; the gathered cache within ``F32_TOL``
with ``slot_pos`` equal; every rank's cache shard shaped as
``shard_shape(cache_partition(...))`` (JAX's ``NamedSharding.
shard_shape`` at CONFIG width); the dry-run's collective calls and bytes
by kind equal to what the ranks counted.
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

from repro.launch import steps as jsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs.shapes import Shape  # noqa: E402
from repro_torch.distributed import partition as tpart  # noqa: E402
from repro_torch.distributed import process_group as pg  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch.steps import LMHarness  # noqa: E402
from repro_torch.tree import flatten_with_paths, leaves, unflatten  # noqa

from test_torch_lm import F32_TOL  # noqa: E402
from test_torch_lm_train import one_torch_thread  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, N_DEC = 8, 16, 3
POD_MESHES = [(2, 2, 1), (2, 1, 2)]
MESHES = [(2, 2), (4, 1), (1, 4)] + POD_MESHES
ARCHS = ["granite-3-2b", "granite-20b", "mixtral-8x7b",
         "llama4-scout-17b-a16e"]
SCOUT = "llama4-scout-17b-a16e"
# query heads model does not divide: "<arch>@HxKV" sets the head counts
PARTIAL = [(SCOUT + "@10x2", (1, 4), S, True),
           (SCOUT + "@5x1", (2, 2), S, True),
           (SCOUT + "@10x2", (1, 4), S + 1, True),
           (SCOUT + "@5x1", (2, 2), S, False),
           ("granite-3-2b@10x2", (1, 4), S, True),
           ("granite-3-2b@10x5", (1, 4), S, True),
           ("granite-3-2b@10x5", (1, 4), S + 1, True),
           ("granite-3-2b@10x5", (1, 4), S, False)]
# (arch, mesh, cache length, prefill first); without a prefill the
# decode steps start from an empty cache at position 0
CASES = ([(arch, mesh, S, True) for mesh in MESHES for arch in ARCHS
          if mesh not in POD_MESHES or arch != "llama4-scout-17b-a16e"]
         + [("granite-3-2b", (2, 2), S + 1, True),
            ("granite-3-2b", (1, 4), S + 1, True),
            ("granite-3-2b", (2, 1, 2), S + 1, True),
            ("granite-3-2b", (1, 4), S, False),
            ("mixtral-8x7b", (2, 2), S, False),
            ("mixtral-8x7b", (2, 1, 2), S, False)] + PARTIAL)
# every arch of a case, the head cuts included: the inputs' params
INPUT_ARCHS = ARCHS + sorted({c[0] for c in PARTIAL})
TIMEOUT = 600            # seconds a run may take before it fails


def _tag(arch, mesh, T, prefill):
    return f"{arch}/{T}/{'prefill' if prefill else 'empty'}/" + "x".join(
        map(str, mesh))


def _names(mesh):
    """The axis names of a mesh shape: a leading ``pod`` axis on three."""
    return ("pod", "data", "model")[-len(mesh):]


def _ids(cases):
    return [_tag(*c) for c in cases]


# the scripts' reading of a case's arch: its id and REDUCED config, with
# the head counts of an "<id>@HxKV" cut
_CUT = r"""
def cut(arch, **change):
    name, _, heads = arch.partition("@")
    if heads:
        change.update(zip(("n_heads", "n_kv_heads"),
                          map(int, heads.split("x"))))
    return name, dataclasses.replace(configs.get_arch(name).REDUCED, **change)
"""

# runs under JAX with 4 faked devices; prints OK at the end
_JAX_SIDE = r"""
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.configs.shapes import Shape
from repro.launch.steps import LMHarness

inp = dict(np.load(sys.argv[1]))
B, N_DEC = %(B)d, %(N_DEC)d
FAST_XLA = {"xla_backend_optimization_level": 0}
toks = inp["tokens"]
out = {}
%(CUT)s

for arch, shape, T, prefill in json.loads(sys.argv[3]):
    tag = f"{arch}/{T}/{'prefill' if prefill else 'empty'}/" + "x".join(
        map(str, shape))
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(shape),
                             ("pod", "data", "model")[-len(shape):])
    name, cfg = cut(arch, dtype=jnp.float32)
    h = LMHarness(name, cfg=cfg)
    like, tdef = jax.tree.flatten(h.param_shapes())
    params = jax.tree.unflatten(tdef, [jnp.asarray(inp[f"params/{arch}/{i}"])
                                       for i in range(len(like))])
    sp, sd = Shape("serve", T, B, "prefill"), Shape("serve", T, B, "decode")
    with mesh:
        if prefill:
            ins, outs, _ = h.shardings(sp, mesh, "prefill")
            batch = {"tokens": toks[:, :T], "targets": toks[:, 1:T + 1]}
            step = jax.jit(h.make_prefill_step(sp, mesh), in_shardings=ins,
                           out_shardings=outs).lower(params, batch).compile(
                               compiler_options=FAST_XLA)
            logits, cache = step(params, batch)
            out[tag + "/logits"] = np.asarray(logits)
            start = T
        else:
            cache, start = h.model.init_cache(B, T), 0
        ins, outs, _ = h.shardings(sd, mesh, "decode")
        step = jax.jit(h.make_decode_step(sd), in_shardings=ins,
                       out_shardings=outs).lower(
            params, cache, {"tokens": toks[:, :1]},
            jnp.int32(0)).compile(compiler_options=FAST_XLA)
        for i in range(N_DEC):
            pos = start + i
            tok, cache = step(params, cache,
                              {"tokens": toks[:, pos:pos + 1]},
                              jnp.int32(pos))
            out[f"{tag}/tokens/{i}"] = np.asarray(tok)
    for key in ("k", "v", "slot_pos"):
        out[f"{tag}/cache/{key}"] = np.asarray(cache[key])
np.savez(sys.argv[2], **out)
print("OK")
"""

# one rank of the port's run (argv: rank, init method, inputs, out dir,
# cases); rank 0 writes the gathered results, every rank its records
_RANK_SIDE = r"""
import dataclasses, json, os, sys
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch import configs, convert
from repro_torch.configs.shapes import Shape
from repro_torch.distributed import partition as part
from repro_torch.distributed import process_group as pg
from repro_torch.launch.mesh import make_rank_mesh
from repro_torch.launch.steps import LMHarness
from repro_torch.tree import leaves, unflatten

rank, init, inputs, outdir = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                              sys.argv[4])
B, N_DEC = %(B)d, %(N_DEC)d
inp = dict(np.load(inputs))
toks = inp["tokens"]
groups = {}
groups[(2, 2)] = pg.init_ranks(("data", "model"), (2, 2), rank=rank,
                               init_method=init, device="cpu",
                               timeout_s=%(TIMEOUT)d)
out, recs = {}, {}
%(CUT)s
for arch, shape, T, prefill in json.loads(sys.argv[5]):
    shape = tuple(shape)
    tag = f"{arch}/{T}/{'prefill' if prefill else 'empty'}/" + "x".join(
        map(str, shape))
    if shape not in groups:
        groups[shape] = pg.mesh_groups(("pod", "data", "model")[-len(shape):],
                                       shape, "cpu", timeout_s=%(TIMEOUT)d)
    g = groups[shape]
    mesh = make_rank_mesh(g)
    name, cfg = cut(arch, dtype=torch.float32)
    h = LMHarness(name, cfg=cfg)
    sp, sd = Shape("serve", T, B, "prefill"), Shape("serve", T, B, "decode")
    like = h.param_shapes()
    p_shard = part.params_partition(like, mesh, h.rules(mesh))
    c_shard = part.cache_partition(h.cache_shapes(sd), mesh, h.rules(mesh))
    tree = unflatten(like, [inp[f"params/{arch}/{i}"]
                            for i in range(len(leaves(like)))])
    params = convert.lm_rank_params(tree, p_shard, rank)
    rec = {"tokens": [], "valid": [], "calls": {}, "bytes": {}}
    if prefill:
        pg.reset_bytes()
        logits, cache = h.make_prefill_step(sp, mesh)(
            params, {"tokens": toks[:, :T], "targets": toks[:, 1:T + 1]})
        rec["calls"]["prefill"] = dict(pg.CALLS)
        rec["bytes"]["prefill"] = dict(pg.BYTES)
        rec["logits_shape"] = list(logits.shape)
        if rank == 0:
            out[tag + "/logits"] = logits.numpy()
        start = T
    else:
        cache = part.cache_shards(h.cache_shapes(sd), c_shard, "cpu")
        start = 0
    decode = h.make_decode_step(sd, mesh)
    for i in range(N_DEC):
        pos = start + i
        pg.reset_bytes()
        tok, cache = decode(params, cache, {"tokens": toks[:, pos:pos + 1]},
                            pos)
        if i == 0:
            rec["calls"]["decode"] = dict(pg.CALLS)
            rec["bytes"]["decode"] = dict(pg.BYTES)
        rec["tokens"].append(tok.numpy().tolist())
        rec["valid"].append(int((cache["slot_pos"][0] >= 0).sum()))
    rec["cache_shapes"] = {k: list(v.shape) for k, v in cache.items()}
    recs[tag] = rec
    full = pg.gather_tree(cache, c_shard, g)
    if rank == 0:
        for key in ("k", "v", "slot_pos"):
            out[f"{tag}/cache/{key}"] = full[key].numpy()
        for i, t in enumerate(rec["tokens"]):
            out[f"{tag}/tokens/{i}"] = np.asarray(t, np.int32)
with open(os.path.join(outdir, f"ranks_{rank}.json"), "w") as f:
    json.dump(recs, f)
if rank == 0:
    np.savez(os.path.join(outdir, "ranks.npz"), **out)
pg.shutdown()
print("OK")
"""

# the dry-run of every case's prefill and decode (argv: cases, out file)
_DRYRUN_SIDE = r"""
import dataclasses, json, sys
import torch
torch.set_num_threads(1)
from repro_torch import configs
from repro_torch.configs.shapes import Shape
from repro_torch.launch import dryrun

B = %(B)d
out = {}
%(CUT)s

for arch, shape, T, prefill in json.loads(sys.argv[1]):
    tag = f"{arch}/{T}/{'prefill' if prefill else 'empty'}/" + "x".join(
        map(str, shape))
    name, cfg = cut(arch, dtype=torch.float32)
    for kind in (("prefill", "decode") if prefill else ("decode",)):
        out[f"{tag}/{kind}"] = dryrun.run_cell(
            name, Shape("serve", T, B, kind), mesh=tuple(shape), cfg=cfg,
            device="cpu", verbose=False)
with open(sys.argv[2], "w") as f:
    json.dump(out, f)
print("OK")
"""


def _cfg(arch):
    """The REDUCED float32 config of a case's arch (``"<id>@HxKV"``: with
    those head counts)."""
    name, _, heads = arch.partition("@")
    change = {}
    if heads:
        change = dict(zip(("n_heads", "n_kv_heads"),
                          map(int, heads.split("x"))))
    return dataclasses.replace(tconfigs.get_arch(name).REDUCED,
                               dtype=torch.float32, **change)


def _harness(arch):
    return LMHarness(arch.partition("@")[0], cfg=_cfg(arch))


def _params_np(arch, seed):
    """Every leaf random: norm scales 0.1 N(0, 1), the rest N(0, 1) over
    the square root of the fan-in (the second-to-last dim)."""
    rng = np.random.default_rng(seed)
    out = []
    for path, t in flatten_with_paths(_harness(arch).param_shapes()):
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


def _finish(proc, what):
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        pytest.fail(f"{what} hung past {TIMEOUT} s\n{err[-3000:]}")
    assert proc.returncode == 0 and "OK" in out, \
        f"{what}: rc={proc.returncode}\n{err[-3000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's results, the 4 ranks' and the dry-run's, all side by side."""
    tmp = tmp_path_factory.mktemp("serve_ranks")
    inputs = str(tmp / "inputs.npz")
    rng = np.random.default_rng(11)
    arrays = {"tokens": rng.integers(1, 256, (B, S + 2 + N_DEC))
              .astype(np.int32)}
    for n, arch in enumerate(INPUT_ARCHS):
        for i, a in enumerate(_params_np(arch, 200 + n)):
            arrays[f"params/{arch}/{i}"] = a
    np.savez(inputs, **arrays)
    subs = {"B": B, "N_DEC": N_DEC, "TIMEOUT": TIMEOUT, "CUT": _CUT}
    cases = json.dumps(CASES)
    procs = {"the JAX side": subprocess.Popen(
        [sys.executable, "-c", _JAX_SIDE % subs, inputs,
         str(tmp / "jax.npz"), cases], text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, env=_clean_env(
            XLA_FLAGS="--xla_force_host_platform_device_count=4"))}
    init = pg.file_init_method(str(tmp))
    for r in range(4):
        procs[f"rank {r}"] = subprocess.Popen(
            [sys.executable, "-c", _RANK_SIDE % subs, str(r), init, inputs,
             str(tmp), cases], text=True, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, env=_clean_env())
    procs["the dry-run"] = subprocess.Popen(
        [sys.executable, "-c", _DRYRUN_SIDE % subs, cases,
         str(tmp / "dryrun.json")], text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, env=_clean_env())
    try:
        for what, proc in procs.items():
            _finish(proc, what)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    with np.load(tmp / "jax.npz") as f:
        jax_out = dict(f)
    with np.load(tmp / "ranks.npz") as f:
        rank_out = dict(f)
    recs = []
    for r in range(4):
        with open(tmp / f"ranks_{r}.json") as f:
            recs.append(json.load(f))
    with open(tmp / "dryrun.json") as f:
        dryrun = json.load(f)
    return {"inputs": dict(np.load(inputs)), "jax": jax_out,
            "ranks": rank_out, "recs": recs, "dryrun": dryrun}


def _check(got, want, tag, prefill):
    if prefill:
        np.testing.assert_allclose(got[tag + "/logits"],
                                   want[tag + "/logits"], rtol=F32_TOL,
                                   atol=F32_TOL)
    for i in range(N_DEC):
        np.testing.assert_array_equal(got[f"{tag}/tokens/{i}"],
                                      want[f"{tag}/tokens/{i}"])
    for key in ("k", "v"):
        np.testing.assert_allclose(got[f"{tag}/cache/{key}"],
                                   want[f"{tag}/cache/{key}"], rtol=F32_TOL,
                                   atol=F32_TOL)
    np.testing.assert_array_equal(got[f"{tag}/cache/slot_pos"],
                                  want[f"{tag}/cache/slot_pos"])


@pytest.mark.parametrize("arch,mesh,T,prefill", CASES, ids=_ids(CASES))
def test_serve_ranks_match_jax(runs, arch, mesh, T, prefill):
    """4 gloo ranks == JAX's jitted prefill and decode steps on 4 faked
    devices: the last logits, every decode step's tokens, the cache."""
    _check(runs["ranks"], runs["jax"], _tag(arch, mesh, T, prefill),
           prefill)


@pytest.mark.parametrize("arch,mesh,T,prefill", CASES, ids=_ids(CASES))
def test_serve_ranks_match_the_logical_mesh(runs, arch, mesh, T, prefill):
    """4 gloo ranks == the port's one-process logical mesh of the same
    shape (``cpu``)."""
    tag = _tag(arch, mesh, T, prefill)
    h = _harness(arch)
    like = h.param_shapes()
    inp = runs["inputs"]
    params = convert.lm_params(unflatten(like, [
        inp[f"params/{arch}/{i}"] for i in range(len(leaves(like)))]))
    lmesh = tmesh.LMMesh(_names(mesh), mesh, ("cpu",) * int(np.prod(mesh)))
    toks = inp["tokens"]
    sd = Shape("serve", T, B, "decode")
    want = {}
    if prefill:
        logits, cache = h.make_prefill_step(
            Shape("serve", T, B, "prefill"), lmesh)(
                params, {"tokens": toks[:, :T], "targets": toks[:, 1:T + 1]})
        want[tag + "/logits"] = logits.numpy()
        start = T
    else:
        cache, start = h.model.init_cache(B, T, device="cpu"), 0
    decode = h.make_decode_step(sd, lmesh)
    for i in range(N_DEC):
        pos = start + i
        tok, cache = decode(params, cache,
                            {"tokens": toks[:, pos:pos + 1]}, pos)
        want[f"{tag}/tokens/{i}"] = tok.numpy()
    for key in ("k", "v", "slot_pos"):
        want[f"{tag}/cache/{key}"] = cache[key].numpy()
    _check(runs["ranks"], want, tag, prefill)


@pytest.mark.parametrize("arch,mesh,T,prefill", CASES, ids=_ids(CASES))
def test_each_rank_holds_its_cache_shard(runs, arch, mesh, T, prefill):
    """Every rank's cache leaves have ``shard_shape(cache_partition(...))``
    (a leaf the mesh shards is never whole on a rank; only the ring
    replicated over ``model`` on one data rank is whole), and every rank
    returns the whole batch's logits and the same tokens."""
    tag = _tag(arch, mesh, T, prefill)
    h = _harness(arch)
    lm = tmesh.LMMesh(_names(mesh), mesh)
    c_shapes = h.cache_shapes(Shape("serve", T, B, "decode"))
    c_shard = tpart.cache_partition(c_shapes, lm, h.rules(lm))
    want = {k: list(tpart.shard_shape(c_shard[k], c_shapes[k].shape))
            for k in c_shapes}
    layout = tpart.kv_layout(tpart.layer_shardings(c_shard)["k"])
    if len(mesh) == 3:   # the rows over (pod, data): a batch shard's
        assert want["k"][1] == B // (mesh[0] * mesh[1]), tag
    if layout != "replicated" or np.prod(mesh[:-1]) > 1:   # the ring is cut
        assert want["k"] != list(c_shapes["k"].shape), tag
    for r in range(4):
        rec = runs["recs"][r][tag]
        assert rec["cache_shapes"] == want, (tag, r)
        assert rec["tokens"] == runs["recs"][0][tag]["tokens"], (tag, r)
        if prefill:
            assert rec["logits_shape"] == [B, 1, h.cfg.padded_vocab]


def test_the_three_cache_layouts_are_covered():
    """The cases meet each layout the partitioner gives a K/V ring: the
    slots over ``model``, the K/V heads over it, and replicated."""
    seen = set()
    pod_seen = set()
    for arch, mesh, T, _ in CASES:
        h = _harness(arch)
        lm = tmesh.LMMesh(_names(mesh), mesh)
        sh = tpart.cache_partition(h.cache_shapes(
            Shape("serve", T, B, "decode")), lm, h.rules(lm))
        if mesh[-1] > 1:
            layout = tpart.kv_layout(tpart.layer_shardings(sh)["k"])
            seen.add(layout)
            if len(mesh) == 3:
                pod_seen.add(layout)
    assert seen == {"seq", "heads", "replicated"}
    assert pod_seen == {"seq", "heads"}


@pytest.mark.parametrize("arch,mesh", [("granite-3-2b", (1, 4)),
                                       ("mixtral-8x7b", (2, 2)),
                                       ("mixtral-8x7b", (2, 1, 2)),
                                       (SCOUT + "@5x1", (2, 2)),
                                       ("granite-3-2b@10x5", (1, 4))])
def test_decode_from_an_empty_cache(runs, arch, mesh):
    """From an empty cache the first decode step writes slot 0 alone, so
    the model ranks but the first hold no valid slot; their softmax parts
    add nothing, and the steps still equal JAX's (above)."""
    tag = _tag(arch, mesh, S, False)
    M = mesh[-1]
    T_l = _harness(arch).model.cache_len(S) // M
    for r in range(4):
        valid = runs["recs"][r][tag]["valid"]
        c = r % M
        assert valid[0] == (1 if c == 0 else 0), (tag, r, valid)
        assert valid == [max(0, min(T_l, i + 1 - c * T_l))
                         for i in range(N_DEC)], (tag, r, valid)


@pytest.mark.parametrize("mesh", MESHES)
def test_the_mixtral_ring_wraps(runs, mesh):
    """mixtral's window of 8 makes a ring of 8 slots: a prefill of 16
    keeps positions 8..15, and each decode step overwrites the oldest."""
    tag = _tag("mixtral-8x7b", mesh, S, True)
    sp = runs["ranks"][f"{tag}/cache/slot_pos"]
    assert sp.shape[-1] == 8
    want = np.arange(S - 8 + N_DEC, S + N_DEC)
    np.testing.assert_array_equal(np.sort(sp[0]), want)


@pytest.mark.parametrize("arch,mesh,T,prefill", CASES, ids=_ids(CASES))
def test_dryrun_counts_what_the_ranks_did(runs, arch, mesh, T, prefill):
    """The dry-run of the same cut, mesh and shape (rank 0's prefill and
    decode steps on fake tensors under the fake process group) issues the
    collectives the 4 gloo ranks issued in their prefill and in one
    decode step, call for call and byte for byte by kind."""
    tag = _tag(arch, mesh, T, prefill)
    got = runs["recs"][0][tag]
    for kind in (("prefill", "decode") if prefill else ("decode",)):
        rec = runs["dryrun"][f"{tag}/{kind}"]
        assert rec["status"] == "ok", rec.get("traceback")
        assert rec["n_micro"] == 1
        col = rec["collectives"]
        assert {k.replace("-", "_"): v for k, v in
                col["counts"].items()} == got["calls"][kind], kind
        assert {k.replace("-", "_"): v for k, v in
                col["buffer_bytes_by_kind"].items()} == got["bytes"][kind]


def _abstract(shape):
    names = _names(shape)
    return (jax.sharding.AbstractMesh(shape, names),
            tmesh.LMMesh(names, shape))


@pytest.mark.parametrize("mesh", MESHES[:3] + [(16, 16)] + POD_MESHES
                         + [(2, 16, 16)])
@pytest.mark.parametrize("arch,shape", [("granite-3-2b", "decode_32k"),
                                        ("granite-20b", "decode_32k"),
                                        ("mixtral-8x7b", "long_500k"),
                                        ("mixtral-8x7b", "prefill_32k")])
def test_cache_shard_shapes_match_jax(arch, shape, mesh):
    """Every cache leaf's local shape == JAX's ``NamedSharding(mesh,
    spec).shard_shape`` at CONFIG width: what each rank allocates."""
    from repro.configs.shapes import SHAPES as JSHAPES
    from repro_torch.configs.shapes import SHAPES

    jm, tm = _abstract(mesh)
    kind = SHAPES[shape].kind
    jins, jouts, jargs = jsteps.LMHarness(arch).shardings(
        JSHAPES[shape], jm, kind)
    tins, touts, targs = LMHarness(arch).shardings(SHAPES[shape], tm, kind)
    jc = jouts[1]
    tc = touts[1]
    jl = jax.tree.leaves(jc, is_leaf=lambda x: isinstance(
        x, jax.sharding.NamedSharding))
    tshapes = LMHarness(arch).cache_shapes(SHAPES[shape])
    jshapes = jsteps.LMHarness(arch).cache_shapes(JSHAPES[shape])
    jflat = jax.tree.leaves(jshapes)
    assert len(jl) == len(leaves(tc)) == len(jflat)
    for js, jshape, ts, t in zip(jl, jflat, leaves(tc), leaves(tshapes)):
        assert tuple(jshape.shape) == tuple(t.shape)
        assert tpart.shard_shape(ts, t.shape) == tuple(
            js.shard_shape(tuple(jshape.shape)))
