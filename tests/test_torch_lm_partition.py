"""The port's LM partitioner and meshes (``models.common.AXES`` /
``axes_of``, the LM half of ``distributed.partition``, ``launch.mesh``,
``LMHarness.rules`` / ``shardings`` / ``n_microbatches`` and the strided
microbatch split) against the JAX package's.

JAX's partitioner runs in-process on ``jax.sharding.AbstractMesh`` (shape
only), so the specs at production size, ``(16, 16)`` and ``(2, 16,
16)``, need no faked devices. A JAX ``PartitionSpec`` is compared as the
tuple of its entries, which is what the port's ``Sharding.spec`` holds.

* ``AXES`` equal to JAX's; ``axes_of`` equal on every leaf of all ten
  archs at REDUCED and CONFIG (the port's leaves on ``meta``), with the
  twin's paths.
* ``PartitionRules.default`` equal on ``(1, 1)``, ``(4, 2)``, ``(16,
  16)`` and ``(2, 16, 16)`` under each lever.
* ``params_partition``, ``opt_partition``, ``batch_partition``,
  ``cache_partition`` and ``LMHarness.shardings`` for train, prefill and
  decode: every spec equal to JAX's, all ten archs at CONFIG, on both
  production meshes, with and without the levers.
* ``n_microbatches`` and ``_strided_split`` byte-equal over a sweep of
  batch, ``micro_rows`` and mesh, M-RoPE ids and the plain-split
  fallback included.
* ``tests/test_partition.py``'s cases on the port; the meshes.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.configs.shapes import Shape as JShape  # noqa: E402
from repro.distributed import partition as jpart  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.shapes import SHAPES, Shape  # noqa: E402
from repro_torch.distributed import partition as tpart  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.tree import flatten_with_paths, leaves  # noqa: E402

from test_torch_lm_train import one_torch_thread  # noqa: E402,F401

ARCHS = jconfigs.list_archs()
MESH_SHAPES = [(1, 1), (4, 2), (16, 16), (2, 16, 16)]
LEVERS = [dict(expert_parallel=False, attn_tp=True),
          dict(expert_parallel=True, attn_tp=False)]


def _meshes(shape):
    """(JAX abstract mesh, port abstract mesh) of ``shape``."""
    names = ("pod", "data", "model")[-len(shape):]
    return (jax.sharding.AbstractMesh(shape, names),
            tmesh.LMMesh(names, shape))


def _jkey(path) -> str:
    return "/".join(jpart._pstr(p) for p in path)


def _tkey(path) -> str:
    return "/".join(str(p) for p in path)


def _jspecs(tree):
    """JAX's NamedShardings of ``tree`` as spec tuples, in flatten order."""
    return [tuple(s.spec) for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))]


def _tspecs(tree):
    return [s.spec for s in leaves(
        tree, is_leaf=lambda x: isinstance(x, tpart.Sharding))]


def _same_specs(jtree, ttree, what):
    j, t = _jspecs(jtree), _tspecs(ttree)
    assert len(j) == len(t), what
    assert j == t, what


# --------------------------------------------------------------------------
# the logical-axis registry
# --------------------------------------------------------------------------
def test_axes_registry_equals_jax():
    assert tcommon.AXES == jcommon.AXES
    assert list(tcommon.AXES) == list(jcommon.AXES)


@pytest.mark.parametrize("which", ["REDUCED", "CONFIG"])
@pytest.mark.parametrize("arch", ARCHS)
def test_axes_of_matches_jax_on_every_leaf(arch, which):
    """Same paths in the same order, same logical axes, of the leaf's
    rank; at REDUCED, ``tests/test_partition.py``'s coverage rule too: a
    big matrix (not a norm) shards on some dim."""
    jcfg = getattr(jconfigs.get_arch(arch), which)
    tcfg = getattr(tconfigs.get_arch(arch), which)
    jflat, _ = jax.tree_util.tree_flatten_with_path(
        jsteps.LMHarness(arch, cfg=jcfg).param_shapes())
    tflat = flatten_with_paths(tsteps.LMHarness(arch, cfg=tcfg)
                               .param_shapes())
    assert [_jkey(p) for p, _ in jflat] == [_tkey(p) for p, _ in tflat]
    for (jp, jl), (tp, tl) in zip(jflat, tflat):
        key = _tkey(tp)
        axes = tcommon.axes_of(key, tl)
        assert axes == jcommon.axes_of(_jkey(jp), jl), key
        assert len(axes) == tl.ndim, key
        if (which == "REDUCED" and tl.ndim >= 2 and min(tl.shape) >= 8
                and "norm" not in key):
            assert any(a is not None for a in axes), key


def test_axes_of_suffix_rules():
    """The longest suffix of at most three parts wins; a rank one above
    the entry's gets "layers"; no match replicates."""
    leaf = torch.empty((3, 4, 5), device="meta")
    for path in ("layers/attn/wq", "enc_layers/attn/wq", "x/lora_a",
                 "a/b/c/d", "moe/w_gate"):
        want = jcommon.axes_of(path, jax.ShapeDtypeStruct(leaf.shape,
                                                           jnp.float32))
        assert tcommon.axes_of(path, leaf) == want, path


# --------------------------------------------------------------------------
# rules
# --------------------------------------------------------------------------
@pytest.mark.parametrize("levers", LEVERS + [
    dict(expert_parallel=True, attn_tp=True),
    dict(expert_parallel=False, attn_tp=False)])
@pytest.mark.parametrize("shape", MESH_SHAPES)
def test_rules_default_matches_jax(shape, levers):
    jm, tm = _meshes(shape)
    want = jpart.PartitionRules.default(jm, **levers)
    got = tpart.PartitionRules.default(tm, **levers)
    assert got.rules == want.rules and got.batch_axes == want.batch_axes


# --------------------------------------------------------------------------
# specs at production size
# --------------------------------------------------------------------------
@pytest.mark.parametrize("levers", LEVERS)
@pytest.mark.parametrize("shape", [(16, 16), (2, 16, 16)])
@pytest.mark.parametrize("arch", ARCHS)
def test_shardings_match_jax(arch, shape, levers):
    """Every spec of ``params_partition``, ``opt_partition``,
    ``batch_partition``, ``cache_partition`` (through ``shardings``) for
    the train, prefill and decode steps, at CONFIG."""
    jm, tm = _meshes(shape)
    jh = jsteps.LMHarness(arch, **levers)
    th = tsteps.LMHarness(arch, **levers)
    for h in (jh, th):  # draw the shapes once a harness
        h.param_shapes = (lambda s: lambda: s)(h.param_shapes())
    rules_j, rules_t = jh.rules(jm), th.rules(tm)
    _same_specs(jpart.params_partition(jh.param_shapes(), jm, rules_j),
                tpart.params_partition(th.param_shapes(), tm, rules_t),
                "params")
    for kind, name in (("train", "train_4k"), ("prefill", "prefill_32k"),
                       ("decode", "decode_32k")):
        jin, jout, jargs = jh.shardings(JSHAPES[name], jm, kind)
        tin, tout, targs = th.shardings(SHAPES[name], tm, kind)
        for i, (a, b) in enumerate(zip(jin, tin)):
            _same_specs(a, b, f"{kind} in {i}")
        for i, (a, b) in enumerate(zip(jout, tout)):
            _same_specs(a, b, f"{kind} out {i}")
        for a, b in zip(jax.tree.leaves(jargs), leaves(targs)):
            assert tuple(a.shape) == tuple(b.shape), kind
    o_shapes = th.opt_shapes()
    assert [tuple(t.shape) for t in leaves(o_shapes)] == [
        tuple(a.shape) for a in jax.tree.leaves(jh.opt_shapes())]
    assert all(t.device.type == "meta" for t in leaves(o_shapes))


@pytest.mark.parametrize("arch", ["gemma3-12b", "mixtral-8x7b"])
def test_cache_partition_split_cache_matches_jax(arch):
    """The split cache's leading group dims replicate, as in the twin."""
    jm, tm = _meshes((16, 16))
    jcfg = dataclasses.replace(jconfigs.get_arch(arch).CONFIG,
                               split_cache=arch == "gemma3-12b")
    tcfg = dataclasses.replace(tconfigs.get_arch(arch).CONFIG,
                               split_cache=arch == "gemma3-12b")
    jh = jsteps.LMHarness(arch, cfg=jcfg)
    th = tsteps.LMHarness(arch, cfg=tcfg)
    for name in ("decode_32k", "prefill_32k"):
        _same_specs(
            jpart.cache_partition(jh.cache_shapes(JSHAPES[name]), jm,
                                  jh.rules(jm)),
            tpart.cache_partition(th.cache_shapes(SHAPES[name]), tm,
                                  th.rules(tm)), name)


# --------------------------------------------------------------------------
# microbatches
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape", MESH_SHAPES + [(2, 2), (3, 1)])
def test_n_microbatches_matches_jax(shape):
    jm, tm = _meshes(shape)
    for micro_rows in (1, 2, 3, 4):
        jh = jsteps.LMHarness("granite-3-2b", micro_rows=micro_rows)
        th = tsteps.LMHarness("granite-3-2b", micro_rows=micro_rows)
        for B in (1, 2, 4, 6, 8, 12, 16, 24, 256, 512):
            assert th.n_microbatches(Shape("t", 8, B, "train"), tm) == (
                jh.n_microbatches(JShape("t", 8, B, "train"), jm)), (
                    B, micro_rows)


SPLITS = [  # (x shape, n_micro, n_shards)
    ((8, 5), 4, 2), ((8, 5), 2, 4), ((8, 5), 8, 1), ((8, 5), 1, 8),
    ((12, 3, 2), 3, 2), ((6, 4), 2, 4),          # plain-split fallback
    ((3, 8, 5), 2, 2), ((3, 8, 5), 4, 2),        # M-RoPE (3, B, S)
    ((3, 6, 5), 3, 4), ((1, 7), 1, 16), ((16,), 4, 2)]


@pytest.mark.parametrize("xshape,n_micro,n_shards", SPLITS)
def test_strided_split_is_jaxs(xshape, n_micro, n_shards):
    x = np.arange(int(np.prod(xshape)), dtype=np.int32).reshape(xshape)
    want = np.asarray(jsteps._strided_split(jnp.asarray(x), n_micro,
                                            n_shards))
    got = tsteps._strided_split(torch.from_numpy(x), n_micro, n_shards)
    assert tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy(), want)


def test_strided_split_refuses_what_jax_refuses():
    x = np.zeros((6, 4), np.int32)
    with pytest.raises(ValueError):
        jsteps._strided_split(jnp.asarray(x), 4, 1)
    with pytest.raises(ValueError, match="not divisible"):
        tsteps._strided_split(torch.from_numpy(x), 4, 1)


# --------------------------------------------------------------------------
# tests/test_partition.py on the port
# --------------------------------------------------------------------------
def _host_mesh():
    return tmesh.make_host_mesh(devices=["cpu"])


def test_spec_for_divisibility_fallback():
    rules = tpart.PartitionRules(rules={"heads": "model", "embed": "data"},
                                 batch_axes=("data",))
    assert tpart.spec_for(("embed", "heads"), (64, 64), _host_mesh(),
                          rules) == ()


def test_batch_partition_shapes():
    mesh = _host_mesh()
    rules = tpart.PartitionRules.default(mesh)
    shapes = {"tokens": torch.empty((8, 16), dtype=torch.int32,
                                    device="meta"),
              "mrope_positions": torch.empty((3, 8, 16), dtype=torch.int32,
                                             device="meta")}
    sh = tpart.batch_partition(shapes, mesh, rules)
    assert set(sh) == {"tokens", "mrope_positions"}
    assert all(s.mesh is mesh and s.spec == () for s in sh.values())


@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-1.2b", "rwkv6-7b",
                                  "minicpm3-4b"])
def test_cache_partition_covers_cache_leaves(arch):
    h = tsteps.LMHarness(arch, cfg=tconfigs.get_arch(arch).REDUCED)
    mesh = _host_mesh()
    cache = h.model.init_cache(4, 16, device="meta")
    sh = tpart.cache_partition(cache, mesh, tpart.PartitionRules.default(
        mesh))
    assert len(_tspecs(sh)) == len(leaves(cache))


def test_activation_constraints_return_their_input():
    """The constraints read the context as the twin's do and leave the
    values alone, inside and outside it."""
    x = torch.arange(24.0).reshape(4, 6)
    _, tm = _meshes((4, 2))
    assert tpart.constrain_batch(x) is x and tpart.constrain_seq(x) is x
    with tpart.activation_sharding(("data",), 4, tm):
        assert tpart._ACT_CTX.get() == (("data",), 4, 4)
        assert tpart.constrain_batch(x) is x
        assert tpart.constrain_seq(x, 1) is x
    assert tpart._ACT_CTX.get() is None


# --------------------------------------------------------------------------
# meshes
# --------------------------------------------------------------------------
def test_meshes():
    prod = tmesh.make_production_mesh()
    assert prod.shape == {"data": 16, "model": 16} and prod.abstract
    pods = tmesh.make_production_mesh(multi_pod=True)
    assert pods.axis_names == ("pod", "data", "model")
    assert pods.sizes == (2, 16, 16) and pods.size == 512
    m = tmesh.make_host_mesh(data=4, model=2, devices=["cpu"])
    assert m.shape == {"data": 4, "model": 2} and m.size == 8
    assert m.physical_devices == (torch.device("cpu"),)
    assert tmesh.single_device(m) == torch.device("cpu")
    assert tmesh.make_host_mesh(devices=["cpu", "cpu"]).shape == {
        "data": 2, "model": 1}
    assert tmesh.current_mesh() is None
    with tmesh.use_mesh(m):
        assert tmesh.current_mesh() is m
        with tmesh.use_mesh(prod):
            assert tmesh.current_mesh() is prod
        assert tmesh.current_mesh() is m
    assert tmesh.current_mesh() is None
    with pytest.raises(ValueError, match="abstract"):
        tmesh.single_device(prod)
    with pytest.raises(ValueError):
        tmesh.LMMesh(("data", "model"), (2, 2), ("cpu",))
    two_cards = tmesh.LMMesh(("data", "model"), (2, 1), ("cuda:0", "cuda:1"))
    with pytest.raises(NotImplementedError, match="item 12e"):
        tmesh.single_device(two_cards)
