"""The port's training substrate against the JAX package's: optimizers
and schedules, checkpoints (both directions across the packages), the
fault-tolerant loop and gradient compression. Mirrors
``tests/test_training.py`` in the port and holds each piece against its
twin on the same numpy inputs.

Tolerances: ``sgd``, ``adam`` and ``adamw`` updates and states are
byte-equal to JAX's over five steps (the same float32 ops in the same
order); ``chain_clip`` is rtol 1e-5 (4.6e-6 measured: the global norm's
sum is reduced in another order); the warmup-cosine schedule atol 1e-7
(3.0e-8 measured: ``cos`` differs in the last bit). ``Int8Compressor``
and the checkpoint's arrays are byte-equal.

Subnormals: CPU torch keeps float32 subnormals, XLA on the CPU flushes
them to zero (ROADMAP Queue 3 fault 3), so the cross-package clip test
draws none; a port-only test holds the no-op clip on subnormal input.
Every ``@given`` test here is derandomized and keeps no example database.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_lm_train import one_torch_thread  # noqa: E402,F401
import msgpack  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro import checkpoint as jck  # noqa: E402
from repro.training import compression as jcomp  # noqa: E402
from repro.training import loop as jloop  # noqa: E402
from repro.training import optimizers as jopt  # noqa: E402
from repro_torch import checkpoint as tck  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree as ttree  # noqa: E402
from repro_torch.checkpoint import _msgpack  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.training import compression as tcomp  # noqa: E402
from repro_torch.training import loop as tloop  # noqa: E402
from repro_torch.training import optimizers as topt  # noqa: E402

SETTINGS = dict(deadline=None, derandomize=True, database=None)


def _t(tree):
    """A numpy tree as a tree of CPU tensors."""
    return ttree.tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)),
                          tree)


def _np(tree):
    return [x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in ttree.leaves(tree)]


def _jnp(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


# --------------------------------------------------------------------------
# tree order
# --------------------------------------------------------------------------
def test_tree_flatten_order_and_paths_match_jax():
    rng = np.random.default_rng(0)
    tree = {"z": [rng.normal(size=2), (rng.normal(size=1), None)],
            "a": {"y": np.int32(3), "b": rng.normal(size=(2, 2))},
            "m": [], "n": None}
    jpaths = [("/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path), leaf)
              for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]]
    tpaths = [("/".join(str(p) for p in path), leaf)
              for path, leaf in ttree.flatten_with_paths(tree)]
    assert [p for p, _ in jpaths] == [p for p, _ in tpaths]
    assert all(a is b for (_, a), (_, b) in zip(jpaths, tpaths))
    doubled = ttree.tree_map(lambda x: x * 2, tree)
    for a, b in zip(ttree.leaves(doubled), jax.tree.leaves(
            jax.tree.map(lambda x: x * 2, tree))):
        assert np.array_equal(a, b)
    assert ttree.unflatten(tree, ttree.leaves(tree))["z"][1][1] is None


@pytest.mark.parametrize("walk", ["leaves", "flatten_with_paths",
                                  "unflatten", "tree_map", "structure_str",
                                  "clip_by_global_norm"])
def test_tree_walks_leave_no_reference_cycle(walk):
    """With the cyclic collector off, a tensor that went through a walk
    of ``tree.py`` (or the clip, which flattens the gradients) is freed
    as soon as its caller drops it, and the walk leaves no garbage for
    the collector: no walk's frame or closure keeps the leaves alive
    (ROADMAP Queue 3 fault 10: the unclipped float32 gradients lived
    through AdamW)."""
    import gc
    import weakref

    def run():
        t = torch.ones(4)
        tree = {"b": [t, None], "a": (torch.zeros(2),)}
        out = {
            "leaves": lambda: ttree.leaves(tree),
            "flatten_with_paths": lambda: ttree.flatten_with_paths(tree),
            "unflatten": lambda: ttree.unflatten(tree, ttree.leaves(tree)),
            "tree_map": lambda: ttree.tree_map(lambda x, y: x, tree, tree),
            "structure_str": lambda: ttree.structure_str(tree),
            "clip_by_global_norm": lambda: topt.clip_by_global_norm(tree,
                                                                    1.0),
        }[walk]()
        del out
        return weakref.ref(t)

    gc.collect()
    gc.disable()
    try:
        ref = run()
        assert ref() is None, f"{walk} kept the tensor alive"
        assert gc.collect() == 0, f"{walk} left a reference cycle"
    finally:
        gc.enable()


# --------------------------------------------------------------------------
# optimizers
# --------------------------------------------------------------------------
def _opt_pairs():
    return {
        "sgd": (jopt.sgd(0.1), topt.sgd(0.1), 0.0),
        "sgd momentum": (jopt.sgd(0.1, momentum=0.9),
                         topt.sgd(0.1, momentum=0.9), 0.0),
        "sgd nesterov": (jopt.sgd(0.1, 0.9, True), topt.sgd(0.1, 0.9, True),
                         0.0),
        "adam": (jopt.adam(1e-2), topt.adam(1e-2), 0.0),
        "adamw": (jopt.adamw(1e-2, weight_decay=0.1),
                  topt.adamw(1e-2, weight_decay=0.1), 0.0),
        "adam warmup-cosine": (
            jopt.adam(jopt.Schedules.warmup_cosine(1e-2, 2, 5)),
            topt.adam(topt.Schedules.warmup_cosine(1e-2, 2, 5)), 0.0),
        "chain_clip": (jopt.chain_clip(jopt.adam(1e-2), 1.0),
                       topt.chain_clip(topt.adam(1e-2), 1.0), 1e-5),
    }


@pytest.mark.parametrize("name", list(_opt_pairs()))
def test_optimizer_updates_match_jax(name):
    """Five updates on identical numpy grads (scales 0.01..10): updates,
    params and states byte-equal, or to the stated rtol."""
    jo, to, rtol = _opt_pairs()[name]
    rng = np.random.default_rng(1)
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32),
              "b": [rng.normal(size=(3,)).astype(np.float32)]}
    jp, tp = jax.tree.map(jnp.asarray, params), _t(params)
    js, ts = jo.init(jp), to.init(tp)
    assert ts["step"].dtype == torch.int32 and ts["step"].ndim == 0
    for scale in (1.0, 0.1, 10.0, 3.0, 0.01):
        g = {"w": rng.normal(size=(4, 3)).astype(np.float32) * scale,
             "b": [rng.normal(size=(3,)).astype(np.float32) * scale]}
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = to.update(_t(g), ts, tp)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        for a, b in zip(_jnp((ju, jp, js)), _np((tu, tp, ts))):
            assert a.dtype == b.dtype and a.shape == b.shape
            if rtol:
                np.testing.assert_allclose(b, a, rtol=rtol, atol=0)
            else:
                assert np.array_equal(a, b)
    assert int(ts["step"]) == 5


@pytest.mark.parametrize("make", [
    lambda: topt.sgd(0.1, momentum=0.9),
    lambda: topt.adam(0.1),
    lambda: topt.adamw(0.1, weight_decay=0.0),
])
def test_optimizers_minimize_quadratic(make):
    opt = make()
    params = {"w": torch.tensor([3.0, -2.0]), "b": torch.tensor(5.0)}
    state = opt.init(params)

    def loss(p):
        return torch.sum(p["w"] ** 2) + p["b"] ** 2

    for _ in range(200):
        leaves = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        gw, gb = torch.autograd.grad(loss(leaves), [leaves["w"], leaves["b"]])
        updates, state = opt.update({"w": gw, "b": gb}, state, params)
        params = topt.apply_updates(params, updates)
    assert float(loss(params)) < 1e-2


def test_adamw_decays_weights():
    opt = topt.adamw(0.1, weight_decay=0.5)
    params = {"w": torch.tensor([10.0])}
    state = opt.init(params)
    for _ in range(20):
        updates, state = opt.update({"w": torch.tensor([0.0])}, state, params)
        params = topt.apply_updates(params, updates)
    assert float(torch.abs(params["w"][0])) < 10.0


@pytest.mark.parametrize("sched", ["warmup_cosine", "linear_decay",
                                   "constant"])
def test_schedules_match_jax(sched):
    make = {"warmup_cosine": lambda s: s.warmup_cosine(1.0, 10, 100),
            "linear_decay": lambda s: s.linear_decay(0.5, 100),
            "constant": lambda s: s.constant(3e-3)}[sched]
    jf, tf = make(jopt.Schedules), make(topt.Schedules)
    steps = range(0, 121)
    want = np.array([np.asarray(jf(jnp.asarray(s, jnp.int32)))
                     for s in steps])
    got = np.array([tf(torch.tensor(s, dtype=torch.int32)).numpy()
                    for s in steps])
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    if sched == "warmup_cosine":  # the twin test's own points
        assert float(tf(torch.tensor(0))) == 0.0
        assert float(tf(torch.tensor(10))) == pytest.approx(1.0, abs=0.02)
        assert float(tf(torch.tensor(100))) == pytest.approx(0.0, abs=1e-6)
        assert float(tf(torch.tensor(5))) == pytest.approx(0.5, abs=1e-6)


@given(st.lists(st.floats(-100, 100, allow_nan=False, width=32,
                          allow_subnormal=False), min_size=1, max_size=16),
       st.floats(0.1, 10.0))
@settings(max_examples=50, **SETTINGS)
def test_clip_by_global_norm_matches_jax(vals, max_norm):
    """No subnormal draws: XLA flushes them, torch keeps them."""
    x = np.asarray(vals, np.float32)
    jc, jn = jopt.clip_by_global_norm({"x": jnp.asarray(x)}, max_norm)
    tc, tn = topt.clip_by_global_norm({"x": torch.from_numpy(x)}, max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(tc["x"].numpy(), np.asarray(jc["x"]),
                               rtol=1e-5, atol=1e-30)
    assert float(topt.global_norm(tc)) <= max_norm * (1 + 1e-4) + 1e-6


@given(st.lists(st.floats(-2.0**-126, 2.0**-126, allow_nan=False,
                          width=32, allow_subnormal=True), min_size=1, max_size=16),
       st.floats(0.1, 10.0))
@settings(max_examples=50, **SETTINGS)
def test_clip_by_global_norm_is_a_no_op_on_subnormals(vals, max_norm):
    """Port only: tiny and subnormal grads sit far under any limit; the
    clip leaves them as they are (atol 1e-45, one subnormal step)."""
    x = torch.tensor(vals, dtype=torch.float32)
    clipped, norm = topt.clip_by_global_norm({"x": x}, max_norm)
    assert float(norm) <= max_norm
    np.testing.assert_allclose(clipped["x"].numpy(), x.numpy(), rtol=1e-5,
                               atol=1e-45)


# --------------------------------------------------------------------------
# checkpointing
# --------------------------------------------------------------------------
def _tree(rng):
    return {
        "params": {"w": rng.normal(size=(4, 3)).astype(np.float32),
                   "b": rng.normal(size=(3,)).astype(np.float32)},
        "opt": {"m": [rng.normal(size=(2,)).astype(np.float32)]},
        "step": np.asarray(7),
    }


def _bf16_tree(rng):
    """The JAX test's bf16 tree, as numpy (ml_dtypes) leaves."""
    tree = {"w": jnp.asarray(rng.normal(size=(16, 8)), jnp.bfloat16),
            "v": jnp.asarray(rng.normal(size=(4,)), jnp.float32)}
    return jax.tree.map(np.asarray, tree)


def _port_bf16(host):
    return {"w": torch.from_numpy(host["w"].view(np.int16).copy()).view(
        torch.bfloat16), "v": torch.from_numpy(host["v"].copy())}


def test_checkpoint_roundtrip(tmp_path, rng):
    tree = _t(_tree(rng))
    tck.save(str(tmp_path), 7, tree, metadata={"note": "hi"})
    restored, meta = tck.load(str(tmp_path), like=tree)
    assert meta["note"] == "hi"
    for a, b in zip(ttree.leaves(tree), ttree.leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    flat, _ = tck.load(str(tmp_path))
    assert sorted(flat) == ["opt/m/0", "params/b", "params/w", "step"]
    on_cpu, _ = tck.load(str(tmp_path), like=tree, device_tree=ttree.tree_map(
        lambda _: torch.device("cpu"), tree))
    assert torch.equal(on_cpu["params"]["w"], tree["params"]["w"])


def test_checkpoint_bf16_roundtrip(tmp_path, rng):
    """bfloat16 leaves are stored as uint16 views and come back as
    ``torch.bfloat16``, bit for bit."""
    tree = _port_bf16(_bf16_tree(rng))
    tck.save(str(tmp_path), 0, tree)
    restored, _ = tck.load(str(tmp_path), like=tree)
    assert restored["w"].dtype == torch.bfloat16
    assert torch.equal(restored["w"].view(torch.int16),
                       tree["w"].view(torch.int16))
    with np.load(tmp_path / "step_0" / "arrays.npz") as npz:
        assert npz["w"].dtype == np.uint16


def test_checkpoint_keep_k_gc(tmp_path, rng):
    tree = _t(_tree(rng))
    for s in range(6):
        tck.save(str(tmp_path), s, tree, keep=3)
    assert tck.all_steps(str(tmp_path)) == [3, 4, 5]
    assert tck.latest_step(str(tmp_path)) == 5
    assert tck.all_steps(str(tmp_path / "none")) == []
    with pytest.raises(tck.CheckpointError, match="no checkpoints"):
        tck.load(str(tmp_path / "none"))


def _corrupt(path):
    arrays = os.path.join(path, "arrays.npz")
    raw = bytearray(open(arrays, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(arrays, "wb").write(bytes(raw))


def test_checkpoint_corruption_detected(tmp_path, rng):
    tree = _t(_tree(rng))
    _corrupt(tck.save(str(tmp_path), 1, tree))
    with pytest.raises(tck.CheckpointError, match="CRC"):
        tck.load(str(tmp_path), 1, like=tree)


def test_checkpoint_missing_key_detected(tmp_path, rng):
    tree = _t(_tree(rng))
    tck.save(str(tmp_path), 1, tree)
    bigger = dict(tree, extra=torch.zeros(3))
    with pytest.raises(tck.CheckpointError, match="missing"):
        tck.load(str(tmp_path), 1, like=bigger)


def test_async_checkpointer(tmp_path, rng):
    tree = _t(_tree(rng))
    saver = tck.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        saver.save(s, tree)
    tree["params"]["w"].add_(1.0)  # after the call: not in step 3
    saver.wait()
    assert tck.all_steps(str(tmp_path)) == [2, 3]
    restored, _ = tck.load(str(tmp_path), 3, like=tree)
    assert torch.equal(restored["params"]["w"] + 1.0, tree["params"]["w"])


def test_async_checkpointer_surfaces_worker_error(tmp_path, rng):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver = tck.AsyncCheckpointer(str(blocker), keep=2)
    saver.save(1, _t(_tree(rng)))
    with pytest.raises(OSError):
        saver.wait()
    saver.wait()  # the error is raised once


def _npz(path) -> list[tuple[str, np.ndarray]]:
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        return [(k, npz[k]) for k in npz.files]


@pytest.mark.parametrize("kind", ["tree", "bf16"])
def test_checkpoint_arrays_and_manifest_equal_jax(tmp_path, rng, kind):
    """The same tree saved by both packages: ``arrays.npz`` holds the same
    keys in the same order and byte-equal arrays; the manifests decode
    equal but for the CRC (the zip stamps its write time); the port's
    codec gives msgpack's bytes for the JAX manifest."""
    host = _tree(rng) if kind == "tree" else _bf16_tree(rng)
    port = _t(host) if kind == "tree" else _port_bf16(host)
    meta = {"note": "hi", "wall_time": 1.5, "final": True, "n": None,
            "k": [1, -2, 300]}
    jpath = jck.save(str(tmp_path / "j"), 3, host, meta)
    tpath = tck.save(str(tmp_path / "t"), 3, port, meta)
    ja, ta = _npz(jpath), _npz(tpath)
    assert [k for k, _ in ja] == [k for k, _ in ta]
    for (_, a), (_, b) in zip(ja, ta):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    jm = open(os.path.join(jpath, "manifest.msgpack"), "rb").read()
    tm = open(os.path.join(tpath, "manifest.msgpack"), "rb").read()
    jd, td = msgpack.unpackb(jm), _msgpack.unpackb(tm)
    assert td == msgpack.unpackb(tm)
    assert _msgpack.unpackb(jm) == jd
    assert _msgpack.packb(jd) == jm
    jd.pop("crc32"), td.pop("crc32")
    assert jd == td


def _save_four(save, directory, tree):
    for s in range(4):
        save(directory, s, tree, keep=3)


def test_jax_checkpoints_load_in_the_port(tmp_path, rng):
    """JAX-saved checkpoints (plain, bf16, keep-k, corrupt, missing key)
    read by the port's ``load(like=...)``."""
    host = _tree(rng)
    jck.save(str(tmp_path / "a"), 7, host, metadata={"note": "hi"})
    got, meta = tck.load(str(tmp_path / "a"), like=_t(host))
    assert meta == {"note": "hi"}
    for a, b in zip(jax.tree.leaves(host), ttree.leaves(got)):
        assert np.array_equal(a, b.numpy()) and a.dtype == b.numpy().dtype
    bf = _bf16_tree(rng)
    jck.save(str(tmp_path / "b"), 0, bf)
    got, _ = tck.load(str(tmp_path / "b"), like=_port_bf16(bf))
    assert got["w"].dtype == torch.bfloat16
    assert np.array_equal(got["w"].view(torch.int16).numpy().view(np.uint16),
                          bf["w"].view(np.uint16))
    _save_four(jck.save, str(tmp_path / "c"), host)
    assert tck.all_steps(str(tmp_path / "c")) == [1, 2, 3]
    _corrupt(jck.save(str(tmp_path / "d"), 1, host))
    with pytest.raises(tck.CheckpointError, match="CRC"):
        tck.load(str(tmp_path / "d"), 1, like=_t(host))
    with pytest.raises(tck.CheckpointError, match="missing"):
        tck.load(str(tmp_path / "a"), like=dict(_t(host), extra=torch.zeros(3)))


def test_port_checkpoints_load_in_jax(tmp_path, rng):
    """Port-saved checkpoints (plain, bf16, keep-k, corrupt, missing key)
    read by the JAX package's ``load(like=...)``."""
    host = _tree(rng)
    tck.save(str(tmp_path / "a"), 7, _t(host), metadata={"note": "hi"})
    got, meta = jck.load(str(tmp_path / "a"), like=host)
    assert meta == {"note": "hi"}
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(got)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    bf = _bf16_tree(rng)
    tck.save(str(tmp_path / "b"), 0, _port_bf16(bf))
    got, _ = jck.load(str(tmp_path / "b"), like=bf)
    assert got["w"].dtype == bf["w"].dtype
    assert np.array_equal(got["w"].view(np.uint16), bf["w"].view(np.uint16))
    _save_four(tck.save, str(tmp_path / "c"), _t(host))
    assert jck.all_steps(str(tmp_path / "c")) == [1, 2, 3]
    _corrupt(tck.save(str(tmp_path / "d"), 1, _t(host)))
    with pytest.raises(jck.CheckpointError, match="CRC"):
        jck.load(str(tmp_path / "d"), 1, like=host)
    with pytest.raises(jck.CheckpointError, match="missing"):
        jck.load(str(tmp_path / "a"), like=dict(host, extra=np.zeros(3)))


def test_adam_state_checkpoint_crosses_both_ways(tmp_path, rng):
    """An Adam state of the JAX package, carried with ``convert.adam_state``
    and through either package's checkpoint, continues the same updates."""
    params = [rng.normal(size=(5, 3)).astype(np.float32),
              rng.normal(size=(3, 2)).astype(np.float32)]
    jo, to = jopt.adam(1e-2), topt.adam(1e-2)
    js = jo.init([jnp.asarray(p) for p in params])
    g = [jnp.asarray(rng.normal(size=p.shape).astype(np.float32))
         for p in params]
    _, js = jo.update(g, js)
    host = jax.tree.map(np.asarray, {"params": params, "opt": js})
    ts = convert.adam_state(host["opt"])
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 1
    jck.save(str(tmp_path / "j"), 1, host)
    tree = {"params": convert.snn_params(params), "opt": ts}
    loaded, _ = tck.load(str(tmp_path / "j"), like=tree)
    tck.save(str(tmp_path / "t"), 1, loaded)
    back, _ = jck.load(str(tmp_path / "t"), like=host)
    g2 = [rng.normal(size=p.shape).astype(np.float32) for p in params]
    ju, _ = jo.update([jnp.asarray(x) for x in g2], back["opt"])
    tu, _ = to.update([torch.from_numpy(x) for x in g2], loaded["opt"])
    for a, b in zip(ju, tu):
        assert np.array_equal(np.asarray(a), b.numpy())


@given(st.recursive(
    st.none() | st.booleans() | st.integers(-2**63, 2**64 - 1)
    | st.floats(allow_nan=False) | st.text(max_size=40)
    | st.binary(max_size=300),
    lambda kids: st.lists(kids, max_size=20)
    | st.dictionaries(st.text(max_size=8), kids, max_size=20),
    max_leaves=60))
@settings(max_examples=150, **SETTINGS)
def test_msgpack_codec_matches_msgpack(obj):
    """The port's codec writes msgpack's bytes and reads them back."""
    packed = _msgpack.packb(obj)
    assert packed == msgpack.packb(obj)
    assert _msgpack.unpackb(packed) == msgpack.unpackb(packed)


def test_msgpack_codec_refuses_outside_the_subset():
    with pytest.raises(TypeError):
        _msgpack.packb({"x": object()})
    with pytest.raises(ValueError, match="0xd4"):
        _msgpack.unpackb(bytes([0xD4, 1, 2]))
    with pytest.raises(ValueError, match="truncated"):
        _msgpack.unpackb(msgpack.packb("abcdef")[:-1])
    with pytest.raises(ValueError, match="extra"):
        _msgpack.unpackb(msgpack.packb(1) + b"\x00")
    assert _msgpack.unpackb(bytes([0xCA]) + np.float32(1.5).tobytes()[::-1]
                            ) == 1.5


# --------------------------------------------------------------------------
# fault-tolerant loop: preemption -> restart gives the same trajectory
# --------------------------------------------------------------------------
def _loop_pieces():
    def step_fn(state, batch):
        w = state["w"] - 0.1 * (state["w"] - batch)
        return dict(state, w=w), {"loss": float(torch.sum((w - batch) ** 2))}

    def batch_fn(step):
        return torch.tensor(float(step % 5))

    return step_fn, batch_fn


def test_preemption_resume_exact(tmp_path):
    step_fn, batch_fn = _loop_pieces()
    init = {"w": torch.tensor(10.0), "step": 0}
    ref = tloop.run_loop(tloop.LoopConfig(total_steps=20, log_every=0),
                         dict(init), step_fn, batch_fn)
    cfg = tloop.LoopConfig(total_steps=20, checkpoint_dir=str(tmp_path),
                           checkpoint_every=5, log_every=0, fail_at_step=13)
    with pytest.raises(RuntimeError, match="preemption"):
        tloop.run_loop(cfg, dict(init), step_fn, batch_fn)
    assert tck.all_steps(str(tmp_path)) == [5, 10]
    logs = []
    cfg2 = tloop.LoopConfig(total_steps=20, checkpoint_dir=str(tmp_path),
                            checkpoint_every=5, log_every=0)
    out = tloop.run_loop(cfg2, dict(init), step_fn, batch_fn,
                         log_fn=logs.append)
    assert logs == ["[loop] resumed from checkpoint step 10"]
    assert out["step"] == ref["step"] == 20
    assert float(out["w"]) == float(ref["w"])
    # the JAX loop on the same pieces ends at the same weight
    jref = jloop.run_loop(
        jloop.LoopConfig(total_steps=20, log_every=0),
        {"w": jnp.asarray(10.0), "step": 0},
        lambda s, b: (dict(s, w=s["w"] - 0.1 * (s["w"] - b)), {}),
        lambda step: jnp.asarray(float(step % 5)))
    np.testing.assert_allclose(float(out["w"]), float(jref["w"]), rtol=1e-6)
    final, meta = tck.load(str(tmp_path), like=out)
    assert meta == {"final": True} and int(final["step"]) == 20


def test_loop_logs_and_reports_stragglers(tmp_path):
    step_fn, batch_fn = _loop_pieces()
    logs, flagged = [], []
    tloop.run_loop(tloop.LoopConfig(total_steps=4, log_every=2, num_hosts=2),
                   {"w": torch.tensor(1.0), "step": 0}, step_fn, batch_fn,
                   log_fn=logs.append, on_straggler=flagged.append)
    assert [m.split(":")[0] for m in logs] == ["[loop] step 0",
                                               "[loop] step 2"]
    assert "loss=" in logs[0] and flagged == []


# --------------------------------------------------------------------------
# gradient compression
# --------------------------------------------------------------------------
@given(st.integers(0, 1000))
@settings(max_examples=25, **SETTINGS)
def test_topk_error_feedback_conserves_signal_and_matches_jax(seed):
    rng = np.random.default_rng(seed)
    g = {"a": rng.normal(size=(8, 8)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32)}
    comp = tcomp.TopKCompressor(fraction=0.25)
    tg = _t(g)
    err = comp.init_error(tg)
    sparse, new_err = comp.compress(tg, err)
    dec = comp.decompress(sparse, ttree.tree_map(lambda x: x.shape, tg))
    for k in g:
        np.testing.assert_allclose(dec[k].numpy() + new_err[k].numpy(),
                                   g[k], atol=1e-6)
    jc = jcomp.TopKCompressor(fraction=0.25)
    jg = jax.tree.map(jnp.asarray, g)
    jsparse, jerr = jc.compress(jg, jc.init_error(jg))
    for k in g:
        assert np.array_equal(sparse[k]["indices"].numpy(),
                              np.asarray(jsparse[k]["indices"]))
        assert np.array_equal(sparse[k]["values"].numpy(),
                              np.asarray(jsparse[k]["values"]))
        assert np.array_equal(new_err[k].numpy(), np.asarray(jerr[k]))
    assert comp.wire_bytes(sparse) == jc.wire_bytes(jsparse) < sum(
        x.size * 4 for x in g.values())


@pytest.mark.parametrize("seed", [0, 1, 2**32 - 1])
def test_int8_compressor_equals_jax(seed):
    """Same grads and key: ``q`` and ``scale`` byte-equal to JAX's (the
    rounding noise is the port's threefry), the decompressed grads too,
    and the error bound and wire bytes of ``tests/test_training.py``."""
    rng = np.random.default_rng(seed % 1000)
    g = {"w": rng.normal(size=(64, 64)).astype(np.float32),
         "b": [rng.normal(size=(7,)).astype(np.float32) * 1e-3,
               np.zeros((3,), np.float32)]}
    comp = tcomp.Int8Compressor()
    c = comp.compress(_t(g), prng.key(seed))
    jc = jcomp.Int8Compressor().compress(jax.tree.map(jnp.asarray, g),
                                         jax.random.key(seed))
    leaves_t = ttree.leaves(c, is_leaf=lambda x: isinstance(x, dict)
                            and "q" in x)
    leaves_j = jax.tree.leaves(jc, is_leaf=lambda x: isinstance(x, dict)
                               and "q" in x)
    for t, j in zip(leaves_t, leaves_j):
        assert t["q"].dtype == torch.int8
        assert np.array_equal(t["q"].numpy(), np.asarray(j["q"]))
        assert np.array_equal(t["scale"].numpy(), np.asarray(j["scale"]))
    dec = comp.decompress(c)
    jdec = jcomp.Int8Compressor().decompress(jc)
    for a, b in zip(_jnp(jdec), _np(dec)):
        assert np.array_equal(a, b)
    scale = float(c["w"]["scale"])
    err = np.abs(dec["w"].numpy() - g["w"])
    assert err.max() <= scale * 1.01  # stochastic rounding: <= 1 LSB
    assert comp.wire_bytes(c) == jcomp.Int8Compressor().wire_bytes(jc)
    assert comp.wire_bytes(c) < g["w"].size * 4 // 3
