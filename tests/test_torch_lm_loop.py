"""LM data, the training loop and launcher, and the recurrent archs'
train step, of the port against the JAX package, on the CPU.

* ``data/lm``: ``TokenStream.sample``, ``_hash_next`` and
  ``lm_batches`` byte-equal to JAX's over vocabularies, shapes, steps
  and shards; ``tests/test_data.py``'s stream properties on the port.
* ``tests/test_system.py``'s LM loop on the port: two-layer
  granite-3-2b (float32, JAX's params with the constant leaves
  randomized) through ``run_loop`` with AdamW; a run preempted at step 5
  and resumed from its step-3 checkpoint ends on the uninterrupted run's
  params (atol 1e-5), and the 8 losses equal JAX's run of the same loop
  to rtol 1e-4; the loss falls on the structured stream (bf16, as JAX's
  test).
* ``python -m repro_torch.launch.train --device cpu``: a run stopped by
  ``--fail-at-step`` and run again resumes and ends on the uninterrupted
  run's params; its ``[train]`` header is the JAX launcher's.
* ``LMHarness.make_train_step`` for zamba2-1.2b and rwkv6-7b against
  JAX's (the cases of ``tests/test_torch_lm_train.py``), and the remat
  of zamba2 (its Mamba scans) and whisper (its encoder and decoder
  layers) equal to the plain run.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import lm as jlm  # noqa: E402
from repro.launch.steps import LMHarness as JHarness  # noqa: E402
from repro.training import loop as jloop  # noqa: E402
from repro.training import optimizers as jopt  # noqa: E402
from repro_torch import checkpoint as tckpt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.data import lm as tlm  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.launch.steps import LMHarness  # noqa: E402
from repro_torch.training import loop as tloop  # noqa: E402
from repro_torch.training import optimizers as topt  # noqa: E402
from repro_torch.tree import leaves, tree_map, unflatten  # noqa: E402

from test_torch_lm_train import (  # noqa: E402,F401
    FAST_XLA,
    check_remat_equals_plain,
    check_train_step_matches_jax,
    jax_params,
    one_torch_thread,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECURRENT = ["zamba2-1.2b", "rwkv6-7b"]


# --------------------------------------------------------------------------
# data/lm
# --------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,seed,structure", [
    (101, 2, 0.8), (49155, 0, 0.8), (97, 0, 1.0), (256, 7, 0.3)])
def test_token_stream_is_jaxs_byte_for_byte(vocab, seed, structure):
    j = jlm.TokenStream(vocab, seed=seed, structure=structure)
    t = tlm.TokenStream(vocab, seed=seed, structure=structure)
    assert np.array_equal(j.probs, t.probs)
    for batch, seq, step, shard, shards in [(4, 32, 0, 0, 1),
                                            (3, 17, 5, 1, 4),
                                            (8, 1, 123, 3, 4)]:
        a = j.sample(batch, seq, step, shard, shards)
        b = t.sample(batch, seq, step, shard, shards)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(j._hash_next(a[:, 1], a[:, 0]),
                              t._hash_next(b[:, 1], b[:, 0]))


def test_lm_batches_are_jaxs_byte_for_byte():
    kw = dict(seed=3, start_step=2, shard_index=1, num_shards=2)
    got = list(tlm.lm_batches(300, 4, 24, 6, **kw))
    want = list(jlm.lm_batches(300, 4, 24, 6, **kw))
    assert len(got) == len(want) == 4
    for (s, toks, tgts), (js, jtoks, jtgts) in zip(got, want):
        assert s == js and toks.dtype == jtoks.dtype == np.int32
        assert np.array_equal(toks, jtoks) and np.array_equal(tgts, jtgts)


def test_lm_stream_properties():
    """``tests/test_data.py::test_lm_stream_properties`` on the port."""
    vocab = 101
    got = list(tlm.lm_batches(vocab, 4, 32, 3, seed=2))
    assert len(got) == 3
    for _, toks, tgts in got:
        assert toks.shape == (4, 32) and tgts.shape == (4, 32)
        assert toks.min() >= 0 and toks.max() < vocab
        np.testing.assert_array_equal(toks[:, 1:], tgts[:, :-1])
    resumed = list(tlm.lm_batches(vocab, 4, 32, 3, seed=2, start_step=2))
    np.testing.assert_array_equal(got[2][1], resumed[0][1])


def test_lm_stream_is_learnable():
    """``tests/test_data.py::test_lm_stream_is_learnable`` on the port."""
    stream = tlm.TokenStream(97, seed=0, structure=1.0)
    toks = stream.sample(2, 64, step=0)
    nxt = stream._hash_next(toks[:, 1:-1].ravel(), toks[:, :-2].ravel())
    assert (nxt == toks[:, 2:].ravel()).mean() == 1.0


# --------------------------------------------------------------------------
# the loop (tests/test_system.py)
# --------------------------------------------------------------------------
def _two_layer_granite():
    jcfg = dataclasses.replace(jconfigs.get_arch("granite-3-2b").REDUCED,
                               n_layers=2, dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.get_arch("granite-3-2b").REDUCED,
                               n_layers=2, dtype=torch.float32)
    return (JHarness("granite-3-2b", cfg=jcfg),
            LMHarness("granite-3-2b", cfg=tcfg))


def _port_step(model, opt):
    def step_fn(state, batch):
        params = state["params"]
        live = [p.detach().requires_grad_() for p in leaves(params)]
        loss, _ = model.loss(unflatten(params, live), batch)
        grads = unflatten(params, list(torch.autograd.grad(loss, live)))
        with torch.no_grad():
            updates, o = opt.update(grads, state["opt"], params)
            params = topt.apply_updates(params, updates)
        return dict(state, params=params, opt=o), {"loss": loss.detach()}
    return step_fn


def test_lm_train_loop_with_preemption(tmp_path):
    """``tests/test_system.py::test_lm_train_loop_with_preemption`` on the
    port, in float32 on JAX's params: preempted at step 5, resumed from
    the step-3 checkpoint, the params end where the uninterrupted run's
    do; the 8 losses are JAX's loop's."""
    jh, th = _two_layer_granite()
    jp, tp = jax_params(jh, 0)
    stream = tlm.TokenStream(th.cfg.vocab_size, seed=0)

    def batch_fn(step):
        toks = torch.from_numpy(stream.sample(4, 16, step).astype(np.int32))
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def state0():
        return {"params": tree_map(torch.clone, tp), "opt": th.opt.init(tp),
                "step": np.asarray(0)}

    losses = []
    step_fn = _port_step(th.model, th.opt)

    def logged(state, batch):
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        return state, m

    ref = tloop.run_loop(tloop.LoopConfig(total_steps=8, log_every=0),
                         state0(), logged, batch_fn)
    with pytest.raises(RuntimeError):
        tloop.run_loop(tloop.LoopConfig(
            total_steps=8, checkpoint_dir=str(tmp_path), checkpoint_every=3,
            log_every=0, fail_at_step=5), state0(), step_fn, batch_fn)
    out = tloop.run_loop(tloop.LoopConfig(
        total_steps=8, checkpoint_dir=str(tmp_path), checkpoint_every=3,
        log_every=0), state0(), step_fn, batch_fn)
    for a, b in zip(leaves(ref["params"]), leaves(out["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)

    model, opt = jh.model, jh.opt

    def jstep(params, opt_state, batch):
        (loss, _), grads = jax.value_and_grad(
            model.loss, has_aux=True)(params, batch)
        updates, opt_state = opt.update(grads, opt_state, params)
        return jopt.apply_updates(params, updates), opt_state, loss

    jstream = jlm.TokenStream(jh.cfg.vocab_size, seed=0)

    def jbatch_fn(step):
        toks = jstream.sample(4, 16, step)
        return {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
                "targets": jnp.asarray(toks[:, 1:], jnp.int32)}

    jstep = jax.jit(jstep).lower(jp, opt.init(jp), jbatch_fn(0)).compile(
        compiler_options=FAST_XLA)
    jlosses = []

    def jstep_fn(state, batch):
        p, o, loss = jstep(state["params"], state["opt"], batch)
        jlosses.append(float(loss))
        return dict(state, params=p, opt=o), {"loss": loss}

    jloop.run_loop(jloop.LoopConfig(total_steps=8, log_every=0),
                   {"params": jp, "opt": opt.init(jp), "step": np.asarray(0)},
                   jstep_fn, jbatch_fn)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)


def test_lm_loss_decreases_on_structured_stream():
    """``tests/test_system.py::test_lm_loss_decreases_on_structured_stream``
    on the port (bf16, two layers, vocab 128, AdamW 3e-3, 64 steps)."""
    cfg = dataclasses.replace(tconfigs.get_arch("granite-3-2b").REDUCED,
                              n_layers=2, vocab_size=128)
    h = LMHarness("granite-3-2b", cfg=cfg)
    opt = topt.adamw(3e-3)
    state = {"params": h.model.init(1, device="cpu")}
    state["opt"] = opt.init(state["params"])
    step_fn = _port_step(h.model, opt)
    losses = []
    for _, toks, tgts in tlm.lm_batches(cfg.vocab_size, 8, 32, 64, seed=5):
        state, m = step_fn(state, {"tokens": torch.from_numpy(toks),
                                   "targets": torch.from_numpy(tgts)})
        losses.append(float(m["loss"]))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
def test_train_launcher_restarts_across_fail_at_step(tmp_path, capsys):
    args = ["--device", "cpu", "--steps", "8", "--batch", "4", "--seq",
            "16", "--log-every", "1"]
    ref = ttrain.main(args)
    header = capsys.readouterr().out.splitlines()[0]
    n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(
        JHarness("granite-3-2b",
                 cfg=jconfigs.get_arch("granite-3-2b").REDUCED)
        .param_shapes()))
    assert header == (f"[train] arch=granite-3-2b params={n/1e6:.1f}M "
                      f"batch=4 seq=16")
    ck = ["--checkpoint-dir", str(tmp_path), "--checkpoint-every", "3"]
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "repro_torch.launch.train"] + args + ck
    first = subprocess.run(cmd + ["--fail-at-step", "5"], env=env,
                           capture_output=True, text=True, timeout=300)
    assert first.returncode != 0
    assert "simulated preemption at step 5" in first.stderr
    again = subprocess.run(cmd, env=env, capture_output=True, text=True,
                           timeout=300)
    assert again.returncode == 0, again.stderr[-2000:]
    assert "[loop] resumed from checkpoint step 3" in again.stdout
    assert again.stdout.rstrip().endswith("[train] done at step 8")
    final, meta = tckpt.load(str(tmp_path), 8, like=ref)
    assert meta == {"final": True}
    for a, b in zip(leaves(ref["params"]), leaves(final["params"])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=1e-5)


# --------------------------------------------------------------------------
# the recurrent archs' train step and remat
# --------------------------------------------------------------------------
@pytest.mark.parametrize("micro_rows", [1, 2])
@pytest.mark.parametrize("arch", RECURRENT)
def test_train_step_matches_jax(arch, micro_rows):
    check_train_step_matches_jax(arch, micro_rows)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-large-v3"])
def test_remat_same_loss_and_grads(arch):
    check_remat_equals_plain(arch, "nothing")
