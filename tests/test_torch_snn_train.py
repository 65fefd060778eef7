"""SNN training and the paper's HW-vs-SW evaluation in the port, against
the JAX package (:mod:`repro.snn`), on the same numpy inputs.

* The surrogate spike, the training LIF step, the spiking MLP's forward,
  the loss gradients and one train step are held against JAX's on
  JAX-initialised params. Float paths are not byte-equal across the two
  frameworks (the matmul sums in another order); the tolerances are
  stated in each test.
* ``to_snnetwork`` is byte-equal; the hardware half of ``evaluate_dual``
  (counts, predictions, accuracy, cycles, SOPs) is byte-equal to JAX's on
  ``"reference"`` and on ``"cuda"`` (the kernel's plain version on the
  CPU); JAX runs ``"reference"``.
* The port's own training meets the margins of
  ``tests/test_snn_train.py`` (hidden 32, T 10, batch 64, 140 steps) and
  resumes exactly; the data-parallel step on 1, 2 and 4 shards of the
  CPU matches the unsharded step.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_lm_train import one_torch_thread  # noqa: E402,F401

from repro.configs import snap_v_snn as jcfgs  # noqa: E402
from repro.core import cerebra_h as jch  # noqa: E402
from repro.core import coding as jcoding  # noqa: E402
from repro.core import lif as jlif  # noqa: E402
from repro.core import software as jsw  # noqa: E402
from repro.snn import model as jm  # noqa: E402
from repro.snn import train as jt  # noqa: E402
from repro.training import optimizers as jopt  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import snap_v_snn as tcfgs  # noqa: E402
from repro_torch.core import coding as tcoding  # noqa: E402
from repro_torch.core import lif as tlif  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import software as tsw  # noqa: E402
from repro_torch.data import mnist  # noqa: E402
from repro_torch.snn import model as tm  # noqa: E402
from repro_torch.snn import train as tt  # noqa: E402
from repro_torch.training import optimizers as topt  # noqa: E402

# gradient agreement: |g_port - g_jax| <= GRAD_RTOL * |g_jax| + GRAD_RTOL *
# max|g_jax| per leaf (max |diff| / max |g| measured <= 2.2e-5; elementwise
# rtol alone fails on entries that are sums cancelling to ~0)
GRAD_RTOL = 1e-4
# the software half's predictions, port against JAX (1.0 measured)
SW_PRED_AGREE_MIN = 0.99


def _lif(reset="zero", decay=0.1):
    return (jlif.LIFParams(decay_rate=decay, reset_mode=reset),
            tlif.LIFParams(decay_rate=decay, reset_mode=reset))


def _cfgs(hidden=32, T=10, steps=140, reset="zero"):
    jl, tl = _lif(reset)
    kw = dict(num_steps_time=T, lr=3e-3, batch_size=64, train_steps=steps)
    return (jt.TrainConfig(model=jm.SNNModelConfig(
                layer_sizes=(784, hidden, 10), params=jl), **kw),
            tt.TrainConfig(model=tm.SNNModelConfig(
                layer_sizes=(784, hidden, 10), params=tl), **kw))


def _jax_params(seed, jcfg):
    return [np.asarray(w) for w in jm.init_params(jax.random.key(seed),
                                                  jcfg.model)]


def _spikes(seed, x, T):
    return np.asarray(jcoding.poisson_encode(jax.random.key(seed),
                                             jnp.asarray(x), T))


# --------------------------------------------------------------------------
# the neuron
# --------------------------------------------------------------------------
@pytest.mark.parametrize("slope", [25.0, 1.0, 0.37])
def test_surrogate_spike_forward_and_backward_match_jax(slope):
    """Forward ``(v >= 0)`` and backward ``g / (1 + slope |v|)^2`` against
    ``jax.vjp`` of JAX's, with ``v`` exactly at threshold (0, -0) and
    around it: spikes equal, gradients equal; no gradient for ``slope``."""
    rng = np.random.default_rng(int(slope * 100))
    v = np.concatenate([[0.0, -0.0, 1e-7, -1e-7, 1e-30, -3.0, 40.0],
                        rng.normal(0, 2, 200)]).astype(np.float32)
    g = rng.normal(0, 1, v.shape).astype(np.float32)
    jout, vjp = jax.vjp(lambda x: jlif.surrogate_spike(x, slope),
                        jnp.asarray(v))
    (jg,) = vjp(jnp.asarray(g))
    tv = torch.from_numpy(v).requires_grad_(True)
    tout = tlif.surrogate_spike(tv, slope)
    (tg,) = torch.autograd.grad(tout, tv, torch.from_numpy(g))
    assert tout.dtype == torch.float32
    assert np.array_equal(tout.detach().numpy(), np.asarray(jout))
    assert tout[0] == 1.0 and tout[1] == 1.0
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=0)
    assert tg[0] == g[0]  # at threshold the surrogate passes g through


@pytest.mark.parametrize("reset", ["zero", "subtract", "hold"])
def test_lif_step_train_matches_jax(reset):
    """Two chained training LIF steps: spikes equal, ``v`` allclose (rtol
    1e-6; equal measured), gradients of a weighted sum of spikes and
    ``v`` w.r.t. the input and the first ``v`` allclose (rtol 1e-5); the
    reset gate carries no gradient, as JAX's ``stop_gradient``."""
    jl, tl = _lif(reset, decay=0.25)
    rng = np.random.default_rng(3)
    v0 = rng.normal(0.5, 0.6, (6, 40)).astype(np.float32)
    syn = rng.normal(0.3, 0.7, (2, 6, 40)).astype(np.float32)
    wv, ws = rng.normal(size=(2, 6, 40)).astype(np.float32)

    def jrun(v, s):
        st_, spk1 = jlif.lif_step_train({"v": v}, s[0], jl, 7.0)
        st_, spk2 = jlif.lif_step_train(st_, s[1], jl, 7.0)
        return jnp.sum(st_["v"] * wv) + jnp.sum((spk1 + spk2) * ws), (
            st_["v"], spk1 + spk2)

    (jloss, (jv, jspk)), jgrads = jax.value_and_grad(
        jrun, argnums=(0, 1), has_aux=True)(jnp.asarray(v0), jnp.asarray(syn))
    tv0 = torch.from_numpy(v0).requires_grad_(True)
    tsyn = torch.from_numpy(syn).requires_grad_(True)
    st_, spk1 = tlif.lif_step_train({"v": tv0}, tsyn[0], tl, 7.0)
    st_, spk2 = tlif.lif_step_train(st_, tsyn[1], tl, 7.0)
    loss = (torch.sum(st_["v"] * torch.from_numpy(wv))
            + torch.sum((spk1 + spk2) * torch.from_numpy(ws)))
    tgrads = torch.autograd.grad(loss, (tv0, tsyn))
    assert np.array_equal((spk1 + spk2).detach().numpy(), np.asarray(jspk))
    np.testing.assert_allclose(st_["v"].detach().numpy(), np.asarray(jv),
                               rtol=1e-6, atol=1e-7)
    for a, b in zip(jgrads, tgrads):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)
    assert isinstance(tlif.LIFState, type)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------
def test_init_params_and_model_config_match_jax():
    """``init_params`` draws JAX's params to rtol 1e-6 (the normals,
    :func:`prng.normal`); ``model_config`` equals JAX's."""
    for hidden in (16, 256):
        jc, tc = jcfgs.model_config(hidden), tcfgs.model_config(hidden)
        assert tc.layer_sizes == jc.layer_sizes == (784, hidden, 10)
        assert (tc.params.decay_rate, tc.params.threshold,
                tc.params.reset_mode) == (jc.params.decay_rate,
                                          jc.params.threshold,
                                          jc.params.reset_mode)
        assert (tc.surrogate_slope, tc.weight_clip) == (jc.surrogate_slope,
                                                        jc.weight_clip)
        for seed in (0, 5):
            want = _jax_params(seed, jt.TrainConfig(model=jc))
            got = tm.init_params(seed, tc, device="cpu")
            for a, b in zip(want, got):
                assert b.dtype == torch.float32 and b.shape == a.shape
                np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=0)


@pytest.mark.parametrize("hidden,T,seed", [(32, 10, 0), (64, 8, 2)])
def test_forward_matches_jax_on_jax_params(hidden, T, seed):
    """JAX-initialised params, JAX-encoded spikes: output spikes, counts
    and the hidden total equal on these seeds (a spike could flip only
    where the two summation orders round across the threshold)."""
    jcfg, tcfg = _cfgs(hidden, T)
    params = _jax_params(seed, jcfg)
    x, _ = mnist.load_or_generate("train", 64, seed=seed)
    spikes = _spikes(seed + 5, x, T)
    jo = jm.forward([jnp.asarray(w) for w in params], jnp.asarray(spikes),
                    jcfg.model)
    to = tm.forward(convert.snn_params(params), torch.from_numpy(spikes),
                    tcfg.model)
    assert np.array_equal(to["output_spikes"].detach().numpy(),
                          np.asarray(jo["output_spikes"]))
    assert np.array_equal(to["output_counts"].detach().numpy(),
                          np.asarray(jo["output_counts"]))
    assert float(to["hidden_spike_total"]) == float(jo["hidden_spike_total"])
    assert float(jo["hidden_spike_total"]) > 0


def test_forward_output_shapes():
    cfg = tm.SNNModelConfig(layer_sizes=(12, 8, 6, 4))
    params = tm.init_params(0, cfg, device="cpu")
    out = tm.forward(params, torch.zeros((6, 3, 12)), cfg)
    assert out["output_counts"].shape == (3, 4)
    assert out["output_spikes"].shape == (6, 3, 4)
    assert out["hidden_spike_total"].shape == ()


@pytest.mark.parametrize("reset", ["zero", "subtract"])
def test_loss_gradients_match_jax(reset):
    """``loss_fn``'s value (rtol 1e-6) and gradients (GRAD_RTOL) on
    JAX-initialised params and JAX's spikes."""
    jcfg, tcfg = _cfgs(32, 10, reset=reset)
    for seed in (0, 1):
        params = _jax_params(seed, jcfg)
        x, y = mnist.load_or_generate("train", 64, seed=seed)
        spikes = _spikes(seed + 5, x, 10)
        (jl, jmet), jg = jax.value_and_grad(jt.loss_fn, has_aux=True)(
            [jnp.asarray(w) for w in params], jnp.asarray(spikes),
            jnp.asarray(y), jcfg)
        leaves = [w.requires_grad_(True) for w in convert.snn_params(params)]
        tl, tmet = tt.loss_fn(leaves, torch.from_numpy(spikes),
                              torch.from_numpy(y), tcfg)
        tg = torch.autograd.grad(tl, leaves)
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-6)
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=1e-6)
        assert float(tmet["acc"]) == float(jmet["acc"])
        for a, b in zip(jg, tg):
            a = np.asarray(a)
            np.testing.assert_allclose(b.numpy(), a, rtol=GRAD_RTOL,
                                       atol=GRAD_RTOL * np.abs(a).max())


def _first_step_bound(m, lr, eps=1e-8):
    """How far apart two Adam first steps ``p - lr * g / (|g| + eps)`` may
    land when their clipped gradients ``g = m / (1 - b1)`` are GRAD_RTOL
    apart: ``lr * min(2, eps * delta / (max(|g| - delta, 0) + eps)^2)``
    with ``delta = GRAD_RTOL * (|g| + max|g|)``, plus one float32 rounding
    of a param in [-1, 1]."""
    g = np.abs(np.asarray(m, np.float64)) / 0.1
    delta = GRAD_RTOL * (g + g.max())
    return lr * np.minimum(2.0, eps * delta / (
        np.maximum(g - delta, 0.0) + eps) ** 2) + 2.0 ** -23


def test_one_train_step_matches_jax():
    """One ``make_train_step`` step from JAX-initialised params with the
    same folded key and batch: the spikes are JAX's, so loss and accuracy
    agree (rtol 1e-6), the grad norm (rtol 1e-5) and the Adam moments as
    the gradients do (GRAD_RTOL). Adam's first update is ``-lr * g / (|g|
    + eps)``, about ``-lr * sign(g)``: each new param lies within
    :func:`_first_step_bound` of JAX's (0.25 of it at worst, measured)."""
    jcfg, tcfg = _cfgs(32, 10)
    params = _jax_params(0, jcfg)
    (_, x, y), = mnist.batches("train", 64, 1, seed=0)
    jopt_, topt_ = jopt.adam(jcfg.lr), topt.adam(tcfg.lr)
    jkey = jax.random.fold_in(jax.random.split(jax.random.key(0))[1], 0)
    tkey = prng.fold_in(prng.split(prng.key(0))[1], 0)
    jp = [jnp.asarray(w) for w in params]
    jnew, jst, jmet = jt.make_train_step(jcfg, jopt_)(
        jp, jopt_.init(jp), jkey, jnp.asarray(x), jnp.asarray(y))
    tp = convert.snn_params(params)
    tnew, tst, tmet = tt.make_train_step(tcfg, topt_)(
        tp, topt_.init(tp), tkey, torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=1e-6)
    assert float(tmet["acc"]) == float(jmet["acc"])
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-5)
    for a, b, m in zip(jnew, tnew, jst["m"]):
        a, b = np.asarray(a), b.numpy()
        assert (np.abs(a - b) <= _first_step_bound(m, tcfg.lr)).all()
    for a, b in zip(jst["m"], tst["m"]):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * np.abs(a).max())
    assert int(tst["step"]) == int(jst["step"]) == 1


def test_to_snnetwork_equals_jax():
    """The same numpy params (some outside the clip) give byte-equal
    weights, slices and LIF parameters in both packages."""
    jcfg, tcfg = _cfgs(16)
    rng = np.random.default_rng(4)
    params = [rng.normal(0, 0.8, (784, 16)).astype(np.float32),
              rng.normal(0, 0.8, (16, 10)).astype(np.float32)]
    jn = jm.to_snnetwork(params, jcfg.model)
    for given in (params, convert.snn_params(params)):
        tn = tm.to_snnetwork(given, tcfg.model)
        assert tn.weights.dtype == jn.weights.dtype
        assert np.array_equal(tn.weights, jn.weights)
        assert (tn.n_inputs, tn.n_neurons, tn.layer_slices,
                tn.output_slice) == (jn.n_inputs, jn.n_neurons,
                                     jn.layer_slices, jn.output_slice)
        assert tn.params.decay_rate == jn.params.decay_rate
    assert np.abs(tn.weights).max() == tcfg.model.weight_clip


def test_to_snnetwork_roundtrip():
    cfg = tm.SNNModelConfig(layer_sizes=(5, 4, 2))
    params = tm.init_params(1, cfg, device="cpu")
    net = tm.to_snnetwork(params, cfg)
    assert net.n_inputs == 5 and net.n_neurons == 6
    assert net.output_slice == (4, 6)
    np.testing.assert_allclose(
        net.weights[:5, :4],
        np.clip(params[0].numpy(), -cfg.weight_clip, cfg.weight_clip))


# --------------------------------------------------------------------------
# the port's own training and the paper's evaluation
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def trained():
    _, cfg = _cfgs()
    data = mnist.batches("train", cfg.batch_size, cfg.train_steps, seed=0)
    params, _, metrics = tt.train(cfg, data, log_every=0, device="cpu")
    return cfg, params, metrics


def _eval_acc(params, cfg, x, y, seed=11):
    spikes = tcoding.poisson_encode(prng.key(seed), torch.from_numpy(x),
                                    cfg.num_steps_time)
    out = tm.forward(params, spikes, cfg.model)
    pred = torch.argmax(out["output_counts"], -1).numpy()
    return float((pred == y).mean())


def test_training_learns(trained):
    """``tests/test_snn_train.py``'s margins on the port's training."""
    cfg, params, metrics = trained
    x, y = mnist.load_or_generate("test", 256, seed=2)
    acc = _eval_acc(params, cfg, x, y)
    base = _eval_acc(tm.init_params(123, cfg.model, device="cpu"), cfg, x, y)
    assert acc > 0.35
    assert acc >= base + 0.20
    assert float(metrics["acc"]) > 0.35


def test_weights_stay_deployable(trained):
    cfg, params, _ = trained
    for w in params:
        assert float(torch.abs(w).max()) <= cfg.model.weight_clip + 1e-6


def test_evaluate_dual_matches_paper_contract(trained):
    cfg, params, _ = trained
    x, y = mnist.load_or_generate("test", 256, seed=1)
    res = tt.evaluate_dual(params, cfg.model, x, y,
                           num_steps_time=cfg.num_steps_time, device="cpu")
    assert res["software_acc"] > 0.3
    assert res["hardware_acc"] > 0.25
    assert abs(res["deviation_pct"]) < 15.0
    assert res["agreement"] > 0.65


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_evaluate_dual_hardware_half_equals_jax(trained, backend):
    """The same params and seed through both packages' ``evaluate_dual``
    (JAX on ``"reference"``): the hardware half's output counts,
    predictions, accuracy, raster, cycles and SOPs byte-equal; the
    software half's predictions agree on at least SW_PRED_AGREE_MIN of
    the examples (all 256 measured)."""
    cfg, params, _ = trained
    host = [w.numpy() for w in params]
    x, y = mnist.load_or_generate("test", 256, seed=1)
    jres = jt.evaluate_dual(host, jt.TrainConfig().model.__class__(
        layer_sizes=cfg.model.layer_sizes, params=_lif()[0]), x, y,
        num_steps_time=cfg.num_steps_time)
    tres = tt.evaluate_dual(params, cfg.model, x, y,
                            num_steps_time=cfg.num_steps_time,
                            backend=backend, device="cpu")
    jhw, thw = jres["hw_counts"], tres["hw_counts"]
    for k in ("output_counts", "spikes", "cycles", "sops", "row_fetches"):
        a, b = np.asarray(jhw[k]), thw[k].numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert np.array_equal(np.argmax(np.asarray(jhw["output_counts"]), -1),
                          torch.argmax(thw["output_counts"], -1).numpy())
    assert tres["hardware_acc"] == jres["hardware_acc"]
    # the software half on the same spikes in both packages
    net_j = jm.to_snnetwork(host, jt.TrainConfig().model.__class__(
        layer_sizes=cfg.model.layer_sizes, params=_lif()[0]))
    spikes = np.asarray(jcoding.poisson_encode(
        jax.random.key(0), jnp.asarray(x), cfg.num_steps_time,
        dtype=jnp.int32))
    tspk = tcoding.poisson_encode(prng.key(0), torch.from_numpy(x),
                                  cfg.num_steps_time, dtype=torch.int32)
    assert np.array_equal(tspk.numpy(), spikes)
    jpred = np.argmax(np.asarray(jsw.run_software(
        net_j, jnp.asarray(spikes, jnp.float32))["output_counts"]), -1)
    tpred = torch.argmax(tsw.run_software(
        tm.to_snnetwork(params, cfg.model), tspk.to(torch.float32),
        device="cpu")["output_counts"], -1).numpy()
    assert (jpred == tpred).mean() >= SW_PRED_AGREE_MIN
    assert abs(tres["software_acc"] - jres["software_acc"]) <= (
        1 - SW_PRED_AGREE_MIN)


def test_train_resume_exact_trajectory():
    """fold_in(key, step) + stateless data: a restarted run reproduces the
    uninterrupted one's params (atol 1e-6)."""
    _, cfg = _cfgs(hidden=16, T=5, steps=12)
    p_full, _, _ = tt.train(cfg, mnist.batches("train", cfg.batch_size,
                                               cfg.train_steps, seed=3),
                            log_every=0, device="cpu")
    p_half, opt_half, _ = tt.train(
        cfg, mnist.batches("train", cfg.batch_size, 6, seed=3),
        log_every=0, device="cpu")
    rest = mnist.batches("train", cfg.batch_size, cfg.train_steps, seed=3,
                         start_step=6)
    p_res, opt_res, _ = tt.train(cfg, rest, params=p_half,
                                 opt_state=opt_half, start_step=6,
                                 log_every=0, device="cpu")
    for a, b in zip(p_full, p_res):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    assert int(opt_res["step"]) == 12


def test_train_logs_and_entry_points_need_a_card_by_default():
    _, cfg = _cfgs(hidden=8, T=3, steps=2)
    logs = []
    tt.train(cfg, mnist.batches("train", 8, 2, seed=0), log_every=1,
             log_fn=logs.append, device="cpu")
    assert [m.split(":")[0] for m in logs] == ["step 0", "step 1"]
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    x, y = mnist.load_or_generate("test", 4, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.train(cfg, mnist.batches("train", 8, 1, seed=0), log_every=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.init_params(0, cfg.model)
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.evaluate_dual(tm.init_params(0, cfg.model, device="cpu"),
                         cfg.model, x, y, num_steps_time=3)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_train_step_matches_unsharded(n_shards):
    """``make_sharded_train_step`` over ``n_shards`` repeated CPU devices:
    three steps allclose to the unsharded step (params atol 1e-6; loss,
    accuracy and grad norm rtol 1e-5); a batch that does not split is
    refused."""
    _, cfg = _cfgs(hidden=16, T=5)
    opt = topt.adam(cfg.lr)
    base = tt.make_train_step(cfg, opt)
    sharded = tt.make_sharded_train_step(cfg, opt, ["cpu"] * n_shards)
    p0 = tm.init_params(0, cfg.model, device="cpu")
    pa, sa, pb, sb = p0, opt.init(p0), p0, opt.init(p0)
    key = prng.split(prng.key(0))[1]
    for step, x, y in mnist.batches("train", 16, 3, seed=7):
        k = prng.fold_in(key, step)
        pa, sa, ma = base(pa, sa, k, torch.from_numpy(x),
                          torch.from_numpy(y))
        pb, sb, mb = sharded(pb, sb, k, torch.from_numpy(x),
                             torch.from_numpy(y))
        for m in ("loss", "acc", "grad_norm"):
            np.testing.assert_allclose(float(mb[m]), float(ma[m]), rtol=1e-5)
    for a, b in zip(pa, pb):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6)
    if n_shards > 1:
        with pytest.raises(ValueError, match="equal"):
            sharded(pb, sb, key, torch.zeros((n_shards + 1, 784)),
                    torch.zeros(n_shards + 1, dtype=torch.int32))


def test_train_config_defaults_match_jax():
    jf = {f.name: getattr(jt.TrainConfig(), f.name)
          for f in dataclasses.fields(jt.TrainConfig) if f.name != "model"}
    tf = {f.name: getattr(tt.TrainConfig(), f.name)
          for f in dataclasses.fields(tt.TrainConfig) if f.name != "model"}
    assert jf == tf
    assert tt.TrainConfig().model.layer_sizes == jt.TrainConfig(
    ).model.layer_sizes
