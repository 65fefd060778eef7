"""The port's roofline and op analysis against the JAX package's.

* ``repro_torch.roofline``: ``model_flops`` == ``repro.roofline``'s for
  every arch and shape at CONFIG; ``roofline_terms`` on the H100's
  constants mirrors ``tests/test_partition.py``'s roofline tests (each
  term 1.0 at the constants, the dominant term chosen the same way), its
  keys the twin's.
* ``repro_torch.op_analysis.analyze_step`` against
  ``repro.hlo_analysis.analyze_hlo`` on ``tests/test_hlo_analysis.py``'s
  program (L 6, B 4, D 64, float32; a Python loop here, unrolled and
  scanned there): dot FLOPs exactly, total FLOPs within that test's 20 %
  of the unrolled program's, bytes at least XLA's fusion-boundary bytes.
* Collectives through ``process_group``'s functions on a fake group of 4
  (in a subprocess: no process group is left in a test worker), counted
  by hand in the twin's convention (``tests/test_partition.py``'s
  ``test_collective_bytes_parsing``) and reconciled with
  ``process_group.BYTES``.
* The live-storage peak on fake tensors, and the profiles' rows.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import roofline as jroofline  # noqa: E402
from repro.configs.shapes import SHAPES as JSHAPES  # noqa: E402
from repro.hlo_analysis import analyze_hlo  # noqa: E402
from repro_torch import configs, roofline  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.op_analysis import (  # noqa: E402
    analyze_step,
    collective_profile,
    memory_profile,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
L, B, D = 6, 4, 64
DOT = L * 2 * B * D * D
MiB = 1 << 20


# --------------------------------------------------------------------------
# roofline
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", configs.list_archs())
def test_model_flops_equal_jax(arch, shape):
    cfg = configs.get_arch(arch).CONFIG
    jcfg = jconfigs.get_arch(arch).CONFIG
    got = roofline.model_flops(cfg, SHAPES[shape], 256)
    assert got == jroofline.model_flops(jcfg, JSHAPES[shape], 256)
    assert got > 0


def test_roofline_constants_are_the_h100s():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 450e9


def _terms(**kw):
    return roofline.roofline_terms(
        cfg=configs.get_arch("granite-3-2b").CONFIG,
        shape=SHAPES["train_4k"], n_chips=256, **kw)


def test_roofline_terms_math():
    t = _terms(flops_per_device=989e12, bytes_per_device=3.35e12,
               collective_bytes_per_device=450e9)
    assert t["compute_s"] == pytest.approx(1.0)
    assert t["memory_s"] == pytest.approx(1.0)
    assert t["collective_s"] == pytest.approx(1.0)
    cfg = configs.get_arch("granite-3-2b").CONFIG
    mf = roofline.model_flops(cfg, SHAPES["train_4k"], 256)
    assert mf == pytest.approx(6.0 * cfg.active_param_count() * 4096 * 256)
    assert t["model_flops_per_device"] == pytest.approx(mf / 256)
    assert t["useful_flops_ratio"] == pytest.approx(mf / 256 / 989e12)
    # decode counts one token per sequence
    dec = roofline.model_flops(cfg, SHAPES["decode_32k"], 256)
    assert dec == pytest.approx(2.0 * cfg.active_param_count() * 128)


@pytest.mark.parametrize("kw,dominant,bound", [
    (dict(flops_per_device=1e12, bytes_per_device=3.35e12 * 5,
          collective_bytes_per_device=0.0), "memory", 5.0),
    (dict(flops_per_device=989e12 * 3, bytes_per_device=3.35e12,
          collective_bytes_per_device=450e9 * 2), "compute", 3.0),
    (dict(flops_per_device=989e12, bytes_per_device=0.0,
          collective_bytes_per_device=450e9 * 7), "collective", 7.0),
])
def test_dominant_term_selection(kw, dominant, bound):
    t = _terms(**kw)
    assert t["dominant"] == dominant
    assert t["bound_s"] == pytest.approx(bound)
    # the same choice and the same keys as the twin's on its constants
    scale = {"flops_per_device": jroofline.PEAK_FLOPS / roofline.PEAK_FLOPS,
             "bytes_per_device": jroofline.HBM_BW / roofline.HBM_BW,
             "collective_bytes_per_device": (jroofline.ICI_BW
                                             / roofline.LINK_BW)}
    j = jroofline.roofline_terms(
        cfg=jconfigs.get_arch("granite-3-2b").CONFIG,
        shape=JSHAPES["train_4k"], n_chips=256,
        **{k: v * scale[k] for k, v in kw.items()})
    assert j["dominant"] == t["dominant"]
    assert set(j) == set(t)
    for k in ("compute_s", "memory_s", "collective_s", "bound_s"):
        assert t[k] == pytest.approx(j[k])


# --------------------------------------------------------------------------
# op analysis vs the HLO analysis
# --------------------------------------------------------------------------

def _jax_unrolled(x, W):
    for i in range(L):
        x = jnp.tanh(x @ W[i])
    return x.sum()


def _jax_per_layer(x, *Ws):
    for w in Ws:
        x = jnp.tanh(x @ w)
    return x.sum()


def _torch_program(x, W):
    for i in range(L):
        x = torch.tanh(x @ W[i])
    return x.sum()


@pytest.fixture(scope="module")
def jax_cost():
    """The HLO analysis of the unrolled program, with the weights stacked
    (L, D, D) as ``tests/test_hlo_analysis.py`` has them and as L
    separate (D, D) arguments."""
    x = jax.ShapeDtypeStruct((B, D), jnp.float32)
    W = jax.ShapeDtypeStruct((L, D, D), jnp.float32)
    w = jax.ShapeDtypeStruct((D, D), jnp.float32)
    stacked = jax.jit(_jax_unrolled).lower(x, W).compile()
    per_layer = jax.jit(_jax_per_layer).lower(x, *[w] * L).compile()
    return analyze_hlo(stacked.as_text()), analyze_hlo(per_layer.as_text())


def _inputs():
    g = torch.Generator().manual_seed(0)
    return (torch.randn(B, D, generator=g),
            torch.randn(L, D, D, generator=g) / D ** 0.5)


def test_forward_flops_and_bytes_match_the_hlo_analysis(jax_cost):
    """Dot FLOPs exactly L 2 B D D; the total within 20 % of the HLO
    analysis of the unrolled program (its test's tolerance against XLA).
    Bytes: each op's inputs and output, counted by hand. Against XLA's
    fusion-boundary bytes they are 0.387 of the stacked program's, whose
    CPU executable copies each layer's slice of W in a fusion of its own
    (read and written: 2 D D 4 bytes a layer) where the port's ``W[i]``
    is a view; without those copies (the weights as L arguments) XLA's
    CPU program has the port's op boundaries, and the bytes agree to
    24 of 123932 (its sum reads the init constant)."""
    stacked, per_layer = jax_cost
    x, W = _inputs()
    out, cost = analyze_step(_torch_program, x, W)
    assert torch.equal(out, _torch_program(x, W))
    assert cost.dot_flops == DOT
    assert cost.flops >= DOT
    assert abs(cost.flops - stacked.flops) / stacked.flops < 0.2
    f4 = 4   # float32 bytes
    mm = (B * D + D * D + B * D) * f4
    tanh = 2 * B * D * f4
    assert cost.bytes_accessed == L * (mm + tanh) + (B * D + 1) * f4
    assert stacked.bytes_accessed - per_layer.bytes_accessed == (
        L * 2 * D * D * f4)
    ratio = cost.bytes_accessed / stacked.bytes_accessed
    assert ratio == pytest.approx(0.387, abs=1e-3)
    assert abs(cost.bytes_accessed - per_layer.bytes_accessed) <= 24
    assert cost.collective_counts == {} and cost.total_collective_bytes == 0


def test_backward_counts_three_dots_a_layer():
    x, W = _inputs()

    def fwd_bwd(x, W):
        x, W = x.requires_grad_(), W.requires_grad_()
        return torch.autograd.grad(_torch_program(x, W), (x, W))

    _, cost = analyze_step(fwd_bwd, x, W)
    assert cost.dot_flops == 3 * DOT


def test_memory_peak_on_fake_tensors():
    """4 MiB + 4 MiB, one freed, then 4 MiB more: a peak of 8 MiB; the
    result (a view of the last) is the output, the argument is counted
    throughout."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def step(arg):
        a = torch.empty(MiB, dtype=torch.float32)
        b = torch.empty(MiB, dtype=torch.float32)
        del a
        c = torch.empty(MiB, dtype=torch.float32)
        del b
        return c[:10]

    with FakeTensorMode():
        arg = torch.empty(MiB // 4, dtype=torch.float32)   # 1 MiB
        _, cost = analyze_step(step, arg)
    assert cost.argument_bytes == MiB
    assert cost.temp_bytes == 8 * MiB
    assert cost.total_bytes == 9 * MiB
    assert cost.output_bytes == 4 * MiB
    assert cost.flops == 0 and cost.bytes_accessed == 0


def test_a_reference_cycle_holds_its_storage_until_the_step_ends():
    """The cyclic collector is paused in the step (and restored after):
    a storage a reference cycle holds stays live, as on the card, where
    no collection runs within a step, and the peak counts it."""
    import gc

    from torch._subclasses.fake_tensor import FakeTensorMode

    def step(arg):
        cycle = [torch.empty(MiB, dtype=torch.float32)]
        cycle.append(cycle)
        del cycle
        # enough new containers to start a collection, were it running
        junk = [[] for _ in range(100 * gc.get_threshold()[0])]
        del junk
        return torch.empty(MiB, dtype=torch.float32)

    assert gc.isenabled()
    with FakeTensorMode():
        _, cost = analyze_step(step, torch.empty(MiB // 4))
    assert gc.isenabled()
    assert cost.temp_bytes == 8 * MiB


def test_memory_profile_ranks_ops():
    x, W = _inputs()
    _, cost = analyze_step(_torch_program, x, W)
    rows = memory_profile(cost)
    assert [r[0] for r in rows] == sorted((r[0] for r in rows),
                                          reverse=True)
    mm = next(r for r in rows if r[1] == "mm")
    assert mm[2] == f"f32[{B},{D}]" and mm[3] == L
    assert mm[0] == L * 4 * (B * D + D * D + B * D)
    assert sum(r[0] for r in rows) == cost.bytes_accessed


# --------------------------------------------------------------------------
# collectives on a fake group of 4 (subprocess)
# --------------------------------------------------------------------------

_COLLECTIVES = r"""
import json
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.distributed import process_group as pg
from repro_torch.op_analysis import analyze_step, collective_profile

pg.init_fake(4)
groups = pg.mesh_groups(("data", "model"), (4, 1), "cpu")


def step(x, g, ar, a2a):
    y = pg.gather(x.requires_grad_(), 0, groups, "data")   # all-gather
    (dx,) = torch.autograd.grad(y, x, g)                    # reduce-scatter
    pg.all_reduce_(ar, groups, "data")
    return dx, pg.all_to_all(a2a, groups, "data")


with FakeTensorMode():
    args = (torch.empty(8, 128, dtype=torch.bfloat16),
            torch.empty(32, 128, dtype=torch.bfloat16),
            torch.empty(1024, 256), torch.empty(4, 16))
    pg.reset_bytes()
    (dx, out), cost = analyze_step(step, *args)
print(json.dumps({"counts": cost.collective_counts,
                  "bytes": cost.collective_bytes,
                  "buffer": cost.buffer_bytes,
                  "total": cost.total_collective_bytes,
                  "as_dict": cost.as_dict(),
                  "pg_bytes": dict(pg.BYTES), "pg_calls": dict(pg.CALLS),
                  "profile": collective_profile(cost),
                  "shapes": [list(dx.shape), list(out.shape)]}))
pg.shutdown()
"""


@pytest.fixture(scope="module")
def collectives():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", _COLLECTIVES],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_collectives_counted_in_the_twins_convention(collectives):
    """Counts and bytes by kind == the hand count: all-gather its
    gathered result, reduce-scatter its scattered result, all-reduce the
    tensor (2x in the total), all-to-all its input."""
    c = collectives
    assert c["counts"] == {"all-gather": 1, "reduce-scatter": 1,
                           "all-reduce": 1, "all-to-all": 1}
    ag = 32 * 128 * 2     # bf16[32,128], the gathered result
    rs = 8 * 128 * 2      # bf16[8,128], the scattered result
    ar = 1024 * 256 * 4
    a2a = 4 * 16 * 4
    assert c["bytes"] == {"all-gather": ag, "reduce-scatter": rs,
                          "all-reduce": ar, "all-to-all": a2a}
    assert c["total"] == ar * 2 + ag + rs + a2a
    assert c["as_dict"] == {"counts": c["counts"], "bytes_by_kind":
                            c["bytes"], "total_bytes": c["total"]}
    assert c["shapes"] == [[8, 128], [4, 16]]


def test_collectives_reconcile_with_process_group_bytes(collectives):
    """``buffer_bytes`` == ``process_group.BYTES`` and the calls ==
    ``CALLS`` kind for kind; the two conventions differ only in the
    reduce-scatter, charged its input there: 4 ranks x its result."""
    c = collectives
    pg_kind = {k.replace("_", "-"): v for k, v in c["pg_bytes"].items()}
    assert c["buffer"] == pg_kind
    assert {k.replace("_", "-"): v for k, v in c["pg_calls"].items()} == \
        c["counts"]
    for kind, b in c["bytes"].items():
        assert c["buffer"][kind] == b * (4 if kind == "reduce-scatter"
                                         else 1), kind


def test_collective_profile_rows(collectives):
    rows = collectives["profile"]
    assert [r[0] for r in rows] == sorted((r[0] for r in rows),
                                          reverse=True)
    assert rows[0][:4] == [2 * 1024 * 256 * 4, "all-reduce", "f32[1024,256]",
                           1]
    assert {(r[1], r[2]) for r in rows} == {
        ("all-reduce", "f32[1024,256]"), ("all-gather", "bf16[32,128]"),
        ("reduce-scatter", "bf16[8,128]"), ("all-to-all", "f32[4,16]")}
