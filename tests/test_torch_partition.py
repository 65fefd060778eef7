"""The port's partition rules (``repro_torch.distributed.partition``)
against the JAX package's: ``spec_for`` gives the entries of JAX's
``PartitionSpec`` on the same logical axes, shapes and mesh shape.

JAX's ``spec_for`` reads only ``mesh.shape``, so one duck-typed mesh
drives both packages; the port's own ``SpikeMesh`` drives JAX's too.
"""

import numpy as np
import pytest
import torch

from repro.distributed import partition as jpart
from repro_torch.distributed import partition as tpart
from repro_torch.distributed.spike_mesh import SNN_RULES, make_spike_mesh


class _Mesh:
    def __init__(self, **shape):
        self.shape = dict(shape)


def _both(axes, shape, mesh, rules: dict, batch_axes=("data",)):
    want = jpart.spec_for(axes, shape, mesh, jpart.PartitionRules(
        rules=rules, batch_axes=batch_axes))
    got = tpart.spec_for(axes, shape, mesh, tpart.PartitionRules(
        rules=rules, batch_axes=batch_axes))
    return tuple(want), got


CASES = [
    # test_partition.py: size-1 axes -> everything replicates
    (("embed", "heads"), (64, 64), {"data": 1, "model": 1},
     {"heads": "model", "embed": "data"}),
    # test_partition.py: both dims want 'model' on a size-1 axis
    (("a", "b"), (8, 8), {"model": 1}, {"a": "model", "b": "model"}),
    # ... and on a 2-way axis only the first takes it
    (("a", "b"), (8, 8), {"model": 2}, {"a": "model", "b": "model"}),
    # divisibility fallback: 7 does not divide by 2, the second dim shards
    (("a", "b"), (7, 8), {"model": 2}, {"a": "model", "b": "model"}),
    (("embed", "heads"), (64, 40), {"data": 4, "model": 16},
     {"heads": "model", "embed": "data"}),
    (("embed", "heads"), (64, 48), {"data": 4, "model": 16},
     {"heads": "model", "embed": "data"}),
    # tuple rules: the product of the axes must divide the dim
    (("batch", "embed"), (8, 6), {"pod": 2, "data": 2},
     {"batch": ("pod", "data"), "embed": "data"}),
    (("batch", "embed"), (6, 6), {"pod": 2, "data": 2},
     {"batch": ("pod", "data"), "embed": "data"}),
    # unknown and None logical axes replicate; trailing Nones drop
    ((None, "heads", "other"), (4, 32, 3), {"model": 2},
     {"heads": "model"}),
    (("heads", None), (32, 4), {"model": 2}, {"heads": "model"}),
    ((), (), {"model": 2}, {"heads": "model"}),
]


@pytest.mark.parametrize("axes,shape,mesh_shape,rules", CASES)
def test_spec_for_matches_jax(axes, shape, mesh_shape, rules):
    want, got = _both(axes, shape, _Mesh(**mesh_shape), rules)
    assert got == want


# the specs the mesh engine resolves: weights, carries, rasters and masks
# of a padded (T, B, ...) dispatch, on every mesh shape of the parity suite
SNN_AXES = [
    (("source", "neuron"), lambda n_in, pp, bp, T: (n_in + pp, pp)),
    (("batch", "neuron"), lambda n_in, pp, bp, T: (bp, pp)),
    (("time", "batch", "source"), lambda n_in, pp, bp, T: (T, bp, n_in)),
    (("time", "batch", "neuron"), lambda n_in, pp, bp, T: (T, bp, pp)),
    (("time", "batch"), lambda n_in, pp, bp, T: (T, bp)),
]


@pytest.mark.parametrize("kn,kb", [(1, 1), (1, 2), (2, 1), (2, 2), (2, 4)])
@pytest.mark.parametrize("axes,shape_of", SNN_AXES,
                         ids=[",".join(a) for a, _ in SNN_AXES])
def test_snn_specs_match_jax_on_a_spike_mesh(kn, kb, axes, shape_of):
    mesh = make_spike_mesh(kn, kb, devices=["cpu"] * (kn * kb))
    rules = dict(SNN_RULES.rules)
    for n_in, n_phys, B, T in ((37, 48, 5, 7), (1, 1, 1, 3),
                               (200, 130, 6, 4)):
        pp = -(-n_phys // kn) * kn
        bp = -(-B // kb) * kb
        shape = shape_of(n_in, pp, bp, T)
        want, got = _both(axes, shape, mesh, rules, SNN_RULES.batch_axes)
        assert got == want, (shape, got, want)


def test_partition_rules_defaults_and_axis_size_match_jax():
    assert (tpart.PartitionRules().batch_axes
            == jpart.PartitionRules().batch_axes == ("data",))
    assert tpart.PartitionRules().rules == jpart.PartitionRules().rules == {}
    mesh = _Mesh(pod=2, data=3, model=4)
    for axes in (None, "model", ("pod", "data"), ("pod", "data", "model")):
        assert (tpart._axis_size(mesh, axes)
                == jpart._axis_size(mesh, axes))


def test_spike_mesh_is_a_hashable_grid():
    mesh = make_spike_mesh(2, 4, devices=["cpu"] * 8)
    assert mesh.shape == {"neuron": 2, "batch": 4}
    assert mesh.size == 8 and mesh.axis_names == ("neuron", "batch")
    assert mesh.physical_devices == (torch.device("cpu"),)
    assert mesh == make_spike_mesh(2, 4, devices=["cpu"] * 8)
    assert len({mesh, make_spike_mesh(2, 4, devices=["cpu"] * 8)}) == 1
    assert mesh != make_spike_mesh(4, 2, devices=["cpu"] * 8)
    assert np.asarray(mesh.devices, dtype=object).shape == (2, 4)
