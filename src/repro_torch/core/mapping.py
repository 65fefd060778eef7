"""The hardware configuration compiler — logical neurons -> clusters.

A numpy-only copy of :mod:`repro.core.mapping` (the port imports nothing
from the JAX package).

Cerebra-H groups 1024 physical neurons into 32 clusters of 32; cluster
groups of 4 clusters share one single-port weight SRAM of 2048 rows, where
one row holds the 32 weights from ONE source (cluster-ID, neuron-ID) to the
32 neurons of ONE destination cluster. The paper: "Clustering enables us to
place neurons with common synapses within the same cluster to reduce the
distance spike packets should travel."

This module is the analogue of the paper's (unreleased) "custom hardware
configuration compiler": it places logical neurons onto physical slots,
checks SRAM row budgets, and reports the static communication profile the
timing model consumes.

Row-budget semantics (DESIGN.md §2, changed-assumption note): the literal
reading (every (source, destination-cluster) pair with any nonzero weight
consumes one row in the destination's group) makes the paper's own
784->256->10 MNIST net infeasible. We support both:

  * ``row_mode='strict'``      — literal reading; compile fails if over.
  * ``row_mode='external_broadcast'`` — rows for EXTERNAL stimulus sources
    are resolved once per group and fanned to its four clusters (the
    Incoming Forwarder already performs a per-cluster lookup, so sharing a
    fetched row across co-resident clusters is a small RTL delta). This is
    the mode that makes the paper's experiments fit, and the default.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.network import SNNetwork

__all__ = [
    "ClusterGeometry",
    "Placement",
    "place_contiguous",
    "place_random",
    "place_greedy",
    "row_usage",
    "check_capacity",
    "communication_profile",
]


@dataclasses.dataclass(frozen=True)
class ClusterGeometry:
    n_clusters: int = 32
    neurons_per_cluster: int = 32
    clusters_per_group: int = 4
    rows_per_group: int = 2048
    # hierarchical NoC shape: L1 router per `clusters_per_l1` clusters,
    # one L2 router over all L1s (paper: 4 clusters/L1, 8 L1s/L2).
    clusters_per_l1: int = 4

    @property
    def n_physical(self) -> int:
        return self.n_clusters * self.neurons_per_cluster

    @property
    def n_groups(self) -> int:
        return self.n_clusters // self.clusters_per_group

    @property
    def n_l1_routers(self) -> int:
        return self.n_clusters // self.clusters_per_l1

    @property
    def total_synapse_capacity(self) -> int:
        # rows * 32 weights each, all groups (paper: 524,288).
        return self.n_groups * self.rows_per_group * self.neurons_per_cluster

    def cluster_of(self, phys: np.ndarray) -> np.ndarray:
        return phys // self.neurons_per_cluster

    def group_of_cluster(self, cluster: np.ndarray) -> np.ndarray:
        return cluster // self.clusters_per_group

    def l1_of_cluster(self, cluster: np.ndarray) -> np.ndarray:
        return cluster // self.clusters_per_l1


@dataclasses.dataclass
class Placement:
    """neuron_to_physical[i] = physical slot of logical neuron i."""

    geometry: ClusterGeometry
    neuron_to_physical: np.ndarray  # (n_neurons,) int

    def __post_init__(self):
        p = np.asarray(self.neuron_to_physical, np.int64)
        if len(np.unique(p)) != len(p):
            raise ValueError("placement maps two neurons to one slot")
        if p.size and (p.min() < 0 or p.max() >= self.geometry.n_physical):
            raise ValueError("placement out of range")
        self.neuron_to_physical = p

    @property
    def n_neurons(self) -> int:
        return int(self.neuron_to_physical.size)

    def cluster_of_neuron(self, i) -> np.ndarray:
        return self.geometry.cluster_of(self.neuron_to_physical[i])


def place_contiguous(net: SNNetwork, geom: ClusterGeometry) -> Placement:
    """Identity placement: neuron i -> slot i (layer-contiguous for
    feedforward nets, since layers are numbered contiguously)."""
    _require_fits(net, geom)
    return Placement(geom, np.arange(net.n_neurons))


def place_random(net: SNNetwork, geom: ClusterGeometry, seed: int = 0
                 ) -> Placement:
    _require_fits(net, geom)
    rng = np.random.default_rng(seed)
    slots = rng.permutation(geom.n_physical)[: net.n_neurons]
    return Placement(geom, slots)


def place_greedy(net: SNNetwork, geom: ClusterGeometry) -> Placement:
    """Locality-aware greedy placement.

    Orders neurons so that neurons sharing presynaptic sources land in the
    same cluster (one SRAM row then serves up to 32 destinations at once,
    and spike packets stay on the local L1 router). Strategy: process
    layers in order (feedforward locality is already contiguous); within a
    layer, sort neurons by their dominant source cluster so recurrent nets
    also cluster by connectivity.
    """
    _require_fits(net, geom)
    order: list[int] = []
    slices = net.layer_slices or ((0, net.n_neurons),)
    W = net.weights
    for lo, hi in slices:
        idx = np.arange(lo, hi)
        if len(order) == 0:
            order.extend(idx.tolist())
            continue
        # dominant presynaptic *neuron* block of each candidate (inputs are
        # handled by external_broadcast rows; neuron sources drive NoC hops)
        src = np.abs(W[net.n_inputs :, lo:hi])  # (n_neurons, width)
        buckets = np.add.reduceat(
            src,
            np.arange(0, src.shape[0], geom.neurons_per_cluster),
            axis=0,
        )
        dom = np.argmax(buckets, axis=0) if buckets.size else np.zeros(len(idx))
        order.extend(idx[np.argsort(dom, kind="stable")].tolist())
    return Placement(geom, _slots(order))


def _slots(order: list[int]) -> np.ndarray:
    """Assign consecutive physical slots in the given processing order."""
    slots = np.empty(len(order), np.int64)
    for phys, logical in enumerate(order):
        slots[logical] = phys
    return slots


def _require_fits(net: SNNetwork, geom: ClusterGeometry) -> None:
    if net.n_neurons > geom.n_physical:
        raise ValueError(
            f"{net.n_neurons} neurons > {geom.n_physical} physical slots"
        )


# --------------------------------------------------------------------------
# Capacity accounting
# --------------------------------------------------------------------------

def _edges(net: SNNetwork, placement: Placement):
    """Nonzero (source, dst_cluster) incidence.

    Returns (ext_rows, neuron_rows): boolean matrices
      ext_rows:    (n_inputs, n_clusters)
      neuron_rows: (n_clusters_src, n_clusters) — source *clusters* since a
                   row is addressed by source (cluster, neuron); we keep the
                   per-source-neuron resolution below where needed.
    plus per-destination-cluster nonzero masks at source-neuron resolution.
    """
    geom = placement.geometry
    n_in = net.n_inputs
    W = net.weights
    # destination cluster of each logical neuron
    dst_cluster = geom.cluster_of(placement.neuron_to_physical)  # (n_neurons,)
    nz = W != 0.0
    # collapse destinations into clusters
    n_c = geom.n_clusters
    dst_onehot = np.zeros((net.n_neurons, n_c), bool)
    dst_onehot[np.arange(net.n_neurons), dst_cluster] = True
    src_to_cluster_nz = nz @ dst_onehot  # (n_sources, n_clusters) bool
    return src_to_cluster_nz[:n_in], src_to_cluster_nz[n_in:]


def row_usage(
    net: SNNetwork,
    placement: Placement,
    row_mode: str = "external_broadcast",
) -> np.ndarray:
    """Rows consumed per cluster group. Returns (n_groups,) int array."""
    geom = placement.geometry
    ext_rows, neuron_rows = _edges(net, placement)
    group_of = geom.group_of_cluster(np.arange(geom.n_clusters))
    usage = np.zeros(geom.n_groups, np.int64)
    for g in range(geom.n_groups):
        clusters = np.where(group_of == g)[0]
        if row_mode == "strict":
            usage[g] += int(ext_rows[:, clusters].sum())
        elif row_mode == "external_broadcast":
            # one row per external source per *group* (fanned to clusters)
            usage[g] += int(ext_rows[:, clusters].any(axis=1).sum())
        else:
            raise ValueError(f"unknown row_mode {row_mode!r}")
        # neuron-to-neuron rows are always per (source neuron, dst cluster)
        usage[g] += int(neuron_rows[:, clusters].sum())
    return usage


def check_capacity(
    net: SNNetwork,
    placement: Placement,
    row_mode: str = "external_broadcast",
) -> dict:
    """Validate SRAM budgets; raises ValueError when infeasible."""
    geom = placement.geometry
    usage = row_usage(net, placement, row_mode)
    report = {
        "rows_per_group": usage,
        "rows_budget": geom.rows_per_group,
        "total_synapses": net.n_synapses,
        "synapse_capacity": geom.total_synapse_capacity,
        "feasible": bool(
            (usage <= geom.rows_per_group).all()
            and net.n_synapses <= geom.total_synapse_capacity
        ),
        "row_mode": row_mode,
    }
    if not report["feasible"]:
        raise ValueError(
            f"network exceeds Cerebra-H capacity: rows/group={usage.tolist()}"
            f" (budget {geom.rows_per_group}), synapses={net.n_synapses}"
            f" (capacity {geom.total_synapse_capacity}), row_mode={row_mode}"
        )
    return report


def communication_profile(net: SNNetwork, placement: Placement) -> dict:
    """Static NoC profile: cluster->cluster edges and their hop classes.

    Hop classes (paper Fig. 3 topology):
      local  — same cluster (never leaves the cluster datapath),
      l1     — distinct clusters under the same L1 router,
      l2     — crosses the central L2 router.
    """
    geom = placement.geometry
    _, neuron_rows = _edges(net, placement)  # (n_neurons, n_clusters)
    src_cluster = geom.cluster_of(placement.neuron_to_physical)
    n_c = geom.n_clusters
    edge = np.zeros((n_c, n_c), np.int64)  # src_cluster -> dst_cluster count
    for i in range(net.n_neurons):
        dsts = np.where(neuron_rows[i])[0]
        edge[src_cluster[i], dsts] += 1
    sc, dc = np.nonzero(edge)
    same_cluster = sc == dc
    same_l1 = geom.l1_of_cluster(sc) == geom.l1_of_cluster(dc)
    counts = edge[sc, dc]
    return {
        "edge_matrix": edge,
        "local_edges": int(counts[same_cluster].sum()),
        "l1_edges": int(counts[~same_cluster & same_l1].sum()),
        "l2_edges": int(counts[~same_l1].sum()),
    }
