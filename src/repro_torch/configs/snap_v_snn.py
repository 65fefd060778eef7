"""The paper's own workload: SNAP-V MNIST spiking MLPs on Cerebra-H.

Own copy of the constants of :mod:`repro.configs.snap_v_snn` (Table IV
grid: hidden sizes {16, 32, 64, 128, 256} x T in {25, 50, 75, 100}; the
default 32 x 32 Cerebra-H geometry; the paper's LIF).
"""

from repro_torch.core.cerebra_h import CerebraHConfig
from repro_torch.core.lif import LIFParams
from repro_torch.core.mapping import ClusterGeometry

__all__ = ["ACCELERATOR", "HIDDEN_SIZES", "LIF", "TIMESTEPS", "layer_sizes"]

HIDDEN_SIZES = (16, 32, 64, 128, 256)
TIMESTEPS = (25, 50, 75, 100)

ACCELERATOR = CerebraHConfig(
    geometry=ClusterGeometry(
        n_clusters=32, neurons_per_cluster=32, clusters_per_group=4,
        rows_per_group=2048),
    row_mode="external_broadcast",
)

LIF = LIFParams(decay_rate=0.1, threshold=1.0, reset_mode="zero")


def layer_sizes(hidden: int) -> tuple[int, int, int]:
    """The 784-hidden-10 MNIST net of the paper."""
    return (784, int(hidden), 10)
