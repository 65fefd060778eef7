"""SNN training substrate: surrogate-gradient spiking MLPs + dual eval.

Twin of :mod:`repro.snn`.
"""

from repro_torch.snn import model, train  # noqa: F401
