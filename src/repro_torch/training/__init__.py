"""Training substrate: optimizers, schedules, compression, loop.

Twin of :mod:`repro.training`.
"""

from repro_torch.training import compression, loop, optimizers  # noqa: F401
