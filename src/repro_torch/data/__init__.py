"""Deterministic, stateless data pipelines.

Twin of :mod:`repro.data`:

  events — synthetic event-camera (DVS-gesture-style) sparse spike clips

The procedural MNIST digits (``mnist``) and the LM token streams (``lm``)
wait for their slices (ROADMAP Queue 1 items 11 and 12).
"""

from repro_torch.data import events  # noqa: F401
