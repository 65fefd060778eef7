"""Deterministic, stateless data pipelines.

Twin of :mod:`repro.data`:

  mnist  — procedural MNIST (or real IDX files when present)
  events — synthetic event-camera (DVS-gesture-style) sparse spike clips

The LM token streams (``lm``) wait for their slice (ROADMAP Queue 1 item
12).
"""

from repro_torch.data import events, mnist  # noqa: F401
