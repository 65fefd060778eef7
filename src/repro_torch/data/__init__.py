"""Deterministic, stateless data pipelines.

Twin of :mod:`repro.data`:

  mnist  — procedural MNIST (or real IDX files when present)
  events — synthetic event-camera (DVS-gesture-style) sparse spike clips
  lm     — synthetic Markov token streams for the LM zoo
"""

from repro_torch.data import events, lm, mnist  # noqa: F401
