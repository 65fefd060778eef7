"""Event-driven sparse spike subsystem: AER streams and measured traces.

Twin of :mod:`repro.events`:

  aer    — fixed-capacity Address-Event Representation: ``(t, slot,
           source)`` address tuples, dense <-> AER conversion with an
           explicit overflow policy. The wire format of the spike-packet
           paths, as data.
  trace  — pure numpy passes over the rasters a run produced: measured SOP
           counts and gated-vs-dense weight-block traffic, the model the
           fused kernel's issued block count is checked against, and the
           measured counts the energy model prices.
"""

from repro_torch.events import aer, trace  # noqa: F401
from repro_torch.events.aer import AERStream, aer_to_dense, dense_to_aer  # noqa: F401
from repro_torch.events.trace import SpikeTraceReport, trace_run  # noqa: F401
