"""Event accounting over real spike rasters.

Twin of :mod:`repro.events` for its trace recorder:

  trace  — pure numpy passes over the rasters a run produced: measured SOP
           counts and gated-vs-dense weight-block traffic, the model the
           fused kernel's issued block count is checked against.

The AER wire format (``repro.events.aer``) is not ported yet (ROADMAP
Queue 1 item 6); the trace takes dense rasters.
"""

from repro_torch.events import trace  # noqa: F401
from repro_torch.events.trace import SpikeTraceReport, trace_run  # noqa: F401
