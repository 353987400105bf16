"""Telemetry of the port (counterpart of `repro.telemetry`): one
subsystem, two projections.

1. **In-loop recorders** (`recorder.py`) — fixed-shape tracks built into
   the dense simulator's slot step when a `TelemetryConfig` is passed
   (``telemetry=`` on `simulate`/`sweep`/`run_study`): downsampled time
   series, a FIFO-coupled task-sojourn histogram and a queue-length
   histogram, per cell, from which p50/p95/p99 delay and the
   queue-length distribution flow out as metrics keys.  With
   ``telemetry=None`` nothing is built; when on, the recorder draws no
   random numbers, so sample paths stay bit for bit.

2. **Host-side event tracing** (`events.py`) — a ring-buffered
   `EventRecorder` the serving engine and the host replication lifecycle
   emit typed events into, with a Chrome trace-event JSON exporter
   viewable in Perfetto, and the program's spans and counters
   (`span`, `count`, `collecting`, `recording`): the fleet study path
   marks its phases and counts its work with them, on
   `torch.profiler`'s timeline and the installed recorder's, and at no
   cost while tracing is off.
"""

from repro_torch.telemetry.events import (CLOCK_UNIT_US, COUNTS,
                                          EventRecorder, collecting,
                                          count, counting,
                                          flush_counts, load_trace,
                                          maybe_span, recording, span,
                                          validate_chrome_trace)
from repro_torch.telemetry.recorder import (OVERFLOW_WARN_FRAC,
                                            TELEMETRY_METRIC_KEYS,
                                            SimTelemetry, TelemetryConfig,
                                            TelemetryLike, TelState,
                                            as_telemetry_config,
                                            fcfs_sojourns,
                                            maybe_warn_overflow,
                                            percentiles_from_hist)

__all__ = [
    "CLOCK_UNIT_US", "COUNTS", "EventRecorder", "collecting", "count",
    "counting", "flush_counts", "load_trace", "maybe_span", "recording",
    "span",
    "validate_chrome_trace", "OVERFLOW_WARN_FRAC", "TELEMETRY_METRIC_KEYS",
    "SimTelemetry", "TelemetryConfig", "TelemetryLike", "TelState",
    "as_telemetry_config", "fcfs_sojourns", "maybe_warn_overflow",
    "percentiles_from_hist",
]
