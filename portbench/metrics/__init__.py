"""Per-layer metrics: ``<metric>.py`` exposes ``read(trace)``, which
returns the metric from a `portbench.trace.Trace`, or None where the
trace holds nothing to read."""
