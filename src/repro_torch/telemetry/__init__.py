"""Telemetry of the port (counterpart of `repro.telemetry`): for now the
histogram quantile the serving engine reads.  The in-scan recorder and
event tracing come with the telemetry slice of the port."""

from repro_torch.telemetry.recorder import percentiles_from_hist  # noqa: F401
