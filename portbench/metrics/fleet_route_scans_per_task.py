"""Task slots ``kernels.ops.fleet_route`` scanned for each task that
arrived, over the traced call: the program's counters
``fleet_route.tasks_scanned`` / ``fleet.tasks_arrived``
(`repro_torch.telemetry.COUNTS`), which count only while tracing is on,
so only in the traced call; None where the trace holds no program
span."""

from portbench import spans


def read(trace):
    if not spans.attribution(trace).spans:
        return None
    try:
        from repro_torch import telemetry
    except ImportError:
        return None
    counts = getattr(telemetry, "COUNTS", {})
    scanned = counts.get("fleet_route.tasks_scanned")
    arrived = counts.get("fleet.tasks_arrived")
    if not scanned or not arrived:
        return None
    return scanned / arrived
