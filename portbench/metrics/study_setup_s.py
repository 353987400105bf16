"""Host time of the study's set-up, in s: the program's spans
``study.estimates`` (the estimate tables) and ``fleet.setup`` (the
per-cell estimate stack and its copy, the slot step's constants and the
cells' Poisson CDFs), their union."""

from portbench import spans


def read(trace):
    return spans.host_seconds(trace, ("study.estimates", "fleet.setup"))
