"""Time of the kernels the program launched in its span
``fleet.serve`` (service, scheduling and the running means), in ms a
slot."""

from portbench import spans


def read(trace):
    return spans.kernel_ms_per_slot(trace, ("fleet.serve",))
