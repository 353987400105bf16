"""Time of the kernels the program launched in its spans
``fleet.draws`` (the slot's random blocks and Poisson counts) and
``fleet.arrivals`` (the sampler and its row sort), in ms a slot."""

from portbench import spans


def read(trace):
    return spans.kernel_ms_per_slot(trace, ("fleet.draws", "fleet.arrivals"))
