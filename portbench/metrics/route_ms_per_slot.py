"""Time of the kernels the program launched in its span
``fleet.route`` and every span under it (the private argmin, the water
levels, the rank clamp, the pool fill), in ms a slot."""

from portbench import spans


def read(trace):
    return spans.kernel_ms_per_slot(trace, ("fleet.route",))
