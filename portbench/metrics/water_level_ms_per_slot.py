"""Time of the kernels the program launched in its spans
``fleet.route.water_level`` (each a bisection of the pool's water
level), in ms a slot."""

from portbench import spans


def read(trace):
    return spans.kernel_ms_per_slot(trace, ("fleet.route.water_level",))
