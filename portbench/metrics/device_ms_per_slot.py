"""Kernel time on the device in the traced window, in ms a simulated
slot."""


def read(trace):
    if not trace.kernels or not trace.slots:
        return None
    return sum(k.seconds for k in trace.kernels) * 1e3 / trace.slots
