"""Kernels the device ran in the traced window, a simulated slot."""


def read(trace):
    if not trace.kernels or not trace.slots:
        return None
    return len(trace.kernels) / trace.slots
