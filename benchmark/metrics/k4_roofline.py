"""K4's share of its roofline, % (``kernels/k4.py``): the least times of
its launches in the profiled calls over their device time."""


def read(trace):
    return trace.roofline("k4")
