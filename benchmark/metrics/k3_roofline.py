"""K3's share of its roofline, % (``kernels/k3.py``): the least times of
its launches in the profiled calls over their device time."""


def read(trace):
    return trace.roofline("k3")
