"""K3's share of its roofline in the raw-motion cell, % (``kernels/
raw_k3.py``, K3's count): the least times of the denoiser's self- and
cross-attention launches in the profiled calls over their device time."""


def read(trace):
    return trace.roofline("raw_k3")
