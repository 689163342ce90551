"""The benchmark's operation count of the timed window's calls
(``families/<family>.flops``) over the window, as a share (%) of the
card's dense bf16 peak (``kernels/peaks.MFU_FLOPS``)."""
from benchmark.kernels import peaks


def read(trace):
    w = trace.window_a
    if w["seconds"] <= 0 or not trace.flops:
        return None
    return 100.0 * trace.flops / w["seconds"] / peaks.MFU_FLOPS
