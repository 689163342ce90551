"""The raw-motion cell's share of the card's peak, %: the family's
operation count of the timed window's calls over the window, over the
dense bf16 peak (the same reading as ``mfu.py``, in this cell)."""
from benchmark.metrics import mfu


def read(trace):
    return mfu.read(trace)
