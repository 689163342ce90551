"""MB a call of f32 operands the reduced GEMMs round before they multiply
in the raw-motion cell (the program's ``cast.*`` counters; the same
reading as ``cast_mb.py``)."""
from benchmark.metrics import cast_mb


def read(trace):
    return cast_mb.read(trace)
