"""Wall ms a call in the guided DDIM loop (``diffusion_reverse``)."""
from benchmark.metrics._spans import mean_ms


def read(trace):
    return mean_ms(trace, ("scan",))
