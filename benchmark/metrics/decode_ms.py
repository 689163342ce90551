"""Wall ms a call in the VAE decode (``decode_latent``)."""
from benchmark.metrics._spans import mean_ms


def read(trace):
    return mean_ms(trace, ("decode",))
