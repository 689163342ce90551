"""Wall ms a call in the joints (``masked_joints``) and their copy to the
host."""
from benchmark.metrics._spans import mean_ms


def read(trace):
    return mean_ms(trace, ("joints", "copy"))
