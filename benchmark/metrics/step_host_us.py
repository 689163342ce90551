"""Host us of one sampling step (the program's ``mld.loop.step`` span):
the time the host takes to enqueue a step's work, to hold against the
device's time for the step (K1 about 470 us a launch at B=128)."""
from benchmark.metrics import _program


def read(trace):
    p = _program.phase(trace)
    if p is None:
        return None
    steps = p.durations_us("loop.step")
    if not steps:
        return None
    return sum(steps) / len(steps)
