"""Host us of one DDPM step of the module-path denoiser (the program's
``mld.loop.step`` span, over the traced run's third phase): the time the
host takes to enqueue a step's ~440 launches."""
from benchmark.metrics import step_host_us


def read(trace):
    return step_host_us.read(trace)
