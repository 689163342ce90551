"""MB a call of f32 operands the reduced GEMMs round before they multiply
(the program's ``cast.*`` counters: activations and weights of every
linear under ``default`` or ``high``), over the traced run's third
phase."""
from benchmark.metrics import _program


def read(trace):
    p = _program.phase(trace)
    if p is None or not p.program_calls:
        return None
    return p.total("cast") / p.program_calls / 1e6
