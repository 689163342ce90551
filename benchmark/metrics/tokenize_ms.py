"""Host ms a call in the tokenizer (the program's ``mld.tokenize`` span,
``ClipTokenizer.__call__``), over the traced run's third phase
(``_program.py``)."""
from benchmark.metrics import _program


def read(trace):
    p = _program.phase(trace)
    if p is None or not p.program_calls:
        return None
    spans = p.durations_us("tokenize")
    if not spans:
        return None
    return sum(spans) / 1e3 / p.program_calls
