"""Device idle ms a call in the gaps that open while the host is in the
tokenizer or the text condition (``mld.tokenize``, ``mld.condition``);
None without a device lane."""
from benchmark.metrics import _program


def read(trace):
    p = _program.phase(trace)
    return None if p is None else p.idle_ms(_program.TEXT)
