"""Wall ms a call in the tokenizer and the text tower (``MLD.tokenize``,
``condition_embedding``)."""
from benchmark.metrics._spans import mean_ms


def read(trace):
    if not any("tokenize" in c for c in trace.spans):
        return None
    return mean_ms(trace, ("tokenize", "text"))
