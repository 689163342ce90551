"""Mean wall ms a call of the given spans, summed, over the timed window of
a traced run (each span ends in a synchronisation)."""


def mean_ms(trace, names):
    calls = [c for c in trace.spans if any(n in c for n in names)]
    if not calls:
        return None
    return 1e3 * sum(sum(c.get(n, 0.0) for n in names)
                     for c in calls) / len(calls)
