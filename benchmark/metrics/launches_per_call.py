"""Device operations (kernels, copies, sets) a call in the profiled calls."""


def read(trace):
    if not trace.n_calls:
        return None
    return len(trace.events) / trace.n_calls
