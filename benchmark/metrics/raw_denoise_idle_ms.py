"""Device idle ms a call in the gaps that open while the host is inside a
decoder layer's sublayer (the program's ``mld.attn.self``,
``mld.attn.cross`` and ``mld.ffn`` spans), over the traced run's third
phase; None where the program has no such span.

The same reading as ``ProgramTrace.idle_ms`` of these spans, found by a
sweep: a raw call has about 44k device events and, with its casts' spans,
about 11k program spans, where labelling each gap against every span
(``program_gaps``) would take hours."""
import bisect

from benchmark.metrics import _program

SPANS = ("attn.self", "attn.cross", "ffn")


def gaps(p):
    """The device's idle intervals over the calls [(start us, seconds)], as
    ``ProgramTrace.program_gaps`` finds them."""
    out, end = [], p.t0
    for _, s, e in sorted(p.program_events, key=lambda x: x[1]):
        if s > end:
            out.append((end, (s - end) / 1e6))
        end = max(end, e)
    if p.t1 > end:
        out.append((end, (p.t1 - end) / 1e6))
    return out


def read(trace):
    p = _program.phase(trace)
    if p is None:
        return None
    spans = sorted((s, e) for n, s, e in p.program if n in SPANS)
    if not spans or not p.program_events or not p.program_calls:
        return None
    starts, reach, far = [], [], float("-inf")
    for s, e in spans:              # reach[i]: the latest end of spans[:i+1]
        far = max(far, e)
        starts.append(s)
        reach.append(far)
    idle = 0.0
    for s, sec in gaps(p):
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and s < reach[i]:
            idle += sec
    return 1e3 * idle / p.program_calls
