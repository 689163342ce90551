"""The program's own spans and counters (``mld_tpu_torch/utils/trace.py``)
over further profiled calls of a traced run, for the readers of
``tokenize_ms``, ``step_host_us``, the stage idle times and ``cast_mb``.

The first reader that asks runs a third phase after the traced run's two
(the stage-timed window and the first profiled calls, both with the
program's tracing off, so every earlier metric reads what it read before):
the program's spans on, its counters read, ``core.TRACED_CALLS`` more calls
under ``torch.profiler``, the counters read again, the spans off. The phase
is kept on the trace, so it runs once a run.

A reader is handed the trace alone, and the phase needs the run (its
program, inputs and capture): ``_run_of`` takes it from the reader's
callers, where ``core.execute`` holds the run of the trace's cell. A
program without the trace module (an earlier commit), or a trace without
its run, gives no phase, and every reader of it returns None.
"""
from __future__ import annotations

import bisect
import sys

# the spans that open each serving stage (``utils/trace.py``)
TEXT = ("tokenize", "condition")
LOOP = ("loop",)
DECODE = ("decode",)
JOINTS = ("joints",)


# the CUDA runtime's and driver's calls on the host (a launch, a copy, a set)
RUNTIME = ("cuda", "cuLaunch", "cuMemcpy", "cuMemset")


class ProgramTrace:
    """The third phase, from the profiler's raw events
    (``kineto_results.events()``: name, device type, start and end ns,
    correlation id): the host's ``mld.*`` ranges (``program``: [(name
    without "mld.", start us, end us)]), the device's events over its calls
    (``program_events``, on the host's clock, clipped to the first call's
    start and the last call's end; the ``mld.*`` and ``bench.*``
    annotations on the device's lane are not device work), its calls
    (``program_calls``) and the program's counters over them (``counts``:
    key -> increase).

    The device's times are put on the host's clock call by call. A device
    event cannot start before the host call that issued it (the runtime
    event of the same correlation id, timed on the host) starts, so the
    largest lead of an event over its issuing call within a profiled call
    is how early the device's clock reads there (``clock_shift_us``, one a
    call, 0 where no event leads). On the card the device's times drifted
    by up to a few ms within a profiler session, early, and not in every
    session."""

    def __init__(self, raw_events, counts: dict, cuda):
        calls, host, dev, issued = [], [], [], {}
        base = min((e.start_ns() for e in raw_events), default=0)
        for e in raw_events:
            name = e.name()
            s, t = (e.start_ns() - base) / 1e3, (e.end_ns() - base) / 1e3
            if e.device_type() == cuda:
                if not name.startswith(("mld.", "bench.")):
                    dev.append((name, s, t, e.correlation_id()))
            elif name == "bench.call":
                calls.append((s, t))
            elif name.startswith("mld."):
                host.append((name[len("mld."):], s, t))
            elif name.startswith(RUNTIME):
                issued[e.correlation_id()] = s
        calls.sort()
        self.program_calls = len(calls)
        self.counts = dict(counts)
        self.t0 = calls[0][0] if calls else 0.0
        self.t1 = max((t for _, t in calls), default=0.0)
        self.program = [h for h in host
                        if h[1] >= self.t0 and h[2] <= self.t1]
        starts = [c for c, _ in calls]
        owner = [_call_of(starts, issued.get(corr, s))
                 for _, s, _, corr in dev]
        shift = [0.0] * max(len(calls), 1)
        for (_, s, _, corr), c in zip(dev, owner):
            if corr in issued:
                shift[c] = max(shift[c], issued[corr] - s)
        self.clock_shift_us = shift[:len(calls)]
        moved = [(n, s + shift[c], t + shift[c])
                 for (n, s, t, _), c in zip(dev, owner)]
        self.program_events = [(n, max(s, self.t0), min(t, self.t1))
                               for n, s, t in moved
                               if t > self.t0 and s < self.t1]

    def program_gaps(self) -> list:
        """Idle intervals of the device over the calls [(label, start us,
        seconds)], each labelled with the innermost ``mld.*`` span open on
        the host at its start, else "outside" (the harness, between
        calls)."""
        out, end = [], self.t0
        for _, s, e in sorted(self.program_events, key=lambda x: x[1]):
            if s > end:
                out.append((end, s))
            end = max(end, e)
        if self.t1 > end:
            out.append((end, self.t1))
        labelled = []
        for s, e in out:
            inside = [h for h in self.program if h[1] <= s < h[2]]
            label = min(inside, key=lambda h: h[2] - h[1])[0] \
                if inside else "outside"
            labelled.append((label, s, (e - s) / 1e6))
        return labelled

    def idle_ms(self, names) -> float:
        """Device idle ms a call in the gaps that open inside a span named
        in `names`, at any depth; None without device events."""
        if not self.program_events or not self.program_calls:
            return None
        opened = [h for h in self.program if h[0] in names]
        idle = sum(sec for _, s, sec in self.program_gaps()
                   if any(a <= s < b for _, a, b in opened))
        return 1e3 * idle / self.program_calls

    def durations_us(self, name: str) -> list:
        """Host durations (us) of the spans named `name`."""
        return [e - s for n, s, e in self.program if n == name]

    def total(self, prefix: str) -> int:
        """The counters' increase over the keys that are `prefix` or start
        with it and a dot."""
        dotted = prefix + "."
        return sum(v for k, v in self.counts.items()
                   if k == prefix or k.startswith(dotted))


def _call_of(starts: list, t: float) -> int:
    """The index of the last call that starts at or before t (0 before
    the first)."""
    return max(bisect.bisect_right(starts, t) - 1, 0)


def phase(trace):
    """The trace's third phase (made at the first call), or None."""
    if not hasattr(trace, "program_phase"):
        run = _run_of(trace)
        trace.program_phase = _measure(run) if run is not None else None
    return trace.program_phase


def _run_of(trace):
    """The run of the trace's cell, from the callers' frames."""
    from benchmark import core
    frame = sys._getframe(1)
    while frame is not None:
        for v in frame.f_locals.values():
            if isinstance(v, core.Run) and v.cell is trace.cell \
                    and getattr(v, "program", None) is not None:
                return v
        frame = frame.f_back
    return None


def _measure(run):
    try:
        from mld_tpu_torch.utils import trace as program_trace
    except ImportError:            # a program without spans or counters
        return None
    from torch.profiler import ProfilerActivity, profile

    from benchmark import core
    program_trace.enable(True)
    before = dict(program_trace.COUNTS)
    run.cap.profiling = True
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run.window(0.0, None, core.TRACED_CALLS)
            run.sync()
    finally:
        run.cap.profiling = False
        after = dict(program_trace.COUNTS)
        program_trace.enable(False)
    counts = {k: v - before.get(k, 0) for k, v in after.items()
              if v != before.get(k, 0)}
    return ProgramTrace(prof.profiler.kineto_results.events(), counts,
                        run.torch.autograd.DeviceType.CUDA)
